"""K2 (resize_bilinear) against other builds of it, in turns on one card.

    python3 scripts/resize_variants.py [--source NAME=PATH ...]
        [--only VARIANT ...] [--base NAME] [--sass] [--rounds 5]
        [--out FILE]

The builds: the port's own ``src/repro_torch/csrc/resize.cu`` ("as
committed"); each ``--source`` (another checkout's ``resize.cu``, say the
one-thread-an-output kernel it replaced, ``parent=PATH``); and each of
``VARIANTS`` (or those named by ``--only``), the committed source with its
tile's size or its loads in flight replaced -- each replaced text must
occur exactly once, so an edited source fails here rather than measuring
something else.  All are compiled together with the port's own ``nvcc``
flags into ``src/repro_torch/_build/resize_variants/``; a build that
fails is reported and left out.  Each build's ``resize_kernel``
registers and spills are printed from its ptxas report and, with
``--sass``, the opcode mix of the ``resize_kernel`` the main-path shape
launches, as compiled (``cuobjdump -sass``, ``variants.sass_mix``).

Each build is bound in turn into the port's wrapper (``resize_bilinear``)
and:

* run at the main-path shape, (60, 720, 1280) -> (544, 960), at each shape
  of ``tests/test_torch_kernels.py::RESIZES`` (3 frames) and at each of
  its ``RESIZE_EDGES``, on 0-255 data from a seed: the output elements
  whose bits differ from the ``--base`` build's (default ``parent``
  where given, else the committed build; 0 expected, since every build
  computes the same fused multiply-add chains) and the max |d| against
  the plain version ``resize_ref``;
* timed in turns (A B C, C B A, ...) for ``--rounds`` rounds at
  ``TIMED``: CUDA events over 20 back-to-back calls and the card's kernel
  time by the profiler over 10 (``chip_smoke.kernel_ms``), beside one
  ``F.interpolate(antialias=True)`` call of the same shapes, the
  library's yardstick; and a device copy of the input (``clone``), the
  card's reachable memory rate.

The median of the rounds is printed (of the rounds whose profiler window
counted the kernel: a trace sometimes comes back empty, PERF.md §7), with
the bytes bound (each input read once, each output written once, at
3.35 TB/s).  Ends with one JSON line; exits 1 where a build's bits differ
from the base's (but for the probes', which leave a pass out on
purpose, to time the other).  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import statistics
import sys

from variants import (HERE, bind, build_all, c_entry, in_turns, logger,
                      sass_mix, variant_source)

#: name -> (what it changes, [(text in resize.cu, its replacement)])
VARIANTS = {
    "8 rows": ("tiles of 8 output rows (16 as committed)",
               [("constexpr int kTH = 16;", "constexpr int kTH = 8;")]),
    "32 rows": ("tiles of 32 output rows",
                [("constexpr int kTH = 16;", "constexpr int kTH = 32;")]),
    "64 columns": ("tiles of 64 output columns (128 as committed)",
                   [("constexpr int kTW = 128;", "constexpr int kTW = 64;")]),
    "4 columns a lane": (
        "the vertical pass holds 4 columns a lane (8 as committed)",
        [("constexpr int kVec = 8;", "constexpr int kVec = 4;")]),
    "probe: vertical pass only": (
        "no horizontal taps: each output stores 0 (wrong on purpose)",
        [("            acc[k] = fmaf(w[q], vj[k * kRowStep * ld + b0 + q], "
          "acc[k]);", "")]),
    "probe: horizontal pass only": (
        "no vertical taps: the sums are not written (wrong on purpose)",
        [("        if (in[u]) vr[c0 + 32 * u] = v[u];", "")]),
    "taps one by one": (
        "each tap's loads wait for the last tap's chain step (4 taps' "
        "loads go out together as committed)",
        [("constexpr int kGroup = 4;", "constexpr int kGroup = 1;")]),
}
#: (n, h1, w1, h2, w2): the main path's shape (ingest's transcode to the
#: fast SF's grid), and NN's 2/3 and 1/2 pyramid levels of the fast grid
TIMED = [(60, 720, 1280, 544, 960), (60, 544, 960, 363, 640),
         (60, 544, 960, 272, 480)]
LIBRARY = "F.interpolate"


def _test_cases() -> list:
    """(n, h1, w1, h2, w2): RESIZES (3 frames, as the card test runs them)
    and RESIZE_EDGES of ``tests/test_torch_kernels.py``."""
    spec = importlib.util.spec_from_file_location(
        "test_torch_kernels",
        os.path.join(HERE, "tests", "test_torch_kernels.py"))
    tests = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tests)
    return ([(3, *shape) for shape in tests.RESIZES]
            + list(tests.RESIZE_EDGES))


def _entry(source: str) -> str:
    """The ``resize_kernel`` the main-path shape launches in a build of
    ``source``: the committed form's widest tile, ``resize_kernel<kTW>``,
    or the one untemplated kernel of a source without ``kTW``."""
    m = re.search(r"constexpr int kTW = (\d+);", source)
    return f"resize_kernelILi{m[1]}E" if m else "resize_kernel"


def _median(values) -> float:
    """The median of the values above 0 (0.0 if there is none)."""
    kept = [v for v in values if v > 0]
    return statistics.median(kept) if kept else 0.0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=PATH")
    ap.add_argument("--only", action="append", default=None,
                    choices=sorted(VARIANTS))
    ap.add_argument("--base", default=None)
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.resize import resize as k2
    from repro_torch.kernels.resize.ref import resize_ref

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    say = logger(args.out)
    say(cs.card_line())
    with open(os.path.join(build.CSRC, "resize.cu")) as f:
        sources = {"as committed": f.read()}
    for spec in args.source:
        name, path = spec.split("=", 1)
        with open(path) as f:
            sources[name] = f.read()
    for name, (_, edits) in VARIANTS.items():
        if args.only is None or name in args.only:
            sources[name] = variant_source(sources["as committed"], edits)
    base = args.base or ("parent" if "parent" in sources else "as committed")
    built = build_all(sources, os.path.join(build.BUILD_DIR,
                                            "resize_variants"), "resize")
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    kernels, result, bounds, copies = {}, {}, {}, {}
    for name, (lib, log) in built.items():
        if lib is None:
            say(f"nvcc of {name!r} failed, left out:\n{log}")
            continue
        what = VARIANTS.get(name, ("",))[0]
        entries = [(entry, regs, spill) for _, entry, regs, spill, _ in
                   cs.ptxas_builds({"resize": log})
                   if "resize_kernel" in entry]
        say(f"{name}{f' ({what})' if what else ''}: " + "; ".join(
            f"{entry} {regs} registers, {spill} bytes spilled"
            for entry, regs, spill in entries))
        result[name] = {"ptxas": {e: [r, s] for e, r, s in entries},
                        "differ": {}, "max_abs_err": {}}
        if args.sass:
            entry = _entry(sources[name])
            mix = sass_mix(tool, lib, entry)
            result[name]["sass"] = mix
            say(f"  SASS of {entry}: {sum(mix.values())} instructions: "
                + ", ".join(f"{op} {n}" for op, n in mix.items()))
        kernels[name] = c_entry(lib, "resize_bilinear", k2._ARGTYPES)
    if base not in kernels:
        say(f"no build {base!r} to hold the others against")
        return 1

    dev = torch.device("cuda")
    order = list(kernels)
    for seed, (n, h1, w1, h2, w2) in enumerate(TIMED[:1] + _test_cases()):
        case = f"{n}x{h1}x{w1}->{h2}x{w2}"
        g = torch.Generator(device=dev).manual_seed(seed)
        x = torch.rand((n, h1, w1), generator=g, device=dev) * 255
        want = resize_ref(x, h2, w2)
        bind(k2, kernels[base])
        bits = k2.resize_bilinear(x, h2, w2).view(torch.int32)
        for name in order:
            bind(k2, kernels[name])
            y = k2.resize_bilinear(x, h2, w2)
            result[name]["differ"][case] = int(
                (y.view(torch.int32) != bits).sum())
            result[name]["max_abs_err"][case] = float(
                (y - want).abs().max())
        say(f"{case} ({want.numel()} outputs): " + "; ".join(
            f"{name} {result[name]['differ'][case]} differ from {base}, "
            f"max |d| {result[name]['max_abs_err'][case]:.3g}"
            for name in order))
        del x, want, bits
    torch.cuda.empty_cache()

    for seed, (n, h1, w1, h2, w2) in enumerate(TIMED):
        case = f"{n}x{h1}x{w1}->{h2}x{w2}"
        g = torch.Generator(device=dev).manual_seed(100 + seed)
        x = torch.rand((n, h1, w1), generator=g, device=dev) * 255
        b_ms, _ = cs.bound_ms(4 * n * (h1 * w1 + h2 * w2), 0)

        def measure(name):
            if name == LIBRARY:
                def fn():
                    return F.interpolate(x[:, None], size=(h2, w2),
                                         mode="bilinear", antialias=True,
                                         align_corners=False)
            else:
                bind(k2, kernels[name])

                def fn():
                    return k2.resize_bilinear(x, h2, w2)
            return cs.time_ms(torch, fn, 20), cs.kernel_ms(torch, fn, 10)[0]

        rounds = in_turns(order + [LIBRARY], args.rounds, measure)
        for name, got in rounds.items():
            result.setdefault(name, {}).setdefault("times", {})[case] = {
                "ms": _median(r[0] for r in got),
                "card_ms": _median(r[1] for r in got), "rounds": got}
        say(f"{case}, bound {b_ms:.4f} ms (bytes): " + "; ".join(
            f"{name} {t['ms']:.4f} ms (card {t['card_ms']:.4f})"
            for name in order + [LIBRARY]
            for t in [result[name]["times"][case]]))
        bounds[case] = b_ms
        copy_ms = cs.time_ms(torch, x.clone, 20)
        copies[case] = copy_ms
        say(f"  yardstick: a copy of the input ({2 * x.nbytes / 1e6:.1f} MB "
            f"moved) takes {copy_ms:.4f} ms, "
            f"{2 * x.nbytes / copy_ms / 1e9:.2f} TB/s")
        del x
        torch.cuda.empty_cache()
    say(json.dumps({"base": base, "bound_ms": bounds, "copy_ms": copies,
                    "builds": result}))
    bad = [(name, case) for name in order if not name.startswith("probe")
           for case, n in result[name]["differ"].items() if n]
    if bad:
        say(f"builds whose bits differ from {base}'s: {bad}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
