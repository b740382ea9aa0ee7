"""K5 (mamba_scan) against other builds of it, in turns on one card.

    python3 scripts/scan_variants.py [--source NAME=PATH ...]
        [--only VARIANT ...] [--serve] [--sass] [--rounds 3] [--out FILE]

The builds: the port's own ``src/repro_torch/csrc/mamba_scan.cu`` ("as
committed"); each ``--source`` (another checkout's ``mamba_scan.cu``, say
the parent's); and each of ``VARIANTS`` (or those named by ``--only``),
that source with a few lines replaced -- each replaced text must occur
exactly once, so an edited source fails here rather than measuring
something else.
All are compiled together with the port's own ``nvcc`` flags into
``src/repro_torch/_build/scan_variants/``; a build that fails is reported
and left out.  Each build's ``scan_kernel`` registers and spills are
printed from its ptxas report, with its launch geometry where it reports
one (``mamba_scan.geometry``) and, with ``--sass``, the opcode mix of its
``scan_kernel<bf16, 16>`` as compiled (``cuobjdump -sass``,
``variants.sass_mix``).

Each build is bound in turn into the port's wrapper (``mamba_scan``) and:

* held against the plain version within ``chip_smoke.SCAN_TOL`` of the
  largest value, y and the final state, at ``CASES`` (inputs as
  ``chip_smoke.scan_inputs`` makes them);
* timed by CUDA events in turns (A B C, C B A, ...) for ``--rounds``
  rounds at Falcon-Mamba-7B's prefill shape (4, 2048, 8192, 16, xc bf16;
  20 calls) and decode shape (4, 1, 8192, 16 from a state; 200
  back-to-back calls, and the kernel's own time by the profiler);
* with ``--serve`` (not the probes, whose results are wrong on purpose),
  bound into Falcon-Mamba-7B at full width (bf16
  weights from seed 0, as chip_smoke serves it) for one untimed
  ``generate`` and then, in turns, one timed ``generate`` of 4 x 2048
  prompts and 9 tokens a round: the prefill ms and ms a decode step
  (host clock to a synchronise, ``launch/serve.py::generate``).

The least time of the rounds is printed for each.  Ends with one JSON
line.  Needs one CUDA card.  ``variants.py`` holds what this script
shares with ``prefill_variants.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from variants import (bind, build_all, c_entry, in_turns, logger, sass_mix,
                      variant_source)

#: the one ``load_row`` of mamba_scan.cu takes float4s; a lane of 2 states
#: (4 lanes at n 8) needs a scalar copy
_SCALAR_ROWS = [
    ('  static_assert(K % 4 == 0, "a lane\'s states come in float4s");\n'
     "#pragma unroll\n  for (int i = 0; i < K; i += 4) {",
     "  if constexpr (K % 4 != 0) {\n#pragma unroll\n"
     "    for (int i = 0; i < K; ++i) v[i] = p[i];\n  } else {\n"
     "#pragma unroll\n  for (int i = 0; i < K; i += 4) {"),
    ("    v[i + 3] = q.w;\n  }\n}", "    v[i + 3] = q.w;\n  }\n  }\n}")]

#: name -> (what it changes, [(text in the source, its replacement)])
VARIANTS = {
    "1 lane": (
        "one lane a channel, its 16 states in registers, 4 blocks an SM",
        [("constexpr int kLanes = 2;", "constexpr int kLanes = 1;"),
         ("constexpr int kMinBlocks = 8;", "constexpr int kMinBlocks = 4;")]),
    "4 lanes": (
        "4 lanes a channel (4 states a lane at n 16), 16 channels a block, "
        "16 blocks an SM",
        [("constexpr int kLanes = 2;", "constexpr int kLanes = 4;"),
         ("constexpr int kMinBlocks = 8;", "constexpr int kMinBlocks = 16;"),
         *_SCALAR_ROWS]),
    "255 registers": (
        "at most 255 registers a thread (4 blocks an SM, 2 waves at the "
        "prefill shape)",
        [("constexpr int kMinBlocks = 8;", "constexpr int kMinBlocks = 4;")]),
    "128 threads": (
        "blocks of 128 threads (64 channels), 4 blocks an SM",
        [("constexpr int kThreads = 64;", "constexpr int kThreads = 128;"),
         ("constexpr int kMinBlocks = 8;", "constexpr int kMinBlocks = 4;")]),
    "unroll 4": (
        "a full chunk's steps unrolled by 4, not 16",
        [("#pragma unroll\n      for (int tt = 0; tt < kChunk; ++tt)",
          "#pragma unroll 4\n      for (int tt = 0; tt < kChunk; ++tt)")]),
    "chunk 8": ("chunks of 8 steps",
                [("constexpr int kChunk = 16;", "constexpr int kChunk = 8;")]),
    "fetch after compute": (
        "chunk j+1 fetched after chunk j computes, not before",
        [("    if (more) fetch((j + 1) * kChunk);", ""),
         ("if (more) stash(st ^ 1);",
          "if (more) {\n      fetch((j + 1) * kChunk);\n"
          "      stash(st ^ 1);\n    }")]),
    "accurate expf": (
        "expf(delta·a) with its range reduction, a not pre-scaled",
        [('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));',
          "r = expf(x);"),
         ("constexpr float kLog2e = 1.4426950408889634f;",
          "constexpr float kLog2e = 1.0f;")]),
    # timing probes: wrong results, each takes one cost away
    "probe: no exp": (
        "2^x replaced by 1 + x on the fp32 pipe (wrong)",
        [('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));',
          "r = 1.0f + x;")]),
    "probe: b, c loaded once a chunk": (
        "every step reads the chunk's first b and c rows (wrong)",
        [("load_row(&b_s[st][tt * N + sub * SL], bv);",
          "load_row(&b_s[st][sub * SL], bv);"),
         ("load_row(&c_s[st][tt * N + sub * SL], cv);",
          "load_row(&c_s[st][sub * SL], cv);")]),
}

#: (name, (B, S, inner, n), xc dtype name, a kind, with h0) held per build
CASES = (("prefill", (4, 2048, 8192, 16), "bfloat16", "init", False),
         ("prefill, drawn a", (4, 2048, 8192, 16), "bfloat16", "drawn", False),
         ("n 8, drawn a", (4, 2048, 8192, 8), "bfloat16", "drawn", False),
         ("decode from a state", (4, 1, 8192, 16), "bfloat16", "drawn", True),
         ("ragged S and width, f32", (2, 2049, 1000, 16), "float32", "drawn",
          True))
PREFILL = (4, 2048, 8192, 16)
DECODE = (4, 1, 8192, 16)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=PATH")
    ap.add_argument("--only", action="append", default=None,
                    help="build only these variants (and the sources)")
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.mamba_scan import mamba_scan as k5
    from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    say = logger(args.out)
    say(cs.card_line())
    sources = {"as committed": open(os.path.join(build.CSRC,
                                                 "mamba_scan.cu")).read()}
    for spec in args.source:
        name, path = spec.split("=", 1)
        sources[name] = open(path).read()
    for name, (_, edits) in VARIANTS.items():
        if args.only is None or name in args.only:
            sources[name] = variant_source(sources["as committed"], edits)
    built = build_all(sources, os.path.join(build.BUILD_DIR, "scan_variants"),
                      "scan")
    scans, result = {}, {}
    for name, (lib, log) in built.items():
        if lib is None:
            say(f"nvcc of {name!r} failed, left out:\n{log}")
            continue
        what = VARIANTS.get(name, ("",))[0]
        builds = cs.scan_builds(cs.ptxas_builds({"mamba_scan": log}))
        say(f"{name}{f' ({what})' if what else ''}: " + "; ".join(
            f"<{xdt}, {n}> {regs} registers, {spill} bytes spilled"
            for (xdt, n), (regs, spill) in sorted(builds.items())))
        scans[name] = c_entry(lib, "mamba_scan", k5._ARGTYPES)
        result[name] = {"ptxas": {f"<{x}, {n}>": rs for (x, n), rs in
                                  sorted(builds.items())}, "holds": {}}
        if args.sass:
            mix = sass_mix(os.path.join(os.path.dirname(build.nvcc_path()),
                                        "cuobjdump"), lib,
                           "scan_kernelI13__nv_bfloat16Li16E")
            result[name]["sass"] = mix
            say(f"  SASS of scan_kernel<bf16, 16>: {sum(mix.values())} "
                f"instructions: " + ", ".join(f"{k} {v}" for k, v in
                                              mix.items()))
        try:
            bind(k5, c_entry(lib, "mamba_scan_geometry",
                             k5._GEOMETRY_ARGTYPES), "_geometry")
        except AttributeError:
            say("  (no mamba_scan_geometry in this build)")
            continue
        geo = k5.geometry(16, torch.bfloat16, PREFILL[0], PREFILL[2])
        result[name]["geometry"] = geo
        say(f"  geometry at {PREFILL}: {geo}")

    dev = torch.device("cuda")
    order = list(scans)
    for seed, (case, shape, xdt, a_kind, with_h0) in enumerate(CASES):
        inputs = cs.scan_inputs(torch, *shape, getattr(torch, xdt), dev,
                                seed, with_h0, a_kind)
        y_ref, h_ref = mamba_scan_ref(*inputs)
        for name in order:
            bind(k5, scans[name])
            y, h = k5.mamba_scan(*inputs)
            err = max(cs.rel_err(torch, y, y_ref), cs.rel_err(torch, h, h_ref))
            result[name]["holds"][case] = err
            del y, h
        say(f"hold {case} {shape} {xdt}, a {a_kind}: " + "; ".join(
            f"{name} {result[name]['holds'][case]:.3g}" for name in order))
        del inputs, y_ref, h_ref
        torch.cuda.empty_cache()

    pre = cs.scan_inputs(torch, *PREFILL, torch.bfloat16, dev, 0)
    dec = cs.scan_inputs(torch, *DECODE, torch.bfloat16, dev, 1, True)

    def time_build(name):
        bind(k5, scans[name])
        return {"prefill": cs.time_ms(torch, lambda: k5.mamba_scan(*pre), 20),
                "decode": cs.time_ms(torch, lambda: k5.mamba_scan(*dec), 200),
                "decode_device": cs.kernel_ms(
                    torch, lambda: k5.mamba_scan(*dec), 50)[0]}

    rounds = in_turns(order, args.rounds, time_build)
    times = {name: {k: [r[k] for r in rounds[name]] for k in rounds[name][0]}
             for name in order}
    for name in order:
        # a profiler trace may come back empty (0 ms): such rounds are left
        # out of the least time
        best = {k: min([x for x in v if x > 0], default=0.0)
                for k, v in times[name].items()}
        result[name]["times"] = {k: {"ms": best[k], "rounds_ms": v}
                                 for k, v in times[name].items()}
        say(f"{name}: prefill {best['prefill']:.4f} ms, decode "
            f"{best['decode']:.4f} ms by events, "
            f"{best['decode_device']:.4f} ms on the card "
            f"(rounds {times[name]})")
    del pre, dec
    torch.cuda.empty_cache()

    if args.serve:
        from repro_torch.configs import get_config
        from repro_torch.launch.serve import generate

        cfg = get_config(cs.SERVE_ARCH)
        model, prompts = cs.served_model(torch, cfg, dev)
        order = [name for name in order if not name.startswith("probe")]
        for name in order:
            bind(k5, scans[name])
            generate(model, cfg, prompts, 9)  # warm-up

        def serve_build(name):
            bind(k5, scans[name])
            _, t_pre, t_dec = generate(model, cfg, prompts, 9)
            return t_pre * 1e3, t_dec / 8 * 1e3

        rounds = in_turns(order, args.rounds, serve_build)
        serve = {name: {"prefill_ms": [p for p, _ in rounds[name]],
                        "step_ms": [t for _, t in rounds[name]]}
                 for name in order}
        for name in order:
            result[name]["serve"] = serve[name]
            say(f"serve {cfg.name} 4 x 2048 with {name}: prefill "
                f"{min(serve[name]['prefill_ms']):.1f} ms, decode "
                f"{min(serve[name]['step_ms']):.2f} ms a step (rounds "
                f"{serve[name]})")
    say(json.dumps({"builds": result}))
    bad = [(n, c) for n, r in result.items() for c, e in r["holds"].items()
           if not e <= cs.SCAN_TOL and not n.startswith("probe")]
    if bad:
        say(f"builds that fail the hold: {bad}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
