"""K6 (rglru_scan) and its gated form (rglru_gated_scan) against other
builds of them, in turns on one card.

    python3 scripts/rglru_variants.py [--source NAME=PATH ...]
        [--only VARIANT ...] [--base NAME] [--serve] [--sass]
        [--rounds 3] [--out FILE]

The builds: the port's own ``src/repro_torch/csrc/rglru.cu`` ("as
committed"); each ``--source`` (another checkout's ``rglru.cu``, say the
one-thread-a-column kernel it replaced, ``parent=PATH``, which has only
the standalone form); and each of ``VARIANTS`` (or those named by
``--only``), the committed source with its ring, band or chunk replaced
-- each replaced text must occur exactly once, so an edited source fails
here rather than measuring something else.  All are compiled together
with the port's own ``nvcc`` flags into
``src/repro_torch/_build/rglru_variants/``; a build that fails is
reported and left out.  Each build's kernels' registers and spills are
printed from its ptxas report and, with ``--sass``, the opcode mix of
its gated bf16 kernel (``cuobjdump -sass``, ``variants.sass_mix``).

Each build is bound in turn into the port's wrappers (``rglru_scan``,
``rglru_gated_scan``) and:

* run at RecurrentGemma-9B's prefill shape (2, 4096, 4096), its decode
  shape (2, 1, 4096) from a state, and at ``SHAPES`` (the card tests'
  lengths and widths, and two ragged widths), fresh and from a state,
  with gates in bf16 and f32 from ``chip_smoke.lru_gated_inputs``: the
  standalone form on the gates' a and b (``ref.gated_ab``), its output
  elements whose bits differ from the ``--base`` build's (default
  ``parent`` where given, else the committed build; 0 expected, since
  every build runs the same fmaf chain), and the gated form's elements
  that differ from the stepped route (PyTorch's ops forming a and b, then
  the base build's standalone form; 0 expected); each against its plain
  version, within ``chip_smoke.LRU_TOL`` of the largest |h|;
* timed in turns (A B C, C B A, ...) for ``--rounds`` rounds at the
  prefill and decode shapes, bf16 gates: CUDA events over back-to-back
  calls and the card's kernel time by the profiler
  (``chip_smoke.kernel_ms``), both forms, beside the stepped route; and
  a device copy of the standalone form's a (``clone``), the card's
  reachable memory rate.

With ``--serve``, RecurrentGemma-9B at full width (bf16 weights from seed
0, as chip_smoke serves it) runs its RG-LRU layers through the committed
gated form and through the stepped route it replaced, in turns: one
``generate`` of 2 x 4096 prompts and 9 tokens a round (prefill ms and ms
a decode step, host clock to a synchronise), and one profiled prefill
and 4 profiled decode steps each (kernels, card ms, the elementwise
kernels' ms, the costliest kernels by name).

The median of the rounds whose profiler window counted a kernel is
printed, with the bytes bounds.  Ends with one JSON line; exits 1 where
a build's bits differ (standalone from the base's, gated from the
stepped route).  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

from variants import (bind, build_all, c_entry, in_turns, logger, sass_mix,
                      variant_source)

#: the register double buffer's load: a producer's pieces of step t in
#: registers, by 16-byte loads (scalar ones off the vector path)
_LOAD_PIECES = """template <class F>
__device__ __forceinline__ Pieces<F> load_pieces(const Args& p,
                                                 long long row_base, int t,
                                                 int band, int g) {
  using T = typename F::T;
  Pieces<F> x{};
  if (t >= p.S) return x;
  const long long off = row_base + (long long)t * p.W + band;
#pragma unroll
  for (int k = 0; k < F::kInputs; ++k) {
    const T* src = static_cast<const T*>(p.in[k]) + off;
#pragma unroll
    for (int c = 0; c < kCopies<F>; ++c) {
      const int col = piece_col<F>(g, c);
      if (band + col >= p.W) continue;
      x.v[k][c] = p.vec ? *reinterpret_cast<const uint4*>(src + col)
                        : load_scalar(src + col, p.W - band - col);
    }
  }
  return x;
}

"""
#: name -> (what it changes, [(text in rglru.cu, its replacement)])
VARIANTS = {
    "register double buffer": (
        "the producers' inputs in registers, one chunk ahead by plain "
        "16-byte loads (as committed: a ring of 4 chunks in shared memory, "
        "3 ahead by cp.async)",
        [("// the kGroup values of one input's pieces, widened to f32",
          _LOAD_PIECES + "// the kGroup values of one input's pieces, "
          "widened to f32"),
         ("  float sp[kGroup];\n  if (!consumer) {",
          "  float sp[kGroup];\n  Pieces<F> cur;\n  if (!consumer) {"),
         ("#pragma unroll\n"
          "    for (int s = 0; s < kStages - 1; ++s) {  // the ring's first "
          "chunks\n"
          "      fetch<F>(p, row_base, s * kSteps + st, band, g,\n"
          "               ring + s * kSlotPieces<F>, prod);\n"
          "      cp_async_commit();\n    }\n",
          "    cur = load_pieces<F>(p, row_base, st, band, g);\n"),
         ("      fetch<F>(p, row_base, t + (kStages - 1) * kSteps, band, g,\n"
          "               ring + ((j + kStages - 1) % kStages) * "
          "kSlotPieces<F>, prod);\n"
          "      cp_async_commit();\n"
          "      cp_async_wait<kStages - 1>();  // this thread's copies of "
          "chunk j\n"
          "      Pieces<F> x;\n"
          "      const uint4* slot = ring + (j % kStages) * kSlotPieces<F>;\n"
          "#pragma unroll\n"
          "      for (int k = 0; k < F::kInputs; ++k) {\n"
          "#pragma unroll\n"
          "        for (int c = 0; c < kCopies<F>; ++c) {\n"
          "          x.v[k][c] = slot[(k * kCopies<F> + c) * kProducers + "
          "prod];\n"
          "        }\n      }\n",
          "      const Pieces<F> x = cur;\n"
          "      if (j + 1 < chunks)\n"
          "        cur = load_pieces<F>(p, row_base, t + kSteps, band, g);\n"),
         ("constexpr int kSmemBytes = kAbBytes + kStages * kSlotPieces<F> * "
          "16;", "constexpr int kSmemBytes = kAbBytes;")]),
    **{f"{n} stages": (f"a ring of {n} chunks, {n - 1} in flight",
                       [("constexpr int kStages = 4;",
                         f"constexpr int kStages = {n};")])
       for n in (2, 3, 8)},
    "64-column bands": (
        "bands of 64 columns (128 blocks at the prefill shape, 2 consumer "
        "and 8 producer warps a block)",
        [("constexpr int kCols = 32;", "constexpr int kCols = 64;")]),
    "16-step chunks": ("chunks of 16 steps (2 producer warps a block)",
                       [("constexpr int kSteps = 32;",
                         "constexpr int kSteps = 16;")]),
    "f32 copies side by side": (
        "a producer's two 16-byte f32 copies side by side, so that each "
        "copy instruction of a step's producers takes every other 16 bytes "
        "of the band",
        [("  return (c * kGroups + g) * (16 / (int)sizeof(typename F::T));",
          "  return g * kGroup + c * (16 / (int)sizeof(typename F::T));")]),
}
PREFILL, DECODE = (2, 4096, 4096), (2, 1, 4096)
#: (S, W) beyond the prefill and decode shapes: the card tests' lengths
#: and widths, and widths that take the scalar loads
SHAPES = ([(s, w) for s in (1, 15, 16, 77, 300) for w in (64, 200, 4096)]
          + [(45, 13), (45, 70)])
STEPPED = "stepped route"


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
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.rglru import rglru as k6
    from repro_torch.kernels.rglru.ref import (gated_ab, rglru_gated_scan_ref,
                                               rglru_scan_ref)

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    say = logger(args.out)
    say(cs.card_line())
    with open(os.path.join(build.CSRC, "rglru.cu")) as f:
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
                                            "rglru_variants"), "rglru")
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    scans, gated, result = {}, {}, {}
    for name, (lib, log) in built.items():
        if lib is None:
            say(f"nvcc of {name!r} failed, left out:\n{log}")
            continue
        what = VARIANTS.get(name, ("",))[0]
        entries = [(entry, regs, spill) for _, entry, regs, spill, _ in
                   cs.ptxas_builds({"rglru": log})]
        say(f"{name}{f' ({what})' if what else ''}: " + "; ".join(
            f"{entry} {regs} registers, {spill} bytes spilled"
            for entry, regs, spill in entries))
        result[name] = {"ptxas": {e: [r, s] for e, r, s in entries},
                        "differ": {}, "hold": {}}
        scans[name] = c_entry(lib, "rglru_scan", k6._ARGTYPES)
        try:
            gated[name] = c_entry(lib, "rglru_gated_scan",
                                  k6._GATED_ARGTYPES)
        except AttributeError:
            say("  (no rglru_gated_scan in this build)")
        if args.sass and name in gated:
            entry = next((e for e, _, _ in entries if "bfloat16" in e), None)
            if entry:
                mix = sass_mix(tool, lib, entry)
                result[name]["sass"] = mix
                say(f"  SASS of {entry}: {sum(mix.values())} instructions: "
                    + ", ".join(f"{op} {n}" for op, n in mix.items()))
    if base not in scans:
        say(f"no build {base!r} to hold the others against")
        return 1

    dev = torch.device("cuda")
    order = list(scans)
    cases = [(PREFILL, False), (DECODE, True)] + [
        ((2, s, w), with_h0) for s, w in SHAPES for with_h0 in (False, True)]
    for seed, ((bsz, s, w), with_h0) in enumerate(cases):
        for dtype in (torch.bfloat16, torch.float32):
            case = f"{bsz}x{s}x{w} {str(dtype)[6:]}{' from h0' * with_h0}"
            x = cs.lru_gated_inputs(torch, bsz, s, w, dtype, dev, seed,
                                    with_h0)
            h0 = x[4]
            a, b = gated_ab(*x[:4])
            bind(k6, scans[base])
            bits = k6.rglru_scan(a, b, h0)
            want, want_g = rglru_scan_ref(a, b, h0), rglru_gated_scan_ref(*x)
            scale = cs.LRU_TOL * max(1.0, float(want.abs().max()))
            for name in order:
                bind(k6, scans[name])
                got = k6.rglru_scan(a, b, h0)
                diff = {"standalone": int((got != bits).sum())}
                hold = {"standalone": float((got - want).abs().max()) / scale}
                if name in gated:
                    bind(k6, gated[name], "_gated_kernel")
                    got = k6.rglru_gated_scan(*x)
                    diff["gated"] = int((got != bits).sum())
                    hold["gated"] = float((got - want_g).abs().max()) / scale
                result[name]["differ"][case] = diff
                result[name]["hold"][case] = hold
                del got
            say(f"{case} ({bits.numel()} elements): " + "; ".join(
                f"{name} {result[name]['differ'][case]} differ "
                f"(hold {max(result[name]['hold'][case].values()):.3g})"
                for name in order))
            del x, a, b, bits, want, want_g
    torch.cuda.empty_cache()

    pre = cs.lru_gated_inputs(torch, *PREFILL, torch.bfloat16, dev, 100)
    dec = cs.lru_gated_inputs(torch, *DECODE, torch.bfloat16, dev, 101, True)
    pre_ab, dec_ab = gated_ab(*pre[:4]), gated_ab(*dec[:4])
    committed_scan = scans["as committed"]

    def stepped(x):
        return k6.rglru_scan(*gated_ab(*x[:4]), x[4])

    def measure(name):
        out = {}
        if name == STEPPED:
            bind(k6, committed_scan)
            forms = {"gated": stepped}
        else:
            bind(k6, scans[name])
            forms = {"standalone": lambda x: k6.rglru_scan(
                *(pre_ab if x is pre else dec_ab), x[4])}
            if name in gated:
                bind(k6, gated[name], "_gated_kernel")
                forms["gated"] = lambda x: k6.rglru_gated_scan(*x)
        for form, fn in forms.items():
            out[f"{form} prefill"] = (
                cs.time_ms(torch, lambda: fn(pre), 20),
                cs.kernel_ms(torch, lambda: fn(pre), 10)[0])
            out[f"{form} decode"] = (
                cs.time_ms(torch, lambda: fn(dec), 200),
                cs.kernel_ms(torch, lambda: fn(dec), 50)[0])
        return out

    rounds = in_turns(order + [STEPPED], args.rounds, measure)
    n = PREFILL[0] * PREFILL[1] * PREFILL[2]
    bounds = {"standalone prefill": 3 * 4 * n / cs.PEAK_BYTES_S * 1e3,
              "gated prefill": (3 * 2 + 4) * n / cs.PEAK_BYTES_S * 1e3,
              "standalone decode": 4 * 4 * PREFILL[0] * PREFILL[2]
              / cs.PEAK_BYTES_S * 1e3,
              "gated decode": (3 * 2 + 2 * 4) * PREFILL[0] * PREFILL[2]
              / cs.PEAK_BYTES_S * 1e3}
    say("bounds (bytes at 3.35 TB/s), ms: " + json.dumps(bounds))
    for name, got in rounds.items():
        times = {key: {"ms": _median(r[key][0] for r in got),
                       "card_ms": _median(r[key][1] for r in got),
                       "rounds": [r[key] for r in got]} for key in got[0]}
        result.setdefault(name, {})["times"] = times
        say(f"{name}: " + "; ".join(
            f"{key} {t['ms']:.4f} ms (card {t['card_ms']:.4f})"
            for key, t in times.items()))
    a = pre_ab[0]
    copy_ms = cs.time_ms(torch, a.clone, 20)
    result["copy"] = {"ms": copy_ms, "tb_s": 2 * a.nbytes / copy_ms / 1e9}
    say(f"yardstick: a copy of a {tuple(a.shape)} f32 "
        f"({2 * a.nbytes / 1e6:.1f} MB moved) takes {copy_ms:.4f} ms, {result['copy']['tb_s']:.2f} "
        f"TB/s")
    del pre, dec, pre_ab, dec_ab, a
    torch.cuda.empty_cache()

    if args.serve:
        result["serve"] = serve(torch, cs, say, committed_scan,
                                gated["as committed"], args.rounds)
    say(json.dumps({"base": base, "bound_ms": bounds, "builds": result}))
    bad = [(name, case) for name in order
           for case, diff in result[name]["differ"].items()
           if any(diff.values())]
    if bad:
        say(f"builds whose bits differ: {bad}")
        return 1
    return 0


def serve(torch, cs, say, scan, gated_scan, rounds: int) -> dict:
    """RecurrentGemma-9B served with its RG-LRU layers on the committed
    gated form and on the stepped route, in turns; one profile of each."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.rglru import ops
    from repro_torch.kernels.rglru import rglru as k6
    from repro_torch.kernels.rglru.ref import gated_ab
    from repro_torch.launch.serve import generate
    from repro_torch.models import decode_step, prefill, recurrent

    bind(k6, scan)
    bind(k6, gated_scan, "_gated_kernel")

    def stepped(r, i, xc, a_param, h0=None):
        return k6.rglru_scan(*gated_ab(r, i, xc, a_param), h0)

    routes = {"gated form": ops.lru_gated_scan, STEPPED: stepped}
    cfg = get_config(cs.HYBRID_ARCH)
    model, prompts = cs.served_model(torch, cfg, torch.device("cuda"),
                                     cs.HYBRID_BATCH, cs.HYBRID_PROMPT)
    new = 9
    for route in routes.values():
        recurrent.lru_gated_scan = route
        generate(model, cfg, prompts, new)  # warm-up

    def serve_route(name):
        recurrent.lru_gated_scan = routes[name]
        _, t_pre, t_dec = generate(model, cfg, prompts, new)
        return t_pre * 1e3, t_dec / (new - 1) * 1e3

    got = in_turns(list(routes), rounds, serve_route)
    out = {}
    for name, route in routes.items():
        recurrent.lru_gated_scan = route
        cache = {}

        def run_prefill():
            cache["c"] = prefill(model, cfg, {"tokens": prompts},
                                 prompts.shape[1] + new)[1]

        def run_steps():
            tok, c = prompts[:, -1], cache["c"]
            for _ in range(4):
                logits, c = decode_step(model, cfg, {"tokens": tok[:, None]},
                                        c)
                tok = torch.argmax(logits, dim=-1)

        out[name] = {"prefill_ms": [p for p, _ in got[name]],
                     "step_ms": [s for _, s in got[name]]}
        for what, fn in (("prefill", run_prefill),
                         ("4 decode steps", run_steps)):
            busy, count, top = cs.device_time(torch, fn)
            elem = sum(ms for n, ms, _ in top if "elementwise" in n)
            out[name][what] = {"kernels": count, "card_ms": busy,
                               "elementwise_ms": elem,
                               "top": [list(t) for t in top[:12]]}
            say(f"serve profile {cfg.name} with the {name}, {what}: {count} "
                f"kernels, {busy:.2f} ms on the card, elementwise kernels "
                f"{elem:.2f} ms; top: " + "; ".join(
                    f"{n[:60]} {ms:.2f} ms x{c}" for n, ms, c in top[:12]))
        say(f"serve {cfg.name} {cs.HYBRID_BATCH} x {cs.HYBRID_PROMPT} "
            f"with the {name}: prefill {statistics.median(out[name]['prefill_ms']):.1f}"
            f" ms, decode {statistics.median(out[name]['step_ms']):.2f} ms a "
            f"step (median of {rounds}; rounds {got[name]})")
    recurrent.lru_gated_scan = ops.lru_gated_scan
    return out


if __name__ == "__main__":
    sys.exit(main())
