"""K4's bf16 prefill kernel against variants of its own source, on one card.

    python3 scripts/prefill_variants.py [--rounds 2] [--out FILE]

Each variant is ``src/repro_torch/csrc/attention.cu`` with a few lines
replaced (``VARIANTS``; each replaced text must occur in the source exactly
once, so an edited source fails here rather than measuring something
else).  All are compiled together, with the port's own ``nvcc`` flags,
into ``src/repro_torch/_build/variants/``; each variant's
``prefill_mma_kernel<hd, capped>`` registers and spilled bytes are
printed from its ptxas report.  Then, at the five bf16 prefill shapes
``chip_smoke.py`` times (inputs as it makes them, from seed 1), every
variant runs through the port's wrapper (``flash_attention``), is held by
``ref.HOLD`` against the plain version and is timed by CUDA events, 10
calls after a warm-up, in turns (A B C D, D C B A, ...) for ``--rounds``
rounds; the least time of the rounds and the worst hold are printed with
the nominal TFLOP/s (4·hd a kept pair).  Ends with one JSON line.  Needs
one CUDA card.  ``variants.py`` holds what this script shares with
``scan_variants.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from variants import bind, build_all, c_entry, in_turns, logger, variant_source

#: name -> (what it changes, [(text in attention.cu, its replacement)])
VARIANTS = {
    "as committed": ("the source as it is", []),
    "copy loop unrolled": (
        "the k/v cp.async loop unrolled",
        [("#pragma unroll 1\n    for (int i = tid; i < BK * CH;",
          "#pragma unroll\n    for (int i = tid; i < BK * CH;")]),
    "16 keys at hd 256": (
        "key tiles of 16 at hd 256 (32 as committed)",
        [("return HD == 256 ? 32 : 64;", "return HD == 256 ? 16 : 64;")]),
    "3 blocks an SM at hd <= 128": (
        "3 blocks an SM at hd <= 128; the q tile, held in registers there, "
        "staged in stage 1's k rows, so no shared memory of its own",
        [("return (kBQ + 4 * tc_keys<HD>()) * (HD + 8) * 2;",
          "return (HD <= 128 ? 4 * tc_keys<HD>() : kBQ + 4 * tc_keys<HD>())"
          " * (HD + 8) * 2;"),
         ("__launch_bounds__(kTcThreads, 2)",
          "__launch_bounds__(kTcThreads, HD <= 128 ? 3 : 2)"),
         ("  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(tc_smem);"
          "  // [kBQ][LD]\n  __nv_bfloat16* kv_s = q_s + kBQ * LD;",
          "  __nv_bfloat16* kv_s = reinterpret_cast<__nv_bfloat16*>(tc_smem)"
          " + (HD <= 128 ? 0 : kBQ * LD);\n  __nv_bfloat16* q_s = HD <= 128 ?"
          " kv_s + 2 * BK * LD : reinterpret_cast<__nv_bfloat16*>(tc_smem);"
          )]),
}

#: (name, (B, S, H, KV, hd), keyword arguments) as chip_smoke.py times them
SHAPES = (("dense, causal", (4, 2048, 24, 2, 128), {}),
          ("non-causal", (8, 1499, 16, 16, 80), {"causal": False}),
          ("window 2048", (2, 4096, 16, 1, 256), {"window": 2048}),
          ("gemma2 capped", (2, 8160, 8, 4, 256), {"logit_cap": 50.0}),
          ("gemma2 capped, window 4096", (2, 8160, 8, 4, 256),
           {"window": 4096, "logit_cap": 50.0}))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.attention import attention as k4
    from repro_torch.kernels.attention.ref import attention_ref, hold_ratio

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    say = logger(args.out)
    say(cs.card_line())
    with open(os.path.join(build.CSRC, "attention.cu")) as f:
        source = f.read()
    built = build_all({name: variant_source(source, edits)
                       for name, (_, edits) in VARIANTS.items()},
                      os.path.join(build.BUILD_DIR, "variants"), "variant")
    kernels, result = {}, {}
    for name, (lib, log) in built.items():
        if lib is None:
            raise SystemExit(f"nvcc of variant {name!r} failed:\n{log}")
        regs = {f"<{hd}, {str(cap).lower()}>": rs for (hd, cap), rs in
                sorted(cs.tensor_core_prefill_builds(
                    cs.ptxas_builds({"attention": log})).items())}
        say(f"{name} ({VARIANTS[name][0]}): " + "; ".join(
            f"{k} {r} registers, {s} bytes spilled"
            for k, (r, s) in regs.items()))
        kernels[name] = c_entry(lib, "flash_attention", k4._ARGTYPES)
        result[name] = {"ptxas": regs, "forms": {}}

    dev = torch.device("cuda")
    order = list(kernels)
    for form, (b, s, h, kvh, d), kw in SHAPES:
        cap = kw.get("logit_cap", 0.0)
        if cap:
            q, k, v = cs.capped_inputs(torch, dev, b, s, s, h, kvh, d, 1, 0,
                                       cap)
        else:
            q, k, v = cs.attention_inputs(torch, dev, b, s, s, h, kvh, d, 1,
                                          torch.float32)
        q, k, v = (t.bfloat16() for t in (q, k, v))
        want = attention_ref(q, k, v, **kw)
        w = kw.get("window", 0)
        pairs = b * h * (s * s if kw.get("causal", True) is False else sum(
            min(i + 1, w or s) for i in range(s)))

        def measure(name):
            bind(k4, kernels[name])
            return (hold_ratio(k4.flash_attention(q, k, v, **kw), want),
                    cs.time_ms(torch, lambda: k4.flash_attention(q, k, v,
                                                                 **kw), 10))

        rounds = in_turns(order, args.rounds, measure)
        for name in order:
            ms = min(t for _, t in rounds[name])
            result[name]["forms"][form] = {
                "ms": ms, "rounds_ms": [t for _, t in rounds[name]],
                "hold": max(x for x, _ in rounds[name]),
                "tflop_s": 4 * d * pairs / (ms * 1e-3) / 1e12}
        say(f"{form}: " + "; ".join(
            f"{name} {x['ms']:.4f} ms ({x['tflop_s']:.1f} TFLOP/s, hold "
            f"{x['hold']:.3f})" for name in order
            for x in [result[name]["forms"][form]]))
        del q, k, v, want
        torch.cuda.empty_cache()
    say(json.dumps({"variants": result}))
    bad = [(n, f) for n, r in result.items() for f, x in r["forms"].items()
           if not x["hold"] <= 1.0]
    if bad:
        say(f"variants that fail ref.HOLD: {bad}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
