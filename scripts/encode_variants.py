"""K3's encoder form (``dct8_encode_chunks``) against variants of its own
source and the stepped route it replaced, in turns on one card.

    python3 scripts/encode_variants.py [--only VARIANT ...] [--rounds 3]
        [--sass] [--full-golden] [--out FILE]

The builds: ``src/repro_torch/csrc/dct8.cu`` as committed and each of
``VARIANTS`` (or those named by ``--only``), that source with a few lines
replaced -- each replaced text must occur exactly once, so an edited source
fails here rather than measuring something else -- compiled together with
the port's own ``nvcc`` flags into ``src/repro_torch/_build/
encode_variants/``.  Each build's ``encode_chunks_kernel`` registers and
spills are printed from its ptxas report and, with ``--sass``, its opcode
mix as compiled (``cuobjdump -sass``).  Beside them runs the stepped route:
``ref.encode_chunks_stepped`` over the standalone K3 and K1 wrappers, a
frame position of every chunk a step, as the encoder ran before its
encoder form.

At chip_smoke's two ingest shapes -- a jackson segment at 720p (120 x 720
x 1280, the golden SF's keyframe 250) and the same segment transcoded to
the fast SF (60 x 544 x 960, keyframe 10), as ingest makes them -- each
build, bound in turn into the port's wrapper, is held against the stepped
route (equal, symbol for symbol), then timed in turns (A B C, C B A, ...)
for ``--rounds`` rounds: CUDA events over 10 back-to-back calls (the
stepped route 3), the card's kernel time by the profiler over 5 (the
stepped route 2: the sum of all its kernels), and the wall of one
``codec.segment.encode_segment`` (device encode, copy to the host, entropy
coding): at the fast SF's own level (zlib 3), and for the golden shape at
zlib level 1, since its own level (9: ``zstandard`` is absent there) takes
minutes; ``--full-golden`` adds one golden ``encode_segment`` at its own
level with the committed build.  The median of the rounds is printed (of
the rounds whose profiler window counted the kernels: a trace sometimes
comes back empty, PERF.md §7).
Ends with one JSON line.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

from variants import (bind, build_all, c_entry, in_turns, logger, sass_mix,
                      variant_source)


def _fetch_ahead(p: int) -> list:
    """Frames t+1 .. t+p fetched into a register ring while step t
    computes (t+1 alone as committed)."""
    ring = ", ".join(f"load({a})" for a in range(p))
    return [("  uint2 next = load(0);", f"  uint2 ring[{p}] = {{{ring}}};"),
            ("    const uint2 px = next;\n    next = load(t + 1);",
             "    const uint2 px = ring[0];\n#pragma unroll\n"
             f"    for (int a = 0; a + 1 < {p}; ++a) ring[a] = ring[a + 1];\n"
             f"    ring[{p - 1}] = load(t + {p});")]


#: 4 threads an 8x8 block, thread i coding rows i and i + 4: the geometry,
#: then each row body of the step wrapped in a loop over the two rows
_TWO_ROWS = [
    ("constexpr int kEncMinBlocks = 14;", "constexpr int kEncMinBlocks = 7;"),
    ("ex[2][kEncThreads / 8][kLd]", "ex[2][kEncThreads / 4][kLd]"),
    ("const long long blk = g / 8;", "const long long blk = g / 4;"),
    ("const int i = (int)(g % 8);", "const int i = (int)(g % 4);"),
    ("xs = ex[0][threadIdx.x / 8];", "xs = ex[0][threadIdx.x / 4];"),
    ("cs = ex[1][threadIdx.x / 8];", "cs = ex[1][threadIdx.x / 4];"),
    ("0xffu << (threadIdx.x & 24u)", "0xfu << (threadIdx.x & 28u)"),
    ("const long long threads = groups * 8;",
     "const long long threads = groups * 4;"),
    ("""    return __ldg(reinterpret_cast<const uint2*>(
        src + (long long)(t < tlast ? t : tlast) * frame));
  };
  uint2 next = load(0);
  float pred[8];
#pragma unroll
  for (int l = 0; l < 8; ++l) pred[l] = 128.0f;""",
     """    const uint8_t* p = src + (long long)(t < tlast ? t : tlast) * frame;
    const uint2 a = __ldg(reinterpret_cast<const uint2*>(p));
    const uint2 b = __ldg(reinterpret_cast<const uint2*>(p + 4LL * w));
    return make_uint4(a.x, a.y, b.x, b.y);
  };
  uint4 next = load(0);
  float pred[2][8];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int l = 0; l < 8; ++l) pred[r][l] = 128.0f;
  }"""),
    ("""    const uint2 px = next;
    next = load(t + 1);

    // the residual row into the exchange
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      const unsigned word = l < 4 ? px.x : px.y;
      const float p = (float)((word >> (8 * (l & 3))) & 0xffu);
      xs[l * 8 + i] = __fsub_rn(p, pred[l]);
    }""",
     """    const uint4 px = next;
    next = load(t + 1);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int l = 0; l < 8; ++l) {
        const unsigned word = r ? (l < 4 ? px.z : px.w)
                                : (l < 4 ? px.x : px.y);
        const float p = (float)((word >> (8 * (l & 3))) & 0xffu);
        xs[l * 8 + i + 4 * r] = __fsub_rn(p, pred[r][l]);
      }
    }"""),
    ("""    const int4 q = dct8_row(xt, D, Q, i);
    reinterpret_cast<int4*>(dst)[i] = q;
    const int16_t* s = reinterpret_cast<const int16_t*>(&q);
#pragma unroll
    for (int l = 0; l < 8; ++l) cs[l * 8 + i] = dequant(s[l], Q[i * 8 + l]);""",
     """#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int ir = i + 4 * r;
      const int4 q = dct8_row(xt, D, Q, ir);
      reinterpret_cast<int4*>(dst)[ir] = q;
      const int16_t* s = reinterpret_cast<const int16_t*>(&q);
#pragma unroll
      for (int l = 0; l < 8; ++l) {
        cs[l * 8 + ir] = dequant(s[l], Q[ir * 8 + l]);
      }
    }"""),
    ("""    float o[8];
    idct8_row(xt, D, i, o);
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      pred[l] = fminf(fmaxf(__fadd_rn(pred[l], o[l]), 0.0f), 255.0f);
    }""",
     """#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float o[8];
      idct8_row(xt, D, i + 4 * r, o);
#pragma unroll
      for (int l = 0; l < 8; ++l) {
        pred[r][l] = fminf(fmaxf(__fadd_rn(pred[r][l], o[l]), 0.0f), 255.0f);
      }
    }"""),
]

#: name -> (what it changes, [(text in dct8.cu, its replacement)])
VARIANTS = {
    "fetch 2 ahead": (
        "frames t+1 and t+2 fetched while step t computes (t+1 as "
        "committed)", _fetch_ahead(2)),
    "fetch 4 ahead": (
        "frames t+1 .. t+4 fetched while step t computes", _fetch_ahead(4)),
    "4 threads a block": (
        "4 threads an 8x8 block, 2 rows each (8 threads of 1 row as "
        "committed), registers sized for 7 blocks an SM", _TWO_ROWS),
    "no register cap": (
        "launch bounds without a minimum of blocks an SM (14 as committed)",
        [("constexpr int kEncMinBlocks = 14;",
          "constexpr int kEncMinBlocks = 1;")]),
}
STEPPED = "stepped route"


def _median(values) -> float:
    """The median of the values above 0 (0.0 if there is none)."""
    kept = [v for v in values if v > 0]
    return statistics.median(kept) if kept else 0.0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", action="append", default=None,
                    choices=sorted(VARIANTS))
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--full-golden", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from repro_torch.analytics.scene import generate_segment
    from repro_torch.codec import segment as S
    from repro_torch.codec import transform as T
    from repro_torch.core.knobs import FidelityOption, IngestSpec
    from repro_torch.kernels import build
    from repro_torch.kernels.dct8 import dct8 as k3
    from repro_torch.kernels.dct8 import ops
    from repro_torch.kernels.dct8.ref import encode_chunks_stepped

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    say = logger(args.out)
    say(cs.card_line())
    with open(os.path.join(build.CSRC, "dct8.cu")) as f:
        source = f.read()
    names = ["as committed"] + (args.only or list(VARIANTS))
    texts = {"as committed": source}
    texts.update({name: variant_source(source, VARIANTS[name][1])
                  for name in names[1:]})
    built = build_all(texts, os.path.join(build.BUILD_DIR, "encode_variants"),
                      "encode")
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    kernels, result = {}, {}
    for name, (lib, log) in built.items():
        if lib is None:
            say(f"nvcc of {name!r} failed, left out:\n{log}")
            continue
        entry = [b for b in cs.ptxas_builds({"dct8": log})
                 if "encode_chunks_kernel" in b[1]]
        regs, spill = entry[0][2], entry[0][3]
        what = VARIANTS[name][0] if name in VARIANTS else "the source as it is"
        say(f"{name} ({what}): encode_chunks_kernel {regs} registers, "
            f"{spill} bytes spilled")
        result[name] = {"registers": regs, "spilled": spill, "shapes": {}}
        if args.sass:
            mix = sass_mix(tool, lib, "encode_chunks_kernel")
            result[name]["sass"] = sum(mix.values())
            say(f"  SASS: {sum(mix.values())} instructions, " + ", ".join(
                f"{op} {n}" for op, n in list(mix.items())[:16]))
        kernels[name] = c_entry(lib, "dct8_encode_chunks",
                                k3._ENCODE_ARGTYPES)
    result[STEPPED] = {"shapes": {}}

    def stepped(f, k, qs):
        return encode_chunks_stepped(f, k, qs, k3.dct8_quantize,
                                     k3.dct8_dequantize)

    dev = torch.device("cuda")
    spec = IngestSpec(height=720, width=1280, fps=30, segment_seconds=4)
    formats = cs.smoke_config().storage_formats()
    raw = torch.from_numpy(generate_segment("jackson", 0, spec)[0]).to(dev)
    order = list(kernels) + [STEPPED]
    route = ops.dct_encode_chunks
    for shape, sf_id in (("golden", "sf_g"), ("fast", "sf1")):
        sf = formats[sf_id]
        f = T.convert_fidelity(raw, FidelityOption(), sf.fidelity,
                               spec).contiguous()
        k, qs = sf.coding.keyframe, sf.fidelity.quant_scale
        level = sf.coding.zstd_level if shape == "fast" else 1
        want = stepped(f, k, qs)
        for name in kernels:
            bind(k3, kernels[name], "_encode_kernel")
            n_diff = int((k3.dct8_encode_chunks(f, k, qs) != want).sum())
            result[name]["shapes"][shape] = {"differ": n_diff}
            if n_diff:
                say(f"{name}, {shape}: {n_diff} symbols differ from the "
                    f"stepped route")

        def measure(name):
            if name == STEPPED:
                def fn():
                    return stepped(f, k, qs)
                S.dct_encode_chunks = stepped
                calls = (3, 2)
            else:
                bind(k3, kernels[name], "_encode_kernel")
                def fn():
                    return k3.dct8_encode_chunks(f, k, qs)
                S.dct_encode_chunks = route
                calls = (10, 5)
            ms = cs.time_ms(torch, fn, calls[0])
            card_ms, _ = cs.kernel_ms(torch, fn, calls[1])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            S.encode_segment(f, quant_scale=qs, keyframe_interval=k,
                             zstd_level=level)
            return ms, card_ms, (time.perf_counter() - t0) * 1e3

        rounds = in_turns(order, args.rounds, measure)
        S.dct_encode_chunks = route
        for name in order:
            got = rounds[name]
            result[name]["shapes"].setdefault(shape, {}).update({
                "ms": _median(r[0] for r in got),
                "card_ms": _median(r[1] for r in got),
                "encode_segment_ms": _median(r[2] for r in got),
                "rounds": got})
        say(f"{shape} {tuple(f.shape)} k {k}, encode_segment at zlib "
            f"{level}: " + "; ".join(
                f"{name} {x['ms']:.4f} ms (card {x['card_ms']:.4f}), "
                f"encode_segment {x['encode_segment_ms']:.1f} ms"
                for name in order for x in [result[name]["shapes"][shape]]))
        if shape == "golden" and args.full_golden:
            bind(k3, kernels["as committed"], "_encode_kernel")
            t0 = time.perf_counter()
            S.encode_segment(f, quant_scale=qs, keyframe_interval=k,
                             zstd_level=sf.coding.zstd_level)
            full = (time.perf_counter() - t0) * 1e3
            result["as committed"]["golden_encode_segment_own_level_ms"] = full
            say(f"golden encode_segment at its own level "
                f"({sf.coding.zstd_level}, zlib {min(9, sf.coding.zstd_level)}"
                f"), the committed build: {full:.1f} ms")
        del f, want
        torch.cuda.empty_cache()
    say(json.dumps({"variants": result}))
    bad = [(n, s) for n, r in result.items() for s, x in r["shapes"].items()
           if x.get("differ")]
    if bad:
        say(f"builds whose symbols differ from the stepped route: {bad}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
