#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Seven paths, each through the entry points a user calls, each with the
launch counters zeroed just before it and read just after: the video path
(below), the configuration phase (backward derivation on the card), the
serving phase (Falcon-Mamba-7B), the dense serving phase (StarCoder2-3B),
the hybrid serving phase (RecurrentGemma-9B), the audio phase
(HuBERT-XLarge's encoder) and the gemma2 serving phase (Gemma2-2B),
further below.

Drives the port's main path at the paper's 720p30 through the entry points
a user calls: ``VideoStore.ingest_segment`` writes segments 1 and 3 of
``jackson`` and of ``dashcam`` (120 frames of 720x1280 each; of the first
4, these hold every stage's items) into a
golden SF and a fast-coded SF, then ``run_query`` runs Query A
(Diff -> S-NN -> NN) on jackson and Query B (Motion -> License -> OCR) on
dashcam.  The launch counters are zeroed just before ingest and read just
after it and just after the queries: K3's encoder form
(dct8_encode_chunks, a segment's whole DPCM encode in one launch) must
launch once a segment and coded format (8 times), the standalone K3
(dct8_quantize) never, K1 (dct8_dequantize) not in ingest but in the
queries (the decoder's), K2 (resize_bilinear) at least once.

On 720p30 scenes Query A's Diff flags no event (cars move a few pixels a
frame, far under its threshold, tuned on 96x160 scenes at 8 fps), so its
cascade stops there.  A second counted path, the stage phase, therefore
drives every item-producing stage of both cascades through
``BatchedConsumer`` over both segments of its stream with every consumed
frame activated: S-NN and NN on jackson, Motion, License and OCR on
dashcam at their configured CFs, and Diff on dashcam at the golden SF's
full-rate 720p, where the camera's pan makes it fire.  Its counters are
zeroed just before it and read just after; NN must launch K2 once per
pyramid level it resizes to.

Then it checks what came out:
* each kernel against its plain PyTorch version on the card, at the
  shapes the main path gives it: K3's symbols on identical residual input
  (equal but for at most 1e-6 of them, by one), K1 at atol 1e-3 (the
  reference's Pallas-vs-jnp bound), K2 at atol 1e-3 on 0-255 data
  (ingest's transcode to the fast SF's grid, NN's 2/3 pyramid level of
  the golden grid and 300 of OCR's plate patches to 9 x 26), timed by
  CUDA events and by the profiler, its four ``resize_kernel<TW>`` builds
  spilling nothing;
* K3's encoder form on a golden segment (120 x 720 x 1280, keyframe 250),
  the same segment transcoded to the fast SF (60 x 544 x 960, keyframe
  10) and a ragged case (13 frames in chunks of 5, squares whose edges
  ring past 0 and 255): symbols equal to the stepped K3 + K1 route's
  (the standalone kernels, torch's add and clamp), within K3's bound of
  the plain version, and each defect of ``ref.ENCODE_MUTANTS`` (the
  prediction reset every frame, the clamp dropped, a tail padded with
  mid-grey) failing that bound on the ragged case (the reset on every
  case); timed at the golden and fast shapes by CUDA events and by the
  profiler beside the stepped route, and one segment's ingest encode into
  the fast SF profiled (busy share, kernels by name);
* each query's stage stats against the plain path (the port on the CPU)
  on the same store, and Query B's items at F1 >= 0.98; Query A's items
  are empty on both paths, as its Diff stage flags nothing;
* each stage-phase run's items per segment against the same run on the
  CPU: equal, and never empty;
* the golden SF decodes on the card to the plain decode's frames, at
  35 dB PSNR or better against the ingested frames.
An item comparison fails when either side is empty.
Each kernel is timed (CUDA events) beside its plain version and, where one
PyTorch call computes the same function, that call (``library_ms``), with
the least time the card could take (``bound_ms``).

The configuration phase runs the paper's backward derivation on the card
at the reference's spec (96x160, 8 fps: the operators' thresholds were
tuned there, and every candidate SF is entropy-coded on the host) with
``benchmarks/common.py``'s setting: ``derive_config`` over a ``Profiler``
of 2 sample segments a stream, 12 consumers (all six operators at 0.9 and
0.8).  Profiling materializes through K2, the standalone K3 and K1
(``apply_quality``), encodes through K3's encoder form and decodes
through K1; each must launch.  It prints the derived table, the
profiler's runs and seconds by activity, the measured dct8 dispatch costs
(``dct_backend`` must be "cuda") and the shape ladder ``derive_shapes``
makes of the measured dispatch overhead; checks R1-R3, golden, the
accuracy targets and the boundary search's saving; recomputes every
profiled accuracy with the plain versions bound on the card and derives
again from a ``TableProfiler`` of those accuracies and the card's speeds
and storage tables (CFs, SFs and rounds log must equal the card's); plans
erosion at 0.8, 0.5 and 0.3 of the full storage (golden intact); stores 2
segments a stream in the derived formats, queries them through the
derived configuration and ladder, and holds stage stats and items against
the plain path on the CPU; then materializes the video path's first
720p30 segment into every derived CF, held against the plain versions
(max |d| 1, at most 1e-3 of the pixels), and times ``apply_quality`` at
(120, 720, 1280) beside its bound.

The serving phase serves ``falcon-mamba-7b`` at its published width and
depth (64 layers, d_model 4096, inner 8192, state 16, vocab 65024) with
bf16 weights drawn from a seed on the card: ``launch/serve.py``'s
``generate`` prefills a batch of 4 random 2048-token prompts and decodes
32 greedy tokens (the first from the prefill, 31 serve steps), after one
untimed warm-up run of the same traffic.  K5 (mamba_scan) must launch 64
times for the prefill and 64 for each of the 31 serve steps.  A profiled
prefill and 4 profiled decode steps then report the card's kernel time
against the timed run's wall time (its busy share).  Then, with
f32 weights and a 128-token prompt, it holds the kernel route against the
same model with the plain scan forced on the card (logits within 1e-3 of
their largest magnitude, greedy tokens equal, ``generate`` serving over
the launcher's bf16 cache in every serving phase's hold) and 124-token
prefill + 4 decode steps over an f32 cache against the full forward (the
same bound), and K5 against its plain version (y and the final state
within 1e-5 of the largest value) at one layer's prefill shape (4, 2048,
8192, n 16), with ``a`` as initialised and drawn per (channel, state),
at n 8, at S = 1 from a non-zero state, and at S 2,049 over 1,000
channels (ragged in both); the plain version on each input-level mutant
(``ref.MUTANTS``: state n-1 dropped from y, b and c a step late, h0
ignored) must fail that hold.  K5 is timed at the prefill shape and at
the decode shape (4, 1, 8192, 16) from a state, there by CUDA events over
back-to-back calls and by the profiler, beside its bytes bound; its
launch geometry (lanes a channel, blocks, warps an SM) is printed.

The dense serving phase serves ``starcoder2-3b`` at its published width
and depth (30 layers, d_model 3072, 24 heads over 2 KV heads, head_dim
128, d_ff 12288, vocab 49152) with bf16 weights drawn from a seed on the
card and a bf16 KV cache, with the same traffic and warm-up through
``generate``.  K4 (flash_attention) must launch 30 times for the prefill
and 30 for each serve step.  A profiled prefill and 4 profiled decode
steps report the busy share.  Then, with f32 weights and a 128-token
prompt, it holds 124-token prefill + 4 decode steps against the full
forward and the kernel route against the same model with K4's plain
version bound in its place (logits within 1e-3 of their largest
magnitude, 8 greedy tokens equal), and K4 against its plain version at one
layer's prefill shape (4, 2048, 24 over 2 heads, 128), at head_dim 64
with 16 heads over 16, and in the decode form (one query row over a
(4, 2080, 2, 128) cache at length 2049), within one bf16 ulp (2^-7) of
the largest output.  K4 is timed beside
``F.scaled_dot_product_attention`` as its yardstick (``library_ms``),
which the port never calls.

The hybrid serving phase serves ``recurrentgemma-9b`` at its published
width and depth (38 layers: 26 RG-LRU and 12 local attention, d_model
4096, 16 heads over 1 KV head, head_dim 256, window 2048, GeGLU d_ff
12288, vocab 256000) with bf16 weights drawn from a seed on the card:
``generate`` prefills a batch of 2 random 4096-token prompts (longer than
the window, so the prefill's window masks and the ring buffers wrap on the
first decode step) and decodes 32 greedy tokens, after one untimed
warm-up.  K6's gated form (rglru_gated_scan: a and b formed in registers
from the gates) must launch 26 times, the standalone K6 (rglru_scan)
never, and K4 12 times for the prefill and for each serve step.  Then,
with f32 weights, batch 1 and a 2088-token prompt, it holds a 2080-token
prefill + 8 decode steps against the full forward and the kernel route
against the same model with K6's gated form's and K4's plain versions
bound in their place (1e-3 of the largest |logit|, 8 greedy tokens
equal); K6 against its plain version at one layer's prefill shape (2,
4096, 4096) and at S 1 from a state (within 2^-20 of the largest |h|);
K6's gated form at the same shapes, in bf16 and f32 gates, against its
plain version (the same 2^-20) and element by element against the
stepped route it replaced (PyTorch's ops forming a and b, then K6: the
elements that differ are printed, 0 expected), each of
``ref.GATED_MUTANTS`` failing that hold; and K4 against its plain
version with the window at head_dim 256 (2, 4096, 16 over 1, 256) and in
its decode form over a full ring, element by element within
``ref.HOLD``, in bf16 and in f32.  K4 with the window is timed beside
``F.scaled_dot_product_attention`` with an explicit banded mask; no
single PyTorch call computes K6.  Both
forms of K6 are timed at the prefill shape and at the decode shape (2, 1,
4096) from a state, by CUDA events over back-to-back calls and by the
profiler, beside their bytes bounds; the gated form also beside the
stepped route.  The build prints the registers of K6's three
``scan_kernel`` instances and checks that none spills.

The audio phase encodes with ``hubert-xlarge`` at its published width and
depth (48 layers, d_model 1280, 16 heads over 16 of head_dim 80, GeLU d_ff
5120, 504 cluster targets, bidirectional attention) with bf16 weights
drawn from a seed on the card: ``models.forward`` over a batch of 8 random
clips of 1,499 frame embeddings each -- 30 s of 16-kHz audio through
HuBERT's convolutional frontend (stride 320), which the reference stubs
with precomputed embeddings -- once untimed, then 3 timed forwards.  K4's
non-causal form must launch 48 times a forward and its causal form never.
A profiled forward reports the busy share and K4's share of the card
time.  Then, with f32 weights and 2 clips, it holds the kernel route
against the same model with K4's plain version bound in its place (1e-3
of the largest |logit|), and K4 against its plain version at the phase's
shape (8, 1499, 16, 80), element by element within ``ref.HOLD``, in bf16
and f32; the causal plain version and the plain version with keys
1472..1498 (the last, partial key tile) zeroed must fail that hold.  K4 is
timed beside ``F.scaled_dot_product_attention(is_causal=False)``.

The gemma2 serving phase serves ``gemma2-2b`` at its published width and
depth (26 layers alternating local, window 4096, and global attention; d
2304, 8 heads over 4 KV heads of 256, GeGLU d_ff 9216, vocab 256000 tied;
attention soft-cap 50, final soft-cap 30, post-norms; arXiv:2408.00118)
with bf16 weights drawn from a seed on the card: ``generate`` prefills a
batch of 2 random 8,160-token prompts and decodes 32 greedy tokens, which
fills gemma2's 8,192-token context, after one untimed warm-up; the window
masks in the prefill and in every decode step.  K4's capped form must
launch 13 times and its capped windowed form 13 times for the prefill and
for each serve step, its uncapped forms never.  Then, with f32 weights,
batch 1 and a 4,200-token prompt, it holds a 4,192-token prefill + 8
decode steps over an f32 cache against the full forward, and the kernel
route against K4's plain version over the launcher's bf16 cache; and K4's
capped forms against their plain versions at the phase's shapes, element
by element within ``ref.HOLD``: the prefill form with and without the
window (bf16 and f32), the decode form over a cache at length 8,161 with
and without the window (bf16), and the decode form with an f32 query over
that bf16 cache, with inputs whose scores exceed the cap in every query
row by construction; the plain version without the cap, and without the
window, must fail the hold.  The capped forms are timed beside their plain
versions; the prefill forms also beside ``flex_attention`` with the
soft-cap as its score_mod and the causal or windowed block mask (one
PyTorch call of the same function, held by ``ref.HOLD`` in f32 as K4 is;
its bf16 time is ``library_ms``) and beside
``F.scaled_dot_product_attention`` of the uncapped function.

K4's decode form runs split-KV (a split kernel and a combine kernel a
call).  Each serving phase counts its serve steps' K4 launches apart from
its prefill's (through a pass-through wrapper of the launcher's
``prefill``), holds each decode form with the plain version whose middle
split (of K4's split plan) has its values zeroed failing the hold, and
gives each of its four decode forms -- dense over 2,049 keys, the
hybrid's full ring, gemma2's capped over 8,161 keys with and without the
window -- a ``kernels`` row of its own: the serve steps' launches, CUDA
event ms and the kernels' time on the card by the profiler (``device_ms``,
split + combine), plain ms, the bytes bound, and one PyTorch call of the
same function as ``library_ms`` (SDPA with ``enable_gqa`` over the valid
keys, or ``flex_attention`` with the soft-cap as score_mod over the keys
seen), that call held by ``ref.HOLD`` in f32 against K4's plain version
first; each prints its split plan.

K4's prefill form runs a bf16 call on the tensor cores
(``prefill_mma_kernel``).  The profiled prefill of each serving phase
that runs K4, and the encoder's profiled forward, must show every K4
launch on that kernel and none on the f32 ``prefill_kernel``; each bf16
prefill row (dense, the hybrid's window, the encoder's non-causal form,
gemma2's two capped forms) also gives ``tflop_s``, 4·hd a kept pair over
its CUDA-event ms.  The build prints each ``prefill_mma_kernel<hd,
capped>``'s registers and checks that none of the ten spills; the same
for K5's four ``scan_kernel<xc, n>`` builds.

Prints the queries' x-realtime, each serving phase's prefill time and
decode rate, the audio phase's encode time, a ``{"kernels": [...]}`` line,
the card's name and power limit, and last ``{"ok": true, "device":
{...}}``.  Exits
non-zero without that last line when there is no CUDA card or a check
fails.  Run from the repository root: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# the video path's segments of each stream: 1 and 3 hold every stage's
# items (jackson 1 NN's, dashcam 3 Motion's, License's and OCR's), so no
# "neither may be empty" check loses its items with 2 segments of 4
SEGMENTS = (1, 3)
STREAMS = {"A": "jackson", "B": "dashcam"}
ACCURACY = 0.8
# NVIDIA H100 SXM data sheet: HBM3 bandwidth, fp32 without tensor cores,
# bf16 on the tensor cores (dense)
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOP_S = 67e12
PEAK_BF16_FLOP_S = 989e12
# Hopper special-function units: 16 exp2 per SM per clock, 132 SMs
SFU_PER_SM_CLOCK = 16
SMS = 132
# profiler windows kernel_ms takes before it counts a short one
PROFILER_WINDOWS = 5

# the configuration phase: benchmarks/common.py's derivation (every
# operator, accuracies 0.9 and 0.8, 2 sample segments a stream); erosion
# planned at fig. 12's budgets, fractions of the full storage
CONFIG_ACCURACIES = (0.9, 0.8)
CONFIG_SEGMENTS = 2
EROSION_BUDGETS = (0.8, 0.5, 0.3)
# the serving phase: Falcon-Mamba-7B at full width, bf16 weights
SERVE_ARCH = "falcon-mamba-7b"
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 2048, 32
SERVE_SEED = 0
HOLD_PROMPT, HOLD_DECODE, HOLD_NEW = 128, 4, 8
LOGIT_TOL = 1e-3  # of the largest |logit|: f32 weights, sums reordered
SCAN_TOL = 1e-5   # of the largest |value|: K5 vs its plain version
# the dense serving phase: StarCoder2-3B at full width, bf16 weights and
# KV cache, the same traffic
DENSE_ARCH = "starcoder2-3b"
DECODE_LEN = 2049  # K4's decode form is held at this cache length
# the hybrid serving phase: RecurrentGemma-9B at full width, bf16 weights
# and ring buffers; prompts longer than the 2048-token window
HYBRID_ARCH = "recurrentgemma-9b"
HYBRID_BATCH, HYBRID_PROMPT = 2, 4096
HYBRID_HOLD_PROMPT, HYBRID_HOLD_DECODE = 2088, 8  # 2080 prefilled, > window
# K6 vs its plain version, of max(1, max |h|): both round each step once;
# the plain version's float64 step may land one ulp off at a float32 tie
LRU_TOL = 2 ** -20
# the audio phase: HuBERT-XLarge's encoder at full width, bf16 weights;
# 30-s clips of 16-kHz audio are 1,499 frames after the conv frontend
# (receptive field 400 samples, stride 320)
AUDIO_ARCH = "hubert-xlarge"
AUDIO_BATCH, AUDIO_FRAMES, AUDIO_CLIP_S = 8, 1499, 30.0
AUDIO_TIMED, AUDIO_HOLD_BATCH = 3, 2
# the gemma2 serving phase: Gemma2-2B at full width, bf16 weights and KV
# cache; 8,160-token prompts + 32 new tokens fill its 8,192-token context
GEMMA2_ARCH = "gemma2-2b"
GEMMA2_BATCH, GEMMA2_PROMPT = 2, 8160
GEMMA2_HOLD_PROMPT, GEMMA2_HOLD_DECODE = 4200, 8  # 4192 prefilled > window


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def smoke_config():
    """Two coded SFs serving both queries at ACCURACY, shaped like the
    reference's tests/test_query.py config: the cheap stages read a
    fast-coded SF with keyframe 10 (so chunk-skip decode runs), NN and OCR
    read golden."""
    from repro_torch.core.coalesce import SFNode
    from repro_torch.core.configure import DerivedConfig
    from repro_torch.core.consumption import Consumer, ConsumerPlan
    from repro_torch.core.knobs import (GOLDEN_CODING, CodingOption,
                                        FidelityOption as F)

    # The operators' thresholds and kernels were sized on 96x160 scenes;
    # the cheap stages consume at the 100p rung (96x176 at this spec),
    # where a 720p scene has that geometry.  License needs its plates at
    # pixel scale (540p), NN and OCR read golden.
    cfs = {"diff": F("good", 1.0, 100, 1 / 2),
           "snn": F("good", 1.0, 100, 1 / 2),
           "motion": F("good", 1.0, 100, 1 / 2),
           "license": F("good", 1.0, 540, 1 / 2),
           "nn": F("best", 1.0, 720, 2 / 3),
           "ocr": F("best", 1.0, 720, 1.0)}
    plans = {op: ConsumerPlan(Consumer(op, ACCURACY), cf, 0.85, 100.0)
             for op, cf in cfs.items()}
    cheap = [plans[op] for op in ("diff", "snn", "motion", "license")]
    fid = cheap[0].cf
    for p in cheap[1:]:
        fid = fid.join(p.cf)
    fast = SFNode(fid, CodingOption("fast", 10), cheap)
    golden = SFNode(F(), GOLDEN_CODING, [plans["nn"], plans["ocr"]],
                    golden=True)
    return DerivedConfig(plans=list(plans.values()), nodes=[fast, golden],
                         coalesce_log=None, dct_backend="cuda")


def ingest_all(vs, segments: tuple[int, ...]):
    """Ingest ``segments`` of each stream, one thread per segment
    (scene rendering and entropy coding run on the host, and zlib releases
    the interpreter lock).  Returns the first segment's frames."""
    import concurrent.futures

    from repro_torch.analytics.scene import generate_segment

    jobs = [(s, seg) for s in STREAMS.values() for seg in segments]

    def ingest(job):
        t0 = time.perf_counter()
        frames, _ = generate_segment(job[0], job[1], vs.spec)
        t1 = time.perf_counter()
        vs.ingest_segment(job[0], job[1], frames)
        print(f"ingest {job[0]}:{job[1]}: scene {t1 - t0:.1f} s, "
              f"transcode {time.perf_counter() - t1:.1f} s", flush=True)
        return frames

    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = [pool.submit(ingest, job) for job in jobs]
        frames = [f.result() for f in futures]
    vs.flush()
    return frames[0]


def stage_runs(cfg) -> list[tuple]:
    """(stream, op, sf_id, cf) of the stage phase: every stage of both
    cascades but Query A's Diff, at its configured CF and SF, and Diff at
    the golden SF's own fidelity on Query B's panning dashcam."""
    from repro_torch.analytics.query import stage_specs
    from repro_torch.core.knobs import FidelityOption

    runs = [(stream, op, sf_id, cf)
            for q, stream in STREAMS.items()
            for op, _op, cf, sf_id in stage_specs(cfg, q, ACCURACY)
            if (q, op) != ("A", "diff")]
    return runs + [(STREAMS["B"], "diff", "sf_g", FidelityOption())]


def drive_stage(vs, run, frames: list, launches) -> dict:
    """One stage-phase run: the operator through ``BatchedConsumer`` over
    ``frames`` (one stack per segment, on any device), each consumed
    frame activated.  Returns its items per segment, stats, wall seconds
    and the K2 launches its detect calls made."""
    import torch

    from repro_torch.analytics.batch import BatchedConsumer
    from repro_torch.analytics.operators import OPERATORS
    from repro_torch.codec import transform as T

    _stream, op, _sf, cf = run
    pos = T.sample_indices(vs.spec.frames_per_segment, cf.sampling)
    k2 = launches.snapshot().get("resize_bilinear", 0)
    t0 = time.perf_counter()
    items, stats = BatchedConsumer(vs.spec).consume(
        OPERATORS[op], cf, [(seg, f, pos) for seg, f in enumerate(frames)])
    if frames[0].is_cuda:
        torch.cuda.synchronize()
    return {"items": items, "stats": stats,
            "s": time.perf_counter() - t0,
            "k2": launches.snapshot().get("resize_bilinear", 0) - k2}


def nn_pyramid_resizes(cf, spec) -> int:
    """K2 launches one NN detect call makes at ``cf``: one per pyramid
    level whose grid differs from the frames' own."""
    from repro_torch.analytics.operators import NN

    _, h, w = spec.resolve(cf)
    return sum((max(14, int(h * s)), max(14, int(w * s))) != (h, w)
               for s in NN.scales)


def run_queries(vs, cfg, segments: tuple[int, ...]) -> dict:
    from repro_torch.analytics.query import run_query

    return {q: run_query(vs, cfg, q, stream, list(segments), ACCURACY)
            for q, stream in STREAMS.items()}


def time_ms(torch, fn, reps):
    """Mean device time of ``fn()`` over ``reps`` launches, after a warm-up
    launch, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FP32_FLOP_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    return float(out.stdout.split()[0]) * 1e6


def ptxas_builds(reports: dict) -> list[tuple]:
    """Each kernel entry of the ``nvcc -Xptxas -v`` reports ``{source:
    log}``: (source, entry function, registers, bytes spilled (stores +
    loads), its register and spill lines)."""
    built = []
    for name, log in reports.items():
        for line in log.splitlines():
            if "entry function" in line:
                built.append((name, line.split("'")[1] if "'" in line
                              else "", [0], [0], []))
            elif built and built[-1][0] == name and (
                    "registers" in line or "spill" in line):
                _, _, regs, spill, lines = built[-1]
                lines.append(line.split(":", 1)[-1].strip())
                if "Used" in line:
                    regs[0] = int(line.split("Used ")[1].split()[0])
                else:
                    spill[0] += sum(int(n) for n in re.findall(
                        r"(\d+) bytes spill", line))
    return [(name, entry, regs[0], spill[0], lines)
            for name, entry, regs, spill, lines in built]


def tensor_core_prefill_builds(built: list[tuple]) -> dict:
    """``ptxas_builds``' ``prefill_mma_kernel<hd, capped>`` of attention.cu
    (its arguments from the mangled name): (hd, capped) -> (registers,
    bytes spilled)."""
    out = {}
    for name, entry, regs, spill, _ in built:
        m = re.search(r"prefill_mma_kernelILi(\d+)ELb([01])E", entry)
        if name == "attention" and m:
            out[int(m[1]), m[2] == "1"] = (regs, spill)
    return out


def scan_builds(built: list[tuple]) -> dict:
    """``ptxas_builds``' ``scan_kernel<TX, N>`` of mamba_scan.cu (its
    arguments from the mangled name): (xc dtype, n) -> (registers, bytes
    spilled)."""
    out = {}
    for name, entry, regs, spill, _ in built:
        m = re.search(r"scan_kernelI(f|13__nv_bfloat16)Li(\d+)E", entry)
        if name == "mamba_scan" and m:
            out["float32" if m[1] == "f" else "bfloat16", int(m[2])] = (
                regs, spill)
    return out


def lru_builds(built: list[tuple]) -> dict:
    """``ptxas_builds``' ``scan_kernel<F>`` instances of rglru.cu (the
    form from the mangled name): form -> (registers, bytes spilled)."""
    out = {}
    for name, entry, regs, spill, _ in built:
        if name == "rglru" and "scan_kernel" in entry:
            form = ("standalone" if "Stepped" in entry else
                    "gated bf16" if "bfloat16" in entry else "gated f32")
            out[form] = (regs, spill)
    return out


def lru_gated_inputs(torch, bsz, s, w, dtype, dev, seed, with_h0=False):
    """K6's gated form's inputs as the RG-LRU mixer gives them: r and i
    sigmoids and xc a conv output, in ``dtype``; ``a_param`` float32
    spread around its initial value, every 7th column above softplus's
    threshold of 20 and every 11th from the 4th at -30 (a rounds to 1, so
    1 - a² meets the 1e-12 floor); optionally a state h0."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    r, i = (torch.sigmoid(1.5 * randn(bsz, s, w)).to(dtype) for _ in "ri")
    xc = randn(bsz, s, w).to(dtype)
    a_param = 0.5 + 2.0 * randn(w)
    a_param[::7] = 25.0
    a_param[3::11] = -30.0
    return r, i, xc, a_param, (randn(bsz, w) if with_h0 else None)


def scan_inputs(torch, bsz, s, inner, n, x_dtype, dev, seed, with_h0=False,
                a_kind="init"):
    """K5's inputs as the Mamba mixer gives them on the card: float32
    softplus steps, silu'd activations and B/C rows in ``x_dtype``,
    optionally a non-zero initial state; ``a`` as initialised,
    ``-(1..n)`` per channel (``a_kind`` "init"), or ``-exp(u)`` with u
    drawn uniform in [log 0.05, log 50] per (channel, state) ("drawn"),
    so that no power of one decay gives the others."""
    import math

    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    delta = F.softplus(randn(bsz, s, inner) - 2.0)
    xc = F.silu(randn(bsz, s, inner)).to(x_dtype)
    bmat, cmat = randn(bsz, s, n).to(x_dtype), randn(bsz, s, n).to(x_dtype)
    if a_kind == "init":
        a = -torch.arange(1, n + 1, dtype=torch.float32, device=dev).repeat(
            inner, 1)
    else:
        a = -torch.exp(torch.empty((inner, n), device=dev).uniform_(
            math.log(0.05), math.log(50.0), generator=g))
    return delta, xc, bmat, cmat, a, (randn(bsz, inner, n) if with_h0
                                      else None)


def device_time(torch, fn, warmup=False) -> tuple[float, int, list]:
    """Runs ``fn()`` once under ``torch.profiler``; returns the time the
    card was busy with kernels, in ms (the union of the kernels'
    intervals), the number of kernels, and every kernel name as (name, ms,
    launches), costliest first.  (0.0, 0, []) when the trace holds no
    kernel.  A trace misses the kernels of its first few calls; with
    ``warmup`` the profiler runs ``fn()`` once untraced (its schedule's
    warm-up step) and traces the second run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)
                 if warmup else None) as prof:
        for _ in range(2 if warmup else 1):
            fn()
            torch.cuda.synchronize()
            if warmup:
                prof.step()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and e.time_range.end > e.time_range.start
               and not e.name.startswith(("Command Buffer Full",
                                          "ProfilerStep"))]
    busy, end = 0.0, float("-inf")
    for e in sorted(kernels, key=lambda e: e.time_range.start):
        start = max(e.time_range.start, end)
        if e.time_range.end > start:
            busy += e.time_range.end - start
            end = e.time_range.end
    by_name: dict[str, list] = {}
    for e in kernels:
        row = by_name.setdefault(e.name, [0.0, 0])
        row[0] += (e.time_range.end - e.time_range.start) / 1e3
        row[1] += 1
    rows = sorted(((n, ms, c) for n, (ms, c) in by_name.items()),
                  key=lambda r: -r[1])
    return busy / 1e3, len(kernels), rows


def rel_err(torch, got, want) -> float:
    """max |got - want| over max(1, max |want|)."""
    return float((got.float() - want.float()).abs().max()) / max(
        1.0, float(want.float().abs().max()))


def timed_serve(torch, check, model, cfg, prompts, per_step: dict):
    """One untimed warm-up of ``generate``, then the timed and counted run
    (counters zeroed just before it, read just after, and read between its
    prefill and its first serve step through a pass-through wrapper of
    the launcher's ``prefill``).  Checks that each kernel of ``per_step``
    launched its given number of times (one per layer it serves) for the
    prefill and for each serve step.  Returns (tokens, launches, prefill
    launches, prefill s, decode s)."""
    from repro_torch.kernels import build
    from repro_torch.launch import serve

    serve.generate(model, cfg, prompts, SERVE_NEW)  # warm-up, not counted
    torch.cuda.reset_peak_memory_stats()
    prefill, in_prefill = serve.prefill, {}

    def counted_prefill(*args, **kw):
        out = prefill(*args, **kw)
        in_prefill.update(build.LAUNCHES.snapshot())
        return out

    serve.prefill = counted_prefill
    try:
        build.LAUNCHES.reset()
        toks, t_prefill, t_decode = serve.generate(model, cfg, prompts,
                                                   SERVE_NEW)
        torch.cuda.synchronize()
        launches = build.LAUNCHES.snapshot()
    finally:
        serve.prefill = prefill
    steps = SERVE_NEW - 1
    bsz, plen = prompts.shape
    print(f"serve {cfg.name}: prefill {bsz}x{plen} in "
          f"{t_prefill * 1e3:.1f} ms; {steps} serve steps in "
          f"{t_decode * 1e3:.1f} ms ({t_decode / steps * 1e3:.2f} ms a step, "
          f"{bsz * steps / t_decode:.1f} tok/s decode); peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
          f"launches {launches}, {in_prefill} of them in the prefill",
          flush=True)
    for kernel, n in per_step.items():
        want = n * (1 + steps)
        check(launches.get(kernel, 0) == want
              and in_prefill.get(kernel, 0) == n,
              f"serve {cfg.name}: {kernel} launched "
              f"{launches.get(kernel, 0)} times, {in_prefill.get(kernel, 0)} "
              f"in the prefill, {n} per prefill and per serve step ({want} "
              f"expected)")
    check(tuple(toks.shape) == (bsz, SERVE_NEW)
          and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          f"serve {cfg.name}: greedy tokens {tuple(toks.shape)} in [0, vocab)")
    return toks, launches, in_prefill, t_prefill, t_decode


def profile_serve(torch, model, cfg, prompts, toks, t_prefill, t_decode,
                  check=None, k4_prefill=0):
    """Where the device time goes: kernel time of one prefill and of 4
    decode steps under the profiler, against the unprofiled wall time of
    the timed run.  With ``k4_prefill`` launches of K4 a prefill, checks
    that the profiled prefill ran them all on the tensor-core kernel."""
    from repro_torch.models import decode_step, prefill

    steps = SERVE_NEW - 1
    cache = {}

    def run_prefill():
        cache["c"] = prefill(model, cfg, {"tokens": prompts},
                             prompts.shape[1] + SERVE_NEW)[1]

    def run_steps():
        tok = toks[:, -1]
        c = cache["c"]
        for _ in range(4):
            logits, c = decode_step(model, cfg, {"tokens": tok[:, None]}, c)
            tok = torch.argmax(logits, dim=-1)

    for what, fn, wall_ms in (("prefill", run_prefill, t_prefill * 1e3),
                              ("4 decode steps", run_steps,
                               4 * t_decode / steps * 1e3)):
        busy, count, top = device_time(torch, fn)
        share = (f"{busy / wall_ms:.1%} of the timed run's {wall_ms:.1f} ms"
                 if busy else "not measured (no device time in the trace)")
        print(f"serve profile {cfg.name}, {what}: {count} kernels, "
              f"{busy:.1f} ms on the card, {share}; top: " + "; ".join(
                  f"{name[:60]} {ms:.1f} ms x{n}" for name, ms, n in top[:6]),
              flush=True)
        if k4_prefill and what == "prefill":
            check_tensor_core_prefill(check, f"serve profile {cfg.name}, "
                                      f"prefill", top, k4_prefill)


@contextlib.contextmanager
def plain_versions(plains):
    """Within the block, each ``module.name`` of ``plains`` (module, name,
    plain) is bound to its plain version, which runs on the card."""
    kernels = [getattr(module, name) for module, name, _ in plains]
    for module, name, plain in plains:
        setattr(module, name, plain)
    try:
        yield
    finally:
        for (module, name, _), kernel in zip(plains, kernels):
            setattr(module, name, kernel)


def hold_serve(torch, check, model, cfg, hold, n_decode, plains):
    """With f32 weights on the prompts ``hold`` (B, P): prefill of all but
    ``n_decode`` tokens plus that many decode steps over an f32 cache
    against the full forward, then the kernel route against the same model
    with each ``module.name`` of ``plains`` (module, name, plain) bound to
    its plain version: forward logits within ``LOGIT_TOL`` of the largest
    |logit|, the greedy tokens of ``generate`` (over the launcher's bf16
    cache) equal."""
    from repro_torch.launch.serve import generate
    from repro_torch.models import decode_step, forward, prefill

    bsz, plen = hold.shape
    full = forward(model, cfg, {"tokens": hold})
    p = plen - n_decode
    logits, cache = prefill(model, cfg, {"tokens": hold[:, :p]}, plen)
    errs = [rel_err(torch, logits, full[:, :p])]
    del logits
    for t in range(p, plen):
        step, cache = decode_step(model, cfg, {"tokens": hold[:, t:t + 1]},
                                  cache)
        errs.append(rel_err(torch, step, full[:, t]))
    check(bool(torch.isfinite(full).all())
          and tuple(full.shape) == (bsz, plen, cfg.vocab_size)
          and max(errs) <= LOGIT_TOL,
          f"hold {cfg.name}: prefill({p}) + {n_decode} decode steps vs "
          f"forward({plen}), f32, logits {tuple(full.shape)} finite, "
          f"max |d| {max(errs):.3g} of the largest |logit| "
          f"({float(full.abs().max()):.3g})")
    toks_k, _, _ = generate(model, cfg, hold, HOLD_NEW)
    with plain_versions(plains):
        full_p = forward(model, cfg, {"tokens": hold})
        toks_p, _, _ = generate(model, cfg, hold, HOLD_NEW)
    err = rel_err(torch, full, full_p)
    check(err <= LOGIT_TOL and torch.equal(toks_k, toks_p),
          f"hold {cfg.name}: kernel route vs plain version on the card, f32, "
          f"forward logits max |d| {err:.3g} of the largest |logit|, "
          f"{HOLD_NEW} greedy tokens equal: {torch.equal(toks_k, toks_p)}")


def served_model(torch, cfg, dev, batch=SERVE_BATCH, prompt=SERVE_PROMPT):
    """``cfg`` with bf16 weights drawn from ``SERVE_SEED`` on the card, and
    ``batch`` random prompts of ``prompt`` tokens."""
    from repro_torch.models import init_params

    t0 = time.perf_counter()
    model = init_params(cfg, SERVE_SEED, torch.bfloat16, dev)
    torch.cuda.synchronize()
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    print(f"serve: bf16 weights drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s, {weight_bytes / 1e9:.2f} GB",
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED + 1)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt),
                            generator=gen, device=dev)
    return model, prompts


def free_card(torch) -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def scan_hold(torch, got, want) -> float:
    """How far K5's (y, h_T) ``got`` stands from ``want``: the larger of
    the two parts' ``rel_err`` over ``SCAN_TOL``; the hold passes at 1 or
    less."""
    return max(rel_err(torch, g, w) for g, w in zip(got, want)) / SCAN_TOL


def serving_phase(torch, check, cfg, dev, scan_registers) -> dict:
    """``cfg`` (Falcon-Mamba-7B) served on ``dev``, the kernel route held
    against the plain scan and decode against forward, and K5 held against
    its plain version (the input-level mutants of ``ref.MUTANTS`` failing)
    and timed at the prefill and decode shapes.  Returns K5's ``kernels``
    row, with the builds' ``scan_registers``."""
    from repro_torch.kernels.mamba_scan.mamba_scan import (geometry,
                                                           mamba_scan)
    from repro_torch.kernels.mamba_scan.ref import (MUTANTS, mamba_scan_ref,
                                                    mutant_inputs)
    from repro_torch.models import init_params
    from repro_torch.models import recurrent

    print(f"serve: {cfg.name}, {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"inner {cfg.ssm.expand * cfg.d_model}, state {cfg.ssm.state_dim}, "
          f"vocab {cfg.vocab_size}, {cfg.param_count() / 1e9:.2f} B params",
          flush=True)
    model, prompts = served_model(torch, cfg, dev)

    # -- the timed serve, counted, and its profile ----------------------
    toks, launches, in_prefill, t_prefill, t_decode = timed_serve(
        torch, check, model, cfg, prompts, {"mamba_scan": cfg.n_layers})
    profile_serve(torch, model, cfg, prompts, toks, t_prefill, t_decode)
    del model
    free_card(torch)

    # -- hold on the card: f32 weights, a 128-token prompt ----------------
    model = init_params(cfg, SERVE_SEED, torch.float32, dev)
    hold_serve(torch, check, model, cfg, prompts[:, :HOLD_PROMPT],
               HOLD_DECODE, [(recurrent, "selective_scan", mamba_scan_ref)])
    del model
    free_card(torch)

    # -- K5 against its plain version, at one layer's shapes --------------
    inner, n = cfg.ssm.expand * cfg.d_model, cfg.ssm.state_dim
    x_dtype = torch.bfloat16
    bsz, s = SERVE_BATCH, SERVE_PROMPT
    scan_errs = {}
    for name, shape, with_h0, a_kind in (
            ("prefill", (bsz, s, inner, n), False, "init"),
            ("prefill, drawn a", (bsz, s, inner, n), False, "drawn"),
            ("n 8, drawn a", (bsz, s, inner, 8), False, "drawn"),
            ("decode from a state", (bsz, 1, inner, n), True, "init"),
            ("decode from a state, drawn a", (bsz, 1, inner, n), True,
             "drawn"),
            ("ragged S and width from a state, drawn a",
             (2, s + 1, 1000, n), True, "drawn")):
        args = scan_inputs(torch, *shape, x_dtype, dev, seed=len(scan_errs),
                           with_h0=with_h0, a_kind=a_kind)
        got = mamba_scan(*args)
        want = mamba_scan_ref(*args)
        scan_errs[name] = [float((g - w).abs().max())
                           for g, w in zip(got, want)]
        ratio = scan_hold(torch, got, want)
        check(ratio <= 1,
              f"K5 mamba_scan vs plain at {name} {shape}: max |d| y "
              f"{scan_errs[name][0]:.3g}, h_T {scan_errs[name][1]:.3g}, at "
              f"most {ratio:.3g} of the bound")
        for mutant in MUTANTS:
            bad = mutant_inputs(mutant, *args)
            if bad is not None:
                ratio = scan_hold(torch, got, mamba_scan_ref(*bad))
                check(ratio > 1, f"K5 hold at {name}: the plain version "
                      f"with {mutant} stands at {ratio:.3g} of the bound, "
                      f"so it fails")
        del args, got, want
    free_card(torch)
    geo = geometry(n, x_dtype, bsz, inner)
    print(f"K5 launch at {(bsz, s, inner, n)}: {geo['lanes']} lanes a "
          f"channel, {geo['threads']} threads ({geo['channels']} channels) "
          f"a block, chunks of {geo['chunk']} steps; {geo['blocks']} blocks, "
          f"at most {geo['blocks_per_sm']} an SM, {geo['waves']} wave(s), "
          f"{geo['warps_per_sm']} warps an SM; {geo['registers']} registers, "
          f"{geo['local_bytes']} bytes of local memory a thread", flush=True)
    args = scan_inputs(torch, bsz, s, inner, n, x_dtype, dev, seed=0)
    elems = bsz * s * inner * n
    nbytes = (bsz * s * inner * (4 + 2)          # delta f32, xc bf16 in
              + 2 * bsz * s * n * 2 + inner * n * 4
              + bsz * s * inner * 4 + bsz * inner * n * 4)  # y, h_T out
    flops = 6 * elems + bsz * s * inner
    clock = max_sm_clock_hz()
    t_sfu = elems / (SFU_PER_SM_CLOCK * SMS * clock)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FP32_FLOP_S
    bound = max(t_bytes, t_ops, t_sfu)
    print(f"K5 bound at {(bsz, s, inner, n)}: {nbytes / 1e9:.3f} GB -> "
          f"{t_bytes * 1e3:.4f} ms; {flops / 1e9:.2f} GFLOP fp32 -> "
          f"{t_ops * 1e3:.4f} ms; {elems / 1e9:.3f} G exp on the SFUs at "
          f"{clock / 1e9:.3f} GHz (clocks.max.sm) -> {t_sfu * 1e3:.4f} ms",
          flush=True)
    ms = time_ms(torch, lambda: mamba_scan(*args), 20)
    plain_ms = time_ms(torch, lambda: mamba_scan_ref(*args), 2)
    del args
    # the decode shape: one step from a state, h0 read and h_T written
    dec = scan_inputs(torch, bsz, 1, inner, n, x_dtype, dev, seed=3,
                      with_h0=True)
    dec_bytes = (bsz * inner * (4 + 2) + 2 * bsz * n * 2 + inner * n * 4
                 + 2 * bsz * inner * n * 4 + bsz * inner * 4)
    dec_bound = dec_bytes / PEAK_BYTES_S * 1e3
    dec_ms = time_ms(torch, lambda: mamba_scan(*dec), 200)
    dec_dev_ms = kernel_ms(torch, lambda: mamba_scan(*dec), 50)[0]
    check(dec_dev_ms > 0, "K5's decode-shape calls show in a profiler trace")
    n_all, n_prefill = launches.get("mamba_scan", 0), in_prefill.get(
        "mamba_scan", 0)
    print(f"K5 at {(bsz, s, inner, n)}: {ms:.4f} ms ({ms / (bound * 1e3):.2f}"
          f"x its bound), plain {plain_ms:.2f} ms; at the decode shape "
          f"{(bsz, 1, inner, n)} from a state: {dec_ms:.4f} ms a call by "
          f"CUDA events over 200 back-to-back calls, {dec_dev_ms:.4f} ms on "
          f"the card (profiler); reads and writes {dec_bytes / 1e6:.2f} MB, "
          f"bound {dec_bound:.4f} ms (bytes); launches {n_prefill} in the "
          f"prefill, {n_all - n_prefill} in the serve steps", flush=True)
    return {"name": "mamba_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/mamba_scan.cu",
            "replaces": "src/repro/kernels/mamba_scan/mamba_scan.py:56",
            "launches": n_all, "prefill_launches": n_prefill,
            "decode_launches": n_all - n_prefill,
            "max_abs_err": max(max(e) for e in scan_errs.values()),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound * 1e3,
            "bound_by": "bytes" if t_bytes >= max(t_ops, t_sfu)
            else "operations",
            "library_ms": None, "decode_ms": dec_ms,
            "decode_device_ms": dec_dev_ms, "decode_bound_ms": dec_bound,
            "decode_bound_by": "bytes",
            "registers": scan_registers,
            "warps_per_sm": geo["warps_per_sm"]}


def attention_inputs(torch, dev, bsz, sq, sk, h, kvh, d, seed, dtype):
    """q (bsz, sq, h, d), k, v (bsz, sk, kvh, d), standard normal from
    ``seed`` on the card, in ``dtype``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev,
                        dtype=torch.float32).to(dtype)
            for shape in ((bsz, sq, h, d), (bsz, sk, kvh, d),
                          (bsz, sk, kvh, d))]


def kernel_ms(torch, fn, calls=20) -> tuple[float, dict]:
    """The card's kernel time per call of ``fn()`` (already warm) over
    ``calls`` back-to-back calls under the profiler (``device_time``):
    each kernel's mean time times its launches a call, summed, and by name
    (launches a call, ms a launch), after an untraced warm-up window.
    Launches a call are rounded.  Every kernel these calls launch runs in
    each call, so a window is short when the trace shows a kernel fewer
    times than there were calls, or holds fewer kernels than the port's
    wrappers counted (``LAUNCHES``) over the same calls; a short window is
    printed and taken again, up to ``PROFILER_WINDOWS`` in all (a trace
    may come back empty, most often late in the run).  If all are short, the
    last is counted with each kernel it shows at least once a call.  The
    time is 0.0 if its trace holds no kernel."""
    from repro_torch.kernels import build

    total, per_call = 0.0, {}
    for window in range(1, PROFILER_WINDOWS + 1):
        before = sum(build.LAUNCHES.snapshot().values())
        _, n_kernels, by_name = device_time(
            torch, lambda: [fn() for _ in range(calls)], warmup=True)
        counted = (sum(build.LAUNCHES.snapshot().values()) - before) // 2
        missed = {name: n for name, _, n in by_name if n < calls}
        short = not by_name or missed or n_kernels < counted
        per_call = {name: (max(1, round(n / calls)), ms / n)
                    for name, ms, n in by_name}
        total = sum(c * ms for c, ms in per_call.values())
        if not short:
            break
        print(f"profiler window {window} of {PROFILER_WINDOWS} short "
              f"({calls} calls): "
              f"{n_kernels} kernels traced, {counted} launches counted"
              + "".join(f"; {name[:60]} {n}" for name, n in missed.items()),
              flush=True)
    return total, per_call


def prefill_rate(name, flops, ms, bound) -> dict:
    """K4's bf16 prefill form timed at ``ms`` by CUDA events: prints and
    returns its ``tflop_s``, ``flops`` (4·hd a kept pair) over ``ms``."""
    tflop_s = flops / (ms * 1e-3) / 1e12
    print(f"K4 {name} (bf16, tensor cores): {ms:.4f} ms, {tflop_s:.1f} "
          f"TFLOP/s nominal ({flops / 1e9:.1f} GFLOP), {ms / bound:.1f}x "
          f"the bound {bound:.4f} ms", flush=True)
    return {"tflop_s": tflop_s}


def check_tensor_core_prefill(check, what, by_name, n) -> None:
    """A profile's kernels (``device_time``'s by-name rows) of a window in
    which K4's prefill form ran ``n`` times in bf16: ``n`` launches of the
    tensor-core kernel and none of the f32 one."""
    tc = sum(c for name, _, c in by_name if "prefill_mma_kernel" in name)
    f32 = sum(c for name, _, c in by_name if "prefill_kernel<" in name)
    check(tc == n and f32 == 0, f"{what}: K4's bf16 prefill ran "
          f"prefill_mma_kernel {tc} times ({n} expected) and the f32 "
          f"prefill_kernel {f32} times")


def check_split_drop(torch, check, name, q, k, v, q_offset, k_len, window,
                     cap, want):
    """The plain version with the values of the middle split (of those
    holding keys) of K4's decode split plan zeroed must fail ``ref.HOLD``
    against ``want``: the hold sees one split of the kernel's lost."""
    from repro_torch.kernels.attention.attention import decode_plan
    from repro_torch.kernels.attention.ref import attention_ref, hold_ratio

    _, live = decode_plan(k, q_offset, k_len, window)
    lo, hi = live[(len(live) - 1) // 2]
    v_bad = v.clone()
    v_bad[:, lo:hi] = 0
    bad = hold_ratio(attention_ref(q, k, v_bad, q_offset, k_len, window,
                                   logit_cap=cap), want)
    check(len(live) > 1 and bad > 1,
          f"K4 hold, {name}: the plain version with split {lo}..{hi - 1} "
          f"of {len(live)} zeroed stands at {bad:.3g} of the bound, so it "
          f"fails")


def sdpa_decode(torch, q, k, v, k_len):
    """K4's uncapped decode form over a cache whose first ``k_len`` keys
    are valid, as one PyTorch call for ``library_ms``: SDPA with
    ``enable_gqa`` of the one query over the valid keys, both as views.
    Returns the call, its output in q's layout."""
    import torch.nn.functional as F

    qt = q.transpose(1, 2)
    kt, vt = (t[:, :k_len].transpose(1, 2) for t in (k, v))
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, enable_gqa=True).transpose(1, 2)


def decode_row(torch, check, name, make, q_offset, k_len, window, cap,
               library, launches) -> dict:
    """K4's decode form on inputs ``make(dtype)`` (q, k, v on the card):
    the PyTorch call ``library(q, k, v)`` (a call returning the output in
    q's layout) held against K4's plain version by ``ref.HOLD`` in f32
    first; then, in bf16, K4, its plain version and that call timed by
    CUDA events (back-to-back calls) and by their kernels' time on the
    card (``kernel_ms``), and K4's split plan and bytes bound printed.
    Returns the form's ``kernels`` row, ``launches`` its count on the main
    path."""
    from repro_torch.kernels.attention.attention import (decode_plan,
                                                         flash_attention)
    from repro_torch.kernels.attention.ref import attention_ref, hold_ratio

    q, k, v = make(torch.float32)
    want = attention_ref(q, k, v, q_offset, k_len, window, logit_cap=cap)
    lib_ratio = hold_ratio(library(q, k, v)(), want)
    check(lib_ratio <= 1, f"library call vs K4's plain version, {name} "
          f"(f32): at most {lib_ratio:.3g} of the bound")
    del q, k, v, want
    q, k, v = make(torch.bfloat16)

    def kernel():
        return flash_attention(q, k, v, q_offset, k_len, window,
                               logit_cap=cap)

    err = float((kernel().float() - attention_ref(
        q, k, v, q_offset, k_len, window, logit_cap=cap).float()).abs().max())
    lib = library(q, k, v)
    ms = time_ms(torch, kernel, 100)
    dev_ms, names = kernel_ms(torch, kernel)
    plain_ms = time_ms(torch, lambda: attention_ref(
        q, k, v, q_offset, k_len, window, logit_cap=cap), 10)
    lib_ms = time_ms(torch, lib, 100)
    lib_dev_ms, lib_names = kernel_ms(torch, lib)
    (n_split, split_len), live = decode_plan(k, q_offset, k_len, window)
    bsz, kvh, hd = k.shape[0], k.shape[2], k.shape[3]
    keys = live[-1][1] - live[0][0]
    nbytes = (2 * bsz * keys * kvh * hd * k.element_size()
              + 2 * q.numel() * q.element_size())  # k, v read; q, o
    bound = nbytes / PEAK_BYTES_S * 1e3
    ours = [c for n, (c, _) in names.items() if "decode_" in n]
    check(ours == [1] * (1 + (n_split > 1)) and len(ours) == len(names),
          f"K4 {name}: each call ran the split kernel and, with "
          f"{n_split} splits, the combine kernel once, and nothing else: "
          + "; ".join(f"{n[:60]} x{c} at {ms:.4f} ms"
                      for n, (c, ms) in names.items()))
    print(f"K4 {name} at q {tuple(q.shape)}, k/v {tuple(k.shape)} bf16 over "
          f"{keys} keys: split plan {n_split} x {split_len} keys, "
          f"{n_split * bsz * kvh} blocks ({len(live)} splits a row hold "
          f"keys); {ms:.4f} ms a call by CUDA events, {dev_ms:.4f} ms on the "
          f"card ({dev_ms / bound:.1f}x its bound); plain {plain_ms:.4f} ms; "
          f"library {lib_ms:.4f} ms by events, {lib_dev_ms:.4f} ms on the "
          f"card (" + "; ".join(f"{n[:50]} x{c} at {ms:.4f} ms"
                                for n, (c, ms) in lib_names.items())
          + f"); reads {nbytes / 1e6:.2f} MB, bound {bound:.4f} ms; "
          f"library held in f32 at {lib_ratio:.3g} of the bound", flush=True)
    return {"name": f"flash_attention ({name}, head_dim {hd})",
            "route": "cuda", "source": "src/repro_torch/csrc/attention.cu",
            "replaces": "src/repro/kernels/attention/attention.py:80",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": lib_ms,
            "library_device_ms": lib_dev_ms, "n_split": n_split,
            "split_len": split_len, "blocks": n_split * bsz * kvh}


def dense_serving_phase(torch, check, cfg, dev) -> list[dict]:
    """``cfg`` (StarCoder2-3B) served on ``dev`` with a bf16 KV cache, the
    kernel route held against K4's plain version and decode against
    forward, and K4 held and timed against its plain version and against
    ``F.scaled_dot_product_attention``.  Returns K4's ``kernels`` rows: the
    prefill form (its launches the prefill's) and the decode form (the
    serve steps')."""
    import torch.nn.functional as F

    from repro_torch.kernels.attention.attention import flash_attention
    from repro_torch.kernels.attention.ref import (HOLD, attention_ref,
                                                   hold_ratio)
    from repro_torch.models import attention, init_params

    hd = cfg.resolved_head_dim
    print(f"serve: {cfg.name}, {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads of {hd}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.param_count() / 1e9:.2f} B params", flush=True)
    model, prompts = served_model(torch, cfg, dev)

    # -- the timed serve, counted, and its profile ----------------------
    toks, launches, in_prefill, t_prefill, t_decode = timed_serve(
        torch, check, model, cfg, prompts, {"flash_attention": cfg.n_layers})
    profile_serve(torch, model, cfg, prompts, toks, t_prefill, t_decode,
                  check, cfg.n_layers)
    del model
    free_card(torch)

    # -- hold on the card: f32 weights, a 128-token prompt ----------------
    model = init_params(cfg, SERVE_SEED, torch.float32, dev)
    hold_serve(torch, check, model, cfg, prompts[:, :HOLD_PROMPT],
               HOLD_DECODE, [(attention, "gqa_attention", attention_ref)])
    del model
    free_card(torch)

    # -- K4 against its plain version, at one layer's shapes --------------
    # element by element within ref.HOLD, in bf16 (the served dtype) and in
    # f32 (no final rounding, so only the order of the sums may differ)
    b, s, h, kvh = SERVE_BATCH, SERVE_PROMPT, cfg.n_heads, cfg.n_kv_heads
    cache_len = SERVE_PROMPT + SERVE_NEW
    shapes = (("prefill", (b, s, s, h, kvh, hd), 0, s),
              ("head_dim 64, 16 heads over 16", (b, s, s, 16, 16, 64), 0, s),
              (f"decode over a cache at length {DECODE_LEN}",
               (b, 1, cache_len, h, kvh, hd), DECODE_LEN - 1, DECODE_LEN))
    cases, errs = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        for seed, (name, shape, q_offset, k_len) in enumerate(shapes):
            q, k, v = attention_inputs(torch, dev, *shape, seed, dtype)
            got = flash_attention(q, k, v, q_offset, k_len)
            want = attention_ref(q, k, v, q_offset, k_len)
            ratio = hold_ratio(got, want)
            errs[name, dtype] = float((got.float() - want.float()).abs().max())
            u, r = HOLD[dtype]
            check(ratio <= 1,
                  f"K4 flash_attention vs plain, {name}: q {tuple(q.shape)}, "
                  f"k/v {tuple(k.shape)} {str(dtype)[6:]}, max |d| "
                  f"{errs[name, dtype]:.3g}, at most {ratio:.3g} of the bound "
                  f"{u:.3g}·|want| + {r:.3g}·rms(row)")
            if dtype == torch.bfloat16:
                if shape[1] > 1:
                    cases[name] = (q, k, v)
                # the hold must see one middle key tile gone wrong
                v_bad = v.clone()
                v_bad[:, 1024:1088] = 0
                bad = hold_ratio(attention_ref(q, k, v_bad, q_offset, k_len),
                                 want)
                check(bad > 1, f"K4 hold, {name}: the plain version with "
                      f"values 1024..1087 zeroed stands at {bad:.3g} of the "
                      f"bound, so it fails")
                del v_bad
                if shape[1] == 1:
                    check_split_drop(torch, check, name, q, k, v, q_offset,
                                     k_len, 0, 0.0, want)
            del q, k, v, got, want
    free_card(torch)
    decode = decode_row(
        torch, check, f"decode over {DECODE_LEN} keys",
        lambda dtype: attention_inputs(torch, dev, *shapes[2][1], 2, dtype),
        DECODE_LEN - 1, DECODE_LEN, 0, 0.0,
        lambda q, k, v: sdpa_decode(torch, q, k, v, DECODE_LEN),
        launches.get("flash_attention", 0)
        - in_prefill.get("flash_attention", 0))
    free_card(torch)
    q, k, v = cases[shapes[0][0]]
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    lib_err = float((library().transpose(1, 2).float()
                     - attention_ref(q, k, v).float()).abs().max())
    pairs = b * h * s * (s + 1) // 2  # kept (q, k) pairs, causal
    flops = 4 * hd * pairs
    nbytes = 2 * (q.numel() + k.numel()) * q.element_size()  # q, o; k, v
    clock = max_sm_clock_hz()
    t_ops, t_bytes = flops / PEAK_BF16_FLOP_S, nbytes / PEAK_BYTES_S
    t_sfu = pairs / (SFU_PER_SM_CLOCK * SMS * clock)
    print(f"K4 bound at q {tuple(q.shape)}, k/v {tuple(k.shape)} bf16, "
          f"causal: {pairs:.4g} (q, k) pairs x 4·{hd} = {flops / 1e9:.1f} "
          f"GFLOP -> {t_ops * 1e3:.4f} ms at 989 TFLOP/s bf16 "
          f"({flops / PEAK_FP32_FLOP_S * 1e3:.3f} ms at 67 TFLOP/s fp32); "
          f"{nbytes / 1e6:.1f} MB -> {t_bytes * 1e3:.4f} ms; {pairs:.4g} exp "
          f"on the SFUs at {clock / 1e9:.3f} GHz -> {t_sfu * 1e3:.4f} ms.  "
          f"SDPA vs plain: max |d| {lib_err:.3g}", flush=True)
    bound = max(t_ops, t_bytes, t_sfu)
    ms = time_ms(torch, lambda: flash_attention(q, k, v), 20)
    return [{"name": "flash_attention", "route": "cuda",
             "source": "src/repro_torch/csrc/attention.cu",
             "replaces": "src/repro/kernels/attention/attention.py:80",
             "launches": in_prefill.get("flash_attention", 0),
             "max_abs_err": max(errs.values()), "ms": ms,
             "plain_ms": time_ms(torch, lambda: attention_ref(q, k, v), 3),
             "bound_ms": bound * 1e3,
             "bound_by": "bytes" if t_bytes >= max(t_ops, t_sfu)
             else "operations",
             "library_ms": time_ms(torch, library, 20),
             **prefill_rate("causal prefill", flops, ms, bound * 1e3)},
            decode]


def lru_gated_row(torch, check, dev, w, launches, in_prefill,
                  lru_registers) -> dict:
    """K6's gated form at the hybrid's prefill shape (2, 4096, W) and its
    decode shape (2, 1, W) from a state, in bf16 and f32 gates: held
    against its plain version (``LRU_TOL``) with each of
    ``ref.GATED_MUTANTS`` failing that hold, its elements that differ from
    the stepped route (PyTorch's ops forming a and b, then K6) counted (0
    expected); timed in bf16, the served dtype, by CUDA events and the
    profiler beside the stepped route, its plain version and its bytes
    bound.  Returns its ``kernels`` row."""
    from repro_torch.kernels.rglru.ref import (GATED_MUTANTS, gated_ab,
                                               gated_mutant,
                                               rglru_gated_scan_ref)
    from repro_torch.kernels.rglru.rglru import rglru_gated_scan, rglru_scan

    def stepped(r, i, xc, a_param, h0=None):
        return rglru_scan(*gated_ab(r, i, xc, a_param), h0)

    errs, n_differ = {}, 0
    shapes = (("prefill", (HYBRID_BATCH, HYBRID_PROMPT, w), False),
              ("decode from a state", (HYBRID_BATCH, 1, w), True))
    for seed, (dtype, (name, shape, with_h0)) in enumerate(
            (d, c) for d in (torch.bfloat16, torch.float32) for c in shapes):
        args = lru_gated_inputs(torch, *shape, dtype, dev, 20 + seed, with_h0)
        what = f"{name} {shape} {str(dtype)[6:]}"
        got = rglru_gated_scan(*args)
        want = rglru_gated_scan_ref(*args)
        errs[what] = float((got - want).abs().max())
        bound = LRU_TOL * max(1.0, float(want.abs().max()))
        check(errs[what] <= bound, f"K6 gated form vs plain at {what}: max "
              f"|d| {errs[what]:.3g}, bound {bound:.3g}")
        del want
        ref = stepped(*args)
        n = int((got != ref).sum())
        n_differ += n
        check(n == 0, f"K6 gated form vs the stepped route at {what}: {n} "
              f"of {got.numel()} elements differ, max |d| "
              f"{float((got - ref).abs().max()):.3g}")
        del ref
        for mutant in GATED_MUTANTS:
            bad = gated_mutant(mutant, *args)
            if bad is None:
                continue
            ratio = float((got - bad).abs().max()) / (
                LRU_TOL * max(1.0, float(bad.abs().max())))
            check(ratio > 1, f"K6 gated hold at {what}: the plain version "
                  f"with {mutant} stands at {ratio:.3g} of the bound, so it "
                  f"fails")
            del bad
        del got, args
    free_card(torch)

    args = lru_gated_inputs(torch, HYBRID_BATCH, HYBRID_PROMPT, w,
                            torch.bfloat16, dev, 30)
    # r, i, xc read and h written once, a_param once; per element about 11
    # fp32 operations (-c·r, ·softplus, exp, a·a, 1 - ·, max, sqrt, i·xc,
    # the product, and the fma's two)
    n = args[0].numel()
    nbytes = 3 * n * args[0].element_size() + 4 * n + 4 * w
    flops = 11 * n
    b_ms, b_by = bound_ms(nbytes, flops)
    ms = time_ms(torch, lambda: rglru_gated_scan(*args), 20)
    dev_ms, by_name = kernel_ms(torch, lambda: rglru_gated_scan(*args), 10)
    st_ms = time_ms(torch, lambda: stepped(*args), 5)
    st_dev_ms, st_by_name = kernel_ms(torch, lambda: stepped(*args), 5)
    plain_ms = time_ms(torch, lambda: rglru_gated_scan_ref(*args), 2)
    st_kernels = sum(n for n, _ in st_by_name.values())
    print(f"K6 gated form at {tuple(args[0].shape)} bf16: {ms:.4f} ms by "
          f"CUDA events, {dev_ms:.4f} ms on the card (profiler: {by_name}); "
          f"bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.1f} MB, "
          f"{flops / 1e9:.3f} GFLOP); the stepped route {st_ms:.4f} ms "
          f"({st_dev_ms:.4f} ms on the card in {st_kernels} kernels a call: "
          f"{st_by_name}); plain {plain_ms:.1f} ms", flush=True)
    del args
    dec = lru_gated_inputs(torch, HYBRID_BATCH, 1, w, torch.bfloat16, dev,
                           31, with_h0=True)
    dec_bytes = 3 * HYBRID_BATCH * w * 2 + 4 * w + 2 * HYBRID_BATCH * w * 4
    dec_ms = time_ms(torch, lambda: rglru_gated_scan(*dec), 200)
    dec_dev_ms = kernel_ms(torch, lambda: rglru_gated_scan(*dec), 50)[0]
    check(dec_dev_ms > 0,
          "K6 gated form's decode-shape calls show in a profiler trace")
    dec_st_ms = time_ms(torch, lambda: stepped(*dec), 200)
    dec_st_dev_ms = kernel_ms(torch, lambda: stepped(*dec), 50)[0]
    row = {"name": "rglru_gated_scan", "route": "cuda",
           "source": "src/repro_torch/csrc/rglru.cu",
           "replaces": "src/repro/kernels/rglru/rglru.py:48",
           "launches": launches.get("rglru_gated_scan", 0),
           "prefill_launches": in_prefill.get("rglru_gated_scan", 0),
           "max_abs_err": max(errs.values()),
           "differ_from_stepped": n_differ, "ms": ms, "device_ms": dev_ms,
           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": None, "stepped_ms": st_ms,
           "stepped_device_ms": st_dev_ms, "stepped_kernels": st_kernels,
           "decode_ms": dec_ms, "decode_device_ms": dec_dev_ms,
           "decode_bound_ms": dec_bytes / PEAK_BYTES_S * 1e3,
           "decode_bound_by": "bytes", "decode_stepped_ms": dec_st_ms,
           "decode_stepped_device_ms": dec_st_dev_ms,
           "registers": {form: regs for form, (regs, _) in
                         lru_registers.items() if form.startswith("gated")}}
    row["decode_launches"] = row["launches"] - row["prefill_launches"]
    print(f"K6 gated form at the decode shape {(HYBRID_BATCH, 1, w)} bf16 "
          f"from a state: {dec_ms:.4f} ms a call by CUDA events over 200 "
          f"back-to-back calls, {dec_dev_ms:.4f} ms on the card (profiler); "
          f"the stepped route {dec_st_ms:.4f} ms ({dec_st_dev_ms:.4f} ms on "
          f"the card); reads and writes {dec_bytes / 1e3:.1f} KB, bound "
          f"{row['decode_bound_ms']:.5f} ms (bytes); launches "
          f"{row['prefill_launches']} in the prefill, "
          f"{row['decode_launches']} in the serve steps", flush=True)
    return row


def hybrid_serving_phase(torch, check, cfg, dev, lru_registers) -> list[dict]:
    """``cfg`` (RecurrentGemma-9B) served on ``dev`` with bf16 ring
    buffers, the kernel route held against K6's gated form's and K4's
    plain versions and decode against forward past the window, and both
    forms of K6 and K4 (windowed, head_dim 256) held and timed against
    their plain versions, K6's gated form also against the stepped route
    it replaced.  Returns K6's standalone and gated rows (with the builds'
    ``lru_registers``), the windowed K4's and K4's decode form's (over the
    ring) ``kernels`` rows."""
    import torch.nn.functional as F

    from repro_torch.kernels.attention.attention import flash_attention
    from repro_torch.kernels.attention.ref import (HOLD, attention_ref,
                                                   hold_ratio)
    from repro_torch.kernels.rglru.ref import (rglru_gated_scan_ref,
                                               rglru_scan_ref)
    from repro_torch.kernels.rglru.rglru import rglru_scan
    from repro_torch.models import attention, init_params, recurrent

    hd, win = cfg.resolved_head_dim, cfg.rglru.window
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    n_rec, n_attn = kinds.count("rglru"), kinds.count("local_attn")
    print(f"serve: {cfg.name}, {cfg.n_layers} layers ({n_rec} RG-LRU, "
          f"{n_attn} local attention), d_model {cfg.d_model}, lru_width "
          f"{cfg.rglru.lru_width}, {cfg.n_heads} heads over {cfg.n_kv_heads} "
          f"KV heads of {hd}, window {win}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, {cfg.param_count() / 1e9:.2f} B params",
          flush=True)
    model, prompts = served_model(torch, cfg, dev, HYBRID_BATCH,
                                  HYBRID_PROMPT)

    # -- the timed serve, counted, and its profile ----------------------
    toks, launches, in_prefill, t_prefill, t_decode = timed_serve(
        torch, check, model, cfg, prompts,
        {"rglru_gated_scan": n_rec, "rglru_scan": 0,
         "flash_attention": n_attn})
    profile_serve(torch, model, cfg, prompts, toks, t_prefill, t_decode,
                  check, n_attn)
    del model
    free_card(torch)

    # -- hold on the card: f32 weights, one prompt past the window --------
    model = init_params(cfg, SERVE_SEED, torch.float32, dev)
    hold_serve(torch, check, model, cfg, prompts[:1, :HYBRID_HOLD_PROMPT],
               HYBRID_HOLD_DECODE,
               [(recurrent, "lru_gated_scan", rglru_gated_scan_ref),
                (attention, "gqa_attention", attention_ref)])
    del model
    free_card(torch)

    # -- K6 against its plain version, at one layer's shapes --------------
    # a and b as the mixer forms them at init: a = exp(-8·r·softplus(a_param))
    # with softplus(a_param) = 0.65, b = sqrt(1 - a²)·(i·xc)
    def lru_inputs(bsz, s, w, seed, with_h0=False):
        g = torch.Generator(device=dev).manual_seed(seed)

        def randn(*shape):
            return torch.randn(shape, generator=g, device=dev)

        a = torch.exp(-8.0 * 0.65 * torch.sigmoid(randn(bsz, s, w)))
        b = torch.sqrt(torch.clamp(1 - a * a, min=1e-12)) * randn(bsz, s, w)
        return a, b, (randn(bsz, w) if with_h0 else None)

    w = cfg.rglru.lru_width
    lru_errs = {}
    for name, shape, with_h0 in (
            ("prefill", (HYBRID_BATCH, HYBRID_PROMPT, w), False),
            ("decode from a state", (HYBRID_BATCH, 1, w), True)):
        a, b, h0 = lru_inputs(*shape, seed=len(lru_errs), with_h0=with_h0)
        got, want = rglru_scan(a, b, h0), rglru_scan_ref(a, b, h0)
        lru_errs[name] = float((got - want).abs().max())
        scale = max(1.0, float(want.abs().max()))
        check(lru_errs[name] <= LRU_TOL * scale,
              f"K6 rglru_scan vs plain at {name} {shape}: max |d| "
              f"{lru_errs[name]:.3g}, bound {LRU_TOL * scale:.3g}")
    a, b, _ = lru_inputs(HYBRID_BATCH, HYBRID_PROMPT, w, seed=0)
    lru_bytes = 3 * a.numel() * 4  # a, b read, h written, f32
    lru_flops = 2 * a.numel()
    lru_bound, lru_by = bound_ms(lru_bytes, lru_flops)
    print(f"K6 bound at {tuple(a.shape)}: {lru_bytes / 1e6:.1f} MB -> "
          f"{lru_bytes / PEAK_BYTES_S * 1e3:.4f} ms; {lru_flops / 1e9:.3f} "
          f"GFLOP fp32 -> {lru_flops / PEAK_FP32_FLOP_S * 1e3:.4f} ms",
          flush=True)
    k6_row = {"name": "rglru_scan", "route": "cuda",
              "source": "src/repro_torch/csrc/rglru.cu",
              "replaces": "src/repro/kernels/rglru/rglru.py:48",
              "launches": launches.get("rglru_scan", 0),
              "prefill_launches": in_prefill.get("rglru_scan", 0),
              "max_abs_err": max(lru_errs.values()),
              "ms": time_ms(torch, lambda: rglru_scan(a, b), 20),
              "device_ms": kernel_ms(torch, lambda: rglru_scan(a, b), 10)[0],
              "plain_ms": time_ms(torch, lambda: rglru_scan_ref(a, b), 2),
              "bound_ms": lru_bound, "bound_by": lru_by,
              "library_ms": None,
              "registers": lru_registers.get("standalone", (None,))[0]}
    del a, b
    # the decode shape: one step from a state, a, b and h0 read, h written
    dec = lru_inputs(HYBRID_BATCH, 1, w, seed=3, with_h0=True)
    dec_bytes = 4 * HYBRID_BATCH * w * 4
    dec_ms = time_ms(torch, lambda: rglru_scan(*dec), 200)
    dec_dev_ms = kernel_ms(torch, lambda: rglru_scan(*dec), 50)[0]
    check(dec_dev_ms > 0, "K6's decode-shape calls show in a profiler trace")
    k6_row.update({
        "decode_launches": k6_row["launches"] - k6_row["prefill_launches"],
        "decode_ms": dec_ms, "decode_device_ms": dec_dev_ms,
        "decode_bound_ms": dec_bytes / PEAK_BYTES_S * 1e3,
        "decode_bound_by": "bytes"})
    print(f"K6 at {(HYBRID_BATCH, HYBRID_PROMPT, w)}: {k6_row['ms']:.4f} ms "
          f"by CUDA events, {k6_row['device_ms']:.4f} ms on the card "
          f"(profiler); at the decode shape {(HYBRID_BATCH, 1, w)} from a "
          f"state: "
          f"{dec_ms:.4f} ms a call by CUDA events over 200 back-to-back "
          f"calls, {dec_dev_ms:.4f} ms on the card (profiler); reads and "
          f"writes {dec_bytes / 1e3:.1f} KB, bound "
          f"{k6_row['decode_bound_ms']:.5f} ms (bytes); launches "
          f"{k6_row['prefill_launches']} in the prefill, "
          f"{k6_row['decode_launches']} in the serve steps", flush=True)
    del dec
    free_card(torch)
    gated_row = lru_gated_row(torch, check, dev, w, launches, in_prefill,
                              lru_registers)
    free_card(torch)

    # -- K4 with the window at head_dim 256, and its decode form over a ring
    bsz, s, h, kvh = HYBRID_BATCH, HYBRID_PROMPT, cfg.n_heads, cfg.n_kv_heads
    shapes = ((f"prefill, window {win}", (bsz, s, s, h, kvh, hd), 0, s, win),
              (f"decode form over a full ring of {win}",
               (bsz, 1, win, h, kvh, hd), win - 1, win, 0))
    cases, errs = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        for seed, (name, shape, q_offset, k_len, window) in enumerate(shapes):
            q, k, v = attention_inputs(torch, dev, *shape, seed + 10, dtype)
            got = flash_attention(q, k, v, q_offset, k_len, window)
            want = attention_ref(q, k, v, q_offset, k_len, window)
            ratio = hold_ratio(got, want)
            errs[name, dtype] = float((got.float() - want.float()).abs().max())
            u, r = HOLD[dtype]
            check(ratio <= 1,
                  f"K4 flash_attention vs plain, {name}: q {tuple(q.shape)}, "
                  f"k/v {tuple(k.shape)} {str(dtype)[6:]}, max |d| "
                  f"{errs[name, dtype]:.3g}, at most {ratio:.3g} of the bound "
                  f"{u:.3g}·|want| + {r:.3g}·rms(row)")
            if dtype == torch.bfloat16:
                if window:  # one 64-key tile inside the last rows' window
                    cases[name] = (q, k, v)
                    lo = (s - window // 2) // 64 * 64
                    v_bad = v.clone()
                    v_bad[:, lo:lo + 64] = 0
                    bad = hold_ratio(attention_ref(q, k, v_bad, 0, s, window),
                                     want)
                    check(bad > 1, f"K4 hold, {name}: the plain version with "
                          f"values {lo}..{lo + 63} zeroed stands at "
                          f"{bad:.3g} of the bound, so it fails")
                    del v_bad
                else:
                    check_split_drop(torch, check, name, q, k, v, q_offset,
                                     k_len, window, 0.0, want)
            del q, k, v, got, want
    free_card(torch)
    decode = decode_row(
        torch, check, f"decode over a full ring of {win}",
        lambda dtype: attention_inputs(torch, dev, *shapes[1][1], 11, dtype),
        win - 1, win, 0, 0.0,
        lambda q, k, v: sdpa_decode(torch, q, k, v, win),
        launches.get("flash_attention", 0)
        - in_prefill.get("flash_attention", 0))
    free_card(torch)
    q, k, v = cases[shapes[0][0]]
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (t.transpose(1, 2).expand(-1, h, -1, -1).contiguous()
              for t in (k, v))
    pos = torch.arange(s, device=dev)
    band = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < win)

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band)

    lib_err = float((library().transpose(1, 2).float() - attention_ref(
        q, k, v, window=win).float()).abs().max())
    # kept (q, k) pairs: min(i + 1, window) keys for row i
    pairs = bsz * h * sum(min(i + 1, win) for i in range(s))
    flops = 4 * hd * pairs
    nbytes = 2 * (q.numel() + k.numel()) * q.element_size()  # q, o; k, v
    clock = max_sm_clock_hz()
    t_ops, t_bytes = flops / PEAK_BF16_FLOP_S, nbytes / PEAK_BYTES_S
    t_sfu = pairs / (SFU_PER_SM_CLOCK * SMS * clock)
    print(f"K4 bound at q {tuple(q.shape)}, k/v {tuple(k.shape)} bf16, "
          f"window {win}: {pairs:.4g} (q, k) pairs x 4·{hd} = "
          f"{flops / 1e9:.1f} GFLOP -> {t_ops * 1e3:.4f} ms at 989 TFLOP/s "
          f"bf16 ({flops / PEAK_FP32_FLOP_S * 1e3:.3f} ms at 67 TFLOP/s "
          f"fp32); {nbytes / 1e6:.1f} MB -> {t_bytes * 1e3:.4f} ms; "
          f"{pairs:.4g} exp on the SFUs at {clock / 1e9:.3f} GHz -> "
          f"{t_sfu * 1e3:.4f} ms.  SDPA (banded mask) vs plain: max |d| "
          f"{lib_err:.3g}", flush=True)
    ms = time_ms(torch, lambda: flash_attention(q, k, v, window=win), 10)
    k4_row = {"name": f"flash_attention (window {win}, head_dim {hd})",
              "route": "cuda", "source": "src/repro_torch/csrc/attention.cu",
              "replaces": "src/repro/kernels/attention/attention.py:80",
              "launches": in_prefill.get("flash_attention", 0),
              "max_abs_err": max(errs.values()), "ms": ms,
              "plain_ms": time_ms(torch, lambda: attention_ref(
                  q, k, v, window=win), 2),
              "bound_ms": max(t_ops, t_bytes, t_sfu) * 1e3,
              "bound_by": "bytes" if t_bytes >= max(t_ops, t_sfu)
              else "operations",
              "library_ms": time_ms(torch, library, 10),
              **prefill_rate(f"prefill, window {win}", flops, ms,
                             max(t_ops, t_bytes, t_sfu) * 1e3)}
    return [k6_row, gated_row, k4_row, decode]


def audio_phase(torch, check, cfg, dev) -> dict:
    """``cfg`` (HuBERT-XLarge) encodes on ``dev``: the timed forwards,
    counted and profiled, the kernel route held against K4's plain version,
    and K4's non-causal form held, its mutants refused, and timed against
    its plain version and ``F.scaled_dot_product_attention``.  Returns its
    ``kernels`` row."""
    import torch.nn.functional as F

    from repro_torch.kernels import build
    from repro_torch.kernels.attention.attention import (NONCAUSAL,
                                                         flash_attention)
    from repro_torch.kernels.attention.ref import (HOLD, attention_ref,
                                                   hold_ratio)
    from repro_torch.models import attention, forward, init_params

    hd, h = cfg.resolved_head_dim, cfg.n_heads
    print(f"audio: {cfg.name}, {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{h} heads over {cfg.n_kv_heads} KV heads of {hd}, non-causal, "
          f"{cfg.act} d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.param_count() / 1e9:.3f} B params", flush=True)
    t0 = time.perf_counter()
    model = init_params(cfg, SERVE_SEED, torch.bfloat16, dev)
    torch.cuda.synchronize()
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    print(f"audio: bf16 weights drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s, {weight_bytes / 1e9:.3f} GB",
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED + 1)
    frames = torch.randn((AUDIO_BATCH, AUDIO_FRAMES, cfg.d_model),
                         generator=gen, device=dev).to(torch.bfloat16)

    # -- the timed forwards, counted, and a profile ------------------------
    def encode():
        return forward(model, cfg, {"embeds": frames})

    encode()  # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.LAUNCHES.reset()
    t0 = time.perf_counter()
    for _ in range(AUDIO_TIMED):
        logits = encode()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / AUDIO_TIMED
    launches = build.LAUNCHES.snapshot()
    audio_s = AUDIO_BATCH * AUDIO_CLIP_S
    print(f"audio {cfg.name}: encode {AUDIO_BATCH}x{AUDIO_FRAMES} frames "
          f"({audio_s:.0f} s of audio) in {wall * 1e3:.1f} ms a forward "
          f"(mean of {AUDIO_TIMED}), {audio_s / wall:.1f} s of audio per "
          f"wall second; peak {torch.cuda.max_memory_allocated() / 1e9:.2f} "
          f"GB; launches {launches}", flush=True)
    want = cfg.n_layers * AUDIO_TIMED
    check(launches.get(NONCAUSAL, 0) == want
          and launches.get("flash_attention", 0) == 0,
          f"audio {cfg.name}: K4's non-causal form launched "
          f"{launches.get(NONCAUSAL, 0)} times in {AUDIO_TIMED} forwards "
          f"({cfg.n_layers} a forward, {want} expected), its causal form "
          f"{launches.get('flash_attention', 0)} times (0 expected)")
    check(tuple(logits.shape) == (AUDIO_BATCH, AUDIO_FRAMES, cfg.vocab_size)
          and logits.dtype == torch.bfloat16
          and bool(torch.isfinite(logits).all()),
          f"audio {cfg.name}: logits {tuple(logits.shape)} "
          f"{str(logits.dtype)[6:]}, finite")
    busy, count, by_name = device_time(torch, encode)
    check_tensor_core_prefill(check, f"audio profile {cfg.name}, one forward",
                              by_name, cfg.n_layers)
    k4_ms = sum(ms for name, ms, _ in by_name if "prefill_" in name)
    share = (f"{busy / (wall * 1e3):.1%} of the timed forward's "
             f"{wall * 1e3:.1f} ms; K4 {k4_ms:.1f} ms, "
             f"{k4_ms / busy:.1%} of the card time" if busy
             else "not measured (no device time in the trace)")
    print(f"audio profile {cfg.name}, one forward: {count} kernels, "
          f"{busy:.1f} ms on the card, {share}; top: " + "; ".join(
              f"{name[:60]} {ms:.1f} ms x{n}" for name, ms, n in by_name[:6]),
          flush=True)
    del model, logits
    free_card(torch)

    # -- hold on the card: f32 weights, 2 clips ----------------------------
    model = init_params(cfg, SERVE_SEED, torch.float32, dev)
    x = frames[:AUDIO_HOLD_BATCH].float()
    full = forward(model, cfg, {"embeds": x})
    with plain_versions([(attention, "gqa_attention", attention_ref)]):
        full_p = forward(model, cfg, {"embeds": x})
    err = rel_err(torch, full, full_p)
    check(bool(torch.isfinite(full).all()) and tuple(full.shape) == (
              AUDIO_HOLD_BATCH, AUDIO_FRAMES, cfg.vocab_size)
          and err <= LOGIT_TOL,
          f"hold {cfg.name}: kernel route vs plain version on the card, f32, "
          f"logits {tuple(full.shape)} finite, max |d| {err:.3g} of the "
          f"largest |logit| ({float(full.abs().max()):.3g})")
    del model, x, full, full_p
    free_card(torch)

    # -- K4's non-causal form against its plain version, and two mutants ----
    b, s = AUDIO_BATCH, AUDIO_FRAMES
    lo = (s - 1) // 64 * 64  # the last, partial key tile: keys lo..s-1
    errs = {}
    for seed, dtype in enumerate((torch.bfloat16, torch.float32)):
        q, k, v = attention_inputs(torch, dev, b, s, s, h, cfg.n_kv_heads,
                                   hd, seed + 20, dtype)
        got = flash_attention(q, k, v, causal=False)
        want = attention_ref(q, k, v, causal=False)
        ratio = hold_ratio(got, want)
        errs[dtype] = float((got.float() - want.float()).abs().max())
        u, r = HOLD[dtype]
        check(ratio <= 1,
              f"K4 flash_attention vs plain, non-causal: q {tuple(q.shape)}, "
              f"k/v {tuple(k.shape)} {str(dtype)[6:]}, max |d| "
              f"{errs[dtype]:.3g}, at most {ratio:.3g} of the bound "
              f"{u:.3g}·|want| + {r:.3g}·rms(row)")
        bad = hold_ratio(attention_ref(q, k, v), want)
        check(bad > 1, f"K4 hold, non-causal {str(dtype)[6:]}: the causal "
              f"plain version stands at {bad:.3g} of the bound, so it fails")
        k0, v0 = k.clone(), v.clone()
        k0[:, lo:] = 0
        v0[:, lo:] = 0
        bad = hold_ratio(attention_ref(q, k0, v0, causal=False), want)
        check(bad > 1, f"K4 hold, non-causal {str(dtype)[6:]}: the plain "
              f"version with keys {lo}..{s - 1} zeroed stands at {bad:.3g} "
              f"of the bound, so it fails")
        del got, want, k0, v0
        if dtype == torch.bfloat16:
            case = (q, k, v)
        del q, k, v
    free_card(torch)
    q, k, v = case
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=False)

    lib_err = float((library().transpose(1, 2).float() - attention_ref(
        q, k, v, causal=False).float()).abs().max())
    pairs = b * h * s * s  # every (q, k) pair is kept
    flops = 4 * hd * pairs
    nbytes = 2 * (q.numel() + k.numel()) * q.element_size()  # q, o; k, v
    clock = max_sm_clock_hz()
    t_ops, t_bytes = flops / PEAK_BF16_FLOP_S, nbytes / PEAK_BYTES_S
    t_sfu = pairs / (SFU_PER_SM_CLOCK * SMS * clock)
    print(f"K4 bound at q {tuple(q.shape)}, k/v {tuple(k.shape)} bf16, "
          f"non-causal: {pairs:.4g} (q, k) pairs x 4·{hd} = "
          f"{flops / 1e9:.1f} GFLOP -> {t_ops * 1e3:.4f} ms at 989 TFLOP/s "
          f"bf16 ({flops / PEAK_FP32_FLOP_S * 1e3:.3f} ms at 67 TFLOP/s "
          f"fp32); {nbytes / 1e6:.1f} MB -> {t_bytes * 1e3:.4f} ms; "
          f"{pairs:.4g} exp on the SFUs at {clock / 1e9:.3f} GHz -> "
          f"{t_sfu * 1e3:.4f} ms.  SDPA vs plain: max |d| {lib_err:.3g}",
          flush=True)
    ms = time_ms(torch, lambda: flash_attention(q, k, v, causal=False), 10)
    return {"name": f"flash_attention (non-causal, head_dim {hd})",
            "route": "cuda", "source": "src/repro_torch/csrc/attention.cu",
            "replaces": "src/repro/kernels/attention/attention.py:80",
            "launches": launches.get(NONCAUSAL, 0),
            "max_abs_err": max(errs.values()), "ms": ms,
            "plain_ms": time_ms(torch, lambda: attention_ref(
                q, k, v, causal=False), 2),
            "bound_ms": max(t_ops, t_bytes, t_sfu) * 1e3,
            "bound_by": "bytes" if t_bytes >= max(t_ops, t_sfu)
            else "operations",
            "library_ms": time_ms(torch, library, 10),
            **prefill_rate("non-causal prefill", flops, ms,
                           max(t_ops, t_bytes, t_sfu) * 1e3)}


def capped_inputs(torch, dev, bsz, sq, sk, h, kvh, d, seed, q_offset, cap):
    """``attention_inputs`` in f32 with the keys 30 times larger (scores
    spread far past ``cap``) and key row ``q_offset + i`` a multiple of
    query row i (``ref.scores_over_cap``: a score of ``2·cap`` in every
    query row)."""
    from repro_torch.kernels.attention.ref import scores_over_cap

    q, k, v = attention_inputs(torch, dev, bsz, sq, sk, h, kvh, d, seed,
                               torch.float32)
    return q, scores_over_cap(q, 30 * k, cap, q_offset), v


def flex_capped(torch, qt, kt, vt, window, cap, causal=True):
    """K4's capped causal function, with ``window`` > 0 its band, as one
    PyTorch call for ``library_ms``: ``flex_attention`` with the soft-cap
    ``cap·tanh(s/cap)`` as its score_mod and the mask as its block mask,
    compiled once (one compile thread, its caches in the build directory);
    not ``causal``: no mask (the decode form over its keys alone).  qt
    (B, H, Sq, hd), kt/vt (B, KV, Sk, hd).  Returns the call."""
    import torch._dynamo.config as dynamo_config
    import torch._inductor.config as inductor_config
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    from repro_torch.kernels.build import BUILD_DIR

    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                          os.path.join(BUILD_DIR, "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(BUILD_DIR,
                                                           "triton"))
    inductor_config.compile_threads = 1
    # one compile per shape and dtype: the prefill and decode forms take 8
    dynamo_config.cache_size_limit = max(dynamo_config.cache_size_limit, 32)
    s = qt.shape[2]

    def softcap(score, b, h, q_idx, kv_idx):
        return cap * torch.tanh(score / cap)

    def mask(b, h, q_idx, kv_idx):
        keep = q_idx >= kv_idx
        return keep & (q_idx - kv_idx < window) if window else keep

    block_mask = (create_block_mask(mask, None, None, s, s, device=qt.device)
                  if causal else None)
    flex = torch.compile(flex_attention, dynamic=False)
    return lambda: flex(qt, kt, vt, score_mod=softcap, block_mask=block_mask,
                        scale=qt.shape[-1] ** -0.5, enable_gqa=True)


def flex_decode(torch, q, k, v, q_offset, k_len, window, cap):
    """K4's capped decode form as one PyTorch call for ``library_ms``:
    ``flex_capped`` (no mask) of the one query over the keys it sees (from
    the first live split of K4's plan to the end of its last), copied out
    of the cache into the (B, KV, keys, hd) layout outside the call.
    Returns the call, its output in q's layout."""
    from repro_torch.kernels.attention.attention import decode_plan

    _, live = decode_plan(k, q_offset, k_len, window)
    lo, n_keys = live[0][0], live[-1][1]
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (t[:, lo:n_keys].transpose(1, 2).contiguous() for t in (k, v))
    flex = flex_capped(torch, qt, kt, vt, 0, cap, causal=False)
    return lambda: flex().transpose(1, 2)


def gemma2_serving_phase(torch, check, cfg, dev) -> list[dict]:
    """``cfg`` (Gemma2-2B) served on ``dev`` with a bf16 KV cache, the
    kernel route held against K4's plain version and decode against
    forward past the window, and K4's capped forms (prefill and decode,
    with and without the window, and an f32 query over a bf16 cache) held
    and timed against their plain versions, the prefill forms beside
    ``flex_attention`` of the same function (the rows' ``library_ms``) and
    SDPA of the uncapped function.  Returns the ``kernels`` rows of the
    capped form and the capped windowed form."""
    import torch.nn.functional as F

    from repro_torch.kernels.attention.attention import (
        CAPPED, CAPPED_WINDOWED, decode_plan, flash_attention)
    from repro_torch.kernels.attention.ref import (HOLD, attention_ref,
                                                   hold_ratio,
                                                   scores_over_cap)
    from repro_torch.models import attention, init_params

    hd, h, kvh = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    win, cap = cfg.local_window, cfg.logit_softcap
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    n_local, n_global = kinds.count("local_attn"), kinds.count("attn")
    print(f"serve: {cfg.name}, {cfg.n_layers} layers ({n_local} local, "
          f"window {win}; {n_global} global), d_model {cfg.d_model}, {h} "
          f"heads over {kvh} KV heads of {hd}, {cfg.act} d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size} tied, caps {cap} / {cfg.final_softcap}, "
          f"post-norms, {cfg.param_count() / 1e9:.2f} B params", flush=True)
    model, prompts = served_model(torch, cfg, dev, GEMMA2_BATCH,
                                  GEMMA2_PROMPT)

    # -- the timed serve, counted, and its profile ----------------------
    toks, launches, in_prefill, t_prefill, t_decode = timed_serve(
        torch, check, model, cfg, prompts,
        {CAPPED: n_global, CAPPED_WINDOWED: n_local})
    check(launches.get("flash_attention", 0) == 0,
          f"serve {cfg.name}: K4's uncapped form launched "
          f"{launches.get('flash_attention', 0)} times (0 expected)")
    profile_serve(torch, model, cfg, prompts, toks, t_prefill, t_decode,
                  check, cfg.n_layers)
    del model
    free_card(torch)

    # -- hold on the card: f32 weights, one prompt past the window --------
    model = init_params(cfg, SERVE_SEED, torch.float32, dev)
    hold_serve(torch, check, model, cfg, prompts[:1, :GEMMA2_HOLD_PROMPT],
               GEMMA2_HOLD_DECODE,
               [(attention, "gqa_attention", attention_ref)])
    del model
    free_card(torch)

    # -- K4's capped forms against their plain versions, with mutants ------
    b, s = GEMMA2_BATCH, GEMMA2_PROMPT
    length = s + 1  # the decode form at the first step's cache length
    cache = s + SERVE_NEW
    forms = (("prefill", (b, s, s, h, kvh, hd), 0, s, 0),
             (f"prefill, window {win}", (b, s, s, h, kvh, hd), 0, s, win),
             (f"decode over {length} keys", (b, 1, cache, h, kvh, hd),
              length - 1, length, 0),
             (f"decode over {length} keys, window {win}",
              (b, 1, cache, h, kvh, hd), length - 1, length, win))
    # (form, q dtype, k/v dtype): bf16 in every form, f32 in the prefill
    # forms, an f32 q over a bf16 cache in the decode forms
    bf16, f32 = torch.bfloat16, torch.float32
    holds = ([(i, bf16, bf16) for i in range(4)]
             + [(i, f32, f32) for i in (0, 1)]
             + [(i, f32, bf16) for i in (2, 3)])

    def capped_case(i, q_dtype, kv_dtype):
        """Form i's inputs (``capped_inputs``); in the decode forms also
        the first key of the middle split that holds keys (of K4's split
        plan) scores 2·cap, so that the split carries weight in every
        row."""
        _, shape, q_offset, k_len, window = forms[i]
        q, k, v = capped_inputs(torch, dev, *shape, i + 30, q_offset, cap)
        if shape[1] == 1:
            _, live = decode_plan(k, q_offset, k_len, window)
            k = scores_over_cap(q, k, cap, live[(len(live) - 1) // 2][0])
        return q.to(q_dtype), k.to(kv_dtype), v.to(kv_dtype)

    cases, errs, flex_ratio = {}, {}, {}
    for i, q_dtype, kv_dtype in holds:
        name, shape, q_offset, k_len, window = forms[i]
        label = (str(q_dtype)[6:] if q_dtype == kv_dtype
                 else "f32 q, bf16 k/v")
        q, k, v = capped_case(i, q_dtype, kv_dtype)
        got = flash_attention(q, k, v, q_offset, k_len, window,
                              logit_cap=cap)
        want = attention_ref(q, k, v, q_offset, k_len, window,
                             logit_cap=cap)
        ratio = hold_ratio(got, want)
        errs[name, label] = float((got.float() - want.float()).abs().max())
        u, r = HOLD[want.dtype]
        check(ratio <= 1 and got.dtype == q.dtype,
              f"K4 flash_attention capped vs plain, {name}: q "
              f"{tuple(q.shape)} {str(q.dtype)[6:]}, k/v "
              f"{tuple(k.shape)} {str(k.dtype)[6:]}, max |d| "
              f"{errs[name, label]:.3g}, at most {ratio:.3g} of the "
              f"bound {u:.3g}·|want| + {r:.3g}·rms(row)")
        bad = hold_ratio(attention_ref(q, k, v, q_offset, k_len, window),
                         want)
        check(bad > 1, f"K4 hold, {name} ({label}): the plain version "
              f"without the cap stands at {bad:.3g} of the bound, so it "
              f"fails")
        if window:
            bad = hold_ratio(attention_ref(q, k, v, q_offset, k_len,
                                           logit_cap=cap), want)
            check(bad > 1, f"K4 hold, {name} ({label}): the plain "
                  f"version without the window stands at {bad:.3g} of "
                  f"the bound, so it fails")
        if shape[1] == 1:
            check_split_drop(torch, check, f"{name} ({label})", q, k, v,
                             q_offset, k_len, window, cap, want)
        if q_dtype == f32 == kv_dtype:
            # the library call of the rows below computes K4's function:
            # held like K4 in f32, where its arithmetic is exact enough
            # (in bf16 it rounds the probabilities, as SDPA does)
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            flex_ratio[name] = hold_ratio(flex_capped(
                torch, qt, kt, vt, window, cap)().transpose(1, 2), want)
            check(flex_ratio[name] <= 1,
                  f"flex_attention vs K4's plain version, {name} (f32): at "
                  f"most {flex_ratio[name]:.3g} of the bound")
            del qt, kt, vt
        if shape[1] > 1 and q_dtype == bf16 or q_dtype != kv_dtype:
            cases[name, label] = (q, k, v)
        del q, k, v, got, want
        free_card(torch)

    clock = max_sm_clock_hz()
    t_sfu_pair = 2 / (SFU_PER_SM_CLOCK * SMS * clock)  # an exp and a tanh
    rows, timings = [], []
    for (name, shape, q_offset, k_len, window), key in (
            (forms[0], CAPPED), (forms[1], CAPPED_WINDOWED)):
        q, k, v = cases.pop((name, "bfloat16"))
        pairs = b * h * sum(min(i + 1, window or s) for i in range(s))
        flops = 4 * hd * pairs
        nbytes = 2 * (q.numel() + k.numel()) * q.element_size()
        t_ops, t_bytes = flops / PEAK_BF16_FLOP_S, nbytes / PEAK_BYTES_S
        t_sfu = pairs * t_sfu_pair
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
        if window:
            pos = torch.arange(s, device=dev)
            band = (pos[:, None] >= pos[None, :]) & (
                pos[:, None] - pos[None, :] < window)

            def library(qt=qt, kt=kt, vt=vt, band=band):
                return F.scaled_dot_product_attention(
                    qt, kt.repeat_interleave(h // kvh, dim=1),
                    vt.repeat_interleave(h // kvh, dim=1), attn_mask=band)
        else:
            def library(qt=qt, kt=kt, vt=vt):
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)
        flex = flex_capped(torch, qt, kt, vt, window, cap)
        ms = time_ms(torch, lambda: flash_attention(
            q, k, v, window=window, logit_cap=cap), 10)
        plain_ms = time_ms(torch, lambda: attention_ref(
            q, k, v, window=window, logit_cap=cap), 3)
        sdpa_ms = time_ms(torch, library, 10)
        flex_ms = time_ms(torch, flex, 10)
        bound = max(t_ops, t_bytes, t_sfu) * 1e3
        print(f"K4 capped {name} at q {tuple(q.shape)}, k/v {tuple(k.shape)} "
              f"bf16, cap {cap}: {pairs:.4g} (q, k) pairs x 4·{hd} = "
              f"{flops / 1e9:.1f} GFLOP -> {t_ops * 1e3:.4f} ms at 989 "
              f"TFLOP/s bf16 ({flops / PEAK_FP32_FLOP_S * 1e3:.3f} ms at 67 "
              f"TFLOP/s fp32); {nbytes / 1e6:.1f} MB -> {t_bytes * 1e3:.4f} "
              f"ms; {2 * pairs:.4g} exp and tanh on the SFUs at "
              f"{clock / 1e9:.3f} GHz -> {t_sfu * 1e3:.4f} ms.  Kernel "
              f"{ms:.4f} ms ({ms / bound:.1f}x the bound), plain "
              f"{plain_ms:.4f} ms, flex_attention with the cap "
              f"{flex_ms:.4f} ms (in f32 at {flex_ratio[name]:.3g} of the "
              f"hold), SDPA of the uncapped function {sdpa_ms:.4f} ms",
              flush=True)
        del qt, kt, vt, flex
        form = f"capped, window {window}" if window else "capped"
        rows.append({"name": f"flash_attention ({form}, head_dim {hd})",
                     "route": "cuda",
                     "source": "src/repro_torch/csrc/attention.cu",
                     "replaces": "src/repro/kernels/attention/attention.py:80",
                     "launches": in_prefill.get(key, 0),
                     "max_abs_err": max(e for (n, _), e in errs.items()
                                        if n == name),
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": "bytes" if t_bytes >= max(t_ops, t_sfu)
                     else "operations",
                     "library_ms": flex_ms,
                     **prefill_rate(f"capped {name}", flops, ms, bound)})
        del q, k, v
    free_card(torch)
    for i, key in ((2, CAPPED), (3, CAPPED_WINDOWED)):
        name, _, q_offset, k_len, window = forms[i]
        rows.append(decode_row(
            torch, check, f"capped {name}",
            lambda dtype, i=i: capped_case(i, dtype, dtype), q_offset, k_len,
            window, cap,
            lambda q, k, v, q_offset=q_offset, k_len=k_len, window=window:
            flex_decode(torch, q, k, v, q_offset, k_len, window, cap),
            launches.get(key, 0) - in_prefill.get(key, 0)))
        free_card(torch)
        q, k, v = cases[name, "f32 q, bf16 k/v"]
        keys = min(k_len, window or k_len)
        nbytes = 2 * b * keys * kvh * hd * k.element_size()

        def kernel(q=q, k=k, v=v, q_offset=q_offset, k_len=k_len,
                   window=window):
            return flash_attention(q, k, v, q_offset, k_len, window,
                                   logit_cap=cap)

        ms = time_ms(torch, kernel, 100)
        dev_ms, _ = kernel_ms(torch, kernel)
        plain_ms = time_ms(torch, lambda: attention_ref(
            q, k, v, q_offset, k_len, window, logit_cap=cap), 10)
        timings.append(
            f"{name} (f32 q, bf16 k/v): {ms:.4f} ms by CUDA events, "
            f"{dev_ms:.4f} ms on the card, plain {plain_ms:.4f} ms, reads "
            f"{nbytes / 1e6:.2f} MB of cache, bound "
            f"{nbytes / PEAK_BYTES_S * 1e3:.4f} ms")
        del q, k, v
    print("K4 capped decode forms: " + "; ".join(timings), flush=True)
    return rows


def encoder_cases(torch, vs, spec, first_frames, dev) -> list[tuple]:
    """(name, (n, h, w) u8 frames on the card, keyframe interval, quant
    scale) of K3's encoder form: one golden segment (ingest's first jackson
    segment), the same segment transcoded to the fast SF as ingest
    transcodes it, and a ragged case (13 frames in chunks of 5, black and
    white squares whose edges ring past 0 and 255: ``ref.encode_inputs``)."""
    from repro_torch.codec import transform as T
    from repro_torch.core.knobs import FidelityOption
    from repro_torch.kernels.dct8.ref import encode_inputs

    raw = torch.from_numpy(first_frames).to(dev)
    out = []
    for name, sf_id in (("golden", "sf_g"), ("fast", "sf1")):
        sf = vs.formats[sf_id]
        frames = T.convert_fidelity(raw, FidelityOption(), sf.fidelity, spec)
        out.append((name, frames.contiguous(), sf.coding.keyframe,
                    sf.fidelity.quant_scale))
    golden_qs = out[0][3]
    out.append(("ragged", encode_inputs(13, spec.height, spec.width, 13,
                                        dev), 5, golden_qs))
    return out


def encoder_row(torch, check, vs, spec, first_frames, launches,
                dev) -> dict:
    """K3's encoder form held against the stepped K3 + K1 route (equal) and
    its plain version (K3's bound) on ``encoder_cases``, each mutant of
    ``ref.ENCODE_MUTANTS`` failing that bound, timed at the golden and fast
    shapes (CUDA events and the profiler) beside the stepped route, its
    plain version and its bound; then one profiled ingest encode of a
    segment into the fast SF.  Returns its ``kernels`` row."""
    from repro_torch.core.knobs import FidelityOption
    from repro_torch.kernels.dct8.dct8 import (dct8_dequantize,
                                               dct8_encode_chunks,
                                               dct8_quantize)
    from repro_torch.kernels.dct8.ref import (ENCODE_MUTANTS,
                                              dct8_encode_chunks_ref,
                                              encode_chunks_stepped,
                                              encode_mutant, k3_holds)

    def stepped(f, k, qs):
        return encode_chunks_stepped(f, k, qs, dct8_quantize, dct8_dequantize)

    cases = encoder_cases(torch, vs, spec, first_frames, dev)
    errs, timed = [], {}
    for name, f, k, qs in cases:
        got = dct8_encode_chunks(f, k, qs)
        n_step = int((got != stepped(f, k, qs)).sum())
        check(n_step == 0, f"K3 encoder form vs the stepped K3 + K1 route, "
              f"{name} {tuple(f.shape)} k {k}: {n_step} of {got.numel()} "
              f"symbols differ")
        plain = dct8_encode_chunks_ref(f, k, qs)
        ok, n_plain = k3_holds(got, plain)
        errs.append(float((got.int() - plain.int()).abs().max()))
        del plain
        check(ok, f"K3 encoder form vs plain, {name}: {n_plain} of "
              f"{got.numel()} symbols differ (at most 1e-6 by one)")
        for mutant in ENCODE_MUTANTS:
            held, n_bad = k3_holds(got, encode_mutant(mutant, f, k, qs))
            if name == "ragged" or mutant == "prediction reset every frame":
                check(not held, f"K3 encoder hold, {name}: the plain "
                      f"version with the {mutant} differs in {n_bad} "
                      f"symbols, so it fails")
            else:
                print(f"K3 encoder hold, {name}: the plain version with the "
                      f"{mutant} differs in {n_bad} symbols", flush=True)
        if name != "ragged":
            timed[name] = (f, k, qs, got.numel())
        del got
    free_card(torch)

    row = {"name": "dct8_encode_chunks", "route": "cuda",
           "source": "src/repro_torch/csrc/dct8.cu",
           "replaces": "src/repro/kernels/dct8/dct8.py:64",
           "launches": launches.get("dct8_encode_chunks", 0),
           "max_abs_err": max(errs)}
    for name, (f, k, qs, n_sym) in timed.items():
        nbytes = f.numel() + 2 * n_sym          # u8 in, int16 out
        flops = 2 * n_sym / 64 * (2048 + 64)    # K3 and K1 a block
        b_ms, b_by = bound_ms(nbytes, flops)
        ms = time_ms(torch, lambda: dct8_encode_chunks(f, k, qs), 20)
        dev_ms, by_kernel = kernel_ms(
            torch, lambda: dct8_encode_chunks(f, k, qs), 10)
        step_ms = time_ms(torch, lambda: stepped(f, k, qs), 3)
        step_dev_ms, _ = kernel_ms(torch, lambda: stepped(f, k, qs), 2)
        plain_ms = time_ms(torch, lambda: dct8_encode_chunks_ref(f, k, qs), 1)
        print(f"K3 encoder form, {name} {tuple(f.shape)} k {k}: {ms:.4f} ms "
              f"by CUDA events, {dev_ms:.4f} ms on the card (profiler: "
              f"{by_kernel}); bound {b_ms:.4f} ms ({b_by}: "
              f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); the stepped "
              f"route {step_ms:.3f} ms ({step_dev_ms:.3f} ms on the card); "
              f"plain {plain_ms:.1f} ms", flush=True)
        keys = ({"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                 "stepped_ms": step_ms, "stepped_device_ms": step_dev_ms}
                if name == "golden" else
                {"fast_ms": ms, "fast_device_ms": dev_ms,
                 "fast_plain_ms": plain_ms, "fast_bound_ms": b_ms,
                 "fast_stepped_ms": step_ms,
                 "fast_stepped_device_ms": step_dev_ms})
        row.update(keys)
    del timed, cases
    free_card(torch)

    # one segment's ingest encode into the fast SF, under the profiler
    sf = vs.formats["sf1"]
    t0 = time.perf_counter()
    busy, n_kernels, by_name = device_time(
        torch, lambda: vs.encode_format(first_frames, FidelityOption(), sf))
    wall = (time.perf_counter() - t0) * 1e3
    print(f"profiled ingest encode of one segment into {sf.name()}: "
          f"{wall:.1f} ms wall (profiler on), the card busy {busy:.3f} ms "
          f"({100 * busy / wall:.2f}%), {n_kernels} kernels: " + "; ".join(
              f"{n} {ms:.3f} ms x{c}" for n, ms, c in by_name), flush=True)
    row["ingest_encode_busy_share"] = busy / wall
    return row


def plain_dct_resize():
    """(module, name, plain version) of K1, the standalone K3, K3's encoder
    form and K2 as their dispatch calls them: bound by ``plain_versions``,
    the codec, ``apply_quality`` and the operators run the plain versions
    on the card."""
    from repro_torch.kernels.dct8 import ops as dct_ops
    from repro_torch.kernels.dct8.ref import (dct8_dequantize_ref,
                                              dct8_encode_chunks_ref,
                                              dct8_quantize_ref)
    from repro_torch.kernels.resize import ops as resize_ops
    from repro_torch.kernels.resize.ref import resize_ref

    return [(dct_ops, "dct8_quantize", dct8_quantize_ref),
            (dct_ops, "dct8_dequantize", dct8_dequantize_ref),
            (dct_ops, "dct8_encode_chunks", dct8_encode_chunks_ref),
            (resize_ops, "resize_bilinear", resize_ref)]


def config_phase(torch, check, check_items, first_frames, dev) -> dict:
    """The configuration phase: derive a configuration on the card, hold
    it against the plain route's, store and query in its formats, and
    materialize a 720p30 segment into its CFs.  Counters zeroed just before
    it and read after its card runs (before the comparisons with the plain
    versions).  Returns its launches and ``apply_quality``'s times."""
    from repro_torch.analytics.batch import derive_shapes
    from repro_torch.analytics.query import run_query
    from repro_torch.analytics.scene import generate_segment
    from repro_torch.codec import transform as T
    from repro_torch.core import (DEFAULT_OPS, Profiler, TableProfiler,
                                  choose_coding, derive_config, plan_erosion)
    from repro_torch.core.knobs import (QUALITY_QUANT_SCALE, IngestSpec,
                                        fidelity_space)
    from repro_torch.kernels import build
    from repro_torch.videostore.video_store import VideoStore

    real_spec = IngestSpec(720, 1280, 30, 4)
    spec = IngestSpec()
    print(f"cut: the configuration phase profiles, stores and queries at "
          f"the reference's own spec, {spec.height}x{spec.width} at "
          f"{spec.fps} fps ({spec.segment_seconds}-s segments), not 720p30: "
          f"the operators' thresholds were tuned there (at 720p30 Query A's "
          f"Diff flags nothing), and the storage profiles code every "
          f"candidate SF on the host with zlib (one golden 720p segment "
          f"takes 140-205 s at zlib 9 on an H100 machine's host); "
          f"{CONFIG_SEGMENTS} sample segments a "
          f"stream, benchmarks/common.py's setting", flush=True)

    # -- a. derive a configuration on the card ------------------------------
    build.LAUNCHES.reset()
    t_phase = time.perf_counter()
    prof = Profiler(spec, n_segments=CONFIG_SEGMENTS, repeats=1, device=dev)
    cfg = derive_config(prof, ops=DEFAULT_OPS,
                        accuracies=CONFIG_ACCURACIES)
    t_derive = time.perf_counter() - t_phase
    cpu_s, cuda_s = prof.dct_dispatch_cost()
    # Diff scores frame pairs at a segment's positions, so its batches hold
    # a segment's frames: with the default 64 both packages raise
    overhead_s, per_frame_s = prof.dispatch_overhead(
        "diff", n_big=spec.frames_per_segment)
    shapes = derive_shapes(overhead_s, per_frame_s)
    st = prof.stats
    print(cfg.table(), flush=True)
    print(f"derived: {len(cfg.nodes)} SFs, {6 * len(cfg.nodes)} knobs (4 a "
          f"fidelity + 2 a coding); {st.consumption_runs} consumption runs, "
          f"{st.storage_runs} storage runs, {st.memo_hits} memo hits, "
          f"{st.wall_seconds:.1f} s profiling; derive {t_derive:.1f} s: "
          f"consumer profiling {st.consumer_seconds:.1f} s, storage "
          f"profiling (conversion + coding) {st.encode_seconds:.1f} s, "
          f"retrieval profiling {st.retrieval_seconds:.1f} s; dct dispatch "
          f"{cpu_s * 1e3:.3f} ms plain (CPU), {cuda_s * 1e3:.3f} ms K1 (card)"
          f" -> dct_backend {cfg.dct_backend}; dispatch overhead "
          f"{overhead_s * 1e3:.3f} ms, {per_frame_s * 1e6:.2f} us a frame -> "
          f"batch shapes {shapes}", flush=True)
    check(cfg.dct_backend == "cuda",
          f"dct_backend {cfg.dct_backend!r} from the measured dispatch costs "
          f"(K1 {cuda_s * 1e3:.3f} ms, plain {cpu_s * 1e3:.3f} ms)")
    subscribed = [p for n in cfg.nodes for p in n.plans]
    n_consumers = len(DEFAULT_OPS) * len(CONFIG_ACCURACIES)
    check(len(subscribed) == len(cfg.plans) == n_consumers
          and {id(p) for p in subscribed} == {id(p) for p in cfg.plans},
          f"R3: each of {len(cfg.plans)} consumers subscribed once")
    check(all(n.fidelity.richer_eq(p.cf) for n in cfg.nodes for p in n.plans),
          "R1: each SF's fidelity is richer than or equal to its CFs")
    r2 = [(n.sf.name(), p.consumer.name()) for n in cfg.nodes
          for p in n.plans
          if not prof.retrieval_speed(n.sf, p.cf) > p.speed
          and not (n.sf.coding.bypass
                   and choose_coding(prof, n.fidelity, n.plans) is None)]
    check(not r2, f"R2: each subscribed consumer's retrieval speed exceeds "
          f"its consumption speed (or RAW, where no coding keeps up): "
          f"{r2 or 'all'}")
    golden = [n for n in cfg.nodes if n.golden]
    check(len(golden) == 1 and all(golden[0].fidelity.richer_eq(p.cf)
                                   for p in cfg.plans),
          "the golden SF exists, once, and dominates every CF")
    check(all(p.accuracy >= p.consumer.target - 1e-9 for p in cfg.plans),
          "every plan's accuracy is at least its target")
    exhaustive = len(DEFAULT_OPS) * len(fidelity_space())
    check(st.consumption_runs < exhaustive,
          f"{st.consumption_runs} consumer profiles, fewer than the "
          f"exhaustive search's {exhaustive}")

    # -- b. the plain route's derivation -----------------------------------
    acc, cost, storage, retrieve = prof.tables()
    with plain_versions(plain_dct_resize()):
        plain_prof = Profiler(spec, n_segments=CONFIG_SEGMENTS, repeats=1,
                              device=dev)
        plain_acc = {cell: plain_prof.accuracy(*cell) for cell in acc}
    d_f1 = [abs(plain_acc[cell] - a) for cell, a in acc.items()]
    print(f"plain route: {sum(d == 0 for d in d_f1)} of {len(d_f1)} profiled "
          f"(op, f) accuracies equal the card's, max |dF1| {max(d_f1):.4g}",
          flush=True)
    plain_cfg = derive_config(TableProfiler(plain_acc, cost, storage,
                                            retrieve),
                              ops=DEFAULT_OPS, accuracies=CONFIG_ACCURACIES)
    check([(p.consumer, p.cf) for p in plain_cfg.plans]
          == [(p.consumer, p.cf) for p in cfg.plans],
          "the plain route's derivation (its accuracies, the card's speeds "
          "and storage tables) gives every consumer the card's CF")
    check(plain_cfg.storage_formats() == cfg.storage_formats()
          and plain_cfg.coalesce_log.rounds == cfg.coalesce_log.rounds,
          f"... and the card's SFs and rounds log "
          f"({len(cfg.coalesce_log.rounds)} rounds)")
    subs = {p: i for i, n in enumerate(cfg.nodes) for p in n.plans}
    daily = [prof.storage_profile(n.sf)[1] * 86400 for n in cfg.nodes]
    golden_idx = next(i for i, n in enumerate(cfg.nodes) if n.golden)
    for frac in EROSION_BUDGETS:
        plan = plan_erosion(prof, cfg.nodes, subs, daily, 10,
                            frac * sum(daily) * 10)
        intact = all(f.get(golden_idx, 0) == 0 for f in plan.fractions)
        print(f"erosion at {frac} of the full storage: k {plan.k:.3f}, "
              f"feasible {plan.feasible}, day-1 speed "
              f"{plan.overall_speed[0]:.3f}, day-10 speed "
              f"{plan.overall_speed[-1]:.3f}, golden intact {intact}",
              flush=True)
        check(intact, f"erosion at {frac}: golden intact")

    # -- c. store and query in the derived formats --------------------------
    work = tempfile.mkdtemp(prefix=".smoke-", dir=HERE)
    try:
        root = os.path.join(work, "store")
        vs = VideoStore(root, spec, device=dev)
        vs.set_formats(cfg.storage_formats())
        segs = list(range(CONFIG_SEGMENTS))
        for stream in STREAMS.values():
            for seg in segs:
                vs.ingest_segment(stream, seg,
                                  generate_segment(stream, seg, spec)[0])
        vs.flush()
        for stream in STREAMS.values():
            s = vs.ingest_stats[stream]
            print(f"derived store, {stream}: {s.segments} segments, "
                  f"{s.bytes_per_video_second(spec):.1f} bytes a video "
                  f"second, cost {s.cost_xrealtime(spec):.4f} x realtime",
                  flush=True)

        def queries(store):
            return {q: run_query(store, cfg, q, stream, segs, ACCURACY,
                                 batch_segments=len(segs),
                                 batch_shapes=shapes)
                    for q, stream in STREAMS.items()}

        card = queries(vs)
        torch.cuda.synchronize()
        plain = queries(VideoStore(root, spec, readonly=True, device="cpu"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for q, res in card.items():
        rows = [(s.op, s.frames, s.segments_scanned, s.detect_calls, s.items)
                for s in res.stages]
        print(f"derived query {q}: {res.measured_speed:.1f}x realtime, "
              f"{len(res.items)} items; stages {rows}", flush=True)
        check(rows == [(s.op, s.frames, s.segments_scanned, s.detect_calls,
                        s.items) for s in plain[q].stages],
              f"derived query {q} stage stats equal the plain path's")
        check_items(res.items, plain[q].items, 0.98,
                    f"derived query {q} items, kernel path vs plain path")

    # -- d. a 720p30 segment materialized into every derived CF -------------
    raw = torch.from_numpy(first_frames).to(dev)
    cfs = sorted({p.cf for p in cfg.plans})
    card_frames = [T.materialize(raw, cf, real_spec) for cf in cfs]
    torch.cuda.synchronize()
    launches = build.LAUNCHES.snapshot()
    t_phase = time.perf_counter() - t_phase
    print(f"launches in the configuration phase: {launches}", flush=True)
    for name in ("dct8_dequantize", "resize_bilinear", "dct8_quantize",
                 "dct8_encode_chunks"):
        check(launches.get(name, 0) > 0,
              f"{name} launched in the configuration phase")
    with plain_versions(plain_dct_resize()):
        for cf, got in zip(cfs, card_frames):
            want = T.materialize(raw, cf, real_spec)
            d = (got.int() - want.int()).abs()
            n_diff = int((d > 0).sum())
            check(int(d.max()) <= 1 and n_diff <= 1e-3 * d.numel(),
                  f"materialize at {tuple(real_spec.resolve(cf))} "
                  f"{cf.name()}: {n_diff} of {d.numel()} u8 pixels differ "
                  f"from the plain versions' (max {int(d.max())})")
    del card_frames

    qs = QUALITY_QUANT_SCALE["bad"]
    n = raw.numel()
    b_ms, b_by = bound_ms(2 * n, 2 * n / 64 * (2048 + 64))
    ms = time_ms(torch, lambda: T.apply_quality(raw, qs), 10)
    dev_ms, by_kernel = kernel_ms(torch, lambda: T.apply_quality(raw, qs), 10)
    with plain_versions(plain_dct_resize()):
        plain_ms = time_ms(torch, lambda: T.apply_quality(raw, qs), 1)
    print(f"apply_quality at {tuple(raw.shape)} (qs {qs}): {ms:.4f} ms by "
          f"CUDA events, {dev_ms:.4f} ms on the card (profiler: "
          f"{by_kernel}); bound {b_ms:.4f} ms ({b_by}: u8 in and out, both "
          f"transforms); plain {plain_ms:.2f} ms", flush=True)
    print(f"configuration phase: {t_phase:.1f} s to its counters read",
          flush=True)
    return {"launches": launches, "apply_quality_ms": ms,
            "apply_quality_device_ms": dev_ms,
            "apply_quality_bound_ms": b_ms,
            "apply_quality_plain_ms": plain_ms}


def main() -> int:
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 2

    from repro_torch.analytics.accuracy import f1_score
    from repro_torch.analytics.operators import NN
    from repro_torch.codec import segment as S
    from repro_torch.codec import transform as T
    from repro_torch.configs import get_config
    from repro_torch.core.knobs import FidelityOption, IngestSpec
    from repro_torch.kernels import build
    from repro_torch.kernels.dct8.dct8 import dct8_dequantize, dct8_quantize
    from repro_torch.kernels.dct8.ref import (dct8_dequantize_ref,
                                              dct8_quantize_ref, k3_holds)
    from repro_torch.kernels.resize.resize import band, resize_bilinear
    from repro_torch.kernels.resize.ref import resize_ref
    from repro_torch.videostore.video_store import VideoStore

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    failures: list[str] = []

    def check(ok: bool, what: str):
        print(f"check {'ok  ' if ok else 'FAIL'} {what}", flush=True)
        if not ok:
            failures.append(what)

    def check_items(card, plain, min_f1: float, what: str):
        """Items of the kernel path against the plain path's: F1 at least
        ``min_f1``, and neither side empty (empty sets agree vacuously)."""
        f1 = f1_score(card, plain) if card and plain else 0.0
        check(f1 >= min_f1, f"{what}: F1 {f1:.4f} ({len(card)} vs "
              f"{len(plain)} items, neither may be empty)")

    t_start = t0 = time.perf_counter()
    rows: list[dict] = []
    reports = build.compile_all()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    built = ptxas_builds(reports)
    for name, entry, _, _, lines in built:
        for line in lines:
            print(f"ptxas {name} {entry[:72]}: {line}")
    tc = tensor_core_prefill_builds(built)
    print("ptxas K4 prefill_mma_kernel<hd, capped>: " + "; ".join(
        f"<{hd}, {str(cap).lower()}> {regs} registers, {spill} bytes spilled"
        for (hd, cap), (regs, spill) in sorted(tc.items())), flush=True)
    check(len(tc) == 10 and all(spill == 0 for _, spill in tc.values()),
          f"K4's {len(tc)} tensor-core prefill kernels (10 expected: hd 32, "
          f"64, 80, 128, 256, capped and not) spill nothing")
    sb = scan_builds(built)
    scan_registers = {f"<{x}, {n}>": regs
                      for (x, n), (regs, _) in sorted(sb.items())}
    print("ptxas K5 scan_kernel<xc, n>: " + "; ".join(
        f"<{x}, {n}> {regs} registers, {spill} bytes spilled"
        for (x, n), (regs, spill) in sorted(sb.items())), flush=True)
    check(len(sb) == 4 and all(spill == 0 for _, spill in sb.values()),
          f"K5's {len(sb)} scan_kernel builds (4 expected: xc f32 and bf16, "
          f"n 8 and 16) spill nothing")
    rk = {entry: (regs, spill) for name, entry, regs, spill, _ in built
          if name == "resize" and "resize_kernel" in entry}
    print("ptxas K2 resize_kernel<TW>: " + "; ".join(
        f"{entry} {regs} registers, {spill} bytes spilled"
        for entry, (regs, spill) in sorted(rk.items())), flush=True)
    check(len(rk) == 4 and all(spill == 0 for _, spill in rk.values()),
          f"K2's {len(rk)} resize_kernel builds (4 expected: tiles of 128, "
          f"64, 32 and 16 columns) spill nothing")
    lb = lru_builds(built)
    print("ptxas K6 scan_kernel<form>: " + "; ".join(
        f"{form} {regs} registers, {spill} bytes spilled"
        for form, (regs, spill) in sorted(lb.items())), flush=True)
    check(len(lb) == 3 and all(spill == 0 for _, spill in lb.values()),
          f"K6's {len(lb)} scan_kernel builds (3 expected: the standalone "
          f"form, gated bf16 and f32) spill nothing")
    enc = [(regs, spill) for name, entry, regs, spill, _ in built
           if name == "dct8" and "encode_chunks_kernel" in entry]
    check(len(enc) == 1 and enc[0][1] == 0,
          f"K3's encoder form (encode_chunks_kernel) builds once and spills "
          f"nothing: {enc} (registers, bytes spilled)")

    spec = IngestSpec(height=720, width=1280, fps=30, segment_seconds=4)
    cfg = smoke_config()
    work = tempfile.mkdtemp(prefix=".smoke-", dir=HERE)
    try:
        root = os.path.join(work, "store")
        vs = VideoStore(root, spec, device="cuda")
        vs.set_formats(cfg.storage_formats())

        # -- the main path: ingest, Query A, Query B ------------------------
        build.LAUNCHES.reset()
        t0 = time.perf_counter()
        first_frames = ingest_all(vs, SEGMENTS)
        torch.cuda.synchronize()
        t_ingest = time.perf_counter() - t0
        in_ingest = build.LAUNCHES.snapshot()
        n_seg = len(SEGMENTS) * len(STREAMS)
        raw_gb = n_seg * first_frames.nbytes / 1e9
        print(f"ingest: {n_seg} segments, {raw_gb:.2f} GB raw u8, "
              f"{t_ingest:.1f} s, stored {vs.storage_bytes() / 1e6:.1f} MB",
              flush=True)
        results = run_queries(vs, cfg, SEGMENTS)
        torch.cuda.synchronize()
        launches = build.LAUNCHES.snapshot()

        for query, res in results.items():
            stages = ", ".join(f"{s.op}: {s.frames} frames/"
                               f"{s.segments_scanned} segs/{s.items} items/"
                               f"{s.retrieve_s:.2f} s retrieve/"
                               f"{s.consume_s:.2f} s detect"
                               for s in res.stages)
            print(f"query {query} ({STREAMS[query]}): "
                  f"{res.measured_speed:.1f}x realtime "
                  f"({res.video_seconds} s of video in {res.wall_s:.2f} s), "
                  f"{len(res.items)} items; {stages}", flush=True)
        for query, res in run_queries(vs, cfg, SEGMENTS).items():
            print(f"query {query} warm (not counted): "
                  f"{res.measured_speed:.1f}x realtime", flush=True)
        print(f"launches on the main path: {launches} ({in_ingest} of them "
              f"in ingest)", flush=True)
        coded = sum(not sf.coding.bypass for sf in vs.formats.values())
        check(launches.get("dct8_encode_chunks", 0) == n_seg * coded,
              f"K3's encoder form launched once a segment and coded format "
              f"on the main path: {launches.get('dct8_encode_chunks', 0)} "
              f"({n_seg} x {coded} expected)")
        check(launches.get("dct8_quantize", 0) == 0,
              "the standalone K3 (dct8_quantize) launched 0 times on the "
              "main path: the encoder runs K3's encoder form")
        check(in_ingest.get("dct8_dequantize", 0) == 0
              and launches.get("dct8_dequantize", 0) > 0,
              f"K1 (dct8_dequantize) launched by the decoder only: "
              f"{in_ingest.get('dct8_dequantize', 0)} in ingest, "
              f"{launches.get('dct8_dequantize', 0)} on the main path")
        check(launches.get("resize_bilinear", 0) > 0,
              "resize_bilinear launched on the main path")

        # -- the stage phase: every item-producing stage on real frames -----
        runs = stage_runs(cfg)
        build.LAUNCHES.reset()
        stage_frames, stage_card = [], []
        for run in runs:
            stream, _op, sf_id, cf = run
            frames, _ = vs.retrieve_many(stream, list(SEGMENTS),
                                         sf_id, cf)
            stage_frames.append(frames)
            stage_card.append(drive_stage(vs, run, frames, build.LAUNCHES))
        stage_launches = build.LAUNCHES.snapshot()
        print(f"launches in the stage phase: {stage_launches}", flush=True)
        for name in ("dct8_dequantize", "resize_bilinear"):
            check(stage_launches.get(name, 0) > 0,
                  f"{name} launched in the stage phase")
        for run, out in zip(runs, stage_card):
            if run[1] == "nn":
                want = (nn_pyramid_resizes(run[3], spec)
                        * out["stats"].detect_calls)
                check(out["k2"] == want,
                      f"stage nn launched K2 {out['k2']} times at its pyramid "
                      f"levels ({want} expected)")

        # -- output checks ---------------------------------------------------
        golden, _ = vs.retrieve(STREAMS["A"], SEGMENTS[0], "sf_g",
                                FidelityOption())
        mse = float(((golden.float() - torch.from_numpy(first_frames).to(
            golden.device).float()) ** 2).mean())
        psnr = 10 * np.log10(255.0 ** 2 / max(mse, 1e-9))
        plain_golden, _ = VideoStore(root, spec, readonly=True,
                                     device="cpu").retrieve(
            STREAMS["A"], SEGMENTS[0], "sf_g", FidelityOption())
        check(tuple(golden.shape) == first_frames.shape and psnr >= 35.0
              and torch.equal(golden.cpu(), plain_golden),
              f"golden {STREAMS['A']}:{SEGMENTS[0]} decodes to {tuple(golden.shape)} "
              f"u8 equal to the plain decode, PSNR {psnr:.2f} dB vs the "
              f"ingested frames")

        t0 = time.perf_counter()
        plain = run_queries(VideoStore(root, spec, readonly=True,
                                       device="cpu"), cfg, SEGMENTS)

        def stage_row(s):
            return (s.op, s.frames, s.segments_scanned, s.detect_calls,
                    s.items)

        for query in STREAMS:
            card_rows = [stage_row(s) for s in results[query].stages]
            check(card_rows == [stage_row(s) for s in plain[query].stages],
                  f"query {query} stage stats (op, frames, segments, detect "
                  f"calls, items) equal the plain path's: {card_rows}")
        check_items(results["B"].items, plain["B"].items, 0.98,
                    "query B items, kernel path vs plain path")
        print(f"query A: {len(results['A'].items)} items on the kernel path, "
              f"{len(plain['A'].items)} on the plain path (Diff flags no "
              f"event on 720p30 jackson; S-NN and NN are held in the stage "
              f"phase)", flush=True)
        print(f"plain path (CPU): {time.perf_counter() - t0:.1f} s", flush=True)

        for run, frames, card in zip(runs, stage_frames, stage_card):
            stream, op, sf_id, cf = run
            ref = drive_stage(vs, run, [f.cpu() for f in frames],
                              build.LAUNCHES)
            union = set().union(*card["items"].values())
            check_items(union, set().union(*ref["items"].values()), 1.0,
                        f"stage {op} on {stream} {sf_id}/{cf.name()}, "
                        f"{card['stats'].frames} frames, kernel path vs plain")
            check(card["items"] == ref["items"]
                  and card["stats"] == ref["stats"],
                  f"stage {op}: items per segment and batch stats equal "
                  f"({card['stats'].detect_calls} detect calls)")
            print(f"stage {op}: {card['s']:.3f} s on the card, "
                  f"{ref['s']:.3f} s plain (CPU), "
                  f"{sum(map(len, card['items'].values()))} items in "
                  f"{sum(1 for v in card['items'].values() if v)} of "
                  f"{len(SEGMENTS)} segments", flush=True)
        del stage_frames

        # -- kernels against their plain versions, timed --------------------
        kernels = []
        dev = torch.device("cuda")

        # K3 on the encoder's input: a frame minus the mid-grey prediction
        resid = torch.from_numpy(first_frames[:1]).to(dev).float() - 128.0
        qs = FidelityOption().quant_scale  # golden quality
        sym = dct8_quantize(resid, qs)
        want = dct8_quantize_ref(resid, qs)
        ok, n_diff = k3_holds(sym, want)
        check(ok, f"K3 dct8_quantize vs plain on {tuple(resid.shape)}: "
              f"{n_diff} of {sym.numel()} symbols differ")
        n = resid.numel()
        kernels.append(("dct8_quantize",
                        float((sym.int() - want.int()).abs().max()),
                        lambda: dct8_quantize(resid, qs),
                        lambda: dct8_quantize_ref(resid, qs), None,
                        bound_ms(n * 4 + n * 2, n / 64 * (2048 + 64)),
                        "src/repro/kernels/dct8/dct8.py:64"))

        # K1 on the decoder's input: a whole golden segment's symbols
        blob = vs.backend.get(f"{STREAMS['A']}:sf_g:{SEGMENTS[0]:06d}")
        header, payload = S._parse(blob)
        chunks = np.arange(-(-header["n"] // header["k"]))
        sym_np, _ = S._chunk_symbols(header, payload, chunks,
                                     S._pad_chunk_count(len(chunks)))
        sym_all = torch.from_numpy(sym_np).to(dev).transpose(0, 1).reshape(
            -1, *sym_np.shape[2:]).contiguous()
        qs = header["qs"]
        r = dct8_dequantize(sym_all, qs)
        err1 = float((r - dct8_dequantize_ref(sym_all, qs)).abs().max())
        check(err1 <= 1e-3, f"K1 dct8_dequantize vs plain on "
              f"{tuple(sym_all.shape)}: max |d| {err1:.3g}")
        n = r.numel()
        kernels.append(("dct8_dequantize", err1,
                        lambda: dct8_dequantize(sym_all, qs),
                        lambda: dct8_dequantize_ref(sym_all, qs), None,
                        bound_ms(n * 2 + n * 4, n / 64 * (2048 + 64)),
                        "src/repro/kernels/dct8/dct8.py:85"))

        # K2 on ingest's transcode of a golden segment to the fast SF's grid
        sf = vs.formats["sf1"].fidelity
        idx = T.temporal_indices(FidelityOption(), sf, spec)
        x = torch.from_numpy(first_frames[idx]).to(dev).float()
        nf, h1, w1 = x.shape
        h2, w2 = spec.resolve(sf)[1:]
        y = resize_bilinear(x, h2, w2)
        err2 = float((y - resize_ref(x, h2, w2)).abs().max())
        check(err2 <= 1e-3, f"K2 resize_bilinear vs plain on "
              f"{tuple(x.shape)} -> {(h2, w2)}: max |d| {err2:.3g}")
        lib_err = float((y - F.interpolate(
            x[:, None], size=(h2, w2), mode="bilinear", antialias=True,
            align_corners=False)[:, 0]).abs().max())
        print(f"K2 vs F.interpolate(antialias=True): max |d| {lib_err:.3g}",
              flush=True)
        # ... and at NN's 2/3 pyramid level of the golden grid and on OCR's
        # plate patches (300 of them, where OCR cuts them at 720p) to 9 x 26
        nn_h, nn_w = int(h1 * NN.scales[1]), int(w1 * NN.scales[1])
        g = torch.Generator(device=dev).manual_seed(2)
        ph, pw = max(4, round(9 * h1 / 96)), max(8, round(26 * w1 / 160))
        at = torch.stack([torch.randint(0, nf, (300,), generator=g,
                                        device=dev),
                          torch.randint(0, h1 - ph, (300,), generator=g,
                                        device=dev),
                          torch.randint(0, w1 - pw, (300,), generator=g,
                                        device=dev)], 1).tolist()
        patches = torch.stack([x[t, r:r + ph, c:c + pw] for t, r, c in at])
        for what, src, hw in (("NN's 2/3 level", x, (nn_h, nn_w)),
                              ("OCR's plate patches", patches, (9, 26))):
            err = float((resize_bilinear(src, *hw)
                         - resize_ref(src, *hw)).abs().max())
            check(err <= 1e-3, f"K2 resize_bilinear vs plain at {what}, "
                  f"{tuple(src.shape)} -> {hw}: max |d| {err:.3g}")
            err2 = max(err2, err)
        del patches
        ty, tx = band(h2, h1)[1].shape[1], band(w2, w1)[1].shape[1]
        kernels.append((
            "resize_bilinear", err2, lambda: resize_bilinear(x, h2, w2),
            lambda: resize_ref(x, h2, w2),
            lambda: F.interpolate(x[:, None], size=(h2, w2), mode="bilinear",
                                  antialias=True, align_corners=False),
            bound_ms(4 * nf * (h1 * w1 + h2 * w2),
                     2 * nf * (h2 * w1 * ty + h2 * w2 * tx)),
            "src/repro/kernels/resize/resize.py:58"))

        sources = {"dct8_quantize": "src/repro_torch/csrc/dct8.cu",
                   "dct8_dequantize": "src/repro_torch/csrc/dct8.cu",
                   "resize_bilinear": "src/repro_torch/csrc/resize.cu"}
        for name, err, fn, plain, lib, (b_ms, b_by), replaces in kernels:
            rows.append({
                "name": name, "route": "cuda", "source": sources[name],
                "replaces": replaces, "launches": launches.get(name, 0),
                "max_abs_err": err, "ms": time_ms(torch, fn, 20),
                "plain_ms": time_ms(torch, plain, 3), "bound_ms": b_ms,
                "bound_by": b_by,
                "library_ms": None if lib is None else time_ms(torch, lib, 5)})
        k2 = next(row for row in rows if row["name"] == "resize_bilinear")
        k2["device_ms"] = kernel_ms(
            torch, lambda: resize_bilinear(x, h2, w2), 20)[0]
        k2["registers"] = next((regs for entry, (regs, _) in rk.items()
                                if "resize_kernelILi128E" in entry), None)
        print(f"K2 resize_bilinear at {tuple(x.shape)} -> {(h2, w2)}: "
              f"{k2['ms']:.4f} ms by CUDA events, {k2['device_ms']:.4f} ms "
              f"on the card (profiler), bound {k2['bound_ms']:.4f} ms",
              flush=True)
        check(k2["device_ms"] > 0, "K2's calls show in a profiler trace")
        k3 = next(row for row in rows if row["name"] == "dct8_quantize")
        k3["device_ms"] = kernel_ms(
            torch, lambda: dct8_quantize(resid, FidelityOption().quant_scale),
            20)[0]
        print(f"K3 dct8_quantize at {tuple(resid.shape)}: {k3['ms']:.4f} ms "
              f"by CUDA events, {k3['device_ms']:.4f} ms on the card "
              f"(profiler)", flush=True)
        rows.append(encoder_row(torch, check, vs, spec, first_frames,
                                launches, dev))
        rows[-1]["registers"] = enc[0][0] if enc else None
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"video path: {time.perf_counter() - t_start:.1f} s", flush=True)

    # -- the configuration phase, counters zeroed inside it -----------------
    t0 = time.perf_counter()
    conf = config_phase(torch, check, check_items, first_frames,
                        torch.device("cuda"))
    for row in rows:
        if row["name"] in ("dct8_quantize", "dct8_dequantize",
                           "resize_bilinear", "dct8_encode_chunks"):
            by_path = {"video": row["launches"],
                       "config": conf["launches"].get(row["name"], 0)}
            row["launches_by_path"] = by_path
            row["launches"] = sum(by_path.values())
    k3 = next(row for row in rows if row["name"] == "dct8_quantize")
    k3.update({k: v for k, v in conf.items() if k.startswith("apply_")})
    print(f"configuration phase: {time.perf_counter() - t0:.1f} s",
          flush=True)
    free_card(torch)

    # -- the serving phases, counters zeroed inside each --------------------
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    rows.append(serving_phase(torch, check, get_config(SERVE_ARCH), dev,
                              scan_registers))
    print(f"serving phase: {time.perf_counter() - t0:.1f} s", flush=True)
    free_card(torch)
    t0 = time.perf_counter()
    rows.extend(dense_serving_phase(torch, check, get_config(DENSE_ARCH),
                                    dev))
    print(f"dense serving phase: {time.perf_counter() - t0:.1f} s",
          flush=True)
    free_card(torch)
    t0 = time.perf_counter()
    rows.extend(hybrid_serving_phase(torch, check, get_config(HYBRID_ARCH),
                                     dev, lb))
    print(f"hybrid serving phase: {time.perf_counter() - t0:.1f} s",
          flush=True)
    free_card(torch)
    t0 = time.perf_counter()
    rows.append(audio_phase(torch, check, get_config(AUDIO_ARCH), dev))
    print(f"audio phase: {time.perf_counter() - t0:.1f} s", flush=True)
    free_card(torch)
    t0 = time.perf_counter()
    rows.extend(gemma2_serving_phase(torch, check, get_config(GEMMA2_ARCH),
                                     dev))
    print(f"gemma2 serving phase: {time.perf_counter() - t0:.1f} s; whole "
          f"run {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)

    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed: {failures}",
              file=sys.stderr)
        return 1
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
