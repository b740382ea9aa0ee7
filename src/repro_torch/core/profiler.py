"""Port of ``repro/core/profiler.py``: the profiling harness (paper
§4.2/§4.3).  It measures, per fidelity option, an operator's accuracy and
consumption speed, and per storage format, its ingestion cost, storage
cost, and retrieval speed for a downstream consumer.

A measured ``Profiler`` runs on one device, the card unless the caller
passes ``device="cpu"``: its sample segments move there once and stay, and
materializing (K2, the standalone K3 and K1), detecting, encoding (K3's
encoder form) and decoding (K1) run there.  Work on the card is launched
asynchronously, so every timed region starts and ends in
``torch.cuda.synchronize()`` on a CUDA device before the clock is read.

All results are memoized -- the paper's configuration overhead reductions
(Fig. 13, §6.4) come from (a) profiling only boundary fidelity options and
(b) memoizing storage-format profiles across coalescing rounds.  The counters
here feed the overhead benchmark.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..codec import segment as codec
from ..codec import transform as T
from ..device import resolve_device
from .knobs import FidelityOption, IngestSpec, StorageFormat


def _analytics():
    """Deferred import: analytics depends on core.knobs, so importing it at
    module scope would cycle through the package inits."""
    from ..analytics.accuracy import f1_score
    from ..analytics.operators import OPERATORS
    from ..analytics.scene import generate_segment
    return f1_score, OPERATORS, generate_segment

GOLDEN_F = FidelityOption("best", 1.0, 720, 1.0)

# Paper §6.1: ops of query A profiled on jackson, query B on dashcam.
DEFAULT_PROFILE_STREAMS = {
    "diff": "jackson", "snn": "jackson", "nn": "jackson",
    "motion": "dashcam", "license": "dashcam", "ocr": "dashcam",
}


@dataclasses.dataclass
class ProfilerStats:
    consumption_runs: int = 0
    storage_runs: int = 0
    memo_hits: int = 0
    wall_seconds: float = 0.0
    # wall_seconds by activity: consumer profiles (materialize + detect,
    # golden items included), storage-format samples (conversion + coding)
    # and retrieval (decode + conversion); the dispatch probes count in
    # wall_seconds only
    consumer_seconds: float = 0.0
    encode_seconds: float = 0.0
    retrieval_seconds: float = 0.0


class Profiler:
    """Measured profiling over procedurally generated sample segments."""

    def __init__(self, spec: IngestSpec | None = None, n_segments: int = 3,
                 streams: dict[str, str] | None = None, repeats: int = 2,
                 device=None):
        self.device = resolve_device(device)
        self.spec = spec or IngestSpec()
        self.n_segments = n_segments
        self.streams = streams or dict(DEFAULT_PROFILE_STREAMS)
        self.repeats = repeats
        self.stats = ProfilerStats()
        self._samples: dict[str, list[torch.Tensor]] = {}
        self._golden: dict[tuple, set] = {}
        self._consume: dict[tuple, tuple[float, float]] = {}
        self._storage: dict[tuple, tuple[float, float]] = {}
        self._retrieve: dict[tuple, float] = {}
        self._blob_cache: dict[tuple, tuple[list[bytes], float]] = {}

    def _clock(self) -> float:
        """Host clock after the device's queued work has finished."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    # -- samples -------------------------------------------------------------
    def _segments(self, stream: str) -> list[torch.Tensor]:
        if stream not in self._samples:
            _, _, generate_segment = _analytics()
            self._samples[stream] = [
                torch.from_numpy(generate_segment(stream, i, self.spec)[0]
                                 ).to(self.device)
                for i in range(self.n_segments)]
        return self._samples[stream]

    def _golden_items(self, op_name: str, stream: str, i: int) -> set:
        key = (op_name, stream, i)
        if key not in self._golden:
            _, OPERATORS, _ = _analytics()
            seg = self._segments(stream)[i]
            self._golden[key] = OPERATORS[op_name].detect(seg, GOLDEN_F,
                                                          self.spec)
        return self._golden[key]

    # -- consumer profile (accuracy + consumption speed) ----------------------
    def consumer_profile(self, op_name: str, f: FidelityOption
                         ) -> tuple[float, float]:
        """Returns (accuracy F1, consumption speed in x-realtime)."""
        key = (op_name, f)
        if key in self._consume:
            self.stats.memo_hits += 1
            return self._consume[key]
        t_start = self._clock()
        f1_score, OPERATORS, _ = _analytics()
        op = OPERATORS[op_name]
        stream = self.streams.get(op_name, "jackson")
        accs, best_t = [], []
        for i, seg in enumerate(self._segments(stream)):
            frames = T.materialize(seg, f, self.spec)
            times = []
            pred = None
            for _ in range(self.repeats):
                t0 = self._clock()
                pred = op.detect(frames, f, self.spec)
                times.append(self._clock() - t0)
            accs.append(f1_score(pred, self._golden_items(op_name, stream, i)))
            best_t.append(min(times))
        acc = float(np.mean(accs))
        speed = self.spec.segment_seconds * len(accs) / max(sum(best_t), 1e-9)
        self._consume[key] = (acc, speed)
        self.stats.consumption_runs += 1
        dt = self._clock() - t_start
        self.stats.wall_seconds += dt
        self.stats.consumer_seconds += dt
        return acc, speed

    def accuracy(self, op_name: str, f: FidelityOption) -> float:
        return self.consumer_profile(op_name, f)[0]

    def consumption_speed(self, op_name: str, f: FidelityOption) -> float:
        return self.consumer_profile(op_name, f)[1]

    # -- storage-format profile ------------------------------------------------
    def _blobs(self, sf: StorageFormat) -> tuple[list[bytes], float]:
        """Encoded sample blobs for a storage format + encode seconds."""
        key = (sf.fidelity, sf.coding)
        if key in self._blob_cache:
            return self._blob_cache[key]
        t_start = self._clock()
        stream = "jackson"
        blobs, enc_t = [], 0.0
        for seg in self._segments(stream):
            frames = T.convert_fidelity(frames_u8=seg, f_from=GOLDEN_F,
                                        f_to=sf.fidelity, spec=self.spec)
            t0 = self._clock()
            if sf.coding.bypass:
                blob = codec.encode_raw(frames)
            else:
                blob = codec.encode_segment(
                    frames, quant_scale=sf.fidelity.quant_scale,
                    keyframe_interval=sf.coding.keyframe,
                    zstd_level=sf.coding.zstd_level)
            enc_t += self._clock() - t0
            blobs.append(blob)
        self._blob_cache[key] = (blobs, enc_t)
        self.stats.encode_seconds += self._clock() - t_start
        return blobs, enc_t

    def storage_profile(self, sf: StorageFormat) -> tuple[float, float]:
        """Returns (ingest cost: encode-seconds per video-second,
        storage cost: bytes per video-second)."""
        key = (sf.fidelity, sf.coding)
        if key in self._storage:
            self.stats.memo_hits += 1
            return self._storage[key]
        t_start = self._clock()
        blobs, enc_t = self._blobs(sf)
        dur = self.n_segments * self.spec.segment_seconds
        res = (enc_t / dur, sum(len(b) for b in blobs) / dur)
        self._storage[key] = res
        self.stats.storage_runs += 1
        self.stats.wall_seconds += self._clock() - t_start
        return res

    def dispatch_overhead(self, op_name: str = "diff",
                          f: FidelityOption | None = None,
                          n_big: int = 64) -> tuple[float, float]:
        """Measured ``(dispatch_overhead_s, per_frame_s)`` of one operator
        call: the fixed cost of an ``op.detect`` invocation (launches,
        host<->device staging, Python glue) versus the marginal per-frame
        compute.  Fit from two batch sizes -- a single frame (all fixed
        cost) and ``n_big`` frames -- with the best of ``repeats`` runs
        after a warm-up.  Feeds ``repro_torch.analytics.batch.derive_shapes``:
        the batched consumer's static shape ladder is coarse when dispatch
        dominates and fine when per-frame compute does.  Memoized like the
        other profiles."""
        if n_big < 2:
            raise ValueError(f"n_big must be >= 2, got {n_big}")
        f = f or GOLDEN_F
        key = ("dispatch", op_name, f, n_big)
        if key in self._consume:
            self.stats.memo_hits += 1
            return self._consume[key]
        t_start = self._clock()
        _, OPERATORS, _ = _analytics()
        op = OPERATORS[op_name]
        stream = self.streams.get(op_name, "jackson")
        seg = self._segments(stream)[0]
        frames = T.materialize(seg, f, self.spec)
        idx = torch.arange(n_big, device=frames.device) % len(frames)
        big = frames[idx]
        times = {1: [], n_big: []}
        for n, batch in ((1, big[:1]), (n_big, big)):
            op.detect(batch, f, self.spec)  # warm-up
            for _ in range(max(2, self.repeats)):
                t0 = self._clock()
                op.detect(batch, f, self.spec)
                times[n].append(self._clock() - t0)
        t1, tn = min(times[1]), min(times[n_big])
        per_frame = max((tn - t1) / (n_big - 1), 1e-9)
        overhead = max(t1 - per_frame, 0.0)
        self._consume[key] = (overhead, per_frame)
        self.stats.consumption_runs += 1
        self.stats.wall_seconds += self._clock() - t_start
        return overhead, per_frame

    def dct_dispatch_cost(self, n_frames: int = 8,
                          resolution: int = 360) -> tuple[float, float]:
        """Measured wall seconds of one fused dct8 dequantize dispatch per
        route: ``(cpu_s, cuda_s)``, the plain route on a CPU tensor and K1
        on a CUDA tensor, each with its symbols already on its device and
        its residuals left there (the decoder keeps them on its device).
        The probe shape is the reference's, a decode-representative chunk:
        8 frames at 360², int16 symbols drawn from seed 0.  Best of
        ``repeats`` after a warm call per route.  A CPU profiler measures
        the plain route only and returns ``cuda_s = inf``.  Memoized like
        the other profiles; feeds ``derive_config``'s
        ``DerivedConfig.dct_backend``."""
        key = ("dct_dispatch", n_frames, resolution)
        if key in self._consume:
            self.stats.memo_hits += 1
            return self._consume[key]
        t_start = self._clock()
        from ..kernels.dct8.ops import dct_dequantize
        hb = wb = resolution // 8
        rng = np.random.default_rng(0)
        sym = torch.from_numpy(
            rng.integers(-32, 32, (n_frames, hb, wb, 8, 8), dtype=np.int16))
        best = {"cpu": float("inf"), "cuda": float("inf")}
        routes = ("cpu", "cuda") if self.device.type == "cuda" else ("cpu",)
        for route in routes:
            dev = torch.device("cpu") if route == "cpu" else self.device
            x = sym.to(dev)
            dct_dequantize(x, 2.0)
            times = []
            for _ in range(max(2, self.repeats)):
                t0 = self._clock()
                dct_dequantize(x, 2.0)
                times.append(self._clock() - t0)
            best[route] = min(times)
        res = (best["cpu"], best["cuda"])
        self._consume[key] = res
        self.stats.consumption_runs += 1
        self.stats.wall_seconds += self._clock() - t_start
        return res

    def tables(self) -> tuple[dict, dict, dict, dict]:
        """What this profiler has measured, as ``TableProfiler``'s tables:
        accuracy and consumption speed by (op, f), (ingest, storage) cost
        by (fidelity, coding), retrieval speed by (fidelity, coding, cf)."""
        cells = {k: v for k, v in self._consume.items()
                 if len(k) == 2 and isinstance(k[1], FidelityOption)}
        return ({k: v[0] for k, v in cells.items()},
                {k: v[1] for k, v in cells.items()},
                dict(self._storage), dict(self._retrieve))

    def retrieval_speed(self, sf: StorageFormat, cf: FidelityOption) -> float:
        """x-realtime speed of decoding SF (with chunk-skip for the CF's
        sampling) and converting to CF, on the profiler's device."""
        key = (sf.fidelity, sf.coding, cf)
        if key in self._retrieve:
            self.stats.memo_hits += 1
            return self._retrieve[key]
        t_start = self._clock()
        blobs, _ = self._blobs(sf)
        t_decode = self._clock()
        want = T.temporal_indices(sf.fidelity, cf, self.spec)
        times = []
        for blob in blobs:
            for _ in range(self.repeats):
                t0 = self._clock()
                frames = codec.decode_segment(blob, want, device=self.device)
                T.spatial_convert(frames, sf.fidelity, cf, self.spec)
                times.append(self._clock() - t0)
        per_seg = np.median(np.asarray(times).reshape(len(blobs), -1).min(axis=1))
        speed = self.spec.segment_seconds / max(float(per_seg), 1e-9)
        self._retrieve[key] = speed
        self.stats.storage_runs += 1
        t_end = self._clock()
        self.stats.wall_seconds += t_end - t_start
        self.stats.retrieval_seconds += t_end - t_decode
        return speed


class TableProfiler:
    """Profiler backed by explicit tables — used by unit/property tests and
    by exhaustive-vs-search validation (deterministic, no wall clock)."""

    def __init__(self, acc: dict, cost: dict, storage: dict | None = None,
                 retrieve: dict | None = None):
        self._acc, self._cost = acc, cost
        self._storage = storage or {}
        self._retrieve = retrieve or {}
        self.stats = ProfilerStats()
        self._seen_consumer = set()
        self._seen_storage = set()

    def consumer_profile(self, op, f):
        if (op, f) in self._seen_consumer:
            self.stats.memo_hits += 1
        else:
            self._seen_consumer.add((op, f))
            self.stats.consumption_runs += 1
        return self._acc[(op, f)], self._cost[(op, f)]

    def accuracy(self, op, f):
        return self.consumer_profile(op, f)[0]

    def consumption_speed(self, op, f):
        return self.consumer_profile(op, f)[1]

    def storage_profile(self, sf):
        key = (sf.fidelity, sf.coding)
        if key in self._seen_storage:
            self.stats.memo_hits += 1
        else:
            self._seen_storage.add(key)
            self.stats.storage_runs += 1
        return self._storage[key]

    def retrieval_speed(self, sf, cf):
        return self._retrieve[(sf.fidelity, sf.coding, cf)]
