"""Port of ``repro/analytics/batch.py``: cross-segment batched consumption.

The port runs eagerly and has no jit cache; it keeps the reference's
static batch shapes so that it feeds the operators the same padded
batches (the shape ladder a later CUDA-graph path will capture).  Frames
are tensors and are concatenated on their device.

Cross-segment batched consumption: one operator call over many segments'
activated frames.

The cascade executors historically called ``op.detect`` once per segment,
paying a jit dispatch + small-batch penalty for every 8-second segment even
when a late cascade stage has only a handful of activated frames per
segment.  ``BatchedConsumer`` gathers activated frames from many segments,
tags each frame with its segment via a *slot offset* on the position axis,
pads the concatenation to a small static set of batch shapes (so jit caches
stay warm), runs **one** ``op.detect`` per shape bucket, and scatters the
detected items back to per-segment results.

Bit-exactness with the per-segment path is by construction:

* Every operator is a per-frame program on the batch axis — conv, resize,
  per-frame reductions — so a frame's scores do not depend on which other
  frames share the batch.  The one exception is ``Diff``, which scores
  *consecutive-frame pairs*; see the slot-gap invariant below.
* Items carry their time bucket in position 1 (the cascade-wide invariant
  ``next_active = {it[1] ...}`` already relies on).  Offsetting a segment's
  positions by ``slot * stride`` (``stride`` a multiple of the bucket size)
  shifts its buckets by ``slot * buckets_per_slot`` exactly, so scattering
  is a ``divmod`` — no per-item bookkeeping rides through the operator.
* **Slot-gap invariant**: ``stride`` leaves a gap of at least
  ``_MIN_SLOT_GAP`` position ticks between consecutive segments' frames.
  ``Diff`` divides each pair score (``mean|Δ| <= 1.0`` on [0,1] pixels) by
  the positional gap, so a cross-segment pair can never reach its
  threshold — the batched path introduces no boundary detections.  Pairs
  *within* a segment see the same positions, hence the same gaps and the
  same scores, as the per-segment call.
* Shape buckets never split a segment (whole segments are packed greedily),
  so no within-segment ``Diff`` pair is lost to a chunk boundary.  Padding
  frames are zeros placed in a sentinel slot past every real segment; any
  item a padded frame could produce scatters to the sentinel and is
  dropped.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.knobs import IngestSpec
from ..obs.trace import span as _span
from .operators import Diff, Operator

# Minimum positional gap between consecutive slots' frames.  Diff's score
# for a frame pair is mean|Δ| / gap with mean|Δ| <= 1.0, so any gap
# >= ceil(1 / threshold) + 1 keeps every cross-segment pair strictly below
# threshold.  128 also gives headroom if the threshold is retuned downward.
_MIN_SLOT_GAP = max(128, int(np.ceil(1.0 / Diff.threshold)) + 1)

# The static batch shapes operator calls are padded to (plus the exact size
# for the rare batch larger than the top shape): the reference's ladder,
# so both packages feed their operators the same batches.
DEFAULT_BATCH_SHAPES = (8, 16, 32, 64, 128, 256)


def derive_shapes(dispatch_overhead_s: float, per_frame_s: float, *,
                  min_shape: int = 8, max_shape: int = 256,
                  max_rungs: int = 10) -> tuple[int, ...]:
    """Static shape ladder sized from *measured* dispatch economics instead
    of the fixed power-of-two ladder (the reference's rule, verbatim).

    The ladder trades two costs.  Padding a batch of ``n`` frames up to the
    next rung ``r*n`` wastes ``n*(r-1)`` frames of operator compute (about
    ``n*(r-1)/2`` in expectation over uniform batch sizes).  Every extra
    rung costs one more static shape per (op, cf) and a call whose fixed
    overhead the profiler measures (``Profiler.dispatch_overhead``).  Let
    ``b = overhead / per_frame`` be the *breakeven batch*: the frame count
    whose compute equals one call's overhead.  A rung at size ``s`` earns
    its keep only if the padding it saves (~``s*(ratio-1)/2`` frames per
    call) outweighs that fixed cost, so the step ratio leaving rung ``s`` is
    ``1 + 2*b/s`` -- coarse where dispatch dominates (small rungs, or
    expensive dispatch), fine where per-frame compute does.  Clamped to
    [1.5, 4] so the ladder never degenerates, values snapped to multiples
    of 8 to match frame-batch alignment, and capped at ``max_rungs``
    entries.

    Deterministic in its inputs; callers thread the result through
    ``run_query(batch_shapes=)``.
    """
    if per_frame_s <= 0:
        raise ValueError(f"per_frame_s must be > 0, got {per_frame_s}")
    if not 0 < min_shape <= max_shape:
        raise ValueError(f"bad shape bounds [{min_shape}, {max_shape}]")
    b = max(0.0, dispatch_overhead_s) / per_frame_s
    shapes = [min_shape]
    while shapes[-1] < max_shape and len(shapes) < max_rungs:
        s = shapes[-1]
        ratio = min(4.0, max(1.5, 1.0 + 2.0 * b / s))
        nxt = min(max_shape, max(s + 8, int(round(s * ratio / 8.0)) * 8))
        shapes.append(nxt)
    if shapes[-1] != max_shape:
        shapes[-1] = max_shape  # rung cap hit: top rung must cover max
    return tuple(shapes)


@dataclasses.dataclass
class ConsumeStats:
    """Accounting for one ``consume`` call (accumulated into StageStats)."""
    detect_calls: int = 0
    frames: int = 0          # real activated frames consumed
    batched_frames: int = 0  # rows fed to the operator, padding included


class BatchedConsumer:
    """Fuses many segments' activated frames into few operator calls.

    One instance per executor run; it is stateless between ``consume``
    calls.
    """

    def __init__(self, spec: IngestSpec,
                 shapes: tuple[int, ...] = DEFAULT_BATCH_SHAPES):
        self.spec = spec
        self.shapes = tuple(sorted(shapes))
        bsz = max(1, spec.fps // 2)  # _bucket granularity in position ticks
        need = spec.frames_per_segment + _MIN_SLOT_GAP
        self._stride = -(-need // bsz) * bsz  # bucket-aligned slot stride
        self._spb = self._stride // bsz       # buckets per slot

    def _pad_to(self, n: int) -> int:
        for s in self.shapes:
            if s >= n:
                return s
        return n  # beyond the largest static shape: exact (compiles once)

    def consume(self, op: Operator, cf, batch: list[tuple]
                ) -> tuple[dict[int, set], ConsumeStats]:
        """Run ``op`` once per shape bucket over ``batch`` and scatter.

        ``batch`` is ``[(seg, frames_u8, positions), ...]`` with unique
        segments, each ``positions`` sorted ascending (the activated subset
        of the CF's consumed positions).  Returns ``({seg: items}, stats)``
        where every listed segment has an entry (possibly empty) — exactly
        the segments a per-segment loop would have called ``detect`` for.
        """
        batch = sorted(batch, key=lambda t: t[0])
        per_entry, stats = self.consume_entries(
            op, cf, [(f, p) for _seg, f, p in batch])
        per_seg = {seg: items
                   for (seg, f, _p), items in zip(batch, per_entry)
                   if len(f)}
        return per_seg, stats

    def consume_entries(self, op: Operator, cf, entries: list[tuple]
                        ) -> tuple[list[set], ConsumeStats]:
        """The slot-granular core of ``consume``: entries key on their list
        index, not a segment id, so the *same* segment may appear more than
        once (two queries' different activated subsets of one segment — the
        shared cross-query scheduler's case).  ``entries`` is
        ``[(frames_u8, positions), ...]``; returns a per-entry list of item
        sets in the entry's own (local) position coordinates.

        Bit-exactness carries over unchanged from the module invariants:
        every entry gets its own slot, slot offsets ascend with entry
        order, and consecutive slots keep the ``_MIN_SLOT_GAP`` positional
        gap — a ``Diff`` pair spanning two entries (even two copies of the
        same segment) can never reach threshold."""
        per_entry: list[set] = [set() for _ in entries]
        stats = ConsumeStats()
        todo = [(i, f, p) for i, (f, p) in enumerate(entries) if len(f)]
        if not todo:
            return per_entry, stats

        # Pack whole entries into chunks of at most the largest static
        # shape — a chunk boundary inside an entry would drop that
        # entry's Diff pairs straddling it.
        max_shape = self.shapes[-1]
        chunks: list[list[tuple[int, int, np.ndarray, np.ndarray]]] = []
        cur: list[tuple[int, int, np.ndarray, np.ndarray]] = []
        cur_n = 0
        for slot, (idx, frames, pos) in enumerate(todo):
            if cur and cur_n + len(frames) > max_shape:
                chunks.append(cur)
                cur, cur_n = [], 0
            cur.append((slot, idx, frames, pos))
            cur_n += len(frames)
        chunks.append(cur)

        sentinel = len(todo) * self._stride  # pad slot past every entry
        slot_idx = [idx for idx, _, _ in todo]
        for chunk in chunks:
            x = torch.cat([torch.as_tensor(f) for _, _, f, _ in chunk])
            p = np.concatenate([np.asarray(pos, np.int64) + slot * self._stride
                                for slot, _, _, pos in chunk])
            n = len(x)
            target = self._pad_to(n)
            if target > n:
                x = torch.cat(
                    [x, x.new_zeros((target - n,) + tuple(x.shape[1:]))])
                p = np.concatenate(
                    [p, sentinel + np.arange(target - n, dtype=np.int64)])
            with _span("detect", op=type(op).__name__.lower(), cf=cf.name(),
                       frames=n, shape=target, segments=len(chunk)):
                items = op.detect(x, cf, self.spec, positions=p)
            stats.detect_calls += 1
            stats.frames += n
            stats.batched_frames += target
            for it in items:
                slot, local = divmod(int(it[1]), self._spb)
                if slot >= len(slot_idx):
                    continue  # produced by a padding frame
                per_entry[slot_idx[slot]].add((it[0], local) + tuple(it[2:]))
        return per_entry, stats
