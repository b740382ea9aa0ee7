"""Port of ``repro/analytics/query.py``: cascade query execution over the
video store.  Frames stay on the store's device; the activated subset of
each segment is selected there, and only items and costs return.

Cascade query execution over the video store.

A query is a cascade of ⟨operator, accuracy⟩ stages (paper Fig. 2): early
stages scan most of the queried timespan cheaply and *activate* later stages
only on the time buckets they flag.  Each stage consumes frames in its
consumption format, retrieved from the storage format its CF subscribes to.

Speed accounting follows the paper's model (§2.2): a stage streams data from
disk through the decoder to the operator, so its effective speed is the lower
of retrieval speed and consumption speed; we time both paths per stage and
report ``duration / max(retrieve_time, consume_time)`` (perfect pipelining)
as well as the strictly-sequential speed.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..core.knobs import FidelityOption, IngestSpec
from .batch import DEFAULT_BATCH_SHAPES, BatchedConsumer
from .operators import OPERATORS, _bucket, _positions

QUERY_A = ("diff", "snn", "nn")            # car detection
QUERY_B = ("motion", "license", "ocr")     # license-plate recognition
QUERIES = {"A": QUERY_A, "B": QUERY_B}


@dataclasses.dataclass
class StageStats:
    op: str
    cf: FidelityOption
    sf_id: str
    retrieve_s: float = 0.0
    consume_s: float = 0.0
    frames: int = 0
    items: int = 0
    segments_scanned: int = 0
    detect_calls: int = 0    # op.detect invocations (batching merges them)
    batched_frames: int = 0  # rows fed via the batched path, padding incl.

    def to_wire(self) -> dict:
        """Plain-scalar form (msgpack/json-safe) for cross-process serving."""
        d = dataclasses.asdict(self)
        d["cf"] = [self.cf.quality, self.cf.crop, self.cf.resolution,
                   self.cf.sampling]
        return d

    @staticmethod
    def from_wire(d: dict) -> "StageStats":
        d = dict(d)
        q, crop, res, samp = d["cf"]
        d["cf"] = FidelityOption(q, crop, res, samp)
        return StageStats(**d)


def _wire_scalar(x):
    """Numpy scalars -> plain Python so item tuples survive msgpack."""
    if isinstance(x, np.integer):
        return int(x)
    if isinstance(x, np.floating):
        return float(x)
    return x


@dataclasses.dataclass
class QueryCost:
    """Per-query resource attribution: what *this* query cost the system.

    The serving stack already tracks every one of these globally (planner
    decode counters, cache stats, scheduler leader shares); this ledger
    attributes them to the query that incurred them.  Fused-batch detect
    accounting follows the leader-share convention — a dispatch is
    charged to the batch's leading unit's query — so summing the ledgers
    across a server's queries equals the true fused cost (per-query values
    are exact only in aggregate, like ``StageStats``).  Wall-clock fields:
    ``queue_wait_s`` is admission-to-start wait under the server,
    ``sched_wait_s`` is time blocked on shared-scheduler futures; deadline
    fields are filled when the query ran under a ``deadline_ms`` SLO."""
    decode_bytes: int = 0        # compressed bytes read off the store
    decode_chunks: int = 0
    decoded_frames: int = 0      # frames retrieval delivered
    detect_frames: int = 0       # operator rows consumed (leader share)
    detect_calls: int = 0        # fused op.detect dispatches (leader share)
    cache_hits: int = 0          # decoded-segment cache: exact hits
    cache_richer_hits: int = 0   # served bit-exactly from a richer CF
    cache_inflight_hits: int = 0  # joined another query's in-flight decode
    cache_misses: int = 0        # real decodes this query triggered
    queue_wait_s: float = 0.0
    sched_wait_s: float = 0.0
    deadline_ms: float = 0.0     # 0 = ran without a deadline
    deadline_slack_s: float = 0.0
    deadline_met: bool = True

    def to_wire(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_wire(d: dict) -> "QueryCost":
        return QueryCost(**d)


@dataclasses.dataclass
class QueryResult:
    items: set
    stages: list[StageStats]
    video_seconds: float
    wall_s: float = 0.0  # measured end-to-end wall time of the execution
    # predicate pushdown (repro.index): segments the semantic index pruned
    # before retrieval — never read, never decoded.  ``pruned_conservative``
    # counts the subset pruned across a knob mismatch (conservative mode:
    # bounded recall loss); exact-match prunes never change items.
    pruned_segments: int = 0
    pruned_bytes: int = 0
    pruned_conservative: int = 0
    # per-query resource attribution (telemetry): filled by the executors,
    # deadline fields by the serving layer, rolled up by the router
    cost: QueryCost = dataclasses.field(default_factory=QueryCost)

    def to_wire(self) -> dict:
        """Plain-scalar form of the result (item tuples become lists; a
        shard worker ships this over the cluster wire protocol)."""
        return {
            "items": [[_wire_scalar(x) for x in it] for it in self.items],
            "stages": [s.to_wire() for s in self.stages],
            "video_seconds": float(self.video_seconds),
            "wall_s": float(self.wall_s),
            "pruned_segments": int(self.pruned_segments),
            "pruned_bytes": int(self.pruned_bytes),
            "pruned_conservative": int(self.pruned_conservative),
            "cost": self.cost.to_wire(),
        }

    @staticmethod
    def from_wire(d: dict) -> "QueryResult":
        return QueryResult(
            items={tuple(it) for it in d["items"]},
            stages=[StageStats.from_wire(s) for s in d["stages"]],
            video_seconds=d["video_seconds"], wall_s=d["wall_s"],
            pruned_segments=d.get("pruned_segments", 0),
            pruned_bytes=d.get("pruned_bytes", 0),
            pruned_conservative=d.get("pruned_conservative", 0),
            cost=(QueryCost.from_wire(d["cost"]) if d.get("cost")
                  else QueryCost()))

    @property
    def pipelined_speed(self) -> float:
        """x realtime with retrieval/consumption overlapped per stage."""
        t = sum(max(s.retrieve_s, s.consume_s) for s in self.stages)
        return self.video_seconds / max(t, 1e-9)

    @property
    def sequential_speed(self) -> float:
        t = sum(s.retrieve_s + s.consume_s for s in self.stages)
        return self.video_seconds / max(t, 1e-9)

    @property
    def measured_speed(self) -> float:
        """x realtime from the measured wall clock (the honest number; the
        two estimates above model perfect/no pipelining from stage timings)."""
        return self.video_seconds / max(self.wall_s, 1e-9)


def stage_specs(config, query: str, accuracy: float):
    """The cascade's resolved stages: [(op_name, operator, cf, sf_id)].

    Shared by the sequential path below and the pipelined executor
    (repro.serving.executor) so both run the identical cascade."""
    out = []
    for op_name in QUERIES[query]:
        cf = config.consumption_format(op_name, accuracy)
        out.append((op_name, OPERATORS[op_name], cf, config.subscription(cf)))
    return out


def apply_pushdown(store, index, stream: str, segments: list[int],
                   specs: list, accuracy: float, mode: str = "exact"):
    """Consult the semantic index (repro.index) before any retrieval:
    segments whose persisted cascade-head sketch shows zero activations
    at (or dominating) the query's knobs are dropped from the stage-0
    scan — no store read, no decode.  Returns ``(kept_segments,
    (pruned_segments, pruned_bytes, pruned_conservative))``.  Shared by
    ``run_query`` and the pipelined executor so both prune identically."""
    if index is None or mode == "off" or not segments:
        return segments, (0, 0, 0)
    op_name, _op, cf, sf_id = specs[0]
    if op_name not in getattr(index, "ops", ()):
        return segments, (0, 0, 0)
    dec = index.prune(stream, segments, op_name, cf, sf_id, accuracy,
                      mode=mode)
    if not dec.pruned:
        return segments, (0, 0, 0)
    nbytes = sum(store.segment_bytes(stream, s, sf_id) for s in dec.pruned)
    return dec.kept, (len(dec.pruned), nbytes, dec.conservative)


def _charge_fetch(cost: QueryCost, fcost: dict, n_frames: int,
                  n_fetches: int = 1) -> None:
    """Fold one retrieval's cost dict into a query ledger.  The cache
    kind tag (``"hit"``/``"richer"``/``"inflight"``/``"miss"``) comes from
    the serving planner's fetch; a raw store retrieve carries no tag and
    counts as misses — it decoded for real."""
    cost.decode_bytes += int(fcost.get("bytes", 0))
    cost.decode_chunks += int(fcost.get("chunks", 0))
    cost.decoded_frames += int(fcost.get("frames", n_frames))
    kind = fcost.get("cache")
    if kind == "hit":
        cost.cache_hits += n_fetches
    elif kind == "richer":
        cost.cache_richer_hits += n_fetches
    elif kind == "inflight":
        cost.cache_inflight_hits += n_fetches
    else:
        cost.cache_misses += n_fetches


def _active_frame_mask(frames_pos: np.ndarray, active_buckets: set | None,
                       spec: IngestSpec) -> np.ndarray:
    if active_buckets is None:
        return np.ones(len(frames_pos), bool)
    return np.array([_bucket(p, spec) in active_buckets for p in frames_pos],
                    dtype=bool)


def _select(frames: torch.Tensor, sel: np.ndarray) -> torch.Tensor:
    """The activated frames ``sel`` of one segment, on its device."""
    if len(sel) == len(frames):
        return frames
    return frames[torch.from_numpy(sel).to(frames.device)]


def run_query(store, config, query: str, stream: str, segments: list[int],
              accuracy: float, retriever=None,
              batch_segments: int = 0,
              batch_shapes: tuple[int, ...] | None = None,
              index=None, pushdown: str = "exact") -> QueryResult:
    """Execute a cascade at one target accuracy for every stage.

    ``config`` is a DerivedConfig (``core.configure``): maps consumer
    (op, accuracy) -> CF and CF -> storage format id.  ``retriever``
    substitutes the store's decode path — the serving layer passes its
    planner's cache-aware fetch here so all retrieval routes through the
    shared decoded-segment cache.

    ``batch_segments`` > 0 switches consumption to the cross-segment
    batched path (``analytics.batch``): up to that many segments'
    activated frames are fused into one ``op.detect`` call per static
    shape bucket, and retrieval goes through ``store.retrieve_many`` so
    ``want_indices``/``convert`` amortize across the group.  Item sets are
    bit-exact with the per-segment path; ``StageStats.detect_calls`` shows
    the dispatch saving.  ``batch_shapes`` overrides the consumer's static
    shape ladder.

    ``index`` enables predicate pushdown through a semantic index with the
    reference's ``prune`` interface (``repro.index``; the port's own index
    arrives with a later slice): sketched-inactive segments are pruned
    before the stage-0 scan (see ``apply_pushdown``).
    """
    if batch_segments < 0:
        raise ValueError(f"batch_segments must be >= 0, got {batch_segments}")
    spec = store.spec
    fetch = retriever or store.retrieve
    consumer = (BatchedConsumer(spec, shapes=batch_shapes or
                                DEFAULT_BATCH_SHAPES)
                if batch_segments else None)
    specs = stage_specs(config, query, accuracy)
    n_total = len(segments)  # video_seconds covers pruned segments too
    segments, (n_pruned, pruned_bytes, n_cons) = apply_pushdown(
        store, index, stream, segments, specs, accuracy, pushdown)
    stages: list[StageStats] = []
    active: dict[int, set] | None = None  # per segment active buckets
    items_all: set = set()
    cost = QueryCost()
    t_start = time.perf_counter()

    for op_name, op, cf, sf_id in specs:
        st = StageStats(op=op_name, cf=cf, sf_id=sf_id)
        stage_items: set = set()
        next_active: dict[int, set] = {}
        pos = _positions(cf, spec)

        if consumer is not None:
            segs = [s for s in segments
                    if active is None or active.get(s)]
            st.segments_scanned = len(segs)
            for g0 in range(0, len(segs), batch_segments):
                group = segs[g0:g0 + batch_segments]
                t0 = time.perf_counter()
                if retriever is None:
                    frames_list, gcost = store.retrieve_many(
                        stream, group, sf_id, cf)
                    _charge_fetch(cost, gcost,
                                  sum(len(f) for f in frames_list),
                                  n_fetches=len(group))
                else:
                    frames_list = []
                    for s in group:
                        frames, fcost = retriever(stream, s, sf_id, cf)
                        frames_list.append(frames)
                        _charge_fetch(cost, fcost, len(frames))
                st.retrieve_s += time.perf_counter() - t0
                pending = []
                for seg, frames in zip(group, frames_list):
                    mask = _active_frame_mask(pos, None if active is None
                                              else active.get(seg, set()),
                                              spec)
                    if not mask.any():
                        continue
                    sel = np.nonzero(mask)[0]
                    pending.append((seg, _select(frames, sel), pos[sel]))
                t0 = time.perf_counter()
                per_seg, cstats = consumer.consume(op, cf, pending)
                st.consume_s += time.perf_counter() - t0
                st.detect_calls += cstats.detect_calls
                st.frames += cstats.frames
                st.batched_frames += cstats.batched_frames
                cost.detect_calls += cstats.detect_calls
                cost.detect_frames += cstats.frames
                for seg, items in per_seg.items():
                    stage_items |= {(seg,) + it for it in items}
                    next_active[seg] = {it[1] for it in items}
        else:
            for seg in segments:
                if active is not None and not active.get(seg):
                    continue  # early stage filtered this segment entirely
                st.segments_scanned += 1
                t0 = time.perf_counter()
                frames, fcost = fetch(stream, seg, sf_id, cf)
                st.retrieve_s += time.perf_counter() - t0
                _charge_fetch(cost, fcost, len(frames))

                mask = _active_frame_mask(pos, None if active is None
                                          else active.get(seg, set()), spec)
                if not mask.any():
                    continue
                t0 = time.perf_counter()
                # operators are batch programs; feed only activated frames
                sel = np.nonzero(mask)[0]
                items = op.detect(_select(frames, sel), cf, spec,
                                  positions=pos[sel])
                st.consume_s += time.perf_counter() - t0
                st.detect_calls += 1
                st.frames += int(mask.sum())
                cost.detect_calls += 1
                cost.detect_frames += int(mask.sum())
                stage_items |= {(seg,) + it for it in items}
                next_active[seg] = {it[1] for it in items}

        st.items = len(stage_items)
        stages.append(st)
        active = next_active
        items_all = stage_items  # final stage's items are the answer

    dur = n_total * spec.segment_seconds
    return QueryResult(items=items_all, stages=stages, video_seconds=dur,
                       wall_s=time.perf_counter() - t_start,
                       pruned_segments=n_pruned, pruned_bytes=pruned_bytes,
                       pruned_conservative=n_cons, cost=cost)
