"""The slice as a whole: Query A and Query B run by the port on a store the
reference wrote (opened read-only) give the reference's items, stage stats
and decode counters; a store the port writes serves both packages alike;
and inside the port the batched and per-segment paths agree exactly."""

import pytest

torch = pytest.importorskip("torch")

from repro.analytics.query import run_query as ref_run_query
from repro.analytics.scene import generate_segment
from repro.cluster import wire as ref_wire
from repro.core.coalesce import SFNode as RefSFNode
from repro.core.configure import DerivedConfig as RefDerivedConfig
from repro.core.consumption import Consumer as RefConsumer
from repro.core.consumption import ConsumerPlan as RefConsumerPlan
from repro.core import knobs as rk
from repro.videostore import VideoStore as RefVideoStore

from repro_torch.analytics.query import QueryResult, run_query
from repro_torch.cluster import wire
from repro_torch.videostore.video_store import VideoStore

STREAMS = {"A": "jackson", "B": "dashcam"}
SEGS = [0, 1, 2]


def _ref_config():
    """Two coded SFs for both queries at accuracy 0.8 (the shape of
    ``tests/test_query.py``'s manual config): the cheap stages read a
    fast-coded SF with keyframe 10, NN and OCR read golden."""
    F = rk.FidelityOption
    cfs = {"diff": F("good", 1.0, 270, 1 / 2), "snn": F("good", 1.0, 360, 1 / 2),
           "motion": F("good", 0.75, 360, 1 / 2),
           "license": F("best", 1.0, 540, 1 / 2),
           "nn": F("best", 1.0, 720, 2 / 3), "ocr": F("best", 1.0, 720, 1.0)}
    plans = {op: RefConsumerPlan(RefConsumer(op, 0.8), cf, 0.85, 100.0)
             for op, cf in cfs.items()}
    cheap = [plans[op] for op in ("diff", "snn", "motion", "license")]
    fid = cheap[0].cf
    for p in cheap[1:]:
        fid = fid.join(p.cf)
    fast = RefSFNode(fid, rk.CodingOption("fast", 10), cheap)
    golden = RefSFNode(F(), rk.GOLDEN_CODING, [plans["nn"], plans["ocr"]],
                       golden=True)
    return RefDerivedConfig(plans=list(plans.values()), nodes=[fast, golden],
                            coalesce_log=None, dct_backend="jnp")


@pytest.fixture(scope="module")
def ref_store(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ref_store"))
    cfg = _ref_config()
    vs = RefVideoStore(root, rk.IngestSpec())
    vs.set_formats(cfg.storage_formats())
    for stream in STREAMS.values():
        for seg in SEGS:
            vs.ingest_segment(stream, seg,
                              generate_segment(stream, seg, vs.spec)[0])
    vs.flush()
    return root, cfg


def _check_same(res: QueryResult, ref):
    assert res.items == ref.items
    assert len(res.stages) == len(ref.stages)
    for st, rst in zip(res.stages, ref.stages):
        assert (st.op, st.sf_id, st.frames, st.items, st.segments_scanned,
                st.detect_calls, st.batched_frames) == \
            (rst.op, rst.sf_id, rst.frames, rst.items, rst.segments_scanned,
             rst.detect_calls, rst.batched_frames)
    for key in ("decode_bytes", "decode_chunks", "decoded_frames",
                "detect_frames", "detect_calls", "cache_misses"):
        assert getattr(res.cost, key) == getattr(ref.cost, key), key
    assert res.video_seconds == ref.video_seconds


@pytest.mark.parametrize("batch", [0, 2])
@pytest.mark.parametrize("query", ["A", "B"])
def test_queries_on_reference_store_match_reference(ref_store, query, batch):
    root, ref_cfg = ref_store
    cfg = wire.config_from_wire(ref_wire.config_to_wire(ref_cfg))
    ref = ref_run_query(RefVideoStore(root, rk.IngestSpec(), readonly=True),
                        ref_cfg, query, STREAMS[query], SEGS, 0.8,
                        batch_segments=batch)
    vs = VideoStore(root, readonly=True, device="cpu")
    res = run_query(vs, cfg, query, STREAMS[query], SEGS, 0.8,
                    batch_segments=batch)
    _check_same(res, ref)
    assert all(st.frames > 0 for st in res.stages), res.stages
    assert QueryResult.from_wire(res.to_wire()).items == res.items


def test_port_written_store_serves_both_packages(ref_store, tmp_path):
    """The port ingests the same segments on the CPU and the reference
    reads the port's store to the same query results.  Golden blobs come
    out byte-identical to the reference's; a blob of a resized SF differs
    where the resize put a pixel within float noise of a rounding edge
    (2-3 pixels in 10^4 flip by one grey level)."""
    root, ref_cfg = ref_store
    cfg = wire.config_from_wire(ref_wire.config_to_wire(ref_cfg))
    vs = VideoStore(str(tmp_path), device="cpu")
    vs.set_formats(cfg.storage_formats())
    seg = 1
    for stream in STREAMS.values():
        vs.ingest_segment(stream, seg, generate_segment(stream, seg)[0])
    vs.flush()
    ref_vs = RefVideoStore(root, rk.IngestSpec(), readonly=True)
    n_same = n_blobs = 0
    for key in vs.backend.keys():
        n_blobs += 1
        n_same += vs.backend.get(key) == ref_vs.backend.get(key)
    print(f"{n_same} of {n_blobs} port blobs byte-identical to the reference's")
    cross = RefVideoStore(str(tmp_path), rk.IngestSpec(), readonly=True)
    for query, stream in STREAMS.items():
        ref = ref_run_query(cross, ref_cfg, query, stream, [seg], 0.8)
        res = run_query(vs, cfg, query, stream, [seg], 0.8)
        _check_same(res, ref)


@pytest.mark.parametrize("query", ["A", "B"])
def test_batched_equals_per_segment_in_port(ref_store, query):
    root, ref_cfg = ref_store
    cfg = wire.config_from_wire(ref_wire.config_to_wire(ref_cfg))
    vs = VideoStore(root, readonly=True, device="cpu")
    per_seg = run_query(vs, cfg, query, STREAMS[query], SEGS, 0.8)
    for batch in (1, 3):
        res = run_query(vs, cfg, query, STREAMS[query], SEGS, 0.8,
                        batch_segments=batch)
        assert res.items == per_seg.items
        assert [s.frames for s in res.stages] == \
            [s.frames for s in per_seg.stages]


def test_retrieve_many_equals_retrieve(ref_store):
    root, _ = ref_store
    vs = VideoStore(root, readonly=True, device="cpu")
    cf = vs.formats["sf1"].fidelity
    small = type(cf)("good", 1.0, 270, 1 / 5)
    for sf_id, f in (("sf1", small), ("sf_g", cf)):
        frames, cost = vs.retrieve_many("jackson", SEGS, sf_id, f)
        for seg, got in zip(SEGS, frames):
            one, _ = vs.retrieve("jackson", seg, sf_id, f)
            assert torch.equal(got, one)
        assert cost["frames"] == len(SEGS) * len(vs.want_indices(sf_id, f))


def test_readonly_store_refuses_writes(ref_store):
    root, _ = ref_store
    vs = VideoStore(root, readonly=True, device="cpu")
    with pytest.raises(RuntimeError):
        vs.set_formats({})
    with pytest.raises(RuntimeError):
        vs.backend.put("x", b"y")
    assert vs.available_segments("jackson", "sf_g") == SEGS
