"""The configuration engine (backward derivation) of the port against the
JAX reference: from the same ``TableProfiler`` tables, made from a seed
with numpy, the port's boundary search, consumption formats, coalescing,
erosion plan, ``derive_config`` and ``derive_shapes`` give exactly the
reference's results; and the image-quality roundtrip (``apply_quality``)
and ``materialize`` give the reference's frames within one grey level."""

import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analytics.batch import derive_shapes as ref_derive_shapes
from repro.analytics.scene import generate_segment
from repro.codec import transform as RT
from repro.core import boundary as ref_boundary
from repro.core import configure as ref_configure
from repro.core import consumption as ref_consumption
from repro.core import erosion as ref_erosion
from repro.core import knobs as rk
from repro.core import profiler as ref_profiler

from repro_torch.analytics.batch import derive_shapes
from repro_torch.codec import transform as T
from repro_torch.core import boundary, configure, consumption
from repro_torch.core import erosion, knobs, profiler
from repro_torch.kernels.dct8 import ops as dct_ops

# the packages' ``core`` re-export the function ``coalesce`` over its module
ref_coalesce = importlib.import_module("repro.core.coalesce")
coalesce = importlib.import_module("repro_torch.core.coalesce")

SEEDS = range(6)
OPS = ("diff", "snn", "nn")
ACCS = (0.9, 0.8, 0.7)

_PORT_TYPES = {rk.FidelityOption: knobs.FidelityOption,
               rk.CodingOption: knobs.CodingOption,
               rk.StorageFormat: knobs.StorageFormat}


def to_port(x):
    """The reference's ``FidelityOption``, ``CodingOption`` or
    ``StorageFormat`` as the port's, field by field; tuples (table keys)
    element by element; anything else as it is."""
    if isinstance(x, tuple):
        return tuple(to_port(v) for v in x)
    cls = _PORT_TYPES.get(type(x))
    if cls is None:
        return x
    return cls(**{f.name: to_port(getattr(x, f.name))
                  for f in dataclasses.fields(x)})


def _port_table(table: dict) -> dict:
    return {to_port(k): v for k, v in table.items()}


# -- tables from a seed ---------------------------------------------------------

def _ladder(rng, n: int) -> np.ndarray:
    """n increasing values in (0, 1]: a random monotone knob ladder."""
    v = np.cumsum(rng.uniform(0.1, 1.0, n))
    return v / v[-1]


def _consumer_tables(seed: int, ops=OPS):
    """Random monotone accuracies over the whole fidelity space, and
    consumption speeds that fall with resolution, crop and sampling (not
    with quality, O2), rounded so that ties occur."""
    rng = np.random.default_rng(seed)
    acc, cost = {}, {}
    for op in ops:
        ladders = [_ladder(rng, n) for n in (len(rk.QUALITY_VALUES),
                                             len(rk.CROP_VALUES),
                                             len(rk.RESOLUTION_VALUES),
                                             len(rk.SAMPLING_VALUES))]
        w = rng.uniform(0.2, 1.0, 4)
        base = float(rng.uniform(50, 5000))
        for f in rk.fidelity_space():
            r = f.rank()
            a = sum(wi * lad[ri] for wi, lad, ri in zip(w, ladders, r))
            acc[(op, f)] = float(a / w.sum())
            px = (f.resolution / 720) ** 2 * f.crop ** 2 * f.sampling
            cost[(op, f)] = float(np.round(base / px, -1))
    return acc, cost


def _join_closure(cfs) -> set:
    fids = set(cfs)
    while True:
        more = {a.join(b) for a in fids for b in fids} - fids
        if not more:
            return fids
        fids |= more


def _storage_tables(plans, fast_decode=300.0):
    """Storage and retrieval tables shaped as ``tests/test_coalesce.py``'s
    ``_mk_profiler`` builds them, over every join of the plans' CFs."""
    storage, retrieve = {}, {}
    for f in _join_closure({p.cf for p in plans}):
        for c in rk.coding_space():
            rank = sum(f.rank()) + 1
            if c.bypass:
                size, enc = 4000.0 * rank, 0.1 * rank
            else:
                speed_i = rk.SPEED_VALUES.index(c.speed)
                size = 100.0 * rank * (1 + 0.15 * speed_i) * \
                    (1 + 10.0 / c.keyframe)
                enc = rank * (2.0 - 0.3 * speed_i)
            storage[(f, c)] = (enc, size)
            for p in plans:
                if c.bypass:
                    spd = fast_decode * 40 / max(p.cf.sampling, 1e-3)
                else:
                    spd = fast_decode / rank * (1 + 5.0 / c.keyframe) / \
                        max(p.cf.sampling, 0.05)
                retrieve[(f, c, p.cf)] = spd
    return storage, retrieve


def _both_profilers(acc, cost, storage=None, retrieve=None):
    ref = ref_profiler.TableProfiler(acc, cost, storage, retrieve)
    port = profiler.TableProfiler(_port_table(acc), _port_table(cost),
                                  _port_table(storage or {}),
                                  _port_table(retrieve or {}))
    return ref, port


def _plan_row(p) -> tuple:
    return (p.consumer.op, p.consumer.target, to_port(p.cf), p.accuracy,
            p.speed)


def _stats_row(stats) -> tuple:
    return (stats.consumption_runs, stats.storage_runs, stats.memo_hits,
            stats.wall_seconds)


def _random_plans(seed: int, n: int = 5):
    """n consumers on random CFs with random speeds, in both packages."""
    rng = np.random.default_rng(100 + seed)
    space = rk.fidelity_space()
    ref_plans, port_plans = [], []
    for i in range(n):
        f = space[int(rng.integers(len(space)))]
        speed = float(np.round(rng.uniform(5, 3000), 1))
        ref_plans.append(ref_consumption.ConsumerPlan(
            ref_consumption.Consumer(f"op{i}", 0.9), f, 0.92, speed))
        port_plans.append(consumption.ConsumerPlan(
            consumption.Consumer(f"op{i}", 0.9), to_port(f), 0.92, speed))
    return ref_plans, port_plans


def _node_row(n) -> tuple:
    return (to_port(n.fidelity), to_port(n.coding), n.golden,
            [(p.consumer.name(), to_port(p.cf)) for p in n.plans])


# -- exact parity ----------------------------------------------------------------

@pytest.mark.parametrize("seed", range(10))
def test_boundary_search_matches_reference(seed):
    """Random monotone grids (and a threshold that leaves rows empty): the
    same boundary points and the same number of probes."""
    rng = np.random.default_rng(seed)
    rows, cols = int(rng.integers(1, 8)), int(rng.integers(1, 12))
    grid = np.cumsum(np.cumsum(rng.uniform(0, 1, (rows, cols)), 0), 1)
    for thr in np.quantile(grid, [0.0, 0.3, 0.7, 1.0]) + [0.0, 0, 0, 1e-9]:
        def adequate(r, c, _thr=thr):
            return grid[r, c] >= _thr
        assert boundary.boundary_search(rows, cols, adequate) == \
            ref_boundary.boundary_search(rows, cols, adequate)


@pytest.mark.parametrize("seed", SEEDS)
def test_derive_all_matches_reference(seed):
    acc, cost = _consumer_tables(seed)
    ref_prof, port_prof = _both_profilers(acc, cost)
    ref_plans = ref_consumption.derive_all(
        ref_prof, [ref_consumption.Consumer(op, a) for op in OPS
                   for a in ACCS])
    plans = consumption.derive_all(
        port_prof, [consumption.Consumer(op, a) for op in OPS for a in ACCS])
    assert [_plan_row(p) for p in plans] == [_plan_row(p) for p in ref_plans]
    assert _stats_row(port_prof.stats) == _stats_row(ref_prof.stats)
    assert port_prof.stats.consumption_runs > 0


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("budget", [None, 0.6, 0.2])
def test_coalesce_matches_reference(seed, budget):
    """Nodes, codings, golden, the ``rounds`` log, costs and
    ``budget_met``, free and under an ingestion budget (a fraction of the
    free result's ingest cost, which drives phase 2's cheapening and
    forced merges)."""
    ref_plans, port_plans = _random_plans(seed)
    storage, retrieve = _storage_tables(ref_plans)
    ref_prof, port_prof = _both_profilers({}, {}, storage, retrieve)
    ingest_budget = None
    if budget is not None:
        ingest_budget = budget * ref_coalesce.coalesce(
            ref_profiler.TableProfiler({}, {}, storage, retrieve),
            ref_plans).ingest_cost
    want = ref_coalesce.coalesce(ref_prof, ref_plans,
                                 ingest_budget=ingest_budget)
    got = coalesce.coalesce(port_prof, port_plans,
                            ingest_budget=ingest_budget)
    assert [_node_row(n) for n in got.nodes] == \
        [_node_row(n) for n in want.nodes]
    assert got.rounds == want.rounds
    assert (got.ingest_cost, got.storage_cost, got.budget_met) == \
        (want.ingest_cost, want.storage_cost, want.budget_met)
    assert _stats_row(port_prof.stats) == _stats_row(ref_prof.stats)
    if budget is not None:  # phase 2 stepped, or found no step to take
        assert any(r["phase"] == 2 for r in got.rounds) or not got.budget_met
    for ref_p, p in zip(ref_plans, port_plans):
        ref_c = ref_coalesce.choose_coding(ref_prof, ref_p.cf, [ref_p], 2)
        c = coalesce.choose_coding(port_prof, p.cf, [p], 2)
        assert (c is None and ref_c is None) or c == to_port(ref_c)


def _erosion_setup(seed):
    ref_plans, port_plans = _random_plans(seed)
    storage, retrieve = _storage_tables(ref_plans)
    ref_prof, port_prof = _both_profilers({}, {}, storage, retrieve)
    # the N -> N formats (one SF per CF, and golden): a deeper tree than
    # coalescing leaves
    ref_nodes = ref_coalesce._unique_nodes(ref_plans, ref_prof) + \
        [ref_coalesce._golden_node(ref_plans)]
    nodes = coalesce._unique_nodes(port_plans, port_prof) + \
        [coalesce._golden_node(port_plans)]
    ref_subs = {p: i for i, n in enumerate(ref_nodes) for p in n.plans}
    subs = {p: i for i, n in enumerate(nodes) for p in n.plans}
    daily = [storage[(n.fidelity, n.coding)][1] * 86400.0 for n in ref_nodes]
    return (ref_prof, ref_nodes, ref_subs), (port_prof, nodes, subs), daily


@pytest.mark.parametrize("seed", SEEDS)
def test_plan_erosion_and_recovery_cost_match_reference(seed):
    """``k``, per-age fractions and speeds, bytes and ``feasible`` at
    budgets that fit flat, need a decay and cannot be met; and
    ``recovery_cost`` per node."""
    ref_args, port_args, daily = _erosion_setup(seed)
    assert len(port_args[1]) > 1
    assert erosion.recovery_cost(*port_args) == \
        ref_erosion.recovery_cost(*ref_args)
    full = sum(daily) * 10
    for frac in (1.0, 0.8, 0.5, 0.3, 0.01):
        want = ref_erosion.plan_erosion(*ref_args, daily, 10, frac * full)
        got = erosion.plan_erosion(*port_args, daily, 10, frac * full)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert (erosion.STEP, erosion.K_MAX) == (ref_erosion.STEP,
                                             ref_erosion.K_MAX)


@pytest.mark.parametrize("seed", SEEDS)
def test_derive_config_matches_reference(seed):
    """The whole derivation from the same tables: ``table()``,
    ``storage_formats()``, ``subscriptions_by_node()``, the ``rounds`` log
    and the erosion plan."""
    acc, cost = _consumer_tables(seed)
    ref_prof, _ = _both_profilers(acc, cost)
    plans = ref_consumption.derive_all(
        ref_prof, [ref_consumption.Consumer(op, a) for op in OPS
                   for a in ACCS])
    storage, retrieve = _storage_tables(plans)
    ref_prof, port_prof = _both_profilers(acc, cost, storage, retrieve)
    full = sum(storage[(f, c)][1] for f, c in storage) * 86400.0
    kwargs = dict(ops=OPS, accuracies=ACCS, storage_budget_bytes=0.05 * full)
    want = ref_configure.derive_config(ref_prof, **kwargs)
    got = configure.derive_config(port_prof, **kwargs)
    assert got.table() == want.table()
    assert {k: to_port(v) for k, v in want.storage_formats().items()} == \
        got.storage_formats()
    assert {k: [_plan_row(p) for p in v]
            for k, v in got.subscriptions_by_node().items()} == \
        {k: [_plan_row(p) for p in v]
         for k, v in want.subscriptions_by_node().items()}
    assert got.coalesce_log.rounds == want.coalesce_log.rounds
    assert dataclasses.astuple(got.erosion) == \
        dataclasses.astuple(want.erosion)
    assert got.dct_backend is None and want.dct_backend is None
    assert _stats_row(port_prof.stats) == _stats_row(ref_prof.stats)


@pytest.mark.parametrize("overhead", [0.0, 1e-5, 1e-4, 1e-3, 2e-2])
def test_derive_shapes_matches_reference(overhead):
    for per_frame in (1e-6, 3e-5, 1e-4, 2e-3):
        for kw in ({}, {"min_shape": 16, "max_shape": 512, "max_rungs": 4}):
            assert derive_shapes(overhead, per_frame, **kw) == \
                ref_derive_shapes(overhead, per_frame, **kw)
    with pytest.raises(ValueError):
        derive_shapes(overhead, 0.0)


# -- the image-quality roundtrip and materialize ----------------------------

def _u8_diff(got: torch.Tensor, want) -> tuple[int, int]:
    """(max |Δ|, count of differing pixels) of two uint8 stacks."""
    want = np.asarray(want)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    d = np.abs(got.numpy().astype(np.int16) - want.astype(np.int16))
    return int(d.max()), int((d > 0).sum())


@pytest.mark.parametrize("quality", rk.QUALITY_VALUES)
def test_apply_quality_matches_reference(quality):
    """Every quality value on scene frames: u8 within one grey level of the
    reference's jitted roundtrip (tolerance max |Δ| <= 1; the port sums its
    transforms in XLA:CPU's order, so 0 pixels differ)."""
    frames, _ = generate_segment("jackson", 1, rk.IngestSpec())
    qs = rk.QUALITY_QUANT_SCALE[quality]
    got = T.apply_quality(torch.from_numpy(frames), qs)
    max_d, n_diff = _u8_diff(got, RT.apply_quality(frames, qs))
    assert max_d <= 1, (max_d, n_diff)
    assert n_diff == 0, f"{n_diff} of {frames.size} pixels differ"


@pytest.mark.parametrize("knobs_", [("worst", 1.0, 720, 1 / 5),
                                    ("good", 1.0, 720, 2 / 3),
                                    ("worst", 0.5, 144, 1 / 5),
                                    ("bad", 0.75, 360, 1 / 2),
                                    ("good", 1.0, 540, 2 / 3),
                                    ("best", 0.75, 400, 1.0)])
def test_materialize_matches_reference(knobs_):
    """A few CFs on dashcam frames.  Where the CF needs no resize, the u8
    frames are within one grey level (0 pixels differ).  Where it resizes,
    the reference's resize weights depend on its compiler and K2's plain
    version rounds about 2 pixels in 10^4 one level apart
    (``test_torch_codec.py::test_fidelity_conversion_within_one_grey_level``);
    the quality roundtrip spreads such a pixel over its 8x8 block, so the
    frames may differ only inside blocks whose resized input differs, and
    the port's roundtrip on the reference's resized frames gives the
    reference's frames exactly.  The differing pixels are counted."""
    spec, port_spec = rk.IngestSpec(), knobs.IngestSpec()
    frames, _ = generate_segment("dashcam", 0, spec)
    cf = rk.FidelityOption(*knobs_)
    want = np.asarray(RT.materialize(frames, cf, spec))
    got = T.materialize(torch.from_numpy(frames), to_port(cf), port_spec)
    max_d, n_diff = _u8_diff(got, want)
    conv = np.array(RT.convert_fidelity(frames, rk.FidelityOption(), cf,
                                         spec))
    port_conv = T.convert_fidelity(torch.from_numpy(frames),
                                   knobs.FidelityOption(), to_port(cf),
                                   port_spec).numpy()
    if spec.resolve(cf)[1:] == spec.resolve(rk.FidelityOption())[1:]:
        assert max_d <= 1 and n_diff == 0, (max_d, n_diff)
        return
    n, h, w = want.shape
    def blocks(x):
        return x.reshape(n, h // 8, 8, w // 8, 8).any(axis=(2, 4))
    assert not (blocks(got.numpy() != want) & ~blocks(port_conv != conv)).any(), \
        f"{n_diff} pixels differ (max {max_d}) outside the resize's blocks"
    assert np.array_equal(
        T.apply_quality(torch.from_numpy(conv), cf.quant_scale).numpy(), want)


def test_materialize_keeps_frames_on_their_device():
    spec = knobs.IngestSpec()
    frames = torch.from_numpy(generate_segment("jackson", 0, spec)[0])
    out = T.materialize(frames, knobs.FidelityOption("bad", 1.0, 360, 1 / 2),
                        spec)
    assert out.device == frames.device and out.dtype == torch.uint8
    assert tuple(out.shape) == spec.resolve(
        knobs.FidelityOption("bad", 1.0, 360, 1 / 2))


def test_dct_quantize_refuses_other_devices():
    """The standalone K3's dispatch: plain version on a CPU tensor, a
    ``ValueError`` on a device that is neither CUDA nor CPU."""
    x = torch.zeros((1, 16, 16), dtype=torch.float32)
    assert dct_ops.dct_quantize(x, 2.0).shape == (1, 2, 2, 8, 8)
    with pytest.raises(ValueError, match="no dct8 path"):
        dct_ops.dct_quantize(x.to("meta"), 2.0)


def test_core_exports_the_references_names():
    import repro.core as ref_core
    import repro_torch.core as core
    assert core.__all__ == ref_core.__all__
    assert all(hasattr(core, name) for name in core.__all__)
