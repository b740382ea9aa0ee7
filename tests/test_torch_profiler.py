"""The port's measured ``Profiler`` on the CPU against the JAX reference's:
the consumer set of ``tests/test_configure_e2e.py`` (Diff and Motion at
0.8) derived at ``IngestSpec()`` from 2 sample segments; every accuracy
the port profiled against the reference ``Profiler``'s on the same
fidelity, and the configuration requirements (R1-R3, golden, accuracy
targets, the boundary search's saving) on the port's own derivation."""

import inspect

import pytest

torch = pytest.importorskip("torch")

from repro.core import knobs as rk
from repro.core.profiler import Profiler as RefProfiler

from repro_torch.core import Profiler, derive_config
from repro_torch.core import profiler as port_profiler
from repro_torch.core.coalesce import choose_coding
from repro_torch.core.knobs import (CROP_VALUES, QUALITY_VALUES,
                                    RESOLUTION_VALUES, SAMPLING_VALUES,
                                    IngestSpec)

OPS = ("diff", "motion")
ACCS = (0.8,)


@pytest.fixture(scope="module")
def derived():
    # the CPU path's tensors are tiny: one thread runs them several times
    # faster than a pool that contends with the other test workers
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        prof = Profiler(IngestSpec(), n_segments=2, repeats=1, device="cpu")
        cfg = derive_config(prof, ops=OPS, accuracies=ACCS)
    finally:
        torch.set_num_threads(threads)
    return cfg, prof


def test_accuracies_match_reference_profiler(derived):
    """Every (op, f) the port profiled, against the reference ``Profiler``
    at the same fidelity.  Tolerance: F1 equal in at least 19 of 20 cells
    and within 0.1 in every cell -- a CF that resizes may meet a pixel that
    K2's plain version rounds one level from ``jax.image.resize``
    (``test_torch_config.py::test_materialize_matches_reference``).
    Measured: every cell equal."""
    _, prof = derived
    cells = list(prof.tables()[0].items())
    assert len(cells) == prof.stats.consumption_runs - 1  # + the dct probe
    ref = RefProfiler(rk.IngestSpec(), n_segments=2, repeats=1)
    deltas = []
    for (op, f), acc in cells:
        want = ref.accuracy(op, rk.FidelityOption(f.quality, f.crop,
                                                  f.resolution, f.sampling))
        deltas.append(abs(acc - want))
    n_diff = sum(d > 0 for d in deltas)
    assert n_diff <= len(cells) / 20 and max(deltas) <= 0.1, \
        f"{n_diff} of {len(cells)} cells differ, max |dF1| {max(deltas)}"


def test_r1_satisfiable_fidelity(derived):
    cfg, _ = derived
    for node in cfg.nodes:
        for p in node.plans:
            assert node.fidelity.richer_eq(p.cf)


def test_r2_adequate_retrieval(derived):
    """R2, or the engine's documented terminal fallback: RAW when no coding
    keeps up (``choose_coding`` returns None)."""
    cfg, prof = derived
    for node in cfg.nodes:
        for p in node.plans:
            if prof.retrieval_speed(node.sf, p.cf) > p.speed:
                continue
            assert node.sf.coding.bypass and \
                choose_coding(prof, node.fidelity, node.plans) is None


def test_r3_consumers_subscribed_once(derived):
    cfg, _ = derived
    subscribed = [p for n in cfg.nodes for p in n.plans]
    assert len(subscribed) == len(cfg.plans) == len(OPS) * len(ACCS)
    assert {id(p) for p in subscribed} == {id(p) for p in cfg.plans}
    for p in cfg.plans:
        assert cfg.subscription(p.cf) in cfg.storage_formats()


def test_golden_exists_and_dominates(derived):
    cfg, _ = derived
    golden = [n for n in cfg.nodes if n.golden]
    assert len(golden) == 1
    for p in cfg.plans:
        assert golden[0].fidelity.richer_eq(p.cf)


def test_accuracy_targets_met(derived):
    cfg, _ = derived
    for p in cfg.plans:
        assert p.accuracy >= p.consumer.target - 1e-9


def test_profiling_far_below_exhaustive(derived):
    _, prof = derived
    exhaustive = len(OPS) * len(QUALITY_VALUES) * len(CROP_VALUES) * \
        len(RESOLUTION_VALUES) * len(SAMPLING_VALUES)
    assert prof.stats.consumption_runs < exhaustive / 4
    assert prof.stats.memo_hits > 0


def test_cpu_profiler_measures_the_plain_route_only(derived):
    """A CPU profiler times the plain dct8 route, never CUDA
    (``cuda_s = inf``), so the configuration records the CPU route; the
    wall seconds split by activity stay within the total."""
    cfg, prof = derived
    cpu_s, cuda_s = prof.dct_dispatch_cost()
    assert 0 < cpu_s < float("inf") and cuda_s == float("inf")
    assert cfg.dct_backend == "cpu"
    s = prof.stats
    assert 0 < s.consumer_seconds + s.encode_seconds + s.retrieval_seconds \
        <= s.wall_seconds


def test_profiler_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Profiler()
    assert Profiler(device="cpu").device == torch.device("cpu")


def test_clock_synchronizes_a_cuda_device(monkeypatch):
    """Every timed region reads the clock through ``Profiler._clock``,
    which on a CUDA device waits for the queued work first."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: calls.append(device))
    prof = Profiler(device="cpu")
    prof._clock()
    assert calls == []
    prof.device = torch.device("cuda")
    prof._clock()
    assert calls == [torch.device("cuda")]
    assert inspect.getsource(port_profiler).count("perf_counter") == 1
