"""Port foundation vs the JAX reference: scenes byte for byte, the
configuration across the wire, trace spans, and the port's import
hygiene (no ``jax``, no ``repro``)."""

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analytics import scene as ref_scene
from repro.cluster import wire as ref_wire
from repro.core.coalesce import SFNode as RefSFNode
from repro.core.configure import DerivedConfig as RefDerivedConfig
from repro.core.consumption import Consumer as RefConsumer
from repro.core.consumption import ConsumerPlan as RefConsumerPlan
from repro.core import knobs as ref_knobs

from repro_torch.analytics import scene
from repro_torch.cluster import wire
from repro_torch.core import knobs
from repro_torch.obs import trace

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), os.pardir))
PORT = os.path.join(ROOT, "src", "repro_torch")
STREAMS = ("jackson", "miami", "tucson", "dashcam", "park", "airport")


@pytest.mark.parametrize("stream", STREAMS)
def test_scene_bytes_and_truth_match_reference(stream):
    for seg in (0, 3):
        f_ref, t_ref = ref_scene.generate_segment(stream, seg)
        f, t = scene.generate_segment(stream, seg)
        assert f.dtype == np.uint8 and f.tobytes() == f_ref.tobytes()
        assert dataclasses.asdict(t) == dataclasses.asdict(t_ref)
    assert np.array_equal(scene.digit_glyphs(), ref_scene.digit_glyphs())


def test_knob_spaces_match_reference():
    assert knobs.fidelity_space() == [
        knobs.FidelityOption(f.quality, f.crop, f.resolution, f.sampling)
        for f in ref_knobs.fidelity_space()]
    assert [c.name() for c in knobs.coding_space()] == \
        [c.name() for c in ref_knobs.coding_space()]
    spec = knobs.IngestSpec(720, 1280, 30, 4)
    ref_spec = ref_knobs.IngestSpec(720, 1280, 30, 4)
    for f, rf in zip(knobs.fidelity_space(), ref_knobs.fidelity_space()):
        assert spec.resolve(f) == ref_spec.resolve(rf)


def _ref_config(backend):
    F = ref_knobs.FidelityOption
    cf_a, cf_b = F("good", 1.0, 270, 1 / 2), F("good", 0.75, 360, 1 / 5)
    cf_c = F("best", 1.0, 720, 2 / 3)
    plans = [RefConsumerPlan(RefConsumer("diff", 0.8), cf_a, 0.85, 3000.0),
             RefConsumerPlan(RefConsumer("snn", 0.8), cf_b, 0.86, 500.0),
             RefConsumerPlan(RefConsumer("nn", 0.8), cf_c, 0.82, 30.0),
             RefConsumerPlan(RefConsumer("nn", 0.9), cf_c, 0.93, 25.0)]
    fast = RefSFNode(cf_a.join(cf_b), ref_knobs.CodingOption("fast", 10),
                     plans[:2])
    golden = RefSFNode(F(), ref_knobs.GOLDEN_CODING, plans[2:], golden=True)
    return RefDerivedConfig(plans=plans, nodes=[fast, golden],
                            coalesce_log=None, dct_backend=backend,
                            index_ops=("diff",))


@pytest.mark.parametrize("backend,route", [("jnp", "cpu"),
                                           ("pallas", "cuda"), (None, None)])
def test_config_from_reference_wire(backend, route):
    ref = _ref_config(backend)
    w = ref_wire.config_to_wire(ref)
    cfg = wire.config_from_wire(w)
    assert cfg.dct_backend == route
    assert wire.config_to_wire(cfg) == w  # and back, unchanged
    for p in ref.plans:
        op, acc = p.consumer.op, p.consumer.target
        cf = cfg.consumption_format(op, acc)
        assert wire._fidelity_to_wire(cf) == ref_wire._fidelity_to_wire(
            ref.consumption_format(op, acc))
        assert cfg.subscription(cf) == ref.subscription(p.cf)
    assert {k: (v.name()) for k, v in cfg.storage_formats().items()} == \
        {k: (v.name()) for k, v in ref.storage_formats().items()}
    assert cfg.nodes[1].plans[0] is cfg.plans[2]  # shared references


def test_spec_wire_roundtrip():
    spec = knobs.IngestSpec(720, 1280, 30, 4)
    assert wire.spec_from_wire(ref_wire.spec_to_wire(
        ref_knobs.IngestSpec(720, 1280, 30, 4))) == spec
    assert wire.spec_to_wire(spec) == ref_wire.spec_to_wire(
        ref_knobs.IngestSpec(720, 1280, 30, 4))


def test_trace_spans_nest_and_noop_when_disabled():
    tr = trace.Tracer()
    assert tr.span("x") is trace._NOOP
    tr.enabled = True
    with tr.span("outer", a=1) as outer:
        with tr.span("inner") as inner:
            inner.set(bytes=7)
    spans = tr.drain()
    assert [s.name for s in spans] == ["inner", "outer"]
    assert spans[0].parent_id == outer.span_id
    assert spans[0].trace_id == spans[1].trace_id
    assert spans[0].attrs == {"bytes": 7}
    w = spans[1].to_wire()
    assert trace.Span.from_wire(w).to_wire() == w
    assert trace.span("y") is trace._NOOP  # module tracer stays disabled


def _imports(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _is_banned(mod):
    return mod.split(".")[0] in ("jax", "jaxlib", "repro")


def test_port_sources_import_neither_jax_nor_repro():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _dirs, names in os.walk(PORT):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    bad = [(os.path.relpath(p, ROOT), m) for p in files
           for m in _imports(p) if _is_banned(m)]
    assert not bad, bad


def test_port_import_pulls_in_neither_jax_nor_repro():
    """Importing every port module in a fresh interpreter loads no jax
    and no repro module, not even transitively."""
    mods = []
    for dirpath, _dirs, names in os.walk(PORT):
        for n in names:
            if n.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, n[:-3]),
                                      os.path.join(ROOT, "src"))
                mods.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    # the walk reaches every slice's modules, the serving path's included
    assert {"repro_torch.codec.segment", "repro_torch.configs",
            "repro_torch.kernels.mamba_scan.mamba_scan",
            "repro_torch.kernels.mamba_scan.ops",
            "repro_torch.kernels.attention.attention",
            "repro_torch.kernels.attention.ops",
            "repro_torch.models.attention",
            "repro_torch.models.serving", "repro_torch.models.convert",
            "repro_torch.train.train_step",
            "repro_torch.launch.serve"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {sorted(mods)!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
