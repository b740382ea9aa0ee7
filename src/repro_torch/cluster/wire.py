"""Port of ``repro/cluster/wire.py``: the wire forms of the ``IngestSpec``
and of a ``DerivedConfig``.

The dicts are the reference's own, so a configuration serialized by
``repro.cluster.wire.config_to_wire`` rebuilds here (and the other way
round).  The reference's codec backend names (``"jnp"``/``"pallas"``)
cross the wire unchanged and map onto the port's dispatch routes
(``core.configure.DCT_ROUTES``) on arrival.  Framing, the erosion plan and
the other forms belong to the cluster slice and are not ported yet.
"""

from __future__ import annotations

import dataclasses

from ..core.coalesce import SFNode
# analysis: allow[wire-field] DerivedConfig.erosion is deliberately not
# in the config frame: the reference ships the erosion plan separately,
# and erosion waits for a later slice of the port
from ..core.configure import DCT_ROUTES, DerivedConfig
from ..core.consumption import Consumer, ConsumerPlan
from ..core.knobs import CodingOption, FidelityOption, IngestSpec

_WIRE_BACKENDS = {route: name for name, route in DCT_ROUTES.items()}


# -- IngestSpec --------------------------------------------------------------

def spec_to_wire(spec: IngestSpec) -> dict:
    return dataclasses.asdict(spec)


def spec_from_wire(d: dict) -> IngestSpec:
    return IngestSpec(**d)


# -- DerivedConfig -----------------------------------------------------------

def _fidelity_to_wire(f: FidelityOption) -> list:
    return [f.quality, f.crop, f.resolution, f.sampling]


def _fidelity_from_wire(v) -> FidelityOption:
    q, crop, res, samp = v
    return FidelityOption(q, crop, res, samp)


def _coding_to_wire(c: CodingOption) -> list:
    return [c.speed, c.keyframe, c.bypass]


def _coding_from_wire(v) -> CodingOption:
    speed, keyframe, bypass = v
    return CodingOption(speed, keyframe, bypass)


@dataclasses.dataclass
class _WireCoalesceLog:
    """Minimal coalesce-log stand-in for a config rebuilt from the wire."""
    nodes: list
    ingest_cost: float = 0.0
    storage_cost: float = 0.0
    rounds: list = dataclasses.field(default_factory=list)
    budget_met: bool = True


def config_to_wire(config: DerivedConfig) -> dict:
    """Serialize the parts of a ``DerivedConfig`` query execution reads:
    consumer plans and SF nodes.  Plans are indexed so node membership
    round-trips as shared references."""
    plan_idx = {id(p): i for i, p in enumerate(config.plans)}
    return {
        "plans": [{
            "op": p.consumer.op, "target": p.consumer.target,
            "cf": _fidelity_to_wire(p.cf), "accuracy": p.accuracy,
            "speed": p.speed,
        } for p in config.plans],
        "nodes": [{
            "fidelity": _fidelity_to_wire(n.fidelity),
            "coding": _coding_to_wire(n.coding),
            "plans": [plan_idx[id(p)] for p in n.plans],
            "golden": n.golden,
        } for n in config.nodes],
        "dct_backend": _WIRE_BACKENDS.get(config.dct_backend),
        "index_ops": (list(config.index_ops)
                      if config.index_ops is not None else None),
    }


def config_from_wire(d: dict) -> DerivedConfig:
    plans = [ConsumerPlan(Consumer(p["op"], p["target"]),
                          _fidelity_from_wire(p["cf"]),
                          p["accuracy"], p["speed"]) for p in d["plans"]]
    nodes = [SFNode(_fidelity_from_wire(n["fidelity"]),
                    _coding_from_wire(n["coding"]),
                    [plans[i] for i in n["plans"]],
                    golden=n["golden"]) for n in d["nodes"]]
    index_ops = d.get("index_ops")
    backend = d.get("dct_backend")
    return DerivedConfig(plans=plans, nodes=nodes,
                         coalesce_log=_WireCoalesceLog(nodes=nodes),
                         dct_backend=(DCT_ROUTES[backend]
                                      if backend is not None else None),
                         index_ops=(tuple(index_ops)
                                    if index_ops is not None else None))
