"""Port of ``repro/core/configure.py``: the ``DerivedConfig`` data and its
lookup tables.

``derive_config`` (the backward derivation consumers -> CFs -> SFs ->
erosion plan) belongs to the configuration-engine slice and is not ported
yet; a port configuration is built by hand or rebuilt from the reference's
wire form (``repro_torch.cluster.wire.config_from_wire``).
"""

from __future__ import annotations

import dataclasses

from .coalesce import SFNode
from .consumption import ConsumerPlan
from .knobs import FidelityOption, StorageFormat

#: the port's codec dispatch routes, keyed by the reference's backend names:
#: the reference's Pallas kernels become the CUDA kernels (CUDA tensors),
#: its jnp oracle becomes the plain PyTorch path (CPU tensors)
DCT_ROUTES = {"pallas": "cuda", "jnp": "cpu"}


@dataclasses.dataclass
class DerivedConfig:
    plans: list[ConsumerPlan]
    nodes: list[SFNode]
    coalesce_log: object
    # the reference's ErosionPlan; erosion waits for a later slice
    erosion: object | None = None
    # codec dispatch route ("cuda" | "cpu", see DCT_ROUTES) the reference's
    # profiler chose; informational here: the port dispatches on the
    # device of the tensors it is given.  None means "not profiled".
    dct_backend: str | None = None
    # cascade-head ops to sketch at ingest; None disables indexing
    index_ops: tuple[str, ...] | None = None

    # -- derived lookup tables -------------------------------------------------
    def __post_init__(self):
        self._sf_ids: dict[int, str] = {}
        n = 1
        for i, node in enumerate(self.nodes):
            if node.golden:
                self._sf_ids[i] = "sf_g"
            else:
                self._sf_ids[i] = f"sf{n}"
                n += 1
        self._cf_to_node: dict[FidelityOption, int] = {}
        for i, node in enumerate(self.nodes):
            for p in node.plans:
                self._cf_to_node[p.cf] = i
        self._consumer_plan: dict[tuple[str, float], ConsumerPlan] = {
            (p.consumer.op, round(p.consumer.target, 4)): p for p in self.plans}

    # -- public API ---------------------------------------------------------
    def _plan_for(self, op: str, accuracy: float) -> ConsumerPlan:
        plan = self._consumer_plan.get((op, round(accuracy, 4)))
        if plan is None:
            ops = sorted({o for o, _ in self._consumer_plan})
            accs = sorted({a for _, a in self._consumer_plan}, reverse=True)
            raise KeyError(
                f"no consumer plan for op={op!r} at accuracy={accuracy}; "
                f"this configuration profiled ops {ops} "
                f"at accuracies {accs}")
        return plan

    def consumption_format(self, op: str, accuracy: float) -> FidelityOption:
        return self._plan_for(op, accuracy).cf

    def consumer_speed(self, op: str, accuracy: float) -> float:
        return self._plan_for(op, accuracy).speed

    def subscription(self, cf: FidelityOption) -> str:
        return self._sf_ids[self._cf_to_node[cf]]

    def storage_formats(self) -> dict[str, StorageFormat]:
        return {self._sf_ids[i]: n.sf for i, n in enumerate(self.nodes)}

    def node_id(self, idx: int) -> str:
        return self._sf_ids[idx]

    def subscriptions_by_node(self) -> dict[str, list[ConsumerPlan]]:
        return {self._sf_ids[i]: list(n.plans)
                for i, n in enumerate(self.nodes)}

    def table(self) -> str:
        """Human-readable Table-2-style snapshot."""
        lines = ["== consumption formats =="]
        for p in sorted(self.plans, key=lambda p: (p.consumer.op,
                                                   -p.consumer.target)):
            lines.append(
                f"  {p.consumer.name():14s} cf={p.cf.name():24s} "
                f"acc={p.accuracy:.2f} speed={p.speed:9.1f}x "
                f"-> {self.subscription(p.cf)}")
        lines.append("== storage formats ==")
        for i, n in enumerate(self.nodes):
            lines.append(f"  {self._sf_ids[i]:5s} {n.sf.name()}"
                         f"{'  [golden]' if n.golden else ''}")
        return "\n".join(lines)
