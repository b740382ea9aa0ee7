"""Port of ``repro/core/configure.py``: backward derivation of the global
video-format configuration (paper §4).

    consumers --(§4.2)--> consumption formats
              --(§4.3)--> storage formats (+ ingestion budget)
              --(§4.4)--> data erosion plan (+ storage budget)

`derive_config` runs the three steps and returns a `DerivedConfig` that the
video store installs and query execution reads.  A configuration can also
be rebuilt from the reference's wire form
(``repro_torch.cluster.wire.config_from_wire``).
"""

from __future__ import annotations

import dataclasses

from .coalesce import CoalesceResult, SFNode, coalesce
from .consumption import Consumer, ConsumerPlan, derive_all
from .erosion import ErosionPlan, plan_erosion
from .knobs import FidelityOption, StorageFormat

DEFAULT_ACCURACIES = (0.95, 0.90, 0.80, 0.70)
DEFAULT_OPS = ("diff", "snn", "nn", "motion", "license", "ocr")

#: the port's codec dispatch routes, keyed by the reference's backend names:
#: the reference's Pallas kernels become the CUDA kernels (CUDA tensors),
#: its jnp oracle becomes the plain PyTorch path (CPU tensors)
DCT_ROUTES = {"pallas": "cuda", "jnp": "cpu"}


@dataclasses.dataclass
class DerivedConfig:
    plans: list[ConsumerPlan]
    nodes: list[SFNode]
    coalesce_log: CoalesceResult | None
    erosion: ErosionPlan | None = None
    # codec dispatch route ("cuda" | "cpu", see DCT_ROUTES) chosen from the
    # profiler's measured dispatch cost (derive_config) or carried over the
    # wire; informational: the port dispatches on the device of the tensors
    # it is given.  None means "not profiled".
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


def derive_config(profiler,
                  ops: tuple[str, ...] = DEFAULT_OPS,
                  accuracies: tuple[float, ...] = DEFAULT_ACCURACIES,
                  ingest_budget: float | None = None,
                  storage_budget_bytes: float | None = None,
                  lifespan_days: int = 10,
                  daily_video_seconds: float = 86400.0) -> DerivedConfig:
    """Run the full backward derivation."""
    consumers = [Consumer(op, a) for op in ops for a in accuracies]

    # 1. consumption formats (optimize consumption speed)
    plans = derive_all(profiler, consumers)

    # 2. storage formats (optimize storage, respect ingestion budget)
    result = coalesce(profiler, plans, ingest_budget=ingest_budget)
    cfg = DerivedConfig(plans=plans, nodes=result.nodes, coalesce_log=result)

    # 2b. codec route: the faster of the plain route and K1 by the
    # profiler's *measured* dct8 dispatch cost, recorded only -- the port
    # dispatches on tensor devices, so no codec-wide switch is installed.
    # Table-backed profilers (tests) have no wall clock and skip this.
    if hasattr(profiler, "dct_dispatch_cost"):
        cpu_s, cuda_s = profiler.dct_dispatch_cost()
        cfg.dct_backend = DCT_ROUTES["pallas" if cuda_s < cpu_s else "jnp"]

    # 3. erosion plan (respect storage budget)
    if storage_budget_bytes is not None:
        subs = {}
        for i, node in enumerate(result.nodes):
            for p in node.plans:
                subs[p] = i
        daily = []
        for node in result.nodes:
            _, bytes_per_sec = profiler.storage_profile(node.sf)
            daily.append(bytes_per_sec * daily_video_seconds)
        cfg.erosion = plan_erosion(
            profiler, result.nodes, subs, daily, lifespan_days,
            storage_budget_bytes)
    return cfg
