"""Port of ``repro/core/erosion.py``, verbatim: the planner is pure Python
over a profiler's retrieval speeds.

Age-based data erosion planning (paper §4.4).

Storage formats form a *richer-than* tree rooted at the golden format (never
eroded).  A consumer whose format lost a segment falls back to the nearest
ancestor that still holds it — accuracy is preserved (richer fidelity, R1)
but effective speed decays.  The planner:

  * computes each consumer's relative speed under per-format erosion
    fractions (generalized  α/((1-p)α+p)  across a fallback chain),
  * defines overall speed as the max-min-fair minimum across consumers,
  * sets per-age targets with the power law  P(x) = (1-Pmin)·x^(-k) + Pmin,
  * erodes, per age, whichever format least hurts the currently-slowest
    consumer until the age's target is reached (fair-scheduler style),
  * binary-searches the smallest decay factor k whose accumulated storage
    cost over the lifespan fits the storage budget.
"""

from __future__ import annotations

import dataclasses

from .coalesce import SFNode
from .consumption import ConsumerPlan

STEP = 0.05  # erosion-fraction quantum
K_MAX = 8.0


@dataclasses.dataclass
class ErosionPlan:
    k: float
    ages: list[int]
    fractions: list[dict[int, float]]   # per age: node index -> eroded frac
    overall_speed: list[float]          # per age
    daily_bytes: list[float]            # per age, after erosion
    total_bytes: float
    feasible: bool


class _Chains:
    """Fallback chains + speed math shared by planning and evaluation."""

    def __init__(self, profiler, nodes: list[SFNode],
                 subscriptions: dict[ConsumerPlan, int]):
        self.nodes = nodes
        self.golden_idx = next(i for i, n in enumerate(nodes) if n.golden)
        self.parent = self._build_tree()
        # consumer -> (chain of node indices, speeds along chain)
        self.chains: list[tuple[ConsumerPlan, list[int], list[float]]] = []
        for plan, idx in subscriptions.items():
            chain = [idx]
            while chain[-1] != self.golden_idx:
                chain.append(self.parent[chain[-1]])
            speeds = []
            for ni in chain:
                ret = profiler.retrieval_speed(self.nodes[ni].sf, plan.cf)
                speeds.append(min(ret, plan.speed))
            self.chains.append((plan, chain, speeds))

    def _build_tree(self) -> dict[int, int]:
        parent = {}
        for i, n in enumerate(self.nodes):
            if n.golden:
                continue
            cands = [j for j, m in enumerate(self.nodes)
                     if j != i and m.fidelity.richer_eq(n.fidelity)]
            # nearest ancestor: minimal fidelity among richer candidates
            def _key(j):
                return (sum(self.nodes[j].fidelity.rank()), j)
            parent[i] = min(cands, key=_key)
        return parent

    def relative_speed(self, plan_i: int, e: dict[int, float]) -> float:
        _, chain, speeds = self.chains[plan_i]
        t, survive = 0.0, 1.0
        for ni, v in zip(chain, speeds):
            frac_here = survive * (1.0 - e.get(ni, 0.0))
            t += frac_here / max(v, 1e-12)
            survive *= e.get(ni, 0.0)
        v0 = speeds[0]
        return 1.0 / max(v0 * t, 1e-12)

    def overall(self, e: dict[int, float]) -> float:
        if not self.chains:
            return 1.0
        return min(self.relative_speed(i, e) for i in range(len(self.chains)))

    def p_min(self) -> float:
        e_full = {i: 1.0 for i, n in enumerate(self.nodes) if not n.golden}
        return self.overall(e_full)


def recovery_cost(profiler, nodes: list[SFNode],
                  subscriptions: dict[ConsumerPlan, int]) -> dict[int, float]:
    """Per-node fleet slowdown if that node is entirely absent and every
    read is served over its fallback chain: ``1 - overall({i: 1.0})``.

    This is the same chain math the erosion planner optimizes with, reused
    by the ingest scheduler to rank transcode work: a format whose absence
    barely slows the fleet is cheap to recover (its ancestor serves reads
    nearly as fast), so under transcode-budget pressure it is shed first.
    Golden is never shed and scores +inf."""
    chains = _Chains(profiler, nodes, subscriptions)
    out: dict[int, float] = {}
    for i, n in enumerate(nodes):
        if n.golden:
            out[i] = float("inf")
        else:
            out[i] = max(0.0, 1.0 - chains.overall({i: 1.0}))
    return out


def _erode_to_target(chains: _Chains, e: dict[int, float], target: float
                     ) -> dict[int, float]:
    """Fair-scheduler erosion: repeatedly erode the format that least hurts
    the currently slowest consumer, until overall speed <= target."""
    e = dict(e)
    while chains.overall(e) > target + 1e-9:
        cands = [i for i, n in enumerate(chains.nodes)
                 if not n.golden and e.get(i, 0.0) < 1.0 - 1e-9]
        if not cands:
            break
        q = min(range(len(chains.chains)),
                key=lambda i: chains.relative_speed(i, e))
        best = None
        for f in cands:
            e2 = dict(e)
            e2[f] = min(1.0, e2.get(f, 0.0) + STEP)
            hurt_q = chains.relative_speed(q, e) - chains.relative_speed(q, e2)
            freed = 1.0  # tie-break below uses storage weight
            key = (hurt_q, -freed)
            if best is None or key < best[0]:
                best = (key, f, e2)
        e = best[2]
    return e


def plan_erosion(profiler, nodes: list[SFNode],
                 subscriptions: dict[ConsumerPlan, int],
                 daily_bytes_per_node: list[float],
                 lifespan_days: int,
                 storage_budget_bytes: float) -> ErosionPlan:
    chains = _Chains(profiler, nodes, subscriptions)
    p_min = chains.p_min()
    ages = list(range(1, lifespan_days + 1))

    def build(k: float) -> ErosionPlan:
        e: dict[int, float] = {}
        fractions, speeds, daily = [], [], []
        for x in ages:
            target = (1.0 - p_min) * (x ** -k) + p_min if k > 0 else 1.0
            e = _erode_to_target(chains, e, target)
            fractions.append(dict(e))
            speeds.append(chains.overall(e))
            daily.append(sum(b * (1.0 - e.get(i, 0.0))
                             for i, b in enumerate(daily_bytes_per_node)))
        total = sum(daily)
        return ErosionPlan(k=k, ages=ages, fractions=fractions,
                           overall_speed=speeds, daily_bytes=daily,
                           total_bytes=total,
                           feasible=total <= storage_budget_bytes)

    flat = build(0.0)
    if flat.feasible:
        return flat

    lo, hi = 0.0, K_MAX
    best = build(K_MAX)
    if not best.feasible:
        return best  # even max decay cannot fit the budget
    for _ in range(24):
        mid = (lo + hi) / 2
        plan = build(mid)
        if plan.feasible:
            best, hi = plan, mid
        else:
            lo = mid
    return best
