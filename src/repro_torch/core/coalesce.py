"""Port of ``repro/core/coalesce.py``, verbatim: the search is pure Python
over a profiler's answers, and keeps the reference's iteration orders,
tie-breaks and ``rounds`` log.

Storage-format derivation by iterative pairwise coalescing (paper §4.3).

Start from one SF per unique CF (identical fidelity) plus the *golden* SF
(knob-wise max fidelity of all CFs, slowest coding).  Repeatedly coalesce
pairs: the coalesced fidelity is the knob-wise max (R1); its coding is the
cheapest-storage option whose retrieval speed still exceeds every downstream
consumer's consumption speed (R2), falling back to RAW.  Phase 1 merges pairs
that cut ingestion cost without increasing storage cost; if an ingestion
budget is exceeded, phase 2 first cheapens coding (faster speed steps, then
RAW) and then keeps coalescing at the expense of storage (paper Table 3).
"""

from __future__ import annotations

import dataclasses
import itertools

from .consumption import ConsumerPlan
from .knobs import (GOLDEN_CODING, KEYFRAME_VALUES, RAW, SPEED_VALUES,
                    CodingOption, FidelityOption, StorageFormat)


@dataclasses.dataclass
class SFNode:
    fidelity: FidelityOption
    coding: CodingOption
    plans: list[ConsumerPlan]          # downstream consumers
    golden: bool = False

    @property
    def sf(self) -> StorageFormat:
        return StorageFormat(self.fidelity, self.coding)

    def cfs(self) -> list[FidelityOption]:
        return sorted({p.cf for p in self.plans})


@dataclasses.dataclass
class CoalesceResult:
    nodes: list[SFNode]
    ingest_cost: float      # encode-seconds per video-second (all SFs)
    storage_cost: float     # bytes per video-second (all SFs)
    rounds: list[dict]      # log for benchmarks
    budget_met: bool = True


def _coding_candidates():
    """Coding options in (approximately) ascending storage cost: slower
    speed steps compress better; larger keyframe intervals store fewer intra
    frames.  RAW is the terminal fallback."""
    for speed in SPEED_VALUES:                       # slowest ... fastest
        for k in sorted(KEYFRAME_VALUES, reverse=True):
            yield CodingOption(speed, k)
    yield RAW


def choose_coding(profiler, fidelity: FidelityOption,
                  plans: list[ConsumerPlan],
                  min_speed_idx: int = 0) -> CodingOption | None:
    """Cheapest-storage coding whose retrieval speed exceeds every
    subscribed consumer's consumption speed.  ``min_speed_idx`` restricts to
    speed steps at least that cheap (used by budget adaptation)."""
    for coding in _coding_candidates():
        if not coding.bypass and SPEED_VALUES.index(coding.speed) < min_speed_idx:
            continue
        sf = StorageFormat(fidelity, coding)
        ok = all(profiler.retrieval_speed(sf, p.cf) > p.speed for p in plans)
        if ok:
            return coding
    return None


def _unique_nodes(plans: list[ConsumerPlan], profiler) -> list[SFNode]:
    by_cf: dict[FidelityOption, list[ConsumerPlan]] = {}
    for p in plans:
        by_cf.setdefault(p.cf, []).append(p)
    nodes = []
    for cf, ps in sorted(by_cf.items()):
        coding = choose_coding(profiler, cf, ps) or RAW
        nodes.append(SFNode(cf, coding, ps))
    return nodes


def _golden_node(plans: list[ConsumerPlan]) -> SFNode:
    fg = plans[0].cf
    for p in plans[1:]:
        fg = fg.join(p.cf)
    return SFNode(fg, GOLDEN_CODING, [], golden=True)


def _costs(profiler, nodes: list[SFNode]) -> tuple[float, float]:
    ing = sto = 0.0
    for n in nodes:
        i, s = profiler.storage_profile(n.sf)
        ing += i
        sto += s
    return ing, sto


def _merge(profiler, a: SFNode, b: SFNode, min_speed_idx: int = 0
           ) -> SFNode | None:
    fidelity = a.fidelity.join(b.fidelity)
    plans = a.plans + b.plans
    coding = (GOLDEN_CODING if (a.golden or b.golden) and not plans else
              choose_coding(profiler, fidelity, plans, min_speed_idx))
    if coding is None:
        return None
    if (a.golden or b.golden):
        # merging into golden keeps golden status; coding must still serve
        # the union's consumers (checked above)
        node = SFNode(fidelity, coding, plans, golden=True)
        if not plans:
            node.coding = GOLDEN_CODING
        return node
    return SFNode(fidelity, coding, plans)


def coalesce(profiler, plans: list[ConsumerPlan],
             ingest_budget: float | None = None,
             min_speed_idx: int = 0) -> CoalesceResult:
    nodes = _unique_nodes(plans, profiler) + [_golden_node(plans)]
    rounds: list[dict] = []

    # Phase 1: merge while some pair cuts ingest without growing storage.
    while True:
        ing0, sto0 = _costs(profiler, nodes)
        best = None
        for i, j in itertools.combinations(range(len(nodes)), 2):
            m = _merge(profiler, nodes[i], nodes[j], min_speed_idx)
            if m is None:
                continue
            mi, ms = profiler.storage_profile(m.sf)
            ai, as_ = profiler.storage_profile(nodes[i].sf)
            bi, bs = profiler.storage_profile(nodes[j].sf)
            d_ing, d_sto = mi - ai - bi, ms - as_ - bs
            if d_ing < 0 and d_sto <= 0:
                if best is None or (d_ing, d_sto) < (best[0], best[1]):
                    best = (d_ing, d_sto, i, j, m)
        if best is None:
            break
        _, _, i, j, m = best
        rounds.append({"phase": 1, "merged": (nodes[i].sf.name(),
                                              nodes[j].sf.name()),
                       "into": m.sf.name()})
        nodes = [n for k, n in enumerate(nodes) if k not in (i, j)] + [m]

    # Phase 2: respect the ingestion budget.
    budget_met = True
    if ingest_budget is not None:
        guard = 0
        while True:
            ing, sto = _costs(profiler, nodes)
            if ing <= ingest_budget:
                break
            guard += 1
            if guard > 200:
                budget_met = False
                break
            step = _cheapen_step(profiler, nodes) or \
                _forced_merge_step(profiler, nodes, min_speed_idx)
            if step is None:
                budget_met = False
                break
            kind, payload = step
            if kind == "cheapen":
                idx, coding = payload
                rounds.append({"phase": 2, "cheapen": nodes[idx].sf.name(),
                               "to": coding.name()})
                nodes[idx].coding = coding
            else:
                i, j, m = payload
                rounds.append({"phase": 2,
                               "merged": (nodes[i].sf.name(),
                                          nodes[j].sf.name()),
                               "into": m.sf.name()})
                nodes = [n for k, n in enumerate(nodes) if k not in (i, j)] + [m]

    ing, sto = _costs(profiler, nodes)
    return CoalesceResult(nodes=nodes, ingest_cost=ing, storage_cost=sto,
                          rounds=rounds, budget_met=budget_met)


def _cheapen_step(profiler, nodes):
    """Best single-SF coding cheapening: max ingest reduction, tie-break min
    storage increase.  Keeps R2 satisfied (verified per candidate)."""
    best = None
    for idx, n in enumerate(nodes):
        if n.coding.bypass:
            continue
        i0, s0 = profiler.storage_profile(n.sf)
        for coding in n.coding.cheaper_steps():
            sf2 = StorageFormat(n.fidelity, coding)
            if not all(profiler.retrieval_speed(sf2, p.cf) > p.speed
                       for p in n.plans):
                continue
            i1, s1 = profiler.storage_profile(sf2)
            d_ing, d_sto = i1 - i0, s1 - s0
            if d_ing < 0:
                key = (d_ing, d_sto)
                if best is None or key < best[0]:
                    best = (key, idx, coding)
            break  # only the next cheaper feasible step per node
    if best is None:
        return None
    _, idx, coding = best
    return "cheapen", (idx, coding)


def _forced_merge_step(profiler, nodes, min_speed_idx):
    """Coalesce the pair with the smallest storage growth that reduces
    ingestion cost (budget pressure: storage is traded for ingest)."""
    best = None
    for i, j in itertools.combinations(range(len(nodes)), 2):
        m = _merge(profiler, nodes[i], nodes[j], min_speed_idx)
        if m is None:
            continue
        mi, ms = profiler.storage_profile(m.sf)
        ai, as_ = profiler.storage_profile(nodes[i].sf)
        bi, bs = profiler.storage_profile(nodes[j].sf)
        d_ing, d_sto = mi - ai - bi, ms - as_ - bs
        if d_ing < 0:
            key = (d_sto, d_ing)
            if best is None or key < best[0]:
                best = (key, i, j, m)
    if best is None:
        return None
    _, i, j, m = best
    return "merge", (i, j, m)
