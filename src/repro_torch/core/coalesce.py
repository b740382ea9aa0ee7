"""Port of ``repro/core/coalesce.py``: the ``SFNode`` and ``CoalesceResult``
data.

An ``SFNode`` is one storage format with the consumers subscribed to it.
The coalescing search that produces them belongs to the
configuration-engine slice and is not ported yet.
"""

from __future__ import annotations

import dataclasses

from .consumption import ConsumerPlan
from .knobs import CodingOption, FidelityOption, StorageFormat


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
