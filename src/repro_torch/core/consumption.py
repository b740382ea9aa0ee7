"""Port of ``repro/core/consumption.py``: ``Consumer`` and ``ConsumerPlan``.

A consumer is an ⟨operator, target accuracy⟩ pair; its plan records the
consumption format (CF) chosen for it.  The derivation itself
(``derive_consumption_format``) belongs to the configuration-engine slice
and is not ported yet.
"""

from __future__ import annotations

import dataclasses

from .knobs import FidelityOption


@dataclasses.dataclass(frozen=True)
class Consumer:
    op: str
    target: float

    def name(self) -> str:
        return f"{self.op}@{self.target:.2f}"


@dataclasses.dataclass(eq=False)  # identity hash: plans key subscriptions
class ConsumerPlan:
    consumer: Consumer
    cf: FidelityOption
    accuracy: float
    speed: float  # consumption speed, x-realtime
