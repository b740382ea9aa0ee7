"""Port of ``repro/core/consumption.py``, verbatim: the derivation is pure
Python over a profiler's answers.

Consumption-format derivation (paper §4.2).

For each consumer ⟨operator, target accuracy⟩ find the fidelity f0 with
adequate accuracy and minimum consumption cost:

  i)   fix image quality at its richest value (O2: quality does not affect
       consumption cost),
  ii)  partition the remaining 3D space along the shortest dimension (crop),
  iii) in each 2D (sampling x resolution) plane walk the accuracy boundary
       (boundary_search) profiling only probed cells,
  iv)  among all adequate boundary points pick the minimum consumption cost,
  v)   then lower image quality as far as accuracy stays adequate (reduces
       storage-side costs opportunistically without touching consumption
       cost).
"""

from __future__ import annotations

import dataclasses

from .boundary import boundary_search
from .knobs import (CROP_VALUES, QUALITY_VALUES, RESOLUTION_VALUES,
                    SAMPLING_VALUES, FidelityOption)


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


def derive_consumption_format(profiler, consumer: Consumer) -> ConsumerPlan:
    op, target = consumer.op, consumer.target
    best_q = QUALITY_VALUES[-1]

    candidates: list[tuple[float, FidelityOption]] = []
    for crop in CROP_VALUES:
        def adequate(r: int, c: int, _crop=crop) -> bool:
            f = FidelityOption(best_q, _crop, RESOLUTION_VALUES[c],
                               SAMPLING_VALUES[r])
            return profiler.accuracy(op, f) >= target

        points, _ = boundary_search(len(SAMPLING_VALUES),
                                    len(RESOLUTION_VALUES), adequate)
        for r, c in points:
            f = FidelityOption(best_q, crop, RESOLUTION_VALUES[c],
                               SAMPLING_VALUES[r])
            acc, speed = profiler.consumer_profile(op, f)
            candidates.append((speed, f))

    if not candidates:  # golden fidelity is adequate by construction
        f = FidelityOption()
        acc, speed = profiler.consumer_profile(op, f)
        return ConsumerPlan(consumer, f, acc, speed)

    # max consumption speed = min consumption cost; tie-break to the poorest
    # fidelity (lower storage-side cost downstream)
    speed0, f0 = max(candidates, key=lambda t: (t[0], -sum(t[1].rank())))

    # v) lower image quality to the minimum that stays adequate
    chosen = f0
    for q in reversed(QUALITY_VALUES[:-1]):  # good, bad, worst
        f_try = chosen.with_knob("quality", q)
        if profiler.accuracy(op, f_try) >= target:
            chosen = f_try
        else:
            break

    acc, speed = profiler.consumer_profile(op, chosen)
    return ConsumerPlan(consumer, chosen, acc, speed)


def derive_all(profiler, consumers: list[Consumer]) -> list[ConsumerPlan]:
    """Derive CFs for every consumer.  Profiling results are memoized inside
    the profiler, so one operator's multiple accuracy levels share runs
    (paper §4.2 'further optimization')."""
    return [derive_consumption_format(profiler, c) for c in consumers]
