"""Port of ``repro.core``: VStore's backward derivation of the video-format
configuration (consumption formats -> storage formats -> erosion plan),
plus the knob spaces and the profiling harness it runs on."""

from .boundary import boundary_search
from .coalesce import CoalesceResult, SFNode, choose_coding, coalesce
from .configure import (DEFAULT_ACCURACIES, DEFAULT_OPS, DerivedConfig,
                        derive_config)
from .consumption import Consumer, ConsumerPlan, derive_all
from .erosion import ErosionPlan, plan_erosion, recovery_cost
from .knobs import (CodingOption, FidelityOption, IngestSpec, StorageFormat,
                    coding_space, fidelity_space)
from .profiler import Profiler, TableProfiler

__all__ = [
    "boundary_search", "coalesce", "choose_coding", "CoalesceResult",
    "SFNode", "derive_config", "DerivedConfig", "DEFAULT_ACCURACIES",
    "DEFAULT_OPS", "Consumer", "ConsumerPlan", "derive_all", "ErosionPlan",
    "plan_erosion", "recovery_cost", "FidelityOption", "CodingOption",
    "StorageFormat",
    "IngestSpec", "fidelity_space", "coding_space", "Profiler",
    "TableProfiler",
]
