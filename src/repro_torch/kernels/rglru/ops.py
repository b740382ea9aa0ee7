"""Dispatch for K6 on the tensor's device: the CUDA kernel for a CUDA
tensor, the plain version for a CPU tensor, nothing else.  The RG-LRU
mixer calls this once per layer, in prefill and in every decode step."""

import torch

from .ref import rglru_scan_ref
from .rglru import rglru_scan


def lru_scan(a: torch.Tensor, b: torch.Tensor,
             h0: torch.Tensor | None = None) -> torch.Tensor:
    if a.is_cuda:
        return rglru_scan(a, b, h0)
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b, h0)
    raise ValueError(f"no rglru_scan path for device {a.device}")
