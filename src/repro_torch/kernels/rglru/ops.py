"""Dispatch for K6's gated form on the tensor's device: the CUDA kernel
for a CUDA tensor, the plain version for a CPU tensor, nothing else.  The RG-LRU mixer calls ``lru_gated_scan`` once per layer, in
prefill and in every decode step."""

import torch

from .ref import rglru_gated_scan_ref
from .rglru import rglru_gated_scan


def lru_gated_scan(r: torch.Tensor, i: torch.Tensor, xc: torch.Tensor,
                   a_param: torch.Tensor,
                   h0: torch.Tensor | None = None) -> torch.Tensor:
    if r.is_cuda:
        return rglru_gated_scan(r, i, xc, a_param, h0)
    if r.device.type == "cpu":
        return rglru_gated_scan_ref(r, i, xc, a_param, h0)
    raise ValueError(f"no rglru_gated_scan path for device {r.device}")
