"""Dispatch for K5 on the tensor's device: the CUDA kernel for a CUDA
tensor, the plain version for a CPU tensor, nothing else.  The Mamba mixer
calls this once per layer, in prefill and in every decode step."""

import torch

from .mamba_scan import mamba_scan
from .ref import mamba_scan_ref


def selective_scan(delta: torch.Tensor, xc: torch.Tensor, bmat: torch.Tensor,
                   cmat: torch.Tensor, a: torch.Tensor,
                   h0: torch.Tensor | None = None):
    if delta.is_cuda:
        return mamba_scan(delta, xc, bmat, cmat, a, h0)
    if delta.device.type == "cpu":
        return mamba_scan_ref(delta, xc, bmat, cmat, a, h0)
    raise ValueError(f"no mamba_scan path for device {delta.device}")
