"""Dispatch for K2 on the tensor's device: the CUDA kernel for a CUDA
tensor, the plain version for a CPU tensor, nothing else."""

import torch

from .ref import resize_ref
from .resize import resize_bilinear


def resize(frames: torch.Tensor, h2: int, w2: int) -> torch.Tensor:
    if frames.is_cuda:
        return resize_bilinear(frames, h2, w2)
    if frames.device.type == "cpu":
        return resize_ref(frames, h2, w2)
    raise ValueError(f"no resize path for device {frames.device}")
