"""Plain PyTorch version of K2: ``R_y · X · R_xᵀ`` with the dense
``interp_matrix`` weights, on any device.  The CPU path and the oracle the
CUDA kernel is held against."""

import torch

from .resize import interp_matrix


def resize_ref(frames: torch.Tensor, h2: int, w2: int) -> torch.Tensor:
    """(n, h1, w1) -> (n, h2, w2) float32; an axis whose size is unchanged
    is left alone, as ``jax.image.resize`` leaves it."""
    x = frames.to(torch.float32)
    n, h1, w1 = x.shape
    if h2 != h1:
        ry = torch.from_numpy(interp_matrix(h2, h1)).to(x.device)
        x = torch.matmul(ry, x)
    if w2 != w1:
        rx = torch.from_numpy(interp_matrix(w2, w1)).to(x.device)
        x = torch.matmul(x, rx.T)
    return x
