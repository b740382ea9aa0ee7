"""Shared neural layers of the port (``src/repro/models/layers.py``): what
the Mamba serving path needs -- truncated-normal init, zero-centred RMSNorm
and logit soft-capping.  RoPE and the gated MLPs come with the attention
families' slices."""

from __future__ import annotations

import torch


def truncated_normal(shape, scale: float, dtype, generator: torch.Generator,
                     device) -> torch.Tensor:
    """``scale * N(0, 1)`` truncated to [-2, 2], drawn in float32 from
    ``generator`` on ``device`` and cast to ``dtype`` before the scale, as
    the reference casts."""
    z = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(z, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=generator)
    return z.to(dtype) * scale


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """Zero-centred RMSNorm (scaled by ``1 + weight``) with the variance in
    float32 and the result in ``x``'s dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + weight)).to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 style logit soft-capping; identity when ``cap`` is 0."""
    if not cap:
        return x
    return cap * torch.tanh(x / cap)
