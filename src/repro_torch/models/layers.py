"""Shared neural layers of the port (``src/repro/models/layers.py``):
truncated-normal init, zero-centred RMSNorm, logit soft-capping, RoPE, the
MLPs of the dense and hybrid families (SiLU-gated, plain GeLU and GeGLU)
and ``matmul``, the product with the reference's type promotion.  M-RoPE
waits for the vlm slice (ROADMAP §1)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def param(shape, dtype, device) -> nn.Parameter:
    """An uninitialised, frozen parameter: modules are built empty and
    filled by their ``init_*`` function or by ``convert``."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


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


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` as the reference's jnp product computes it for operands of
    two dtypes: both promoted to the wider one (float32 activations over
    bfloat16 weights give a float32 product).  A plain ``@`` when the
    dtypes agree, as they do on every served path."""
    if x.dtype != w.dtype:
        dtype = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dtype), w.to(dtype)
    return x @ w


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 style logit soft-capping; identity when ``cap`` is 0."""
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# Rotary position embeddings

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim / 2,) float32 inverse frequencies ``theta^(-2i/hd)``."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def rope_table(positions: torch.Tensor, head_dim: int, theta: float
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(cos, sin)`` of the angles ``position · freq`` in float32, each
    (..., seq, 1, head_dim / 2) to broadcast over heads.  The reference's
    ``apply_rope`` computes them inside every call; the port computes them
    once per forward or decode step and rotates q and k of every layer
    with them (``apply_rope``)."""
    ang = positions[..., None].to(torch.float32) * rope_freqs(
        head_dim, theta, positions.device)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def apply_rope(x: torch.Tensor, table: tuple[torch.Tensor, torch.Tensor]
               ) -> torch.Tensor:
    """x: (..., seq, heads, head_dim) rotated by ``rope_table``'s angles,
    in halves (not interleaved pairs), in float32; the result in x's
    dtype."""
    cos, sin = table
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP

#: the MLP activations, and which of them gate ``x·wi`` with ``x·wg``
GATED = {"silu": True, "geglu": True, "gelu": False}


class MLP(nn.Module):
    """The feed-forward of the dense and hybrid families, with the
    reference's leaves: ``wi`` (d, d_ff) and ``wo`` (d_ff, d), plus the
    gate ``wg`` (d, d_ff) for the gated activations.  ``silu``:
    ``wo(silu(x·wg) * x·wi)``; ``geglu``: ``wo(gelu(x·wg) * x·wi)``;
    ``gelu``: ``wo(gelu(x·wi))``; GeLU with the tanh approximation, which
    is what ``jax.nn.gelu`` computes by default.  Built empty: ``init_mlp``
    draws the weights, ``convert.params_from_numpy`` copies them in."""

    def __init__(self, d_model: int, d_ff: int, act: str, dtype, device):
        super().__init__()
        if act not in GATED:
            raise ValueError(f"MLP act {act!r}: one of {sorted(GATED)}")
        self.act = act
        self.wi = param((d_model, d_ff), dtype, device)
        self.wo = param((d_ff, d_model), dtype, device)
        if GATED[act]:
            self.wg = param((d_model, d_ff), dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = matmul(x, self.wi)
        if self.act == "silu":
            h = F.silu(matmul(x, self.wg)) * h
        elif self.act == "geglu":
            h = F.gelu(matmul(x, self.wg), approximate="tanh") * h
        else:
            h = F.gelu(h, approximate="tanh")
        return matmul(h, self.wo)


def init_mlp(mlp: MLP, generator: torch.Generator) -> MLP:
    """Draw ``mlp``'s weights in place with the reference's scales:
    ``wi`` and ``wg`` at d^-0.5, ``wo`` at d_ff^-0.5, truncated at 2
    sigma."""
    d_model, d_ff = mlp.wi.shape
    with torch.no_grad():
        for p, scale in ((mlp.wi, d_model ** -0.5), (mlp.wo, d_ff ** -0.5),
                         *(((mlp.wg, d_model ** -0.5),)
                           if GATED[mlp.act] else ())):
            p.copy_(truncated_normal(p.shape, scale, p.dtype, generator,
                                     p.device))
    return mlp
