"""Recurrent sequence mixing of the port (``src/repro/models/recurrent.py``):
the Mamba-1 selective SSM block and the RG-LRU block (Griffin /
RecurrentGemma), each with its depthwise causal conv.

The projections, the conv and the gates are plain PyTorch, as they are jnp
in the reference; the scans go through kernels, the CUDA kernel on the
card and its plain version on the CPU: Mamba's -- the reference's
``scan_impl="step"`` body -- through K5 (``kernels/mamba_scan/ops.py``),
the RG-LRU's ``h_t = a_t·h_{t-1} + b_t``, with a and b formed from its
gates, through K6's gated form (``kernels/rglru/ops.py``).  One mixer
call serves both forms: the full sequence from a zero state (train,
prefill) and one step from a carried state (decode).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.mamba_scan.ops import selective_scan
from ..kernels.rglru.ops import lru_gated_scan
from .layers import param, truncated_normal


def _causal_conv(x: torch.Tensor, w: torch.Tensor, state=None):
    """x: (B, S, W) depthwise causal conv with kernel (cw, W).
    ``state``: (B, cw-1, W) history for decode; returns (y, new_state).
    The taps are summed in the reference's order; the new state is a copy,
    so it does not keep the padded sequence alive."""
    cw = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], cw - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(cw))
    new_state = xp[:, xp.shape[1] - (cw - 1):].clone()
    return y, new_state


class MambaMixer(nn.Module):
    """One Mamba-1 block's sequence mixer, with the reference's parameter
    names and layouts (``x @ in_proj``, conv taps (cw, inner), ...).
    Projection weights take the model's dtype; ``dt_bias``, ``a_log`` and
    ``d`` are float32, as in the reference.  Built empty: ``init_mamba``
    draws the weights, ``convert.params_from_numpy`` copies them in."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        ssm = cfg.ssm
        d = cfg.d_model
        self.inner = ssm.expand * d
        self.state_dim = ssm.state_dim
        self.dt_rank = ssm.dt_rank or -(-d // 16)
        inner, n, r = self.inner, self.state_dim, self.dt_rank
        self.in_proj = param((d, 2 * inner), dtype, device)
        self.conv = param((ssm.conv_width, inner), dtype, device)
        self.x_proj = param((inner, r + 2 * n), dtype, device)
        self.dt_proj = param((r, inner), dtype, device)
        self.dt_bias = param((inner,), torch.float32, device)
        self.a_log = param((inner, n), torch.float32, device)
        self.d = param((inner,), torch.float32, device)
        self.out_proj = param((inner, d), dtype, device)

    def forward(self, x: torch.Tensor, state: dict | None = None):
        """x: (B, S, d).  ``state``: None (a zero state) or dict(conv, h)
        as ``mamba_init_state`` lays it out.  Returns (out (B, S, d),
        new_state)."""
        n, r = self.state_dim, self.dt_rank
        xi, z = torch.chunk(x @ self.in_proj, 2, dim=-1)
        xc, conv_state = _causal_conv(
            xi, self.conv, None if state is None else state["conv"])
        xc = F.silu(xc)
        dt, bmat, cmat = torch.split(xc @ self.x_proj, [r, n, n], dim=-1)
        delta = F.softplus(dt @ self.dt_proj + self.dt_bias)
        a = -torch.exp(self.a_log)
        y, h_t = selective_scan(delta, xc, bmat.contiguous(),
                                cmat.contiguous(), a,
                                None if state is None else state["h"])
        y = y + self.d * xc.to(torch.float32)
        y = y.to(x.dtype) * F.silu(z)
        return y @ self.out_proj, {"conv": conv_state, "h": h_t}


def init_mamba(mixer: MambaMixer, generator: torch.Generator) -> MambaMixer:
    """Draw ``mixer``'s weights in place from ``generator`` with the
    reference's distributions (``init_mamba`` there): truncated normals at
    fan-in scale, ``dt_bias`` the softplus inverse of a log-uniform step in
    [1e-3, 1e-1], ``a_log = log(1..n)`` per channel, ``d = 1``."""
    dev = mixer.in_proj.device
    d = mixer.in_proj.shape[0]
    inner, n, r = mixer.inner, mixer.state_dim, mixer.dt_rank
    with torch.no_grad():
        for p, scale in ((mixer.in_proj, d ** -0.5),
                         (mixer.conv, inner ** -0.5),
                         (mixer.x_proj, inner ** -0.5),
                         (mixer.dt_proj, r ** -0.5)):
            p.copy_(truncated_normal(p.shape, scale, p.dtype, generator, dev))
        u = torch.empty((inner,), dtype=torch.float32, device=dev)
        u.uniform_(math.log(1e-3), math.log(1e-1), generator=generator)
        mixer.dt_bias.copy_(torch.log(torch.expm1(torch.exp(u))))
        mixer.a_log.copy_(torch.log(
            torch.arange(1, n + 1, dtype=torch.float32, device=dev)
            .repeat(inner, 1)))
        mixer.d.fill_(1.0)
        mixer.out_proj.copy_(truncated_normal(
            mixer.out_proj.shape, inner ** -0.5, mixer.out_proj.dtype,
            generator, dev))
    return mixer


def mamba_init_state(cfg, batch: int, dtype, device) -> dict:
    """A zero decode state: ``conv`` (B, cw-1, inner) in the activation
    dtype, ``h`` (B, inner, n) float32."""
    inner = cfg.ssm.expand * cfg.d_model
    return {"conv": torch.zeros((batch, cfg.ssm.conv_width - 1, inner),
                                dtype=dtype, device=device),
            "h": torch.zeros((batch, inner, cfg.ssm.state_dim),
                             dtype=torch.float32, device=device)}


class RGLRUMixer(nn.Module):
    """One RG-LRU block's sequence mixer, with the reference's parameter
    names and layouts: ``wx``, ``wy`` (d, W), ``conv`` taps (cw, W),
    ``w_input_gate``, ``w_rec_gate`` (W, W), ``a_param`` (W,) and ``wo``
    (W, d).  ``a_param`` is float32, the rest take the model's dtype, as in
    the reference.  Built empty: ``init_rglru`` draws the weights,
    ``convert.params_from_numpy`` copies them in."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        d = cfg.d_model
        w = cfg.rglru.lru_width or d
        self.wx = param((d, w), dtype, device)
        self.wy = param((d, w), dtype, device)
        self.conv = param((cfg.rglru.conv_width, w), dtype, device)
        self.w_input_gate = param((w, w), dtype, device)
        self.w_rec_gate = param((w, w), dtype, device)
        self.a_param = param((w,), torch.float32, device)
        self.wo = param((w, d), dtype, device)

    def forward(self, x: torch.Tensor, state: dict | None = None):
        """x: (B, S, d).  ``state``: None (a zero state) or dict(conv, h)
        as ``rglru_init_state`` lays it out.  Returns (out (B, S, d),
        new_state), the new ``h`` the last row of the scan in float32.

        Types follow the reference step by step: the gates in the
        activation dtype; a and b formed from them in float32 as
        ``kernels/rglru/ref.py::gated_ab`` forms them (in the kernel's
        registers on the card), then scanned."""
        yb = F.gelu(x @ self.wy, approximate="tanh")
        xc, conv_state = _causal_conv(
            x @ self.wx, self.conv, None if state is None else state["conv"])
        r = torch.sigmoid(xc @ self.w_rec_gate)
        i = torch.sigmoid(xc @ self.w_input_gate)
        h = lru_gated_scan(r, i, xc, self.a_param,
                           None if state is None else state["h"])
        out = (h.to(x.dtype) * yb) @ self.wo
        return out, {"conv": conv_state, "h": h[:, -1].contiguous()}


def init_rglru(mixer: RGLRUMixer, generator: torch.Generator) -> RGLRUMixer:
    """Draw ``mixer``'s weights in place from ``generator`` with the
    reference's distributions (``init_rglru`` there): truncated normals at
    d^-0.5 (``wx``, ``wy``) and W^-0.5 (the rest), and ``a_param`` the
    softplus inverse of 0.65 on every channel."""
    d, w = mixer.wx.shape
    with torch.no_grad():
        for p, scale in ((mixer.wx, d ** -0.5), (mixer.wy, d ** -0.5),
                         (mixer.conv, w ** -0.5),
                         (mixer.w_input_gate, w ** -0.5),
                         (mixer.w_rec_gate, w ** -0.5),
                         (mixer.wo, w ** -0.5)):
            p.copy_(truncated_normal(p.shape, scale, p.dtype, generator,
                                     p.device))
        mixer.a_param.copy_(torch.log(torch.expm1(torch.full(
            (w,), 0.65, dtype=torch.float32, device=mixer.a_param.device))))
    return mixer


def rglru_init_state(cfg, batch: int, dtype, device) -> dict:
    """A zero decode state: ``conv`` (B, cw-1, W) in the activation dtype,
    ``h`` (B, W) float32."""
    w = cfg.rglru.lru_width or cfg.d_model
    return {"conv": torch.zeros((batch, cfg.rglru.conv_width - 1, w),
                                dtype=dtype, device=device),
            "h": torch.zeros((batch, w), dtype=torch.float32, device=device)}
