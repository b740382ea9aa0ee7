"""Plain PyTorch version of K5: the selective scan step by step, in the
operation order of the reference's step body
(``src/repro/models/recurrent.py::mamba_mix``, ``scan_impl="step"``), on
any device.  The CPU path and the oracle the CUDA kernel is held
against."""

from __future__ import annotations

import torch


def mamba_scan_ref(delta: torch.Tensor, xc: torch.Tensor, bmat: torch.Tensor,
                   cmat: torch.Tensor, a: torch.Tensor,
                   h0: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """delta, xc (B, S, inner); bmat, cmat (B, S, n); a (inner, n); h0
    (B, inner, n) or None (zeros).  Returns y (B, S, inner) f32 and the
    final state (B, inner, n) f32."""
    bsz, s, inner = delta.shape
    a = a.to(torch.float32)
    h = (torch.zeros((bsz, inner, a.shape[-1]), dtype=torch.float32,
                     device=delta.device)
         if h0 is None else h0.to(torch.float32))
    y = torch.empty((bsz, s, inner), dtype=torch.float32, device=delta.device)
    for t in range(s):
        delta_t = delta[:, t]
        da = torch.exp(delta_t[..., None].to(torch.float32) * a)
        dbx = ((delta_t * xc[:, t]).to(torch.float32)[..., None]
               * bmat[:, t].to(torch.float32)[:, None, :])
        h = da * h + dbx
        y[:, t] = torch.einsum("bin,bn->bi", h, cmat[:, t].to(torch.float32))
    return y, h
