"""Plain PyTorch version of K5: the selective scan step by step, in the
operation order of the reference's step body
(``src/repro/models/recurrent.py::mamba_mix``, ``scan_impl="step"``), on
any device.  The CPU path and the oracle the CUDA kernel is held
against, with the input-level mutants that hold must see fail."""

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


#: input-level mutants a hold of K5 must see fail: the plain version on
#: the mutated inputs against the kernel on the true ones
MUTANTS = ("state n-1 dropped from y", "b and c a step late", "h0 ignored")


def mutant_inputs(mutant: str, delta, xc, bmat, cmat, a, h0):
    """The inputs of ``mutant`` (one of ``MUTANTS``): cmat's last state
    zeroed, bmat and cmat rolled one step later, or h0 left out; None
    where it would change nothing (no step at S 0, no earlier step at S 1,
    no h0)."""
    if mutant == "state n-1 dropped from y":
        if delta.shape[1] < 1:
            return None
        cmat = cmat.clone()
        cmat[..., -1] = 0
    elif mutant == "b and c a step late":
        if delta.shape[1] < 2:
            return None
        bmat, cmat = (torch.roll(t, 1, dims=1) for t in (bmat, cmat))
    elif h0 is None:  # "h0 ignored"
        return None
    else:
        h0 = None
    return delta, xc, bmat, cmat, a, h0
