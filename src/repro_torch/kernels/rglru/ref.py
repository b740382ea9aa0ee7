"""Plain PyTorch versions of K6 and its gated form, on any device.  The
CPU path and the oracles the CUDA kernels are held against.

``rglru_scan_ref``: the RG-LRU recurrence step by step.  Each step is
``a_t * h + b_t`` rounded once, as the kernel's ``fmaf`` and the
reference's compiled step (``src/repro/models/recurrent.py::rglru_mix``
from a state) round it: the product of two float32 values is exact in
float64, so the step is taken there and rounded to float32.  (That rounds
twice, to float64 and then float32, which can differ from one rounding
only when the float64 sum lands exactly halfway between two float32
values.)

``rglru_gated_scan_ref``: a and b formed from the gates as the RG-LRU
mixer forms them (``gated_ab``, the reference's ``rglru_mix`` type for
type), then ``rglru_scan_ref``.  ``GATED_MUTANTS`` are defects of the
gated form that the card's holds must catch (``gated_mutant``).
``gate_arrays`` makes the gated form's inputs for the checks.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

#: the RG-LRU's gate constant c in ``log a = -c·r·softplus(a_param)``
C_RGLRU = 8.0

GATED_MUTANTS = ("b without its sqrt(1 - a²) factor",
                 "a without the factor C", "h0 ignored")


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor,
                   h0: torch.Tensor | None = None) -> torch.Tensor:
    """a, b (B, S, W); h0 (B, W) or None (zeros).  Returns h (B, S, W)
    float32 with ``h_t = a_t * h_{t-1} + b_t``."""
    bsz, s, w = a.shape
    h = (torch.zeros((bsz, w), dtype=torch.float32, device=a.device)
         if h0 is None else h0.to(torch.float32))
    out = torch.empty((bsz, s, w), dtype=torch.float32, device=a.device)
    f64 = torch.float64
    for t in range(s):
        h = (a[:, t].to(f64) * h.to(f64) + b[:, t].to(f64)).to(torch.float32)
        out[:, t] = h
    return out


def gated_ab(r: torch.Tensor, i: torch.Tensor, xc: torch.Tensor,
             a_param: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """a and b (B, S, W) float32 from the gates r, i, xc (B, S, W) in the
    activation dtype and ``a_param`` (W,) float32, typed as the reference
    types them: ``-c·r`` in the activation dtype, times the float32
    ``softplus(a_param)`` in float32; ``i·xc`` in the activation dtype
    before the cast."""
    log_a = -C_RGLRU * r * F.softplus(a_param)
    a = torch.exp(log_a.to(torch.float32))
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) \
        * (i * xc).to(torch.float32)
    return a, b


def rglru_gated_scan_ref(r: torch.Tensor, i: torch.Tensor, xc: torch.Tensor,
                         a_param: torch.Tensor,
                         h0: torch.Tensor | None = None) -> torch.Tensor:
    """K6's gated form: ``gated_ab``'s a and b scanned by
    ``rglru_scan_ref`` from h0 (B, W) float32 or None (zeros).  Returns h
    (B, S, W) float32."""
    return rglru_scan_ref(*gated_ab(r, i, xc, a_param), h0)


def gated_mutant(mutant: str, r, i, xc, a_param, h0=None):
    """The plain gated form with the defect ``mutant`` (one of
    ``GATED_MUTANTS``): b left at ``i·xc``, a taken as
    ``exp(-r·softplus(a_param))`` (and b from that a), or h0 left out;
    None where it would change nothing (no h0)."""
    if mutant == "h0 ignored":
        return None if h0 is None else rglru_gated_scan_ref(r, i, xc,
                                                            a_param)
    a, b = gated_ab(r, i, xc, a_param)
    if mutant == "b without its sqrt(1 - a²) factor":
        b = (i * xc).to(torch.float32)
    elif mutant == "a without the factor C":
        a, b = gated_ab(r / C_RGLRU, i, xc, a_param)
    else:
        raise ValueError(f"no gated mutant {mutant!r}")
    return rglru_scan_ref(a, b, h0)


def gate_arrays(bsz: int, s: int, w: int, seed: int) -> list[np.ndarray]:
    """The gated form's inputs from numpy, float32: r and i (B, S, W)
    sigmoids, xc (B, S, W) normal, ``a_param`` (W,) spread around its
    initial value with every 7th column above softplus's threshold of 20
    (a ~ 0) and every 11th from the 4th at -30 (a rounds to 1, so 1 - a²
    meets the 1e-12 floor), and a state h0 (B, W)."""
    rng = np.random.default_rng(seed)
    r, i = (1 / (1 + np.exp(-rng.normal(0, 1.5, (bsz, s, w))))
            for _ in range(2))
    xc = rng.normal(0, 1, (bsz, s, w))
    a_param = rng.normal(0.5, 2.0, w)
    a_param[::7] = 25.0
    a_param[3::11] = -30.0
    h0 = rng.normal(0, 1, (bsz, w))
    return [x.astype(np.float32) for x in (r, i, xc, a_param, h0)]
