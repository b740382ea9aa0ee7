"""Plain PyTorch version of K6: the RG-LRU recurrence step by step, on any
device.  The CPU path and the oracle the CUDA kernel is held against.

Each step is ``a_t * h + b_t`` rounded once, as the kernel's ``fmaf`` and
the reference's compiled step (``src/repro/models/recurrent.py::
rglru_mix`` from a state) round it: the product of two float32 values is
exact in float64, so the step is taken there and rounded to float32.
(That rounds twice, to float64 and then float32, which can differ from one
rounding only when the float64 sum lands exactly halfway between two
float32 values.)
"""

from __future__ import annotations

import torch


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
