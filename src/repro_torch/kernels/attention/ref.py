"""Plain PyTorch version of K4: GQA attention as full-matrix torch in
float32, causal or not, with the query offset, the valid key count, the
sliding window and the logit soft-cap of the CUDA kernel, on any device.
The CPU path and the oracle the CUDA kernel is held against.

It computes the function of the reference's TPU kernel
(``src/repro/kernels/attention/attention.py::flash_attention``, causal
with or without a window, or non-causal, with or without a soft-cap) in
the model's layout: each input is cast to float32 on its own (so k and v
may have another dtype than q, as a float32 q over a bfloat16 cache), q
is scaled by hd^-0.5 in float32 before the product, as that kernel scales
it, the scores are soft-capped, ``cap * tanh(s / cap)``, before the mask,
masked scores become -1e30, and the result is cast to q's dtype.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30

#: How far the CUDA kernel may lie from this version on the same inputs,
#: element by element: |got - want| <= u * |want| + r * rms(want's row),
#: the rms taken over a query row's hd values.  Both sum in float32 in
#: different orders, which moves an output by a few eps * sqrt(keys) of
#: its row's rms: r covers that.  In bfloat16 each then rounds once, and
#: the two may land one bf16 ulp apart, at most 2^-7 of |want|: u.  The
#: row is want's dtype, q's: a float32 q over a bfloat16 cache takes the
#: float32 row, as bfloat16 inputs are exact in float32 and nothing rounds
#: to bfloat16 on the way.  The soft-cap's tanh has a slope of at most 1,
#: so it adds no more than its own float32 rounding to a score.
HOLD = {torch.float32: (0.0, 2 ** -13), torch.bfloat16: (2 ** -7, 2 ** -10)}


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_offset: int = 0, k_len: int | None = None,
                  window: int = 0, causal: bool = True,
                  logit_cap: float = 0.0) -> torch.Tensor:
    """q (B, Sq, H, hd); k, v (B, Sk, KV, hd) with KV dividing H (query
    head h reads KV head h // (H / KV)).  Query row i sits at absolute
    position ``q_offset + i`` and sees key j when ``j < k_len`` (default
    Sk), when ``causal`` also ``j <= q_offset + i``, and with ``window``
    > 0 also ``q_offset + i - j < window``: not causal and without a
    window, ``j < k_len`` is the only mask (the TPU kernel's ``k_pos <
    sk``).  With ``logit_cap`` > 0 the scores ``s`` become ``logit_cap *
    tanh(s / logit_cap)`` first.  Returns (B, Sq, H, hd) in q's dtype."""
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    k_len = sk if k_len is None else k_len
    qf = (q.to(torch.float32) * hd ** -0.5).reshape(b, sq, kvh, h // kvh, hd)
    s = torch.einsum("bqkgd,bpkd->bkgqp", qf, k.to(torch.float32))
    if logit_cap:
        s = logit_cap * torch.tanh(s / logit_cap)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    k_pos = torch.arange(sk, device=q.device)
    ok = k_pos[None, :] < k_len
    if causal:
        ok = ok & (k_pos[None, :] <= q_pos[:, None])
    if window:
        ok = ok & (q_pos[:, None] - k_pos[None, :] < window)
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqp,bpkd->bqkgd", p, v.to(torch.float32))
    return out.reshape(b, sq, h, hd).to(q.dtype)


def scores_over_cap(q: torch.Tensor, k: torch.Tensor, cap: float,
                    q_offset: int = 0) -> torch.Tensor:
    """k with key row ``q_offset + i`` of each KV head set to a multiple of
    query row i of the first query head of its group, so that their score
    ``q·hd^-0.5·k`` is ``2·cap``: every query row has a score above
    ``cap`` by construction, whatever the inputs' seed (the key lies at
    the row's own position, which its causal mask and any window keep).
    q (B, Sq, H, hd), k (B, Sk, KV, hd) with ``q_offset + Sq <= Sk``;
    returns a new float32 k (round it to the dtype under test after)."""
    sq, h, hd = q.shape[1], q.shape[2], q.shape[3]
    lead = q[:, :, ::h // k.shape[2]].to(torch.float32)
    norm2 = lead.square().sum(dim=-1, keepdim=True)
    k = k.to(torch.float32).clone()
    k[:, q_offset:q_offset + sq] = lead * (2 * cap * hd ** 0.5 / norm2)
    return k


def hold_ratio(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest ratio of |got - want| to its bound in ``HOLD`` for
    want's dtype, over all elements; the kernel holds when it is at most
    1."""
    u, r = HOLD[want.dtype]
    w = want.to(torch.float32)
    rms = w.square().mean(dim=-1, keepdim=True).sqrt()
    bound = (u * w.abs() + r * rms).clamp_min(torch.finfo(torch.float32).tiny)
    return float(((got.to(torch.float32) - w).abs() / bound).max())
