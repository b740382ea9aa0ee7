"""Grouped-query attention of the port (``src/repro/models/attention.py``):
causal self-attention over the prompt (with a sliding window on the hybrid
family's and gemma2's local-attention layers) and over a KV cache or ring
buffer (with gemma2's window over its linear cache), gemma2's logit
soft-cap on both, and bidirectional self-attention over the frames of the
audio family's encoder.

The projections are plain PyTorch matrix products (``layers.matmul``), as
they are XLA's in the reference; both attention calls go through K4
(``kernels/attention/ops.py``): the CUDA kernel on the card, its plain
version on the CPU.  The reference computes attention in blocked jnp and
its decode form as one softmax; the port's kernel computes both, the
decode form with the query at position ``cache_len - 1``.  The reference
scales q and casts p in the input dtype (in its decode form, the cache's:
p and the output are rounded to bfloat16 over a bfloat16 cache); the port
follows the TPU kernel (q scaled and p kept in float32, each input cast to
float32 on its own, the output in q's dtype), so the two agree to rounding
in float32 and differ by bf16 rounding where the reference rounds.
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels.attention.ops import gqa_attention
from .config import ArchConfig
from .layers import apply_rope, matmul, param, truncated_normal


class Attention(nn.Module):
    """One layer's attention with the reference's leaves and layouts:
    ``wq`` (d, H, hd), ``wk``/``wv`` (d, KV, hd), ``wo`` (H, hd, d), and
    ``bq`` (H, hd), ``bk``/``bv`` (KV, hd) when ``cfg.qkv_bias``.  Built
    empty: ``init_attention`` draws the weights,
    ``convert.params_from_numpy`` copies them in."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        h, kv = cfg.n_heads, cfg.n_kv_heads
        self.n_heads, self.n_kv_heads, self.head_dim = h, kv, hd
        self.wq = param((d, h, hd), dtype, device)
        self.wk = param((d, kv, hd), dtype, device)
        self.wv = param((d, kv, hd), dtype, device)
        self.wo = param((h, hd, d), dtype, device)
        self.qkv_bias = cfg.qkv_bias
        if cfg.qkv_bias:
            self.bq = param((h, hd), dtype, device)
            self.bk = param((kv, hd), dtype, device)
            self.bv = param((kv, hd), dtype, device)

    def qkv_project(self, x: torch.Tensor, rope) -> tuple:
        """x (B, S, d) -> q (B, S, H, hd), k, v (B, S, KV, hd), q and k
        rotated by ``rope`` (a ``layers.rope_table``)."""
        b, s, d = x.shape
        q = matmul(x, self.wq.reshape(d, -1)).view(b, s, self.n_heads, -1)
        k = matmul(x, self.wk.reshape(d, -1)).view(b, s, self.n_kv_heads, -1)
        v = matmul(x, self.wv.reshape(d, -1)).view(b, s, self.n_kv_heads, -1)
        if self.qkv_bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        return apply_rope(q, rope), apply_rope(k, rope), v

    @staticmethod
    def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  window: int = 0, causal: bool = True,
                  logit_cap: float = 0.0) -> torch.Tensor:
        """Attention of the sequence over itself (train, prefill, encode):
        q (B, S, H, hd), k, v (B, S, KV, hd) -> (B, S, H, hd); causal, with
        ``window`` > 0 query i sees keys i - window < j <= i only; not
        ``causal`` (an encoder: ``cfg.causal``), every query sees every
        key; scores soft-capped at ``logit_cap`` when it is > 0."""
        return gqa_attention(q, k, v, window=window, causal=causal,
                             logit_cap=logit_cap)

    @staticmethod
    def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, cache_len: int,
                         window: int = 0,
                         logit_cap: float = 0.0) -> torch.Tensor:
        """One token per row against the cache: q (B, 1, H, hd), caches
        (B, S_max, KV, hd) whose first ``cache_len`` positions are valid,
        the new token's k/v already written among them (at ``cache_len -
        1`` in a linear cache, anywhere in a ring: the softmax does not
        care where).  With ``window`` > 0 the token sees positions
        ``cache_len - window`` .. ``cache_len - 1`` (all of a ring of at
        most ``window``); scores
        soft-capped at ``logit_cap`` when it is > 0.  The caches may be of
        another dtype than q (bfloat16 under float32 weights); the result
        takes q's."""
        return gqa_attention(q, k_cache, v_cache, q_offset=cache_len - 1,
                             k_len=cache_len, window=window,
                             logit_cap=logit_cap)

    def out_project(self, attn_out: torch.Tensor) -> torch.Tensor:
        """(B, S, H, hd) -> (B, S, d)."""
        b, s = attn_out.shape[:2]
        return matmul(attn_out.reshape(b, s, -1),
                      self.wo.reshape(-1, self.wo.shape[-1]))


def init_attention(attn: Attention, generator: torch.Generator) -> Attention:
    """Draw ``attn``'s weights in place with the reference's scales:
    ``wq``/``wk``/``wv`` at d^-0.5, ``wo`` at (H·hd)^-0.5, truncated at 2
    sigma; the biases zero."""
    d = attn.wq.shape[0]
    with torch.no_grad():
        for p, scale in ((attn.wq, d ** -0.5), (attn.wk, d ** -0.5),
                         (attn.wv, d ** -0.5),
                         (attn.wo, (attn.n_heads * attn.head_dim) ** -0.5)):
            p.copy_(truncated_normal(p.shape, scale, p.dtype, generator,
                                     p.device))
        if attn.qkv_bias:
            for p in (attn.bq, attn.bk, attn.bv):
                p.zero_()
    return attn
