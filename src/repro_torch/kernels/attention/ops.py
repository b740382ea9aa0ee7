"""Dispatch for K4 on the tensor's device: the CUDA kernel for a CUDA
tensor, the plain version for a CPU tensor, nothing else.  The model's
attention (``models/attention.py``) calls this once per layer: over the
prompt in prefill (with a window on the hybrid family's and gemma2's
local-attention layers, soft-capped in gemma2), over the KV cache or ring
in every decode step (with gemma2's window over its linear cache), and
non-causally over the frames in the audio family's encoder."""

import torch

from .attention import flash_attention
from .ref import attention_ref


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_offset: int = 0, k_len: int | None = None,
                  window: int = 0, causal: bool = True,
                  logit_cap: float = 0.0) -> torch.Tensor:
    """q (B, Sq, H, hd); k, v (B, Sk, KV, hd).  Returns (B, Sq, H, hd):
    attention of query rows at positions ``q_offset + i`` over the first
    ``k_len`` keys (default all), causal unless ``causal`` is False,
    within ``window`` keys of each row when it is > 0, its scores
    soft-capped at ``logit_cap`` when that is > 0."""
    if q.is_cuda:
        return flash_attention(q, k, v, q_offset, k_len, window, causal,
                               logit_cap)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, q_offset, k_len, window, causal,
                             logit_cap)
    raise ValueError(f"no attention path for device {q.device}")
