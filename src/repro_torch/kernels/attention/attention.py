"""K4: GQA flash attention -- causal, with an optional sliding window over
a prompt, or non-causal over a whole sequence -- as a hand-written CUDA
kernel (``csrc/attention.cu``), replacing the Pallas kernel
``src/repro/kernels/attention/attention.py::flash_attention``.

The TPU kernel takes q, k, v of shape (B, H, S, hd) with equal head
counts (its wrapper repeats the KV heads) and counts query positions from
0.  This one takes the model's layouts -- q (B, Sq, H, hd), k and v
(B, Sk, KV, hd) -- reads KV head ``h // (H / KV)`` for query head h
without repeating it, and takes two scalars: ``q_offset``, the absolute
position of query row 0, and ``k_len``, the number of valid keys.  Over
a prompt (Sq > 1) it takes ``q_offset = 0`` and ``k_len = Sk`` only, and
computes the TPU kernel's causal function, with its sliding ``window``
when one is given (RecurrentGemma's local attention); with Sq = 1,
``q_offset = len - 1`` and ``k_len = len`` over a KV cache or a ring
buffer it computes the reference's ``decode_attention`` without a window.
A prompt chunk over a cache (Sq > 1 at an offset) and a window in the
decode form are no served path's and are refused.  With ``causal=False``
(the audio family's encoder) it computes the TPU kernel's non-causal
function over a whole sequence: the prefill form at ``q_offset = 0`` and
``k_len = Sk`` with no window, the only mask ``j < Sk``; head_dim 80
(HuBERT-XLarge) is built for that prefill form only.  The TPU kernel's
logit soft-cap and gemma2's windowed decode over a linear cache are left
to the gemma2 slice.

The wrapper takes CUDA tensors only, checks them, allocates the output
with ``torch.empty``, launches on the current stream and raises if the
launch was refused.  The plain version is in ``ref.py``; ``ops.py`` picks
by device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..build import LAUNCHES, LIBRARIES, check_launch

#: head dims the kernel is instantiated for (smollm / qwen1.5 64,
#: hubert 80, starcoder2 128, recurrentgemma 256)
HEAD_DIMS = (64, 80, 128, 256)
#: head dims of the decode form (Sq = 1), where a thread takes one of hd
#: columns of a 256-thread block: hd divides 256
DECODE_HEAD_DIMS = (64, 128, 256)
#: the launch counter of the non-causal form (``build.LAUNCHES``), apart
#: from the causal form's ``"flash_attention"``, so that a run can show
#: which form it launched
NONCAUSAL = "flash_attention (non-causal)"
#: query heads per KV head that the decode form (Sq = 1) serves in one block
MAX_DECODE_GROUPS = 16
_TYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _kernel():
    fn = LIBRARIES.get("attention").flash_attention
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr] * 4 + [i32] * 10 + [ctypes.c_float, i32, ptr]
    fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, shape: tuple, dtype) -> None:
    if not t.is_cuda:
        raise ValueError(f"flash_attention needs CUDA tensors ({name})")
    if tuple(t.shape) != shape or t.dtype != dtype:
        raise ValueError(f"flash_attention: {name} must be {shape} {dtype}, "
                         f"got {tuple(t.shape)} {t.dtype}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"flash_attention: {name} must be contiguous and "
                         f"16-byte aligned")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_offset: int = 0, k_len: int | None = None,
                    window: int = 0, causal: bool = True) -> torch.Tensor:
    """q (B, Sq, H, hd); k, v (B, Sk, KV, hd); one dtype, float32 or
    bfloat16, on the card.  Query row i sits at position ``q_offset + i``
    and sees key j when ``j < k_len`` (default Sk) and, if ``causal``,
    ``j <= q_offset + i`` and, with ``window`` > 0, ``q_offset + i - j <
    window``; with Sq > 1, ``q_offset`` must be 0 and ``k_len`` Sk, with
    Sq = 1 ``window`` 0 and hd one of ``DECODE_HEAD_DIMS``.  Not
    ``causal``: Sq > 1 and no window.  Returns (B, Sq, H, hd) in q's
    dtype."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_attention takes (B, S, heads, hd) inputs")
    bsz, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    k_len = sk if k_len is None else int(k_len)
    q_offset, window = int(q_offset), int(window)
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention is built for head dims "
                         f"{HEAD_DIMS}, got {hd}")
    if q.dtype not in _TYPES:
        raise ValueError(f"flash_attention takes float32 or bfloat16, got "
                         f"{q.dtype}")
    if min(bsz, sq, h, kvh) <= 0 or h % kvh:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if not 1 <= k_len <= sk or q_offset < 0:
        raise ValueError(f"flash_attention: k_len {k_len} must be in "
                         f"[1, {sk}] and q_offset {q_offset} >= 0")
    if sq > 1 and (q_offset, k_len) != (0, sk):
        raise ValueError(f"flash_attention: the prefill form (Sq {sq}) takes "
                         f"q_offset 0 and k_len {sk}, got {q_offset}, {k_len}")
    if window < 0 or (sq == 1 and window):
        raise ValueError(f"flash_attention: the decode form takes no window "
                         f"and a window is >= 0, got {window} at Sq {sq}")
    if not causal and (sq == 1 or window):
        raise ValueError(f"flash_attention: the non-causal form is a prefill "
                         f"form with no window, got Sq {sq}, window {window}")
    if sq == 1 and hd not in DECODE_HEAD_DIMS:
        raise ValueError(f"flash_attention: the decode form is built for head "
                         f"dims {DECODE_HEAD_DIMS}, got {hd}")
    if sq == 1 and h // kvh > MAX_DECODE_GROUPS:
        raise ValueError(f"flash_attention: the decode form serves at most "
                         f"{MAX_DECODE_GROUPS} query heads per KV head, got "
                         f"{h // kvh}")
    _check(q, "q", (bsz, sq, h, hd), q.dtype)
    _check(k, "k", (bsz, sk, kvh, hd), q.dtype)
    _check(v, "v", (bsz, sk, kvh, hd), q.dtype)
    out = torch.empty_like(q)
    rc = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bsz, sq,
        sk, h, kvh, hd, q_offset, k_len, window, int(bool(causal)),
        hd ** -0.5,
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("flash_attention", rc)
    LAUNCHES.add("flash_attention" if causal else NONCAUSAL)
    return out
