"""K4: GQA flash attention -- causal, with an optional sliding window over
a prompt or over a linear KV cache, or non-causal over a whole sequence,
each with an optional logit soft-cap -- as a hand-written CUDA kernel
(``csrc/attention.cu``), replacing the Pallas kernel
``src/repro/kernels/attention/attention.py::flash_attention``.

The TPU kernel takes q, k, v of shape (B, H, S, hd) with equal head
counts (its wrapper repeats the KV heads), casts each to float32 on its
own and counts query positions from 0.  This one takes the model's
layouts -- q (B, Sq, H, hd), k and v (B, Sk, KV, hd) -- reads KV head
``h // (H / KV)`` for query head h without repeating it, and takes two
scalars: ``q_offset``, the absolute position of query row 0, and
``k_len``, the number of valid keys.  Over a prompt (Sq > 1) it takes
``q_offset = 0``, ``k_len = Sk`` and one dtype only, and computes the TPU
kernel's causal function, with its sliding ``window`` when one is given
(RecurrentGemma's and gemma2's local attention); with Sq = 1,
``q_offset = len - 1`` and ``k_len = len`` over a KV cache or a ring
buffer it computes the reference's ``decode_attention``, with its window
over a linear cache (gemma2's local layers: keys ``len - window`` ..
``len - 1``) and with a float32 q over a bfloat16 cache (float32 weights
over the reference's default cache).  ``logit_cap`` > 0 soft-caps the
float32 scores, ``cap * tanh(s / cap)``, before the mask (gemma2's 50).
A prompt chunk over a cache (Sq > 1 at an offset), a window in the decode
form with the query anywhere but at the cache's last valid position,
mixed dtypes in the prefill form and a bfloat16 q over a float32 cache
are no served path's and are refused.  With ``causal=False`` (the audio
family's encoder) it computes the TPU kernel's non-causal function over a
whole sequence: the prefill form at ``q_offset = 0`` and ``k_len = Sk``
with no window, the only mask ``j < Sk``; head_dim 80 (HuBERT-XLarge) is
built for that prefill form only.

The wrapper takes CUDA tensors only, checks them, allocates the output
with ``torch.empty``, launches on the current stream and raises if the
launch was refused.  The prefill form runs a bfloat16 call on the tensor
cores (raw q·k scaled in float32, p split in bfloat16 hi + lo for p·v,
so that it keeps ``ref.HOLD``) and a float32 call on the CUDA cores.
The decode form runs split-KV: ``decode_splits`` cuts
the keys a query sees into splits from the cache's shape, the window and
the card's SM count alone, so every step over one cache launches the same
grid; the splits' float32 workspace is kept from call to call
(``_workspace``), and the C side launches a split kernel and, with more
than one split, a combine kernel.  Each wrapper call counts once in
``build.LAUNCHES`` under the key of its form (``launch_key``).  The plain
version is in ``ref.py``; ``ops.py`` picks by device.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from ..build import LAUNCHES, LIBRARIES, check_launch

#: head dims the kernel is instantiated for (the reduced launcher's 32,
#: smollm / qwen1.5 64, hubert 80, starcoder2 128, recurrentgemma and
#: gemma2 256)
HEAD_DIMS = (32, 64, 80, 128, 256)
#: head dims of the decode form (Sq = 1), whose warps split a row of hd
#: values over their 32 lanes: hd a multiple of 32
DECODE_HEAD_DIMS = (32, 64, 128, 256)
#: the launch counters (``build.LAUNCHES``) of the non-causal form and of
#: the causal capped forms (gemma2's, without and with a window), apart
#: from the causal form's ``"flash_attention"``, so that a run can show
#: which form it launched
NONCAUSAL = "flash_attention (non-causal)"
CAPPED = "flash_attention (capped)"
CAPPED_WINDOWED = "flash_attention (capped, windowed)"
#: query heads per KV head that the decode form (Sq = 1) serves in one block
MAX_DECODE_GROUPS = 16
#: the fewest keys a split of the decode form takes, and the blocks an SM
#: its split plan aims for
MIN_SPLIT_LEN = 64
SPLIT_BLOCKS_PER_SM = 2
_TYPES = (torch.float32, torch.bfloat16)


@functools.cache
def decode_splits(bsz: int, sk: int, kvh: int, window: int,
                  n_sm: int) -> tuple:
    """The decode form's split plan over a cache of ``bsz`` rows, ``sk``
    positions and ``kvh`` KV heads under ``window`` (0: none) on a card of
    ``n_sm`` SMs: returns ``(n_split, split_len)``, split j taking keys
    ``k_first + j·split_len`` onwards, so that the splits cover the most
    keys a query sees, ``min(sk, window)`` or ``sk``, from the first one.
    It depends on the cache's shape and the window alone, never on the
    valid length, so every decode step over one cache launches the same
    grid of ``n_split·kvh·bsz`` blocks: ``SPLIT_BLOCKS_PER_SM·n_sm`` of
    them (two an SM, the most that are resident at once; one more row of
    splits where ``bsz·kvh`` does not divide that), or, where that would
    make splits shorter than ``MIN_SPLIT_LEN`` keys, splits of that
    length; one split when the batch fills that many blocks alone.
    Cached: the wrapper asks for it at every call."""
    span = min(sk, window) if window else sk
    want = -(-SPLIT_BLOCKS_PER_SM * n_sm // (bsz * kvh))
    split_len = -(-span // want)
    if split_len < MIN_SPLIT_LEN:
        return -(-span // MIN_SPLIT_LEN), MIN_SPLIT_LEN
    return want, split_len


def decode_split_keys(plan: tuple, q_offset: int, k_len: int,
                      window: int) -> list:
    """The keys ``[lo, hi)`` of each split of ``plan`` (``decode_splits``)
    that holds keys the query at ``q_offset`` sees over ``k_len`` valid
    keys under ``window``: those of ``[k_first, n_keys)``, with ``n_keys =
    min(k_len, q_offset + 1)`` and ``k_first = max(0, q_offset + 1 -
    window)`` under a window, else 0.  Split j takes them from ``k_first +
    j·split_len``, as the kernel does, so a window's splits start at its
    first key."""
    n_split, split_len = plan
    n_keys = min(k_len, q_offset + 1)
    k_first = max(0, q_offset + 1 - window) if window else 0
    bounds = [(k_first + j * split_len,
               min(n_keys, k_first + (j + 1) * split_len))
              for j in range(n_split)]
    return [(lo, hi) for lo, hi in bounds if lo < hi]


def decode_plan(k: torch.Tensor, q_offset: int, k_len: int,
                window: int) -> tuple:
    """The split plan the wrapper launches over the cache ``k`` (B, Sk,
    KV, hd) on its card, and the keys of each split that holds keys of
    this query: ``((n_split, split_len), [(lo, hi), ...])``."""
    plan = decode_splits(k.shape[0], k.shape[1], k.shape[2], window,
                         sm_count(k.device.index))
    return plan, decode_split_keys(plan, q_offset, k_len, window)


#: the decode form's float32 workspaces, one a (device, stream, thread),
#: grown as needed (``_workspace``)
_WORKSPACES: dict = {}


def _workspace(n: int, device: torch.device, stream: int) -> torch.Tensor:
    """A float32 workspace of at least ``n`` floats on ``device``, kept
    for the calls of this thread on ``stream``: they reach the card in
    the stream's order, so one call's split kernel never writes it while
    the combine of another still reads it, and the host spends no
    allocation a call.  A workspace replaced by a larger one goes back to
    the caching allocator on the stream it was taken on."""
    key = (device.index, stream, threading.get_ident())
    ws = _WORKSPACES.get(key)
    if ws is None or ws.numel() < n:
        ws = _WORKSPACES[key] = torch.empty(n, dtype=torch.float32,
                                            device=device)
    return ws


@functools.cache
def sm_count(index: int) -> int:
    """The SM count of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def cache_dtypes(q_dtype) -> tuple:
    """The k/v dtypes the decode form takes under a q of ``q_dtype``: its
    own, and bfloat16 under a float32 q (float32 weights over the
    reference's default cache); none for a dtype the kernel does not
    take."""
    if q_dtype not in _TYPES:
        return ()
    return _TYPES if q_dtype == torch.float32 else (q_dtype,)


def launch_key(causal: bool = True, window: int = 0,
               logit_cap: float = 0.0) -> str:
    """The ``build.LAUNCHES`` key a launch of this form counts under."""
    if not causal:
        return NONCAUSAL
    if logit_cap:
        return CAPPED_WINDOWED if window else CAPPED
    return "flash_attention"


_PTR, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: the C entry's arguments: q, k, v, o; B, Sq, Sk, H, KV, hd, q_offset,
#: k_len, window, causal; scale, logit_cap; q_bf16, kv_bf16; the decode
#: form's workspace, n_split and split_len; the stream
_ARGTYPES = ([_PTR] * 4 + [_I32] * 10 + [_F32, _F32, _I32, _I32]
             + [_PTR, _I32, _I32, _PTR])


@functools.cache
def _kernel():
    fn = LIBRARIES.get("attention").flash_attention
    fn.argtypes = _ARGTYPES
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
                    window: int = 0, causal: bool = True,
                    logit_cap: float = 0.0) -> torch.Tensor:
    """q (B, Sq, H, hd); k, v (B, Sk, KV, hd) of one dtype, float32 or
    bfloat16, on the card; q of k's dtype, or with Sq = 1 float32 over a
    bfloat16 k/v.  Query row i sits at position ``q_offset + i`` and sees
    key j when ``j < k_len`` (default Sk) and, if ``causal``, ``j <=
    q_offset + i`` and, with ``window`` > 0, ``q_offset + i - j <
    window``; its scores ``s`` become ``logit_cap * tanh(s / logit_cap)``
    when ``logit_cap`` > 0.  With Sq > 1, ``q_offset`` must be 0 and
    ``k_len`` Sk; with Sq = 1, hd one of ``DECODE_HEAD_DIMS`` and, with a
    window, ``q_offset = k_len - 1``.  Not ``causal``: Sq > 1 and no
    window.  Returns (B, Sq, H, hd) in q's dtype.

    Sq > 1 launches one kernel; Sq = 1 launches the split kernel over
    ``decode_splits(B, Sk, KV, window, SMs)`` and, with more than one
    split, the combine kernel, over a float32 workspace of
    ``B·KV·n_split·(H/KV)·(hd + 2)`` floats kept for this thread and
    stream (``_workspace``).  One count in ``build.LAUNCHES`` a call
    either way."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_attention takes (B, S, heads, hd) inputs")
    bsz, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    k_len = sk if k_len is None else int(k_len)
    q_offset, window = int(q_offset), int(window)
    logit_cap = float(logit_cap)
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention is built for head dims "
                         f"{HEAD_DIMS}, got {hd}")
    if q.dtype not in _TYPES or k.dtype not in _TYPES:
        raise ValueError(f"flash_attention takes float32 or bfloat16, got "
                         f"q {q.dtype}, k {k.dtype}")
    if q.dtype != k.dtype and (sq > 1
                               or k.dtype not in cache_dtypes(q.dtype)):
        raise ValueError(f"flash_attention: q and k/v of different dtypes "
                         f"({q.dtype}, {k.dtype}) are taken in the decode "
                         f"form only, as a float32 q over a bfloat16 cache")
    if min(bsz, sq, h, kvh) <= 0 or h % kvh:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if not 1 <= k_len <= sk or q_offset < 0:
        raise ValueError(f"flash_attention: k_len {k_len} must be in "
                         f"[1, {sk}] and q_offset {q_offset} >= 0")
    if sq > 1 and (q_offset, k_len) != (0, sk):
        raise ValueError(f"flash_attention: the prefill form (Sq {sq}) takes "
                         f"q_offset 0 and k_len {sk}, got {q_offset}, {k_len}")
    if window < 0 or (sq == 1 and window and q_offset != k_len - 1):
        raise ValueError(f"flash_attention: a window is >= 0, and the decode "
                         f"form takes one with its query at the cache's last "
                         f"valid position (q_offset {k_len - 1}), got window "
                         f"{window}, q_offset {q_offset}")
    if not logit_cap >= 0:
        raise ValueError(f"flash_attention: logit_cap must be >= 0 (0: "
                         f"none), got {logit_cap}")
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
    _check(k, "k", (bsz, sk, kvh, hd), k.dtype)
    _check(v, "v", (bsz, sk, kvh, hd), k.dtype)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    n_split = split_len = 0
    ws = None
    if sq == 1:
        n_split, split_len = decode_splits(bsz, sk, kvh, window,
                                           sm_count(q.device.index))
        if n_split > 1:
            ws = _workspace(bsz * kvh * n_split * (h // kvh) * (hd + 2),
                            q.device, stream)
    rc = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bsz, sq,
        sk, h, kvh, hd, q_offset, k_len, window, int(bool(causal)),
        hd ** -0.5, logit_cap, int(q.dtype == torch.bfloat16),
        int(k.dtype == torch.bfloat16), None if ws is None else ws.data_ptr(),
        n_split, split_len, stream)
    check_launch("flash_attention", rc)
    LAUNCHES.add(launch_key(causal, window, logit_cap))
    return out
