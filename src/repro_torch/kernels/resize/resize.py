"""K2: antialiased bilinear resize as a hand-written CUDA kernel
(``csrc/resize.cu``), replacing the Pallas kernel
``src/repro/kernels/resize/resize.py::resize_bilinear``.

``interp_matrix`` is the port's copy of the reference's weight matrix, here
computed the way ``jax.image.resize(..., "bilinear")`` computes it under
``jit`` (float32 sample positions, column-normalised triangle filter, in
XLA's arithmetic), so the port matches that function and not only the
reference kernel's float64 weights.  The
kernel takes the band of each matrix (``band``): per output row a start
index and at most ``2·ceil(support)+1`` weights.  ``tile_plan`` is the
host's twin of the kernel's tile plan (``csrc/resize.cu::resize_plan``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..build import LAUNCHES, LIBRARIES, check_launch


def _xla_column_sums(w: np.ndarray) -> np.ndarray:
    """Column sums of ``w`` (n_in, n_out) float32 in the order XLA:CPU
    computes ``jnp.sum(w, axis=0)``: while more than 32 rows remain, rows
    are zero-padded evenly on both ends to a multiple of 32 and each run of
    32 is summed in order (the tree-reduction rewrite into reduce-windows);
    the last <= 32 partial sums are then added in order."""
    while w.shape[0] > 32:
        n = w.shape[0]
        m = -(-n // 32)
        lo = (m * 32 - n) // 2
        padded = np.zeros((m * 32, w.shape[1]), np.float32)
        padded[lo:lo + n] = w
        acc = np.zeros((m, w.shape[1]), np.float32)
        for j in range(32):
            acc = acc + padded[j::32]
        w = acc
    acc = np.zeros(w.shape[1], np.float32)
    for row in w:
        acc = acc + row
    return acc[None, :]


@functools.cache
def interp_matrix(n_out: int, n_in: int) -> np.ndarray:
    """(n_out, n_in) float32 interpolation weights of
    ``jax.image.resize(..., "bilinear")`` along one axis (antialiased
    triangle filter: support widens by the downscale factor; each output's
    weights normalised to sum 1), in the arithmetic XLA compiles that
    function's weights to under ``jit``: the division by the kernel scale
    becomes a multiply by its float32 reciprocal, and the normalising sums
    take XLA:CPU's reduction order (``_xla_column_sums``)."""
    if n_out == n_in:
        return np.eye(n_out, dtype=np.float32)
    inv_scale = 1.0 / (n_out / n_in)
    inv_kernel_scale = np.float32(1) / np.float32(max(inv_scale, 1.0))
    sample_f = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5))
                * np.float32(inv_scale) - np.float32(0.5))
    x = np.abs(sample_f[None, :]
               - np.arange(n_in, dtype=np.float32)[:, None]) * inv_kernel_scale
    w = np.maximum(np.float32(0), np.float32(1) - x)  # (n_in, n_out)
    total = _xla_column_sums(w)
    ok = np.abs(total) > 1000.0 * np.finfo(np.float32).eps
    w = np.where(ok, w / np.where(total != 0, total, np.float32(1)),
                 np.float32(0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    w = np.where(inside[None, :], w, np.float32(0))
    return np.ascontiguousarray(w.T.astype(np.float32))


@functools.cache
def band(n_out: int, n_in: int) -> tuple[np.ndarray, np.ndarray]:
    """The band of ``interp_matrix(n_out, n_in)``: ``(start, weights)``
    with ``start`` (n_out,) int32 and ``weights`` (n_out, taps) float32,
    ``taps`` the widest row's span; a narrower row is zero-padded and its
    start shifted so that ``start + taps <= n_in``."""
    m = interp_matrix(n_out, n_in)
    nz = m != 0
    first = np.where(nz.any(axis=1), nz.argmax(axis=1), 0)
    last = np.where(nz.any(axis=1), n_in - 1 - nz[:, ::-1].argmax(axis=1), 0)
    taps = int(max(1, (last - first + 1).max()))
    start = np.clip(np.minimum(first, n_in - taps), 0, None).astype(np.int32)
    cols = start[:, None] + np.arange(taps)[None, :]
    weights = np.take_along_axis(m, np.minimum(cols, n_in - 1), axis=1)
    weights = np.where(cols < n_in, weights, 0).astype(np.float32)
    return start, np.ascontiguousarray(weights)


#: ``csrc/resize.cu``'s tile: output rows, output columns before narrowing,
#: threads a block; shared memory a block takes without opting in, and most
TILE_ROWS, TILE_COLS, THREADS = 16, 128, 256
SMEM_DEFAULT, SMEM_MAX = 48 * 1024, 232448


def column_span(n_out: int, n_in: int, taps: int, tw: int) -> int:
    """Input columns of the widest column band ``[start[j0], start[j_last]
    + taps)`` of a tile of ``tw`` outputs of ``band(n_out, n_in)``:
    ``start`` rises by at most ``ceil(d·n_in/n_out)`` over ``d`` outputs,
    plus one for its float32 rounding."""
    d = min(tw, n_out) - 1
    return min(n_in, -(-d * n_in // n_out) + taps + 1)


def tile_plan(n_out: int, n_in: int, taps: int) -> tuple[int, int, int]:
    """The tile K2 launches for an output row of ``n_out`` columns from
    ``n_in`` with ``taps`` taps, as ``csrc/resize.cu::resize_plan`` plans
    it: ``(tw, span, smem)``, the output columns of a tile, the input
    columns of its widest band and the block's shared memory in bytes
    (``TILE_ROWS`` rows of ``span`` float32 sums).  ``tw`` halves from
    ``TILE_COLS`` while the band overflows ``SMEM_DEFAULT``, down to
    ``THREADS // TILE_ROWS``; past that the kernel opts in to more, up to
    ``SMEM_MAX``."""
    tw = TILE_COLS
    while True:
        span = column_span(n_out, n_in, taps, tw)
        smem = TILE_ROWS * span * 4
        if smem <= SMEM_DEFAULT or tw == THREADS // TILE_ROWS:
            return tw, span, smem
        tw //= 2


def kernel_tile_plan(n_out: int, n_in: int, taps: int) -> tuple[int, int,
                                                                 int]:
    """``tile_plan`` as the built ``csrc/resize.cu`` computes it (its
    ``resize_plan``), so that a test holds the two twins equal; compiles
    the library on first use."""
    fn = LIBRARIES.get("resize").resize_plan
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    plan = (ctypes.c_longlong * 3)()
    fn(n_in, n_out, taps, plan)
    return tuple(plan)


@functools.cache
def _band_on(n_out: int, n_in: int, device: torch.device):
    start, weights = band(n_out, n_in)
    return (torch.from_numpy(start).to(device),
            torch.from_numpy(weights).to(device), weights.shape[1])


_P, _I32 = ctypes.c_void_p, ctypes.c_int
#: the C entry's arguments: x, out, n, h1, w1, h2, w2, y0, wy, ty, x0, wx,
#: tx, stream
_ARGTYPES = [_P, _P, ctypes.c_longlong, _I32, _I32, _I32, _I32, _P, _P, _I32,
             _P, _P, _I32, _P]


@functools.cache
def _kernel():
    fn = LIBRARIES.get("resize").resize_bilinear
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def resize_bilinear(frames: torch.Tensor, h2: int, w2: int) -> torch.Tensor:
    """(n, h1, w1) float32 on the card -> (n, h2, w2) float32."""
    if not frames.is_cuda:
        raise ValueError("resize_bilinear needs a CUDA tensor")
    if frames.dtype != torch.float32 or frames.dim() != 3:
        raise ValueError(f"resize_bilinear takes (n, h, w) float32, got "
                         f"{tuple(frames.shape)} {frames.dtype}")
    if not frames.is_contiguous():
        raise ValueError("resize_bilinear needs a contiguous tensor")
    if h2 <= 0 or w2 <= 0:
        raise ValueError(f"bad output shape {(h2, w2)}")
    n, h1, w1 = frames.shape
    dev = frames.device
    y0, wy, ty = _band_on(h2, h1, dev)
    x0, wx, tx = _band_on(w2, w1, dev)
    out = torch.empty((n, h2, w2), dtype=torch.float32, device=dev)
    rc = _kernel()(frames.data_ptr(), out.data_ptr(), n, h1, w1, h2, w2,
                   y0.data_ptr(), wy.data_ptr(), ty, x0.data_ptr(),
                   wx.data_ptr(), tx, torch.cuda.current_stream(dev).cuda_stream)
    check_launch("resize_bilinear", rc)
    LAUNCHES.add("resize_bilinear")
    return out
