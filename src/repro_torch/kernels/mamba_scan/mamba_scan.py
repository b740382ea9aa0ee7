"""K5: the Mamba-1 selective scan as a hand-written CUDA kernel
(``csrc/mamba_scan.cu``), replacing the Pallas kernel
``src/repro/kernels/mamba_scan/mamba_scan.py::mamba_scan``.

The TPU kernel scans ``da``/``dbx`` of shape (B, S, inner, n) that its
caller formed; this one takes what ``mamba_mix``'s step scan scans --
``delta``, ``xc`` (B, S, inner), ``bmat``, ``cmat`` (B, S, n), ``a``
(inner, n) and an initial state -- and forms the discretisation in
registers.  With no initial state it computes the TPU kernel's function.

The wrapper takes CUDA tensors only, checks them, allocates the outputs
with ``torch.empty``, launches on the current stream and raises if the
launch was refused.  The plain version is in ``ref.py``; ``ops.py`` picks
by device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..build import LAUNCHES, LIBRARIES, check_launch

#: state sizes the kernel is instantiated for (reduced configs use 8,
#: Falcon-Mamba-7B 16)
STATE_DIMS = (8, 16)
_TYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _kernel():
    fn = LIBRARIES.get("mamba_scan").mamba_scan
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr] * 8 + [i32] * 5 + [ptr]
    fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, shape: tuple, dtypes):
    if not t.is_cuda:
        raise ValueError(f"mamba_scan needs CUDA tensors ({name})")
    if tuple(t.shape) != shape or t.dtype not in dtypes:
        raise ValueError(f"mamba_scan: {name} must be {shape} "
                         f"{'/'.join(map(str, dtypes))}, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"mamba_scan: {name} must be contiguous")


def mamba_scan(delta: torch.Tensor, xc: torch.Tensor, bmat: torch.Tensor,
               cmat: torch.Tensor, a: torch.Tensor,
               h0: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """delta (B, S, inner) f32; xc (B, S, inner), bmat, cmat (B, S, n) of
    one dtype, f32/bf16; a (inner, n) f32; h0 (B, inner, n) f32 or None
    (zeros).  Returns y (B, S, inner) f32 and the final state (B, inner, n)
    f32, on the card."""
    if delta.dim() != 3 or bmat.dim() != 3:
        raise ValueError("mamba_scan takes (B, S, inner) and (B, S, n) inputs")
    bsz, s, inner = delta.shape
    n = bmat.shape[-1]
    if n not in STATE_DIMS:
        raise ValueError(f"mamba_scan is built for state sizes {STATE_DIMS}, "
                         f"got {n}")
    if bsz == 0 or inner == 0:
        raise ValueError(f"mamba_scan: empty batch or width {tuple(delta.shape)}")
    _check(delta, "delta", (bsz, s, inner), (torch.float32,))
    _check(xc, "xc", (bsz, s, inner), _TYPES)
    _check(bmat, "bmat", (bsz, s, n), (xc.dtype,))
    _check(cmat, "cmat", (bsz, s, n), (xc.dtype,))
    _check(a, "a", (inner, n), (torch.float32,))
    if h0 is not None:
        _check(h0, "h0", (bsz, inner, n), (torch.float32,))
    dev = delta.device
    y = torch.empty((bsz, s, inner), dtype=torch.float32, device=dev)
    h_t = torch.empty((bsz, inner, n), dtype=torch.float32, device=dev)
    rc = _kernel()(
        delta.data_ptr(), xc.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
        a.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
        h_t.data_ptr(), bsz, s, inner, n, int(xc.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch("mamba_scan", rc)
    LAUNCHES.add("mamba_scan")
    return y, h_t
