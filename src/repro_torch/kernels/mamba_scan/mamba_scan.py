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
#: lanes a channel's states are split across (``csrc/mamba_scan.cu``'s
#: ``kLanes``; ``geometry`` reports the build's own)
LANES = 2
_TYPES = (torch.float32, torch.bfloat16)
#: the C entries' arguments: ``mamba_scan``'s and ``mamba_scan_geometry``'s
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_GEOMETRY_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


@functools.cache
def _kernel():
    fn = LIBRARIES.get("mamba_scan").mamba_scan
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _geometry():
    fn = LIBRARIES.get("mamba_scan").mamba_scan_geometry
    fn.argtypes = _GEOMETRY_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def geometry(n: int, x_dtype: torch.dtype, bsz: int, inner: int) -> dict:
    """The launch the kernel makes on the current card at (bsz, S, inner,
    n) with ``xc`` in ``x_dtype``, as the loaded build reports it: lanes a
    channel, threads and channels a block, steps a chunk, the blocks of the
    grid, the most blocks an SM holds (CUDA's occupancy calculator), the
    warps an SM the grid gives, the waves it takes, and the kernel's
    registers and local-memory bytes a thread."""
    out = (ctypes.c_int * 7)()
    check_launch("mamba_scan_geometry",
                 _geometry()(n, int(x_dtype == torch.bfloat16), out))
    lanes, threads, channels, chunk, per_sm, regs, local = out
    blocks = bsz * -(-inner // channels)
    sms = torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count
    return {"lanes": lanes, "threads": threads, "channels": channels,
            "chunk": chunk, "blocks": blocks, "blocks_per_sm": per_sm,
            "warps_per_sm": min(per_sm, -(-blocks // sms)) * threads // 32,
            "waves": -(-blocks // (max(per_sm, 1) * sms)), "registers": regs,
            "local_bytes": local}


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
