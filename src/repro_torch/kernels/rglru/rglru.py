"""K6: the RG-LRU linear recurrence as a hand-written CUDA kernel
(``csrc/rglru.cu``), replacing the Pallas kernel
``src/repro/kernels/rglru/rglru.py::rglru_scan``, and its gated form.

``rglru_scan``: ``h_t = a_t * h_{t-1} + b_t`` over (B, S, W), from an
optional initial state (B, W); with none it computes the TPU kernel's
function.  ``rglru_gated_scan``: the same recurrence with a and b formed
in the kernel's registers from the RG-LRU's gates (r, i, xc in the
activation dtype, ``a_param`` float32), in the roundings of
``ref.gated_ab``.  The RG-LRU mixer calls the gated form from zero for the
prefill and with S = 1 from the cached state for each decode step.

The wrappers take CUDA tensors only, check them, allocate the output with
``torch.empty``, launch on the current stream and raise if the launch was
refused.  The plain versions are in ``ref.py``; ``ops.py`` picks by
device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..build import LAUNCHES, LIBRARIES, check_launch

#: the gated form's activation dtypes, one kernel instance each
GATE_DTYPES = (torch.float32, torch.bfloat16)
#: the C entries' arguments: ``rglru_scan``'s and ``rglru_gated_scan``'s
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_GATED_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])


@functools.cache
def _kernel():
    fn = LIBRARIES.get("rglru").rglru_scan
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _gated_kernel():
    fn = LIBRARIES.get("rglru").rglru_gated_scan
    fn.argtypes = _GATED_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _meta(t: torch.Tensor, name: str, shape: tuple, dtypes,
          kernel: str) -> None:
    if tuple(t.shape) != shape or t.dtype not in dtypes:
        raise ValueError(f"{kernel}: {name} must be {shape} "
                         f"{'/'.join(map(str, dtypes))}, got "
                         f"{tuple(t.shape)} {t.dtype}")


def _check(t: torch.Tensor, name: str, shape: tuple, dtypes,
           kernel: str = "rglru_scan") -> None:
    if not t.is_cuda:
        raise ValueError(f"{kernel} needs CUDA tensors ({name})")
    _meta(t, name, shape, dtypes, kernel)
    if not t.is_contiguous() or t.data_ptr() % t.element_size():
        raise ValueError(f"{kernel}: {name} must be contiguous and "
                         f"aligned to its element")


def _shape(x: torch.Tensor, kernel: str) -> tuple:
    if x.dim() != 3:
        raise ValueError(f"{kernel} takes (B, S, W) inputs")
    if min(x.shape) <= 0:
        raise ValueError(f"{kernel}: empty input {tuple(x.shape)}")
    return tuple(x.shape)


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: torch.Tensor | None = None) -> torch.Tensor:
    """a, b (B, S, W) float32; h0 (B, W) float32 or None (zeros), on the
    card.  Returns h (B, S, W) float32 with ``h_t = a_t * h_{t-1} + b_t``,
    each step one fused multiply-add."""
    bsz, s, w = _shape(a, "rglru_scan")
    f32 = (torch.float32,)
    _check(a, "a", (bsz, s, w), f32)
    _check(b, "b", (bsz, s, w), f32)
    if h0 is not None:
        _check(h0, "h0", (bsz, w), f32)
    h = torch.empty_like(a)
    rc = _kernel()(a.data_ptr(), b.data_ptr(),
                   None if h0 is None else h0.data_ptr(), h.data_ptr(), bsz,
                   s, w, torch.cuda.current_stream(a.device).cuda_stream)
    check_launch("rglru_scan", rc)
    LAUNCHES.add("rglru_scan")
    return h


def rglru_gated_scan(r: torch.Tensor, i: torch.Tensor, xc: torch.Tensor,
                     a_param: torch.Tensor,
                     h0: torch.Tensor | None = None) -> torch.Tensor:
    """r, i, xc (B, S, W) in one of ``GATE_DTYPES``; a_param (W,) float32;
    h0 (B, W) float32 or None (zeros), on the card.  Returns h (B, S, W)
    float32: ``ref.gated_ab``'s a and b, formed in registers, scanned as
    ``rglru_scan`` scans them."""
    kernel = "rglru_gated_scan"
    bsz, s, w = _shape(r, kernel)
    if r.dtype not in GATE_DTYPES:
        raise ValueError(f"{kernel}: gates in {r.dtype}; the kernel takes "
                         f"{'/'.join(map(str, GATE_DTYPES))}")
    f32 = (torch.float32,)
    wanted = [(r, "r", (bsz, s, w), (r.dtype,)),
              (i, "i", (bsz, s, w), (r.dtype,)),
              (xc, "xc", (bsz, s, w), (r.dtype,)),
              (a_param, "a_param", (w,), f32)]
    if h0 is not None:
        wanted.append((h0, "h0", (bsz, w), f32))
    for t, *spec in wanted:  # shapes and types first, then the device
        _meta(t, *spec, kernel)
    for t, *spec in wanted:
        _check(t, *spec, kernel)
    h = torch.empty((bsz, s, w), dtype=torch.float32, device=r.device)
    rc = _gated_kernel()(
        r.data_ptr(), i.data_ptr(), xc.data_ptr(), a_param.data_ptr(),
        None if h0 is None else h0.data_ptr(), h.data_ptr(), bsz, s, w,
        int(r.dtype == torch.bfloat16),
        torch.cuda.current_stream(r.device).cuda_stream)
    check_launch(kernel, rc)
    LAUNCHES.add(kernel)
    return h
