"""K6: the RG-LRU linear recurrence as a hand-written CUDA kernel
(``csrc/rglru.cu``), replacing the Pallas kernel
``src/repro/kernels/rglru/rglru.py::rglru_scan``.

``h_t = a_t * h_{t-1} + b_t`` over (B, S, W), from an optional initial
state (B, W); with none it computes the TPU kernel's function.  The
RG-LRU mixer calls it from zero for the prefill and with S = 1 from the
cached state for each decode step.

The wrapper takes CUDA tensors only, checks them, allocates the output with
``torch.empty``, launches on the current stream and raises if the launch
was refused.  The plain version is in ``ref.py``; ``ops.py`` picks by
device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..build import LAUNCHES, LIBRARIES, check_launch


@functools.cache
def _kernel():
    fn = LIBRARIES.get("rglru").rglru_scan
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr] * 4 + [i32] * 3 + [ptr]
    fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, shape: tuple) -> None:
    if not t.is_cuda:
        raise ValueError(f"rglru_scan needs CUDA tensors ({name})")
    if tuple(t.shape) != shape or t.dtype != torch.float32:
        raise ValueError(f"rglru_scan: {name} must be {shape} float32, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if not t.is_contiguous() or t.data_ptr() % 4:
        raise ValueError(f"rglru_scan: {name} must be contiguous and "
                         f"4-byte aligned")


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: torch.Tensor | None = None) -> torch.Tensor:
    """a, b (B, S, W) float32; h0 (B, W) float32 or None (zeros), on the
    card.  Returns h (B, S, W) float32 with ``h_t = a_t * h_{t-1} + b_t``,
    each step one fused multiply-add."""
    if a.dim() != 3:
        raise ValueError("rglru_scan takes (B, S, W) inputs")
    bsz, s, w = a.shape
    if min(bsz, s, w) <= 0:
        raise ValueError(f"rglru_scan: empty input {tuple(a.shape)}")
    _check(a, "a", (bsz, s, w))
    _check(b, "b", (bsz, s, w))
    if h0 is not None:
        _check(h0, "h0", (bsz, w))
    h = torch.empty_like(a)
    rc = _kernel()(a.data_ptr(), b.data_ptr(),
                   None if h0 is None else h0.data_ptr(), h.data_ptr(), bsz,
                   s, w, torch.cuda.current_stream(a.device).cuda_stream)
    check_launch("rglru_scan", rc)
    LAUNCHES.add("rglru_scan")
    return h
