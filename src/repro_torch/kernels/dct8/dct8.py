"""K1 and K3: the codec's 8x8 block transforms as hand-written CUDA kernels
(``csrc/dct8.cu``), replacing the Pallas kernels
``src/repro/kernels/dct8/dct8.py::dct8_dequantize`` (K1) and
``::dct8_quantize`` (K3).

The wrappers take CUDA tensors only, check them, allocate the output with
``torch.empty``, launch on the current stream and raise if the launch was
refused.  The plain versions are in ``ref.py``; ``ops.py`` picks by device.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ...codec.transform import BLOCK, basis_on
from ..build import LAUNCHES, LIBRARIES, check_launch


@functools.cache
def _kernel(symbol: str):
    fn = getattr(LIBRARIES.get("dct8"), symbol)
    ptr = ctypes.c_void_p
    fn.argtypes = [ptr, ptr, ptr, ptr, ctypes.c_float, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ptr]
    fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int):
    if not t.is_cuda:
        raise ValueError(f"{name} needs a CUDA tensor")
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name} takes a {ndim}-d {dtype} tensor, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} needs a contiguous 16-byte aligned tensor")


def dct8_quantize(frames: torch.Tensor, quant_scale: float) -> torch.Tensor:
    """(n, h, w) float32 -> (n, h//8, w//8, 8, 8) int16 quantized symbols."""
    _check(frames, "dct8_quantize", torch.float32, 3)
    n, h, w = frames.shape
    if h % BLOCK or w % BLOCK:
        raise ValueError(f"frame {h}x{w} is not a multiple of {BLOCK}")
    hb, wb = h // BLOCK, w // BLOCK
    dev = frames.device
    d, qt = basis_on(dev)
    out = torch.empty((n, hb, wb, BLOCK, BLOCK), dtype=torch.int16,
                      device=dev)
    rc = _kernel("dct8_quantize")(
        frames.data_ptr(), out.data_ptr(), d.data_ptr(), qt.data_ptr(),
        float(np.float32(quant_scale)), n, hb, wb,
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch("dct8_quantize", rc)
    LAUNCHES.add("dct8_quantize")
    return out


def dct8_dequantize(symbols: torch.Tensor, quant_scale: float) -> torch.Tensor:
    """(n, hb, wb, 8, 8) int16 -> (n, 8·hb, 8·wb) float32 reconstruction."""
    _check(symbols, "dct8_dequantize", torch.int16, 5)
    n, hb, wb = symbols.shape[:3]
    if tuple(symbols.shape[3:]) != (BLOCK, BLOCK):
        raise ValueError(f"symbols must end in ({BLOCK}, {BLOCK}) blocks")
    dev = symbols.device
    d, qt = basis_on(dev)
    out = torch.empty((n, hb * BLOCK, wb * BLOCK), dtype=torch.float32,
                      device=dev)
    rc = _kernel("dct8_dequantize")(
        symbols.data_ptr(), out.data_ptr(), d.data_ptr(), qt.data_ptr(),
        float(np.float32(quant_scale)), n, hb, wb,
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch("dct8_dequantize", rc)
    LAUNCHES.add("dct8_dequantize")
    return out
