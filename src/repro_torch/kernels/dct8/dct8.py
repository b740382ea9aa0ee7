"""K1 and K3: the codec's 8x8 block transforms as hand-written CUDA kernels
(``csrc/dct8.cu``), replacing the Pallas kernels
``src/repro/kernels/dct8/dct8.py::dct8_dequantize`` (K1) and
``::dct8_quantize`` (K3), and K3's encoder form ``dct8_encode_chunks``,
which runs the reference's whole encoder scan over K3 and K1
(``src/repro/codec/segment.py::_encode_chunk``) for every chunk of a
segment in one launch.

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


#: the C entry ``dct8_encode_chunks``'s arguments
_ENCODE_ARGTYPES = [ctypes.c_void_p] * 4 + [
    ctypes.c_float, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p]


@functools.cache
def _encode_kernel():
    fn = LIBRARIES.get("dct8").dct8_encode_chunks
    fn.argtypes = _ENCODE_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
           frame_dims: tuple = ()):
    """Type and rank, then the ``frame_dims`` that must be multiples of 8,
    then the device, contiguity and alignment."""
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name} takes a {ndim}-d {dtype} tensor, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if any(t.shape[d] % BLOCK for d in frame_dims):
        raise ValueError(f"{name}: frame {tuple(t.shape[1:])} is not a "
                         f"multiple of {BLOCK}")
    if not t.is_cuda:
        raise ValueError(f"{name} needs a CUDA tensor")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} needs a contiguous 16-byte aligned tensor")


def dct8_quantize(frames: torch.Tensor, quant_scale: float) -> torch.Tensor:
    """(n, h, w) float32 -> (n, h//8, w//8, 8, 8) int16 quantized symbols."""
    _check(frames, "dct8_quantize", torch.float32, 3, (1, 2))
    n, h, w = frames.shape
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


def dct8_encode_chunks(frames_u8: torch.Tensor, k: int,
                       quant_scale: float) -> torch.Tensor:
    """(n, h, w) uint8 -> (ceil(n/k), min(k, n), h//8, w//8, 8, 8) int16:
    chunk c DPCM-codes frames ``c*k ..`` from a mid-grey prediction, a short
    tail chunk repeating its last frame, every chunk in one launch."""
    _check(frames_u8, "dct8_encode_chunks", torch.uint8, 3, (1, 2))
    if k < 1:
        raise ValueError(f"dct8_encode_chunks: keyframe interval {k} < 1")
    n, h, w = frames_u8.shape
    dev = frames_u8.device
    out = torch.empty((-(-n // k), min(k, n), h // BLOCK, w // BLOCK, BLOCK,
                       BLOCK), dtype=torch.int16, device=dev)
    if n == 0:
        return out
    d, qt = basis_on(dev)
    rc = _encode_kernel()(
        frames_u8.data_ptr(), out.data_ptr(), d.data_ptr(), qt.data_ptr(),
        float(np.float32(quant_scale)), n, h, w, k,
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch("dct8_encode_chunks", rc)
    LAUNCHES.add("dct8_encode_chunks")
    return out
