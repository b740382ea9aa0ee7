"""Dispatch for K1, the standalone K3 and K3's encoder form on the tensor's
device: the CUDA kernels for a CUDA tensor, the plain versions for a CPU
tensor, nothing else.  The codec's decoder calls K1, its encoder K3's
encoder form; ``codec/transform.py::apply_quality`` (the image-quality
roundtrip the profiler materializes with) calls the standalone K3, then
K1."""

import torch

from .dct8 import dct8_dequantize, dct8_encode_chunks, dct8_quantize
from .ref import (dct8_dequantize_ref, dct8_encode_chunks_ref,
                  dct8_quantize_ref)


def dct_quantize(frames: torch.Tensor, quant_scale) -> torch.Tensor:
    if frames.is_cuda:
        return dct8_quantize(frames, quant_scale)
    if frames.device.type == "cpu":
        return dct8_quantize_ref(frames, quant_scale)
    raise ValueError(f"no dct8 path for device {frames.device}")


def dct_dequantize(symbols: torch.Tensor, quant_scale) -> torch.Tensor:
    if symbols.is_cuda:
        return dct8_dequantize(symbols, quant_scale)
    if symbols.device.type == "cpu":
        return dct8_dequantize_ref(symbols, quant_scale)
    raise ValueError(f"no dct8 path for device {symbols.device}")


def dct_encode_chunks(frames_u8: torch.Tensor, k: int,
                      quant_scale) -> torch.Tensor:
    if frames_u8.is_cuda:
        return dct8_encode_chunks(frames_u8, k, quant_scale)
    if frames_u8.device.type == "cpu":
        return dct8_encode_chunks_ref(frames_u8, k, quant_scale)
    raise ValueError(f"no dct8 path for device {frames_u8.device}")
