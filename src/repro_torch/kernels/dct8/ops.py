"""Dispatch for K1/K3 on the tensor's device: the CUDA kernels for a CUDA
tensor, the plain versions for a CPU tensor, nothing else.  The codec's
encoder and decoder call these."""

import torch

from .dct8 import dct8_dequantize, dct8_quantize
from .ref import dct8_dequantize_ref, dct8_quantize_ref


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
