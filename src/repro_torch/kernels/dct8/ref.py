"""Plain PyTorch versions of K1 and K3 (the codec's own transform path), on
any device.  The CPU path and the oracle the CUDA kernels are held
against."""

import torch

from ...codec import transform as T


def dct8_quantize_ref(frames: torch.Tensor, quant_scale) -> torch.Tensor:
    return T.frames_to_symbols(frames.to(torch.float32), quant_scale)


def dct8_dequantize_ref(symbols: torch.Tensor, quant_scale) -> torch.Tensor:
    return T.symbols_to_residuals(symbols, quant_scale)
