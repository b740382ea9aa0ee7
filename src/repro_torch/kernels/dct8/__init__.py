"""dct8 kernels: K1 (dequantize + IDCT) and K3 (DCT + quantize)."""
