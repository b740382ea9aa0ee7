"""Port of ``repro/codec/transform.py``: 8x8 block DCT, quantization and
fidelity conversion (crop / resize / temporal sampling) on tensors.

Every function follows the device of the tensor it is given.  The block
transforms here (``frames_to_symbols``, ``symbols_to_residuals``) are the
plain PyTorch formulation -- the reference's two GEMMs per block, each
8-term dot summed in the order XLA:CPU sums it (``_dot8``), so symbols and
residuals equal the reference's bit for bit -- and serve as the oracle of
the CUDA kernels in ``repro_torch.kernels.dct8``, which sum in the same
order and which the codec's hot path calls through ``kernels.dct8.ops``.
``resize`` goes through ``kernels.resize.ops``: the hand-written K2 kernel
on the card, its plain version on the CPU; ``apply_quality`` runs the
standalone K3 and then K1 through ``kernels.dct8.ops`` the same way.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..kernels.resize import ops as resize_ops

BLOCK = 8


@functools.cache
def dct_basis() -> np.ndarray:
    """Orthonormal 8x8 DCT-II basis matrix D (D @ D.T = I)."""
    k = np.arange(BLOCK)[:, None]
    n = np.arange(BLOCK)[None, :]
    d = np.cos(np.pi * (2 * n + 1) * k / (2 * BLOCK))
    d[0] *= 1.0 / np.sqrt(2)
    d *= np.sqrt(2.0 / BLOCK)
    return d.astype(np.float32)


@functools.cache
def quant_table() -> np.ndarray:
    """JPEG-like base quantization table scaled to unit DC step: higher
    frequencies quantized more coarsely."""
    i = np.arange(BLOCK)[:, None]
    j = np.arange(BLOCK)[None, :]
    return (1.0 + (i + j) * 1.5).astype(np.float32)


@functools.cache
def basis_on(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(D, quant_table) as float32 tensors on ``device``, made once."""
    return (torch.from_numpy(dct_basis()).to(device),
            torch.from_numpy(quant_table()).to(device))


def _dot8(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``a @ m`` for (M, 8) x (8, 8) float32, each 8-term dot summed the way
    XLA:CPU sums it: four fused multiply-add chains over the term pairs
    (j, j+4), added pairwise, ``(c0 + c1) + (c2 + c3)``.  A plain GEMM sums
    in another order, and its last-bit differences flip quantized symbols
    that fall on a rounding tie (integer pixels make ties common).  The
    fused multiply-add is emulated in float64, where the product is exact:
    one float64 add, then one rounding to float32."""
    a64, m64 = a.to(torch.float64), m.to(torch.float64)
    c = [(a64[:, j + 4:j + 5] * m64[j + 4]
          + (a64[:, j:j + 1] * m64[j]).to(torch.float32).to(torch.float64)
          ).to(torch.float32) for j in range(4)]
    return (c[0] + c[1]) + (c[2] + c[3])


def to_blocks(frames: torch.Tensor) -> torch.Tensor:
    """(n, h, w) -> (n, h//8, w//8, 8, 8)."""
    n, h, w = frames.shape
    x = frames.reshape(n, h // BLOCK, BLOCK, w // BLOCK, BLOCK)
    return x.permute(0, 1, 3, 2, 4)


def from_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """(n, hb, wb, 8, 8) -> (n, h, w)."""
    n, hb, wb, _, _ = blocks.shape
    return blocks.permute(0, 1, 3, 2, 4).reshape(n, hb * BLOCK, wb * BLOCK)


def quantize(coefs: torch.Tensor, quant_scale: float) -> torch.Tensor:
    q = basis_on(coefs.device)[1] * np.float32(quant_scale)
    return torch.round(coefs / q).to(torch.int16)  # half-to-even


def dequantize(symbols: torch.Tensor, quant_scale: float) -> torch.Tensor:
    q = basis_on(symbols.device)[1] * np.float32(quant_scale)
    return symbols.to(torch.float32) * q


def frames_to_symbols(frames: torch.Tensor,
                      quant_scale: float) -> torch.Tensor:
    """Blocking + DCT + quantize for a frame stack: (n, h, w) float32 ->
    (n, hb, wb, 8, 8) int16 (``round(D·X·Dᵀ / (qt·qs))`` per block)."""
    n, h, w = frames.shape
    hb, wb = h // BLOCK, w // BLOCK
    d = basis_on(frames.device)[0]
    x = frames.reshape(n, hb, BLOCK, wb, BLOCK)
    tmp = x.permute(0, 1, 3, 4, 2)                        # (n, hb, wb, k, j)
    tmp = _dot8(tmp.reshape(-1, BLOCK), d.T).reshape(n, hb, wb, BLOCK, BLOCK)
    tmp = tmp.transpose(3, 4)                             # (n, hb, wb, i, k)
    coef = _dot8(tmp.reshape(-1, BLOCK), d.T).reshape(n, hb, wb, BLOCK, BLOCK)
    return quantize(coef, quant_scale)


def symbols_to_residuals(symbols: torch.Tensor,
                         quant_scale: float) -> torch.Tensor:
    """Dequantize + IDCT + de-blocking for a frame stack:
    (n, hb, wb, 8, 8) int16 -> (n, h, w) float32 (``Dᵀ·C·D`` per block)."""
    n, hb, wb = symbols.shape[:3]
    d = basis_on(symbols.device)[0]
    coef = dequantize(symbols, quant_scale)
    tmp = coef.reshape(-1, BLOCK, BLOCK).transpose(1, 2)
    tmp = _dot8(tmp.reshape(-1, BLOCK), d).reshape(n, hb, wb, BLOCK, BLOCK)
    tmp = tmp.permute(0, 1, 4, 2, 3)                      # (n, hb, i, wb, k)
    out = _dot8(tmp.reshape(-1, BLOCK), d)                # rows (n,hb,i,wb)
    return out.reshape(n, hb * BLOCK, wb * BLOCK)


# ---------------------------------------------------------------------------
# Fidelity conversion
# ---------------------------------------------------------------------------

def sample_indices(n_total: int, sampling: float) -> np.ndarray:
    """Deterministic frame-sampling index set (monotone in ``sampling``)."""
    n_keep = max(1, round(n_total * sampling))
    return np.floor(np.arange(n_keep) * (n_total / n_keep)).astype(np.int64)


def center_crop(frames: torch.Tensor, crop: float) -> torch.Tensor:
    """Central crop to ``crop`` fraction on both axes, snapped to x8."""
    if crop >= 1.0:
        return frames
    n, h, w = frames.shape
    ch = max(8, int(round(h * crop / 8)) * 8)
    cw = max(8, int(round(w * crop / 8)) * 8)
    top, left = (h - ch) // 2, (w - cw) // 2
    return frames[:, top:top + ch, left:left + cw]


def resize(frames: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Antialiased bilinear resize of an (n, h1, w1) stack, the function
    ``jax.image.resize(..., "bilinear")`` computes; identity when the
    shape already matches."""
    if tuple(frames.shape[1:]) == (h, w):
        return frames
    return resize_ops.resize(frames.to(torch.float32).contiguous(), h, w)


def apply_quality(frames_u8, quant_scale: float) -> torch.Tensor:
    """Intra-frame quantization roundtrip -- the image-quality knob's effect
    on pixels, used when materializing consumption-fidelity samples for
    profiling: ``clip(round(IDCT(dequantize(quantize(DCT(blocks))))))`` to
    uint8, the identity for ``quant_scale <= 1``.  One launch of the
    standalone K3 and one of K1 on a CUDA tensor, their plain versions on a
    CPU tensor (``kernels.dct8.ops``)."""
    frames = torch.as_tensor(frames_u8)
    if quant_scale <= 1.0:
        return frames.to(torch.uint8)
    # deferred: kernels.dct8 imports this module
    from ..kernels.dct8.ops import dct_dequantize, dct_quantize
    sym = dct_quantize(frames.to(torch.float32).contiguous(), quant_scale)
    x = dct_dequantize(sym, quant_scale)
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)


def materialize(frames_u8, cf, spec, src=None) -> torch.Tensor:
    """Ingest-fidelity frames -> consumption-fidelity frames (sampling,
    crop, resolution, then image-quality loss), on the frames' device."""
    from ..core.knobs import FidelityOption
    src = src or FidelityOption()
    out = convert_fidelity(frames_u8, src, cf, spec)
    return apply_quality(out, cf.quant_scale)


def temporal_indices(f_from, f_to, spec) -> np.ndarray:
    """Indices into a segment stored at fidelity ``f_from`` that realize the
    (sparser) sampling of ``f_to`` -- the stored frames nearest to the
    target timeline points.  These drive chunk-skip decoding."""
    n_from, _, _ = spec.resolve(f_from)
    n_to, _, _ = spec.resolve(f_to)
    if n_to == n_from:
        return np.arange(n_from)
    src_pos = sample_indices(spec.frames_per_segment, f_from.sampling)
    dst_pos = sample_indices(spec.frames_per_segment, f_to.sampling)
    nearest = np.searchsorted(src_pos, dst_pos, side="right") - 1
    return np.clip(nearest, 0, n_from - 1)


def spatial_convert(frames: torch.Tensor, f_from, f_to, spec) -> torch.Tensor:
    """Crop + resize a (temporally sampled) frame stack from ``f_from``'s
    grid to ``f_to``'s.  Returns uint8 on the frames' device."""
    _, h_to, w_to = spec.resolve(f_to)
    rel_crop = f_to.crop / f_from.crop
    x = center_crop(frames.to(torch.float32), min(1.0, rel_crop))
    x = resize(x, h_to, w_to)
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)


def convert_fidelity(frames_u8, f_from, f_to, spec) -> torch.Tensor:
    """Convert a segment from fidelity ``f_from`` to ``f_to`` (temporal
    re-sampling, central re-crop, spatial resize).  ``f_from`` must be
    richer-than-or-equal ``f_to`` (R1).  Returns uint8 frames shaped per
    ``spec.resolve(f_to)``, on the input's device."""
    if not f_from.richer_eq(f_to):
        raise ValueError(f"fidelity {f_from.name()} cannot serve {f_to.name()}")
    n_from, _, _ = spec.resolve(f_from)
    frames = torch.as_tensor(frames_u8)
    if frames.shape[0] != n_from:
        raise ValueError(f"segment has {frames.shape[0]} frames, spec says {n_from}")
    idx = temporal_indices(f_from, f_to, spec)
    if len(idx) != n_from:
        frames = frames[torch.from_numpy(idx).to(frames.device)]
    return spatial_convert(frames, f_from, f_to, spec)
