"""Plain PyTorch versions of K1 and K3 (the codec's own transform path) and
of K3's encoder form, on any device.  The CPU path and the oracle the CUDA
kernels are held against."""

import numpy as np
import torch

from ...codec import transform as T

def dct8_quantize_ref(frames: torch.Tensor, quant_scale) -> torch.Tensor:
    return T.frames_to_symbols(frames.to(torch.float32), quant_scale)


def dct8_dequantize_ref(symbols: torch.Tensor, quant_scale) -> torch.Tensor:
    return T.symbols_to_residuals(symbols, quant_scale)


def k3_holds(got: torch.Tensor, want: torch.Tensor) -> tuple[bool, int]:
    """K3's bound against its plain version, for either form: at most 1e-6
    of the symbols differ, each by one.  Returns (holds, symbols that
    differ)."""
    d = (got.int() - want.int()).abs()
    n_diff = int((d > 0).sum())
    return int(d.max()) <= 1 and n_diff <= 1e-6 * d.numel(), n_diff


def chunk_rows(n: int, k: int) -> np.ndarray:
    """(ceil(n/k), min(k, n)) frame index of chunk c's step t: ``c*k + t``,
    a short tail chunk repeating its last frame."""
    starts = np.arange(0, n, k)
    last = np.minimum(starts + k, n) - 1
    return np.minimum(starts[:, None] + np.arange(min(k, n)), last[:, None])


def encode_chunks_stepped(frames_u8: torch.Tensor, k: int, quant_scale,
                          quantize=dct8_quantize_ref,
                          dequantize=dct8_dequantize_ref) -> torch.Tensor:
    """The DPCM encoder stepped one frame position at a time over every
    chunk of a segment: (n, h, w) uint8 -> (ceil(n/k), min(k, n), h/8, w/8,
    8, 8) int16, chunk c holding frames ``chunk_rows(n, k)[c]``.  Step t
    codes frame t of every chunk through ``quantize`` (K3) and
    ``dequantize`` (K1): their plain versions, or on the card their
    kernels' wrappers (the stepped route the encoder form replaced)."""
    n, h, w = frames_u8.shape
    rows = torch.from_numpy(chunk_rows(n, k)).to(frames_u8.device)
    out = torch.empty((*rows.shape, h // T.BLOCK, w // T.BLOCK, T.BLOCK,
                       T.BLOCK), dtype=torch.int16, device=frames_u8.device)
    pred = torch.full((rows.shape[0], h, w), 128.0, dtype=torch.float32,
                      device=frames_u8.device)
    for t in range(rows.shape[1]):
        resid = (frames_u8[rows[:, t]].to(torch.float32) - pred).contiguous()
        sym = quantize(resid, quant_scale)
        pred = torch.clamp(pred + dequantize(sym, quant_scale), 0.0, 255.0)
        out[:, t] = sym
    return out


def dct8_encode_chunks_ref(frames_u8: torch.Tensor, k: int,
                           quant_scale) -> torch.Tensor:
    return encode_chunks_stepped(frames_u8, k, quant_scale)


#: defects of the encoder that its checks must see: the prediction reset
#: to mid-grey every frame, the reconstruction left unclamped, a short tail
#: chunk padded with mid-grey frames rather than its last frame
ENCODE_MUTANTS = ("prediction reset every frame", "clamp dropped",
                  "tail padded with mid-grey")


def encode_mutant(mutant: str, frames_u8: torch.Tensor, k: int,
                  quant_scale) -> torch.Tensor:
    """The plain encoder's symbols with the defect ``mutant`` (one of
    ``ENCODE_MUTANTS``), in its layout.  A prediction reset every frame
    codes each frame as a chunk of one; a grey tail is the plain encoder
    on frames padded with mid-grey to whole chunks; the unclamped
    reconstruction runs its own loop."""
    n, h, w = frames_u8.shape
    rows = torch.from_numpy(chunk_rows(n, k)).to(frames_u8.device)
    if mutant == "prediction reset every frame":
        return encode_chunks_stepped(frames_u8, 1, quant_scale)[rows, 0]
    if mutant == "tail padded with mid-grey":
        grey = torch.full((rows.numel() - n, h, w), 128,
                          dtype=torch.uint8, device=frames_u8.device)
        return encode_chunks_stepped(torch.cat([frames_u8, grey]), k,
                                     quant_scale)
    if mutant == "clamp dropped":
        pred = torch.full((rows.shape[0], h, w), 128.0,
                          device=frames_u8.device)
        out = []
        for t in range(rows.shape[1]):
            out.append(dct8_quantize_ref(frames_u8[rows[:, t]] - pred,
                                         quant_scale))
            pred = pred + dct8_dequantize_ref(out[-1], quant_scale)
        return torch.stack(out, 1)
    raise ValueError(f"unknown encoder mutant {mutant!r}")


def encode_inputs(n: int, h: int, w: int, seed: int,
                  device="cpu") -> torch.Tensor:
    """(n, h, w) uint8 frames for the encoder's checks, from ``seed``: a
    moving smooth field with noise, and in every frame a black and a white
    11x11 square off the 8x8 grid, whose edges ring past 0 and 255 in the
    reconstruction, so that the clamp matters.  h and w are at least 12."""
    g = torch.Generator(device=device).manual_seed(seed)
    t = torch.arange(n, dtype=torch.float32, device=device)[:, None, None]
    y = torch.arange(h, dtype=torch.float32, device=device)[None, :, None]
    x = torch.arange(w, dtype=torch.float32, device=device)[None, None, :]
    f = 120 + 50 * torch.sin((x + 2 * t) / 9) + 30 * torch.cos((y - t) / 7)
    f = f + 3 * torch.randn((n, h, w), generator=g, device=device)
    ys = torch.randint(0, h - 11, (n, 2), generator=g, device=device).tolist()
    xs = torch.randint(0, w - 11, (n, 2), generator=g, device=device).tolist()
    for i in range(n):
        for val, y0, x0 in zip((0.0, 255.0), ys[i], xs[i]):
            f[i, y0:y0 + 11, x0:x0 + 11] = val
    return f.clamp(0, 255).to(torch.uint8)
