"""Port of ``repro/codec/segment.py``: segment-level encode / decode.

An encoded segment is a sequence of *chunks* ("group of pictures"): each
chunk begins with an intra-coded frame (predicted from mid-gray) followed
by delta-coded frames (predicted from the previous *reconstructed* frame,
DPCM style).  Chunks decode independently, so sparse frame sampling skips
whole chunks.  Quantized DCT symbols are entropy-coded on the host with
zstd (zlib when ``zstandard`` is absent; the coder is recorded in the
header as ``"ec"``).

The blob format is the reference's, byte for byte: ``[u32 header_len]
[msgpack header][payload]``, magic ``tpucodec-v1``, v1 (one entropy stream)
or v2 (one stream per chunk, lengths in ``"spans"``).  Either package
decodes the other's blobs.

The transforms run on the device of the frames (encode) or on the caller's
``device`` (decode): on the card through the CUDA kernels, on the CPU
through their plain versions.  Encoding codes every chunk of a segment in
one launch of K3's encoder form (forward DCT + quantize, dequantize + IDCT
and the DPCM prediction, all on the card); decoding reconstructs every
wanted chunk's residuals in one K1 launch, then runs the add+clip DPCM scan
(``_residuals_scan``, plain tensor ops) over them.  Only symbols and blob
bytes cross to the host.  The port's float sums run in another order than
XLA's, so its symbols and frames agree with the reference's within stated
bounds (see ``tests/test_torch_codec.py``), not bit for bit.
"""

from __future__ import annotations

import struct
import zlib

import msgpack
import numpy as np
import torch

try:
    import zstandard
except ImportError:  # pragma: no cover - exercised on bare interpreters
    zstandard = None

from ..device import resolve_device
from ..kernels.dct8.ops import dct_dequantize, dct_encode_chunks
from ..obs.trace import span as _span
from . import transform as T

_MAGIC = "tpucodec-v1"

#: Blob format written by :func:`encode_segment` when ``version`` is None.
DEFAULT_VERSION = 2


def _compress(payload: bytes, level: int) -> tuple[str, bytes]:
    """Entropy-code with zstd when available, else zlib.  Returns the coder
    tag recorded in the header alongside the compressed payload."""
    if zstandard is not None:
        return "zstd", zstandard.ZstdCompressor(level=level).compress(payload)
    return "zlib", zlib.compress(payload, min(9, max(1, level)))


def _decompress(coder: str, payload: bytes) -> bytes:
    if coder == "zstd":
        if zstandard is None:
            raise RuntimeError(
                "blob was zstd-coded but the zstandard module is unavailable")
        return zstandard.ZstdDecompressor().decompress(payload)
    if coder == "zlib":
        return zlib.decompress(payload)
    raise ValueError(f"unknown entropy coder {coder!r}")


# ---------------------------------------------------------------------------
# Chunk coding
# ---------------------------------------------------------------------------

def _encode_chunks(frames_u8: torch.Tensor, k: int,
                   quant_scale: float) -> torch.Tensor:
    """DPCM-encode every chunk of a segment at once: (n, h, w) uint8 ->
    (C, k_eff, hb, wb, 8, 8) int16, chunk c holding frames ``c*k ..``.

    The reference's ``_encode_chunk`` scans one chunk's frames; chunks are
    independent, so on the card one launch of K3's encoder form codes every
    chunk, and on the CPU its plain version steps every chunk together, one
    frame position at a time.  A short tail chunk repeats its last frame
    (DPCM is causal, so the padding cannot change the real frames'
    symbols)."""
    return dct_encode_chunks(frames_u8.contiguous(), k, quant_scale)


def _chunk_residuals(symbols: torch.Tensor, quant_scale: float) -> torch.Tensor:
    """Batched residual IDCT: (C, k, hb, wb, 8, 8) int16 -> (k, C, h, w)
    float32 residuals of every wanted chunk's frames in one K1 launch,
    k-major so the DPCM scan below walks its leading axis."""
    C, k, hb, wb, _, _ = symbols.shape
    kmajor = symbols.transpose(0, 1).reshape(k * C, hb, wb, T.BLOCK, T.BLOCK)
    resid = dct_dequantize(kmajor.contiguous(), quant_scale)
    return resid.reshape(k, C, hb * T.BLOCK, wb * T.BLOCK)


def _residuals_scan(resid: torch.Tensor) -> torch.Tensor:
    """The sequential DPCM tail over precomputed residuals:
    (k, C, h, w) float32 -> (k, C, h, w) uint8.  Each step adds, clips and
    emits rounded uint8 (half to even); only the (C, h, w) carry stays
    float."""
    out = torch.empty(resid.shape, dtype=torch.uint8, device=resid.device)
    pred = torch.full(resid.shape[1:], 128.0, dtype=torch.float32,
                      device=resid.device)
    for t in range(resid.shape[0]):
        pred = torch.clamp(pred + resid[t], 0.0, 255.0)
        out[t] = torch.round(pred).to(torch.uint8)
    return out


def _decode_chunks(symbols: torch.Tensor, quant_scale: float) -> torch.Tensor:
    """Batched chunk decode: (C, k, hb, wb, 8, 8) int16 -> (k, C, h, w)
    uint8; callers index ``[frame_in_chunk, chunk_row]``."""
    return _residuals_scan(_chunk_residuals(symbols, quant_scale))


def _pad_chunk_count(c: int) -> int:
    """Next power of two >= c: the chunk-batch sizes the reference decodes
    in (its jit shape ladder); kept so both decode the same chunk stacks."""
    return 1 << max(0, c - 1).bit_length()


def _k_eff(k: int, n: int) -> int:
    """The chunk-stack frame dimension: ``min(k, n)``."""
    return min(k, n)


# ---------------------------------------------------------------------------
# Public segment API
# ---------------------------------------------------------------------------

def encode_segment(frames_u8, *, quant_scale: float, keyframe_interval: int,
                   zstd_level: int, version: int | None = None) -> bytes:
    """Encode (n, h, w) uint8 frames (a tensor, coded on its device, or a
    numpy array, coded on the CPU).  ``version`` selects the blob format
    (default ``DEFAULT_VERSION``)."""
    version = DEFAULT_VERSION if version is None else version
    if version not in (1, 2):
        raise ValueError(f"unknown blob format version {version}")
    frames = torch.as_tensor(frames_u8)
    n, h, w = frames.shape
    k = keyframe_interval
    with _span("codec.encode", frames=n):
        sym = _encode_chunks(frames, k, quant_scale).cpu().numpy()
    parts = [sym[c, :min(k, n - start)]
             for c, start in enumerate(range(0, n, k))]
    header = {
        "magic": _MAGIC, "raw": False, "n": n, "h": h, "w": w,
        "k": k, "qs": float(quant_scale), "lvl": zstd_level,
    }
    if version == 1:
        coder, comp = _compress(b"".join(p.tobytes() for p in parts),
                                zstd_level)
        header["ec"] = coder
        payload = comp
    else:
        spans, blobs = [], []
        coder = None
        for p in parts:
            coder, comp = _compress(p.tobytes(), zstd_level)
            spans.append(len(comp))
            blobs.append(comp)
        header["v"] = 2
        header["ec"] = coder or _compress(b"", zstd_level)[0]
        header["spans"] = spans
        payload = b"".join(blobs)
    packed = msgpack.packb(header)
    return struct.pack("<I", len(packed)) + packed + payload


def encode_raw(frames_u8) -> bytes:
    """Coding bypass: store raw frames (true random access, no decode)."""
    frames = np.ascontiguousarray(
        torch.as_tensor(frames_u8).to(torch.uint8).cpu().numpy())
    n, h, w = frames.shape
    header = msgpack.packb({"magic": _MAGIC, "raw": True, "n": n, "h": h, "w": w})
    return struct.pack("<I", len(header)) + header + frames.tobytes()


def _parse(blob: bytes):
    (hlen,) = struct.unpack_from("<I", blob, 0)
    header = msgpack.unpackb(blob[4:4 + hlen])
    if header.get("magic") != _MAGIC:
        raise ValueError("not a tpucodec blob")
    return header, blob[4 + hlen:]


def segment_info(blob: bytes) -> dict:
    header, _ = _parse(blob)
    return header


def _chunk_symbols(header: dict, payload: bytes, chunks: np.ndarray,
                   pad_to: int) -> tuple[np.ndarray, int]:
    """Entropy-decode the selected ``chunks`` into a zero-padded
    (pad_to, k, hb, wb, 8, 8) int16 host stack.  Returns (symbols,
    payload_bytes_touched): v2 touches only the selected chunks' spans, v1
    must decompress the whole stream."""
    n, h, w, k = header["n"], header["h"], header["w"], header["k"]
    hb, wb = h // T.BLOCK, w // T.BLOCK
    ec = header.get("ec", "zstd")
    out = np.zeros((pad_to, _k_eff(k, n), hb, wb, T.BLOCK, T.BLOCK),
                   np.int16)
    if header.get("v", 1) >= 2:
        offsets = np.concatenate([[0], np.cumsum(header["spans"])])
        touched = 0
        for i, c in enumerate(chunks):
            c = int(c)
            raw = _decompress(ec, payload[offsets[c]:offsets[c + 1]])
            kc = min(k, n - c * k)
            out[i, :kc] = np.frombuffer(raw, np.int16).reshape(
                kc, hb, wb, T.BLOCK, T.BLOCK)
            touched += int(header["spans"][c])
        return out, touched
    sym_all = np.frombuffer(_decompress(ec, payload), np.int16).reshape(
        n, hb, wb, T.BLOCK, T.BLOCK)
    for i, c in enumerate(chunks):
        start = int(c) * k
        kc = min(k, n - start)
        out[i, :kc] = sym_all[start:start + kc]
    return out, len(payload)


def _decode_cost(header: dict, header_bytes: int, payload_bytes: int,
                 chunks: int, frames: int) -> dict:
    """The header dict augmented with bytes/chunks/frames actually touched."""
    return dict(header) | {
        "bytes": header_bytes + payload_bytes,
        "chunks": chunks,
        "frames": frames,
    }


def decode_segment_ex(blob: bytes, want: np.ndarray | None = None,
                      device=None) -> tuple[torch.Tensor, dict]:
    """Decode stored frames onto ``device`` (the card by default) and
    return ``(frames_u8, info)`` from one parse.

    ``want`` (sorted indices into the stored frame sequence) enables
    chunk-skip: only chunks containing wanted frames are entropy-decoded
    (v2: only their payload bytes are touched) and reconstructed, in one
    batched K1 launch.  ``info`` is the blob header plus
    ``bytes``/``chunks``/``frames`` actually touched."""
    dev = resolve_device(device)
    with _span("codec.parse", bytes=len(blob)):
        header, payload = _parse(blob)
    hlen = len(blob) - len(payload)
    n, h, w = header["n"], header["h"], header["w"]
    if header["raw"]:
        return _decode_raw(header, payload, hlen, want, dev)

    k = header["k"]
    want = np.arange(n) if want is None else np.asarray(want, np.int64)
    if want.size == 0:
        return (torch.empty((0, h, w), dtype=torch.uint8, device=dev),
                _decode_cost(header, hlen, 0, 0, 0))
    chunks = np.unique(want // k)
    with _span("codec.entropy", chunks=len(chunks)) as esp:
        sym, touched = _chunk_symbols(header, payload, chunks,
                                      _pad_chunk_count(len(chunks)))
        esp.set(bytes=touched)
    with _span("codec.residuals", chunks=len(chunks), frames=len(want)):
        decoded = _run_decode(sym, header, dev)  # (k_eff, C_padded, h, w)
    out = _scatter_rows(decoded, want, k, chunks)
    return out, _decode_cost(header, hlen, touched, len(chunks), len(want))


def _decode_raw(header: dict, payload: bytes, hlen: int,
                want: np.ndarray | None, dev: torch.device
                ) -> tuple[torch.Tensor, dict]:
    """Coding-bypass read: the wanted raw frames, copied onto ``dev``."""
    n, h, w = header["n"], header["h"], header["w"]
    frames = np.frombuffer(payload, np.uint8).reshape(n, h, w)
    sel = frames[np.asarray(want, np.int64)] if want is not None \
        else frames.copy()
    return (torch.from_numpy(sel).to(dev),
            _decode_cost(header, hlen, sel.nbytes, 0, len(sel)))


def _run_decode(sym_padded: np.ndarray, header: dict,
                dev: torch.device) -> torch.Tensor:
    """Symbols host -> device, then one batched ``_decode_chunks``."""
    sym = torch.from_numpy(sym_padded)
    if dev.type == "cuda":
        sym = sym.pin_memory().to(dev, non_blocking=True)
    return _decode_chunks(sym, header["qs"])


def _scatter_rows(decoded: torch.Tensor, want: np.ndarray, k: int,
                  chunks: np.ndarray, row0: int = 0) -> torch.Tensor:
    """Select ``want`` frames from a decoded (k_eff, C, h, w) chunk stack
    whose rows ``row0 .. row0+len(chunks)`` hold ``chunks`` (sorted
    unique).  Shared by the one-segment and grouped decoders."""
    chunk_of = want // k
    rows = row0 + np.searchsorted(chunks, chunk_of)
    dev = decoded.device
    return decoded[torch.from_numpy(want - chunk_of * k).to(dev),
                   torch.from_numpy(rows).to(dev)]


def decode_segment(blob: bytes, want: np.ndarray | None = None,
                   device=None) -> torch.Tensor:
    """Decode stored frames (see ``decode_segment_ex``; drops the cost
    info).  Returns (len(want) or n, h, w) uint8 on ``device``."""
    return decode_segment_ex(blob, want, device)[0]


def decode_many(blobs: list[bytes], want: np.ndarray | None = None,
                device=None) -> tuple[list[torch.Tensor], dict]:
    """Decode several segments' ``want`` frames with ONE batched K1 launch
    per transform shape (h, w, k, qs): every coded blob of one storage
    format contributes its wanted chunks to a single stacked
    ``_decode_chunks`` call; raw blobs are copied.  Returns
    ``(frames_per_blob, cost)`` with bytes/chunks/frames touched and the
    ``dispatches`` issued."""
    dev = resolve_device(device)
    outs: list[torch.Tensor | None] = [None] * len(blobs)
    cost = {"bytes": 0, "chunks": 0, "frames": 0, "dispatches": 0}
    groups: dict[tuple, list] = {}
    for i, blob in enumerate(blobs):
        header, payload = _parse(blob)
        hlen = len(blob) - len(payload)
        if header["raw"]:
            outs[i], info = _decode_raw(header, payload, hlen, want, dev)
            for key in ("bytes", "chunks", "frames"):
                cost[key] += info[key]
            continue
        key = (header["h"], header["w"], header["k"], header["qs"],
               _k_eff(header["k"], header["n"]))
        groups.setdefault(key, []).append((i, header, payload, hlen))

    for (_h, _w, k, _qs, k_eff), members in groups.items():
        per_member = []
        total_chunks = 0
        for i, header, payload, hlen in members:
            n = header["n"]
            w_i = (np.arange(n) if want is None
                   else np.asarray(want, np.int64))
            chunks = np.unique(w_i // k) if w_i.size else np.empty(0, np.int64)
            per_member.append((i, header, payload, hlen, w_i, chunks))
            total_chunks += len(chunks)
        if total_chunks == 0:
            for i, header, payload, hlen, w_i, _c in per_member:
                outs[i] = torch.empty((0, header["h"], header["w"]),
                                      dtype=torch.uint8, device=dev)
                cost["bytes"] += hlen
            continue
        pad = _pad_chunk_count(total_chunks)
        header0 = per_member[0][1]
        hb, wb = header0["h"] // T.BLOCK, header0["w"] // T.BLOCK
        sym = np.zeros((pad, k_eff, hb, wb, T.BLOCK, T.BLOCK), np.int16)
        row = 0
        rowspans = []
        with _span("codec.entropy", chunks=total_chunks,
                   segments=len(per_member)) as esp:
            for i, header, payload, hlen, w_i, chunks in per_member:
                part, touched = _chunk_symbols(header, payload, chunks,
                                               len(chunks))
                sym[row:row + len(chunks)] = part
                rowspans.append(row)
                row += len(chunks)
                cost["bytes"] += hlen + touched
                cost["chunks"] += len(chunks)
                cost["frames"] += len(w_i)
            esp.set(bytes=cost["bytes"])
        with _span("codec.residuals", chunks=total_chunks,
                   frames=cost["frames"]):
            decoded = _run_decode(sym, header0, dev)
        cost["dispatches"] += 1
        for (i, header, payload, hlen, w_i, chunks), r0 in zip(per_member,
                                                              rowspans):
            if w_i.size == 0:
                outs[i] = torch.empty((0, header["h"], header["w"]),
                                      dtype=torch.uint8, device=dev)
                continue
            outs[i] = _scatter_rows(decoded, w_i, k, chunks, row0=r0)
    return outs, cost


def decode_segment_scan(blob: bytes, want: np.ndarray | None = None,
                        device=None) -> torch.Tensor:
    """The per-chunk oracle decoder: the plain dequantize + IDCT inside the
    DPCM loop, one chunk at a time, on ``device``."""
    dev = resolve_device(device)
    header, payload = _parse(blob)
    n, h, w = header["n"], header["h"], header["w"]
    if header["raw"]:
        return _decode_raw(header, payload, 0, want, dev)[0]
    k, qs = header["k"], header["qs"]
    want = np.arange(n) if want is None else np.asarray(want, np.int64)
    out = torch.empty((len(want), h, w), dtype=torch.uint8, device=dev)
    chunk_of = want // k
    chunks = np.unique(chunk_of)
    sym_all, _ = _chunk_symbols(header, payload, chunks, len(chunks))
    for row, c in enumerate(chunks):
        kc = min(k, n - int(c) * k)
        sym = torch.from_numpy(sym_all[row, :kc]).to(dev)
        pred = torch.full((h, w), 128.0, dtype=torch.float32, device=dev)
        frames = []
        for t in range(kc):
            r = T.symbols_to_residuals(sym[t:t + 1], qs)[0]
            pred = torch.clamp(pred + r, 0.0, 255.0)
            frames.append(pred)
        sel = np.nonzero(chunk_of == c)[0]
        stack = torch.stack([frames[int(i)] for i in want[sel] - int(c) * k])
        out[torch.from_numpy(sel).to(dev)] = torch.clamp(
            torch.round(stack), 0, 255).to(torch.uint8)
    return out
