"""Port of ``repro/videostore/video_store.py``: ingestion into every
configured storage format, multi-version storage, and retrieval with
chunk-skip decode and fidelity conversion.

A ``VideoStore`` works on one device (the card unless ``device="cpu"``):
ingested frames are moved there once, transcoded and encoded there, and
retrieval decodes and converts onto it, so frames stay on the device from
decode through ``convert`` to the operators.  Blobs, ``meta.json`` and the
segment store are the reference's formats, so either package opens the
other's store.

The fallback chain (reconstructing missing blobs) and erosion belong to
later slices and are not ported yet.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time

import numpy as np
import torch

from ..codec import segment as codec
from ..codec import transform as T
from ..core.knobs import (CodingOption, FidelityOption, IngestSpec,
                          StorageFormat)
from ..device import resolve_device
from ..obs.trace import span as _span
from .store import SegmentStore


@dataclasses.dataclass
class IngestStats:
    """Per-ingest accounting: the paper's ingestion cost (transcode compute)
    and storage cost (bytes/sec of stored video), with the chunk-level byte
    spans of v2 blobs."""
    encode_seconds: float = 0.0
    stored_bytes: int = 0
    segments: int = 0
    chunks: int = 0          # entropy-coded chunks written (0 for RAW blobs)
    chunk_bytes: int = 0     # payload bytes of those chunks (v2 spans)

    def add(self, sec: float, nbytes: int, chunks: int = 0,
            chunk_bytes: int = 0):
        self.encode_seconds += sec
        self.stored_bytes += nbytes
        self.chunks += chunks
        self.chunk_bytes += chunk_bytes

    def bytes_per_video_second(self, spec: IngestSpec) -> float:
        dur = max(1e-9, self.segments * spec.segment_seconds)
        return self.stored_bytes / dur

    def cost_xrealtime(self, spec: IngestSpec) -> float:
        """Transcode compute normalized to video realtime (1.0 = keeps up)."""
        dur = max(1e-9, self.segments * spec.segment_seconds)
        return self.encode_seconds / dur


def _sf_key(sf_id: str, stream: str, seg: int) -> str:
    return f"{stream}:{sf_id}:{seg:06d}"


def blob_chunk_profile(blob: bytes) -> tuple[int, int]:
    """(chunks, chunk_bytes) of a stored blob: v2 headers carry exact
    per-chunk byte spans; v1 charges the whole entropy stream and RAW blobs
    report their payload as chunkless bytes."""
    header = codec.segment_info(blob)
    if header.get("raw"):
        return 0, header["n"] * header["h"] * header["w"]
    spans = header.get("spans")
    if spans is not None:  # blob v2: exact per-chunk byte spans
        return len(spans), int(sum(spans))
    n, k = header["n"], header["k"]
    return -(-n // k), len(blob)


class VideoStore:
    """Owns the on-disk segments for all streams × storage formats.

    ``readonly=True`` attaches to an existing store (the reference's or the
    port's) without mutating it: no meta/identity writes, writes raise.
    ``device`` is where frames live: the card unless ``"cpu"`` is asked
    for, which runs the plain PyTorch path throughout."""

    def __init__(self, root: str, spec: IngestSpec | None = None,
                 readonly: bool = False, device=None):
        self.root = root
        self.spec = spec or IngestSpec()
        self.readonly = readonly
        self.device = resolve_device(device)
        self.backend = SegmentStore(os.path.join(root, "segments"),
                                    readonly=readonly)
        self.formats: dict[str, StorageFormat] = {}
        self.store_id: str | None = None
        self.ingest_stats: dict[str, IngestStats] = {}  # guarded-by: _stats_mu
        self._meta_path = os.path.join(root, "meta.json")
        # segments may be ingested from several threads at once
        self._stats_mu = threading.Lock()
        self._load_meta()
        if self.store_id is None and not readonly:
            # analysis: allow[determinism] store identity is minted once
            # at creation and persisted in meta.json; it must be unique
            # across stores (shard-identity checks), not reproducible
            self.store_id = os.urandom(8).hex()
            self._save_meta()

    # -- configuration -------------------------------------------------------
    def set_formats(self, formats: dict[str, StorageFormat]):
        """Install the storage-format set (keys 'sf_g', 'sf1', ...)."""
        if self.readonly:
            raise RuntimeError(f"read-only VideoStore at {self.root}")
        self.formats = dict(formats)
        self._save_meta()

    def _save_meta(self):
        blob = {
            sid: {
                "quality": sf.fidelity.quality, "crop": sf.fidelity.crop,
                "resolution": sf.fidelity.resolution,
                "sampling": sf.fidelity.sampling,
                "speed": sf.coding.speed, "keyframe": sf.coding.keyframe,
                "bypass": sf.coding.bypass,
            } for sid, sf in self.formats.items()
        }
        blob["__store__"] = {"store_id": self.store_id}
        tmp = self._meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(blob, f, indent=1)
        os.replace(tmp, self._meta_path)

    def _load_meta(self):
        if not os.path.exists(self._meta_path):
            return
        with open(self._meta_path) as f:
            blob = json.load(f)
        self.store_id = blob.pop("__store__", {}).get("store_id")
        self.formats = {
            sid: StorageFormat(
                FidelityOption(v["quality"], v["crop"], v["resolution"],
                               v["sampling"]),
                CodingOption(v["speed"], v["keyframe"], v["bypass"]))
            for sid, v in blob.items()
        }

    # -- ingestion ------------------------------------------------------------
    def encode_format(self, frames_u8, src_f: FidelityOption,
                      sf: StorageFormat) -> bytes:
        """Transcode frames at fidelity ``src_f`` into ``sf``'s blob bytes
        (fidelity conversion + coding) on the store's device."""
        frames = T.convert_fidelity(
            torch.as_tensor(frames_u8).to(self.device), src_f, sf.fidelity,
            self.spec)
        if sf.coding.bypass:
            return codec.encode_raw(frames)
        return codec.encode_segment(
            frames, quant_scale=sf.fidelity.quant_scale,
            keyframe_interval=sf.coding.keyframe,
            zstd_level=sf.coding.zstd_level)

    def put_segment(self, stream: str, seg: int, sf_id: str, blob: bytes,
                    encode_s: float = 0.0):
        """Write one materialized blob and account it (bytes + chunk spans)."""
        chunks, chunk_bytes = blob_chunk_profile(blob)
        self.backend.put(_sf_key(sf_id, stream, seg), blob)
        with self._stats_mu:
            stats = self.ingest_stats.setdefault(stream, IngestStats())
            stats.add(encode_s, len(blob), chunks, chunk_bytes)

    def ingest_segment(self, stream: str, seg: int, frames_u8,
                       ingest_fidelity: FidelityOption | None = None):
        """Blocking ingest: transcode one arriving segment (uint8 frames at
        the ingest fidelity, numpy or tensor) into every configured storage
        format before returning.  The frames cross to the device once."""
        src_f = ingest_fidelity or FidelityOption()
        frames = torch.as_tensor(frames_u8).to(self.device)
        with self._stats_mu:
            stats = self.ingest_stats.setdefault(stream, IngestStats())
            stats.segments += 1
        for sid, sf in self.formats.items():
            t0 = time.perf_counter()
            blob = self.encode_format(frames, src_f, sf)
            dt = time.perf_counter() - t0
            self.put_segment(stream, seg, sid, blob, encode_s=dt)

    # -- retrieval -------------------------------------------------------------
    def retrieve(self, stream: str, seg: int, sf_id: str,
                 cf: FidelityOption) -> tuple[torch.Tensor, dict]:
        """Decode a stored segment (chunk-skip under the consumer's sparser
        sampling) and convert to the consumption fidelity.  Returns
        (frames_u8 on the store's device, cost dict).  The serving layer's
        cache hook arrives with the serving slice."""
        return self.retrieve_direct(stream, seg, sf_id, cf)

    def retrieve_direct(self, stream: str, seg: int, sf_id: str,
                        cf: FidelityOption) -> tuple[torch.Tensor, dict]:
        """The uncached decode path."""
        want = self.want_indices(sf_id, cf)
        frames, cost = self.decode_for(stream, seg, sf_id, want)
        t0 = time.perf_counter()
        out = self.convert(frames, sf_id, cf)
        cost["convert_s"] = time.perf_counter() - t0
        return out, cost

    def retrieve_many(self, stream: str, segs: list[int], sf_id: str,
                      cf: FidelityOption) -> tuple[list[torch.Tensor], dict]:
        """Retrieve several segments at one consumption fidelity: one
        batched decode (``decode_many_for``) and one ``convert`` over the
        concatenated frames, split back per segment.  Decode and convert
        are per-frame programs, so the frames equal ``retrieve``'s."""
        cost = {"decode_s": 0.0, "convert_s": 0.0, "bytes": 0,
                "chunks": 0, "frames": 0}
        if not segs:
            return [], cost
        want = self.want_indices(sf_id, cf)
        decoded, c = self.decode_many_for(stream, segs, sf_id, want)
        for k in ("decode_s", "bytes", "chunks", "frames"):
            cost[k] += c[k]
        t0 = time.perf_counter()
        stacked = decoded[0] if len(decoded) == 1 else torch.cat(decoded)
        conv = self.convert(stacked, sf_id, cf)
        cost["convert_s"] = time.perf_counter() - t0
        n = len(want)
        return [conv[i * n:(i + 1) * n] for i in range(len(segs))], cost

    def want_indices(self, sf_id: str, cf: FidelityOption) -> np.ndarray:
        """Stored-frame indices realizing ``cf``'s sampling (R1-checked)."""
        sf = self.formats[sf_id]
        if not sf.fidelity.richer_eq(cf):
            raise ValueError(
                f"R1 violated: SF {sf.fidelity.name()} poorer than CF {cf.name()}")
        return T.temporal_indices(sf.fidelity, cf, self.spec)

    def decode_for(self, stream: str, seg: int, sf_id: str,
                   want: np.ndarray) -> tuple[torch.Tensor, dict]:
        """Fetch + chunk-skip-decode stored frames ``want`` at the storage
        fidelity's own grid.  ``bytes``/``chunks`` report what the decode
        actually touched."""
        blob = self.backend.get(_sf_key(sf_id, stream, seg))
        t0 = time.perf_counter()
        with _span("codec.decode", sf=sf_id, seg=seg) as sp:
            frames, info = codec.decode_segment_ex(blob, np.asarray(want),
                                                   self.device)
            sp.set(bytes=info["bytes"], chunks=info["chunks"],
                   frames=info["frames"])
        cost = {
            "decode_s": time.perf_counter() - t0, "convert_s": 0.0,
            "bytes": info["bytes"], "chunks": info["chunks"],
            "frames": info["frames"],
        }
        return frames, cost

    def decode_many_for(self, stream: str, segs: list[int], sf_id: str,
                        want: np.ndarray) -> tuple[list[torch.Tensor], dict]:
        """Chunk-skip-decode ``want`` from several segments of one storage
        format in a single batched decode (``codec.decode_many``)."""
        blobs = [self.backend.get(_sf_key(sf_id, stream, s)) for s in segs]
        t0 = time.perf_counter()
        with _span("codec.decode", sf=sf_id, segments=len(segs)) as sp:
            frames_list, info = codec.decode_many(blobs, np.asarray(want),
                                                  self.device)
            sp.set(bytes=info["bytes"], chunks=info["chunks"],
                   frames=info["frames"])
        cost = {
            "decode_s": time.perf_counter() - t0, "convert_s": 0.0,
            "bytes": info["bytes"], "chunks": info["chunks"],
            "frames": info["frames"], "dispatches": info["dispatches"],
        }
        return frames_list, cost

    def convert(self, frames: torch.Tensor, sf_id: str,
                cf: FidelityOption) -> torch.Tensor:
        """Storage-grid frames -> consumption fidelity (crop + resize)."""
        sf = self.formats[sf_id]
        with _span("convert", sf=sf_id, cf=cf.name(), frames=len(frames)):
            return T.spatial_convert(frames, sf.fidelity, cf, self.spec)

    def available_segments(self, stream: str, sf_id: str) -> list[int]:
        prefix = f"{stream}:{sf_id}:"
        return [int(k.rsplit(":", 1)[1]) for k in self.backend.keys(prefix)]

    def segment_bytes(self, stream: str, seg: int, sf_id: str) -> int:
        """Stored size of one materialized blob, 0 when absent."""
        try:
            return self.backend.size_of(_sf_key(sf_id, stream, seg))
        except KeyError:
            return 0

    def storage_bytes(self, stream: str | None = None) -> int:
        return self.backend.total_bytes(f"{stream}:" if stream else "")

    def flush(self):
        self.backend.flush()
