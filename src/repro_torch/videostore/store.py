"""Port of ``repro/videostore/store.py``: the on-disk format is shared with
the reference, so either package reads the other's stores.  Deletes (and
with them tunable compaction) arrive with erosion, a later slice.

On-disk segment store (LMDB-like: MB-size values behind a keyed index).

Layout: ``root/shard-XXXX.bin`` append-only blob shards + ``root/index.msgpack``
mapping key -> (shard, offset, length).  Overwriting a key leaves dead
bytes in the shards; they are tracked in the index and reclaimed by
compaction once they exceed ``_AUTO_COMPACT_FRAC`` of the store.  This
mirrors the paper's use of LMDB for 8-second MB-size segment values without
an external dependency.
"""

from __future__ import annotations

import os
import threading

import msgpack

from ..obs.trace import span as _span

_SHARD_LIMIT = 64 * 1024 * 1024
# compact once dead bytes pass this share of the store (and this floor)
_AUTO_COMPACT_FRAC = 0.5
_AUTO_COMPACT_MIN_BYTES = 1 << 16


class SegmentStore:
    def __init__(self, root: str, readonly: bool = False):
        """``readonly=True`` attaches without any mutation: writes raise
        and the load-time orphan-shard sweep is skipped — safe for
        inspecting a store another process owns."""
        self.root = root
        self.readonly = readonly
        if not readonly:
            os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()
        self._index: dict[str, tuple[int, int, int]] = {}  # guarded-by: _lock
        self._shard_id = 0    # guarded-by: _lock
        self._shard_size = 0  # guarded-by: _lock
        self._live_bytes = 0  # guarded-by: _lock (sum of indexed lengths)
        self._dead_bytes = 0  # guarded-by: _lock (unreferenced shard bytes)
        self._gen = 0  # guarded-by: _lock (compaction bump; detects rewrites)
        self._load()

    # -- persistence --------------------------------------------------------
    def _index_path(self) -> str:
        return os.path.join(self.root, "index.msgpack")

    def _shard_path(self, sid: int) -> str:
        return os.path.join(self.root, f"shard-{sid:04d}.bin")

    def _load(self):
        if not os.path.exists(self._index_path()):
            return
        with open(self._index_path(), "rb") as f:
            raw = msgpack.unpackb(f.read())
        self._index = {k: tuple(v) for k, v in raw["index"].items()}
        self._shard_id = raw["shard_id"]
        self._shard_size = raw["shard_size"]
        self._live_bytes = sum(v[2] for v in self._index.values())
        self._dead_bytes = raw.get("dead_bytes", 0)
        if self.readonly:
            return  # the orphan sweep below mutates; owner's job
        # drop shard files the durable index no longer references — the
        # garbage a crash may leave on either side of a compaction (old
        # shards not yet removed, or new shards written before the index
        # flush); never data loss, because compaction makes the new index
        # durable before deleting the old shards
        live = {v[0] for v in self._index.values()} | {self._shard_id}
        for name in os.listdir(self.root):
            if name.startswith("shard-") and name.endswith(".bin"):
                sid = int(name[6:-4])
                if sid not in live:
                    os.remove(os.path.join(self.root, name))

    def flush(self):
        if self.readonly:
            return  # nothing of ours to persist
        with self._lock:
            self._flush_locked()

    def _flush_locked(self):
        blob = msgpack.packb({
            "index": {k: list(v) for k, v in self._index.items()},
            "shard_id": self._shard_id, "shard_size": self._shard_size,
            "dead_bytes": self._dead_bytes,
        })
        tmp = self._index_path() + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, self._index_path())  # atomic

    def _check_writable(self):
        if self.readonly:
            raise RuntimeError(f"read-only SegmentStore at {self.root}")

    # -- KV API --------------------------------------------------------------
    def put(self, key: str, value: bytes):
        self._check_writable()
        with self._lock:
            if self._shard_size + len(value) > _SHARD_LIMIT and self._shard_size:
                self._shard_id += 1
                self._shard_size = 0
            sid = self._shard_id
            path = self._shard_path(sid)
            with open(path, "ab") as f:
                offset = f.tell()
                f.write(value)
            self._shard_size = offset + len(value)
            old = self._index.get(key)
            if old is not None:
                self._dead_bytes += old[2]
                self._live_bytes -= old[2]
            self._index[key] = (sid, offset, len(value))
            self._live_bytes += len(value)
            self._maybe_compact_locked()

    def get(self, key: str) -> bytes:
        with _span("store.get", key=key) as sp:
            blob = self._get(key)
            sp.set(bytes=len(blob))
            return blob

    def _get(self, key: str) -> bytes:
        # Optimistic read: snapshot the index entry under the lock, read the
        # shard without it (gets stay concurrent), then verify no compaction
        # rewrote the shard layout mid-read.  Compaction holds the lock for
        # its whole rewrite, so an unchanged generation proves the bytes
        # came from the layout the entry described.
        while True:
            with self._lock:
                gen = self._gen
                sid, offset, length = self._index[key]
                path = self._shard_path(sid)
            try:
                with open(path, "rb") as f:
                    f.seek(offset)
                    blob = f.read(length)
            except FileNotFoundError:
                with self._lock:
                    if self._gen != gen:
                        continue  # compacted away mid-read; retry new index
                raise  # shard genuinely missing (corrupt/partial store)
            with self._lock:
                if self._gen == gen:
                    return blob

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._index

    def keys(self, prefix: str = "") -> list[str]:
        with self._lock:
            return sorted(k for k in self._index if k.startswith(prefix))

    def size_of(self, key: str) -> int:
        with self._lock:
            return self._index[key][2]

    def total_bytes(self, prefix: str = "") -> int:
        with self._lock:
            return sum(v[2] for k, v in self._index.items()
                       if k.startswith(prefix))

    def _maybe_compact_locked(self):
        """Auto-compaction check (caller holds the lock): rewrite the shards
        once orphaned bytes exceed ``_AUTO_COMPACT_FRAC`` of the store (the
        rewrite itself makes the index durable before deleting shards)."""
        if (self._dead_bytes >= _AUTO_COMPACT_MIN_BYTES
                and self._dead_bytes > _AUTO_COMPACT_FRAC
                * max(1, self._live_bytes + self._dead_bytes)):
            self._compact_locked()

    def _compact_locked(self):
        """Crash-safe rewrite: surviving blobs are copied into *fresh*
        shard ids (never reusing old names, so no renames), the index is
        made durable pointing at them, and only then are the old shards
        deleted.  A crash at any point leaves a readable store — before
        the index flush the old index + old shards are intact (new shards
        are orphans ``_load`` cleans up); after it, the new layout is live
        (old shards are the orphans)."""
        old_sids = {v[0] for v in self._index.values()} | {self._shard_id}
        base = self._shard_id + 1
        items = sorted(self._index.items())
        new_index, si, size = {}, 0, 0
        out = open(self._shard_path(base), "wb")
        for key, (osid, off, ln) in items:
            with open(self._shard_path(osid), "rb") as f:
                f.seek(off)
                blob = f.read(ln)
            if size + ln > _SHARD_LIMIT and size:
                out.close()
                si += 1
                out = open(self._shard_path(base + si), "wb")
                size = 0
            new_index[key] = (base + si, size, ln)
            out.write(blob)
            size += ln
        out.close()
        self._index = new_index
        self._shard_id, self._shard_size = base + si, size
        self._live_bytes = sum(v[2] for v in new_index.values())
        self._dead_bytes = 0
        self._gen += 1
        self._flush_locked()  # durable before the destructive deletes
        for sid in old_sids:
            path = self._shard_path(sid)
            if os.path.exists(path):
                os.remove(path)
