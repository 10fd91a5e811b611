"""Incremental checkpoints: content-addressed shared state chunks
(port of ``flink_tpu/state/shared_registry.py``).

The reference uploads only new RocksDB SST files per incremental
checkpoint and tracks cross-checkpoint sharing in a
SharedStateRegistry (ref: RocksDBKeyedStateBackend.java:342-381
snapshot strategy; SharedStateRegistry.java:42 refcounted handles).
Here the same seam is the :class:`SharedChunk`: any operator/backend
snapshot may wrap a stable unit of its state (a key group's bytes, a
window's compacted log) in a SharedChunk; the checkpoint storage
stores each distinct content hash ONCE, replaces repeats with light
references, refcounts chunks across retained checkpoints, and deletes
a chunk when its last referencing checkpoint is dropped.

Two chunk units ship wrapped:
- the keyed backends' per-key-group serialized chunks (heap + TPU
  backends, state/backend.py snapshot path) — an untouched key group
  contributes ~0 bytes to the next checkpoint;
- the log window engines' per-window compacted logs
  (streaming/log_windows.py) — a closed-but-unfired or simply
  untouched window re-uploads nothing (and skips re-hashing via a
  version cache).

Savepoints and cross-storage copies always materialize full payloads
(resolve_chunks) — a savepoint must be self-contained, exactly like
the reference's full-savepoint-from-incremental-checkpoint rule.
"""

from __future__ import annotations

import hashlib
from typing import Any, Callable, Dict, List, Set


class SharedChunk:
    """A content-addressed unit of snapshot state.  ``payload`` may be
    None when the producer knows the chunk is unchanged since a
    checkpoint this storage retains (hash-only reference); the storage
    falls back to requiring the payload for unknown hashes."""

    __slots__ = ("hash", "payload")

    def __init__(self, payload: Any, chunk_hash: str = None):
        self.payload = payload
        self.hash = chunk_hash if chunk_hash is not None \
            else content_hash(payload)

    def __getitem__(self, key):
        """A chunk reads like its payload: an engine of the JAX package
        restoring a port snapshot in memory indexes a window's chunk as
        the payload dict it expects."""
        return self.payload[key]

    def __repr__(self):
        return (f"SharedChunk({self.hash[:12]}, "
                f"{'ref' if self.payload is None else 'payload'})")


class ChunkRef:
    """Storage-internal replacement for a registered SharedChunk."""

    __slots__ = ("hash",)

    def __init__(self, chunk_hash: str):
        self.hash = chunk_hash

    def __repr__(self):
        return f"ChunkRef({self.hash[:12]})"


def content_hash(payload: Any) -> str:
    """Stable content hash of a chunk payload (bytes, numpy arrays,
    and nested list/tuple/dict compositions of them)."""
    h = hashlib.blake2b(digest_size=16)
    _feed(h, payload)
    return h.hexdigest()


def _feed(h, obj) -> None:
    # every field is length-prefixed: without delimiting, adjacent
    # fields can collide ([b"ab", b"c"] vs [b"a", b"bc"]) and a
    # collision in a content-addressed store is silent corruption
    import numpy as np

    def tagged(tag: bytes, payload: bytes) -> None:
        h.update(tag)
        h.update(len(payload).to_bytes(8, "little"))
        h.update(payload)

    if isinstance(obj, (bytes, bytearray, memoryview)):
        tagged(b"b", bytes(obj))
    elif isinstance(obj, np.ndarray):
        tagged(b"t", f"{obj.dtype}|{obj.shape}".encode())
        tagged(b"a", np.ascontiguousarray(obj).tobytes())
    elif isinstance(obj, dict):
        h.update(b"d")
        h.update(len(obj).to_bytes(8, "little"))
        for k in sorted(obj, key=repr):
            tagged(b"k", repr(k).encode())
            _feed(h, obj[k])
    elif isinstance(obj, (list, tuple)):
        h.update(b"l")
        h.update(len(obj).to_bytes(8, "little"))
        for x in obj:
            _feed(h, x)
    else:
        # deterministic scalar/struct fallback: pickle, never repr
        # (default reprs embed addresses — reuse would collide)
        import pickle
        tagged(b"o", pickle.dumps(obj, protocol=4))


def map_chunks(obj: Any, fn: Callable[[Any], Any],
               kinds=(SharedChunk, ChunkRef)) -> Any:
    """Rebuild a nested snapshot structure with every SharedChunk /
    ChunkRef node replaced by fn(node).  Containers are copied only
    along paths that contain chunks.  Objects exposing ``_map_chunks_``
    (e.g. KeyedStateSnapshot) map themselves."""
    if isinstance(obj, kinds):
        return fn(obj)
    mapper = getattr(obj, "_map_chunks_", None)
    if mapper is not None:
        return mapper(lambda c: fn(c) if isinstance(c, kinds) else c)
    if isinstance(obj, dict):
        out = None
        for k, v in obj.items():
            nv = map_chunks(v, fn, kinds)
            if nv is not v:
                if out is None:
                    out = dict(obj)
                out[k] = nv
        return out if out is not None else obj
    if isinstance(obj, (list, tuple)):
        mapped = [map_chunks(v, fn, kinds) for v in obj]
        if all(m is v for m, v in zip(mapped, obj)):
            return obj
        return type(obj)(mapped) if isinstance(obj, tuple) else mapped
    return obj


def find_chunks(obj: Any, out: List, kinds=(SharedChunk, ChunkRef)):
    if isinstance(obj, kinds):
        out.append(obj)
    elif hasattr(obj, "_map_chunks_"):
        obj._map_chunks_(lambda c: (out.append(c), c)[1]
                         if isinstance(c, kinds) else c)
    elif isinstance(obj, dict):
        for v in obj.values():
            find_chunks(v, out, kinds)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            find_chunks(v, out, kinds)
    return out


class SharedStateRegistry:
    """Refcounted chunk registry for one checkpoint storage (ref:
    SharedStateRegistry.java).  ``store``/``fetch``/``delete`` are
    provided by the storage (memory dict or files)."""

    def __init__(self, store: Callable[[str, Any], None],
                 delete: Callable[[str], None],
                 exists: Callable[[str], bool]):
        self._store = store
        self._delete = delete
        self._exists = exists
        self._refs: Dict[str, int] = {}
        self._by_checkpoint: Dict[int, Set[str]] = {}

    def register_checkpoint(self, checkpoint_id: int, snapshot: Any) -> Any:
        """Register every SharedChunk under this checkpoint; returns
        the snapshot with chunks replaced by ChunkRefs.  A payloadless
        chunk whose hash is unknown raises — the producer's unchanged
        claim was wrong for this storage.  ``last_new_hashes`` records
        the chunks actually stored by this call (the incremental
        bytes)."""
        hashes: Set[str] = set()
        self.last_new_hashes: List[str] = []

        def visit(chunk):
            if isinstance(chunk, ChunkRef):   # re-persist of loaded state
                hashes.add(chunk.hash)
                if chunk.hash not in self._refs \
                        and not self._exists(chunk.hash):
                    raise KeyError(
                        f"chunk {chunk.hash} referenced but not stored")
                return chunk
            if chunk.hash not in self._refs:
                if chunk.payload is None:
                    if not self._exists(chunk.hash):
                        raise KeyError(
                            f"chunk {chunk.hash} elided its payload but "
                            f"is unknown to this checkpoint storage")
                else:
                    self._store(chunk.hash, chunk.payload)
                    self.last_new_hashes.append(chunk.hash)
            hashes.add(chunk.hash)
            return ChunkRef(chunk.hash)

        out = map_chunks(snapshot, visit)
        for h in hashes:
            self._refs[h] = self._refs.get(h, 0) + 1
        self._by_checkpoint[checkpoint_id] = hashes
        return out

    def adopt_checkpoint(self, checkpoint_id: int, snapshot: Any) -> None:
        """Re-register refs of a checkpoint loaded from persistent
        storage (recovery in a fresh process)."""
        refs: List[ChunkRef] = []
        find_chunks(snapshot, refs, kinds=(ChunkRef,))
        hashes = {r.hash for r in refs}
        for h in hashes:
            self._refs[h] = self._refs.get(h, 0) + 1
        self._by_checkpoint[checkpoint_id] = hashes

    def release_checkpoint(self, checkpoint_id: int) -> None:
        for h in self._by_checkpoint.pop(checkpoint_id, ()):
            n = self._refs.get(h, 0) - 1
            if n <= 0:
                self._refs.pop(h, None)
                self._delete(h)
            else:
                self._refs[h] = n
