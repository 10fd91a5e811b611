"""Keyed-state backend contract (port of ``flink_tpu/state/backend.py``).

Per-state-name factories, ``set_current_key`` (which computes the key
group), ``get_or_create_keyed_state`` (binds a descriptor once and
caches it), namespace addressing (a window is a namespace) and
snapshot/restore in per-key-group chunks, so a restore can re-split
key-group ranges.

Snapshot chunks are the reference's v2 format: one pickled dict per
key group, ``{"v": 2, "rows": [(state, namespace, key, value)],
"cols": {state: [{"keys", "ns", "comps", "kind"}]}}``, whose key and
namespace columns go through the wire codec's column encoding
(``encode_obj_column``).  They pickle plain values only (ints, floats,
strings, tuples, numpy arrays and the codec's tuples), so a chunk
written by either package restores in the other without importing it;
``snapshot_from_chunks`` wraps bytes and meta taken from the JAX
package.  Queryable state, introspection, statistics and serializer
migration are later slices.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, Iterable, Optional

import numpy as np

from flink_tpu_torch.core.keygroups import KeyGroupRange
from flink_tpu_torch.core.state import (AggregatingStateDescriptor,
                                        FoldingStateDescriptor,
                                        ListStateDescriptor,
                                        MapStateDescriptor,
                                        ReducingStateDescriptor,
                                        StateDescriptor,
                                        ValueStateDescriptor)

#: namespace of non-windowed keyed state
VOID_NAMESPACE = ()


class KeyedStateSnapshot:
    """Serialized keyed state, one opaque chunk per key group.

    Each chunk is wrapped as a content-addressed ``SharedChunk``, so a
    checkpoint storage stores a distinct chunk once across the
    checkpoints it retains: an untouched key group adds ~0 bytes to the
    next checkpoint (the incremental-checkpoint seam).  ``blobs()``
    hands back raw bytes whether the snapshot is freshly taken
    (wrapped) or resolved by a storage (raw)."""

    __slots__ = ("key_group_bytes", "meta")

    def __init__(self, key_group_bytes: Dict[int, bytes],
                 meta: Optional[dict] = None, wrap: bool = True):
        if wrap:
            from flink_tpu_torch.state.shared_registry import SharedChunk
            key_group_bytes = {
                kg: b if isinstance(b, SharedChunk) else SharedChunk(b)
                for kg, b in key_group_bytes.items()}
        self.key_group_bytes = dict(key_group_bytes)
        self.meta = meta or {}

    def blobs(self):
        """Yields (key_group, raw_bytes)."""
        from flink_tpu_torch.state.shared_registry import SharedChunk
        for kg, b in self.key_group_bytes.items():
            yield kg, (b.payload if isinstance(b, SharedChunk) else b)

    @property
    def total_bytes(self) -> int:
        return sum(len(b) for _, b in self.blobs() if b is not None)

    def _map_chunks_(self, fn):
        """``shared_registry.map_chunks`` protocol: the snapshot with
        every chunk node replaced by ``fn(node)``."""
        from flink_tpu_torch.state.shared_registry import ChunkRef, SharedChunk
        mapped = {}
        changed = False
        for kg, b in self.key_group_bytes.items():
            nb = fn(b) if isinstance(b, (SharedChunk, ChunkRef)) else b
            changed = changed or nb is not b
            mapped[kg] = nb
        if not changed:
            return self
        return KeyedStateSnapshot(mapped, dict(self.meta), wrap=False)


def snapshot_from_chunks(key_group_bytes, meta: Optional[dict] = None
                         ) -> KeyedStateSnapshot:
    """A snapshot from plain chunk bytes — a ``{key_group: bytes}`` dict
    or ``(key_group, bytes)`` pairs, e.g. another package's
    ``snapshot.blobs()`` — and its meta dict."""
    return KeyedStateSnapshot(dict(key_group_bytes), meta)


#: value serializers whose configuration the port honours: the chunk
#: holds the values themselves, which these serializers store unchanged
_PLAIN_SERIALIZERS = frozenset({
    "PickleSerializer", "LongSerializer", "IntSerializer",
    "DoubleSerializer", "FloatSerializer", "BooleanSerializer",
    "StringSerializer", "BytesSerializer"})


class KeyedStateBackend(abc.ABC):
    """The contract every keyed backend implements."""

    def __init__(self, key_group_range: KeyGroupRange, max_parallelism: int):
        self.key_group_range = key_group_range
        self.max_parallelism = max_parallelism
        self._current_key: Any = None
        #: name -> bound state object
        self._states: Dict[str, Any] = {}
        #: name -> descriptor it was bound with
        self._descriptors: Dict[str, StateDescriptor] = {}
        # the introspection plane's registry (a WeakSet: free, and
        # walked only while the plane is on)
        from flink_tpu_torch.state.introspect import INTROSPECTION
        INTROSPECTION.register_backend(self)

    # ---- key context ------------------------------------------------
    def set_current_key(self, key: Any) -> None:
        self._current_key = key

    @property
    def current_key(self) -> Any:
        return self._current_key

    # ---- state binding ----------------------------------------------
    def get_or_create_keyed_state(self, descriptor: StateDescriptor):
        state = self._states.get(descriptor.name)
        if state is None:
            state = self._create_state(descriptor)
            self._states[descriptor.name] = state
            self._descriptors[descriptor.name] = descriptor
        elif self._descriptors[descriptor.name].TYPE != descriptor.TYPE:
            raise ValueError(
                f"state {descriptor.name!r} already registered as "
                f"{self._descriptors[descriptor.name].TYPE!r}, cannot rebind "
                f"as {descriptor.TYPE!r}")
        return state

    def get_partitioned_state(self, namespace, descriptor: StateDescriptor):
        """Bind and switch namespace in one call."""
        state = self.get_or_create_keyed_state(descriptor)
        state.set_current_namespace(namespace)
        return state

    def _create_state(self, descriptor: StateDescriptor):
        # most specific first; isinstance covers subclasses
        for dtype, factory in [
            (MapStateDescriptor, self.create_map_state),
            (AggregatingStateDescriptor, self.create_aggregating_state),
            (ReducingStateDescriptor, self.create_reducing_state),
            (FoldingStateDescriptor, self.create_folding_state),
            (ListStateDescriptor, self.create_list_state),
            (ValueStateDescriptor, self.create_value_state),
        ]:
            if isinstance(descriptor, dtype):
                return factory(descriptor)
        raise TypeError(f"unsupported state descriptor {descriptor!r}")

    @abc.abstractmethod
    def create_value_state(self, descriptor: ValueStateDescriptor):
        ...

    @abc.abstractmethod
    def create_list_state(self, descriptor: ListStateDescriptor):
        ...

    @abc.abstractmethod
    def create_reducing_state(self, descriptor: ReducingStateDescriptor):
        ...

    @abc.abstractmethod
    def create_aggregating_state(self, descriptor: AggregatingStateDescriptor):
        ...

    @abc.abstractmethod
    def create_folding_state(self, descriptor: FoldingStateDescriptor):
        ...

    @abc.abstractmethod
    def create_map_state(self, descriptor: MapStateDescriptor):
        ...

    # ---- batched ingest, read and clear -----------------------------
    def add_batch(self, state, keys, namespace, values, namespaces=None,
                  pre_extracted: bool = False) -> str:
        """Add ``values[i]`` under (``keys[i]``, ``namespace`` or
        ``namespaces[i]``).  Uses the state's own ``add_batch`` when it
        has one, else the exact per-row path (set_current_key +
        set_current_namespace + add).  Returns the path taken, "batch"
        or "rows".  Leaves the current key/namespace undefined."""
        from flink_tpu_torch.state.introspect import INTROSPECTION
        from flink_tpu_torch.state.stats import STATE_STATS
        n = len(keys)
        name = _state_name(state)
        if INTROSPECTION.enabled:
            INTROSPECTION.note_ingest(name, keys, self.max_parallelism)
        native = getattr(state, "add_batch", None)
        if native is not None:
            if pre_extracted:
                native(keys, namespace, values, namespaces=namespaces,
                       pre_extracted=True)
            else:
                native(keys, namespace, values, namespaces=namespaces)
            STATE_STATS.note_batch(name, n)
            return "batch"
        if namespaces is None:
            state.set_current_namespace(namespace)
        for i in range(n):
            self.set_current_key(keys[i])
            if namespaces is not None:
                state.set_current_namespace(namespaces[i])
            state.add(values[i])
        STATE_STATS.note_fallback(name, n)
        return "rows"

    def get_batch(self, state, keys, namespace, namespaces=None):
        """The batched ``state.get()``: ``(results, found, path)``, with
        ``found[i]`` False where the row has no state.  Uses the state's
        own ``get_batch`` (one flush and one gather on the GPU backend)
        when it has one.  Leaves the current key/namespace undefined."""
        from flink_tpu_torch.state.stats import STATE_STATS
        n = len(keys)
        name = _state_name(state)
        native = getattr(state, "get_batch", None)
        if native is not None:
            results, found = native(keys, namespace, namespaces=namespaces)
            STATE_STATS.note_batch(name, n)
            return results, found, "batch"
        results = []
        found = np.empty(n, bool)
        if namespaces is None:
            state.set_current_namespace(namespace)
        for i in range(n):
            self.set_current_key(keys[i])
            if namespaces is not None:
                state.set_current_namespace(namespaces[i])
            v = state.get()
            results.append(v)
            found[i] = v is not None
        STATE_STATS.note_fallback(name, n)
        return results, found, "rows"

    def clear_batch(self, state, keys, namespace, namespaces=None) -> str:
        """The batched ``state.clear()``; returns "batch" or "rows".
        Leaves the current key/namespace undefined."""
        native = getattr(state, "clear_batch", None)
        if native is not None:
            native(keys, namespace, namespaces=namespaces)
            return "batch"
        if namespaces is None:
            state.set_current_namespace(namespace)
        for i, k in enumerate(keys):
            self.set_current_key(k)
            if namespaces is not None:
                state.set_current_namespace(namespaces[i])
            state.clear()
        return "rows"

    # ---- introspection ----------------------------------------------
    def accounting_breakdown(self) -> Dict[str, Dict[int, dict]]:
        """Per-(state, key group) rows, bytes and namespace counts of the
        live state: this backend's own snapshot decoded as the offline
        inspector decodes a checkpoint's (``inspect_snapshot_chunks``),
        so live and offline accounting agree by construction.  Called
        only by the introspection plane, on demand."""
        from flink_tpu_torch.state.introspect import inspect_snapshot_chunks
        from flink_tpu_torch.state.stats import STATE_STATS
        # a read, not a checkpoint: the snapshot counters stay as they were
        counted = STATE_STATS.snapshot_rows, STATE_STATS.snapshot_columns
        try:
            snap = self.snapshot()
        finally:
            STATE_STATS.snapshot_rows, STATE_STATS.snapshot_columns = counted
        report = inspect_snapshot_chunks([snap])
        return {name: {int(kg): dict(e) for kg, e in st["key_groups"].items()}
                for name, st in report["states"].items()}

    def dispose(self) -> None:
        """Freeze the accounting into the introspection plane (while it
        is on), then drop the bound states."""
        from flink_tpu_torch.state.introspect import INTROSPECTION
        if INTROSPECTION.enabled:
            INTROSPECTION.note_dispose(self)
        self._states.clear()

    # ---- snapshot / restore -----------------------------------------
    def _meta(self) -> dict:
        # the port's descriptors carry no serializer, so it records none
        return {"backend": self.name, "max_parallelism": self.max_parallelism,
                "serializers": {}}

    @staticmethod
    def check_serializer_compatibility(snapshots) -> None:
        """A snapshot may record a serializer configuration per state.
        The port honours the plain value serializers, whose chunks hold
        the values themselves; any other configuration would need the
        serializer migration of a later slice, so it raises."""
        for snap in snapshots:
            for name, cfg in (snap.meta or {}).get("serializers", {}).items():
                if (getattr(cfg, "serializer_name", None) not in _PLAIN_SERIALIZERS
                        or getattr(cfg, "details", None)):
                    raise NotImplementedError(
                        f"state {name!r} was written with serializer "
                        f"configuration {cfg!r}; the port restores only "
                        f"{sorted(_PLAIN_SERIALIZERS)} without details "
                        "(serializer migration is not ported)")

    @abc.abstractmethod
    def snapshot(self) -> KeyedStateSnapshot:
        ...

    @abc.abstractmethod
    def restore(self, snapshots: Iterable[KeyedStateSnapshot]) -> None:
        """Restore from the chunks of one or more snapshots whose key
        group falls in this backend's range (rescale: pass the
        snapshots of every old subtask)."""


# ---------------------------------------------------------------------
# column codec of snapshot chunks (a copy of the reference's wire codec,
# flink_tpu/runtime/netchannel.py _encode_value_column /
# _decode_value_column: the chunks carry its output)
# ---------------------------------------------------------------------

def _encode_value_column(vals: list):
    """One column tree for a homogeneous list of ints, floats, strings
    or tuples of them; None when the list fits no column form.  An int
    beyond int64 raises OverflowError."""
    vt = type(vals[0])
    if vt is int:
        if any(type(v) is not int for v in vals):
            return None
        return ("i8", np.array(vals, np.int64))
    if vt is float:
        if any(type(v) is not float for v in vals):
            return None
        return ("f8", np.array(vals, np.float64))
    if vt is str:
        if any(type(v) is not str for v in vals):
            return None
        chunks = [v.encode("utf-8") for v in vals]
        offsets = np.zeros(len(chunks) + 1, np.int64)
        np.cumsum(np.fromiter((len(c) for c in chunks), np.int64,
                              len(chunks)), out=offsets[1:])
        return ("str", offsets, np.frombuffer(b"".join(chunks), np.uint8))
    if vt is tuple:
        arity = len(vals[0])
        if any(type(v) is not tuple or len(v) != arity for v in vals):
            return None
        fields = []
        for j in range(arity):
            col = _encode_value_column([v[j] for v in vals])
            if col is None:
                return None
            fields.append(col)
        return ("tuple", fields)
    return None


def _decode_value_column(col, n: int) -> list:
    kind = col[0]
    if kind == "i8" or kind == "f8":
        return col[1].tolist()
    if kind == "str":
        offs = col[1].tolist()
        data = col[2].tobytes()
        return [data[offs[i]:offs[i + 1]].decode("utf-8") for i in range(n)]
    fields = [_decode_value_column(f, n) for f in col[1]]
    if not fields:
        return [()] * n
    return list(zip(*fields))


def encode_obj_column(values) -> tuple:
    """A key or namespace column in the codec's column form, or
    ``("pickle", list)`` when the column is not strictly typed."""
    values = list(values)
    if values:
        try:
            col = _encode_value_column(values)
        except (OverflowError, ValueError):
            col = None
        if col is not None:
            return col
    return ("pickle", values)


def decode_obj_column(col, n: int) -> list:
    """Inverse of encode_obj_column."""
    if col[0] == "pickle":
        return list(col[1])
    return _decode_value_column(col, n)


def _state_name(state) -> str:
    d = getattr(state, "_descriptor", None)
    return getattr(d, "name", "?") if d is not None else "?"
