"""Heap (host-dict) keyed-state backend (port of
``flink_tpu/state/heap_backend.py``).

A ``StateTable`` is ``{namespace: {key: value}}`` per registered state;
``ColumnStateTable`` keeps int/float values of reducing and aggregating
states in typed numpy columns, so a snapshot writes one value buffer
per (state, namespace, key group).  This backend is the reference
semantics the GPU backend is tested against, it holds the GPU
backend's non-device states, and it serves ``state.backend: heap``.
Snapshots use the v2 chunk format of ``state/backend.py``.
"""

from __future__ import annotations

import pickle
from collections import defaultdict
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.core.keygroups import (KeyGroupRange,
                                            assign_key_groups_np,
                                            assign_to_key_group,
                                            stable_hashes_np)
from flink_tpu_torch.core.state import (AggregatingState,
                                        AggregatingStateDescriptor,
                                        FoldingState, FoldingStateDescriptor,
                                        ListState, ListStateDescriptor,
                                        MapState, MapStateDescriptor,
                                        ReducingState,
                                        ReducingStateDescriptor,
                                        StateDescriptor, ValueState,
                                        ValueStateDescriptor)
from flink_tpu_torch.state.backend import (VOID_NAMESPACE, KeyedStateBackend,
                                           KeyedStateSnapshot,
                                           decode_obj_column,
                                           encode_obj_column)


class StateTable:
    """{namespace: {key: value}}."""

    __slots__ = ("by_namespace",)

    def __init__(self):
        self.by_namespace: Dict[Any, Dict[Any, Any]] = {}

    def get(self, key, namespace, default=None):
        ns = self.by_namespace.get(namespace)
        if ns is None:
            return default
        return ns.get(key, default)

    def put(self, key, namespace, value) -> None:
        self.by_namespace.setdefault(namespace, {})[key] = value

    def remove(self, key, namespace) -> None:
        ns = self.by_namespace.get(namespace)
        if ns is not None:
            ns.pop(key, None)
            if not ns:
                del self.by_namespace[namespace]

    def contains(self, key, namespace) -> bool:
        ns = self.by_namespace.get(namespace)
        return ns is not None and key in ns

    def keys(self, namespace) -> Iterable[Any]:
        return self.by_namespace.get(namespace, {}).keys()

    def entries(self) -> Iterable[Tuple[Any, Any, Any]]:
        for namespace, by_key in self.by_namespace.items():
            for key, value in by_key.items():
                yield namespace, key, value

    def is_empty(self) -> bool:
        return not self.by_namespace

    def clear_all(self) -> None:
        # in place: bound state objects hold table references
        self.by_namespace.clear()


class _ColumnBlock:
    """One namespace's rows in a ColumnStateTable: a key -> slot index
    plus either a typed numpy value column (int64/float64, grown by
    doubling, swap-remove on delete) or, once any value fails the
    strict type check, a boxed Python list of the exact objects.
    Demotion is lossless (``.item()`` round-trips int64 -> int and
    float64 -> float exactly)."""

    __slots__ = ("index", "keys", "vals", "boxed")

    def __init__(self):
        self.index: Dict[Any, int] = {}
        self.keys: List[Any] = []
        self.vals: Optional[np.ndarray] = None
        self.boxed: Optional[list] = None

    def demote(self) -> None:
        if self.boxed is None:
            n = len(self.keys)
            self.boxed = ([] if self.vals is None
                          else [v.item() for v in self.vals[:n]])
            self.vals = None

    def _coltype(self, value):
        if type(value) is int:
            return np.int64
        if type(value) is float:
            return np.float64
        return None

    def put(self, key, value) -> None:
        slot = self.index.get(key)
        if self.boxed is None:
            dtype = self._coltype(value)
            if dtype is None or (self.vals is not None
                                 and self.vals.dtype != dtype):
                self.demote()
            elif self.vals is None:
                self.vals = np.empty(8, dtype)
        if self.boxed is not None:
            if slot is None:
                self.index[key] = len(self.keys)
                self.keys.append(key)
                self.boxed.append(value)
            else:
                self.boxed[slot] = value
            return
        if slot is None:
            slot = len(self.keys)
            if slot == len(self.vals):
                grown = np.empty(slot * 2, self.vals.dtype)
                grown[:slot] = self.vals
                self.vals = grown
            self.index[key] = slot
            self.keys.append(key)
        try:
            self.vals[slot] = value
        except OverflowError:
            self.demote()
            self.boxed[slot] = value

    def get(self, key, default=None):
        slot = self.index.get(key)
        if slot is None:
            return default
        if self.boxed is not None:
            return self.boxed[slot]
        return self.vals[slot].item()

    def remove(self, key) -> None:
        slot = self.index.pop(key, None)
        if slot is None:
            return
        last = len(self.keys) - 1
        if slot != last:
            moved = self.keys[last]
            self.keys[slot] = moved
            self.index[moved] = slot
            if self.boxed is not None:
                self.boxed[slot] = self.boxed[last]
            else:
                self.vals[slot] = self.vals[last]
        self.keys.pop()
        if self.boxed is not None:
            self.boxed.pop()

    def values_list(self) -> list:
        n = len(self.keys)
        if self.boxed is not None:
            return list(self.boxed)
        return [] if self.vals is None else [v.item() for v in self.vals[:n]]


class ColumnStateTable:
    """StateTable with typed numpy value columns:
    ``{namespace: _ColumnBlock}``.  Same interface as StateTable; int
    and float values live in typed columns, which snapshot as one
    buffer per (state, namespace, key group) and restore in bulk.  An
    opaque value demotes its namespace's block to a boxed list."""

    __slots__ = ("blocks",)

    def __init__(self):
        self.blocks: Dict[Any, _ColumnBlock] = {}

    def get(self, key, namespace, default=None):
        b = self.blocks.get(namespace)
        if b is None:
            return default
        return b.get(key, default)

    def put(self, key, namespace, value) -> None:
        b = self.blocks.get(namespace)
        if b is None:
            b = self.blocks[namespace] = _ColumnBlock()
        b.put(key, value)

    def remove(self, key, namespace) -> None:
        b = self.blocks.get(namespace)
        if b is not None:
            b.remove(key)
            if not b.keys:
                del self.blocks[namespace]

    def contains(self, key, namespace) -> bool:
        b = self.blocks.get(namespace)
        return b is not None and key in b.index

    def keys(self, namespace) -> Iterable[Any]:
        b = self.blocks.get(namespace)
        return list(b.keys) if b is not None else []

    def entries(self) -> Iterable[Tuple[Any, Any, Any]]:
        for namespace, b in self.blocks.items():
            for key, value in zip(list(b.keys), b.values_list()):
                yield namespace, key, value

    def is_empty(self) -> bool:
        return not self.blocks

    def clear_all(self) -> None:
        self.blocks.clear()

    def bulk_load(self, namespace, keys, vals: np.ndarray) -> None:
        """Restore fast path: append a whole decoded column."""
        b = self.blocks.get(namespace)
        if b is None and len(keys):
            b = self.blocks[namespace] = _ColumnBlock()
            b.keys = list(keys)
            b.index = {k: i for i, k in enumerate(b.keys)}
            b.vals = np.array(vals)
            return
        for k, v in zip(keys, vals):
            b.put(k, v.item())

    def column_blocks(self):
        """Snapshot view: yields (namespace, keys, vals_ndarray|None,
        boxed_list|None) per namespace block."""
        for namespace, b in self.blocks.items():
            n = len(b.keys)
            if b.boxed is not None:
                yield namespace, b.keys, None, b.boxed
            else:
                vals = b.vals[:n] if b.vals is not None else np.empty(0)
                yield namespace, b.keys, vals, None


def split_column_by_key_group(keys, max_parallelism: int):
    """ONE vectorized hash pass: key column → ordered per-key-group
    index segments.  Yields (key_group, row_index_array); row order
    within a group preserves column order (stable sort)."""
    n = len(keys)
    if n == 0:
        return
    kgs = assign_key_groups_np(stable_hashes_np(keys), max_parallelism)
    order = np.argsort(kgs, kind="stable")
    sorted_kgs = kgs[order]
    bounds = np.nonzero(np.diff(sorted_kgs))[0] + 1
    start = 0
    for end in list(bounds) + [n]:
        yield int(sorted_kgs[start]), order[start:end]
        start = end


#: sentinel for "no namespace seen yet" in the batched read's
#: last-block cache (None and () are both real namespaces)
_NO_NAMESPACE = object()


class _AbstractHeapState:
    def __init__(self, backend: "HeapKeyedStateBackend", descriptor: StateDescriptor,
                 table: StateTable):
        self._backend = backend
        self._descriptor = descriptor
        self._table = table
        self._namespace = VOID_NAMESPACE

    def set_current_namespace(self, namespace) -> None:
        self._namespace = namespace

    @property
    def _key(self):
        return self._backend.current_key

    def clear(self) -> None:
        self._table.remove(self._key, self._namespace)

    def clear_batch(self, keys, namespace, namespaces=None) -> None:
        """Batched twin of clear(): one table.remove per row, no
        backend key-context churn (the fire path's one-call cleanup)."""
        remove = self._table.remove
        if namespaces is None:
            for k in keys:
                remove(k, namespace)
        else:
            for i, k in enumerate(keys):
                remove(k, namespaces[i])

    def _get_rows_batch(self, keys, namespace, namespaces) -> list:
        """Raw stored values for many (key, namespace) rows — COLUMN-
        DIRECT when the table is a ColumnStateTable: one block fetch
        per distinct namespace, values read straight out of the typed
        numpy column (the identical .item() boxing scalar reads
        perform).  Absent rows are None."""
        n = len(keys)
        out: list = [None] * n
        blocks = getattr(self._table, "blocks", None)
        if blocks is None:
            get = self._table.get
            if namespaces is None:
                for i in range(n):
                    out[i] = get(keys[i], namespace)
            else:
                for i in range(n):
                    out[i] = get(keys[i], namespaces[i])
            return out
        if namespaces is None:
            b = blocks.get(namespace)
            if b is None:
                return out
            idx, boxed, vals = b.index, b.boxed, b.vals
            for i in range(n):
                slot = idx.get(keys[i])
                if slot is not None:
                    out[i] = (boxed[slot] if boxed is not None
                              else vals[slot].item())
            return out
        # per-row namespaces arrive grouped-by-window from the timer
        # sweep, so caching the last block makes this one dict fetch
        # per distinct window, not per row
        cur: Any = _NO_NAMESPACE
        b = None
        for i in range(n):
            ns = namespaces[i]
            if ns != cur:
                cur = ns
                b = blocks.get(ns)
            if b is None:
                continue
            slot = b.index.get(keys[i])
            if slot is not None:
                out[i] = (b.boxed[slot] if b.boxed is not None
                          else b.vals[slot].item())
        return out

    @staticmethod
    def _group_rows(keys, namespace, namespaces):
        """Group row indices by (key, namespace), preserving row order
        within each group — the invariant that keeps a batched fold
        bit-identical to the scalar add loop for ANY fold function
        (float reduction order included)."""
        groups: Dict[Any, List[int]] = {}
        if namespaces is None:
            for i, k in enumerate(keys):
                groups.setdefault((k, namespace), []).append(i)
        else:
            for i, k in enumerate(keys):
                groups.setdefault((k, namespaces[i]), []).append(i)
        return groups


class HeapValueState(_AbstractHeapState, ValueState):
    def value(self):
        v = self._table.get(self._key, self._namespace)
        if v is None:
            return self._descriptor.get_default_value()
        return v

    def update(self, value) -> None:
        if value is None:
            self.clear()
        else:
            self._table.put(self._key, self._namespace, value)


class HeapListState(_AbstractHeapState, ListState):
    def get(self):
        v = self._table.get(self._key, self._namespace)
        return list(v) if v else None

    def add(self, value) -> None:
        v = self._table.get(self._key, self._namespace)
        if v is None:
            self._table.put(self._key, self._namespace, [value])
        else:
            v.append(value)

    def add_all(self, values) -> None:
        values = list(values)
        if not values:
            return
        v = self._table.get(self._key, self._namespace)
        if v is None:
            self._table.put(self._key, self._namespace, values)
        else:
            v.extend(values)

    def update(self, values) -> None:
        values = list(values)
        if values:
            self._table.put(self._key, self._namespace, values)
        else:
            self.clear()

    def add_batch(self, keys, namespace, values, namespaces=None) -> None:
        """Batched twin of add(): one table get/put per (key, ns)
        group, elements appended in row order."""
        for (k, ns), idxs in self._group_rows(keys, namespace,
                                              namespaces).items():
            cur = self._table.get(k, ns)
            rows = [values[i] for i in idxs]
            if cur is None:
                self._table.put(k, ns, rows)
            else:
                cur.extend(rows)

    def get_batch(self, keys, namespace, namespaces=None):
        """Batched twin of get(): one table read per row, contents
        copied exactly as get() does (empty lists read as absent)."""
        rows = self._get_rows_batch(keys, namespace, namespaces)
        found = np.fromiter((bool(v) for v in rows), bool, len(rows))
        return [list(v) if v else None for v in rows], found

    def merge_namespaces(self, target, sources) -> None:
        """Concatenate the sources' lists into the target's."""
        merged = self._table.get(self._key, target) or []
        for src in sources:
            v = self._table.get(self._key, src)
            if v:
                merged.extend(v)
            self._table.remove(self._key, src)
        if merged:
            self._table.put(self._key, target, merged)


class HeapReducingState(_AbstractHeapState, ReducingState):
    def __init__(self, backend, descriptor: ReducingStateDescriptor, table):
        super().__init__(backend, descriptor, table)
        self._reduce = descriptor.reduce_function.reduce

    def get(self):
        return self._table.get(self._key, self._namespace)

    def add(self, value) -> None:
        cur = self._table.get(self._key, self._namespace)
        self._table.put(self._key, self._namespace,
                        value if cur is None else self._reduce(cur, value))

    def add_batch(self, keys, namespace, values, namespaces=None) -> None:
        """Batched twin of add(): grouped in-order fold — bit-equal to
        the scalar loop for any reduce function."""
        reduce = self._reduce
        for (k, ns), idxs in self._group_rows(keys, namespace,
                                              namespaces).items():
            cur = self._table.get(k, ns)
            for i in idxs:
                v = values[i]
                cur = v if cur is None else reduce(cur, v)
            self._table.put(k, ns, cur)

    def get_batch(self, keys, namespace, namespaces=None):
        """Batched twin of get(): direct column reads (the reduced
        value IS the stored value), no key-context churn."""
        rows = self._get_rows_batch(keys, namespace, namespaces)
        found = np.fromiter((v is not None for v in rows), bool,
                            len(rows))
        return rows, found

    def merge_namespaces(self, target, sources) -> None:
        merged = self._table.get(self._key, target)
        for src in sources:
            v = self._table.get(self._key, src)
            self._table.remove(self._key, src)
            if v is not None:
                merged = v if merged is None else self._reduce(merged, v)
        if merged is not None:
            self._table.put(self._key, target, merged)


class HeapAggregatingState(_AbstractHeapState, AggregatingState):
    """add -> agg.add(value, acc)."""

    def __init__(self, backend, descriptor: AggregatingStateDescriptor, table):
        super().__init__(backend, descriptor, table)
        self._agg = descriptor.aggregate_function

    def get(self):
        acc = self._table.get(self._key, self._namespace)
        if acc is None:
            return None
        return self._agg.get_result(acc)

    def get_accumulator(self):
        return self._table.get(self._key, self._namespace)

    def add(self, value) -> None:
        acc = self._table.get(self._key, self._namespace)
        if acc is None:
            acc = self._agg.create_accumulator()
        acc = self._agg.add(value, acc)
        self._table.put(self._key, self._namespace, acc)

    def add_batch(self, keys, namespace, values, namespaces=None) -> None:
        """Batched twin of add(): grouped in-order accumulator fold."""
        agg = self._agg
        for (k, ns), idxs in self._group_rows(keys, namespace,
                                              namespaces).items():
            acc = self._table.get(k, ns)
            for i in idxs:
                if acc is None:
                    acc = agg.create_accumulator()
                acc = agg.add(values[i], acc)
            self._table.put(k, ns, acc)

    def get_batch(self, keys, namespace, namespaces=None):
        """Batched twin of get(): accumulators read column-direct,
        finalized per row through agg.get_result in row order — the
        exact scalar result for any aggregate function."""
        accs = self._get_rows_batch(keys, namespace, namespaces)
        get_result = self._agg.get_result
        found = np.fromiter((a is not None for a in accs), bool,
                            len(accs))
        return [None if a is None else get_result(a) for a in accs], found

    def merge_namespaces(self, target, sources) -> None:
        merged = self._table.get(self._key, target)
        for src in sources:
            v = self._table.get(self._key, src)
            self._table.remove(self._key, src)
            if v is not None:
                merged = v if merged is None else self._agg.merge(merged, v)
        if merged is not None:
            self._table.put(self._key, target, merged)


class HeapFoldingState(_AbstractHeapState, FoldingState):
    def __init__(self, backend, descriptor: FoldingStateDescriptor, table):
        super().__init__(backend, descriptor, table)
        self._fold = descriptor.fold_function

    def get(self):
        return self._table.get(self._key, self._namespace)

    def add(self, value) -> None:
        acc = self._table.get(self._key, self._namespace)
        if acc is None:
            acc = self._descriptor.get_default_value()
        self._table.put(self._key, self._namespace, self._fold(acc, value))


class HeapMapState(_AbstractHeapState, MapState):
    def _map(self, create=False) -> Optional[dict]:
        m = self._table.get(self._key, self._namespace)
        if m is None and create:
            m = {}
            self._table.put(self._key, self._namespace, m)
        return m

    def get(self, key):
        m = self._map()
        return None if m is None else m.get(key)

    def put(self, key, value) -> None:
        self._map(create=True)[key] = value

    def put_all(self, mapping: dict) -> None:
        if mapping:
            self._map(create=True).update(mapping)

    def remove(self, key) -> None:
        m = self._map()
        if m is not None:
            m.pop(key, None)
            if not m:
                self.clear()

    def contains(self, key) -> bool:
        m = self._map()
        return m is not None and key in m

    def entries(self):
        m = self._map()
        return list(m.items()) if m else []

    def keys(self):
        m = self._map()
        return list(m.keys()) if m else []

    def values(self):
        m = self._map()
        return list(m.values()) if m else []

    def is_empty(self) -> bool:
        m = self._map()
        return not m


class HeapKeyedStateBackend(KeyedStateBackend):
    """All registered states as host dict tables."""

    name = "heap"

    def __init__(self, key_group_range: KeyGroupRange, max_parallelism: int):
        super().__init__(key_group_range, max_parallelism)
        self._tables: Dict[str, Any] = {}

    def _table(self, name: str, columnar: bool = False):
        """A name's table; ``columnar=True`` asks for the numpy column
        table (reducing/aggregating states).  An existing table of
        either kind is reused: the interfaces are the same."""
        t = self._tables.get(name)
        if t is None:
            t = ColumnStateTable() if columnar else StateTable()
            self._tables[name] = t
        return t

    # ---- factories --------------------------------------------------
    def create_value_state(self, d: ValueStateDescriptor):
        return HeapValueState(self, d, self._table(d.name))

    def create_list_state(self, d: ListStateDescriptor):
        return HeapListState(self, d, self._table(d.name))

    def create_reducing_state(self, d: ReducingStateDescriptor):
        return HeapReducingState(self, d, self._table(d.name, columnar=True))

    def create_aggregating_state(self, d: AggregatingStateDescriptor):
        return HeapAggregatingState(self, d,
                                    self._table(d.name, columnar=True))

    def create_folding_state(self, d: FoldingStateDescriptor):
        return HeapFoldingState(self, d, self._table(d.name))

    def create_map_state(self, d: MapStateDescriptor):
        return HeapMapState(self, d, self._table(d.name))

    # ---- snapshot / restore -----------------------------------------
    def snapshot(self) -> KeyedStateSnapshot:
        """Per-key-group v2 chunks: each typed column block as one key
        column and one value buffer, everything else per row."""
        per_kg_rows: Dict[int, list] = defaultdict(list)
        per_kg_cols: Dict[int, Dict[str, list]] = defaultdict(dict)
        mp = self.max_parallelism
        for name, table in self._tables.items():
            if isinstance(table, ColumnStateTable):
                for namespace, bkeys, vals, boxed in table.column_blocks():
                    if vals is None:
                        for key, value in zip(bkeys, boxed):
                            per_kg_rows[assign_to_key_group(key, mp)].append(
                                (name, namespace, key, value))
                        continue
                    for kg, idx in split_column_by_key_group(bkeys, mp):
                        per_kg_cols[kg].setdefault(name, []).append({
                            "keys": encode_obj_column([bkeys[i] for i in idx]),
                            "ns": ("const", namespace),
                            "comps": {"value": vals[idx]},
                            "kind": "scalar",
                        })
            else:
                for namespace, key, value in table.entries():
                    per_kg_rows[assign_to_key_group(key, mp)].append(
                        (name, namespace, key, value))
        chunks = {kg: pickle.dumps({"v": 2, "rows": per_kg_rows.get(kg, []),
                                    "cols": per_kg_cols.get(kg, {})},
                                   protocol=pickle.HIGHEST_PROTOCOL)
                  for kg in set(per_kg_rows) | set(per_kg_cols)}
        return KeyedStateSnapshot(chunks, meta=self._meta())

    def _restore_cols(self, cols: dict) -> None:
        for name, blocks in cols.items():
            for block in blocks:
                comps = block["comps"]
                n = len(next(iter(comps.values()))) if comps else 0
                keys = decode_obj_column(block["keys"], n)
                ns_field = block["ns"]
                if block["kind"] == "scalar":
                    vals = comps["value"]
                    table = self._table(name, columnar=True)
                    if (ns_field[0] == "const"
                            and isinstance(table, ColumnStateTable)):
                        table.bulk_load(ns_field[1], keys, vals)
                    else:
                        namespaces = ([ns_field[1]] * n
                                      if ns_field[0] == "const"
                                      else decode_obj_column(ns_field[1], n))
                        for k, ns, v in zip(keys, namespaces, vals):
                            table.put(k, ns, v.item())
                    continue
                # device accumulator block -> per-row accumulator dicts,
                # the format HeapAggregatingState folds into
                namespaces = ([ns_field[1]] * n if ns_field[0] == "const"
                              else decode_obj_column(ns_field[1], n))
                table = self._table(name)
                for i in range(n):
                    table.put(keys[i], namespaces[i],
                              {c: np.array(arr[i]) for c, arr in comps.items()})

    def restore(self, snapshots) -> None:
        snapshots = list(snapshots)
        self.check_serializer_compatibility(snapshots)
        # in place: bound state objects hold table references
        for table in self._tables.values():
            table.clear_all()
        for snap in snapshots:
            for kg, blob in snap.blobs():
                if not self.key_group_range.contains(kg):
                    continue
                chunk = load_chunk(blob)
                for name, namespace, key, value in chunk["rows"]:
                    self._table(name).put(key, namespace, value)
                self._restore_cols(chunk["cols"])


def load_chunk(blob: bytes) -> dict:
    """One key group's chunk; only the v2 format is read."""
    chunk = pickle.loads(blob)
    if not (isinstance(chunk, dict) and chunk.get("v") == 2):
        raise ValueError("keyed-state chunk is not in the v2 format")
    return chunk
