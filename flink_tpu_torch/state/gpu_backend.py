"""GPU-resident keyed-state backend (port of
``flink_tpu/state/tpu_backend.py``).

Aggregation state of every key of the subtask's key-group range lives
as struct-of-arrays in device memory (``{component: [capacity, ...]}``,
one ``torch.Tensor`` each); a host dict maps (key, namespace) to a
dense slot, and updates are micro-batched: ``add`` appends to host
pending lists, and every ``microbatch`` rows one flush scatters them
with one kernel launch per component.  Reads (window fires) flush and
then gather.  States of arbitrary Python values (value, list, map,
and reducing/aggregating state over a non-device function) live in the
heap backend's host tables, as the reference keeps them.

Device programs, each a kernel of ``flink_tpu_torch.kernels``:

=====================  =======================================  ==================
reference program      what it does                             kernel
=====================  =======================================  ==================
``_jit_update``        flush: scatter the pending rows          ``hll_update`` (raw
                                                                lanes) /
                                                                ``scatter_combine``
``_jit_result``        gather and finalize fired slots          ``hll_estimate``
                                                                (Sum…Avg: a gather)
``_jit_clear``         refill freed slots                       ``clear_rows``
``_jit_merge``         session merge, a dst may repeat          ``merge_rows``
``_jit_merge_rows``    batched session merge, unique dst        ``merge_rows``
``_jit_upload``,       host rows into slots (promotion,         ``set_rows``
restore ``.at[].set``  restore)
=====================  =======================================  ==================

The reference replaces its arrays on every update (donated buffers);
the port updates the tensors in place, and ``_device_lock`` guards the
operations that replace them (grow) or rewrite many rows (restore).
Flushes send exactly the pending rows: no padding to a power of two.
The host-RAM spill tier keeps the reference's rule: with a device-slot
budget (``max_device_slots``) the coldest quarter of slots moves to
host RAM when no slot is free, and an access promotes a row back.
Queryable state, telemetry and statistics are later slices.
"""

from __future__ import annotations

import pickle
import threading
from collections import defaultdict
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from flink_tpu_torch.core.keygroups import (KeyGroupRange, assign_to_key_group,
                                            stable_hash64)
from flink_tpu_torch.core.state import (AggregatingState,
                                        AggregatingStateDescriptor,
                                        FoldingStateDescriptor,
                                        ListStateDescriptor,
                                        MapStateDescriptor,
                                        ReducingStateDescriptor,
                                        ValueStateDescriptor)
from flink_tpu_torch.device import DeviceLike, resolve_device
from flink_tpu_torch.kernels import set_rows
from flink_tpu_torch.ops.device_agg import (DeviceAggregateFunction,
                                            device_dtype)
from flink_tpu_torch.state.backend import (VOID_NAMESPACE, KeyedStateBackend,
                                           KeyedStateSnapshot,
                                           decode_obj_column,
                                           encode_obj_column)
from flink_tpu_torch.state.heap_backend import (HeapAggregatingState,
                                                HeapFoldingState,
                                                HeapListState, HeapMapState,
                                                HeapReducingState,
                                                HeapValueState, StateTable,
                                                load_chunk,
                                                split_column_by_key_group)

DEFAULT_INITIAL_CAPACITY = 4096
DEFAULT_MICROBATCH = 16384


def _round_up_pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


class DeviceAggregatingState(AggregatingState):
    """Slot-indexed, micro-batched device aggregation state: the
    AggregatingState contract, with ``add`` queueing into the pending
    lists and ``get`` flushing, then gathering."""

    def __init__(self, backend: "GpuKeyedStateBackend",
                 descriptor: AggregatingStateDescriptor,
                 initial_capacity: int = DEFAULT_INITIAL_CAPACITY,
                 microbatch: int = DEFAULT_MICROBATCH,
                 max_device_slots: Optional[int] = None):
        agg = descriptor.aggregate_function
        if not isinstance(agg, DeviceAggregateFunction):
            raise TypeError("device state needs a DeviceAggregateFunction")
        self._backend = backend
        self._descriptor = descriptor
        self.agg: DeviceAggregateFunction = agg
        self.device = backend.device
        self._namespace = VOID_NAMESPACE
        self.capacity = initial_capacity
        self.device_state: Dict[str, torch.Tensor] = agg.init_state(
            initial_capacity, device=self.device)
        #: (key, namespace) -> slot
        self.slot_index: Dict[Tuple[Any, Any], int] = {}
        #: slot -> (key, namespace), None when free
        self.slot_meta: List[Optional[Tuple[Any, Any]]] = [None] * initial_capacity
        self._free: List[int] = list(range(initial_capacity - 1, -1, -1))
        self.microbatch = microbatch
        #: device-slot budget; None = grow on demand
        self.max_device_slots = max_device_slots
        #: (key, namespace) -> {component: numpy row} evicted to host RAM
        self.host_tier: Dict[Tuple[Any, Any], Dict[str, np.ndarray]] = {}
        #: per-slot last-access stamps (an approximate LRU clock)
        self._access_stamp: List[int] = [0] * initial_capacity
        #: per slot: some update has landed on the device (a slot whose
        #: first adds are still pending holds only the fill)
        self._slot_flushed = bytearray(initial_capacity)
        self._clock = 0
        self.evictions = 0
        self.promotions = 0
        self._pending_slots: List[int] = []
        self._pending_values: List[Any] = []
        self._pending_hi: List[int] = []
        self._pending_lo: List[int] = []
        self._device_lock = threading.RLock()

    def set_current_namespace(self, namespace) -> None:
        self._namespace = namespace

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _slots(self, slots) -> torch.Tensor:
        return self._to_device(np.asarray(slots, np.int32))

    # ---- slot management --------------------------------------------
    def _slot_for(self, key, namespace, create: bool = True) -> Optional[int]:
        entry = (key, namespace)
        slot = self.slot_index.get(entry)
        if slot is None and entry in self.host_tier:
            slot = self._promote(entry)
        if slot is None and create:
            if not self._free:
                self._make_room()
            slot = self._free.pop()
            self.slot_index[entry] = slot
            self.slot_meta[slot] = entry
        if slot is not None:
            self._clock += 1
            self._access_stamp[slot] = self._clock
        return slot

    def _make_room(self) -> None:
        """No free slot: grow the device state, or at the budget spill
        the coldest quarter of slots to the host tier."""
        if (self.max_device_slots is None
                or self.capacity * 2 <= self.max_device_slots):
            self._grow(self.capacity * 2)
            return
        self._evict_cold(max(1, self.capacity // 4))

    def _evict_cold(self, n: int) -> None:
        self._flush()
        # never evict recently touched slots: a batch being assembled
        # holds up to `microbatch` fresh slots and a merge re-stamps its
        # sources just before it allocates the target (+16 margin)
        protected = self._clock - (2 * self.microbatch + 16)
        candidates = [(self._access_stamp[s], s)
                      for s, meta in enumerate(self.slot_meta)
                      if meta is not None and self._access_stamp[s] < protected]
        if not candidates:
            # everything is hot: grow past the budget rather than take
            # a slot an in-flight batch holds (a soft cap)
            self._grow(self.capacity * 2)
            return
        candidates.sort()
        victims = [s for _, s in candidates[:n]]
        idx = self._slots(victims)
        host_rows = {name: arr.index_select(0, idx.to(torch.int64)).cpu().numpy()
                     for name, arr in self.device_state.items()}
        for i, s in enumerate(victims):
            entry = self.slot_meta[s]
            self.host_tier[entry] = {name: host_rows[name][i]
                                     for name in host_rows}
            del self.slot_index[entry]
            self.slot_meta[s] = None
        with self._device_lock:
            self.agg.clear_slots(self.device_state, idx)
            for s in victims:
                self._slot_flushed[s] = 0
        self._free.extend(victims)
        self.evictions += len(victims)

    def _promote(self, entry) -> int:
        """A host-tier entry is accessed: upload its row into a free
        slot (one ``set_rows`` launch per component).  The index entry
        is published only after the upload."""
        if not self._free:
            self._make_room()
        slot = self._free.pop()
        row = self.host_tier[entry]
        idx = self._slots([slot])
        with self._device_lock:
            for name, val in row.items():
                set_rows(self.device_state[name], idx,
                         torch.from_numpy(np.array(val)[None]))
            del self.host_tier[entry]
            self.slot_index[entry] = slot
            self._slot_flushed[slot] = 1
        self.slot_meta[slot] = entry
        # a promoted slot is hot: stamp it, or a later promotion in the
        # same batch could evict it right back
        self._clock += 1
        self._access_stamp[slot] = self._clock
        self.promotions += 1
        return slot

    def _grow(self, new_capacity: int) -> None:
        """Double the arena: new tensors, the old rows copied (old and
        new arenas are held at once during the copy)."""
        self._flush()
        with self._device_lock:
            self.device_state = self.agg.grow_state(self.device_state,
                                                    new_capacity)
        grown = new_capacity - self.capacity
        self._free.extend(range(new_capacity - 1, self.capacity - 1, -1))
        self._access_stamp.extend([0] * grown)
        self._slot_flushed.extend(bytes(grown))
        self.slot_meta.extend([None] * grown)
        self.capacity = new_capacity

    # ---- write path -------------------------------------------------
    def add(self, value) -> None:
        slot = self._slot_for(self._backend.current_key, self._namespace)
        self._pending_slots.append(slot)
        value = self.agg.extract_value(value)
        if self.agg.needs_value:
            self._pending_values.append(value)
        if self.agg.needs_value_hash:
            h = stable_hash64(value)
            self._pending_hi.append(h >> 32)
            self._pending_lo.append(h & 0xFFFFFFFF)
        if len(self._pending_slots) >= self.microbatch:
            self._flush()

    def add_batch(self, keys: Iterable[Any], namespace, values,
                  namespaces=None, pre_extracted: bool = False) -> None:
        """Batched ``add``: one slot-lookup loop.  ``namespace`` is the
        batch's one namespace unless ``namespaces`` gives one per row;
        ``pre_extracted`` means the caller already applied the
        aggregate's ``extract_value`` to ``values``."""
        keys = list(keys)
        if self.max_device_slots is not None and len(keys) > self.microbatch:
            # capped backend: resolve slots in microbatch-sized chunks,
            # so an eviction late in the loop can never take a slot
            # resolved earlier in the same chunk
            for i in range(0, len(keys), self.microbatch):
                sl = slice(i, i + self.microbatch)
                self.add_batch(keys[sl], namespace,
                               values[sl] if values is not None else None,
                               namespaces=None if namespaces is None
                               else namespaces[sl],
                               pre_extracted=pre_extracted)
            return
        slot_for = self._slot_for
        if namespaces is None:
            slots = [slot_for(k, namespace) for k in keys]
        else:
            slots = [slot_for(k, namespaces[i]) for i, k in enumerate(keys)]
        self._pending_slots.extend(slots)
        extract = self.agg.extract_value
        # overridden on the class or on the instance (a plain function
        # set on the instance has no __func__)
        if not pre_extracted and getattr(
                extract, "__func__",
                None) is not DeviceAggregateFunction.extract_value:
            values = [extract(v) for v in values]
        if self.agg.needs_value:
            self._pending_values.extend(values)
        if self.agg.needs_value_hash:
            hi = self._pending_hi
            lo = self._pending_lo
            for v in values:
                h = stable_hash64(v)
                hi.append(h >> 32)
                lo.append(h & 0xFFFFFFFF)
        if len(self._pending_slots) >= self.microbatch:
            self._flush()

    def _flush(self) -> None:
        n = len(self._pending_slots)
        if n == 0:
            return
        with self._device_lock:
            self._flush_locked(n)

    def _flush_locked(self, n: int) -> None:
        """One update launch per component over exactly the n pending
        rows; HLL gets the value hashes' raw 32-bit lanes."""
        agg = self.agg
        slots = self._slots(self._pending_slots)
        values = hi = lo = None
        if agg.needs_value:
            values = self._to_device(
                np.asarray(self._pending_values, agg.value_dtype)
                .astype(device_dtype(agg.value_dtype)))
        if agg.needs_value_hash:
            hi = self._to_device(np.asarray(self._pending_hi, np.uint64)
                                 .astype(np.uint32).view(np.int32))
            lo = self._to_device(np.asarray(self._pending_lo, np.uint64)
                                 .astype(np.uint32).view(np.int32))
        agg.update(self.device_state, slots, values, hi, lo, n)
        flushed = self._slot_flushed
        for s in self._pending_slots:
            flushed[s] = 1
        self._pending_slots.clear()
        self._pending_values.clear()
        self._pending_hi.clear()
        self._pending_lo.clear()

    # ---- read path --------------------------------------------------
    def _result(self, state, slots: torch.Tensor) -> np.ndarray:
        return self.agg.result(state, slots).cpu().numpy()

    def get(self):
        slot = self._slot_for(self._backend.current_key, self._namespace,
                              create=False)
        if slot is None:
            return None
        self._flush()
        out = self._result(self.device_state, self._slots([slot]))[0]
        return out.item() if np.ndim(out) == 0 else out

    def get_batch(self, keys, namespace, namespaces=None
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """Results of many (key, namespace) rows in one device round
        trip: one flush, one gather, one copy to the host.  Spilled rows
        are finalized from their host rows without promotion.  Returns
        (results, found)."""
        keys = list(keys)
        n = len(keys)
        slot_index = self.slot_index
        host_tier = self.host_tier
        slots = np.zeros(n, np.int32)
        found = np.zeros(n, bool)
        spill_idx: List[int] = []
        spill_rows: List[Dict[str, np.ndarray]] = []
        stamp = self._access_stamp
        for i, k in enumerate(keys):
            entry = (k, namespace if namespaces is None else namespaces[i])
            s = slot_index.get(entry)
            if s is not None:
                slots[i] = s
                found[i] = True
                self._clock += 1
                stamp[s] = self._clock
                continue
            row = host_tier.get(entry)
            if row is not None:
                spill_idx.append(i)
                spill_rows.append(row)
                found[i] = True
        self._flush()
        res = self._result(self.device_state, self._slots(slots))
        if spill_idx:
            res[spill_idx] = self._finalize_spilled(spill_rows)
        return res, found

    def _finalize_spilled(self, rows: List[Dict[str, np.ndarray]]) -> np.ndarray:
        """Results of host-tier rows: stack them into a temporary state
        on the device and finalize it with the same kernels."""
        state = {name: self._to_device(np.stack([r[name] for r in rows]))
                 for name in self.device_state}
        return self._result(state, self._slots(np.arange(len(rows))))

    # ---- clear and merge --------------------------------------------
    def clear(self) -> None:
        entry = (self._backend.current_key, self._namespace)
        self.host_tier.pop(entry, None)
        slot = self.slot_index.pop(entry, None)
        if slot is None:
            return
        self._flush()
        with self._device_lock:
            self.agg.clear_slots(self.device_state, self._slots([slot]))
            self._slot_flushed[slot] = 0
        self.slot_meta[slot] = None
        self._free.append(slot)

    def clear_batch(self, keys, namespace, namespaces=None) -> None:
        slots = []
        for i, k in enumerate(keys):
            ns = namespace if namespaces is None else namespaces[i]
            self.host_tier.pop((k, ns), None)
            s = self.slot_index.pop((k, ns), None)
            if s is not None:
                slots.append(s)
                self.slot_meta[s] = None
        if not slots:
            return
        self._flush()
        with self._device_lock:
            self.agg.clear_slots(self.device_state, self._slots(slots))
            for s in slots:
                self._slot_flushed[s] = 0
        self._free.extend(slots)

    def merge_namespaces(self, target, sources) -> None:
        """Session-window merge of the current key's ``sources`` into
        ``target``: one ``merge_slots`` (dst repeats), then the source
        slots are cleared and freed."""
        key = self._backend.current_key
        self._flush()
        # spilled sources take part in the merge: promote them first
        for src in sources:
            if (key, src) in self.host_tier:
                self._promote((key, src))
        if (key, target) in self.host_tier:
            self._promote((key, target))
        # stamp every source before the target is allocated below, so
        # making room cannot evict a slot this merge still reads
        live_sources = []
        for src in sources:
            s = self.slot_index.get((key, src))
            if s is not None:
                self._clock += 1
                self._access_stamp[s] = self._clock
                live_sources.append((src, s))
        # merging only empty namespaces leaves no state, as on the heap
        if not live_sources:
            return
        dst = self._slot_for(key, target)
        src_slots = []
        for src, s in live_sources:
            del self.slot_index[(key, src)]
            if s != dst:
                src_slots.append(s)
                self.slot_meta[s] = None
        if not src_slots:
            return
        srcs = self._slots(src_slots)
        with self._device_lock:
            self.agg.merge_slots(self.device_state,
                                 self._slots([dst] * len(src_slots)), srcs)
            self.agg.clear_slots(self.device_state, srcs)
            self._slot_flushed[dst] = 1
            for s in src_slots:
                self._slot_flushed[s] = 0
        self._free.extend(src_slots)

    def merge_namespaces_batch(self, merges) -> None:
        """Batched session merge over ``(key, target, [sources])``
        triples: one flush, then rounds of ``merge_rows`` (round r
        folds each target's r-th live source, so every launch has
        unique dst), then one clear of every source slot.  The state
        afterwards equals ``merge_namespaces`` per triple."""
        self._flush()
        plans = []  # (dst_slot, [src_slots])
        for key, target, sources in merges:
            for src in sources:
                if (key, src) in self.host_tier:
                    self._promote((key, src))
            if (key, target) in self.host_tier:
                self._promote((key, target))
            live = []
            for src in sources:
                s = self.slot_index.get((key, src))
                if s is not None:
                    self._clock += 1
                    self._access_stamp[s] = self._clock
                    live.append((src, s))
            if not live:
                continue
            dst = self._slot_for(key, target)
            srcs = []
            for src, s in live:
                del self.slot_index[(key, src)]
                if s != dst:
                    srcs.append(s)
                    self.slot_meta[s] = None
            if srcs:
                plans.append((dst, srcs))
        if not plans:
            return
        rounds = max(len(srcs) for _, srcs in plans)
        all_srcs: List[int] = []
        with self._device_lock:
            for r in range(rounds):
                dsts = [dst for dst, srcs in plans if len(srcs) > r]
                srcs = [srcs[r] for _, srcs in plans if len(srcs) > r]
                self.agg.merge_rows(self.device_state, self._slots(dsts),
                                    self._slots(srcs))
                all_srcs.extend(srcs)
            self.agg.clear_slots(self.device_state, self._slots(all_srcs))
            for dst, _ in plans:
                self._slot_flushed[dst] = 1
            for s in all_srcs:
                self._slot_flushed[s] = 0
        self._free.extend(all_srcs)

    # ---- snapshot ---------------------------------------------------
    def snapshot_columns(self) -> Dict[int, Tuple[list, list, Dict[str, np.ndarray]]]:
        """Per key group: (keys, namespaces, {component: stacked rows}).
        One device gather of the live slots and one copy to the host
        per component; host-tier rows are appended."""
        self._flush()
        keys: List[Any] = []
        nss: List[Any] = []
        slots: List[int] = []
        for (key, namespace), slot in self.slot_index.items():
            keys.append(key)
            nss.append(namespace)
            slots.append(slot)
        idx = self._slots(slots).to(torch.int64)
        comps = {name: arr.index_select(0, idx).cpu().numpy()
                 for name, arr in self.device_state.items()}
        if self.host_tier:
            spilled = list(self.host_tier.items())
            for (key, namespace), _ in spilled:
                keys.append(key)
                nss.append(namespace)
            comps = {name: np.concatenate(
                [comps[name], np.stack([row[name] for _, row in spilled])])
                for name in comps}
        out: Dict[int, Tuple[list, list, Dict[str, np.ndarray]]] = {}
        for kg, sel in split_column_by_key_group(keys, self._backend.max_parallelism):
            out[kg] = ([keys[i] for i in sel], [nss[i] for i in sel],
                       {name: arr[sel] for name, arr in comps.items()})
        return out

    def restore_columns(self, keys: list, namespaces: list,
                        comps: Dict[str, np.ndarray]) -> None:
        """One slot-resolve loop, then one ``set_rows`` upload per
        component.  Beyond the device budget the overflow goes to the
        host tier (promoted on first access)."""
        n = len(keys)
        if n == 0:
            return
        specs = self.agg.state_specs()
        comps = {name: np.asarray(comps[name], device_dtype(specs[name].dtype))
                 for name in specs}
        needed = len(self.slot_index) + n
        if self.max_device_slots is not None and needed > self.max_device_slots:
            budget = max(self.max_device_slots - len(self.slot_index), 0)
            for i in range(budget, n):
                self.host_tier[(keys[i], namespaces[i])] = {
                    name: np.array(arr[i]) for name, arr in comps.items()}
            keys, namespaces = keys[:budget], namespaces[:budget]
            comps = {name: arr[:budget] for name, arr in comps.items()}
            n = budget
            if n == 0:
                return
            needed = len(self.slot_index) + n
        if needed > self.capacity - len(self._pending_slots):
            self._grow(max(self.capacity * 2, _round_up_pow2(needed)))
        slots = np.empty(n, np.int32)
        for i in range(n):
            slots[i] = self._slot_for(keys[i], namespaces[i])
        idx = self._slots(slots)
        with self._device_lock:
            for name, arr in comps.items():
                set_rows(self.device_state[name], idx,
                         torch.from_numpy(np.ascontiguousarray(arr)))
            for s in slots.tolist():
                self._slot_flushed[s] = 1

    def restore_entries(self, entries) -> None:
        """Per-row (key, namespace, {component: row}) entries."""
        if entries:
            self.restore_columns(
                [e[0] for e in entries], [e[1] for e in entries],
                {name: np.stack([np.asarray(e[2][name]) for e in entries])
                 for name in self.agg.state_specs()})

    def reset(self) -> None:
        """Drop every entry and pending row (a restore supersedes
        them); the arena keeps its capacity and is refilled in place."""
        with self._device_lock:
            self.agg.clear_range(self.device_state, 0, self.capacity)
        self.slot_index.clear()
        self.slot_meta = [None] * self.capacity
        self._free = list(range(self.capacity - 1, -1, -1))
        self._slot_flushed = bytearray(self.capacity)
        self.host_tier.clear()
        self._pending_slots.clear()
        self._pending_values.clear()
        self._pending_hi.clear()
        self._pending_lo.clear()


class GpuKeyedStateBackend(KeyedStateBackend):
    """Device slots for DeviceAggregateFunction aggregation state, host
    tables for everything else."""

    name = "gpu"

    def __init__(self, key_group_range: KeyGroupRange, max_parallelism: int,
                 initial_capacity: int = DEFAULT_INITIAL_CAPACITY,
                 microbatch: int = DEFAULT_MICROBATCH,
                 max_device_slots: Optional[int] = None,
                 device: DeviceLike = None):
        super().__init__(key_group_range, max_parallelism)
        #: where device states live (the card unless "cpu")
        self.device = resolve_device(device)
        self._tables: Dict[str, StateTable] = {}
        self._device_states: Dict[str, DeviceAggregatingState] = {}
        self.initial_capacity = initial_capacity
        self.microbatch = microbatch
        #: per-state device-slot budget (state.backend.tpu.max-device-slots)
        self.max_device_slots = max_device_slots

    def _table(self, name: str) -> StateTable:
        t = self._tables.get(name)
        if t is None:
            t = self._tables[name] = StateTable()
        return t

    # ---- factories --------------------------------------------------
    def create_value_state(self, d: ValueStateDescriptor):
        return HeapValueState(self, d, self._table(d.name))

    def create_list_state(self, d: ListStateDescriptor):
        return HeapListState(self, d, self._table(d.name))

    def create_reducing_state(self, d: ReducingStateDescriptor):
        return HeapReducingState(self, d, self._table(d.name))

    def create_aggregating_state(self, d: AggregatingStateDescriptor):
        if not isinstance(d.aggregate_function, DeviceAggregateFunction):
            return HeapAggregatingState(self, d, self._table(d.name))
        st = DeviceAggregatingState(self, d, self.initial_capacity,
                                    self.microbatch,
                                    max_device_slots=self.max_device_slots)
        self._device_states[d.name] = st
        # a restore before this bind parked the state's accumulators in
        # a host table: lift them onto the device
        leftover = self._tables.pop(d.name, None)
        if leftover is not None:
            specs = d.aggregate_function.state_specs()
            st.restore_entries([
                (key, namespace,
                 {n: np.asarray(value[n]).reshape(specs[n].shape) for n in specs})
                for namespace, key, value in leftover.entries()])
        return st

    def create_folding_state(self, d: FoldingStateDescriptor):
        return HeapFoldingState(self, d, self._table(d.name))

    def create_map_state(self, d: MapStateDescriptor):
        return HeapMapState(self, d, self._table(d.name))

    # ---- snapshot / restore -----------------------------------------
    def snapshot(self) -> KeyedStateSnapshot:
        """v2 chunks: each device state as one column block per key
        group (key and namespace columns through the column codec),
        host-table entries per row."""
        per_kg_rows: Dict[int, list] = defaultdict(list)
        per_kg_cols: Dict[int, Dict[str, list]] = defaultdict(dict)
        mp = self.max_parallelism
        for name, table in self._tables.items():
            for namespace, key, value in table.entries():
                per_kg_rows[assign_to_key_group(key, mp)].append(
                    (name, namespace, key, value))
        for name, dstate in self._device_states.items():
            for kg, (keys, nss, comps) in dstate.snapshot_columns().items():
                per_kg_cols[kg].setdefault(name, []).append({
                    "keys": encode_obj_column(keys),
                    "ns": ("col", encode_obj_column(nss)),
                    "comps": comps,
                    "kind": "acc",
                })
        chunks = {kg: pickle.dumps({"v": 2, "rows": per_kg_rows.get(kg, []),
                                    "cols": per_kg_cols.get(kg, {})},
                                   protocol=pickle.HIGHEST_PROTOCOL)
                  for kg in set(per_kg_rows) | set(per_kg_cols)}
        return KeyedStateSnapshot(chunks, meta=self._meta())

    def _restore_rows(self, rows, pending_device) -> None:
        """Per-row entries: accumulator dicts of a device state here
        become device rows; everything else goes to host tables."""
        for name, namespace, key, value in rows:
            dstate = self._device_states.get(name)
            if dstate is not None and isinstance(value, dict):
                specs = dstate.agg.state_specs()
                pending_device[name].append((key, namespace, {
                    n: np.asarray(value[n]).reshape(specs[n].shape)
                    for n in specs}))
            else:
                self._table(name).put(key, namespace, value)

    def _restore_cols(self, cols: dict, pending_cols) -> None:
        for name, blocks in cols.items():
            for block in blocks:
                comps = block["comps"]
                n = len(next(iter(comps.values()))) if comps else 0
                keys = decode_obj_column(block["keys"], n)
                ns_field = block["ns"]
                namespaces = ([ns_field[1]] * n if ns_field[0] == "const"
                              else decode_obj_column(ns_field[1], n))
                if block["kind"] == "scalar":
                    # a heap column block: plain scalar values
                    table = self._table(name)
                    for k, ns, v in zip(keys, namespaces, comps["value"]):
                        table.put(k, ns, v.item())
                    continue
                pending_cols[name].append((keys, namespaces, comps))

    def restore(self, snapshots) -> None:
        snapshots = list(snapshots)
        self.check_serializer_compatibility(snapshots)
        # in place: bound state objects hold table references
        for table in self._tables.values():
            table.clear_all()
        for dstate in self._device_states.values():
            dstate.reset()
        pending_device: Dict[str, list] = defaultdict(list)
        pending_cols: Dict[str, list] = defaultdict(list)
        for snap in snapshots:
            for kg, blob in snap.blobs():
                if not self.key_group_range.contains(kg):
                    continue
                chunk = load_chunk(blob)
                self._restore_rows(chunk["rows"], pending_device)
                self._restore_cols(chunk["cols"], pending_cols)
        for name, blocks in pending_cols.items():
            dstate = self._device_states.get(name)
            for keys, namespaces, comps in blocks:
                if dstate is not None:
                    dstate.restore_columns(keys, namespaces, comps)
                    continue
                # descriptor not bound yet: park accumulator dicts in a
                # host table; create_aggregating_state lifts them
                table = self._table(name)
                for i in range(len(keys)):
                    table.put(keys[i], namespaces[i],
                              {c: np.array(arr[i]) for c, arr in comps.items()})
        for name, entries in pending_device.items():
            dstate = self._device_states.get(name)
            if dstate is not None:
                dstate.restore_entries(entries)
            else:
                table = self._table(name)
                for key, namespace, row in entries:
                    table.put(key, namespace, row)

    def flush_all(self) -> None:
        """Push every pending micro-batch to the device (before a
        snapshot)."""
        for dstate in self._device_states.values():
            dstate._flush()
