"""Vectorized tumbling and sliding window engines with device-resident
state (port of ``flink_tpu/streaming/vectorized.py:44-736, 786-1007``).

Whole record batches go through:

  host:   vectorized key hashing (numpy), window assignment
          (ts - ts % size), slot resolution through an open-addressing
          table (``make_slot_index``: the C++ ``NativeSlotIndex``);
  device: one ``agg.update`` per micro-batch (one kernel launch per
          state component) into the arena's accumulators, one
          ``result`` per fire tile, one clear per fired window.

Semantics match the reference engine for tumbling event-time windows
with allowed lateness 0: the same records are dropped as late, the
same (key, window) pairs fire with the same results.  Both packages
resolve slots through the same C++ index, but results still compare
per (key, window), never per slot.

The sliding engine (``VectorizedSlidingWindows``) aggregates each
record once into its slide-sized pane and composes a window at fire
time by merging its panes into fresh union slots on the device
(``agg.merge_rows``, one ``merge_rows`` launch per pane).

Differences from the JAX engine, each because PyTorch runs eagerly and
updates in place: no power-of-two padding of micro-batches, merges or
fire tiles (there is no compile cache to keep warm; rows at or beyond
``n`` still contribute nothing); the full-arena re-init after a full
fire refills the existing register file in place (``clear_rows`` over
[0, C)) where JAX drops and reallocates it.

Observability follows the reference engine: each device call goes
through ``traced_call`` under the reference's ``traced_jit`` label
(``window.masked_update``, ``window.result``, ``window.result_contig``,
``window.result_all``, ``window.clear``, ``window.clear_contig``,
``window.merge``; the full-arena refill is the reference's untraced
``init_state``), and the device telemetry ledgers ``window.flush``
(h2d), ``window.fire`` and ``window.snapshot`` (d2h) with the host
arrays' bytes.  The port ships micro-batches unpadded, so its
``window.flush`` bytes are the records' own where the reference's are
those of the power-of-two padding and its size-1 dummies.
"""

from __future__ import annotations

import functools
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from flink_tpu_torch.core.keygroups import splitmix64_np, stable_hash64
from flink_tpu_torch.device import DeviceLike, resolve_device
from flink_tpu_torch.native import NativeSlotIndex
from flink_tpu_torch.ops.device_agg import (DeviceAggregateFunction,
                                            device_dtype, state_from_numpy,
                                            state_to_numpy)
from flink_tpu_torch.ops.hashing import split_hash64_np
from flink_tpu_torch.runtime.device_stats import TELEMETRY
from flink_tpu_torch.runtime.tracing import traced_call
from flink_tpu_torch.state.stats import register_device_engine

_perf_ns = time.perf_counter_ns


def _nbytes(*arrays) -> int:
    return sum(a.nbytes for a in arrays if a is not None)


class agg_call:
    """An engine's class attribute: ``engine.<attr>(*args)`` calls
    ``engine.agg.<method>(*args)`` through ``traced_call`` under the
    reference's label.  The method is looked up at each call (so a
    swapped method on the aggregate is the one that runs), and the
    engine is bound at each access, so the wrapper holds no engine."""

    def __init__(self, method: str, label: str):
        self._call = traced_call(
            lambda agg, *args: getattr(agg, method)(*args), label)

    def __get__(self, engine, owner=None) -> Callable:
        if engine is None:
            return self
        return functools.partial(self._call, engine.agg)


def hash_keys_np(keys) -> np.ndarray:
    """Vectorized stable 64-bit key hashing: integer arrays through
    splitmix64 in one numpy pass; object arrays per key through
    stable_hash64.  Uniform numeric tuples arrive as a 2-D array whose
    per-column hashes combine order-sensitively into one hash per row."""
    arr = np.asarray(keys)
    if arr.dtype.kind == "f" and arr.size \
            and np.all(arr == arr.astype(np.int64)):
        arr = arr.astype(np.int64)
    if arr.dtype.kind in "iu":
        if arr.ndim == 1:
            return splitmix64_np(arr.astype(np.uint64))
        h = np.zeros(len(arr), np.uint64)
        for j in range(arr.shape[1]):
            h = splitmix64_np(
                h ^ splitmix64_np(arr[:, j].astype(np.uint64))
                ^ np.uint64(0x9E3779B97F4A7C15 * (j + 1) & (2**64 - 1)))
        return h
    if arr.ndim > 1:
        return np.fromiter((stable_hash64(tuple(r)) for r in arr),
                           dtype=np.uint64, count=len(arr))
    return np.fromiter((stable_hash64(k) for k in arr),
                       dtype=np.uint64, count=len(arr))


_EMPTY = np.uint64(0)
_ZERO_REMAP = np.uint64(0x9E3779B97F4A7C15)


class VectorizedSlotIndex:
    """hash64 → dense slot through a vectorized open-addressing table
    (load kept < 0.6).  Intra-batch insert races resolve by
    write-then-reread: unresolved records write their hash at their
    probe position, winners take a slot from the allocator, losers
    advance.  Slots come from an external allocator so every window
    shares one device-state arena."""

    __slots__ = ("table_hash", "table_slot", "cap", "n")

    def __init__(self, capacity: int = 1 << 12):
        cap = 1 << max(4, (capacity - 1).bit_length())
        self.table_hash = np.zeros(cap, np.uint64)   # 0 = empty
        self.table_slot = np.zeros(cap, np.int64)
        self.cap = cap
        self.n = 0

    def _pos0(self, h: np.ndarray) -> np.ndarray:
        return ((h ^ (h >> np.uint64(32)))
                & np.uint64(self.cap - 1)).astype(np.int64)

    def _grow(self, need: int) -> None:
        new_cap = self.cap
        while (self.n + need) * 5 > new_cap * 3:   # load < 0.6
            new_cap *= 2
        if new_cap == self.cap:
            return
        old_hash, old_slot = self.table_hash, self.table_slot
        occ = old_hash != _EMPTY
        self.table_hash = np.zeros(new_cap, np.uint64)
        self.table_slot = np.zeros(new_cap, np.int64)
        self.cap = new_cap
        self.n = 0
        if occ.any():
            self._insert_existing(old_hash[occ], old_slot[occ])

    def _insert_existing(self, hashes: np.ndarray, slots: np.ndarray) -> None:
        """Rehash unique entries into the (empty, larger) table."""
        pos = self._pos0(hashes)
        pending = np.arange(len(hashes))
        mask_c = np.int64(self.cap - 1)
        while len(pending):
            pi = pos[pending]
            empty = self.table_hash[pi] == _EMPTY
            idx = pending[empty]
            if len(idx):
                self.table_hash[pos[idx]] = hashes[idx]
                won = self.table_hash[pos[idx]] == hashes[idx]
                w = idx[won]
                self.table_slot[pos[w]] = slots[w]
                self.n += len(w)
                done = np.zeros(len(hashes), bool)
                done[w] = True
                pending = pending[~done[pending]]
            if len(pending):
                pos[pending] = (pos[pending] + 1) & mask_c

    def lookup_or_insert(
        self, batch_hashes: np.ndarray,
        alloc: Callable[[int], np.ndarray],
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Resolve a batch to slots; new keys get slots from `alloc`.
        Returns (slots[N] int64, first_idx): for each inserted unique
        hash, one batch position holding that key (for first-seen key
        capture)."""
        h = np.where(batch_hashes == _EMPTY, _ZERO_REMAP, batch_hashes)
        self._grow(len(h))
        n = len(h)
        out = np.full(n, -1, np.int64)
        pos = self._pos0(h)
        pending = np.arange(n)
        mask_c = np.int64(self.cap - 1)
        new_first: List[np.ndarray] = []
        while len(pending):
            hp = h[pending]
            p = pos[pending]
            cur = self.table_hash[p]
            match = cur == hp
            if match.any():
                m = pending[match]
                out[m] = self.table_slot[pos[m]]
            empty = cur == _EMPTY
            if empty.any():
                idx = pending[empty]
                pi = pos[idx]
                # last-write-wins per position; re-read to find winners
                self.table_hash[pi] = h[idx]
                won = self.table_hash[pi] == h[idx]
                w = idx[won]
                if len(w):
                    # batch duplicates share a position and a hash:
                    # keep the first per position
                    _, first_per_pos = np.unique(pos[w], return_index=True)
                    w = w[first_per_pos]
                    new_slots = alloc(len(w))
                    self.table_slot[pos[w]] = new_slots
                    out[w] = new_slots
                    self.n += len(w)
                    new_first.append(w)
            resolved = out[pending] >= 0
            pending = pending[~resolved]
            if len(pending):
                # duplicates of a just-inserted key re-check their
                # current position (it now matches); others advance
                cur2 = self.table_hash[pos[pending]]
                advance = pending[cur2 != h[pending]]
                pos[advance] = (pos[advance] + 1) & mask_c
        if new_first:
            return out, np.concatenate(new_first)
        return out, np.zeros(0, np.int64)

    def export(self) -> Tuple[np.ndarray, np.ndarray]:
        """Occupied (hash, slot) pairs — the snapshot format both
        packages' indexes restore from."""
        occ = self.table_hash != _EMPTY
        return self.table_hash[occ].copy(), self.table_slot[occ].copy()

    def set_bulk(self, hashes: np.ndarray, slots: np.ndarray) -> None:
        self._grow(len(hashes))
        self._insert_existing(np.asarray(hashes, np.uint64),
                              np.asarray(slots, np.int64))


def make_slot_index(capacity: int = 1 << 12) -> NativeSlotIndex:
    """The engines' slot index: the C++ open-addressing table of the
    port's host runtime (``native.NativeSlotIndex``), as the JAX package
    picks its native index.  ``VectorizedSlotIndex`` is its numpy twin
    with the same contract, kept for the tests."""
    return NativeSlotIndex(capacity)


class _SlotArena:
    """Dense slot allocator over the device-state arrays."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.next = 0
        self.free: List[np.ndarray] = []  # freed slot arrays

    def alloc(self, n: int) -> np.ndarray:
        out = np.empty(n, np.int64)
        filled = 0
        while self.free and filled < n:
            chunk = self.free[-1]
            take = min(len(chunk), n - filled)
            out[filled:filled + take] = chunk[:take]
            if take == len(chunk):
                self.free.pop()
            else:
                self.free[-1] = chunk[take:]
            filled += take
        fresh = n - filled
        if fresh:
            out[filled:] = np.arange(self.next, self.next + fresh)
            self.next += fresh
        return out

    def release(self, slots: np.ndarray) -> None:
        if len(slots):
            self.free.append(np.asarray(slots, np.int64))

    @property
    def high_water(self) -> int:
        return self.next

    @property
    def live_count(self) -> int:
        """Slots currently allocated (handed out and not released)."""
        return self.next - sum(len(c) for c in self.free)


_SIGNED = {np.dtype(np.uint16): np.int16, np.dtype(np.uint32): np.int32,
           np.dtype(np.uint64): np.int64}


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host column → device tensor.  Unsigned 16/32/64-bit columns
    travel as signed views of the same bits (the kernels read them as
    unsigned; PyTorch's unsigned types beyond uint8 lack most ops)."""
    arr = np.ascontiguousarray(arr)
    signed = _SIGNED.get(arr.dtype)
    if signed is not None:
        arr = arr.view(signed)
    return torch.from_numpy(arr).to(device)


class _WindowShard:
    """Per-live-window bookkeeping: its own slot index + first-seen
    keys (and their hashes), all slots drawn from the shared arena."""

    __slots__ = ("start", "index", "key_list", "slot_list", "hash_list")

    def __init__(self, start: int):
        self.start = start
        self.index = make_slot_index()
        self.key_list: List[np.ndarray] = []
        self.slot_list: List[np.ndarray] = []
        self.hash_list: List[np.ndarray] = []

    @property
    def n_keys(self) -> int:
        return sum(len(a) for a in self.key_list)

    def all_keys(self) -> np.ndarray:
        if not self.key_list:
            return np.empty(0, object)
        if len(self.key_list) > 1:
            self.key_list = [np.concatenate(self.key_list)]
        return self.key_list[0]

    def all_slots(self) -> np.ndarray:
        if not self.slot_list:
            return np.empty(0, np.int64)
        if len(self.slot_list) > 1:
            self.slot_list = [np.concatenate(self.slot_list)]
        return self.slot_list[0]

    def all_hashes(self) -> np.ndarray:
        if not self.hash_list:
            return np.empty(0, np.uint64)
        if len(self.hash_list) > 1:
            self.hash_list = [np.concatenate(self.hash_list)]
        return self.hash_list[0]


class VectorizedTumblingWindows:
    """Batched keyBy().window(Tumbling...).aggregate(device_agg) with
    the accumulators resident on ``device`` (the card unless
    ``device="cpu"``)."""

    #: fire/clear tile in slots (bounded further by bytes per slot)
    FIRE_TILE = 1 << 18
    # the aggregate's calls under the reference's traced_jit labels
    _jit_update = agg_call("update", "window.masked_update")
    _jit_result = agg_call("result", "window.result")
    _jit_clear = agg_call("clear_slots", "window.clear")
    _jit_result_contig = agg_call("result_dense", "window.result_contig")
    _jit_clear_contig = agg_call("clear_range", "window.clear_contig")
    _jit_result_all = agg_call("result_dense", "window.result_all")

    def __init__(self, aggregate: DeviceAggregateFunction, window_size_ms: int,
                 initial_capacity: int = 1 << 16,
                 microbatch: int = 1 << 17,
                 emit: Optional[Callable[[Any, Any, int, int], None]] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.agg = aggregate
        self.size = window_size_ms
        #: how far past a window start a record stays live
        self.lateness_horizon = window_size_ms
        self.capacity = initial_capacity
        self.state = aggregate.init_state(initial_capacity, self.device)
        self.arena = _SlotArena(initial_capacity)
        self.windows: Dict[int, _WindowShard] = {}
        self.watermark = -(2**63)
        self.microbatch = microbatch
        #: emit(key, result, window_start, window_end); None → collect
        self.emit = emit
        self.emitted: List[Tuple[Any, Any, int, int]] = []
        #: True → fires land in `fired` as (keys_np, results_np, start,
        #: end) batches in slot-sorted order, with no per-key tuples
        self.emit_arrays = False
        self.fired: List[Tuple[np.ndarray, np.ndarray, int, int]] = []
        self.num_late_dropped = 0
        self._p_slots: List[np.ndarray] = []
        self._p_values: List[np.ndarray] = []
        self._p_hi: List[np.ndarray] = []
        self._p_lo: List[np.ndarray] = []
        self._p_count = 0
        # fire/clear tile bounded by BYTES as well as slots: a plain
        # gather materializes [tile, *slot_shape] intermediates
        bytes_per_slot = max(
            sum(int(np.prod(spec.shape, dtype=np.int64)) * spec.dtype.itemsize
                for spec in aggregate.state_specs().values()), 1)
        budget = 256 << 20
        tile = 1 << max(9, (budget // bytes_per_slot).bit_length() - 1)
        self.FIRE_TILE = min(tile, type(self).FIRE_TILE)
        register_device_engine(self)

    # ---- ingestion --------------------------------------------------
    def process_batch(
        self,
        keys,
        timestamps: np.ndarray,
        values: Optional[np.ndarray] = None,
        key_hashes: Optional[np.ndarray] = None,
        value_hashes: Optional[np.ndarray] = None,
    ) -> None:
        """One batch of records: assign windows, resolve slots, buffer
        the scatter.  Pass `key_hashes` to skip hashing."""
        ts = np.asarray(timestamps, np.int64)
        kh = key_hashes if key_hashes is not None else hash_keys_np(keys)
        starts = ts - np.mod(ts, self.size)
        # drop late records (the containing window's end <= watermark,
        # lateness 0)
        live = starts + self.lateness_horizon - 1 > self.watermark
        if not live.all():
            self.num_late_dropped += int((~live).sum())
            if not live.any():
                return
            ts, kh, starts = ts[live], kh[live], starts[live]
            keys = (keys[live] if isinstance(keys, np.ndarray)
                    else np.asarray(keys, dtype=object)[live])
            if values is not None:
                values = np.asarray(values)[live]
            if value_hashes is not None:
                value_hashes = np.asarray(value_hashes)[live]

        if self.agg.needs_value_hash and value_hashes is None:
            value_hashes = hash_keys_np(values)

        keys_arr = keys if isinstance(keys, np.ndarray) else np.asarray(
            keys, dtype=object)
        uniq_starts = np.unique(starts)
        single_window = len(uniq_starts) == 1
        for start in uniq_starts:
            shard = self.windows.get(start)
            if shard is None:
                shard = _WindowShard(int(start))
                self.windows[int(start)] = shard
            if single_window:
                bh, masked_keys = kh, keys_arr
                m_values = values
                m_vhashes = value_hashes
            else:
                mask = starts == start
                bh = kh[mask]
                masked_keys = keys_arr[mask]
                m_values = None if values is None else np.asarray(values)[mask]
                m_vhashes = None if value_hashes is None else value_hashes[mask]
            slots, first_idx = shard.index.lookup_or_insert(
                bh, self.arena.alloc)
            if len(first_idx):
                shard.key_list.append(masked_keys[first_idx])
                shard.slot_list.append(np.asarray(slots[first_idx], np.int64))
                shard.hash_list.append(np.asarray(bh[first_idx], np.uint64))
            self._buffer(slots, m_values, m_vhashes)
        if self._p_count >= self.microbatch:
            self.flush()

    def _buffer(self, slots, values, value_hashes) -> None:
        self._p_slots.append(slots.astype(np.int32))
        if self.agg.needs_value:
            self._p_values.append(np.asarray(values, self.agg.value_dtype))
        if self.agg.needs_value_hash:
            hi, lo = split_hash64_np(value_hashes)
            self._p_hi.append(hi)
            self._p_lo.append(lo)
        self._p_count += len(slots)
        # grow device arrays before slots overflow capacity
        if self.arena.high_water > self.capacity:
            self.flush(grow_to=max(self.capacity * 2,
                                   1 << (self.arena.high_water - 1).bit_length()))

    def flush(self, grow_to: Optional[int] = None) -> None:
        if grow_to is not None and grow_to > self.capacity:
            self.state = self.agg.grow_state(self.state, grow_to)
            self.capacity = grow_to
        if self._p_count == 0:
            return
        n = self._p_count
        dev = self.device
        slots = to_device(np.concatenate(self._p_slots), dev)
        values = hi = lo = None
        if self.agg.needs_value:
            values = to_device(np.concatenate(self._p_values).astype(
                device_dtype(self.agg.value_dtype), copy=False), dev)
        if self.agg.needs_value_hash:
            hi0, lo0 = self.agg.compress_value_hash(
                np.concatenate(self._p_hi), np.concatenate(self._p_lo))
            hi, lo = to_device(hi0, dev), to_device(lo0, dev)
        # rows [0, n) scatter in place: the JAX package's jitted
        # make_masked_update, with n passed where it derives a mask
        tel = TELEMETRY.enabled
        t0 = _perf_ns() if tel else 0
        self.state = self._jit_update(self.state, slots, values, hi, lo, n)
        if tel:
            TELEMETRY.record_transfer(
                "h2d", _nbytes(slots, values, hi, lo), t0, _perf_ns(),
                "window.flush")
            TELEMETRY.note_flush(n)
        self._p_slots.clear()
        self._p_values.clear()
        self._p_hi.clear()
        self._p_lo.clear()
        self._p_count = 0

    # ---- firing -----------------------------------------------------
    def advance_watermark(self, watermark: int) -> int:
        """Fire every window whose end-1 <= watermark; returns the
        number of (key, window) results emitted."""
        self.watermark = watermark
        fired = 0
        for start in sorted(self.windows):
            if start + self.size - 1 > watermark:
                continue
            shard = self.windows.pop(start)
            self.flush()
            slots = shard.all_slots()
            if len(slots):
                end = start + self.size
                full = (len(slots) == self.arena.live_count
                        and 4 * len(slots) >= self.capacity)
                slots = self._emit_fire(shard.all_keys(), slots, start, end,
                                        full=full)
                fired += len(slots)
                if full:
                    # the fired window owned every live slot: refill
                    # the whole arena in place at write bandwidth
                    self.agg.clear_range(self.state, 0, self.capacity)
                else:
                    self._clear_tiled(slots)
                self.arena.release(slots)
        if TELEMETRY.enabled:
            TELEMETRY.note_windows_fired(fired)
        return fired

    def _emit_fire(self, keys, slots: np.ndarray, start: int, end: int,
                   full: bool = False):
        """Fire (keys, slots) in slot-sorted order; returns the slots in
        fire order so callers clear/release the same layout.  Sorted
        slots of a window are mostly one dense arena range, so the
        fire and clear run as contiguous tiles."""
        if len(slots) == 0:
            return slots
        keys = keys if isinstance(keys, np.ndarray) else np.asarray(
            keys, dtype=object)
        order = np.argsort(slots, kind="stable")
        slots = slots[order]
        keys = keys[order]
        if full:
            # one dense pass over the whole state, one device-to-host
            # copy of the per-slot results, host-side index into order
            res = self._jit_result_all(self.state)
            tel = TELEMETRY.enabled
            t0 = _perf_ns() if tel else 0
            res_all = res.cpu().numpy()
            if tel:
                TELEMETRY.record_transfer("d2h", res_all.nbytes, t0,
                                          _perf_ns(), "window.fire")
                TELEMETRY.note_fire_read()
            results = res_all[slots]
            if self.emit_arrays:
                self.fired.append((keys, results, start, end))
                return slots
            res_list = results.tolist()
        elif self.emit_arrays:
            self.fired.append((keys, self._gather_tiled_np(slots), start, end))
            return slots
        else:
            res_list = self._gather_tiled_np(slots).tolist()
        if self.emit is not None:
            for key, res in zip(keys, res_list):
                self.emit(key, res, start, end)
        else:
            self.emitted.extend(zip(keys, res_list,
                                    [start] * len(slots), [end] * len(slots)))
        return slots

    def _is_contiguous_tile(self, chunk: np.ndarray, tile: int) -> bool:
        """Full tile of strictly consecutive slots inside the capacity."""
        return (len(chunk) == tile
                and int(chunk[0]) + tile <= self.capacity
                and int(chunk[-1]) - int(chunk[0]) == tile - 1
                and np.array_equal(
                    chunk, np.arange(chunk[0], chunk[0] + tile,
                                     dtype=chunk.dtype)))

    def _fire_tile(self, chunk: np.ndarray, tile: int) -> torch.Tensor:
        """One tile's results: contiguous full tiles finalize a slice
        of the state in place; ragged/unordered tiles gather."""
        if self._is_contiguous_tile(chunk, tile):
            s = int(chunk[0])
            return self._jit_result_contig(
                {k: v[s:s + tile] for k, v in self.state.items()})
        return self._jit_result(self.state,
                                to_device(chunk.astype(np.int32), self.device))

    def _gather_tiled_np(self, slots: np.ndarray) -> np.ndarray:
        tile = self.FIRE_TILE
        # launch every tile before copying any result back
        outs = [self._fire_tile(slots[i:i + tile], tile)
                for i in range(0, len(slots), tile)]
        tel = TELEMETRY.enabled and outs
        t0 = _perf_ns() if tel else 0
        host = [o.cpu().numpy() for o in outs]
        if tel:
            TELEMETRY.record_transfer("d2h", _nbytes(*host), t0, _perf_ns(),
                                      "window.fire")
            TELEMETRY.note_fire_read(len(outs))
        return np.concatenate(host)

    def _clear_tiled(self, slots: np.ndarray) -> None:
        tile = self.FIRE_TILE
        for i in range(0, len(slots), tile):
            chunk = slots[i:i + tile]
            if self._is_contiguous_tile(chunk, tile):
                self._jit_clear_contig(self.state, int(chunk[0]), tile)
            else:
                self._jit_clear(
                    self.state, to_device(chunk.astype(np.int32), self.device))

    def block_until_ready(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- snapshots: the JAX engine's dict format --------------------
    def snapshot(self) -> dict:
        """Device state copied to host numpy; host indexes as plain
        arrays.  The dict is the JAX engine's snapshot format, so a
        snapshot restores into either package."""
        self.flush()
        tel = TELEMETRY.enabled
        t0 = _perf_ns() if tel else 0
        host_state = state_to_numpy(self.state)
        if tel:
            TELEMETRY.record_transfer("d2h", _nbytes(*host_state.values()),
                                      t0, _perf_ns(), "window.snapshot")
        return {
            "state": host_state,
            "capacity": self.capacity,
            "arena": _snapshot_arena(self.arena),
            "watermark": self.watermark,
            "num_late_dropped": self.num_late_dropped,
            "windows": {int(s): _snapshot_shard(sh)
                        for s, sh in self.windows.items()},
            "fired_horizon": getattr(self, "_fired_horizon", None),
            "scratch": getattr(self, "_scratch_slot_id", None),
        }

    def restore(self, snap: dict) -> None:
        self.capacity = snap["capacity"]
        self.state = state_from_numpy(self.agg, snap["state"], self.device)
        self.arena = _restore_arena(snap["arena"])
        self.watermark = snap["watermark"]
        self.num_late_dropped = snap["num_late_dropped"]
        self.windows = {int(s): _restore_shard(sh)
                        for s, sh in snap["windows"].items()}
        if snap.get("fired_horizon") is not None:
            self._fired_horizon = snap["fired_horizon"]
        if snap.get("scratch") is not None:
            self._scratch_slot_id = snap["scratch"]
        self._p_slots.clear()
        self._p_values.clear()
        self._p_hi.clear()
        self._p_lo.clear()
        self._p_count = 0


def device_slots(slots, capacity: int, device: torch.device) -> torch.Tensor:
    """Host slot numbers → an int32 tensor on ``device``, after checking
    on the host that each lies in [0, capacity): a kernel writes
    wherever it is told, where XLA's scatter drops an out-of-range
    index silently."""
    arr = np.asarray(slots, np.int64)
    if len(arr) and (arr.min() < 0 or arr.max() >= capacity):
        bad = arr[(arr < 0) | (arr >= capacity)]
        raise IndexError(f"slot {int(bad[0])} outside the state's "
                         f"{capacity} rows")
    return to_device(arr.astype(np.int32), device)


class _ScratchMergeMixin:
    """Device-side slot merging shared by the sliding and session
    engines: ``state[dst] ⊕= state[src]`` in one call per component.
    The JAX engines pad each merge to a power of two with a sacrificial
    scratch slot; the port passes the exact lists, but still allocates
    the scratch slot from the arena where the JAX engine does (the
    first merge), so arena numbering and snapshots match and restore
    in either package.  Requires self.agg / self.arena / self.state /
    self.capacity / self.device and self._jit_merge: ``agg.merge_rows``
    where every merge's dst are unique (plain loads and stores), else
    ``agg.merge_slots`` (a dst may repeat)."""

    _scratch_slot_id: Optional[int] = None

    def _scratch(self) -> int:
        if self._scratch_slot_id is None:
            self._scratch_slot_id = int(self.arena.alloc(1)[0])
        return self._scratch_slot_id

    def _ensure_state_capacity(self) -> None:
        """Grow the device arrays if the arena outran them (fire-time
        union allocations bypass the ingest path's growth check)."""
        if self.arena.high_water > self.capacity:
            new_cap = max(self.capacity * 2,
                          1 << (self.arena.high_water - 1).bit_length())
            self.state = self.agg.grow_state(self.state, new_cap)
            self.capacity = new_cap

    def _merge_tiled(self, dst, src) -> None:
        if len(dst) == 0:
            return
        self._ensure_state_capacity()
        self._scratch()
        d = device_slots(dst, self.capacity, self.device)
        s = device_slots(src, self.capacity, self.device)
        self.state = self._jit_merge(self.state, d, s)


class VectorizedSlidingWindows(_ScratchMergeMixin, VectorizedTumblingWindows):
    """Batched keyBy().window(SlidingEventTimeWindows).aggregate(agg),
    pane-composed (BASELINE config #3: 10 s / 1 s quantiles at 10M
    keys).  Each record is aggregated once into its slide-sized pane; a
    window's result is composed at fire time by merging its size/slide
    panes into fresh union slots (``agg.merge_rows``: a pane holds each
    key once, so the union slots of one merge are unique, and they are
    fresh, so none is also a source).  Ingest costs what a tumbling
    window at slide granularity costs; the overlap factor is paid at
    fire time, as device merges.  Semantics: WindowOperator +
    SlidingEventTimeWindows with lateness 0."""

    _jit_merge = agg_call("merge_rows", "window.merge")

    def __init__(self, aggregate: DeviceAggregateFunction,
                 window_size_ms: int, slide_ms: int,
                 initial_capacity: int = 1 << 16,
                 microbatch: int = 1 << 17,
                 emit: Optional[Callable[[Any, Any, int, int], None]] = None,
                 device: DeviceLike = None):
        if window_size_ms % slide_ms != 0:
            raise ValueError("window size must be a multiple of the slide "
                             "(pane composition)")
        super().__init__(aggregate, slide_ms, initial_capacity, microbatch,
                         emit, device)
        self.window_size = window_size_ms
        self.slide = slide_ms
        self.n_panes = window_size_ms // slide_ms
        self.lateness_horizon = window_size_ms
        self._fired_horizon = -(2**63)  # the watermark fires last ran at

    def advance_watermark(self, watermark: int) -> int:
        """Fire every sliding window with end-1 in (previous watermark,
        watermark]; prune the panes no window needs any more."""
        prev = self._fired_horizon
        self._fired_horizon = watermark
        self.watermark = watermark
        self.flush()
        fired = 0
        if not self.windows:
            return 0
        # candidate window starts W on the slide grid with
        #   W + size - 1 <= wm      (due now)
        #   W + size - 1 > prev     (not fired on an earlier call)
        #   W >= min_pane - size + slide  (contains at least one pane)
        min_pane = min(self.windows)
        max_pane = max(self.windows)
        hi = min(watermark - self.window_size + 1, max_pane)
        start_from = max(min_pane - self.window_size + self.slide,
                         prev - self.window_size + 2)
        first = -(-start_from // self.slide) * self.slide  # ceil to grid
        if first > hi:
            self._prune_panes(watermark)
            return 0
        for W in range(first, hi + 1, self.slide):
            panes = [self.windows[p]
                     for p in range(W, W + self.window_size, self.slide)
                     if p in self.windows and self.windows[p].slot_list]
            if not panes:
                continue
            end = W + self.window_size
            if len(panes) == 1:
                # single-pane window: fire straight from the pane slots
                shard = panes[0]
                slots = shard.all_slots()
                self._emit_fire(shard.all_keys(), slots, W, end)
                fired += len(slots)
                continue
            # union the panes' keys into fresh fire slots, merging on
            # the device pane by pane
            union_index = make_slot_index(sum(p.n_keys for p in panes))
            union_key_list: List[np.ndarray] = []
            union_slot_list: List[np.ndarray] = []
            for shard in panes:
                pslots = shard.all_slots()
                uslots, first_idx = union_index.lookup_or_insert(
                    shard.all_hashes(), self.arena.alloc)
                if len(first_idx):
                    union_key_list.append(shard.all_keys()[first_idx])
                    union_slot_list.append(uslots[first_idx])
                self._merge_tiled(uslots, pslots)
            union_slots = (np.concatenate(union_slot_list)
                           if union_slot_list else np.empty(0, np.int64))
            union_keys = (np.concatenate(union_key_list)
                          if union_key_list else np.empty(0, object))
            union_slots = self._emit_fire(union_keys, union_slots, W, end)
            fired += len(union_slots)
            self._clear_tiled(union_slots)
            self.arena.release(union_slots)
        self._prune_panes(watermark)
        if TELEMETRY.enabled:
            TELEMETRY.note_windows_fired(fired)
        return fired

    def _prune_panes(self, watermark: int) -> None:
        """Pane [P, P+slide) is dead once its last containing window
        [P, P+size) fired, i.e. watermark >= P+size-1."""
        for P in sorted(self.windows):
            if P + self.window_size - 1 > watermark:
                break
            shard = self.windows.pop(P)
            slots = shard.all_slots()
            if len(slots):
                slots = np.sort(slots)
                self._clear_tiled(slots)
                self.arena.release(slots)


def _snapshot_arena(arena: _SlotArena) -> dict:
    return {"capacity": arena.capacity, "next": arena.next,
            "free": [np.array(a, np.int64) for a in arena.free]}


def _restore_arena(snap: dict) -> _SlotArena:
    arena = _SlotArena(snap["capacity"])
    arena.next = snap["next"]
    arena.free = [np.array(a, np.int64) for a in snap["free"]]
    return arena


def _snapshot_shard(sh: _WindowShard) -> dict:
    ih, isl = sh.index.export()
    return {"start": sh.start, "keys": sh.all_keys().copy(),
            "slots": sh.all_slots().copy(), "hashes": sh.all_hashes().copy(),
            "index_hashes": ih, "index_slots": isl}


def _restore_shard(snap: dict) -> _WindowShard:
    sh = _WindowShard(snap["start"])
    ks = snap["keys"]
    if not isinstance(ks, np.ndarray):
        arr = np.empty(len(ks), object)
        arr[:] = ks
        ks = arr
    sh.key_list = [ks] if len(ks) else []
    sh.slot_list = [np.array(snap["slots"], np.int64)]
    sh.hash_list = [np.array(snap["hashes"], np.uint64)]
    ih = np.array(snap["index_hashes"], np.uint64)
    isl = np.array(snap["index_slots"], np.int64)
    sh.index = make_slot_index(2 * max(len(ih), 8))
    sh.index.set_bulk(ih, isl)
    return sh
