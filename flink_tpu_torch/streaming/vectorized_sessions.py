"""Batched session windows with device-side accumulator merging (port
of ``flink_tpu/streaming/vectorized_sessions.py``).

Per-record work is vectorized and only per-session work runs on the
host:

  1. sort the batch by (key hash, timestamp) (numpy);
  2. session breaks (a new key, or the gap exceeded) → a batch-session
     id per record by cumsum;
  3. one fresh device slot per live batch-session and one update of
     the aggregate's kernel over the batch;
  4. merge batch-sessions into the live session table on the host
     (intervals per key, few per key), coalescing overlapping live
     sessions; the accumulator merges of a batch go to the device in
     one ``agg.merge_slots`` call (a dst may repeat), the slots merged
     away are cleared (``clear_rows``) and released.

A fire gathers the due sessions' results in one ``agg.result`` call
(the aggregate's result kernel, or a gather) and clears their slots.

Lateness-0 semantics match WindowOperator + EventTimeSessionWindows: a
batch-session is late only if it overlaps no live session and its own
window ends at or before the watermark (the post-merge lateness check).

The port passes exact slot lists where the JAX engine pads to a power
of two (with the scratch slot for merges, with the first slot for
clears and fires); the scratch slot is still allocated at the JAX
engine's point (``_ScratchMergeMixin``) so that snapshots restore in
either package.
"""

from __future__ import annotations

import bisect
import heapq
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from flink_tpu_torch.device import DeviceLike, resolve_device
from flink_tpu_torch.ops.device_agg import (DeviceAggregateFunction,
                                            device_dtype, state_from_numpy,
                                            state_to_numpy)
from flink_tpu_torch.ops.hashing import split_hash64_np
from flink_tpu_torch.runtime.device_stats import TELEMETRY
from flink_tpu_torch.state.stats import register_device_engine
from flink_tpu_torch.streaming.vectorized import (_restore_arena,
                                                  _ScratchMergeMixin,
                                                  _SlotArena,
                                                  _snapshot_arena,
                                                  _nbytes, _perf_ns, agg_call,
                                                  device_slots, hash_keys_np,
                                                  to_device)


class _Session:
    """One live session: [start, end) with end = last_ts + gap."""

    __slots__ = ("start", "end", "slot", "key")

    def __init__(self, start: int, end: int, slot: int, key):
        self.start = start
        self.end = end
        self.slot = slot
        self.key = key


class VectorizedSessionWindows(_ScratchMergeMixin):
    """Batched keyBy().window(EventTimeSessionWindows).aggregate(agg)
    with the accumulators resident on ``device`` (the card unless
    ``device="cpu"``)."""

    # the aggregate's calls under the reference's traced_jit labels
    _jit_update = agg_call("update", "window.masked_update")
    _jit_merge = agg_call("merge_slots", "session.merge")
    _jit_result = agg_call("result", "session.result")
    _jit_clear = agg_call("clear_slots", "session.clear")

    def __init__(self, aggregate: DeviceAggregateFunction, gap_ms: int,
                 initial_capacity: int = 1 << 16,
                 emit: Optional[Callable[[Any, Any, int, int], None]] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.agg = aggregate
        self.gap = gap_ms
        self.capacity = initial_capacity
        self.state = aggregate.init_state(initial_capacity, self.device)
        self.arena = _SlotArena(initial_capacity)
        #: key_hash -> list of live _Session (kept sorted by start)
        self.table: Dict[int, List[_Session]] = {}
        self.watermark = -(2**63)
        self.emit = emit
        self.emitted: List[Tuple[Any, Any, int, int]] = []
        self.num_late_dropped = 0
        #: (end, key_hash) min-heap driving watermark expiry; entries go
        #: stale when merges extend a session, pops revalidate against
        #: the live table
        self._expiry_heap: List[Tuple[int, int]] = []
        register_device_engine(self)

    def _clear_release(self, slots: List[int]) -> None:
        if not slots:
            return
        self._jit_clear(self.state, device_slots(slots, self.capacity,
                                                 self.device))
        self.arena.release(np.asarray(slots, np.int64))

    # ---- ingestion --------------------------------------------------
    def process_batch(self, keys, timestamps: np.ndarray,
                      values: Optional[np.ndarray] = None,
                      key_hashes: Optional[np.ndarray] = None,
                      value_hashes: Optional[np.ndarray] = None) -> None:
        ts = np.asarray(timestamps, np.int64)
        n = len(ts)
        if n == 0:
            return
        kh = key_hashes if key_hashes is not None else hash_keys_np(keys)
        keys_arr = keys if isinstance(keys, np.ndarray) else np.asarray(
            keys, dtype=object)
        if self.agg.needs_value_hash and value_hashes is None:
            value_hashes = hash_keys_np(values)

        # 1-2. sort by (key_hash, ts); break where the key changes or
        # the gap is exceeded → batch-session ids
        order = np.lexsort((ts, kh))
        kh_s = kh[order]
        ts_s = ts[order]
        brk = np.ones(n, bool)
        if n > 1:
            same_key = kh_s[1:] == kh_s[:-1]
            # <=: abutting [a, a+g) / [a+g, a+2g) windows intersect and
            # merge (TimeWindow.intersects is inclusive)
            within_gap = (ts_s[1:] - ts_s[:-1]) <= self.gap
            brk[1:] = ~(same_key & within_gap)
        sess_id = np.cumsum(brk) - 1
        n_sessions = int(sess_id[-1]) + 1
        first_of = np.nonzero(brk)[0]
        sess_start = ts_s[first_of]
        last_of = np.empty(n_sessions, np.int64)
        last_of[:-1] = first_of[1:] - 1
        last_of[-1] = n - 1
        sess_end = ts_s[last_of] + self.gap
        sess_kh = kh_s[first_of]

        # post-merge lateness: a batch-session is late iff it overlaps
        # no live session AND ends at or before the watermark; with
        # time-ordered input the candidate set is empty, so the
        # per-session probe runs only for late stragglers
        live_mask = np.ones(n_sessions, bool)
        candidates = np.nonzero(sess_end - 1 <= self.watermark)[0]
        for i in candidates.tolist():
            sessions = self.table.get(int(sess_kh[i]))
            if not sessions or not any(
                    s.start <= sess_end[i] and sess_start[i] <= s.end
                    for s in sessions):
                live_mask[i] = False
        if not live_mask.all():
            dropped = np.isin(sess_id, np.nonzero(~live_mask)[0])
            self.num_late_dropped += int(dropped.sum())

        # 3. one fresh slot per live batch-session; scatter the records
        slot_of_session = np.full(n_sessions, -1, np.int64)
        live_sessions = np.nonzero(live_mask)[0]
        if len(live_sessions) == 0:
            return
        slot_of_session[live_sessions] = self.arena.alloc(len(live_sessions))
        self._ensure_state_capacity()
        rec_slots = slot_of_session[sess_id]
        keep = rec_slots >= 0
        rs = rec_slots[keep]
        dev = self.device
        vals = hi = lo = None
        if self.agg.needs_value:
            v = np.asarray(values, self.agg.value_dtype)[order][keep]
            vals = to_device(v.astype(device_dtype(self.agg.value_dtype),
                                      copy=False), dev)
        if self.agg.needs_value_hash:
            vh = np.asarray(value_hashes)[order][keep]
            hi0, lo0 = self.agg.compress_value_hash(*split_hash64_np(vh))
            hi, lo = to_device(hi0, dev), to_device(lo0, dev)
        d_slots = device_slots(rs, self.capacity, dev)
        tel = TELEMETRY.enabled
        t0 = _perf_ns() if tel else 0
        self.state = self._jit_update(self.state, d_slots, vals, hi, lo,
                                      len(rs))
        if tel:
            TELEMETRY.record_transfer("h2d", _nbytes(d_slots, vals, hi, lo),
                                      t0, _perf_ns(), "session.flush")
            TELEMETRY.note_flush(len(rs))

        # 4. merge batch-sessions into the live table (host work per
        # session, the device merges of the batch in one call)
        merge_dst: List[int] = []
        merge_src: List[int] = []
        free_after: List[int] = []
        keys_sorted = keys_arr[order]
        heap_push = heapq.heappush
        expiry = self._expiry_heap
        for i in live_sessions.tolist():
            khash = int(sess_kh[i])
            s_new = int(sess_start[i])
            e_new = int(sess_end[i])
            slot_new = int(slot_of_session[i])
            key_obj = keys_sorted[first_of[i]]
            sessions = self.table.setdefault(khash, [])
            overlapping = [s for s in sessions
                           if s.start <= e_new and s_new <= s.end]
            if not overlapping:
                bisect.insort(sessions,
                              _Session(s_new, e_new, slot_new, key_obj),
                              key=lambda s: s.start)
                heap_push(expiry, (e_new, khash))
                continue
            # coalesce: the first overlapped live session survives; the
            # batch slot and any other overlapped sessions fold into it
            survivor = overlapping[0]
            survivor.start = min(survivor.start, s_new)
            survivor.end = max(survivor.end, e_new)
            merge_dst.append(survivor.slot)
            merge_src.append(slot_new)
            free_after.append(slot_new)
            for other in overlapping[1:]:
                survivor.start = min(survivor.start, other.start)
                survivor.end = max(survivor.end, other.end)
                merge_dst.append(survivor.slot)
                merge_src.append(other.slot)
                free_after.append(other.slot)
                sessions.remove(other)
            heap_push(expiry, (survivor.end, khash))
        self._merge_tiled(merge_dst, merge_src)
        self._clear_release(free_after)

    # ---- firing -----------------------------------------------------
    def advance_watermark(self, watermark: int) -> int:
        self.watermark = watermark
        fire_slots: List[int] = []
        fire_meta: List[Tuple[Any, int, int]] = []
        # expiry-heap walk: only keys whose (possibly stale) minimum
        # session end is due are visited, so an advance that retires
        # nothing costs O(1)
        expiry = self._expiry_heap
        seen: set = set()
        while expiry and expiry[0][0] - 1 <= watermark:
            _, khash = heapq.heappop(expiry)
            if khash in seen:
                continue
            seen.add(khash)
            sessions = self.table.get(khash)
            if not sessions:
                continue
            remaining = []
            for s in sessions:
                if s.end - 1 <= watermark:
                    fire_slots.append(s.slot)
                    fire_meta.append((s.key, s.start, s.end))
                else:
                    remaining.append(s)
            if remaining:
                self.table[khash] = remaining
            else:
                del self.table[khash]
        if not fire_slots:
            return 0
        res = self._jit_result(
            self.state, device_slots(fire_slots, self.capacity, self.device))
        tel = TELEMETRY.enabled
        t0 = _perf_ns() if tel else 0
        results = res.cpu().numpy()
        if tel:
            TELEMETRY.record_transfer("d2h", results.nbytes, t0, _perf_ns(),
                                      "session.fire")
            TELEMETRY.note_fire_read()
        for (key, start, end), res in zip(fire_meta, results):
            if self.emit is not None:
                self.emit(key, res, start, end)
            else:
                self.emitted.append((key, res, start, end))
        self._clear_release(fire_slots)
        if TELEMETRY.enabled:
            TELEMETRY.note_windows_fired(len(fire_slots))
        return len(fire_slots)

    def block_until_ready(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- snapshots: the JAX engine's dict format --------------------
    def snapshot(self) -> dict:
        return {
            "state": state_to_numpy(self.state),
            "capacity": self.capacity,
            "arena": _snapshot_arena(self.arena),
            "watermark": self.watermark,
            "num_late_dropped": self.num_late_dropped,
            "table": {kh: [(s.start, s.end, s.slot, s.key) for s in lst]
                      for kh, lst in self.table.items()},
            "scratch": self._scratch_slot_id,
        }

    def restore(self, snap: dict) -> None:
        self.capacity = snap["capacity"]
        self.state = state_from_numpy(self.agg, snap["state"], self.device)
        self.arena = _restore_arena(snap["arena"])
        self.watermark = snap["watermark"]
        self.num_late_dropped = snap["num_late_dropped"]
        self.table = {kh: [_Session(s, e, slot, key)
                           for (s, e, slot, key) in lst]
                      for kh, lst in snap["table"].items()}
        # rebuild the expiry heap from the restored live sessions
        self._expiry_heap = [(s.end, kh) for kh, lst in self.table.items()
                             for s in lst]
        heapq.heapify(self._expiry_heap)
        if snap.get("scratch") is not None:
            self._scratch_slot_id = snap["scratch"]
