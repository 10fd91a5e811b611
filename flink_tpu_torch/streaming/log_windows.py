"""Log-structured window engines, the combiner tier (port of
``flink_tpu/streaming/log_windows.py``).

Ingest appends each record's aggregate cells to a per-window log on
the host; the fire sorts the log and reduces each key's run densely
(the C++ radix sort and segmented reductions of ``native/``), with an
optional finish on the card (``finish_tier="device"``: the C++ sort and
compaction, then one ``hll_log_finish`` launch over the compacted
cells, HLL only).  A window's state is its log, bounded by periodic
compaction at min(events, keys x cells).

Engines (the engine interface of the scatter tier):

- ``LogStructuredTumblingWindows``;
- ``LogStructuredSlidingWindows``: one log per slide-sized pane, a
  window's fire concatenates its panes' logs (the sort regroups keys
  across panes);
- ``LogStructuredSessionWindows``: sort by (key, ts), split runs at
  gaps (abutting windows merge), close sessions behind the watermark,
  Count-Min totals;
- ``StringSumTumblingWindows``: string-keyed float sums, interning and
  summing in one C++ pass per batch.

Scope: integer keys (the key rides in the log; grouping is exact) and
aggregates with a cell decomposition: HyperLogLog (cell = (register,
rank), combine max, precision <= 16), Sum (cell = value, add), the
quantile sketch (cell = (bucket, count), add) and, for sessions,
Count-Min.  Other aggregates raise ``TypeError`` and run on the scatter
tier (``streaming/vectorized.py``).

Snapshots are the JAX engines' dicts.  Each window's payload is a
content-addressed ``SharedChunk`` (``state/shared_registry.py``), so a
checkpoint storage keeps a window that took no records since the last
checkpoint once; a version count per window log skips re-hashing it.
A restore reads a chunk, a resolved payload dict, or the JAX package's
chunk, through its ``payload``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

import flink_tpu_torch.native as nat
from flink_tpu_torch.device import DeviceLike, resolve_device
from flink_tpu_torch.kernels import hll_log_finish
from flink_tpu_torch.ops.device_agg import DeviceAggregateFunction, SumAggregate
from flink_tpu_torch.ops.hashing import split_hash64_np
from flink_tpu_torch.ops.link_probe import recommended_finish_tier
from flink_tpu_torch.ops.sketches import (CountMinSketchAggregate,
                                          HyperLogLogAggregate,
                                          QuantileSketchAggregate)
from flink_tpu_torch.runtime.device_stats import TELEMETRY
from flink_tpu_torch.streaming.vectorized import _perf_ns, hash_keys_np


def _is_single_window(starts: np.ndarray) -> bool:
    """Whether every record of the batch lies in one window, decided in
    one vectorized pass (no np.unique sort)."""
    return bool(len(starts)) and starts[0] == starts[-1] \
        and bool((starts == starts[0]).all())


class _WindowLog:
    """Columnar append log of one window (or pane); ``version`` counts
    appends (an unchanged version keeps the snapshot chunk's hash)."""

    __slots__ = ("keys", "cols", "count", "version", "compacted_size")

    def __init__(self):
        self.keys: List[np.ndarray] = []
        self.cols: List[Tuple[np.ndarray, ...]] = []
        self.count = 0
        self.version = 0
        #: cell count right after the last compaction: compaction
        #: re-arms only once the log has grown well past it, so a log
        #: whose compacted floor sits above the threshold cannot re-sort
        #: itself on every batch
        self.compacted_size = 0

    def append(self, keys: np.ndarray, *cols: np.ndarray) -> None:
        self.keys.append(keys)
        self.cols.append(cols)
        self.count += len(keys)
        self.version += 1

    def concat(self) -> Tuple[np.ndarray, Tuple[np.ndarray, ...]]:
        keys = (self.keys[0] if len(self.keys) == 1
                else np.concatenate(self.keys))
        n_cols = len(self.cols[0])
        cols = tuple(
            (self.cols[0][j] if len(self.cols) == 1
             else np.concatenate([c[j] for c in self.cols]))
            for j in range(n_cols))
        self.keys = [keys]
        self.cols = [cols]
        return keys, cols

    def compact(self, mode) -> None:
        keys, cols = self.concat()
        ck, ccols = mode.compact(keys, cols)
        self.keys = [ck]
        self.cols = [ccols]
        self.count = len(ck)
        self.compacted_size = self.count

    def should_compact(self, threshold: int) -> bool:
        return (self.count > threshold
                and self.count >= 2 * self.compacted_size)


class _SumTabLog:
    """Adaptive Sum window state: a dense C++ key -> sum table while the
    distinct-key count stays cache-resident, spilling to the ordinary
    cell log when cardinality outgrows it.  Same interface as
    _WindowLog."""

    __slots__ = ("tab", "log", "max_distinct", "version")

    def __init__(self, max_distinct: int = 1 << 19):
        self.tab = nat.NativeSumTable()
        self.log: Optional[_WindowLog] = None
        self.max_distinct = max_distinct
        self.version = 0

    @property
    def count(self) -> int:
        return self.tab.n if self.log is None else self.log.count

    def append(self, keys: np.ndarray, values: np.ndarray) -> None:
        self.version += 1
        if self.log is None:
            values = np.asarray(values, np.float64)
            consumed = self.tab.ingest(keys, values, self.max_distinct)
            if consumed == len(keys):
                return
            # cardinality outgrew the table: spill to log form and free
            # the table (it is never consulted again)
            self.log = _WindowLog()
            tk, tsums = self.tab.export()
            self.log.append(tk, tsums)
            self.tab = None
            keys, values = keys[consumed:], values[consumed:]
        self.log.append(keys, np.asarray(values, np.float64))

    def concat(self):
        if self.log is None:
            tk, tsums = self.tab.export()
            return tk, (tsums,)
        return self.log.concat()

    def compact(self, mode) -> None:
        if self.log is not None:
            self.log.compact(mode)

    def should_compact(self, threshold: int) -> bool:
        return self.log is not None and self.log.should_compact(threshold)


# ---------------------------------------------------------------------
# per-aggregate cell decompositions
# ---------------------------------------------------------------------

class _HllMode:
    name = "hll"
    can_compact = True

    @staticmethod
    def upgrade_cols(cols):
        return cols

    def new_log(self):
        return _WindowLog()

    def __init__(self, agg: HyperLogLogAggregate, finish_tier: str,
                 device: torch.device):
        if agg.precision > 16:
            raise ValueError("log engine supports precision <= 16 "
                             "(u16 register cells)")
        self.agg = agg
        self.device = device
        if finish_tier == "auto":
            # the link probe decides, as in the JAX package
            finish_tier = recommended_finish_tier(device)
        self.finish_tier = finish_tier

    def make_cols(self, values, value_hashes):
        if value_hashes is None:
            value_hashes = hash_keys_np(values)
        vh = np.asarray(value_hashes)
        if vh.dtype == np.uint64:
            # one fused C++ pass (clz rank + masked register)
            return nat.hll_make_cells(vh, self.agg.precision)
        hi, lo = split_hash64_np(vh)
        ranks, regs = self.agg.compress_value_hash(hi, lo)
        return (np.ascontiguousarray(regs, np.uint16),
                np.ascontiguousarray(ranks, np.uint8))

    def compact(self, keys, cols):
        ck, cr, crk, _ = nat.hll_log_compact(keys, cols[0], cols[1],
                                             self.agg.precision)
        return ck, (cr, crk)

    def fire(self, keys, cols):
        if self.finish_tier == "device":
            ck, _, crk, ends = nat.hll_log_compact(
                keys, cols[0], cols[1], self.agg.precision)
            return ck[ends - 1], self._device_finish(crk, ends)
        return nat.hll_log_fire(keys, cols[0], cols[1], self.agg.precision)

    def _device_finish(self, ranks: np.ndarray, ends: np.ndarray) -> np.ndarray:
        """The estimate phase of the fire on the device: the compacted
        ranks and run ends go to the card, one ``hll_log_finish``
        launch, the float64 estimates come back."""
        # the reference's log.finish ledger, of unpadded arrays
        tel = TELEMETRY.enabled
        t0 = _perf_ns() if tel else 0
        r = torch.from_numpy(ranks).to(self.device)
        e = torch.from_numpy(ends).to(self.device)
        if tel:
            TELEMETRY.record_transfer("h2d", ranks.nbytes + ends.nbytes, t0,
                                      _perf_ns(), "log.finish")
        est = hll_log_finish(r, e, self.agg.m, self.agg.alpha)
        t1 = _perf_ns() if tel else 0
        out = est.cpu().numpy()
        if tel:
            TELEMETRY.record_transfer("d2h", out.nbytes, t1, _perf_ns(),
                                      "log.finish")
            TELEMETRY.note_fire_read()
        return out


class _SumMode:
    name = "sum"
    can_compact = True

    @staticmethod
    def upgrade_cols(cols):
        return cols

    def __init__(self, agg: SumAggregate, finish_tier: str,
                 device: torch.device):
        self.agg = agg

    def new_log(self):
        return _SumTabLog()

    def make_cols(self, values, value_hashes):
        return (np.asarray(values, np.float64),)

    def compact(self, keys, cols):
        ks, sums = nat.sum_log_fire(keys, cols[0])
        return ks, (sums,)

    def fire(self, keys, cols):
        ks, sums = nat.sum_log_fire(keys, cols[0])
        return ks, sums.astype(self.agg.value_dtype)


class _QuantileMode:
    name = "quantile"
    #: count-combining compaction: (key, bucket) duplicates collapse into
    #: count cells (bucket u16, count u32), bounding a window's log at
    #: keys x buckets cells; raw appends carry count 1
    can_compact = True

    def new_log(self):
        return _WindowLog()

    def __init__(self, agg: QuantileSketchAggregate, finish_tier: str,
                 device: torch.device):
        if agg.buckets > (1 << 16):
            raise ValueError("log engine supports <= 65536 buckets")
        self.agg = agg

    @staticmethod
    def upgrade_cols(cols):
        """Snapshots from before count cells logged (bucket,) only: raw
        cells, weight 1."""
        if len(cols) == 1:
            return [cols[0], np.ones(len(cols[0]), np.uint32)]
        return cols

    def make_cols(self, values, value_hashes):
        # numpy twin of the sketch's bucketing (float32 steps, as the
        # kernels take them)
        agg = self.agg
        v = np.asarray(values, np.float32)
        logs = np.log(np.maximum(v, np.float32(agg.min_value)),
                      dtype=np.float32) / np.float32(agg.log_gamma)
        b = 1 + np.floor(logs).astype(np.int32) - agg.offset
        b = np.clip(b, 1, agg.buckets - 1)
        b = np.where(v <= agg.min_value, 0, b)
        return (b.astype(np.uint16), np.ones(len(v), np.uint32))

    def compact(self, keys, cols):
        ck, cb, cc = nat.qsketch_log_compact(keys, cols[0], cols[1],
                                             self.agg.buckets)
        return ck, (cb, cc)

    def fire(self, keys, cols):
        agg = self.agg
        # the C++ fire computes gamma^(b - 0.5) * mid_corr; folding
        # sqrt(gamma) into the correction gives the DDSketch estimate
        # 2 gamma^b / (gamma + 1)
        mid_corr = 2.0 * float(np.sqrt(agg.gamma)) / (1.0 + agg.gamma)
        # never-compacted logs are all count-1 cells: the unweighted
        # fire carries the bucket inside the sorted record
        counts = cols[1]
        if (counts == 1).all():
            counts = None
        return nat.qsketch_log_fire(keys, cols[0], agg.buckets,
                                    agg.quantiles, agg.log_gamma,
                                    agg.offset, mid_corr, counts=counts)


def _as_u64_keys(engine, keys) -> np.ndarray:
    """Integer keys as their uint64 bit pattern (exact grouping for
    signed and unsigned alike); the signedness locks on the first batch,
    since a later flip would reinterpret keys >= 2^63 emitted earlier."""
    keys = np.asarray(keys)
    if not np.issubdtype(keys.dtype, np.integer):
        raise TypeError("log engine requires integer keys "
                        "(the key rides in the log)")
    signed = bool(np.issubdtype(keys.dtype, np.signedinteger))
    if engine._keys_signed is None:
        engine._keys_signed = signed
    elif engine._keys_signed != signed:
        raise TypeError(
            "key dtype signedness changed mid-stream "
            f"(was {'signed' if engine._keys_signed else 'unsigned'}, "
            f"got {keys.dtype}); keep the key dtype stable")
    if signed:
        return keys.astype(np.int64, copy=False).view(np.uint64)
    return keys.astype(np.uint64, copy=False)


def _keys_out(engine, keys_u64: np.ndarray) -> np.ndarray:
    return keys_u64.view(np.int64) if engine._keys_signed else keys_u64


def _mode_for(agg: DeviceAggregateFunction, finish_tier: str,
              device: torch.device):
    if isinstance(agg, HyperLogLogAggregate):
        return _HllMode(agg, finish_tier, device)
    if isinstance(agg, SumAggregate):
        return _SumMode(agg, finish_tier, device)
    if isinstance(agg, QuantileSketchAggregate):
        return _QuantileMode(agg, finish_tier, device)
    raise TypeError(
        "log-structured engines support HyperLogLog / Sum / "
        "QuantileSketch cell decompositions; use the vectorized "
        f"engines for {type(agg).__name__}")


def _payload(w):
    """A window's snapshot payload: the port's dict, or the payload of
    the JAX package's SharedChunk."""
    return getattr(w, "payload", w)


# ---------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------

class LogStructuredTumblingWindows:
    """Batched keyBy().window(Tumbling...).aggregate(agg) on the
    combiner tier.

    finish_tier: "host" (the C++ fused sort and reduce), "device" (the
    C++ sort and compaction, then ``hll_log_finish`` on ``device``; HLL
    only) or "auto" (``ops/link_probe.py`` decides from the measured
    host → device copy rate; "host" when ``device`` is the CPU).
    ``device`` resolves like every engine's: the card unless "cpu"."""

    def __init__(self, aggregate: DeviceAggregateFunction,
                 window_size_ms: int, compact_threshold: int = 64 << 20,
                 finish_tier: str = "auto", emit=None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.agg = aggregate
        self.mode = _mode_for(aggregate, finish_tier, self.device)
        self.size = window_size_ms
        #: how far past a (pane) start a record stays live; the sliding
        #: subclass widens it to the window size
        self.lateness_horizon = window_size_ms
        self.compact_threshold = compact_threshold
        self.windows: Dict[int, Any] = {}
        #: window start -> (log version, chunk hash) of the last snapshot
        self._chunk_cache: Dict[int, Tuple[int, str]] = {}
        self.watermark = -(2 ** 63)
        self.emit = emit
        self.emitted: List[Tuple[Any, Any, int, int]] = []
        self.emit_arrays = False
        self.fired: List[Tuple[np.ndarray, np.ndarray, int, int]] = []
        self.num_late_dropped = 0
        #: signed input keys ride as their uint64 bit pattern (locked on
        #: the first batch)
        self._keys_signed = None

    # ---- ingestion --------------------------------------------------
    def process_batch(self, keys, timestamps, values=None,
                      key_hashes=None, value_hashes=None) -> None:
        ts = np.asarray(timestamps, np.int64)
        keys = _as_u64_keys(self, keys)
        starts = ts - np.mod(ts, self.size)
        live = starts + self.lateness_horizon - 1 > self.watermark
        if not live.all():
            self.num_late_dropped += int((~live).sum())
            if not live.any():
                return
            keys, ts, starts = keys[live], ts[live], starts[live]
            if values is not None:
                values = np.asarray(values)[live]
            if value_hashes is not None:
                value_hashes = np.asarray(value_hashes)[live]

        cols = self.mode.make_cols(values, value_hashes)
        uniq_starts = (starts[:1] if _is_single_window(starts)
                       else np.unique(starts))
        for start in uniq_starts:
            log = self.windows.get(int(start))
            if log is None:
                log = self.windows[int(start)] = self.mode.new_log()
            if len(uniq_starts) == 1:
                log.append(keys, *cols)
            else:
                mask = starts == start
                log.append(keys[mask], *(c[mask] for c in cols))
            if self.mode.can_compact \
                    and log.should_compact(self.compact_threshold):
                log.compact(self.mode)

    def flush(self, grow_to: Optional[int] = None) -> None:
        """No device micro-batch to flush (interface parity)."""

    # ---- firing -----------------------------------------------------
    def advance_watermark(self, watermark: int) -> int:
        self.watermark = watermark
        fired = 0
        for start in sorted(self.windows):
            if start + self.size - 1 > watermark:
                continue
            log = self.windows.pop(start)
            if log.count == 0:
                continue
            keys, cols = log.concat()
            fired += self._fire_window(keys, cols, start, start + self.size)
        if TELEMETRY.enabled:
            TELEMETRY.note_windows_fired(fired)
        return fired

    def _fire_window(self, keys, cols, start: int, end: int) -> int:
        out_keys, results = self.mode.fire(keys, cols)
        self._emit(_keys_out(self, out_keys), results, start, end)
        return len(out_keys)

    def _emit(self, out_keys, results, start: int, end: int) -> None:
        if self.emit_arrays:
            self.fired.append((out_keys, results, start, end))
        elif self.emit is not None:
            for k, r in zip(out_keys, results):
                self.emit(k, r, start, end)
        else:
            self.emitted.extend(zip(out_keys, results,
                                    [start] * len(out_keys),
                                    [end] * len(out_keys)))

    # ---- checkpoint integration ------------------------------------
    def snapshot(self) -> dict:
        """Per-window logs as SharedChunks, in the JAX engine's format.
        Payloads are copies (a retained checkpoint may store any of
        them, so none aliases live arrays); the version cache only skips
        the re-hash of an untouched window."""
        from flink_tpu_torch.state.shared_registry import SharedChunk
        cache = self._chunk_cache
        wins = {}
        for start, log in self.windows.items():
            start = int(start)
            keys, cols = log.concat()
            payload = {"keys": keys.copy(), "cols": [c.copy() for c in cols]}
            cached = cache.get(start)
            if cached is not None and cached[0] == log.version:
                wins[start] = SharedChunk(payload, chunk_hash=cached[1])
                continue
            chunk = SharedChunk(payload)
            cache[start] = (log.version, chunk.hash)
            wins[start] = chunk
        for start in [s for s in cache if s not in wins]:
            del cache[start]
        return {"mode": self.mode.name, "size": self.size,
                "watermark": self.watermark,
                "num_late_dropped": self.num_late_dropped,
                "windows": wins,
                "keys_signed": self._keys_signed,
                # sliding subclass: without it a restored engine would
                # re-fire already-fired windows from pruned panes
                "fired_horizon": getattr(self, "_fired_horizon", None)}

    def restore(self, snap: dict) -> None:
        self.restore_many([snap])

    def restore_many(self, snaps, keep_fn=None) -> None:
        """Restore one snapshot, or merge several after a parallelism
        change keeping the rows ``keep_fn`` (uint64 key bit patterns →
        bool mask) selects.  Merging is exact: a window's state is its
        log, and the fire's sort regroups any concatenation."""
        self.watermark = max(s["watermark"] for s in snaps)
        self.num_late_dropped = sum(s["num_late_dropped"] for s in snaps)
        signed = {s["keys_signed"] for s in snaps
                  if s.get("keys_signed") is not None}
        if len(signed) > 1:
            raise ValueError("snapshots disagree on key signedness")
        self._keys_signed = signed.pop() if signed else None
        horizons = [s["fired_horizon"] for s in snaps
                    if s.get("fired_horizon") is not None]
        if horizons:
            self._fired_horizon = max(horizons)
        self.windows = {}
        self._chunk_cache = {}
        for snap in snaps:
            for start, w in snap["windows"].items():
                w = _payload(w)
                keys = np.asarray(w["keys"], np.uint64)
                cols = self.mode.upgrade_cols(
                    [np.asarray(c) for c in w["cols"]])
                if keep_fn is not None:
                    m = keep_fn(keys)
                    if not m.all():
                        keys = keys[m]
                        cols = [c[m] for c in cols]
                if not len(keys):
                    continue
                log = self.windows.get(int(start))
                if log is None:
                    log = self.windows[int(start)] = self.mode.new_log()
                log.append(keys, *cols)

    def block_until_ready(self) -> None:
        """Host-tier state is always materialized."""


class StringSumTumblingWindows:
    """String-keyed tumbling Sum: one C++ pass per batch interns each
    word and adds its weight into a dense id-indexed per-window sum
    array (``ft_intern_sum``).  keyBy(word).window(Tumbling).aggregate(
    Sum) with float values lands here; emits the original strings."""

    def __init__(self, aggregate, window_size_ms: int, emit=None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.agg = aggregate
        self.size = window_size_ms
        self.lateness_horizon = window_size_ms
        self.interner = nat.NativeStringInterner()
        self.directory: List[str] = []          # id -> word
        self._dir_arr = None                    # cached array view
        self.windows: Dict[int, Any] = {}       # start -> NativeWordSums
        self.watermark = -(2 ** 63)
        self.emit = emit
        self.emitted: List[Tuple[Any, Any, int, int]] = []
        self.emit_arrays = False
        self.fired: List[Tuple[np.ndarray, np.ndarray, int, int]] = []
        self.num_late_dropped = 0

    def process_batch(self, keys, timestamps, values=None,
                      key_hashes=None, value_hashes=None) -> None:
        keys = np.asarray(keys)
        if keys.dtype.kind not in "US":
            keys = keys.astype(np.str_)
        ts = np.asarray(timestamps, np.int64)
        starts = ts - np.mod(ts, self.size)
        # single-window batch: skip the unique sort and the masks
        if _is_single_window(starts) \
                and int(starts[0]) + self.lateness_horizon - 1 \
                > self.watermark:
            self._ingest(int(starts[0]), keys, values)
            return
        live = starts + self.lateness_horizon - 1 > self.watermark
        if not live.all():
            self.num_late_dropped += int((~live).sum())
            if not live.any():
                return
            keys, starts = keys[live], starts[live]
            if values is not None:
                values = np.asarray(values)[live]
        for start in np.unique(starts).tolist():
            m = starts == start
            self._ingest(int(start), keys if m.all() else keys[m],
                         None if values is None
                         else (values if m.all() else np.asarray(values)[m]))

    def _ingest(self, start: int, w_keys, w_vals) -> None:
        ws = self.windows.get(start)
        if ws is None:
            ws = self.windows[start] = nat.NativeWordSums()
        first_idx = ws.add(self.interner, w_keys, w_vals)
        if len(first_idx):
            self.directory.extend(w_keys[first_idx].tolist())
            self._dir_arr = None

    def flush(self, grow_to=None) -> None:
        """Interface parity."""

    def advance_watermark(self, watermark: int) -> int:
        self.watermark = watermark
        fired = 0
        for start in sorted(self.windows):
            if start + self.size - 1 > watermark:
                continue
            ids, sums = self.windows.pop(start).fire()
            if not len(ids):
                continue
            if self._dir_arr is None:
                self._dir_arr = np.asarray(self.directory, dtype=object)
            words = self._dir_arr[ids]
            results = sums.astype(self.agg.value_dtype, copy=False)
            end = start + self.size
            if self.emit_arrays:
                self.fired.append((words, results, start, end))
            elif self.emit is not None:
                for k, r in zip(words, results):
                    self.emit(k, r, start, end)
            else:
                self.emitted.extend(zip(words, results, [start] * len(ids),
                                        [end] * len(ids)))
            fired += len(ids)
        return fired

    def snapshot(self) -> dict:
        wins = {}
        for start, ws in self.windows.items():
            ids, sums = ws.fire()       # export ...
            ws.load(ids, sums)          # ... and restore in place
            wins[int(start)] = {"ids": ids, "sums": sums}
        return {"mode": "string_sum", "size": self.size,
                "watermark": self.watermark,
                "num_late_dropped": self.num_late_dropped,
                "directory": list(self.directory),
                "windows": wins}

    def restore(self, snap: dict) -> None:
        self.watermark = snap["watermark"]
        self.num_late_dropped = snap["num_late_dropped"]
        self.directory = list(snap["directory"])
        self._dir_arr = None
        self.interner = nat.NativeStringInterner(
            max(16, 2 * len(self.directory)))
        if self.directory:
            # dense first-seen ids: re-interning the directory in order
            # reproduces every id
            self.interner.intern(np.asarray(self.directory))
        self.windows = {}
        for start, w in snap["windows"].items():
            ws = nat.NativeWordSums()
            ws.load(np.asarray(w["ids"], np.int64),
                    np.asarray(w["sums"], np.float64))
            self.windows[int(start)] = ws

    def restore_many(self, snaps, keep_fn=None) -> None:
        """Merge snapshots after a parallelism change: ids are dense per
        subtask, so each snapshot's ids map back to words through its
        own directory and re-intern here; sums add, so re-adding merges
        exactly.  ``keep_fn`` filters word arrays."""
        if len(snaps) == 1 and keep_fn is None:
            self.restore(snaps[0])
            return
        self.watermark = max(s["watermark"] for s in snaps)
        self.num_late_dropped = sum(s["num_late_dropped"] for s in snaps)
        self.directory = []
        self._dir_arr = None
        self.interner = nat.NativeStringInterner()
        self.windows = {}
        for snap in snaps:
            directory = np.asarray(snap["directory"], dtype=object)
            for start, w in snap["windows"].items():
                ids = np.asarray(w["ids"], np.int64)
                if not len(ids):
                    continue
                words = directory[ids].astype(np.str_)
                sums = np.asarray(w["sums"], np.float64)
                if keep_fn is not None:
                    m = keep_fn(words)
                    if not m.any():
                        continue
                    if not m.all():
                        words, sums = words[m], sums[m]
                self._ingest(int(start), words, sums)

    def block_until_ready(self) -> None:
        """Host-tier state is always materialized."""


class LogStructuredSlidingWindows(LogStructuredTumblingWindows):
    """Sliding windows composed from slide-sized pane logs: each record
    is appended once to its pane, a window's fire concatenates its
    size/slide pane logs.  The fire and prune rules of
    VectorizedSlidingWindows (lateness 0)."""

    def __init__(self, aggregate: DeviceAggregateFunction,
                 window_size_ms: int, slide_ms: int,
                 compact_threshold: int = 64 << 20,
                 finish_tier: str = "auto", emit=None,
                 device: DeviceLike = None):
        if window_size_ms % slide_ms != 0:
            raise ValueError("window size must be a multiple of the slide")
        super().__init__(aggregate, slide_ms, compact_threshold,
                         finish_tier, emit, device)
        self.window_size = window_size_ms
        self.slide = slide_ms
        self.lateness_horizon = window_size_ms
        self._fired_horizon = -(2 ** 63)

    def advance_watermark(self, watermark: int) -> int:
        prev = self._fired_horizon
        self._fired_horizon = watermark
        self.watermark = watermark
        fired = 0
        if not self.windows:
            return 0
        min_pane = min(self.windows)
        max_pane = max(self.windows)
        hi = min(watermark - self.window_size + 1, max_pane)
        start_from = max(min_pane - self.window_size + self.slide,
                         prev - self.window_size + 2)
        first = -(-start_from // self.slide) * self.slide
        if first <= hi:
            for W in range(first, hi + 1, self.slide):
                logs = [self.windows[p]
                        for p in range(W, W + self.window_size, self.slide)
                        if p in self.windows and self.windows[p].count]
                if not logs:
                    continue
                parts = [lg.concat() for lg in logs]
                keys = (parts[0][0] if len(parts) == 1 else
                        np.concatenate([p[0] for p in parts]))
                n_cols = len(parts[0][1])
                cols = tuple(
                    (parts[0][1][j] if len(parts) == 1 else
                     np.concatenate([p[1][j] for p in parts]))
                    for j in range(n_cols))
                fired += self._fire_window(keys, cols, W,
                                           W + self.window_size)
        # prune panes no future window needs
        for P in sorted(self.windows):
            if P + self.window_size - 1 > watermark:
                break
            del self.windows[P]
        if TELEMETRY.enabled:
            TELEMETRY.note_windows_fired(fired)
        return fired


class LogStructuredSessionWindows:
    """Session windows (gap-merged) with Count-Min totals over an event
    log.  Ingest appends (key, ts, weight, value hash); the watermark
    fire sorts by (key, ts), splits runs at gaps (inclusive: abutting
    windows merge), closes sessions with end - 1 <= watermark and keeps
    the open sessions' events."""

    def __init__(self, aggregate: CountMinSketchAggregate, gap_ms: int,
                 emit=None, device: DeviceLike = None):
        if not isinstance(aggregate, CountMinSketchAggregate):
            raise TypeError("session log engine aggregates Count-Min")
        self.device = resolve_device(device)
        self.agg = aggregate
        self.gap = gap_ms
        self.watermark = -(2 ** 63)
        self.emit = emit
        self.emitted: List[Tuple[Any, Any, int, int]] = []
        self.emit_arrays = False
        self.fired: List[Tuple[np.ndarray, np.ndarray, int, int]] = []
        self.num_late_dropped = 0
        self._keys_signed = None
        self._log_keys: List[np.ndarray] = []
        self._log_ts: List[np.ndarray] = []
        self._log_w: List[np.ndarray] = []
        self._log_vh: List[np.ndarray] = []
        #: open-session rows carried from the last fire, in (key, ts)
        #: order exactly as the C++ fire returned them (it merges them
        #: as a key-major stream; re-sorting would corrupt the merge)
        self._ret: Optional[Tuple[np.ndarray, ...]] = None

    def process_batch(self, keys, timestamps, values=None,
                      key_hashes=None, value_hashes=None) -> None:
        ts = np.asarray(timestamps, np.int64)
        keys = _as_u64_keys(self, keys)
        # lateness 0: an event whose own window [ts, ts + gap) has
        # end - 1 <= watermark is late (no merge into a live session is
        # tried: the open sessions are not visible on the host)
        live = ts + self.gap - 1 > self.watermark
        if not live.all():
            self.num_late_dropped += int((~live).sum())
            if not live.any():
                return
            keys, ts = keys[live], ts[live]
            if values is not None:
                values = np.asarray(values)[live]
            if value_hashes is not None:
                value_hashes = np.asarray(value_hashes)[live]
        if value_hashes is None:
            value_hashes = hash_keys_np(values)
        # per-event int truncation of the weight, as the device tier's
        # Count-Min update casts each weight to int32
        w = (np.ones(len(keys), np.float32) if values is None
             else np.asarray(values).astype(np.int32).astype(np.float32))
        self._log_keys.append(keys)
        self._log_ts.append(ts)
        self._log_w.append(w)
        self._log_vh.append(np.asarray(value_hashes, np.uint64))

    def flush(self, grow_to=None) -> None:
        """Interface parity."""

    def advance_watermark(self, watermark: int) -> int:
        self.watermark = watermark
        if not self._log_keys and self._ret is None:
            return 0

        def cat(xs, dt):
            return (xs[0] if len(xs) == 1
                    else (np.concatenate(xs) if xs else np.empty(0, dt)))

        keys = cat(self._log_keys, np.uint64)
        ts = cat(self._log_ts, np.int64)
        w = cat(self._log_w, np.float32)
        vh = cat(self._log_vh, np.uint64)
        ok, os_, oe, ot, retained = nat.session_log_fire(
            keys, ts, w, vh, self.gap, watermark,
            self.agg.depth, self.agg.width, retained=self._ret)
        self._ret = retained if len(retained[0]) else None
        self._log_keys, self._log_ts = [], []
        self._log_w, self._log_vh = [], []
        totals = ot.astype(np.int64)
        ok = _keys_out(self, ok)
        if self.emit_arrays:
            if len(ok):
                self.fired.append((ok, totals, os_, oe))
        elif self.emit is not None:
            for k, t, s, e in zip(ok, totals, os_, oe):
                self.emit(k, t, int(s), int(e))
        else:
            self.emitted.extend(
                (k, t, int(s), int(e))
                for k, t, s, e in zip(ok, totals, os_, oe))
        return len(ok)

    def snapshot(self) -> dict:
        ret = self._ret or (np.empty(0, np.uint64), np.empty(0, np.int64),
                            np.empty(0, np.float32), np.empty(0, np.uint64))

        def cat(xs, extra):
            return np.concatenate([extra, *xs]) if xs else extra.copy()

        return {"watermark": self.watermark,
                "num_late_dropped": self.num_late_dropped,
                "keys_signed": self._keys_signed,
                "keys": cat(self._log_keys, ret[0]),
                "ts": cat(self._log_ts, ret[1]),
                "w": cat(self._log_w, ret[2]),
                "vh": cat(self._log_vh, ret[3])}

    def restore(self, snap: dict) -> None:
        self.restore_many([snap])

    def restore_many(self, snaps, keep_fn=None) -> None:
        """Restore or merge the retained open-session events, filtered to
        ``keep_fn``'s keys on rescale (sessions are per key, so a
        key-partitioned split of the event log is exact)."""
        self.watermark = max(s["watermark"] for s in snaps)
        self.num_late_dropped = sum(s["num_late_dropped"] for s in snaps)
        signed = {s["keys_signed"] for s in snaps
                  if s.get("keys_signed") is not None}
        if len(signed) > 1:
            raise ValueError("snapshots disagree on key signedness")
        self._keys_signed = signed.pop() if signed else None
        self._log_keys, self._log_ts = [], []
        self._log_w, self._log_vh = [], []
        self._ret = None
        for snap in snaps:
            keys = np.asarray(snap["keys"], np.uint64)
            if not len(keys):
                continue
            m = keep_fn(keys) if keep_fn is not None else None
            if m is not None and not m.any():
                continue
            sel = (lambda a: a) if m is None or m.all() \
                else (lambda a, m=m: np.asarray(a)[m])
            self._log_keys.append(sel(keys))
            self._log_ts.append(sel(snap["ts"]))
            self._log_w.append(sel(snap["w"]))
            self._log_vh.append(sel(snap["vh"]))

    def block_until_ready(self) -> None:
        """Host-tier state is always materialized."""
