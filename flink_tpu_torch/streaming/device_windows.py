"""Fully device-resident tumbling-window aggregation (port of
``flink_tpu/streaming/device_windows.py``).

Key → slot resolution happens on the card in a hash table
(``ops/device_table.py``): per batch and window the host ships the raw
key lanes (and the value column or value-hash lanes) and launches two
kernels, ``table_insert`` (slots, and overflows counted on the device)
and the aggregate's ``update`` (``hll_update``, ``scatter_combine``,
...), which skips the slot -1 of an overflowed record.  Nothing syncs
per batch: the overflow count is read at the next watermark.

Keys must be 64-bit integers (or anything the caller pre-hashes
injectively): the table stores the original key lanes, so a fire
reconstructs the exact keys from it.  A fire runs the aggregate's dense
``result`` over table positions ``[0, C)`` in tiles (``hll_estimate``
for HLL) and keeps the occupied positions.

Per live window: one table and one state arena of ``capacity``
positions (table position = state slot).  Like the JAX package's
engine, no operator reaches it: callers drive it directly.  Unlike it,
batches are not padded to a power of two (PyTorch runs eagerly, there
is no compile cache to keep warm).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from flink_tpu_torch.device import DeviceLike, resolve_device
from flink_tpu_torch.kernels import table_insert
from flink_tpu_torch.ops.device_agg import DeviceAggregateFunction, device_dtype
from flink_tpu_torch.ops.device_table import DeviceHashTable, make_table
from flink_tpu_torch.streaming.vectorized import to_device


class _DeviceWindow:
    __slots__ = ("start", "table", "state")

    def __init__(self, start: int, table: DeviceHashTable, state: dict):
        self.start = start
        self.table = table
        self.state = state


class DeviceTumblingWindows:
    """keyBy().window(Tumbling).aggregate(agg) with the key index on
    ``device`` (the card unless ``device="cpu"``).

    API: ``process_batch(key_hi, key_lo, timestamps, values, vh_hi,
    vh_lo)`` then ``advance_watermark(wm)``; fired windows land in
    ``fired`` as (keys uint64, results, start, end), keys rebuilt from
    the table."""

    def __init__(self, agg: DeviceAggregateFunction, window_size_ms: int,
                 capacity: int = 1 << 20, max_probes: int = 128,
                 fire_tile: int = 1 << 18, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.agg = agg
        self.size = window_size_ms
        self.capacity = capacity
        self.max_probes = max_probes
        self.fire_tile = fire_tile
        self.watermark = -(2**63)
        self.windows: Dict[int, _DeviceWindow] = {}
        self.num_late_dropped = 0
        self.overflowed = 0
        #: overflows since the last watermark, counted on the device
        self._pending_overflow = torch.zeros(1, dtype=torch.int64,
                                             device=self.device)
        self.fired: List[Tuple[np.ndarray, np.ndarray, int, int]] = []

    def _new_window(self, start: int) -> _DeviceWindow:
        return _DeviceWindow(int(start), make_table(self.capacity, self.device),
                             self.agg.init_state(self.capacity, self.device))

    # ---- ingestion --------------------------------------------------
    def process_batch(self, key_hi: np.ndarray, key_lo: np.ndarray,
                      timestamps: np.ndarray,
                      values: Optional[np.ndarray] = None,
                      vh_hi: Optional[np.ndarray] = None,
                      vh_lo: Optional[np.ndarray] = None) -> None:
        ts = np.asarray(timestamps, np.int64)
        starts = ts - np.mod(ts, self.size)
        live = starts + self.size - 1 > self.watermark
        if not live.all():
            self.num_late_dropped += int((~live).sum())
        dev = self.device
        for start in np.unique(starts[live]):
            w = self.windows.get(int(start))
            if w is None:
                w = self.windows[int(start)] = self._new_window(int(start))
            mask = (starts == start) & live
            sel = slice(None) if mask.all() else mask

            def lanes(a):
                return to_device(np.asarray(a, np.uint32)[sel], dev)

            k_hi, k_lo = lanes(key_hi), lanes(key_lo)
            n = len(k_hi)
            slots = table_insert(w.table.key_hi, w.table.key_lo,
                                 w.table.occupied, k_hi, k_lo, n,
                                 self.max_probes,
                                 overflow=self._pending_overflow)
            vals = hh = hl = None
            if self.agg.needs_value:
                vals = to_device(np.asarray(values)[sel].astype(
                    device_dtype(self.agg.value_dtype)), dev)
            if self.agg.needs_value_hash:
                hh, hl = lanes(vh_hi), lanes(vh_lo)
            # an overflowed record has slot -1: the update skips it
            w.state = self.agg.update(w.state, slots, vals, hh, hl, n)

    # ---- firing -----------------------------------------------------
    def advance_watermark(self, watermark: int) -> int:
        self.watermark = watermark
        self.overflowed += int(self._pending_overflow.item())
        self._pending_overflow.zero_()
        fired_total = 0
        for start in sorted(self.windows):
            if start + self.size - 1 > watermark:
                continue
            w = self.windows.pop(start)
            # the dense result of every table position, tiled; launch
            # every tile before copying any back
            outs = [self.agg.result_dense(
                {k: v[i:i + self.fire_tile] for k, v in w.state.items()})
                for i in range(0, self.capacity, self.fire_tile)]
            results = np.concatenate([o.cpu().numpy() for o in outs])
            occ = w.table.occupied.cpu().numpy().astype(bool)
            hi = w.table.key_hi.cpu().numpy().view(np.uint32)[occ]
            lo = w.table.key_lo.cpu().numpy().view(np.uint32)[occ]
            keys = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
            self.fired.append((keys, results[occ], start, start + self.size))
            fired_total += int(occ.sum())
        return fired_total

    def block_until_ready(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def lanes_from_int_keys(keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Original int64/uint64 keys → (hi, lo) uint32 lanes (identity
    encoding: fires reconstruct the exact keys)."""
    k = np.asarray(keys).astype(np.uint64)
    return ((k >> np.uint64(32)).astype(np.uint32),
            (k & np.uint64(0xFFFFFFFF)).astype(np.uint32))
