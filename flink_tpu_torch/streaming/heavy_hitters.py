"""Windowed heavy hitters: Count-Min estimates over tracked candidates
(port of ``flink_tpu/streaming/heavy_hitters.py``).

Per (key, window) the device keeps a Count-Min sketch of the items in
the key's stream; the host keeps the bounded set of distinct (key,
item) candidates seen in the window (a sketch can estimate but not
enumerate).  At fire time one ``countmin_query`` launch estimates
every candidate of the window and one gather reads the keys' totals;
items with est >= phi * total (or the top k by estimate) are the
window's heavy hitters.  Ingest stays one ``countmin_update`` launch
per micro-batch and one vectorized slot-index pass per batch for the
candidates.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.device import DeviceLike
from flink_tpu_torch.ops.sketches import CountMinSketchAggregate
from flink_tpu_torch.streaming.vectorized import (VectorizedTumblingWindows,
                                                  device_slots, hash_keys_np,
                                                  make_slot_index, to_device)


class _Candidates:
    """Distinct (key, item) pairs of one window, deduplicated vectorized."""

    __slots__ = ("index", "key_hashes", "item_his", "item_los",
                 "keys", "items", "count")

    def __init__(self):
        self.index = make_slot_index(1 << 10)
        self.key_hashes: List[np.ndarray] = []
        self.item_his: List[np.ndarray] = []
        self.item_los: List[np.ndarray] = []
        self.keys: List[Any] = []
        self.items: List[Any] = []
        self.count = 0

    def add_batch(self, pair_hashes, key_hashes, item_hashes, keys, items):
        next_slot = [self.count]

        def alloc(n):
            out = np.arange(next_slot[0], next_slot[0] + n)
            next_slot[0] += n
            return out

        _, first_idx = self.index.lookup_or_insert(pair_hashes, alloc)
        self.count = next_slot[0]
        if len(first_idx):
            self.key_hashes.append(key_hashes[first_idx])
            ih = item_hashes[first_idx]
            self.item_his.append((ih >> np.uint64(32)).astype(np.uint32))
            self.item_los.append((ih & np.uint64(0xFFFFFFFF)).astype(np.uint32))
            self.keys.extend(np.asarray(keys, dtype=object)[first_idx].tolist())
            self.items.extend(np.asarray(items, dtype=object)[first_idx].tolist())


class WindowedHeavyHitters(VectorizedTumblingWindows):
    """keyBy(key).window(Tumbling).heavy_hitters(item, phi | k).

    ``hh_emitted`` entries are (key, hitters, window_start, window_end),
    hitters a list of (item, estimated_count) sorted descending."""

    def __init__(self, window_size_ms: int, phi: Optional[float] = None,
                 k: Optional[int] = None, depth: int = 4, width: int = 2048,
                 initial_capacity: int = 1 << 14,
                 max_candidates_per_window: int = 1 << 22,
                 microbatch: int = 1 << 17, device: DeviceLike = None):
        if phi is None and k is None:
            raise ValueError("need a phi threshold or a top-k bound")
        agg = CountMinSketchAggregate(depth=depth, width=width)
        super().__init__(agg, window_size_ms,
                         initial_capacity=initial_capacity,
                         microbatch=microbatch, device=device)
        self.phi = phi
        self.k = k
        self.max_candidates = max_candidates_per_window
        self._candidates: Dict[int, _Candidates] = {}
        #: (key, [(item, est), ...], start, end)
        self.hh_emitted: List[Tuple[Any, list, int, int]] = []

    # ---- ingestion ---------------------------------------------------
    def process_items(self, keys, timestamps, items,
                      weights: Optional[np.ndarray] = None) -> None:
        """One batch of (key, item[, weight]) records."""
        ts = np.asarray(timestamps, np.int64)
        kh = hash_keys_np(keys)
        ih = hash_keys_np(items)
        if weights is None:
            weights = np.ones(len(ts), np.float32)
        starts = ts - np.mod(ts, self.size)
        live = starts + self.lateness_horizon - 1 > self.watermark
        pair = kh * np.uint64(0x9E3779B97F4A7C15) ^ ih
        keys_obj = np.asarray(keys, dtype=object)
        items_obj = np.asarray(items, dtype=object)
        for start in np.unique(starts[live]).tolist():
            m = (starts == start) & live
            cand = self._candidates.get(start)
            if cand is None:
                cand = _Candidates()
                self._candidates[start] = cand
            cand.add_batch(pair[m], kh[m], ih[m], keys_obj[m], items_obj[m])
            if cand.count > self.max_candidates:
                raise RuntimeError(
                    f"window {start}: > {self.max_candidates} distinct "
                    f"(key, item) candidates; raise "
                    f"max_candidates_per_window or pre-aggregate")
        self.process_batch(keys, ts, values=weights, key_hashes=kh,
                           value_hashes=ih)

    # ---- firing ------------------------------------------------------
    def advance_watermark(self, watermark: int) -> int:
        # flush, then query every due window's candidates BEFORE the
        # engine fires (the fire clears the window's tables)
        self.flush()
        for start in sorted(self._candidates):
            if start + self.size - 1 > watermark:
                continue
            self._query_window(start, self._candidates.pop(start))
        return super().advance_watermark(watermark)

    def _query_window(self, start: int, cand: _Candidates) -> None:
        shard = self.windows.get(start)
        if shard is None or cand.count == 0:
            return
        key_hashes = np.concatenate(cand.key_hashes)
        ihi = np.concatenate(cand.item_his)
        ilo = np.concatenate(cand.item_los)
        # the keys are in the window's index already: a lookup only
        slots, first_idx = shard.index.lookup_or_insert(key_hashes,
                                                        self.arena.alloc)
        if len(first_idx):
            raise RuntimeError("a candidate key is missing from its "
                               "window's index")
        s = device_slots(slots, self.capacity, self.device)
        ests = self.agg.point_query(self.state, s,
                                    to_device(ihi, self.device),
                                    to_device(ilo, self.device)).cpu().numpy()
        totals = self.agg.result(self.state, s).cpu().numpy()
        if self.phi is not None:
            hits = np.nonzero(ests.astype(np.float64)
                              >= self.phi * totals.astype(np.float64))[0]
        else:
            hits = np.arange(cand.count)
        # group candidates per key (first-seen order) and select
        per_key: Dict[Any, list] = {}
        for i, est in zip(hits.tolist(), ests[hits].astype(np.float64).tolist()):
            per_key.setdefault(cand.keys[i], []).append((cand.items[i], est))
        end = start + self.size
        for key, hitters in per_key.items():
            hitters.sort(key=lambda kv: -kv[1])
            if self.k is not None:
                hitters = hitters[:self.k]
            self.hh_emitted.append((key, hitters, start, end))
