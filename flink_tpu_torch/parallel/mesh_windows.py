"""Mesh-sharded multi-window tumbling and sliding aggregation: the
framework path (port of ``flink_tpu/parallel/mesh_windows.py``).

Where ``mesh_agg`` is the single-window demo, this engine is the one the
job graph drives: it speaks the host interface of the single-device
engines (process_batch / advance_watermark / emitted / snapshot /
restore), so ``DeviceWindowOperator`` can host it and
``keyBy().window(Tumbling...).aggregate(device_agg)`` runs sharded over
a :class:`~flink_tpu_torch.parallel.mesh.Mesh` with several live
windows, watermark-driven fires and late-record dropping.

  host    : key hashing and window assignment; late records dropped
            against the current watermark (lateness 0, done in bulk);
            each record gets a RING INDEX = (start // size) % R.
  device  : one step per micro-batch: ``shard_pack`` of the S source
            slices by target shard -> ``Mesh.all_to_all`` -> on each
            shard a REGIONAL ``table_insert`` (one region per ring slot,
            so several live windows share one table) -> the aggregate's
            update.
  fire    : when the watermark passes a window end, each shard's region
            of that ring slot comes back (key lanes, occupancy, results);
            the host resolves hashes to original keys through the
            window's key directory and emits with [start, end); the
            region is cleared for the ring slot's next window.

Records of windows beyond the ring horizon park on the host until their
ring slot frees.  A region that runs out of slots raises
(``MeshWindowOverflowError``), never drops data.

:class:`MeshSlidingWindows` composes sliding windows from slide-sized
pane regions in the same ring: keys stay on their shard across panes,
so a window fire is a shard-local merge (each pane region's occupied
keys insert into a scratch region and fold in via ``agg.merge_slots``),
then the scratch region fires like a tumbling window.

The port's key directory of a window is a set of (hash, key) arrays
resolved by ``np.searchsorted`` where the reference keeps a dict: the
same first-seen key for each hash, without a Python loop per key.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from flink_tpu_torch.kernels import clear_rows
from flink_tpu_torch.ops.device_agg import (DeviceAggregateFunction,
                                            state_from_numpy)
from flink_tpu_torch.ops.device_table import (insert_or_lookup_regions_impl,
                                              make_table, table_from_numpy)
from flink_tpu_torch.ops.hashing import split_hash64_np
from flink_tpu_torch.parallel.mesh import Mesh
from flink_tpu_torch.parallel.mesh_agg import (_bucketize, _exchange,
                                               lane_tensor, step_lanes,
                                               to_host)
from flink_tpu_torch.streaming.vectorized import hash_keys_np
from flink_tpu_torch.state.stats import register_device_engine


class MeshWindowOverflowError(RuntimeError):
    """A shard's window region ran out of slots (keys per window per
    shard exceeded capacity_per_window_shard).  Raised, not counted:
    dropping records silently would break the aggregation."""


class _KeyDirectory:
    """hash -> original key of one window: the first key seen for each
    hash.  Batches append arrays; a lookup consolidates them once."""

    def __init__(self, hashes=None, keys=None):
        self._parts: List[Tuple[np.ndarray, np.ndarray]] = []
        self._table = None
        if hashes is not None:
            self.add(hashes, keys)

    @classmethod
    def from_dict(cls, d: Dict[int, Any]) -> "_KeyDirectory":
        """From the reference's ``{hash: key}``.  Keys of one numpy
        scalar type become an array of that type, rows of one 2-D key
        array a 2-D array, as ingest stores them; any other keys an
        object array."""
        hashes = np.fromiter(d.keys(), np.uint64, len(d))
        vals = list(d.values())
        kind = type(vals[0]) if vals else None
        if kind is not None and issubclass(kind, np.generic) and all(
                type(v) is kind for v in vals):
            keys = np.array(vals)
        elif kind is np.ndarray and all(
                type(v) is np.ndarray and v.shape == vals[0].shape
                and v.dtype == vals[0].dtype for v in vals):
            keys = np.stack(vals)
        else:
            keys = np.fromiter(vals, object, len(vals))
        return cls(hashes, keys)

    def to_dict(self) -> Dict[int, Any]:
        """The reference's ``{hash: key}``: int hashes, keys as ingest
        held them."""
        uniq, keys = self.export()
        return dict(zip(uniq.tolist(), keys))

    def add(self, hashes: np.ndarray, keys: np.ndarray) -> None:
        self._parts.append((np.asarray(hashes, np.uint64), keys))
        self._table = None

    def export(self) -> Tuple[np.ndarray, np.ndarray]:
        """(sorted unique hashes, their first-seen keys)."""
        if self._table is None:
            h = np.concatenate([p[0] for p in self._parts])
            k = np.concatenate([p[1] for p in self._parts])
            uniq, first = np.unique(h, return_index=True)
            self._table = (uniq, k[first])
            self._parts = [self._table]
        return self._table

    @staticmethod
    def resolve(dirs: Sequence["_KeyDirectory"], h64: np.ndarray) -> np.ndarray:
        """The keys of ``h64`` from the first directory holding each."""
        merged = _KeyDirectory()
        for d in dirs:
            merged.add(*d.export())
        uniq, keys = merged.export()
        idx = np.searchsorted(uniq, h64)
        if len(h64) and (len(uniq) == 0 or np.any(
                uniq[np.minimum(idx, len(uniq) - 1)] != h64)):
            raise KeyError("a fired key hash is in no window directory")
        return keys[idx]


def _restore_directories(kd: dict, live) -> Dict[int, _KeyDirectory]:
    """A snapshot's key directories in any of the layouts written: per
    window ``{start: {hash: key}}`` (both packages), the port's older
    ``{start: (hashes, keys)}``, or the legacy flat ``{hash: key}``,
    which every live window draws on."""
    if not kd:
        return {}
    first = next(iter(kd.values()))
    if isinstance(first, dict):
        return {s: _KeyDirectory.from_dict(d) for s, d in kd.items()}
    if (isinstance(first, tuple) and len(first) == 2
            and isinstance(first[0], np.ndarray)):
        return {s: _KeyDirectory(*d) for s, d in kd.items()}
    return {s: _KeyDirectory.from_dict(kd) for s in live}


def _region(r: int, region_size: int) -> slice:
    return slice(r * region_size, (r + 1) * region_size)


def _build_programs(mesh: Mesh, axis: str, agg: DeviceAggregateFunction,
                    max_parallelism: int, ring: int, region_size: int,
                    max_probes: int):
    """(init, step, fire, clear) over the S shards' tables and states,
    updated in place.  Local table/state capacity = ring * region_size;
    region r holds ring slot r."""
    n_shards = mesh.shape[axis]
    local_cap = ring * region_size

    def init():
        tables, states = [], []
        for j, d in enumerate(mesh.devices):
            with mesh.on(j):
                tables.append(make_table(local_cap, d))
                states.append(agg.init_state(local_cap, d))
        return tables, states

    def step(table, state, h_hi, h_lo, ring_idx, values, vh_hi, vh_lo, mask):
        with mesh.on(0):
            hhi, hlo, val, vhi, vlo, msk = step_lanes(
                mesh, agg, h_hi, h_lo, values, vh_hi, vh_lo, mask)
            rix = lane_tensor(ring_idx, np.int32, mesh.home)
            buckets, b_mask = _bucketize(hlo, n_shards,
                                         (hhi, hlo, rix, val, vhi, vlo), msk,
                                         max_parallelism)
        overflow = []
        for j, (t, s, (f_hhi, f_hlo, f_ring, f_val, f_vhi, f_vlo, f_mask)) in \
                enumerate(zip(table, state, _exchange(mesh, [*buckets, b_mask]))):
            with mesh.on(j):
                _, slots, ok = insert_or_lookup_regions_impl(
                    t, f_hhi, f_hlo, f_ring, f_mask, region_size=region_size,
                    max_probes=max_probes)
                # slots are -1 on padding and overflow: the update skips them
                agg.update(s, slots, f_val, f_vhi, f_vlo, len(slots))
                overflow.append((f_mask & ~ok).sum())
        return np.array([int(o) for o in overflow], np.int64)

    def fire(table, state, r: int):
        sl = _region(r, region_size)
        out = []
        for j, (t, s) in enumerate(zip(table, state)):
            with mesh.on(j):
                out.append((to_host(t.key_hi[sl]).view(np.uint32),
                            to_host(t.key_lo[sl]).view(np.uint32),
                            to_host(t.occupied[sl]).astype(bool),
                            to_host(agg.result_dense(
                                {k: v[sl] for k, v in s.items()}))))
        clear(table, state, r)
        return tuple(np.stack(parts) for parts in zip(*out))

    def clear(table, state, r: int):
        for j, (t, s) in enumerate(zip(table, state)):
            with mesh.on(j):
                clear_rows(t.occupied, 0, start=r * region_size,
                           count=region_size)
                agg.clear_range(s, r * region_size, region_size)

    return init, step, fire, clear


def _build_merge_program(mesh: Mesh, agg: DeviceAggregateFunction,
                         region_size: int, scratch_region: int,
                         max_probes: int):
    """Shard-local pane merge for sliding fires: for each of the
    window's live pane regions, in pane order, insert its occupied keys
    into the scratch region and fold their accumulators in via
    ``agg.merge_slots``.  No exchange: keys live on the same shard
    across panes.  Lanes that miss (unoccupied, or scratch overflow) get
    slot -1, which the merge skips (the reference points them at its
    junk slot, and walks its always-empty junk region for each missing
    pane)."""

    def merge_shard(t, s, dev, regions: Sequence[int]):
        lane = torch.arange(region_size, dtype=torch.int32, device=dev)
        scratch = torch.full((region_size,), scratch_region,
                             dtype=torch.int32, device=dev)
        missed = torch.zeros((), dtype=torch.int64, device=dev)
        for r in regions:
            sl = _region(r, region_size)
            occ = t.occupied[sl].bool()
            # copies: the insert writes the table these lanes are from
            _, dst, ok = insert_or_lookup_regions_impl(
                t, t.key_hi[sl].clone(), t.key_lo[sl].clone(), scratch, occ,
                region_size=region_size, max_probes=max_probes)
            eff = occ & ok & (dst >= 0)
            agg.merge_slots(s, torch.where(eff, dst, -1),
                            torch.where(eff, lane + r * region_size, -1))
            missed += (occ & ~eff).sum()
        return int(missed)

    def merge(table, state, regions: Sequence[int]):
        overflow = []
        for j, (t, s, dev) in enumerate(zip(table, state, mesh.devices)):
            with mesh.on(j):
                overflow.append(merge_shard(t, s, dev, regions))
        return np.array(overflow, np.int64)

    return merge


class MeshTumblingWindows:
    """Multi-window mesh-sharded tumbling engine with the vectorized-
    engine host interface (DeviceWindowOperator-compatible).

    emitted   : list of (key, result, window_start, window_end)
    fired     : batch form when emit_arrays (keys, results_np, s, e)
    """

    def __init__(self, aggregate: DeviceAggregateFunction,
                 window_size_ms: int, mesh: Mesh, axis: str = "kg",
                 max_parallelism: int = 128,
                 capacity_per_window_shard: int = 1 << 12,
                 ring: int = 8, step_batch: int = 1 << 12,
                 max_probes: int = 64):
        self.agg = aggregate
        self.size = window_size_ms
        #: how far past a (pane) start a record stays live; the sliding
        #: subclass widens it to the full window size
        self.lateness_horizon = window_size_ms
        self.mesh = mesh
        self.axis = axis
        self.n_shards = mesh.shape[axis]
        self.max_parallelism = max_parallelism
        self.ring = ring
        #: ring slots handed to windows; subclasses may reserve a suffix
        #: of the ring for scratch regions
        self.usable_ring = ring
        self.region_size = capacity_per_window_shard
        if step_batch % self.n_shards:
            step_batch += self.n_shards - step_batch % self.n_shards
        self.step_batch = step_batch
        init, self._step, self._fire, self._clear = _build_programs(
            mesh, axis, aggregate, max_parallelism, ring,
            capacity_per_window_shard, max_probes)
        self.table, self.state = init()
        register_device_engine(self)
        self.watermark = -(2 ** 63)
        self.num_late_dropped = 0
        self.emitted: List[Tuple[Any, Any, int, int]] = []
        self.emit_arrays = False
        self.fired: List[Tuple[np.ndarray, np.ndarray, int, int]] = []
        #: ring slot r -> window start currently resident (or None)
        self.ring_window: List[Optional[int]] = [None] * ring
        #: windows with device-resident data, start -> ring slot
        self.live: Dict[int, int] = {}
        #: per-window key directory: window start -> hash -> key; deleted
        #: when the window fires, so host memory is bounded by the LIVE
        #: windows' keys
        self.key_directory: Dict[int, _KeyDirectory] = {}
        #: far-future records parked until their ring slot frees:
        #: start -> list of (kh, values, vh) tuples
        self.pending: Dict[int, List[Tuple[np.ndarray, Optional[np.ndarray],
                                           Optional[np.ndarray]]]] = {}
        self._b_kh: List[np.ndarray] = []
        self._b_ring: List[np.ndarray] = []
        self._b_val: List[np.ndarray] = []
        self._b_vh: List[np.ndarray] = []
        self._b_count = 0

    # ---- ingestion ---------------------------------------------------
    def process_batch(self, keys, timestamps, values=None,
                      key_hashes=None, value_hashes=None) -> None:
        ts = np.asarray(timestamps, np.int64)
        kh = (np.asarray(key_hashes, np.uint64) if key_hashes is not None
              else hash_keys_np(keys))
        starts = ts - np.mod(ts, self.size)
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
            value_hashes = hash_keys_np(np.asarray(values))

        keys_arr = keys if isinstance(keys, np.ndarray) else np.asarray(
            keys, dtype=object)
        vals = (np.asarray(values, self.agg.value_dtype)
                if self.agg.needs_value else None)
        for start in np.unique(starts).tolist():
            m = starts == start
            w_kh = kh[m]
            # the host owns hash -> original key per window (emission
            # needs it back): batch-unique hashes only
            uniq, first = np.unique(w_kh, return_index=True)
            self.key_directory.setdefault(int(start), _KeyDirectory()).add(
                uniq, keys_arr[m][first])
            self._ingest_window(
                int(start), w_kh,
                None if vals is None else vals[m],
                None if value_hashes is None else value_hashes[m])

    def _ingest_window(self, start: int, kh, vals, vhs) -> None:
        r = self._acquire_ring_slot(start)
        if r is None:
            self.pending.setdefault(start, []).append((kh, vals, vhs))
            return
        self._b_kh.append(kh)
        self._b_ring.append(np.full(len(kh), r, np.int32))
        if vals is not None:
            self._b_val.append(vals)
        if vhs is not None:
            self._b_vh.append(vhs)
        self._b_count += len(kh)
        if self._b_count >= self.step_batch:
            self.flush()

    def _acquire_ring_slot(self, start: int) -> Optional[int]:
        got = self.live.get(start)
        if got is not None:
            return got
        r = (start // self.size) % self.usable_ring
        if self.ring_window[r] is not None:
            return None  # occupied by another live window: park
        self.ring_window[r] = start
        self.live[start] = r
        return r

    # ---- device step -------------------------------------------------
    def flush(self) -> None:
        if self._b_count == 0:
            return
        kh = np.concatenate(self._b_kh)
        ring = np.concatenate(self._b_ring)
        vals = np.concatenate(self._b_val) if self._b_val else None
        vhs = np.concatenate(self._b_vh) if self._b_vh else None
        self._b_kh.clear()
        self._b_ring.clear()
        self._b_val.clear()
        self._b_vh.clear()
        self._b_count = 0
        B = self.step_batch
        for i in range(0, len(kh), B):
            self._run_step(kh[i:i + B], ring[i:i + B],
                           None if vals is None else vals[i:i + B],
                           None if vhs is None else vhs[i:i + B])

    def _run_step(self, kh, ring, vals, vhs) -> None:
        n = len(kh)
        B = self.step_batch
        hi, lo = split_hash64_np(kh)

        def pad(a, dtype):
            out = np.zeros(B, dtype)
            out[:n] = a
            return out

        mask = np.zeros(B, bool)
        mask[:n] = True
        p_val = (pad(vals, self.agg.value_dtype) if vals is not None
                 else np.zeros(B, self.agg.value_dtype))
        if vhs is not None:
            vhi, vlo = split_hash64_np(vhs)
            p_vhi, p_vlo = pad(vhi, np.uint32), pad(vlo, np.uint32)
        else:
            p_vhi = p_vlo = np.zeros(B, np.uint32)
        overflow = self._step(
            self.table, self.state, pad(hi, np.uint32), pad(lo, np.uint32),
            pad(ring, np.int32), p_val, p_vhi, p_vlo, mask)
        ov = int(overflow.sum())
        if ov:
            raise MeshWindowOverflowError(
                f"{ov} records overflowed a window region "
                f"(capacity_per_window_shard={self.region_size}, "
                f"shards={self.n_shards}); raise capacity_per_window_shard")

    # ---- firing ------------------------------------------------------
    def advance_watermark(self, watermark: int) -> int:
        """Fire due windows, interleaved with un-parking: a fire frees
        its ring slot, which may admit a parked window, which may itself
        be due (the end-of-input MAX_WATERMARK fires every window in one
        call), so alternate ingest and fire until stable.  Parked records
        were on time when they arrived; they are never dropped as late."""
        self.watermark = watermark
        fired = 0
        while True:
            progress = False
            for start in sorted(self.pending):
                if self._acquire_ring_slot(start) is not None:
                    for kh, vals, vhs in self.pending.pop(start):
                        self._ingest_window(start, kh, vals, vhs)
                    progress = True
            self.flush()
            for start in sorted(self.live):
                if start + self.size - 1 > watermark:
                    break
                fired += self._fire_window(start)
                progress = True
            if not progress:
                break
        return fired

    def _fire_region(self, r: int):
        """Fire and clear one region; returns (key hash64s, results) of
        its occupied lanes across all shards."""
        hi, lo, occ, res = self._fire(self.table, self.state, r)
        hi, lo, occ = hi.reshape(-1), lo.reshape(-1), occ.reshape(-1)
        res = res.reshape(res.shape[0] * res.shape[1], *res.shape[2:])
        sel = np.nonzero(occ)[0]
        h64 = (hi[sel].astype(np.uint64) << np.uint64(32)) | lo[sel].astype(
            np.uint64)
        return h64, res[sel]

    def _emit(self, keys, res, start: int, end: int) -> int:
        if self.emit_arrays:
            self.fired.append((keys, res, start, end))
        else:
            for k, v in zip(keys, res):
                out = v.item() if np.ndim(v) == 0 else v
                self.emitted.append((k, out, start, end))
        return len(keys)

    def _fire_window(self, start: int) -> int:
        r = self.live.pop(start)
        self.ring_window[r] = None
        h64, res = self._fire_region(r)
        wdir = self.key_directory.pop(start, None)
        if not len(h64):
            return 0
        return self._emit(_KeyDirectory.resolve([wdir], h64), res, start,
                          start + self.size)

    def block_until_ready(self) -> None:
        for d in set(self.mesh.devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    # ---- checkpoint --------------------------------------------------
    def snapshot(self) -> dict:
        self.flush()
        tables = [(to_host(t.key_hi).view(np.uint32),
                   to_host(t.key_lo).view(np.uint32),
                   to_host(t.occupied).astype(bool)) for t in self.table]
        return {
            "table": tuple(np.stack(p) for p in zip(*tables)),
            "state": {k: np.stack([to_host(s[k]) for s in self.state])
                      for k in self.state[0]},
            "max_parallelism": self.max_parallelism,
            "watermark": self.watermark,
            "num_late_dropped": self.num_late_dropped,
            "ring_window": list(self.ring_window),
            "live": dict(self.live),
            "key_directory": {s: d.to_dict()
                              for s, d in self.key_directory.items()},
            "pending": {s: [(np.array(kh), None if v is None else np.array(v),
                             None if h is None else np.array(h))
                            for kh, v, h in lst]
                        for s, lst in self.pending.items()},
            "fired_horizon": getattr(self, "_fired_horizon", None),
            "blocked": (sorted(self._blocked)
                        if hasattr(self, "_blocked") else None),
        }

    def restore(self, snap: dict) -> None:
        # key -> shard routing derives from max_parallelism: a mismatch
        # would route keys away from their restored state; snapshots
        # without it were taken at the old fixed default of 128
        snap_mp = snap.get("max_parallelism", 128)
        if snap_mp != self.max_parallelism:
            raise ValueError(
                f"mesh window checkpoint was taken at max_parallelism="
                f"{snap_mp}; this operator is configured "
                f"{self.max_parallelism}")
        hi, lo, occ = snap["table"]
        if len(hi) != self.n_shards:
            raise ValueError(f"mesh window checkpoint was taken at {len(hi)} "
                             f"shards; this mesh has {self.n_shards}")
        self.table = [table_from_numpy(hi[s], lo[s], occ[s], device=d)
                      for s, d in enumerate(self.mesh.devices)]
        self.state = [state_from_numpy(
            self.agg, {k: v[s] for k, v in snap["state"].items()}, device=d)
            for s, d in enumerate(self.mesh.devices)]
        self.watermark = snap["watermark"]
        self.num_late_dropped = snap["num_late_dropped"]
        self.ring_window = list(snap["ring_window"])
        self.live = dict(snap["live"])
        self.key_directory = _restore_directories(snap["key_directory"],
                                                  snap["live"])
        if snap.get("fired_horizon") is not None:
            self._fired_horizon = snap["fired_horizon"]
        if hasattr(self, "_blocked"):
            self._blocked = set(snap.get("blocked") or ())
        self.pending = {s: list(lst) for s, lst in snap["pending"].items()}
        self._b_kh.clear()
        self._b_ring.clear()
        self._b_val.clear()
        self._b_vh.clear()
        self._b_count = 0


class MeshSlidingWindows(MeshTumblingWindows):
    """Mesh-sharded sliding windows by pane composition.

    Ingest runs the tumbling engine at slide granularity (one region per
    pane, one exchanged insert per record); a window fire merges its
    size/slide pane regions shard-locally into a reserved scratch region
    (``agg.merge_slots``) and fires the scratch like a tumbling window.
    Pane regions stay live until no future window needs them (the fire
    and prune rules of VectorizedSlidingWindows, lateness 0)."""

    def __init__(self, aggregate: DeviceAggregateFunction,
                 window_size_ms: int, slide_ms: int, mesh: Mesh,
                 axis: str = "kg", max_parallelism: int = 128,
                 capacity_per_window_shard: int = 1 << 12,
                 extra_ring: int = 4, step_batch: int = 1 << 12,
                 max_probes: int = 64):
        if window_size_ms % slide_ms != 0:
            raise ValueError("window size must be a multiple of the slide "
                             "(pane composition)")
        n_panes = window_size_ms // slide_ms
        if n_panes > 32:
            # a merge walks n_panes regions and the ring holds n_panes
            # regions per shard: work and memory scale with the overlap
            raise ValueError(
                f"mesh sliding supports size/slide <= 32 (got {n_panes}); "
                "use the single-device sliding engines for higher overlap")
        # pane slots + slack for in-flight panes + scratch + junk
        ring = n_panes + extra_ring + 2
        super().__init__(aggregate, slide_ms, mesh, axis, max_parallelism,
                         capacity_per_window_shard, ring, step_batch,
                         max_probes)
        self.window_size = window_size_ms
        self.slide = slide_ms
        self.n_panes = n_panes
        self.lateness_horizon = window_size_ms
        # the ring's last two regions: scratch (window merges fire from
        # it) and junk (an always-empty region standing in for a missing
        # pane; never inserted into)
        self.usable_ring = ring - 2
        self.scratch_region = ring - 2
        self.junk_region = ring - 1
        self.ring_window[self.scratch_region] = -1
        self.ring_window[self.junk_region] = -1
        self._fired_horizon = -(2 ** 63)
        #: due windows skipped because one of their panes was parked;
        #: carried across advance_watermark calls so they fire once the
        #: pane unparks
        self._blocked: set = set()
        self._merge = _build_merge_program(
            mesh, aggregate, self.region_size, self.scratch_region,
            max_probes)

    # ---- firing ------------------------------------------------------
    def advance_watermark(self, watermark: int) -> int:
        prev = self._fired_horizon
        self._fired_horizon = watermark
        self.watermark = watermark
        # windows due on an earlier call but skipped on a parked pane:
        # retry them past the fired horizon (they never fired)
        retry = self._blocked
        blocked = set(retry)
        fired = 0
        done = set()
        while True:
            progress = False
            for start in sorted(self.pending):
                if self._acquire_ring_slot(start) is not None:
                    for kh, vals, vhs in self.pending.pop(start):
                        self._ingest_window(start, kh, vals, vhs)
                    progress = True
            self.flush()
            # scan windows over live AND pending panes: a due window whose
            # every pane is parked has no live pane to anchor the scan,
            # yet must be recorded as blocked so it fires later
            panes_known = set(self.live) | set(self.pending)
            if panes_known:
                min_pane = min(panes_known)
                max_pane = max(panes_known)
                hi = min(watermark - self.window_size + 1, max_pane)
                start_from = min_pane - self.window_size + self.slide
                first = -(-start_from // self.slide) * self.slide
                for W in range(first, hi + 1, self.slide):
                    if W in done or (W + self.window_size - 1 <= prev
                                     and W not in retry):
                        continue
                    # a parked pane's records are on time: firing without
                    # them would lose data, so park the WINDOW too
                    if any(p in self.pending
                           for p in range(W, W + self.window_size,
                                          self.slide)):
                        blocked.add(W)
                        continue
                    panes = [p for p in range(W, W + self.window_size,
                                              self.slide) if p in self.live]
                    if not panes:
                        continue
                    fired += self._fire_sliding_window(W, panes)
                    done.add(W)
                    progress = True
            if self._prune_panes(watermark, done, prev, retry):
                progress = True
            if not progress:
                break
        self._blocked = blocked - done
        return fired

    def _fire_sliding_window(self, W: int, pane_starts) -> int:
        overflow = self._merge(self.table, self.state,
                               [self.live[p] for p in pane_starts])
        ov = int(overflow.sum())
        if ov:
            raise MeshWindowOverflowError(
                f"{ov} keys overflowed the sliding scratch region "
                f"(capacity_per_window_shard={self.region_size}); a "
                f"window's distinct keys per shard must fit one region")
        h64, res = self._fire_region(self.scratch_region)
        if not len(h64):
            return 0
        dirs = [self.key_directory[p] for p in pane_starts
                if p in self.key_directory]
        return self._emit(_KeyDirectory.resolve(dirs, h64), res, W,
                          W + self.window_size)

    def _prune_panes(self, watermark: int, done, prev: int,
                     retry=frozenset()) -> bool:
        """Pane [P, P+slide) dies once every window containing it has
        FIRED (not merely become due: a due window blocked on a parked
        pane still needs this pane): clear its region and free its ring
        slot and key directory.  Windows in ``retry`` sit behind the
        fired horizon but never fired; they count as unfired here."""
        pruned = False
        for P in sorted(self.live):
            if P + self.window_size - 1 > watermark:
                break
            blocked = False
            for W in range(P - self.window_size + self.slide,
                           P + self.slide, self.slide):
                if (W + self.window_size - 1 <= watermark
                        and (W + self.window_size - 1 > prev or W in retry)
                        and W not in done
                        and any(q in self.pending or q in self.live
                                for q in range(W, W + self.window_size,
                                               self.slide))):
                    blocked = True
                    break
            if blocked:
                continue
            r = self.live.pop(P)
            self.ring_window[r] = None
            self._clear(self.table, self.state, r)
            self.key_directory.pop(P, None)
            pruned = True
        return pruned
