"""Mesh-sharded log-structured window engines (port of
``flink_tpu/parallel/mesh_log.py``).

The log-structured engines (``streaming/log_windows.py``) are single
engines; this module scales them as the reference scales all keyed
state: a keyBy exchange routes every record to the shard owning its key
group, and each shard appends what it receives to its OWN log engine.
Fires are per-shard log fires; key groups partition keys disjointly, so
per-shard results are exactly the single-engine results.

- The exchange payload is bit-pattern lanes (u64 key, i64 ts, f64 value,
  u64 value hash, each as two uint32 lanes): the device does no
  arithmetic on it, only the pack by target.
- Targets come from the host with the row runtime's key-group
  arithmetic (the port's C++ ``key_groups``), so a mesh job and a
  keyed job agree on key placement.
- Fast path: the raw lanes and targets go to the card and one
  ``shard_pack`` launch packs every source's rows into ``[S, S, cap,
  K]`` buckets (cap = ``bucket_factor`` x the mean bucket), which
  ``Mesh.all_to_all`` exchanges.  The step is launched before the
  previous one is delivered, so delivery overlaps the card's work; every
  reader of shard state delivers the in-flight step first.
- A step whose (source, target) counts exceed the cap takes the host
  pack instead: a numpy counting partition per source, a pure
  all_to_all of the buckets, and the rows beyond the cap routed to their
  shard out of band (``num_overflow_routed``).
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np
import torch

from flink_tpu_torch import native
from flink_tpu_torch.kernels import shard_pack
from flink_tpu_torch.ops.device_agg import DeviceAggregateFunction
from flink_tpu_torch.ops.sketches import CountMinSketchAggregate
from flink_tpu_torch.parallel.mesh import Mesh
from flink_tpu_torch.runtime.device_stats import TELEMETRY
from flink_tpu_torch.streaming import log_windows as lw
from flink_tpu_torch.streaming.vectorized import _perf_ns, hash_keys_np
from flink_tpu_torch.streaming.windowing import (EventTimeSessionWindows,
                                                 SlidingEventTimeWindows,
                                                 TumblingEventTimeWindows)


def _split_u64(a: np.ndarray):
    a = np.ascontiguousarray(a, np.uint64)
    return ((a >> np.uint64(32)).astype(np.uint32),
            (a & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def _join_u64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    return (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)


def _lanes_to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)


class _MeshShardedLogEngine:
    """N per-shard log engines behind the lane exchange, with the
    standard engine interface (process_batch / flush / advance_watermark
    / emitted / fired / snapshot / restore)."""

    def __init__(self, mesh: Mesh, axis: str, shard_factory,
                 agg: DeviceAggregateFunction,
                 max_parallelism: int = 128, step_batch: int = 8192,
                 bucket_factor: float = 4.0):
        self.mesh = mesh
        self.axis = axis
        self.agg = agg
        self.n_shards = mesh.shape[axis]
        self.max_parallelism = max_parallelism
        if max_parallelism < self.n_shards:
            raise ValueError("max_parallelism < mesh shards")
        # G must be divisible by the shard count (data-parallel slices)
        self.step_batch = -(-step_batch // self.n_shards) * self.n_shards
        self.shards = []
        for j, d in enumerate(mesh.devices):
            with mesh.on(j):
                self.shards.append(shard_factory(d))
        self.needs_value = bool(agg.needs_value)
        self.needs_value_hash = bool(agg.needs_value_hash)
        self.n_lanes = 4 + (2 if self.needs_value else 0) \
            + (2 if self.needs_value_hash else 0)
        m = self.step_batch // self.n_shards
        # per-(source, target) bucket capacity: balanced traffic puts
        # ~m/S rows in each bucket; cap at bucket_factor x the mean
        # (never above the worst case m)
        self.bucket_cap = min(
            m, max(1, int(bucket_factor * m / self.n_shards)))
        # row offsets for the one-bincount overflow precheck: source s
        # contributes ids s*(S+1) + target, so one flat bincount yields
        # the [S, S+1] (source, target) count matrix
        self._src_base = (np.arange(self.n_shards, dtype=np.int64)
                          [:, None] * (self.n_shards + 1))
        #: the previous fast-path step's (recv, rcounts) on the card,
        #: delivered at the next step or at any drain point
        self._inflight = None
        #: rows that overflowed a bucket and took the out-of-band path
        self.num_overflow_routed = 0
        #: steps that took the packed (device) and the host-pack path
        self.num_packed_steps = 0
        self.num_hostpack_steps = 0
        self._keys_signed: Optional[bool] = None
        self._p_lanes: List[np.ndarray] = []
        self._p_tgt: List[np.ndarray] = []
        self._p_n = 0
        self.emit = None
        self.emitted: List[Any] = []
        self.emit_arrays = False
        self.fired: List[Any] = []

    # ---- ingestion --------------------------------------------------
    def process_batch(self, keys, timestamps, values=None,
                      key_hashes=None, value_hashes=None) -> None:
        keys = np.asarray(keys)
        if not np.issubdtype(keys.dtype, np.integer):
            raise TypeError("mesh log engine requires integer keys")
        signed = bool(np.issubdtype(keys.dtype, np.signedinteger))
        if self._keys_signed is None:
            self._keys_signed = signed
        elif self._keys_signed != signed:
            raise TypeError("key dtype signedness changed mid-stream")
        keys_u64 = (keys.astype(np.int64, copy=False).view(np.uint64)
                    if signed else keys.astype(np.uint64, copy=False))
        ts = np.asarray(timestamps, np.int64)
        if key_hashes is None:
            key_hashes = hash_keys_np(keys)
        tgt = native.key_groups(np.asarray(key_hashes, np.uint64),
                                self.max_parallelism, self.n_shards)
        lanes = [*_split_u64(keys_u64), *_split_u64(ts.view(np.uint64))]
        if self.needs_value:
            vals = (np.ones(len(keys), np.float64) if values is None
                    else np.asarray(values, np.float64))
            lanes.extend(_split_u64(vals.view(np.uint64)))
        if self.needs_value_hash:
            if value_hashes is None:
                value_hashes = hash_keys_np(np.asarray(values))
            lanes.extend(_split_u64(np.asarray(value_hashes, np.uint64)))
        self._p_lanes.append(np.stack(lanes, axis=-1))
        self._p_tgt.append(tgt.astype(np.int32, copy=False))
        self._p_n += len(keys)
        while self._p_n >= self.step_batch:
            self._drain_one_step()

    def _concat_pending(self):
        lanes = (self._p_lanes[0] if len(self._p_lanes) == 1
                 else np.concatenate(self._p_lanes))
        tgt = (self._p_tgt[0] if len(self._p_tgt) == 1
               else np.concatenate(self._p_tgt))
        return lanes, tgt

    def _drain_one_step(self) -> None:
        lanes, tgt = self._concat_pending()
        G = self.step_batch
        self._run_step(lanes[:G], tgt[:G], np.ones(G, bool))
        rest_lanes, rest_tgt = lanes[G:], tgt[G:]
        self._p_lanes = [rest_lanes] if len(rest_lanes) else []
        self._p_tgt = [rest_tgt] if len(rest_tgt) else []
        self._p_n = len(rest_lanes)

    def flush(self, grow_to: Optional[int] = None) -> None:
        """Exchange every pending row (the final partial step pads to G
        with masked rows) and deliver the step still in flight."""
        if self._p_n:
            lanes, tgt = self._concat_pending()
            self._p_lanes, self._p_tgt, self._p_n = [], [], 0
            G = self.step_batch
            for off in range(0, len(lanes), G):
                chunk_l, chunk_t = lanes[off:off + G], tgt[off:off + G]
                n = len(chunk_l)
                if n < G:
                    pad_l = np.zeros((G - n, self.n_lanes), np.uint32)
                    chunk_l = np.concatenate([chunk_l, pad_l])
                    chunk_t = np.concatenate(
                        [chunk_t, np.zeros(G - n, np.int32)])
                mask = np.zeros(G, bool)
                mask[:n] = True
                self._run_step(chunk_l, chunk_t, mask)
        self._drain_inflight()

    def _run_step(self, lanes: np.ndarray, tgt: np.ndarray,
                  mask: np.ndarray) -> None:
        """One G-row exchange step; each source slice models one ingest
        host's rows.  Fast path (no bucket over the cap): the raw lanes
        and targets go to the card, ``shard_pack`` packs every source in
        one launch and ``all_to_all`` exchanges; the previous step is
        delivered while this one runs.  Steps with a bucket over the cap
        take the host pack."""
        S, cap = self.n_shards, self.bucket_cap
        m = len(lanes) // S
        telem = TELEMETRY.enabled
        t0 = _perf_ns() if telem else 0
        te = np.where(mask, tgt, S).astype(np.int32, copy=False).reshape(S, m)
        counts_st = np.bincount(
            (self._src_base + te).ravel(),
            minlength=S * (S + 1)).reshape(S, S + 1)[:, :S]
        if (counts_st > cap).any():
            self._drain_inflight()
            self._run_step_hostpack(lanes, te, t0)
            return
        if telem:
            # a phase-split round, delivered at once: the ledger times
            # the copy to the card, the pack and exchange, and the copy
            # back apart (each leg's wall time ends when its calls
            # return; the copy back waits for the legs before it)
            self._drain_inflight()
        t1 = _perf_ns() if telem else 0
        dev = self.mesh.home
        with self.mesh.on(0):
            d_lanes = _lanes_to_device(lanes, dev)
            d_tgt = torch.from_numpy(np.ascontiguousarray(te).reshape(-1)).to(dev)
            t2 = _perf_ns() if telem else 0
            bucks, counts = shard_pack(d_lanes, S, cap, target=d_tgt)
        exchanged = (self.mesh.all_to_all(bucks), self.mesh.all_to_all(counts))
        self.num_packed_steps += 1
        if telem:
            t3 = _perf_ns()
            recv, rcounts = self._to_host(*exchanged)
            t4 = _perf_ns()
            self._ledger_round(lanes.nbytes + te.nbytes, recv, rcounts,
                               t0, t1, t2, t3, t4)
            self._deliver_host(recv, rcounts)
            return
        prev = self._inflight
        self._inflight = exchanged
        if prev is not None:
            self._deliver_recv(*prev)

    @staticmethod
    def _ledger_round(sent, recv, rcounts, t0, t1, t2, t3, t4) -> None:
        got = sum(a.nbytes for a in (*recv, *rcounts))
        TELEMETRY.record_transfer("h2d", sent, t1, t2, tag="mesh.exchange")
        TELEMETRY.record_transfer("d2h", got, t3, t4, tag="mesh.exchange")
        TELEMETRY.record_exchange_round(
            "mesh.log", (t1 - t0) / 1e6, (t2 - t1) / 1e6, (t3 - t2) / 1e6,
            (t4 - t3) / 1e6, sent)

    def _run_step_hostpack(self, lanes: np.ndarray, te: np.ndarray,
                           t0: int = 0) -> None:
        """Host counting-partition pack for a step where some (source,
        target) bucket overflows the cap: per-slice stable sort,
        explicit bucket fill, pure all_to_all, and the beyond-cap tail
        routed out of band."""
        S, cap = self.n_shards, self.bucket_cap
        m = te.shape[1]
        bucks = np.zeros((S, S, cap, self.n_lanes), np.uint32)
        counts = np.zeros((S, S), np.int32)
        overflow = []           # (target, rows) beyond the bucket cap
        for s in range(S):
            tgt_eff = te[s]
            # one stable sort per slice groups rows by target; masked
            # padding rows sort last as virtual target S and never ship
            order = np.argsort(tgt_eff, kind="stable")
            sl_sorted = lanes[s * m:(s + 1) * m][order]
            run_counts = np.bincount(tgt_eff, minlength=S + 1)
            off = 0
            for t in range(S):
                n_t = int(run_counts[t])
                rows = sl_sorted[off:off + n_t]
                off += n_t
                c = min(n_t, cap)
                bucks[s, t, :c] = rows[:c]
                counts[s, t] = c
                if n_t > c:
                    overflow.append((t, rows[c:]))
        dev = self.mesh.home
        telem = TELEMETRY.enabled
        t1 = _perf_ns() if telem else 0
        d_bucks = _lanes_to_device(bucks, dev)
        d_counts = torch.from_numpy(counts).to(dev)
        t2 = _perf_ns() if telem else 0
        recv = self.mesh.all_to_all(d_bucks)
        rcounts = self.mesh.all_to_all(d_counts)
        self.num_hostpack_steps += 1
        if telem:
            t3 = _perf_ns()
            recv, rcounts = self._to_host(recv, rcounts)
            t4 = _perf_ns()
            self._ledger_round(bucks.nbytes + counts.nbytes, recv, rcounts,
                               t0, t1, t2, t3, t4)
            self._deliver_host(recv, rcounts)
        else:
            self._deliver_recv(recv, rcounts)
        # bucket-cap overflow: live rows the exchange could not fit.  One
        # process owns every shard engine, so they route host-side.
        for t, rows in overflow:
            self.num_overflow_routed += len(rows)
            self._deliver(int(t), rows)

    def _deliver_recv(self, recv, rcounts) -> None:
        """Hand shard j the rows ``recv[j][s, :rcounts[j][s]]``, source
        by source (one copy to the host per shard's device)."""
        self._deliver_host(*self._to_host(recv, rcounts))

    @staticmethod
    def _to_host(recv, rcounts):
        """The exchange's received buckets and counts as host arrays,
        one list entry (or tensor row) per shard."""
        host = lambda x: (x.cpu().numpy() if isinstance(x, torch.Tensor)  # noqa: E731
                          else [r.cpu().numpy() for r in x])
        return host(recv), host(rcounts)

    def _deliver_host(self, recv, rcounts) -> None:
        for j in range(self.n_shards):
            rows, counts = recv[j].view(np.uint32), rcounts[j]
            parts = [rows[s, :c] for s, c in enumerate(counts.tolist()) if c]
            if parts:
                self._deliver(j, parts[0] if len(parts) == 1
                              else np.concatenate(parts))

    def _drain_inflight(self) -> None:
        """Deliver the overlapped previous step, if any: called at every
        point that reads shard-engine state (flush -> fires, snapshot)
        and before any out-of-order delivery."""
        inflight = self._inflight
        if inflight is None:
            return
        self._inflight = None
        self._deliver_recv(*inflight)

    def _deliver(self, shard: int, rows: np.ndarray) -> None:
        keys_u64 = _join_u64(rows[:, 0], rows[:, 1])
        keys = (keys_u64.view(np.int64) if self._keys_signed
                else keys_u64)
        ts = _join_u64(rows[:, 2], rows[:, 3]).view(np.int64)
        lane = 4
        values = None
        if self.needs_value:
            values = _join_u64(rows[:, lane],
                               rows[:, lane + 1]).view(np.float64)
            lane += 2
        vh = None
        if self.needs_value_hash:
            vh = _join_u64(rows[:, lane], rows[:, lane + 1])
        self.shards[shard].process_batch(keys, ts, values,
                                         value_hashes=vh)

    # ---- firing -----------------------------------------------------
    def advance_watermark(self, watermark: int) -> int:
        self.flush()
        fired = 0
        for j, sh in enumerate(self.shards):
            sh.emit_arrays = self.emit_arrays
            sh.emit = None
            with self.mesh.on(j):
                fired += sh.advance_watermark(watermark)
            if self.emit_arrays:
                self.fired.extend(sh.fired)
                del sh.fired[:]
            else:
                if self.emit is not None:
                    for k, r, s, e in sh.emitted:
                        self.emit(k, r, s, e)
                else:
                    self.emitted.extend(sh.emitted)
                del sh.emitted[:]
        return fired

    @property
    def num_late_dropped(self) -> int:
        # every late drop happens inside the shard engines
        return sum(sh.num_late_dropped for sh in self.shards)

    @property
    def watermark(self) -> int:
        return max(sh.watermark for sh in self.shards)

    # ---- checkpoint -------------------------------------------------
    def snapshot(self) -> dict:
        # an overlapped step's rows are neither pending nor in any shard
        # yet: land them first or the snapshot would lose them
        self._drain_inflight()
        lanes, tgt = (self._concat_pending() if self._p_n
                      else (np.zeros((0, self.n_lanes), np.uint32),
                            np.zeros(0, np.int32)))
        return {"mesh_log": True,
                "n_shards": self.n_shards,
                "max_parallelism": self.max_parallelism,
                "keys_signed": self._keys_signed,
                "pending_lanes": lanes.copy(),
                "pending_tgt": tgt.copy(),
                "shards": [sh.snapshot() for sh in self.shards]}

    def restore(self, snap: dict) -> None:
        if snap["n_shards"] != self.n_shards:
            raise ValueError(
                f"mesh log checkpoint was taken at {snap['n_shards']} "
                f"shards; this mesh has {self.n_shards} (re-shard the "
                "mesh or restore on a matching one)")
        # key -> shard routing derives from max_parallelism: a mismatch
        # would split each key's state across shards
        if snap["max_parallelism"] != self.max_parallelism:
            raise ValueError(
                f"mesh log checkpoint was taken at max_parallelism="
                f"{snap['max_parallelism']}; this operator is configured "
                f"{self.max_parallelism}: keys would route to other "
                "shards than the ones holding their state")
        # in-flight rows belong to the pre-restore stream: drop them
        self._inflight = None
        self._keys_signed = snap["keys_signed"]
        self._p_lanes = ([snap["pending_lanes"]]
                         if len(snap["pending_lanes"]) else [])
        self._p_tgt = ([snap["pending_tgt"]]
                       if len(snap["pending_tgt"]) else [])
        self._p_n = len(snap["pending_lanes"])
        for sh, s in zip(self.shards, snap["shards"]):
            sh.restore(s)

    def block_until_ready(self) -> None:
        """Land any overlapped exchange step; shard state itself is
        host-resident and always materialized."""
        self._drain_inflight()


class MeshLogTumblingWindows(_MeshShardedLogEngine):
    """keyBy().window(Tumbling).aggregate over the mesh: the exchange
    plus per-shard log-structured fires."""

    def __init__(self, aggregate: DeviceAggregateFunction,
                 window_size_ms: int, mesh: Mesh, axis: str = "kg",
                 max_parallelism: int = 128, step_batch: int = 8192,
                 finish_tier: str = "auto"):
        super().__init__(
            mesh, axis,
            lambda d: lw.LogStructuredTumblingWindows(
                aggregate, window_size_ms, finish_tier=finish_tier,
                device=d),
            aggregate, max_parallelism, step_batch)
        self.size = window_size_ms


class MeshLogSlidingWindows(_MeshShardedLogEngine):
    """Sliding windows over the mesh: per-shard pane logs (one append
    per record regardless of overlap), exchange as above."""

    def __init__(self, aggregate: DeviceAggregateFunction,
                 window_size_ms: int, slide_ms: int, mesh: Mesh,
                 axis: str = "kg", max_parallelism: int = 128,
                 step_batch: int = 8192, finish_tier: str = "auto"):
        super().__init__(
            mesh, axis,
            lambda d: lw.LogStructuredSlidingWindows(
                aggregate, window_size_ms, slide_ms,
                finish_tier=finish_tier, device=d),
            aggregate, max_parallelism, step_batch)
        self.size = window_size_ms
        self.slide = slide_ms


class MeshLogSessionWindows(_MeshShardedLogEngine):
    """Session windows over the mesh.  Sessions are per key and key
    groups partition keys disjointly, so per-shard gap merging is the
    single-engine semantics."""

    def __init__(self, aggregate: CountMinSketchAggregate, gap_ms: int,
                 mesh: Mesh, axis: str = "kg", max_parallelism: int = 128,
                 step_batch: int = 8192):
        super().__init__(
            mesh, axis,
            lambda d: lw.LogStructuredSessionWindows(aggregate, gap_ms,
                                                     device=d),
            aggregate, max_parallelism, step_batch)
        self.gap = gap_ms


def mesh_log_engine_for_assigner(assigner, agg: DeviceAggregateFunction,
                                 mesh: Mesh, axis: str = "kg",
                                 max_parallelism: int = 128):
    """The mesh-sharded log tier for this assigner and aggregate, or None
    when the cell decomposition or the assigner's shape does not fit (the
    scope of ``log_engine_for_assigner``: integer keys, HLL / Sum /
    quantile cells, Count-Min sessions).  A failed build of the host
    runtime raises."""
    try:
        if isinstance(assigner, TumblingEventTimeWindows) \
                and assigner.offset == 0:
            return MeshLogTumblingWindows(
                agg, assigner.size, mesh, axis=axis,
                max_parallelism=max_parallelism)
        if (isinstance(assigner, SlidingEventTimeWindows)
                and assigner.offset == 0
                and assigner.size % assigner.slide == 0):
            return MeshLogSlidingWindows(
                agg, assigner.size, assigner.slide, mesh, axis=axis,
                max_parallelism=max_parallelism)
        if isinstance(assigner, EventTimeSessionWindows):
            return MeshLogSessionWindows(
                agg, assigner.gap, mesh, axis=axis,
                max_parallelism=max_parallelism)
    except (TypeError, ValueError):
        pass  # no cell decomposition, or parameters the tier refuses
    return None
