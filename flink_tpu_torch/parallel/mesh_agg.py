"""Sharded windowed aggregation: the keyBy exchange over a mesh (port of
``flink_tpu/parallel/mesh_agg.py``).

One step per micro-batch replaces the reference's record shuffle and
keyed-state update (KeyGroupStreamPartitioner -> Netty exchange ->
per-record state mutation):

  1. the batch's S data-parallel slices (one per source shard) are
     packed by target shard (key hash -> fmix32 -> key group -> shard,
     KeyGroupRangeAssignment's range arithmetic) into ``[S, S, M]``
     buckets, all sources in one ``shard_pack`` launch;
  2. ``Mesh.all_to_all`` hands shard j its column of buckets;
  3. shard j resolves the keys to slots in its hash table
     (``table_insert``) and scatter-updates its state shard.

A fire reads each shard's whole capacity (key lanes, occupancy,
results) back to the host, which owns hash -> original key, and clears
the shard in place.  Where the reference builds one jitted shard_map
program, the port runs the same steps eagerly, shard after shard.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from flink_tpu_torch.kernels import clear_rows, shard_pack
from flink_tpu_torch.ops.device_agg import DeviceAggregateFunction, device_dtype
from flink_tpu_torch.ops.device_table import (DeviceHashTable,
                                              insert_or_lookup, make_table)
from flink_tpu_torch.parallel.mesh import Mesh
from flink_tpu_torch.runtime.device_stats import TELEMETRY
from flink_tpu_torch.streaming.vectorized import _perf_ns


def _bucketize(h_lo: torch.Tensor, n_shards: int,
               payload: Sequence[torch.Tensor], mask: torch.Tensor,
               max_parallelism: int):
    """Pack the S source slices' rows into ``[S_src, S, M]`` buckets by
    target shard (M = rows per slice, the static worst case): returns
    (one bucket tensor per payload lane, the bucket mask).  The target
    (the reference's ``_target_shard``) is computed in the kernel from
    ``h_lo``; padding rows target the virtual shard S and are never
    sent."""
    m = h_lo.numel() // n_shards
    outs, _ = shard_pack([*payload, mask], n_shards, m, hash_lo=h_lo,
                         max_parallelism=max_parallelism, mask=mask)
    return outs[:-1], outs[-1]


def _exchange(mesh: Mesh, buckets: Sequence[torch.Tensor]
              ) -> List[List[torch.Tensor]]:
    """all_to_all of each lane's buckets; per target shard, its received
    lanes flattened source-major (``[S_src * M]``, on its device)."""
    recv = [mesh.all_to_all(b) for b in buckets]
    return [[r[j].reshape(-1) for r in recv] for j in range(mesh.size)]


def lane_tensor(a, dtype, device: torch.device) -> torch.Tensor:
    """A host column (or tensor) as a device lane: uint32 as int32 bits,
    64-bit values narrowed as the device state keeps them."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    arr = np.ascontiguousarray(a, device_dtype(dtype))
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(arr).to(device)


def step_lanes(mesh: Mesh, agg: DeviceAggregateFunction, h_hi, h_lo, values,
               vh_hi, vh_lo, mask) -> Tuple[torch.Tensor, ...]:
    """The step's inputs on the mesh's home device."""
    dev = mesh.home
    return (lane_tensor(h_hi, np.uint32, dev), lane_tensor(h_lo, np.uint32, dev),
            lane_tensor(values, agg.value_dtype, dev),
            lane_tensor(vh_hi, np.uint32, dev), lane_tensor(vh_lo, np.uint32, dev),
            lane_tensor(mask, np.bool_, dev))


def to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy that later in-place updates of ``t`` do not reach."""
    return t.to("cpu", copy=True).numpy()


class ShardState(NamedTuple):
    """One shard's device state."""
    table: DeviceHashTable
    agg_state: dict


def make_sharded_step(mesh: Mesh, axis: str, agg: DeviceAggregateFunction,
                      max_parallelism: int, capacity_per_shard: int,
                      max_probes: int = 64):
    """(init_fn, step_fn, fire_fn) for mesh-sharded windowed
    aggregation over ``mesh[axis]``; the state is a list of per-shard
    ``ShardState``s, shard s on ``mesh.devices[s]``.

    step_fn(state, h_hi, h_lo, values, vh_hi, vh_lo, mask) -> (state,
    overflow [S]); fire_fn(state) -> (state, (key_hi, key_lo, results,
    occupied)), host arrays ``[S, C, ...]``, the state cleared."""
    n_shards = mesh.shape[axis]

    def init():
        state = []
        for j, d in enumerate(mesh.devices):
            with mesh.on(j):
                state.append(ShardState(make_table(capacity_per_shard, d),
                                        agg.init_state(capacity_per_shard, d)))
        return state

    def step(state, h_hi, h_lo, values, vh_hi, vh_lo, mask):
        with mesh.on(0):
            hhi, hlo, val, vhi, vlo, msk = step_lanes(
                mesh, agg, h_hi, h_lo, values, vh_hi, vh_lo, mask)
            buckets, b_mask = _bucketize(hlo, n_shards,
                                         (hhi, hlo, val, vhi, vlo), msk,
                                         max_parallelism)
        overflow = []
        for j, (st, (f_hhi, f_hlo, f_val, f_vhi, f_vlo, f_mask)) in enumerate(
                zip(state, _exchange(mesh, [*buckets, b_mask]))):
            with mesh.on(j):
                _, slots, ok = insert_or_lookup(st.table, f_hhi, f_hlo, f_mask,
                                                max_probes=max_probes)
                # slots are -1 on padding and overflow: the update skips them
                agg.update(st.agg_state, slots, f_val, f_vhi, f_vlo, len(slots))
                overflow.append((f_mask & ~ok).sum())
        return state, np.array([int(o) for o in overflow], np.int64)

    def fire(state):
        out = []
        for j, st in enumerate(state):
            with mesh.on(j):
                out.append((to_host(st.table.key_hi).view(np.uint32),
                            to_host(st.table.key_lo).view(np.uint32),
                            to_host(agg.result_dense(st.agg_state)),
                            to_host(st.table.occupied).astype(bool)))
                clear_rows(st.table.occupied, 0)
                agg.clear_range(st.agg_state, 0, capacity_per_shard)
        return state, tuple(np.stack(parts) for parts in zip(*out))

    return init, step, fire


class MeshWindowAggregation:
    """Host-facing wrapper: one tumbling window at a time, sharded over
    the mesh.  Each host shard keeps hash -> original key for emission."""

    def __init__(self, mesh: Mesh, axis: str, agg: DeviceAggregateFunction,
                 max_parallelism: int = 128, capacity_per_shard: int = 4096,
                 allow_overflow: bool = False):
        self.mesh = mesh
        self.axis = axis
        self.agg = agg
        self.n_shards = mesh.shape[axis]
        init, self._step, self._fire = make_sharded_step(
            mesh, axis, agg, max_parallelism, capacity_per_shard)
        self.state = init()
        self.capacity_per_shard = capacity_per_shard
        #: overflow policy: a full shard table raises (silently counting
        #: dropped records is data loss); allow_overflow=True counts and
        #: continues, for capacity experiments
        self.allow_overflow = allow_overflow
        self.overflowed = 0

    def step(self, h_hi, h_lo, values, vh_hi, vh_lo, mask) -> None:
        """Process one global batch (length divisible by n_shards)."""
        tel = TELEMETRY.enabled
        t0 = _perf_ns() if tel else 0
        self.state, overflow = self._step(self.state, h_hi, h_lo, values,
                                          vh_hi, vh_lo, mask)
        if tel:
            # the exchange is one call, so its legs are not separable:
            # the call is billed as the collective phase, the overflow
            # read as the copy back
            t1 = _perf_ns()
            overflow = np.asarray(overflow.cpu() if isinstance(
                overflow, torch.Tensor) else overflow)
            t2 = _perf_ns()
            sent = sum(int(getattr(a, "nbytes", 0))
                       for a in (h_hi, h_lo, values, vh_hi, vh_lo, mask))
            TELEMETRY.record_transfer("h2d", sent, t0, t1, tag="mesh.step")
            TELEMETRY.record_transfer("d2h", overflow.nbytes, t1, t2,
                                      tag="mesh.step")
            TELEMETRY.record_exchange_round("mesh.agg", 0.0, 0.0,
                                            (t1 - t0) / 1e6,
                                            (t2 - t1) / 1e6, sent)
        ov = int(overflow.sum())
        if ov:
            self.overflowed += ov
            if not self.allow_overflow:
                raise RuntimeError(
                    f"{ov} records overflowed a shard hash table "
                    f"(capacity_per_shard={self.capacity_per_shard}); "
                    f"raise capacity_per_shard or shard wider")

    def fire(self):
        """Close the window: returns (key_hi, key_lo, results, occupied)
        host arrays concatenated over shards, and resets state."""
        tel = TELEMETRY.enabled
        t0 = _perf_ns() if tel else 0
        self.state, (hi, lo, res, occ) = self._fire(self.state)
        if tel:
            TELEMETRY.record_transfer(
                "d2h", sum(int(getattr(a, "nbytes", 0))
                           for a in (hi, lo, res, occ)),
                t0, _perf_ns(), tag="mesh.fire")
            TELEMETRY.note_fire_read()
        return (hi.reshape(-1), lo.reshape(-1),
                res.reshape(res.shape[0] * res.shape[1], *res.shape[2:]),
                occ.reshape(-1))
