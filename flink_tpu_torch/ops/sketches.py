"""Mergeable sketch aggregates (port of ``flink_tpu/ops/sketches.py:36-116``).

The port carries ``HyperLogLogAggregate``; Count-Min and quantile
sketches are later slices.  HLL registers are ``uint8 [slots, m]`` in
device memory; a batch update is one ``hll_update`` kernel launch, a
fire one ``hll_estimate`` launch, and a merge (``merge_slots`` /
``merge_rows``, the register-wise max of ``combiners``) one
``merge_rows`` launch.  Rank and register come from exact
integer bit operations, so registers are bit-equal to the reference.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from flink_tpu_torch.kernels import hll_estimate, hll_update
from flink_tpu_torch.ops.device_agg import DeviceAggregateFunction, StateSpec


class HyperLogLogAggregate(DeviceAggregateFunction):
    """Approximate COUNT DISTINCT: 2^precision uint8 registers per slot,
    the alpha_m bias correction, linear counting in the small range.
    Relative error ~1.04/sqrt(m) (precision 12: ~1.6%)."""

    needs_value_hash = True
    combiners = {"regs": "max"}

    def __init__(self, precision: int = 12):
        if not 4 <= precision <= 18:
            raise ValueError("precision must be in [4, 18]")
        self.precision = precision
        self.m = 1 << precision
        if self.m == 16:
            self.alpha = 0.673
        elif self.m == 32:
            self.alpha = 0.697
        elif self.m == 64:
            self.alpha = 0.709
        else:
            self.alpha = 0.7213 / (1.0 + 1.079 / self.m)

    def state_specs(self) -> Dict[str, StateSpec]:
        return {"regs": StateSpec((self.m,), np.dtype(np.uint8), 0)}

    def compress_value_hash(self, vh_hi, vh_lo):
        """Host-side precompute: ship (rank uint8, register uint16)
        instead of the 8-byte hash.  floor(log2) on float64 is exact
        for uint32 inputs."""
        hi = np.asarray(vh_hi, np.uint32)
        lo = np.asarray(vh_lo, np.uint32)
        x = hi.astype(np.float64)
        clz = np.where(hi == 0, 32,
                       31 - np.floor(np.log2(np.maximum(x, 1.0))).astype(np.int64))
        rank = (clz + 1).astype(np.uint8)
        # uint16 covers precision <= 16; larger register files need the
        # full 32-bit index
        reg_dtype = np.uint16 if self.precision <= 16 else np.uint32
        reg = (lo & np.uint32(self.m - 1)).astype(reg_dtype)
        return rank, reg

    def update(self, state, slots, values, vh_hi, vh_lo, n):
        hll_update(state["regs"], slots, vh_hi, vh_lo, n)
        return state

    def result(self, state, slots):
        return hll_estimate(state["regs"], self.alpha, slots=slots)

    def result_dense(self, state):
        # gather-free fire for contiguous slot ranges: one dense pass
        # over the [S, m] rows at memory bandwidth
        return hll_estimate(state["regs"], self.alpha)
