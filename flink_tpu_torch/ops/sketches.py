"""Mergeable sketch aggregates (port of ``flink_tpu/ops/sketches.py``).

- ``HyperLogLogAggregate``: registers ``uint8 [slots, m]``; a batch
  update is one ``hll_update`` launch, a fire one ``hll_estimate``.
- ``CountMinSketchAggregate``: ``int32 [slots, d, w]`` counters and an
  ``int32 [slots]`` total; a batch update is one ``countmin_update``
  launch, a point query one ``countmin_query``; ``result`` is the
  total, a gather.
- ``QuantileSketchAggregate``: ``int32 [slots, B]`` log-bucket
  histograms; one ``quantile_update`` per batch, one
  ``quantile_result`` per fire tile.

A merge (``merge_slots`` / ``merge_rows``, each component by its
``combiners`` op: register-wise max, counter-wise add) is one
``merge_rows`` launch for all the components.  Registers, counters and
histograms come from exact integer arithmetic (the quantile bucket
from float32 steps as the reference takes them), so they are
bit-equal to the reference's apart from float32 ``log`` rounding at
bucket boundaries.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from flink_tpu_torch.kernels import (countmin_query, countmin_update,
                                     hll_estimate, hll_update,
                                     quantile_result, quantile_update)
from flink_tpu_torch.ops.device_agg import DeviceAggregateFunction, StateSpec
from flink_tpu_torch.ops.slot_index import torch_index


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


class CountMinSketchAggregate(DeviceAggregateFunction):
    """Count-Min sketch: approximate per-item frequencies.

    ``result`` is the per-slot total weight (exact L1 mass, a side
    counter); per-item estimates come from :meth:`point_query` (the
    heavy-hitter operator's read, ``streaming/heavy_hitters.py``).
    Guarantee: est <= true + eps * L1 with probability 1 - delta,
    eps = e / width, delta = e^-depth.  The value is both the weight
    (``int32`` toward zero) and, hashed, the item."""

    needs_value = True
    needs_value_hash = True
    combiners = {"table": "add", "total": "add"}

    def __init__(self, depth: int = 4, width: int = 2048):
        self.depth = depth
        self.width = width

    def state_specs(self) -> Dict[str, StateSpec]:
        return {"table": StateSpec((self.depth, self.width),
                                   np.dtype(np.int32), 0),
                "total": StateSpec((), np.dtype(np.int32), 0)}

    def update(self, state, slots, values, vh_hi, vh_lo, n):
        countmin_update(state["table"], state["total"], slots, values,
                        vh_hi, vh_lo, n)
        return state

    def result(self, state, slots):
        return state["total"][torch_index(slots, state["total"].shape[0])]

    def result_dense(self, state):
        return state["total"]

    def point_query(self, state, slots, qh_hi, qh_lo) -> torch.Tensor:
        """int32 estimate of item (qh_hi[i], qh_lo[i]) in slot slots[i]."""
        return countmin_query(state["table"], slots, qh_hi, qh_lo)


class QuantileSketchAggregate(DeviceAggregateFunction):
    """DDSketch-style log-bucketed quantile sketch (the t-digest role).

    A value v > min_value lands in bucket 1 + floor(log(v) / log(gamma))
    - offset, clamped to [1, buckets - 1]; v <= min_value in bucket 0.
    Quantile answers carry relative error <= (gamma - 1) / 2 within
    [min_value, max_value].  ``result`` is float32 ``[S, Q]``."""

    needs_value = True
    combiners = {"hist": "add"}

    def __init__(self, quantiles: Sequence[float] = (0.5, 0.99),
                 relative_accuracy: float = 0.01, min_value: float = 1e-9,
                 max_value: float = 1e9):
        self.quantiles = tuple(quantiles)
        self.gamma = (1 + relative_accuracy) / (1 - relative_accuracy)
        self.log_gamma = math.log(self.gamma)
        self.min_value = min_value
        self.offset = math.floor(math.log(min_value) / self.log_gamma)
        self.buckets = 2 + int(math.ceil(
            (math.log(max_value) - math.log(min_value)) / self.log_gamma))
        self._device_tables: Dict[torch.device,
                                  Tuple[torch.Tensor, torch.Tensor]] = {}

    def state_specs(self) -> Dict[str, StateSpec]:
        return {"hist": StateSpec((self.buckets,), np.dtype(np.int32), 0)}

    def bucket_values(self) -> np.ndarray:
        """float32 value of each bucket, the canonical DDSketch estimate
        exp((b + offset) * log gamma) * 2 / (1 + gamma) in the
        reference's float32 steps; bucket 0 is 0."""
        b = np.arange(self.buckets, dtype=np.float32)
        with np.errstate(over="ignore"):
            val = (np.exp((b + np.float32(self.offset))
                          * np.float32(self.log_gamma))
                   * np.float32(2.0 / (1.0 + self.gamma)))
        val[0] = 0.0
        return val

    def _tables(self, device: torch.device):
        """(quantiles, bucket values) as float32 tensors on ``device``,
        made once per device."""
        tables = self._device_tables.get(device)
        if tables is None:
            tables = (torch.tensor(np.float32(self.quantiles), device=device),
                      torch.from_numpy(self.bucket_values()).to(device))
            self._device_tables[device] = tables
        return tables

    def update(self, state, slots, values, vh_hi, vh_lo, n):
        quantile_update(state["hist"], slots, values, n, self.min_value,
                        self.log_gamma, self.offset)
        return state

    def result(self, state, slots):
        hist = state["hist"]
        return quantile_result(hist, *self._tables(hist.device), slots=slots)

    def result_dense(self, state):
        hist = state["hist"]
        return quantile_result(hist, *self._tables(hist.device))
