"""``countmin_query``: Count-Min point queries (kernel
``csrc/countmin_query.cu``).

Replaces ``flink_tpu/ops/sketches.py``
``CountMinSketchAggregate.point_query`` (through
``flink_tpu/streaming/heavy_hitters.py`` ``_jit_point_query``).
``countmin_query_plain`` is the same function in plain PyTorch.
"""

from __future__ import annotations

import torch

from flink_tpu_torch.kernels import loader
from flink_tpu_torch.ops.hashing import countmin_rows

_LANE = (torch.int32, torch.uint32)


def countmin_query(table: torch.Tensor, slots: torch.Tensor,
                   hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """int32 ``[Q]``: ``min_r table[slots[i], r, (lo_i + r * hi_i) mod w]``
    (slots clamped into the table, as XLA's gather clamps)."""
    if table.device.type == "cpu":
        return countmin_query_plain(table, slots, hi, lo)
    dev = table.device
    loader.check(table, "table", (torch.int32,), dev, ndim=3)
    loader.check(slots, "slots", (torch.int32,), dev, ndim=1)
    loader.check(hi, "hi", _LANE, dev, ndim=1)
    loader.check(lo, "lo", _LANE, dev, ndim=1)
    q = len(slots)
    if not (len(hi) == len(lo) == q):
        raise ValueError(f"{q} slots but {len(hi)} / {len(lo)} hash lanes")
    c, d, w = table.shape
    out = torch.empty(q, dtype=torch.int32, device=dev)
    if q:
        loader.launch("countmin_query", "ft_countmin_query", table.data_ptr(),
                      slots.data_ptr(), hi.data_ptr(), lo.data_ptr(), q, d, w,
                      c, out.data_ptr())
    return out


def countmin_query_plain(table: torch.Tensor, slots: torch.Tensor,
                         hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    c, d, w = table.shape
    if len(slots) == 0:
        return torch.empty(0, dtype=torch.int32, device=table.device)
    s = slots.to(torch.int64).clamp(0, c - 1)
    cols = countmin_rows(hi, lo, d, w).to(torch.int64)             # [d, Q]
    r = torch.arange(d, dtype=torch.int64, device=s.device)[:, None]
    return table[s[None, :].expand(d, -1), r, cols].amin(dim=0)
