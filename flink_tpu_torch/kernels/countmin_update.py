"""``countmin_update``: Count-Min scatter-add (kernel
``csrc/countmin_update.cu``).

Replaces ``flink_tpu/ops/sketches.py`` ``CountMinSketchAggregate.update``
(through ``flink_tpu/streaming/vectorized.py`` ``make_masked_update``
and ``streaming/vectorized_sessions.py`` ``_jit_update``).
``countmin_update_plain`` is the same function in plain PyTorch.
"""

from __future__ import annotations

import torch

from flink_tpu_torch.kernels import loader
from flink_tpu_torch.ops.hashing import countmin_rows

_LANE = (torch.int32, torch.uint32)


def f32_to_i32_rz(values: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 toward zero, saturating, NaN -> 0: XLA's
    ``astype(int32)`` and the kernel's ``__float2int_rz``."""
    v = torch.nan_to_num(values.to(torch.float64), nan=0.0)
    return v.clamp(-2.0**31, 2.0**31 - 1).to(torch.int64).to(torch.int32)


def countmin_update(table: torch.Tensor, total: torch.Tensor,
                    slots: torch.Tensor, values: torch.Tensor,
                    hi: torch.Tensor, lo: torch.Tensor, n: int) -> None:
    """In place, for rows ``i < n`` and sketch rows ``r < d``:
    ``table[slots[i], r, (lo_i + r * hi_i) mod w] += int(values[i])``
    and ``total[slots[i]] += int(values[i])``.  ``hi``/``lo`` are the
    item hash's 32-bit lanes (``uint32`` or an ``int32`` view)."""
    if table.device.type == "cpu":
        countmin_update_plain(table, total, slots, values, hi, lo, n)
        return
    dev = table.device
    loader.check(table, "table", (torch.int32,), dev, ndim=3)
    loader.check(total, "total", (torch.int32,), dev, ndim=1)
    loader.check(slots, "slots", (torch.int32,), dev, ndim=1)
    loader.check(values, "values", (torch.float32,), dev, ndim=1)
    loader.check(hi, "hi", _LANE, dev, ndim=1)
    loader.check(lo, "lo", _LANE, dev, ndim=1)
    c, d, w = table.shape
    if total.shape[0] != c:
        raise ValueError(f"total has {total.shape[0]} rows, table {c}")
    if not 0 < w < 1 << 32:
        raise ValueError(f"width {w} outside [1, 2^32)")
    if not (0 <= n <= min(len(slots), len(values), len(hi), len(lo))):
        raise ValueError(f"n={n} exceeds the {len(slots)} rows given")
    if n == 0:
        return
    loader.launch("countmin_update", "ft_countmin_update", table.data_ptr(),
                  total.data_ptr(), slots.data_ptr(), values.data_ptr(),
                  hi.data_ptr(), lo.data_ptr(), n, d, w, c)


def countmin_update_plain(table: torch.Tensor, total: torch.Tensor,
                          slots: torch.Tensor, values: torch.Tensor,
                          hi: torch.Tensor, lo: torch.Tensor, n: int) -> None:
    c, d, w = table.shape
    s = slots[:n].to(torch.int64)
    wt = f32_to_i32_rz(values[:n])
    cols = countmin_rows(hi[:n], lo[:n], d, w).to(torch.int64)   # [d, n]
    keep = (s >= 0) & (s < c)
    s, wt, cols = s[keep], wt[keep], cols[:, keep]
    r = torch.arange(d, dtype=torch.int64, device=s.device)[:, None]
    idx = ((s[None, :] * d + r) * w + cols).reshape(-1)
    table.view(-1).index_add_(0, idx, wt.expand(d, -1).reshape(-1))
    total.index_add_(0, s, wt)
