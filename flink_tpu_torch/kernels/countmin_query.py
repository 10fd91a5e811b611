"""``countmin_query``: Count-Min point queries (kernel
``csrc/countmin_query.cu``).

Replaces ``flink_tpu/ops/sketches.py``
``CountMinSketchAggregate.point_query`` (through
``flink_tpu/streaming/heavy_hitters.py`` ``_jit_point_query``).
``countmin_query_plain`` is the same function in plain PyTorch.  Slots
follow the reference's index rule (``ops.slot_index``): -1 reads the
last row, and a slot outside ``[-C, C)`` the nearest end.
"""

from __future__ import annotations

import torch

from flink_tpu_torch.kernels import loader
from flink_tpu_torch.ops.hashing import countmin_rows
from flink_tpu_torch.ops.slot_index import gather_rows

_I32 = (torch.int32,)
_LANE = (torch.int32, torch.uint32)


def countmin_query(table: torch.Tensor, slots: torch.Tensor,
                   hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """int32 ``[Q]``: ``min_r table[slots[i], r, (lo_i + r * hi_i) mod w]``
    (slots, hi and lo may be slices at any element offset)."""
    if table.device.type == "cpu":
        return countmin_query_plain(table, slots, hi, lo)
    loader.check_all(table, (table, "table", _I32, 3), (slots, "slots", _I32, 1),
                     (hi, "hi", _LANE, 1), (lo, "lo", _LANE, 1))
    q = slots.numel()
    if not hi.numel() == lo.numel() == q:
        raise ValueError(f"{q} slots but {hi.numel()} / {lo.numel()} hash lanes")
    c, d, w = table.shape
    if d < 1 or not 0 < w < 1 << 32 or (q and c < 1):
        raise ValueError(f"a [{c}, {d}, {w}] table takes no queries")
    out = torch.empty(q, dtype=torch.int32, device=table.device)
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
    s = gather_rows(slots, c)
    cols = countmin_rows(hi, lo, d, w).to(torch.int64)             # [d, Q]
    r = torch.arange(d, dtype=torch.int64, device=s.device)[:, None]
    return table[s[None, :].expand(d, -1), r, cols].amin(dim=0)
