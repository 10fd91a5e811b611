"""``scatter_combine``: masked scatter-add/-min/-max of one value column
(kernel ``csrc/scatter_combine.cu``).

Replaces ``flink_tpu/streaming/vectorized.py`` ``make_masked_update``
-> ``flink_tpu/ops/device_agg.py`` Sum/Count/Min/Max/Avg ``.update``.
``scatter_combine_plain`` is the same function in plain PyTorch.

float32 min / max follow the reference's order (``float_order``): a NaN
wins and -0 < +0, whatever the row order; a NaN that a min stores is
0xFFFFFFFF, a max's 0x7FFFFFFF.
"""

from __future__ import annotations

from typing import Optional

import torch

from flink_tpu_torch.kernels import float_order, loader

OPS = {"add": 0, "min": 1, "max": 2}
_DTYPES = {torch.float32: 0, torch.int32: 1}


def scatter_combine(state: torch.Tensor, slots: torch.Tensor,
                    values: Optional[torch.Tensor], n: int, op: str) -> None:
    """In place: ``state[slots[i]] (op)= values[i]`` for rows ``i < n``;
    ``values=None`` combines 1 per row (a count)."""
    if op not in OPS:
        raise ValueError(f"op must be one of {sorted(OPS)}, got {op!r}")
    if state.device.type == "cpu":
        scatter_combine_plain(state, slots, values, n, op)
        return
    dev = state.device
    loader.check(state, "state", tuple(_DTYPES), dev, ndim=1)
    loader.check(slots, "slots", (torch.int32,), dev, ndim=1)
    if values is not None:
        loader.check(values, "values", (state.dtype,), dev, ndim=1)
    rows = len(slots) if values is None else min(len(slots), len(values))
    if not 0 <= n <= rows:
        raise ValueError(f"n={n} exceeds the {rows} rows given")
    if n == 0:
        return
    loader.launch("scatter_combine", "ft_scatter_combine", state.data_ptr(),
                  slots.data_ptr(), loader.ptr(values), n, state.shape[0],
                  _DTYPES[state.dtype], OPS[op])


def scatter_combine_plain(state: torch.Tensor, slots: torch.Tensor,
                          values: Optional[torch.Tensor], n: int,
                          op: str) -> None:
    idx = slots[:n].to(torch.int64)
    if values is None:
        vals = torch.ones(n, dtype=state.dtype, device=state.device)
    else:
        vals = values[:n].to(state.dtype)
    keep = (idx >= 0) & (idx < state.shape[0])
    idx, vals = idx[keep], vals[keep]
    reduce = "amin" if op == "min" else "amax"
    if op == "add":
        state.index_add_(0, idx, vals)
    elif state.dtype == torch.float32:
        old = float_order.keys(state, op)
        new = old.scatter_reduce(0, idx, float_order.keys(vals, op), reduce)
        float_order.write_changed(state, old, new)
    else:
        state.scatter_reduce_(0, idx, vals, reduce)
