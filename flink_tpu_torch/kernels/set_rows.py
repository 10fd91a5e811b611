"""``set_rows``: write host or device rows into the rows of one state
component named by a slot list (kernel ``csrc/set_rows.cu``).

Replaces ``flink_tpu/state/tpu_backend.py`` ``_jit_upload`` and the
``.at[idx].set`` of ``restore_columns`` / ``restore_entries``.
``set_rows_plain`` is the same function in plain PyTorch.
"""

from __future__ import annotations

import math

import torch

from flink_tpu_torch.kernels import loader


def set_rows(comp: torch.Tensor, slots: torch.Tensor,
             rows: torch.Tensor) -> None:
    """In place: ``comp[slots[i]] = rows[i]``.  ``rows`` has the
    component's dtype and row shape; rows on the host go through pinned
    staging to the device before the launch."""
    n = len(slots)
    if tuple(rows.shape) != (n, *comp.shape[1:]):
        raise ValueError(f"rows of shape {tuple(rows.shape)} for {n} slots "
                         f"of a component shaped {tuple(comp.shape)}")
    if comp.device.type == "cpu":
        set_rows_plain(comp, slots, rows)
        return
    dev = comp.device
    if not comp.is_contiguous() or comp.dim() < 1:
        raise ValueError("state component must be contiguous with a row axis")
    loader.check(slots, "slots", (torch.int32,), dev, ndim=1)
    if rows.device.type == "cpu":
        rows = rows.contiguous().pin_memory().to(dev, non_blocking=True)
    loader.check(rows, "rows", (comp.dtype,), dev)
    if n == 0:
        return
    row_bytes = comp.element_size() * math.prod(comp.shape[1:])
    width = next(w for w in (16, 8, 4, 1)
                 if row_bytes % w == 0 and comp.data_ptr() % w == 0
                 and rows.data_ptr() % w == 0)
    loader.launch("set_rows", "ft_set_rows", comp.data_ptr(),
                  slots.data_ptr(), rows.data_ptr(), n, row_bytes // width,
                  comp.shape[0], width)


def set_rows_plain(comp: torch.Tensor, slots: torch.Tensor,
                   rows: torch.Tensor) -> None:
    idx = slots.to(torch.int64)
    keep = (idx >= 0) & (idx < comp.shape[0])
    comp[idx[keep]] = rows.to(comp.device)[keep]
