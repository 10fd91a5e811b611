"""``merge_rows``: ``state[dst] (op)= state[src]`` over the rows of one
state component (kernel ``csrc/merge_rows.cu``).

Replaces ``flink_tpu/state/tpu_backend.py`` ``_jit_merge`` ->
``flink_tpu/ops/device_agg.py`` / ``flink_tpu/ops/sketches.py``
``merge_slots`` (a dst may repeat) and ``_jit_merge_rows`` ->
``device_agg.py`` ``merge_rows`` (``unique_dst=True``).
``merge_rows_plain`` is the same function in plain PyTorch.

Precondition of both: no src row is also a dst row in the same call
(the reference reads every src from the state as it was before the
call).  The plain version raises when it is broken; the kernel cannot
check it without a synchronisation and relies on the caller.

float32 min / max follow the reference's order (``float_order``): a NaN
wins and -0 < +0; with a unique dst, a row keeps its own bits unless the
src beats it.
"""

from __future__ import annotations

import math

import torch

from flink_tpu_torch.kernels import float_order, loader

OPS = {"add": 0, "min": 1, "max": 2}
_DTYPES = {torch.uint8: 0, torch.int32: 1, torch.float32: 2}


def merge_rows(comp: torch.Tensor, dst: torch.Tensor, src: torch.Tensor,
               op: str, unique_dst: bool = False) -> None:
    """In place: ``comp[dst[i]] = comp[dst[i]] (op) comp[src[i]]`` for
    every i; with ``unique_dst`` the caller promises no dst repeats."""
    if op not in OPS:
        raise ValueError(f"op must be one of {sorted(OPS)}, got {op!r}")
    if len(dst) != len(src):
        raise ValueError(f"{len(dst)} dst rows but {len(src)} src rows")
    if comp.device.type == "cpu":
        merge_rows_plain(comp, dst, src, op, unique_dst)
        return
    dev = comp.device
    loader.check(comp, "comp", tuple(_DTYPES), dev)
    if comp.dim() < 1:
        raise ValueError("state component must have a row axis")
    loader.check(dst, "dst", (torch.int32,), dev, ndim=1)
    loader.check(src, "src", (torch.int32,), dev, ndim=1)
    k = len(dst)
    if k == 0:
        return
    row_bytes = comp.element_size() * math.prod(comp.shape[1:])
    if row_bytes % 4:
        raise ValueError(f"rows of {row_bytes} bytes: the kernel merges "
                         "32-bit lanes")
    width = 16 if row_bytes % 16 == 0 and comp.data_ptr() % 16 == 0 else 4
    loader.launch("merge_rows", "ft_merge_rows", comp.data_ptr(),
                  dst.data_ptr(), src.data_ptr(), k, row_bytes,
                  comp.shape[0], _DTYPES[comp.dtype], OPS[op],
                  int(unique_dst), width)


def merge_rows_plain(comp: torch.Tensor, dst: torch.Tensor,
                     src: torch.Tensor, op: str,
                     unique_dst: bool = False) -> None:
    c = comp.shape[0]
    d = dst.to(torch.int64)
    s = src.to(torch.int64)
    keep = (d >= 0) & (d < c) & (s >= 0) & (s < c)
    d, s = d[keep], s[keep]
    if torch.isin(s, d).any():
        raise ValueError("merge_rows: a src row is also a dst row")
    if unique_dst and len(torch.unique(d)) != len(d):
        raise ValueError("merge_rows: unique_dst with a repeated dst row")
    if comp.dtype == torch.float32 and op != "add":
        # the reference's order (float_order): the same merge on keys
        old = float_order.keys(comp, op)
        new = old.clone()
        merge_rows_plain(new, dst, src, op, unique_dst)
        float_order.write_changed(comp.view(-1), old.view(-1), new.view(-1))
        return
    rows = comp[s]
    if unique_dst:
        cur = comp[d]
        if op == "add":
            comp[d] = cur + rows
        else:
            comp[d] = (torch.minimum if op == "min" else torch.maximum)(cur, rows)
        return
    idx = d.view(-1, *([1] * (comp.dim() - 1))).expand_as(rows)
    if op == "add":
        comp.scatter_add_(0, idx, rows)
    else:
        comp.scatter_reduce_(0, idx, rows, "amin" if op == "min" else "amax")
