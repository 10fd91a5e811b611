"""``merge_rows``: ``state[dst] (op)= state[src]`` over the rows of one
state component, and ``merge_rows_many`` over every component of a state
in one launch (kernel ``csrc/merge_rows.cu``).

Replaces ``flink_tpu/state/tpu_backend.py`` ``_jit_merge`` ->
``flink_tpu/ops/device_agg.py`` / ``flink_tpu/ops/sketches.py``
``merge_slots`` (a dst may repeat) and ``_jit_merge_rows`` ->
``device_agg.py`` ``merge_rows`` (``unique_dst=True``); the reference
jits one merge over the whole state dict, and ``merge_rows_many`` is
that one program.  ``merge_rows_plain`` is the same function in plain
PyTorch, ``merge_rows_many_plain`` the loop of it over the components.

Precondition of both: no src row is also a dst row in the same call
(the reference reads every src from the state as it was before the
call).  The plain version raises when it is broken; the kernel cannot
check it without a synchronisation and relies on the caller.

float32 min / max follow the reference's order (``float_order``): a NaN
wins and -0 < +0; with a unique dst, a row keeps its own bits unless the
src beats it.
"""

from __future__ import annotations

import struct
from typing import Sequence

import torch

from flink_tpu_torch.kernels import float_order, loader

OPS = {"add": 0, "min": 1, "max": 2}
_DTYPES = {torch.uint8: 0, torch.int32: 1, torch.float32: 2}
_INT32 = (torch.int32,)
#: components a launch takes (``MR_MAX_COMPONENTS`` in the kernel)
MAX_COMPONENTS = 8
#: packers of the argument array, by component count: dst, src, k,
#: unique_dst, then six values a component, as int64 (``ft_merge_rows``;
#: ctypes passes the bytes' buffer, faster to build than a ctypes array)
_PACK = tuple(struct.Struct(f"={4 + 6 * j}q").pack
              for j in range(MAX_COMPONENTS + 1))


def merge_rows(comp: torch.Tensor, dst: torch.Tensor, src: torch.Tensor,
               op: str, unique_dst: bool = False) -> None:
    """In place: ``comp[dst[i]] = comp[dst[i]] (op) comp[src[i]]`` for
    every i; with ``unique_dst`` the caller promises no dst repeats."""
    merge_rows_many((comp,), dst, src, (op,), unique_dst)


def merge_rows_many(comps: Sequence[torch.Tensor], dst: torch.Tensor,
                    src: torch.Tensor, ops: Sequence[str],
                    unique_dst: bool = False) -> None:
    """``merge_rows(comps[j], dst, src, ops[j], unique_dst)`` for every
    component j, in one launch: the components of one state, each with
    its own dtype, row width and op, all on one device."""
    n = len(comps)
    if n != len(ops) or not n:
        raise ValueError(f"{n} components but {len(ops)} ops")
    codes = [OPS.get(op) for op in ops]
    if None in codes:
        bad = ops[codes.index(None)]
        raise ValueError(f"op must be one of {sorted(OPS)}, got {bad!r}")
    first = comps[0]
    if first.is_cpu:
        if len(dst) != len(src):
            raise ValueError(f"{len(dst)} dst rows but {len(src)} src rows")
        merge_rows_many_plain(comps, dst, src, ops, unique_dst)
        return
    if n > MAX_COMPONENTS:
        raise ValueError(f"{n} components: a launch takes at most "
                         f"{MAX_COMPONENTS}")
    loader.check_all(first, (dst, "dst", _INT32, 1), (src, "src", _INT32, 1))
    k = dst.numel()
    if k != src.numel():
        raise ValueError(f"{k} dst rows but {src.numel()} src rows")
    if k == 0:
        return
    index = first.get_device()
    args = [dst.data_ptr(), src.data_ptr(), k, int(unique_dst)]
    for comp, code in zip(comps, codes):
        dtype = _DTYPES.get(comp.dtype)
        if (dtype is None or comp.get_device() != index
                or not comp.is_contiguous()):
            loader.check(comp, "comp", _DTYPES, first.device)   # raises
        if comp.ndim < 1:
            raise ValueError("state component must have a row axis")
        nbytes = comp.nbytes
        if not nbytes:
            continue
        rows = comp.shape[0]
        row_bytes = nbytes // rows
        if row_bytes % 4:
            raise ValueError(f"rows of {row_bytes} bytes: the kernel merges "
                             "32-bit lanes")
        base = comp.data_ptr()
        # 16-byte words only for plain stores: the atomics of a repeated
        # dst coalesce in 4-byte words (see the kernel's notes)
        width = 16 if unique_dst and not row_bytes % 16 and not base % 16 else 4
        args += (base, row_bytes, rows, dtype, code, width)
    m = (len(args) - 4) // 6
    if m:
        loader.launch("merge_rows", "ft_merge_rows", _PACK[m](*args), m)


def merge_rows_many_plain(comps: Sequence[torch.Tensor], dst: torch.Tensor,
                          src: torch.Tensor, ops: Sequence[str],
                          unique_dst: bool = False) -> None:
    for comp, op in zip(comps, ops):
        merge_rows_plain(comp, dst, src, op, unique_dst)


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
