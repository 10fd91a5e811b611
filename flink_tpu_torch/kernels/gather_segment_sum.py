"""``gather_segment_sum``: ``out[i] = sum of x[src[e]] over the edges e
with dst[e] == i``, through a plan built once per graph (kernel
``csrc/gather_segment_sum.cu``).

Replaces the segment sums of ``flink_tpu/graph/library.py`` PageRank
``step`` (:40-49) and HITS ``step`` (:243-255).  The edges are the same
in every superstep, so ``segment_plan(src, dst, n)`` lays them out once:
the edges stably sorted by ``dst`` (the segment), ``cols`` the gathered
index ``src`` in that order, ``indptr`` the segment bounds, and the
kernel's tile coordinates.  The plan is plain tensor code on whatever
device the edges lie on (a stable sort, a gather and two searchsorted),
a change of layout and not part of the kernel.  HITS's
hub step gathers the other way: ``segment_plan(dst, src, n)``.

``gather_segment_sum(x, plan)`` launches the kernel for a CUDA ``x``;
every row is summed in the plan's order, so two launches give the same
bits.  ``gather_segment_sum_plain(x, plan)`` is the same function in
plain PyTorch (``index_add_`` of ``x[cols]``; on the CPU it adds in the
plan's order, on the card with atomics).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from flink_tpu_torch.kernels import loader

#: merge-path items (row ends + edges) of a tile of the kernel (GS_TILE in
#: csrc/gather_segment_sum.cu); the plan holds each tile's start
TILE_ITEMS = 2048


class SegmentPlan(NamedTuple):
    """The edges of a graph grouped by segment, for ``gather_segment_sum``.

    ``indptr`` int32 [n + 1]: segment i's edges are ``cols[indptr[i]:
    indptr[i + 1]]``; ``cols`` int32 [e]: the gathered index of each edge,
    in segment order and, within a segment, in edge order; ``coords``
    int32 [tiles + 1, 2]: where each of the kernel's tiles starts on the
    merge path of row ends and edges (rows done, edges done), then
    ``(n, e)``; ``n`` the segments; ``gathered`` one past the largest
    gathered index (0 without edges)."""
    indptr: torch.Tensor
    cols: torch.Tensor
    coords: torch.Tensor
    n: int
    gathered: int

    @property
    def device(self) -> torch.device:
        return self.cols.device


def segment_plan(src: torch.Tensor, dst: torch.Tensor, n: int) -> SegmentPlan:
    """The plan of the sums ``out[i] = sum of x[src[e]] over dst[e] == i``
    (``src`` and ``dst`` integer [e] on one device, ``dst`` in
    ``[0, n)``)."""
    if src.dim() != 1 or src.shape != dst.shape:
        raise ValueError(f"src {tuple(src.shape)} and dst {tuple(dst.shape)} "
                         "must be one-dimensional and of one length")
    if src.device != dst.device:
        raise ValueError(f"src is on {src.device}, dst on {dst.device}")
    if src.is_floating_point() or dst.is_floating_point():
        raise TypeError("edge endpoints must be integers")
    e = src.numel()
    if n < 1 or n + e >= 2 ** 31:
        raise ValueError(f"{n} segments and {e} edges: the plan needs "
                         "n >= 1 and n + e < 2^31 (int32 indices)")
    dev = src.device
    gathered = 0
    if e:
        lo, hi, slo, shi = torch.stack([
            v.to(torch.int64) for v in (*torch.aminmax(dst), *torch.aminmax(src))
        ]).tolist()
        if lo < 0 or hi >= n:
            raise ValueError(f"segment indices span [{lo}, {hi}], outside "
                             f"[0, {n})")
        if slo < 0:
            raise ValueError("gathered indices must be >= 0")
        gathered = shi + 1
    keys, order = torch.sort(dst, stable=True)
    cols = src[order].to(torch.int32)
    indptr = torch.searchsorted(keys, torch.arange(n + 1, dtype=keys.dtype,
                                                   device=dev), out_int32=True)
    # row end i is merge-path item i + indptr[i + 1] (ties go to the row end)
    diag = torch.arange(0, n + e + TILE_ITEMS, TILE_ITEMS, dtype=torch.int64,
                        device=dev).clamp_(max=n + e)
    merged = torch.arange(n, dtype=torch.int64, device=dev) + indptr[1:]
    rows = torch.searchsorted(merged, diag)
    coords = torch.stack([rows, diag - rows], 1).to(torch.int32).contiguous()
    return SegmentPlan(indptr, cols, coords, n, gathered)


def _check_x(x: torch.Tensor, plan: SegmentPlan) -> None:
    if x.device != plan.device:
        raise ValueError(f"x is on {x.device}, the plan on {plan.device}")
    if x.dim() != 1 or x.numel() < plan.gathered:
        raise ValueError(f"x has shape {tuple(x.shape)}; the plan gathers "
                         f"{plan.gathered} values")


def gather_segment_sum(x: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """float32 [plan.n]: the sum of ``x[cols[k]]`` over each segment's
    edges, in the plan's order."""
    _check_x(x, plan)
    if x.device.type == "cpu":
        return gather_segment_sum_plain(x, plan)
    dev = x.device
    loader.check(x, "x", (torch.float32,), dev, ndim=1)
    for name in ("indptr", "cols", "coords"):
        loader.check(getattr(plan, name), name, (torch.int32,), dev)
    tiles = len(plan.coords) - 1
    out = torch.empty(plan.n, dtype=torch.float32, device=dev)
    scratch = torch.empty((4, tiles), dtype=torch.int32, device=dev)
    vals = scratch.view(torch.float32)
    loader.launch("gather_segment_sum", "ft_gather_segment_sum",
                  out.data_ptr(), x.data_ptr(), plan.indptr.data_ptr(),
                  plan.cols.data_ptr(), plan.coords.data_ptr(), plan.n, tiles,
                  scratch[0].data_ptr(), vals[1].data_ptr(),
                  scratch[2].data_ptr(), vals[3].data_ptr())
    return out


def gather_segment_sum_plain(x: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    _check_x(x, plan)
    seg = torch.repeat_interleave(
        torch.arange(plan.n, device=x.device),
        (plan.indptr[1:] - plan.indptr[:-1]).to(torch.int64))
    out = torch.zeros(plan.n, dtype=x.dtype, device=x.device)
    return out.index_add_(0, seg, x.index_select(0, plan.cols))
