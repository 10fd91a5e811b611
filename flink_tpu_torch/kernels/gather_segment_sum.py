"""``gather_segment_sum``: ``out[dst[e]] += x[src[e]]`` over a graph's
edges (kernel ``csrc/gather_segment_sum.cu``).

Replaces the segment sums of ``flink_tpu/graph/library.py`` PageRank
``step`` (:40-49) and HITS ``step`` (:243-255).
``gather_segment_sum_plain`` is the same function in plain PyTorch.
"""

from __future__ import annotations

import torch

from flink_tpu_torch.kernels import loader


def gather_segment_sum(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                       n: int) -> torch.Tensor:
    """float32 [n]: the sum of ``x[src[e]]`` over the edges ``e`` with
    ``dst[e] == i``; endpoints are int32 and lie in range."""
    if x.device.type == "cpu":
        return gather_segment_sum_plain(x, src, dst, n)
    dev = x.device
    loader.check(x, "x", (torch.float32,), dev, ndim=1)
    loader.check(src, "src", (torch.int32,), dev, ndim=1)
    loader.check(dst, "dst", (torch.int32,), dev, ndim=1)
    if len(src) != len(dst):
        raise ValueError(f"src has {len(src)} edges, dst {len(dst)}")
    out = torch.zeros(n, dtype=torch.float32, device=dev)
    if len(src):
        loader.launch("gather_segment_sum", "ft_gather_segment_sum",
                      out.data_ptr(), x.data_ptr(), src.data_ptr(),
                      dst.data_ptr(), len(src))
    return out


def gather_segment_sum_plain(x: torch.Tensor, src: torch.Tensor,
                             dst: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros(n, dtype=x.dtype, device=x.device)
    return out.index_add_(0, dst, x.index_select(0, src))
