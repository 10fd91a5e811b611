"""``knn_topk``: the k nearest training points of each query, from the
GEMM output and the squared norms (kernel ``csrc/knn_topk.cu``).

Replaces ``flink_tpu/ml/classification.py`` ``KNN.kneighbors.nearest``
(:96-102): ``d2 = (|q|^2 + |x|^2) - 2 Q X^T`` in that float32 order,
then the k smallest in the order of ``lax.top_k(-d2, k)``: the total
order of float32 (a NaN of negative sign first, -0 before +0, a NaN of
positive sign last), the lower index first on equal bits (a tie rule
``torch.topk`` does not promise).
``knn_topk_plain`` is the same function in plain PyTorch: a stable sort
of the same ``d2``'s order keys (``total_order_keys``), a block of query
rows at a time.
"""

from __future__ import annotations

import torch

from flink_tpu_torch.kernels import loader

#: the largest k the kernel takes
MAX_K = 64


def squared_distances(qx: torch.Tensor, qn: torch.Tensor,
                      xn: torch.Tensor) -> torch.Tensor:
    """``(qn[:, None] + xn[None, :]) - 2 qx``, the reference's order."""
    return (qn[:, None] + xn[None, :]) - 2.0 * qx


def knn_topk(qx: torch.Tensor, qn: torch.Tensor, xn: torch.Tensor,
             k: int) -> torch.Tensor:
    """int32 [m, k]: per query row of ``qx = Q X^T`` [m, n] (float32),
    with ``qn`` [m] and ``xn`` [n] the squared norms, the indices of the
    k smallest distances in the total order of float32, lower index
    first on equal bits."""
    if not 1 <= k <= qx.shape[1]:
        raise ValueError(f"k={k} for {qx.shape[1]} training points")
    if qx.device.type == "cpu":
        return knn_topk_plain(qx, qn, xn, k)
    dev = qx.device
    loader.check(qx, "qx", (torch.float32,), dev, ndim=2)
    loader.check(qn, "qn", (torch.float32,), dev, ndim=1)
    loader.check(xn, "xn", (torch.float32,), dev, ndim=1)
    m, n = qx.shape
    if len(qn) != m or len(xn) != n:
        raise ValueError(f"norms of {len(qn)} and {len(xn)} rows for a "
                         f"[{m}, {n}] product")
    if k > MAX_K:
        raise ValueError(f"knn_topk takes k <= {MAX_K}, got {k}")
    out = torch.empty((m, k), dtype=torch.int32, device=dev)
    if m:
        loader.launch("knn_topk", "ft_knn_topk", qx.data_ptr(), qn.data_ptr(),
                      xn.data_ptr(), m, n, k, out.data_ptr())
    return out


def total_order_keys(d: torch.Tensor) -> torch.Tensor:
    """int32 keys of float32 ``d`` whose signed order is the total order
    of float32: -NaN < -inf < ... < -0 < +0 < ... < +inf < +NaN."""
    b = d.view(torch.int32)
    return b ^ ((b >> 31) & 0x7FFFFFFF)


#: distances the plain version sorts at a time
_BLOCK_FLOATS = 1 << 28


def knn_topk_plain(qx: torch.Tensor, qn: torch.Tensor, xn: torch.Tensor,
                   k: int) -> torch.Tensor:
    rows = max(1, _BLOCK_FLOATS // max(1, qx.shape[1]))
    out = torch.empty((qx.shape[0], k), dtype=torch.int32, device=qx.device)
    for i in range(0, qx.shape[0], rows):
        d2 = squared_distances(qx[i:i + rows], qn[i:i + rows], xn)
        keys = total_order_keys(d2)
        out[i:i + rows] = torch.sort(keys, dim=1, stable=True).indices[:, :k]
    return out
