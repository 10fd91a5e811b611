"""``edge_popcount``: common neighbours per vertex pair from a packed
adjacency bitset (kernel ``csrc/edge_popcount.cu``).

Replaces ``flink_tpu/graph/library.py`` ``_edge_common_neighbors``
``per_edge`` (:398-400).  ``edge_popcount_plain`` is the same function
in plain PyTorch, on the port's own ``popcount32``, a block of pairs at
a time (a whole-edge-list ``adj[u] & adj[v]`` would hold
``[pairs, words]`` words at once).
"""

from __future__ import annotations

import torch

from flink_tpu_torch.kernels import loader
from flink_tpu_torch.ops.hashing import popcount32


def edge_popcount(adj: torch.Tensor, u: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """int32 [pairs]: ``sum_w popcount(adj[u[p], w] & adj[v[p], w])``.
    ``adj`` is the bitset [n, words] as int32 (the bits of uint32
    words), ``u`` / ``v`` int32 vertex indices in range."""
    if adj.device.type == "cpu":
        return edge_popcount_plain(adj, u, v)
    dev = adj.device
    loader.check(adj, "adj", (torch.int32,), dev, ndim=2)
    loader.check(u, "u", (torch.int32,), dev, ndim=1)
    loader.check(v, "v", (torch.int32,), dev, ndim=1)
    if len(u) != len(v):
        raise ValueError(f"u has {len(u)} pairs, v {len(v)}")
    out = torch.empty(len(u), dtype=torch.int32, device=dev)
    if len(u):
        loader.launch("edge_popcount", "ft_edge_popcount", adj.data_ptr(),
                      adj.shape[1], u.data_ptr(), v.data_ptr(), len(u),
                      out.data_ptr())
    return out


#: bitset words of pairs the plain version ANDs at a time
_BLOCK_WORDS = 1 << 27


def edge_popcount_plain(adj: torch.Tensor, u: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    rows = max(1, _BLOCK_WORDS // max(1, adj.shape[1]))
    out = torch.empty(len(u), dtype=torch.int32, device=adj.device)
    for i in range(0, len(u), rows):
        inter = adj.index_select(0, u[i:i + rows]) & adj.index_select(0, v[i:i + rows])
        out[i:i + rows] = popcount32(inter).sum(1, dtype=torch.int32)
    return out
