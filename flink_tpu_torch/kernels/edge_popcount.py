"""``edge_popcount``: common neighbours per vertex pair from a packed
adjacency bitset (kernel ``csrc/edge_popcount.cu``).

Replaces ``flink_tpu/graph/library.py`` ``_edge_common_neighbors``
``per_edge`` (:398-400).  ``edge_popcount_plain`` is the same function
in plain PyTorch, on the port's own ``popcount32``, a block of pairs at
a time (a whole-edge-list ``adj[u] & adj[v]`` would hold
``[pairs, words]`` words at once).

On the card a call runs on a ``PopcountPlan`` (``popcount_plan``): the
bitset is scanned once for each row's nonzero words, which a row with
at most ``words // DENSE_SHARE`` of them keeps as a list of (word index,
word) entries, and the pairs are sorted by their big row (the one with
more nonzero words).  The pair pass then reads only the small row's
list against the big row (see the kernel's notes).  ``scan_plain`` and
``edge_pairs_plain`` are the plan's scan and the pair pass in plain
PyTorch.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from flink_tpu_torch.kernels import loader
from flink_tpu_torch.ops.hashing import popcount32

#: a row with more than ``words // DENSE_SHARE`` nonzero words is dense:
#: read whole, not listed (its list would be at least half its bytes)
DENSE_SHARE = 4
_INT32 = (torch.int32,)


class PopcountPlan(NamedTuple):
    """A bitset's row lists and a pair list's order, built once a call."""
    counts: torch.Tensor      # int32 [n]: nonzero words of each row
    offsets: torch.Tensor     # int64 [n + 1]: each listed row's first entry
    entries: torch.Tensor     # int32 [offsets[n], 2]: (word index, word) of
    #                           the listed rows, row by row, in word order
    big: torch.Tensor         # int32 [p]: each pair's row with more nonzero
    #                           words (ties: v), ascending
    small: torch.Tensor       # int32 [p]: the pair's other row
    order: torch.Tensor       # int32 [p]: the pair's index in the caller's order
    dense_above: int          # rows with more nonzero words are not listed


def edge_popcount(adj: torch.Tensor, u: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """int32 [pairs]: ``sum_w popcount(adj[u[p], w] & adj[v[p], w])``.
    ``adj`` is the bitset [n, words] as int32 (the bits of uint32
    words), ``u`` / ``v`` int32 vertex indices in range."""
    if adj.device.type == "cpu":
        return edge_popcount_plain(adj, u, v)
    return edge_pairs(adj, popcount_plan(adj, u, v))


def edge_pairs(adj: torch.Tensor, plan: PopcountPlan) -> torch.Tensor:
    """The pair pass on ``plan`` (one launch): int32 [pairs] in the
    caller's order.  ``plan`` is ``popcount_plan`` of this ``adj``."""
    if adj.device.type == "cpu":
        return edge_pairs_plain(adj, plan)
    if plan.counts.device != adj.device or len(plan.counts) != adj.shape[0]:
        raise ValueError("the plan is not of this bitset")
    p = len(plan.big)
    out = torch.empty(p, dtype=torch.int32, device=adj.device)
    if p:
        loader.launch("edge_popcount", "ft_edge_popcount", adj.data_ptr(),
                      adj.shape[1], _vec(adj), plan.counts.data_ptr(),
                      plan.dense_above, plan.offsets.data_ptr(),
                      plan.entries.data_ptr(), plan.big.data_ptr(),
                      plan.small.data_ptr(), plan.order.data_ptr(), p,
                      out.data_ptr(), 0)
    return out


def popcount_plan(adj: torch.Tensor, u: torch.Tensor,
                  v: torch.Tensor) -> PopcountPlan:
    """The plan of ``edge_popcount(adj, u, v)``: on the card two
    launches (the scan, then the lists' fill) and tensor glue with one
    synchronisation (the lists' size, and ``u`` / ``v`` checked in
    range); on the CPU ``scan_plain``.  Raises for a pair index outside
    ``[0, n)``."""
    if adj.device.type != "cpu":
        loader.check_all(adj, (adj, "adj", _INT32, 2), (u, "u", _INT32, 1),
                         (v, "v", _INT32, 1))
    if len(u) != len(v):
        raise ValueError(f"u has {len(u)} pairs, v {len(v)}")
    n, words = adj.shape
    dense_above = words // DENSE_SHARE
    if adj.device.type == "cpu":
        counts, offsets, entries = scan_plain(adj, dense_above)
        if len(u):
            _check_range(torch.stack([u.min(), u.max(), v.min(), v.max()])
                         .tolist(), n)
    else:
        counts, offsets, entries = _scan(adj, dense_above, u, v)
    big, small, order = _pair_order(counts, u, v)
    return PopcountPlan(counts, offsets, entries, big, small, order,
                        dense_above)


def _vec(adj: torch.Tensor) -> int:
    """Words a chunk of the kernels' loads: 4 (16 bytes) where rows and
    base allow it, else 1."""
    return 4 if adj.shape[1] % 4 == 0 and adj.data_ptr() % 16 == 0 else 1


def _check_range(bounds, n: int) -> None:
    lo, hi = min(bounds[0], bounds[2]), max(bounds[1], bounds[3])
    if lo < 0 or hi >= n:
        raise ValueError(f"pair vertices span [{lo}, {hi}], outside the "
                         f"bitset's {n} rows")


def _scan(adj: torch.Tensor, dense_above: int, u: torch.Tensor,
          v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    dev = adj.device
    n, words = adj.shape
    vec = _vec(adj)
    mask_words = -(-(words // vec) // 32)
    counts = torch.empty(n, dtype=torch.int32, device=dev)
    masks = torch.empty(n * mask_words, dtype=torch.int32, device=dev)
    loader.launch("edge_popcount", "ft_edge_scan", adj.data_ptr(), n, words,
                  vec, counts.data_ptr(), masks.data_ptr(), mask_words)
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(torch.where(counts > dense_above, 0, counts), 0, out=offsets[1:])
    stats = [offsets[n]]
    if len(u):
        stats += [u.min(), u.max(), v.min(), v.max()]
    stats = torch.stack([s.to(torch.int64) for s in stats]).tolist()
    if len(u):
        _check_range(stats[1:], n)
    entries = torch.empty((stats[0], 2), dtype=torch.int32, device=dev)
    loader.launch("edge_popcount", "ft_edge_fill", adj.data_ptr(), n, words,
                  vec, counts.data_ptr(), dense_above, offsets.data_ptr(),
                  masks.data_ptr(), mask_words, entries.data_ptr())
    return counts, offsets, entries


def _pair_order(counts: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """(big, small, order): each pair's row with more nonzero words (ties:
    ``v``) and the other, sorted by big row (stable), and the sorted
    pairs' indices in the caller's order."""
    pick_u = counts.index_select(0, u) > counts.index_select(0, v)
    big, order = torch.sort(torch.where(pick_u, u, v), stable=True)
    small = torch.where(pick_u, v, u).index_select(0, order)
    return big, small, order.to(torch.int32)


def scan_plain(adj: torch.Tensor,
               dense_above: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plan's scan in plain PyTorch: (counts, offsets, entries)."""
    n = adj.shape[0]
    nonzero = adj != 0
    counts = nonzero.sum(1, dtype=torch.int32)
    listed = counts <= dense_above
    rows, idx = torch.nonzero(nonzero & listed[:, None], as_tuple=True)
    entries = torch.stack([idx.to(torch.int32), adj[rows, idx]], 1)
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=adj.device)
    offsets[1:] = torch.cumsum(torch.where(listed, counts, 0), 0)
    return counts, offsets, entries


def edge_pairs_plain(adj: torch.Tensor, plan: PopcountPlan) -> torch.Tensor:
    """The pair pass on ``plan`` in plain PyTorch: a listed small row's
    entries against the big row's words, a dense small row (its big row
    is dense too) against the whole big row; each count stored at the
    pair's index in the caller's order."""
    p = len(plan.big)
    big, small = plan.big.long(), plan.small.long()
    scnt = plan.counts.index_select(0, small)
    dense = scnt > plan.dense_above
    lens = torch.where(dense, 0, scnt).long()
    pair_of = torch.repeat_interleave(torch.arange(p, device=adj.device), lens)
    first = torch.cumsum(lens, 0) - lens
    pos = (plan.offsets.index_select(0, small)[pair_of]
           + torch.arange(len(pair_of), device=adj.device) - first[pair_of])
    ent = plan.entries[pos]
    hits = popcount32(ent[:, 1] & adj[big[pair_of], ent[:, 0].long()])
    counts = torch.zeros(p, dtype=torch.int32, device=adj.device)
    counts.index_add_(0, pair_of, hits.to(torch.int32))
    both = torch.nonzero(dense).flatten()
    counts[both] = edge_popcount_plain(adj, plan.big[both], plan.small[both])
    out = torch.empty(p, dtype=torch.int32, device=adj.device)
    out[plan.order.long()] = counts
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
