"""``edge_popcount``'s plan (``popcount_plan``) and the plain twin of its
pair pass (``edge_pairs_plain``) against the plain version and the
reference's ``_edge_common_neighbors`` (``flink_tpu/graph/library.py``),
on the same numpy graphs, on the CPU.

The plan is built on the CPU by ``scan_plain``, the twin of the card's
scan and fill; the card's plan is held equal to it by the GPU tests.
Popcounts are integers: every comparison is exact.
"""

import numpy as np
import pytest
import torch

import flink_tpu.graph as jg
import flink_tpu_torch.graph as tg
from flink_tpu.graph import library as jlib
from flink_tpu_torch import kernels as K
from flink_tpu_torch.graph import library as tlib
from flink_tpu_torch.kernels.edge_popcount import DENSE_SHARE


def _edges(case, rng):
    """(n, edges) of one test graph; every vertex 0 .. n - 1 exists."""
    if case == "hub":                       # vertex 7 next to 250 of 300
        n = 300
        edges = [(int(a), int(b)) for a, b in rng.integers(0, n, (600, 2))]
        edges += [(7, int(b)) for b in rng.choice(n, 250, replace=False)]
    elif case == "empty_rows":              # rows 100 .. 399 empty
        n = 400
        edges = [(int(a), int(b)) for a, b in rng.integers(0, 100, (500, 2))]
    elif case == "dense_row":               # 1,000 vertices: 32 words, 8 listed
        n = 1000
        edges = [(int(a), int(b)) for a, b in rng.integers(5, n, (1500, 2))]
        edges += [(3, 32 * w + 5) for w in range(9) if w != 0]      # 8 + its own
        edges += [(3, 1)]                                           # 9 words
        edges += [(4, 32 * w + 6) for w in range(8) if w != 0] + [(4, 2)]
    elif case == "n_not_32":                # 485 vertices: 16 words, the last partial
        n = 485
        edges = [(int(a), int(b)) for a, b in rng.integers(0, n, (3000, 2))]
        edges += [(484, int(b)) for b in rng.choice(n, 60, replace=False)]
    else:                                   # no_edges
        n, edges = 50, []
    return n, edges


def _graph(G, n, edges):
    return G.Graph.from_collection([(i, 0) for i in range(n)], edges)


def _check_plan(adj, u, v, plan):
    a = adj.numpy().view(np.uint32)
    words = a.shape[1]
    counts = (a != 0).sum(1)
    assert plan.dense_above == words // DENSE_SHARE
    np.testing.assert_array_equal(plan.counts.numpy(), counts)
    listed = counts <= plan.dense_above
    offsets = plan.offsets.numpy()
    np.testing.assert_array_equal(np.diff(offsets), np.where(listed, counts, 0))
    ent = plan.entries.numpy()
    for r in range(len(a)):
        mine = ent[offsets[r]:offsets[r + 1]]
        if listed[r]:
            idx = np.flatnonzero(a[r])
            np.testing.assert_array_equal(mine[:, 0], idx)
            np.testing.assert_array_equal(mine[:, 1].view(np.uint32), a[r, idx])
    # big row: more nonzero words, ties to v; sorted by big row, stably
    un, vn = u.numpy(), v.numpy()
    pick_u = counts[un] > counts[vn]
    big, small = np.where(pick_u, un, vn), np.where(pick_u, vn, un)
    order = plan.order.numpy()
    np.testing.assert_array_equal(np.sort(order), np.arange(len(un)))
    np.testing.assert_array_equal(order, np.argsort(big, kind="stable"))
    np.testing.assert_array_equal(plan.big.numpy(), big[order])
    np.testing.assert_array_equal(plan.small.numpy(), small[order])


@pytest.mark.parametrize("case", ["hub", "empty_rows", "dense_row", "n_not_32",
                                  "no_edges"])
def test_plan_and_pair_pass_match_plain_and_jax(case):
    rng = np.random.default_rng(61)
    n, edges = _edges(case, rng)
    tnp = tlib._NeighborPairs(_graph(tg, n, edges))
    want = jlib._edge_common_neighbors(jlib._NeighborPairs(_graph(jg, n, edges)))
    u = torch.from_numpy(np.ascontiguousarray(tnp.pairs[:, 0], np.int32))
    v = torch.from_numpy(np.ascontiguousarray(tnp.pairs[:, 1], np.int32))
    adj = tlib.adjacency_bitset(n, u, v)
    plan = K.popcount_plan(adj, u, v)
    _check_plan(adj, u, v, plan)
    counts = plan.counts.numpy()
    if case == "hub":
        assert counts[7] > plan.dense_above and (counts <= plan.dense_above).any()
    if case == "empty_rows":
        assert (counts[100:] == 0).all()
    if case == "dense_row":
        assert counts[3] == plan.dense_above + 1 and counts[4] == plan.dense_above
    got = K.edge_pairs_plain(adj, plan)
    assert got.dtype == torch.int32
    assert torch.equal(got, K.edge_popcount_plain(adj, u, v))
    if case == "no_edges":
        assert want is None and tlib._edge_common_neighbors(tnp, "cpu") is None
        assert len(got) == 0
    else:
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(tlib._edge_common_neighbors(tnp, "cpu"), want)


@pytest.mark.parametrize("case", ["hub", "dense_row"])
def test_pair_pass_takes_unsorted_repeated_and_self_pairs(case):
    """Pairs in any order, repeated, with u == v and swapped: the twin
    equals the plain version, and each pair's count lands at its own
    index."""
    rng = np.random.default_rng(62)
    n, edges = _edges(case, rng)
    tnp = tlib._NeighborPairs(_graph(tg, n, edges))
    pu, pv = tnp.pairs[:, 0], tnp.pairs[:, 1]
    adj = tlib.adjacency_bitset(n, torch.from_numpy(pu.astype(np.int32)),
                                torch.from_numpy(pv.astype(np.int32)))
    idx = rng.integers(0, len(pu), 3 * len(pu))
    u, v = pu[idx], pv[idx]
    v = np.where(rng.random(len(u)) < 0.1, u, v)
    swap = rng.random(len(u)) < 0.5
    u, v = np.where(swap, v, u), np.where(swap, u, v)
    u, v = (torch.from_numpy(x.astype(np.int32)) for x in (u, v))
    plan = K.popcount_plan(adj, u, v)
    _check_plan(adj, u, v, plan)
    assert torch.equal(K.edge_pairs_plain(adj, plan), K.edge_popcount_plain(adj, u, v))


def test_plan_refuses_pairs_out_of_range():
    adj = torch.zeros((10, 1), dtype=torch.int32)
    for bad in (10, -1):
        with pytest.raises(ValueError, match="outside"):
            K.popcount_plan(adj, torch.tensor([1, bad], dtype=torch.int32),
                            torch.tensor([2, 3], dtype=torch.int32))
