"""The port's graph library (``flink_tpu_torch.graph``) against the JAX
package's (``flink_tpu.graph``) on the same numpy inputs, on the CPU
(``device="cpu"``: the kernels' plain versions).

Every case of ``tests/test_graph.py`` runs through both packages: the
reference case's own assertions hold for the port, and the two outputs
agree.  Then each device program of the reference (K12a-d) against its
port on its own.

Tolerances.  Min / max combines, integer labels, shortest paths over
integer weights and popcounts are exact.  Float32 sums are not: the
port's ``index_add_`` (on the card, float atomics) adds in another order
than XLA's ``segment_sum``.  Two float32 sums of the same ``t`` terms in
any two orders differ by at most ``2 t eps sum|terms|`` (first order in
eps = 2^-23); ``reorder_bound`` computes that, and each test says how
it carries through its iteration.
"""

import itertools
import math
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flink_tpu.graph as jg
import flink_tpu_torch.graph as tg
from flink_tpu.graph import library as jlib
from flink_tpu_torch import kernels as K
from flink_tpu_torch.graph import library as tlib
from flink_tpu_torch.graph.iterations import segment_combine

EPS = float(np.finfo(np.float32).eps)
CPU = "cpu"


def reorder_bound(terms, abs_sum):
    """Largest difference of two float32 sums of ``terms`` numbers whose
    magnitudes add up to ``abs_sum``, taken in any two orders."""
    return 2.0 * np.asarray(terms, np.float64) * EPS * np.asarray(abs_sum, np.float64)


def diamond(G):
    # 0 -> 1 -> 3, 0 -> 2 -> 3
    return G.Graph.from_collection(
        [(i, 0) for i in range(4)],
        [(0, 1), (0, 2), (1, 3), (2, 3)])


def random_graph(G, n=60, p=0.08, seed=5, weighted=False):
    rng = np.random.default_rng(seed)
    edges = []
    for u, v in itertools.permutations(range(n), 2):
        if rng.random() < p:
            w = float(rng.integers(1, 10)) if weighted else 1.0
            edges.append((u, v, w))
    return G.Graph.from_collection([(i, 0) for i in range(n)], edges)


def _random_graph(G, n=40, m=160, seed=4):
    rng = np.random.default_rng(seed)
    edges = {(int(a), int(b)) for a, b in zip(
        rng.integers(0, n, m), rng.integers(0, n, m)) if a != b}
    g = G.Graph.from_collection(
        vertices=[(i, 0) for i in range(n)],
        edges=[(s, t, 1.0) for s, t in sorted(edges)])
    return g, sorted(edges), n


def _brute_neighbors(edges, n):
    nbrs = {i: set() for i in range(n)}
    for s, t in edges:
        if s != t:
            nbrs[s].add(t)
            nbrs[t].add(s)
    return nbrs


# ---------------------------------------------------------------------
# the cases of tests/test_graph.py, through both packages
# ---------------------------------------------------------------------

def test_construction_and_degrees():
    for G in (jg, tg):
        g = diamond(G)
        assert g.number_of_vertices() == 4
        assert g.number_of_edges() == 4
        assert g.out_degrees() == {0: 2, 1: 1, 2: 1, 3: 0}
        assert g.in_degrees() == {0: 0, 1: 1, 2: 1, 3: 2}
        assert g.get_degrees() == {0: 2, 1: 2, 2: 2, 3: 2}


def test_vertices_inferred_from_edges():
    got = {}
    for G in (jg, tg):
        g = G.Graph.from_collection(None, [("a", "b"), ("b", "c")])
        assert set(g.get_vertex_ids()) == {"a", "b", "c"}
        assert g.get_edges()[0] == G.Edge("a", "b", 1.0)
        got[G] = (g.get_vertex_ids(), [tuple(e) for e in g.get_edges()])
    assert got[jg] == got[tg]


def test_map_and_join_and_filter():
    out = {}
    for G in (jg, tg):
        g = diamond(G).map_vertices(lambda v: v.id * 10)
        assert [v.value for v in g.get_vertices()] == [0, 10, 20, 30]
        g2 = g.join_with_vertices([(1, 5), (3, 7)], lambda val, new: val + new)
        assert [v.value for v in g2.get_vertices()] == [0, 15, 20, 37]
        sub = g.subgraph(lambda v: v.id != 2, lambda e: True)
        assert set(sub.get_vertex_ids()) == {0, 1, 3}
        assert sub.number_of_edges() == 2
        ge = g.map_edges(lambda e: 2.5)
        assert all(e.value == 2.5 for e in ge.get_edges())
        out[G] = [tuple(e) for e in sub.get_edges()]
    assert out[jg] == out[tg]


def test_reverse_undirected_union():
    out = {}
    for G in (jg, tg):
        g = diamond(G)
        assert g.reverse().in_degrees() == g.out_degrees()
        assert g.get_undirected().number_of_edges() == 8
        merged = g.union(G.Graph.from_collection([(4, 0)], [(3, 4)]))
        assert merged.number_of_vertices() == 5
        assert merged.number_of_edges() == 5
        out[G] = [tuple(e) for e in merged.get_edges()]
    assert out[jg] == out[tg]


def test_add_remove():
    for G in (jg, tg):
        g = diamond(G).add_edge(3, 4, 9.0)
        assert 4 in g.get_vertex_ids()
        assert g.number_of_edges() == 5
        g = g.remove_vertex(4)
        assert 4 not in g.get_vertex_ids()
        assert g.number_of_edges() == 4


def _pagerank_atol(g, ranks, damping):
    """Per step, the summed contributions of a vertex differ by at most
    reorder_bound(in-degree, its sum), plus a few ulps of the elementwise
    ops; each step shrinks an earlier difference by the damping, so over
    any number of steps the ranks differ by at most that over (1 - d)."""
    deg_in = np.bincount(g.edge_dst, minlength=g.number_of_vertices()).max()
    step = reorder_bound(deg_in, max(ranks)) + 8 * EPS * max(ranks)
    return float(step / (1.0 - damping))


def test_pagerank_matches_power_iteration():
    got = random_graph(tg).run(tg.PageRank(damping=0.85, max_iterations=200,
                                           tolerance=1e-12, device=CPU))
    g = random_graph(jg)
    want = g.run(jg.PageRank(damping=0.85, max_iterations=200, tolerance=1e-12))
    n = g.number_of_vertices()
    M = np.zeros((n, n))
    for e in g.get_edges():
        M[e.target, e.source] += 1.0
    out_deg = M.sum(axis=0)
    for j in range(n):
        M[:, j] = M[:, j] / out_deg[j] if out_deg[j] > 0 else 1.0 / n
    r = np.full(n, 1.0 / n)
    for _ in range(200):
        r = (1 - 0.85) / n + 0.85 * (M @ r)
    for i in range(n):
        assert abs(got[i] - r[i]) < 1e-5
    assert abs(sum(got.values()) - 1.0) < 1e-4
    atol = _pagerank_atol(g, want.values(), 0.85)
    assert max(abs(got[i] - want[i]) for i in range(n)) <= atol


def test_connected_components():
    got = {}
    for G, kw in ((jg, {}), (tg, {"device": CPU})):
        g = G.Graph.from_collection(
            [(i, 0) for i in range(7)],
            [(0, 1), (1, 2), (3, 4), (4, 5)])
        comps = g.run(G.ConnectedComponents(**kw))
        assert comps[0] == comps[1] == comps[2]
        assert comps[3] == comps[4] == comps[5]
        assert comps[0] != comps[3]
        assert comps[6] not in (comps[0], comps[3])
        got[G] = comps
    assert got[tg] == got[jg]


def test_sssp_matches_dijkstra():
    g = random_graph(tg, n=40, p=0.12, seed=9, weighted=True)
    dist = g.run(tg.SingleSourceShortestPaths(source=0, device=CPU))
    n = g.number_of_vertices()
    ref = np.full(n, np.inf)
    ref[0] = 0.0
    edges = [(e.source, e.target, e.value) for e in g.get_edges()]
    for _ in range(n):
        for u, v, w in edges:
            if ref[u] + w < ref[v]:
                ref[v] = ref[u] + w
    for i in range(n):
        assert dist[i] == pytest.approx(ref[i])
    # integer weights: float32 sums exact, min exact -> equal
    want = random_graph(jg, n=40, p=0.12, seed=9, weighted=True).run(
        jg.SingleSourceShortestPaths(source=0))
    assert dist == want


def test_triangle_count_matches_bruteforce():
    count = random_graph(tg, n=30, p=0.15, seed=3).run(tg.TriangleCount(device=CPU))
    g = random_graph(jg, n=30, p=0.15, seed=3)
    adj = {(min(e.source, e.target), max(e.source, e.target))
           for e in g.get_edges() if e.source != e.target}
    brute = sum(1 for a, b, c in itertools.combinations(range(30), 3)
                if (a, b) in adj and (b, c) in adj and (a, c) in adj)
    assert count == brute == g.run(jg.TriangleCount())


def test_label_propagation_converges_to_components():
    got = {}
    for G in (jg, tg):
        g = G.Graph.from_collection(
            [(i, 0) for i in range(6)],
            [(0, 1), (1, 2), (0, 2), (3, 4), (4, 5), (3, 5)])
        labels = g.run(G.LabelPropagation(max_iterations=30))
        assert labels[0] == labels[1] == labels[2]
        assert labels[3] == labels[4] == labels[5]
        assert labels[0] != labels[3]
        got[G] = labels
    assert got[tg] == got[jg]


def _hits_atol(g, iterations):
    """Per step each score is a sum over at most max-degree terms of
    scores <= 1, then an L2 normalisation: reorder_bound(max degree, 1)
    plus a few ulps for the norm and the division.  No contraction is
    assumed, so the bound grows with the steps taken."""
    deg = max(np.bincount(g.edge_dst).max(), np.bincount(g.edge_src).max())
    return float(iterations * (reorder_bound(deg, 1.0) + 8 * EPS))


def test_hits_star():
    got = {}
    for G, kw in ((jg, {}), (tg, {"device": CPU})):
        g = G.Graph.from_collection(None, [(0, i) for i in range(1, 5)])
        hubs, auths = g.run(G.HITS(**kw))
        assert hubs[0] == pytest.approx(1.0, abs=1e-4)
        for i in range(1, 5):
            assert auths[i] == pytest.approx(0.5, abs=1e-4)
            assert hubs[i] == pytest.approx(0.0, abs=1e-6)
        assert auths[0] == pytest.approx(0.0, abs=1e-6)
        got[G] = (hubs, auths)
    atol = _hits_atol(g, 50)
    for t, j in zip(got[tg], got[jg]):
        assert max(abs(t[v] - j[v]) for v in j) <= atol


def test_pregel_iteration_custom():
    """Vertex-centric max-value flood: every vertex converges to the
    global max over its reachable ancestors."""
    out = {}
    for G, mx, kw in ((jg, jnp.maximum, {}), (tg, torch.maximum, {"device": CPU})):
        g = G.Graph.from_collection(
            [(0, 7), (1, 3), (2, 9), (3, 1)],
            [(0, 1), (1, 3), (2, 3)])
        it = G.PregelIteration(
            message=lambda src_vals, ev: src_vals,
            combine="max",
            compute=lambda vals, combined, step: mx(vals, combined),
            max_iterations=10, **kw)
        out[G] = {v.id: int(v.value) for v in g.run(it).get_vertices()}
        assert out[G] == {0: 7, 1: 7, 2: 9, 3: 9}
    assert out[tg] == out[jg]


def test_jaccard_index_differential():
    got = {}
    for G in (jg, tg):
        g, edges, n = _random_graph(G)
        got[G] = G.JaccardIndex().run(g)
    nbrs = _brute_neighbors(edges, n)
    want = {(u, v): len(nbrs[u] & nbrs[v]) / len(nbrs[u] | nbrs[v])
            for u in range(n) for v in range(u + 1, n) if nbrs[u] & nbrs[v]}
    assert set(got[tg]) == set(want)
    for k in want:
        assert abs(got[tg][k] - want[k]) < 1e-12, k
    assert got[tg] == got[jg]


def test_adamic_adar_differential():
    got = {}
    for G in (jg, tg):
        g, edges, n = _random_graph(G, seed=5)
        got[G] = G.AdamicAdar().run(g)
    nbrs = _brute_neighbors(edges, n)
    want = {(u, v): sum(1.0 / math.log(len(nbrs[w])) for w in nbrs[u] & nbrs[v])
            for u in range(n) for v in range(u + 1, n) if nbrs[u] & nbrs[v]}
    assert set(got[tg]) == set(want)
    for k in want:
        assert abs(got[tg][k] - want[k]) < 1e-9, k
    assert got[tg] == got[jg]


def test_clustering_coefficient_differential():
    g, edges, n = _random_graph(tg, seed=6)
    local, avg, global_cc = tg.ClusteringCoefficient(device=CPU).run(g)
    nbrs = _brute_neighbors(edges, n)
    tri_total = 0
    for v in range(n):
        d = len(nbrs[v])
        links = sum(1 for a in nbrs[v] for b in nbrs[v] if a < b and b in nbrs[a])
        tri_total += links
        want = links / (d * (d - 1) / 2) if d >= 2 else 0.0
        assert abs(local[v] - want) < 1e-12, v
    assert abs(avg - sum(local.values()) / n) < 1e-12
    wedges = sum(len(nbrs[v]) * (len(nbrs[v]) - 1) / 2 for v in range(n))
    assert abs(global_cc - (tri_total / wedges if wedges else 0)) < 1e-12
    # integer counts: the float64 host arithmetic after them is the same
    assert (local, avg, global_cc) == jg.ClusteringCoefficient().run(
        _random_graph(jg, seed=6)[0])


def test_clustering_coefficient_triangle():
    got = {}
    for G, kw in ((jg, {}), (tg, {"device": CPU})):
        g = G.Graph.from_collection(
            vertices=[(i, 0) for i in range(4)],
            edges=[(0, 1, 1.0), (1, 2, 1.0), (2, 0, 1.0), (2, 3, 1.0)])
        local, avg, global_cc = G.ClusteringCoefficient(**kw).run(g)
        assert local[0] == 1.0 and local[1] == 1.0
        assert abs(local[2] - 1 / 3) < 1e-12 and local[3] == 0.0
        got[G] = (local, avg, global_cc)
    assert got[tg] == got[jg]


def test_community_detection_two_cliques():
    cliques = [(base + i, base + j, 1.0) for base in (0, 5)
               for i in range(5) for j in range(i + 1, 5)] + [(4, 5, 0.1)]
    got = {}
    for G in (jg, tg):
        g = G.Graph.from_collection(vertices=[(i, 0) for i in range(10)],
                                    edges=cliques)
        labels = G.CommunityDetection(max_iterations=30, delta=0.3).run(g)
        left = {labels[i] for i in range(5)}
        right = {labels[i] for i in range(5, 10)}
        assert len(left) == 1 and len(right) == 1
        assert left != right
        got[G] = labels
    assert got[tg] == got[jg]


# ---------------------------------------------------------------------
# K12a: the superstep of the iteration models (gather, message, combine
# by dst into the segment identity, apply, changed)
# ---------------------------------------------------------------------

_SEG = {"sum": "segment_sum", "min": "segment_min", "max": "segment_max"}


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("kind", ["sum", "min", "max"])
def test_segment_combine_matches_jax(kind, dtype):
    """Vertices 0, 5 and 99 get no message: both give the identity."""
    import jax
    rng = np.random.default_rng(1)
    n, e = 100, 5000
    dst = rng.integers(1, n - 1, e).astype(np.int32)
    dst[dst == 5] = 6
    msgs = rng.integers(-50, 50, e).astype(dtype)    # integers: sums exact
    want = np.array(getattr(jax.ops, _SEG[kind])(jnp.asarray(msgs),
                                                   jnp.asarray(dst), num_segments=n))
    got = segment_combine(kind, torch.from_numpy(msgs), torch.from_numpy(dst), n)
    assert got.dtype == torch.from_numpy(want).dtype
    np.testing.assert_array_equal(got.numpy(), want)


_CALLABLES = {
    # (gather / message, combine, apply / compute) in each package
    "flood_min_int": (lambda s, e: s, "min", "minimum"),
    "relax_float": (lambda s, e: s + e, "min", "minimum"),
    "sum_halves": (lambda s, e: s * 0.5, "sum", "keep_combined"),
    "max_plus_weight": (lambda s, e: s + 2, "max", "maximum"),
}


def _apply(lib, name):
    if name == "keep_combined":
        return lambda old, combined: combined
    return getattr(lib, name)


def _init(case, n):
    rng = np.random.default_rng(2)
    if case == "relax_float":
        init = np.full(n, np.inf, np.float32)
        init[0] = 0.0
        return init
    if case == "sum_halves":
        return rng.integers(0, 64, n).astype(np.float32)
    return rng.permutation(n).astype(np.int64)       # int64 -> int32 in both


@pytest.mark.parametrize("model", ["gsa", "scatter_gather", "pregel"])
@pytest.mark.parametrize("case", sorted(_CALLABLES))
def test_iteration_models_match_jax(case, model):
    """Integer-valued messages and weights: every combine is exact, so
    values and superstep counts agree exactly."""
    gather, combine, apply = _CALLABLES[case]
    g = random_graph(tg, n=50, p=0.06, seed=11, weighted=True)
    jgr = random_graph(jg, n=50, p=0.06, seed=11, weighted=True)
    init = _init(case, g.number_of_vertices())
    g = g.map_vertices(lambda v: init[v.id])
    jgr = jgr.map_vertices(lambda v: init[v.id])
    iters = 4 if case == "sum_halves" else 60
    if model == "pregel":
        t_it = tg.PregelIteration(gather, combine,
                                  lambda v, c, s: _apply(torch, apply)(v, c),
                                  max_iterations=iters, device=CPU)
        j_it = jg.PregelIteration(gather, combine,
                                  lambda v, c, s: _apply(jnp, apply)(v, c),
                                  max_iterations=iters)
    else:
        cls = "GatherSumApplyIteration" if model == "gsa" else "ScatterGatherIteration"
        t_it = getattr(tg, cls)(gather, combine, _apply(torch, apply),
                                max_iterations=iters, device=CPU)
        j_it = getattr(jg, cls)(gather, combine, _apply(jnp, apply),
                                max_iterations=iters)
    got = np.asarray(g.run(t_it).vertex_values)
    want = np.asarray(jgr.run(j_it).vertex_values)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("wide", ["int64", "float64"])
def test_wide_messages_narrow_as_jax(wide):
    """A callable that widens to 64 bits: JAX with x64 off keeps 32-bit
    values, and the port narrows messages and values the same way."""
    init = np.random.default_rng(3).permutation(50).astype(
        np.int32 if wide == "int64" else np.float32)
    t_it = tg.GatherSumApplyIteration(
        lambda s, e: s.to(getattr(torch, wide)) + 1, "min",
        lambda old, c: torch.minimum(old.to(getattr(torch, wide)), c),
        device=CPU)
    j_it = jg.GatherSumApplyIteration(
        lambda s, e: s.astype(getattr(jnp, wide)) + 1, "min",
        lambda old, c: jnp.minimum(old.astype(getattr(jnp, wide)), c))
    graphs = [G.Graph.from_collection([(i, init[i]) for i in range(50)],
                                      [(i, (3 * i + 1) % 50) for i in range(50)])
              for G in (tg, jg)]
    with warnings.catch_warnings():       # JAX: no 64-bit dtype with x64 off
        warnings.simplefilter("ignore", UserWarning)
        want = np.asarray(graphs[1].run(j_it).vertex_values)
    got = np.asarray(graphs[0].run(t_it).vertex_values)
    assert got.dtype == want.dtype and got.dtype.itemsize == 4
    np.testing.assert_array_equal(got, want)


def test_sssp_unreachable_vertex_stays_inf():
    """A vertex with no in-edge receives the min identity (+inf)."""
    edges = [(0, 1, 2.0), (1, 2, 3.0), (3, 0, 1.0)]
    got = tg.Graph.from_collection(None, edges).run(
        tg.SingleSourceShortestPaths(0, device=CPU))
    want = jg.Graph.from_collection(None, edges).run(jg.SingleSourceShortestPaths(0))
    assert got == want == {0: 0.0, 1: 2.0, 2: 5.0, 3: math.inf}


# ---------------------------------------------------------------------
# K12b, K12c: the PageRank and HITS steps (gather_segment_sum)
# ---------------------------------------------------------------------

def test_pagerank_step_segment_sum_matches_jax():
    """One step's ``segment_sum((ranks / deg)[src], dst)``: within
    reorder_bound(in-degree, sum of |terms|) per vertex."""
    import jax
    rng = np.random.default_rng(3)
    n, e = 2000, 40_000
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    ranks = rng.random(n).astype(np.float32)
    deg = np.maximum(np.bincount(src, minlength=n), 1).astype(np.float32)
    x = ranks / deg
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(x)[jnp.asarray(src)],
                                          jnp.asarray(dst), num_segments=n))
    plan = K.segment_plan(torch.from_numpy(src), torch.from_numpy(dst), n)
    got = K.gather_segment_sum(torch.from_numpy(x), plan).numpy()
    mag = np.zeros(n)
    np.add.at(mag, dst, np.abs(x[src]).astype(np.float64))
    assert np.all(np.abs(got.astype(np.float64) - want)
                  <= reorder_bound(np.bincount(dst, minlength=n), mag))


@pytest.mark.parametrize("side", ["authorities", "hubs"])
def test_hits_step_segment_sums_match_jax(side):
    """HITS's two segment sums through their plans: authorities
    ``segment_sum(hubs[src], dst)`` on the plan by dst, hubs
    ``segment_sum(auths[dst], src)`` on the plan by src; within
    reorder_bound(terms, sum of |terms|) per vertex."""
    import jax
    rng = np.random.default_rng(5)
    n, e = 1500, 30_000
    src = rng.integers(0, n, e).astype(np.int32)
    dst = np.minimum(rng.zipf(1.5, e) - 1, n - 1).astype(np.int32)
    if side == "hubs":
        src, dst = dst, src
    x = rng.random(n).astype(np.float32)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(x)[jnp.asarray(src)],
                                          jnp.asarray(dst), num_segments=n))
    plan = K.segment_plan(torch.from_numpy(src), torch.from_numpy(dst), n)
    got = K.gather_segment_sum(torch.from_numpy(x), plan).numpy()
    mag = np.zeros(n)
    np.add.at(mag, dst, np.abs(x[src]).astype(np.float64))
    assert np.all(np.abs(got.astype(np.float64) - want)
                  <= reorder_bound(np.bincount(dst, minlength=n), mag))


@pytest.mark.parametrize("seed", [0, 1])
def test_pagerank_matches_jax_on_a_larger_graph(seed):
    rng = np.random.default_rng(seed)
    n, e = 3000, 30_000
    edges = list(zip(rng.integers(0, n, e).tolist(), rng.integers(0, n, e).tolist()))
    vertices = [(i, 0) for i in range(n)]
    got = tg.Graph.from_collection(vertices, edges).run(tg.PageRank(device=CPU))
    g = jg.Graph.from_collection(vertices, edges)
    want = g.run(jg.PageRank())
    atol = _pagerank_atol(g, want.values(), 0.85)
    assert max(abs(got[v] - want[v]) for v in want) <= atol


def test_hits_matches_jax_on_a_larger_graph():
    rng = np.random.default_rng(4)
    n, e = 2000, 20_000
    edges = list(zip(rng.integers(0, n, e).tolist(), rng.integers(0, n, e).tolist()))
    hubs, auths = tg.Graph.from_collection(None, edges).run(tg.HITS(device=CPU))
    g = jg.Graph.from_collection(None, edges)
    jh, ja = g.run(jg.HITS())
    atol = _hits_atol(g, 50)
    assert max(abs(hubs[v] - jh[v]) for v in jh) <= atol
    assert max(abs(auths[v] - ja[v]) for v in ja) <= atol


# ---------------------------------------------------------------------
# K12d: common neighbours per edge (edge_popcount)
# ---------------------------------------------------------------------

@pytest.mark.parametrize("n,m", [(40, 160), (200, 3000), (333, 5000)])
def test_edge_common_neighbors_match_jax(n, m):
    rng = np.random.default_rng(n)
    edges = list(zip(rng.integers(0, n, m).tolist(), rng.integers(0, n, m).tolist()))
    tnp = tlib._NeighborPairs(tg.Graph.from_collection(None, edges))
    jnp_ = jlib._NeighborPairs(jg.Graph.from_collection(None, edges))
    got = tlib._edge_common_neighbors(tnp, CPU)
    want = jlib._edge_common_neighbors(jnp_)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_adjacency_bitset_equals_the_reference_bits():
    """The port builds the bitset on the device by adding distinct bits;
    its words are the reference's uint32 words."""
    rng = np.random.default_rng(5)
    n = 100
    pairs = np.unique(np.sort(rng.integers(0, n, (600, 2)), 1), axis=0)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    u, v = pairs[:, 0], pairs[:, 1]
    want = np.zeros((n, (n + 31) // 32), np.uint32)
    for s, t in ((u, v), (v, u)):
        np.bitwise_or.at(want, (s, t // 32), np.uint32(1) << (t % 32).astype(np.uint32))
    got = tlib.adjacency_bitset(n, torch.from_numpy(u.astype(np.int32)),
                                torch.from_numpy(v.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


# ---------------------------------------------------------------------
# device policy
# ---------------------------------------------------------------------

def test_device_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = diamond(tg)
    for algo in (tg.PageRank(), tg.HITS(), tg.ConnectedComponents(),
                 tg.SingleSourceShortestPaths(0), tg.TriangleCount(),
                 tg.ClusteringCoefficient(),
                 tg.GatherSumApplyIteration(lambda s, e: s, "min", torch.minimum),
                 tg.PregelIteration(lambda s, e: s, "max",
                                    lambda v, c, s: torch.maximum(v, c))):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            g.run(algo)
    # host-only algorithms take no device and run anywhere
    for cls in (tg.LabelPropagation, tg.CommunityDetection, tg.JaccardIndex,
                tg.AdamicAdar):
        with pytest.raises(TypeError):
            cls(device="cpu")
        g.run(cls())
