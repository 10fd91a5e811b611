"""Graph algorithm library (port of ``flink_tpu/graph/library.py``;
Gelly's PageRank, ConnectedComponents, SingleSourceShortestPaths,
TriangleCount, LabelPropagation, CommunityDetection, HITS, JaccardIndex,
AdamicAdar and the clustering coefficients).

On the device: PageRank and HITS on the ``gather_segment_sum`` kernel,
ConnectedComponents and SingleSourceShortestPaths on the iteration
models (``scatter_combine``), TriangleCount and ClusteringCoefficient on
``edge_popcount``; each of these runs on ``cuda`` unless the caller
passes ``device="cpu"``.  LabelPropagation, CommunityDetection,
JaccardIndex and AdamicAdar are host numpy, as in the reference, and
take no device.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from flink_tpu_torch.device import DeviceLike, resolve_device
from flink_tpu_torch.graph.iterations import GatherSumApplyIteration, to_device
from flink_tpu_torch.kernels import (edge_popcount, gather_segment_sum,
                                     segment_plan)


class PageRank:
    """(ref: library/PageRank.java, beta damping, uniform teleport)
    One superstep = ``rank / out_degree`` gathered along the edges and
    summed per target (``gather_segment_sum`` on a plan of the edges by
    target, built once per run); dangling mass spreads uniformly; stops
    when the L1 change is below ``tolerance``."""

    def __init__(self, damping: float = 0.85, max_iterations: int = 100,
                 tolerance: float = 1e-9, device: DeviceLike = None):
        self.damping = damping
        self.max_iterations = max_iterations
        self.tolerance = tolerance
        self.device = device

    def run(self, graph) -> Dict[Any, float]:
        n = graph.number_of_vertices()
        if n == 0:
            return {}
        dev = resolve_device(self.device)
        out_deg = np.bincount(graph.edge_src, minlength=n).astype(np.float32)
        src = to_device(graph.edge_src, dev)
        dst = to_device(graph.edge_dst, dev)
        deg = to_device(np.maximum(out_deg, 1.0), dev)
        sinks = to_device((out_deg == 0).astype(np.float32), dev)
        plan = segment_plan(src, dst, n)
        d = self.damping
        ranks = torch.full((n,), 1.0 / n, dtype=torch.float32, device=dev)
        for _ in range(self.max_iterations):
            summed = gather_segment_sum(ranks / deg, plan)
            dangling = torch.sum(ranks * sinks)
            new = (1.0 - d) / n + d * (summed + dangling / n)
            delta = torch.sum(torch.abs(new - ranks))
            ranks = new
            if float(delta) < self.tolerance:
                break
        out = ranks.cpu().numpy()
        return {vid: float(out[i]) for i, vid
                in enumerate(graph.vertex_ids)}


class ConnectedComponents:
    """(ref: library/ConnectedComponents.java, min-id label propagation
    over the undirected graph)."""

    def __init__(self, max_iterations: int = 100, device: DeviceLike = None):
        self.max_iterations = max_iterations
        self.device = device

    def run(self, graph) -> Dict[Any, int]:
        und = graph.get_undirected()
        n = und.number_of_vertices()
        init = np.arange(n, dtype=np.int32)
        it = GatherSumApplyIteration(
            gather=lambda src_vals, ev: src_vals,
            combine="min",
            apply=torch.minimum,
            max_iterations=self.max_iterations, device=self.device)
        labels = it.run_arrays(init, und.edge_src, und.edge_dst,
                               und.edge_values)
        return {vid: int(labels[i]) for i, vid
                in enumerate(graph.vertex_ids)}


class SingleSourceShortestPaths:
    """(ref: library/SingleSourceShortestPaths.java, Bellman-Ford
    relaxation: every edge relaxes at once each superstep)."""

    def __init__(self, source, max_iterations: int = 100,
                 device: DeviceLike = None):
        self.source = source
        self.max_iterations = max_iterations
        self.device = device

    def run(self, graph) -> Dict[Any, float]:
        n = graph.number_of_vertices()
        init = np.full(n, np.inf, np.float32)
        init[graph._index[self.source]] = 0.0
        it = GatherSumApplyIteration(
            gather=lambda src_vals, ev: src_vals + ev.to(torch.float32),
            combine="min",
            apply=torch.minimum,
            max_iterations=self.max_iterations, device=self.device)
        dist = it.run_arrays(init, graph.edge_src, graph.edge_dst,
                             graph.edge_values)
        return {vid: float(dist[i]) for i, vid
                in enumerate(graph.vertex_ids)}


class TriangleCount:
    """(ref: library/TriangleEnumerator.java / gelly TriangleCount)
    Counts undirected triangles via the adjacency-intersection method
    on a dense bitset — the shared per-edge kernel of
    ClusteringCoefficient (each triangle is counted once per edge, so
    the global count is sum/3)."""

    def __init__(self, device: DeviceLike = None):
        self.device = device

    def run(self, graph) -> int:
        common = _edge_common_neighbors(_NeighborPairs(graph), self.device)
        return int(common.sum()) // 3 if common is not None else 0


class LabelPropagation:
    """(ref: library/LabelPropagation.java) — each vertex adopts the
    most frequent label among its neighbors; ties break toward the
    smaller label.  The per-vertex label mode is computed SPARSELY by
    sorted run-length counting over the edge list (O(E log E) work,
    O(E) memory) — a dense per-vertex histogram would be O(E·n)."""

    def __init__(self, max_iterations: int = 20):
        self.max_iterations = max_iterations

    def run(self, graph) -> Dict[Any, int]:
        und = graph.get_undirected()
        n = und.number_of_vertices()
        if n == 0:
            return {}
        labels = np.arange(n, dtype=np.int32)
        src = np.asarray(und.edge_src)
        dst = np.asarray(und.edge_dst)

        def step(labels):
            lab = labels[src]
            order = np.lexsort((lab, dst))
            d, l = dst[order], lab[order]
            boundary = np.ones(len(d), bool)
            boundary[1:] = (d[1:] != d[:-1]) | (l[1:] != l[:-1])
            starts = np.flatnonzero(boundary)
            counts = np.diff(np.append(starts, len(d)))
            gd, gl = d[starts], l[starts]
            # per dst: max count, ties -> smallest label (sort by
            # (dst, -count, label) and take the first row per dst)
            order2 = np.lexsort((gl, -counts, gd))
            gd2 = gd[order2]
            first = np.ones(len(gd2), bool)
            first[1:] = gd2[1:] != gd2[:-1]
            new = labels.copy()
            new[gd2[first]] = gl[order2][first]
            return new

        for _ in range(self.max_iterations):
            new = step(labels)
            if np.array_equal(new, labels):
                break
            labels = new
        return {vid: int(labels[i]) for i, vid
                in enumerate(graph.vertex_ids)}


class CommunityDetection:
    """(ref: library/CommunityDetection.java) — label propagation with
    HOP-ATTENUATED SCORES: a vertex adopts the incoming label with the
    highest summed (score x edge weight); the adopted score is the max
    contributing score minus delta, so labels weaken as they travel
    and communities stop growing at their natural boundary (the
    difference from plain LabelPropagation, whose majority rule floods
    the largest label everywhere on connected graphs)."""

    def __init__(self, max_iterations: int = 20, delta: float = 0.5):
        self.max_iterations = max_iterations
        self.delta = delta

    def run(self, graph) -> Dict[Any, int]:
        und = graph.get_undirected()
        n = und.number_of_vertices()
        if n == 0:
            return {}
        labels = np.arange(n, dtype=np.int64)
        scores = np.ones(n, np.float64)
        src = np.asarray(und.edge_src)
        dst = np.asarray(und.edge_dst)
        try:
            ew = np.asarray(und.edge_values, np.float64)
            if ew.shape != src.shape:
                raise ValueError
        except (TypeError, ValueError):
            ew = np.ones(len(src), np.float64)

        for _ in range(self.max_iterations):
            lab = labels[src]
            sc = scores[src] * ew
            # per (dst, label): summed score + max raw score
            order = np.lexsort((lab, dst))
            d, l, s = dst[order], lab[order], sc[order]
            raw = (scores[src])[order]
            boundary = np.ones(len(d), bool)
            boundary[1:] = (d[1:] != d[:-1]) | (l[1:] != l[:-1])
            starts = np.flatnonzero(boundary)
            sums = np.add.reduceat(s, starts) if len(starts) else s[:0]
            maxr = (np.maximum.reduceat(raw, starts)
                    if len(starts) else raw[:0])
            gd, gl = d[starts], l[starts]
            # winner per dst: max summed score, ties -> smaller label
            order2 = np.lexsort((gl, -sums, gd))
            gd2 = gd[order2]
            first = np.ones(len(gd2), bool)
            first[1:] = gd2[1:] != gd2[:-1]
            win_dst = gd2[first]
            win_lab = gl[order2][first]
            win_score = maxr[order2][first] - self.delta
            new_labels = labels.copy()
            new_scores = scores.copy()
            adopt = win_score > 0   # exhausted labels stop spreading
            new_labels[win_dst[adopt]] = win_lab[adopt]
            new_scores[win_dst[adopt]] = win_score[adopt]
            if np.array_equal(new_labels, labels):
                break
            labels, scores = new_labels, new_scores
        return {vid: int(labels[i]) for i, vid
                in enumerate(graph.vertex_ids)}


class HITS:
    """(ref: library/HITSAlgorithm.java) Hubs and authorities by power
    iteration with L2 normalisation: two ``gather_segment_sum`` launches
    a superstep (authorities from hubs along the edges, hubs from the new
    authorities against them), on two plans built once per run (edges
    by target and by source)."""

    def __init__(self, max_iterations: int = 50, tolerance: float = 1e-7,
                 device: DeviceLike = None):
        self.max_iterations = max_iterations
        self.tolerance = tolerance
        self.device = device

    def run(self, graph):
        n = graph.number_of_vertices()
        if n == 0:
            return {}, {}
        dev = resolve_device(self.device)
        src = to_device(graph.edge_src, dev)
        dst = to_device(graph.edge_dst, dev)
        by_dst, by_src = segment_plan(src, dst, n), segment_plan(dst, src, n)
        hubs = torch.ones(n, dtype=torch.float32, device=dev)
        auths = torch.ones(n, dtype=torch.float32, device=dev)
        for _ in range(self.max_iterations):
            new_auths = gather_segment_sum(hubs, by_dst)
            new_auths = new_auths / torch.clamp(
                torch.linalg.vector_norm(new_auths), min=1e-12)
            new_hubs = gather_segment_sum(new_auths, by_src)
            new_hubs = new_hubs / torch.clamp(
                torch.linalg.vector_norm(new_hubs), min=1e-12)
            delta = (torch.sum(torch.abs(new_hubs - hubs))
                     + torch.sum(torch.abs(new_auths - auths)))
            hubs, auths = new_hubs, new_auths
            if float(delta) < self.tolerance:
                break
        h, a = hubs.cpu().numpy(), auths.cpu().numpy()
        ids = graph.vertex_ids
        return ({vid: float(h[i]) for i, vid in enumerate(ids)},
                {vid: float(a[i]) for i, vid in enumerate(ids)})


class _NeighborPairs:
    """Shared machinery for similarity measures: canonical undirected
    adjacency (CSR + packed bitset) and the 2-hop pair expansion
    (every pair of neighbors of some vertex shares that vertex)."""

    def __init__(self, graph):
        und = graph.get_undirected()
        self.n = und.number_of_vertices()
        a = np.minimum(und.edge_src, und.edge_dst)
        b = np.maximum(und.edge_src, und.edge_dst)
        keep = a != b
        # the unique (a, b) rows in lexicographic order, found as unique
        # packed int64 keys (np.unique on rows sorts a structured view,
        # several times slower at millions of edges)
        packed = np.unique(a[keep].astype(np.int64) * max(self.n, 1) + b[keep])
        self.pairs = np.stack([packed // max(self.n, 1), packed % max(self.n, 1)],
                              1).astype(np.int32)
        self.deg = np.bincount(
            np.concatenate([self.pairs[:, 0], self.pairs[:, 1]]),
            minlength=self.n)
        # CSR built lazily: only the 2-hop pair expansion needs it
        # (TriangleCount / ClusteringCoefficient read just n + pairs)
        self._adj_flat = None
        self._indptr = None

    def _build_csr(self):
        if self._adj_flat is not None:
            return
        s = np.concatenate([self.pairs[:, 0], self.pairs[:, 1]])
        t = np.concatenate([self.pairs[:, 1], self.pairs[:, 0]])
        order = np.argsort(s, kind="stable")
        self._adj_flat = t[order]
        self._indptr = np.zeros(self.n + 1, np.int64)
        np.cumsum(self.deg, out=self._indptr[1:])

    @property
    def adj_flat(self):
        self._build_csr()
        return self._adj_flat

    @property
    def indptr(self):
        self._build_csr()
        return self._indptr

    def two_hop_pairs(self):
        """→ (pair_u, pair_v, via) — one row per (neighbor pair,
        shared vertex); canonical u < v."""
        us, vs, ws = [], [], []
        for w in range(self.n):
            lo, hi = self.indptr[w], self.indptr[w + 1]
            nbrs = np.sort(self.adj_flat[lo:hi])
            d = len(nbrs)
            if d < 2:
                continue
            iu, iv = np.triu_indices(d, k=1)
            us.append(nbrs[iu])
            vs.append(nbrs[iv])
            ws.append(np.full(len(iu), w, nbrs.dtype))
        if not us:
            z = np.zeros(0, np.int64)
            return z, z, z
        return (np.concatenate(us), np.concatenate(vs),
                np.concatenate(ws))


class JaccardIndex:
    """(ref: flink-gelly library/similarity/JaccardIndex.java) —
    for every 2-hop vertex pair, |N(u) ∩ N(v)| / |N(u) ∪ N(v)|
    over the undirected neighborhoods.  Pairs with no shared
    neighbor (score 0) are not emitted, as in the reference."""

    def run(self, graph) -> Dict[tuple, float]:
        np_ = _NeighborPairs(graph)
        u, v, _ = np_.two_hop_pairs()
        if not len(u):
            return {}
        packed = u.astype(np.int64) * np_.n + v
        upairs, shared = np.unique(packed, return_counts=True)
        pu = (upairs // np_.n).astype(np.int64)
        pv = (upairs % np_.n).astype(np.int64)
        union = np_.deg[pu] + np_.deg[pv] - shared
        ids = graph.vertex_ids
        return {(ids[a], ids[b]): float(s) / float(un)
                for a, b, s, un in zip(pu.tolist(), pv.tolist(),
                                       shared.tolist(), union.tolist())}


class AdamicAdar:
    """(ref: flink-gelly library/similarity/AdamicAdar.java) — the
    shared-neighbor score Σ_w 1/ln(deg(w)) per 2-hop pair; a shared
    neighbor with many connections says less than a rare one."""

    def run(self, graph) -> Dict[tuple, float]:
        np_ = _NeighborPairs(graph)
        u, v, w = np_.two_hop_pairs()
        if not len(u):
            return {}
        # degree-1 shared vertices cannot appear (they have no pair);
        # ln(deg) >= ln 2 > 0 for every emitted `via`
        weight = 1.0 / np.log(np_.deg[w].astype(np.float64))
        packed = u.astype(np.int64) * np_.n + v
        order = np.argsort(packed, kind="stable")
        sp = packed[order]
        boundary = np.ones(len(sp), bool)
        boundary[1:] = sp[1:] != sp[:-1]
        starts = np.flatnonzero(boundary)
        sums = np.add.reduceat(weight[order], starts)
        upairs = sp[starts]
        pu = (upairs // np_.n).astype(np.int64)
        pv = (upairs % np_.n).astype(np.int64)
        ids = graph.vertex_ids
        return {(ids[a], ids[b]): float(s)
                for a, b, s in zip(pu.tolist(), pv.tolist(),
                                   sums.tolist())}


def adjacency_bitset(n: int, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The undirected adjacency as a packed bitset, int32 [n, ceil(n/32)]
    holding the bits of the reference's uint32 words, built where ``u``
    and ``v`` lie.  Each canonical pair (u < v, unique) sets two
    distinct bits, so adding the bit values sets them (bit 31 adds as
    -2^31 and wraps to the same word)."""
    words = (n + 31) // 32
    adj = torch.zeros(n * words, dtype=torch.int32, device=u.device)
    for s, t in ((u, v), (v, u)):
        s, t = s.to(torch.int64), t.to(torch.int64)
        bits = torch.bitwise_left_shift(torch.ones_like(t), t % 32)
        adj.index_add_(0, s * words + t // 32,
                       torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
                       .to(torch.int32))
    return adj.view(n, words)


def _edge_common_neighbors(np_: "_NeighborPairs", device: DeviceLike = None):
    """|N(u) & N(v)| per canonical undirected edge, by the packed bitset
    and the ``edge_popcount`` kernel; shared by TriangleCount and
    ClusteringCoefficient.  Returns int32 numpy, or None for no edge."""
    n = np_.n
    if n == 0 or not len(np_.pairs):
        return None
    dev = resolve_device(device)
    u = to_device(np_.pairs[:, 0], dev)
    v = to_device(np_.pairs[:, 1], dev)
    return edge_popcount(adjacency_bitset(n, u, v), u, v).cpu().numpy()


class ClusteringCoefficient:
    """(ref: flink-gelly library/clustering/
    LocalClusteringCoefficient + GlobalClusteringCoefficient +
    AverageClusteringCoefficient) — per-vertex triangle density over
    the shared per-edge common-neighbor kernel."""

    def __init__(self, device: DeviceLike = None):
        self.device = device

    def run(self, graph):
        """→ (local: Dict[vertex, float], average: float,
        global_coefficient: float)."""
        np_ = _NeighborPairs(graph)
        n = np_.n
        ids = graph.vertex_ids
        common = _edge_common_neighbors(np_, self.device)
        if common is None:
            return ({vid: 0.0 for vid in ids}, 0.0, 0.0)
        u, v = np_.pairs[:, 0], np_.pairs[:, 1]
        # each triangle {a,b,c} reaches vertex a through its two
        # incident edges -> tri[a] accumulates 2x the triangle count
        tri2 = np.zeros(n, np.int64)
        np.add.at(tri2, u, common)
        np.add.at(tri2, v, common)
        triangles = tri2 / 2.0
        deg = np_.deg.astype(np.float64)
        wedges = deg * (deg - 1.0) / 2.0
        with np.errstate(divide="ignore", invalid="ignore"):
            local = np.where(wedges > 0, triangles / wedges, 0.0)
        total_triangles = float(common.sum()) / 3.0
        total_wedges = float(wedges.sum())
        global_cc = (3.0 * total_triangles / total_wedges
                     if total_wedges else 0.0)
        return ({vid: float(local[i]) for i, vid in enumerate(ids)},
                float(local.mean()), global_cc)
