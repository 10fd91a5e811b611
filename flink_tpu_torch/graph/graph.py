"""Graph data model and transformation API (port of
``flink_tpu/graph/graph.py``; numpy only, no device).

The Graph API surface of Gelly's ``Graph.java`` (fromCollection,
mapVertices, mapEdges, subgraph, filterOnVertices / filterOnEdges,
in/out degrees, getUndirected, reverse, joinWithVertices, union,
addVertex / addEdge / removeVertex, run) over a columnar form:

- vertex ids map to contiguous indices (``_index``: id -> i);
- vertex values live in one numpy array (a Python list for
  non-numeric values);
- edges are three columns (src index, dst index, value), the form every
  superstep of ``flink_tpu_torch.graph.iterations`` consumes.

``from_dataset`` / ``as_vertex_dataset`` / ``as_edge_dataset`` only
call ``.collect()`` and ``env.from_collection`` on what they are given;
nothing here imports a batch API.
"""

from __future__ import annotations

from collections import namedtuple
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

Vertex = namedtuple("Vertex", ["id", "value"])
Edge = namedtuple("Edge", ["source", "target", "value"])


def _as_value_array(values: List[Any]):
    arr = np.asarray(values)
    if arr.dtype.kind in "iufb" and arr.ndim == 1:
        return arr
    return list(values)  # non-numeric vertex values stay a list


class Graph:
    """Immutable directed graph; transformations return new Graphs
    (ref: Graph.java — every op returns a new Graph over transformed
    DataSets)."""

    def __init__(self, vertex_ids: List[Any], vertex_values,
                 edge_src: np.ndarray, edge_dst: np.ndarray,
                 edge_values: np.ndarray):
        self.vertex_ids = list(vertex_ids)
        self._index: Dict[Any, int] = {v: i for i, v
                                       in enumerate(self.vertex_ids)}
        self.vertex_values = vertex_values
        self.edge_src = np.asarray(edge_src, np.int32)
        self.edge_dst = np.asarray(edge_dst, np.int32)
        self.edge_values = np.asarray(edge_values)

    # ---- construction (ref: Graph.fromCollection :292) --------------
    @staticmethod
    def from_collection(vertices: Optional[Iterable] = None,
                        edges: Iterable = ()) -> "Graph":
        """`vertices` = (id, value) pairs or None to infer ids from
        edges with value None; `edges` = (src, dst[, value]) tuples
        (missing value -> 1.0, NullValue analogue)."""
        edges = [tuple(e) for e in edges]
        norm = [(e[0], e[1], e[2] if len(e) > 2 else 1.0) for e in edges]
        if vertices is None:
            ids = []
            seen = set()
            for s, t, _ in norm:
                for v in (s, t):
                    if v not in seen:
                        seen.add(v)
                        ids.append(v)
            values: List[Any] = [None] * len(ids)
        else:
            pairs = [tuple(v) if isinstance(v, (tuple, list, Vertex))
                     else (v, None) for v in vertices]
            ids = [p[0] for p in pairs]
            values = [p[1] for p in pairs]
            # endpoints not in the vertex list are added with value
            # None (the reference's fromCollection(edges, initializer)
            # convenience, Graph.java:310)
            known = set(ids)
            for s, t, _ in norm:
                for v in (s, t):
                    if v not in known:
                        known.add(v)
                        ids.append(v)
                        values.append(None)
        index = {v: i for i, v in enumerate(ids)}
        src = np.fromiter((index[s] for s, _, _ in norm), np.int32,
                          count=len(norm))
        dst = np.fromiter((index[t] for _, t, _ in norm), np.int32,
                          count=len(norm))
        ev = np.asarray([v for _, _, v in norm])
        return Graph(ids, _as_value_array(values), src, dst, ev)

    @staticmethod
    def from_dataset(vertex_ds, edge_ds) -> "Graph":
        """Bridge from the batch API (ref: Graph.fromDataSet)."""
        return Graph.from_collection(vertex_ds.collect(),
                                     edge_ds.collect())

    # ---- basic accessors --------------------------------------------
    def number_of_vertices(self) -> int:
        return len(self.vertex_ids)

    def number_of_edges(self) -> int:
        return len(self.edge_src)

    def get_vertices(self) -> List[Vertex]:
        vals = self.vertex_values
        return [Vertex(vid, vals[i]) for i, vid
                in enumerate(self.vertex_ids)]

    def get_edges(self) -> List[Edge]:
        return [Edge(self.vertex_ids[s], self.vertex_ids[t], v)
                for s, t, v in zip(self.edge_src.tolist(),
                                   self.edge_dst.tolist(),
                                   self.edge_values.tolist())]

    def get_vertex_ids(self) -> List[Any]:
        return list(self.vertex_ids)

    def as_vertex_dataset(self, env):
        return env.from_collection(self.get_vertices())

    def as_edge_dataset(self, env):
        return env.from_collection(self.get_edges())

    # ---- degrees (ref: Graph.java:741-769) --------------------------
    def out_degrees(self) -> Dict[Any, int]:
        counts = np.bincount(self.edge_src,
                             minlength=len(self.vertex_ids))
        return {vid: int(counts[i]) for i, vid
                in enumerate(self.vertex_ids)}

    def in_degrees(self) -> Dict[Any, int]:
        counts = np.bincount(self.edge_dst,
                             minlength=len(self.vertex_ids))
        return {vid: int(counts[i]) for i, vid
                in enumerate(self.vertex_ids)}

    def get_degrees(self) -> Dict[Any, int]:
        ins, outs = self.in_degrees(), self.out_degrees()
        return {vid: ins[vid] + outs[vid] for vid in self.vertex_ids}

    # ---- transformations --------------------------------------------
    def map_vertices(self, fn: Callable[[Vertex], Any]) -> "Graph":
        vals = [fn(Vertex(vid, self.vertex_values[i]))
                for i, vid in enumerate(self.vertex_ids)]
        return Graph(self.vertex_ids, _as_value_array(vals),
                     self.edge_src, self.edge_dst, self.edge_values)

    def map_edges(self, fn: Callable[[Edge], Any]) -> "Graph":
        vals = [fn(e) for e in self.get_edges()]
        return Graph(self.vertex_ids, self.vertex_values,
                     self.edge_src, self.edge_dst, np.asarray(vals))

    def join_with_vertices(self, pairs: Iterable[Tuple[Any, Any]],
                           fn: Callable[[Any, Any], Any]) -> "Graph":
        """(ref: joinWithVertices :549) — pairs of (vertex_id, input);
        vertices without a match keep their value."""
        updates = dict(pairs)
        vals = [fn(self.vertex_values[i], updates[vid])
                if vid in updates else self.vertex_values[i]
                for i, vid in enumerate(self.vertex_ids)]
        return Graph(self.vertex_ids, _as_value_array(vals),
                     self.edge_src, self.edge_dst, self.edge_values)

    def subgraph(self, vertex_filter: Callable[[Vertex], bool],
                 edge_filter: Callable[[Edge], bool]) -> "Graph":
        """(ref: subgraph :624) — keep vertices passing the filter and
        edges passing the filter whose endpoints survive."""
        keep = [i for i, vid in enumerate(self.vertex_ids)
                if vertex_filter(Vertex(vid, self.vertex_values[i]))]
        keep_set = set(keep)
        ids = [self.vertex_ids[i] for i in keep]
        vals = [self.vertex_values[i] for i in keep]
        remap = {old: new for new, old in enumerate(keep)}
        es, ed, ev = [], [], []
        for s, t, v in zip(self.edge_src.tolist(), self.edge_dst.tolist(),
                           self.edge_values.tolist()):
            if s in keep_set and t in keep_set and edge_filter(
                    Edge(self.vertex_ids[s], self.vertex_ids[t], v)):
                es.append(remap[s])
                ed.append(remap[t])
                ev.append(v)
        return Graph(ids, _as_value_array(vals),
                     np.asarray(es, np.int32), np.asarray(ed, np.int32),
                     np.asarray(ev))

    def filter_on_vertices(self, fn) -> "Graph":
        return self.subgraph(fn, lambda e: True)

    def filter_on_edges(self, fn) -> "Graph":
        return self.subgraph(lambda v: True, fn)

    def reverse(self) -> "Graph":
        """(ref: reverse :797)"""
        return Graph(self.vertex_ids, self.vertex_values,
                     self.edge_dst, self.edge_src, self.edge_values)

    def get_undirected(self) -> "Graph":
        """(ref: getUndirected :776) — each edge plus its reverse."""
        return Graph(
            self.vertex_ids, self.vertex_values,
            np.concatenate([self.edge_src, self.edge_dst]),
            np.concatenate([self.edge_dst, self.edge_src]),
            np.concatenate([self.edge_values, self.edge_values]))

    def union(self, other: "Graph") -> "Graph":
        """(ref: union :1316) — vertex sets merge by id (other wins on
        value conflicts), edge lists concatenate."""
        ids = list(self.vertex_ids)
        vals = list(self.vertex_values)
        index = dict(self._index)
        for i, vid in enumerate(other.vertex_ids):
            if vid in index:
                vals[index[vid]] = other.vertex_values[i]
            else:
                index[vid] = len(ids)
                ids.append(vid)
                vals.append(other.vertex_values[i])
        def remap(g):
            m = np.fromiter((index[v] for v in g.vertex_ids), np.int64,
                            count=len(g.vertex_ids))
            return m[g.edge_src], m[g.edge_dst]
        s1, d1 = remap(self)
        s2, d2 = remap(other)
        return Graph(ids, _as_value_array(vals),
                     np.concatenate([s1, s2]).astype(np.int32),
                     np.concatenate([d1, d2]).astype(np.int32),
                     np.concatenate([self.edge_values,
                                     other.edge_values]))

    def add_vertex(self, vertex) -> "Graph":
        vid, val = vertex if isinstance(vertex, (tuple, Vertex)) \
            else (vertex, None)
        if vid in self._index:
            return self
        return Graph(self.vertex_ids + [vid],
                     _as_value_array(list(self.vertex_values) + [val]),
                     self.edge_src, self.edge_dst, self.edge_values)

    def add_edge(self, source, target, value=1.0) -> "Graph":
        g = self.add_vertex(source).add_vertex(target)
        return Graph(g.vertex_ids, g.vertex_values,
                     np.append(g.edge_src, g._index[source]).astype(np.int32),
                     np.append(g.edge_dst, g._index[target]).astype(np.int32),
                     np.append(g.edge_values, value))

    def remove_vertex(self, vertex_id) -> "Graph":
        return self.filter_on_vertices(lambda v: v.id != vertex_id)

    # ---- algorithms (ref: Graph.run :1795) --------------------------
    def run(self, algorithm):
        return algorithm.run(self)
