"""StreamGraph → JobGraph translation with operator chaining (port of
``flink_tpu/streaming/graph.py:24-285``, without the chain reports).

A StreamNode carries an operator factory (a zero-arg callable returning
a fresh operator), so each subtask gets its own instance.  Chains grow
greedily from the sources across forward edges between nodes of equal
parallelism whose downstream node has one input and allows chaining, so
a node set to another parallelism than its neighbours heads a vertex
of its own.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, List, Optional

from flink_tpu_torch.streaming.partitioners import (ForwardPartitioner,
                                                    StreamPartitioner)


class StreamNode:
    def __init__(self, node_id: int, name: str,
                 operator_factory: Callable[[], Any], parallelism: int = 1,
                 max_parallelism: int = 128, is_source: bool = False,
                 key_selector=None, uid: str = None,
                 chaining_strategy: str = "always"):  # always | head | never
        self.id = node_id
        self.name = name
        self.operator_factory = operator_factory
        self.parallelism = parallelism
        self.max_parallelism = max_parallelism
        self.is_source = is_source
        self.key_selector = key_selector
        self.uid = uid or f"op-{node_id}-{name}"
        self.chaining_strategy = chaining_strategy

    def __repr__(self):
        return f"StreamNode({self.id}:{self.name} p={self.parallelism})"


class StreamEdge:
    def __init__(self, source_id: int, target_id: int,
                 partitioner: StreamPartitioner, type_number: int = 0,
                 side_output_tag=None):
        self.source_id = source_id
        self.target_id = target_id
        self.partitioner = partitioner
        #: which logical input of the target (0 = first/only)
        self.type_number = type_number
        #: set: the edge carries this side output, not the main stream
        self.side_output_tag = side_output_tag
        #: an iteration's back edge (``IterativeStream.close_with``):
        #: never chained, left out of the topological order, and
        #: carrying neither barriers nor end of stream
        self.is_feedback = False

    def __repr__(self):
        return (f"StreamEdge({self.source_id}->{self.target_id} "
                f"{self.partitioner!r} in{self.type_number})")


class StreamGraph:
    def __init__(self, job_name: str = "job"):
        self.job_name = job_name
        self.nodes: Dict[int, StreamNode] = {}
        self.edges: List[StreamEdge] = []
        self._id_counter = itertools.count(1)

    def new_node_id(self) -> int:
        return next(self._id_counter)

    def add_node(self, node: StreamNode) -> StreamNode:
        self.nodes[node.id] = node
        return node

    def add_edge(self, edge: StreamEdge) -> None:
        self.edges.append(edge)

    def in_edges(self, node_id: int) -> List[StreamEdge]:
        return [e for e in self.edges if e.target_id == node_id]

    def out_edges(self, node_id: int) -> List[StreamEdge]:
        return [e for e in self.edges if e.source_id == node_id]

    def sources(self) -> List[StreamNode]:
        return [n for n in self.nodes.values() if n.is_source]


class JobVertex:
    """One schedulable vertex: a chain of StreamNodes, head first."""

    def __init__(self, vertex_id: int, chain: List[StreamNode],
                 chain_edges: List[StreamEdge]):
        self.id = vertex_id
        self.chain = chain
        self.chain_edges = chain_edges
        self.name = " -> ".join(n.name for n in chain)

    @property
    def head(self) -> StreamNode:
        return self.chain[0]

    @property
    def parallelism(self) -> int:
        return self.head.parallelism

    @property
    def is_source(self) -> bool:
        return self.head.is_source

    def __repr__(self):
        return f"JobVertex({self.id}: {self.name} p={self.parallelism})"


class JobEdge:
    def __init__(self, source_vertex_id: int, target_vertex_id: int,
                 partitioner: StreamPartitioner, type_number: int = 0,
                 source_node_id: int = -1, side_output_tag=None,
                 is_feedback: bool = False):
        self.source_vertex_id = source_vertex_id
        self.target_vertex_id = target_vertex_id
        self.partitioner = partitioner
        self.type_number = type_number
        self.side_output_tag = side_output_tag
        #: which node inside the source chain emits this edge
        self.source_node_id = source_node_id
        self.is_feedback = is_feedback


class JobGraph:
    def __init__(self, job_name: str):
        self.job_name = job_name
        self.vertices: Dict[int, JobVertex] = {}
        self.edges: List[JobEdge] = []
        #: interval, mode and storage of checkpoints; None: none taken
        self.checkpoint_config: Optional[dict] = None
        #: a savepoint the first attempt restores from
        self.savepoint_restore_path: Optional[str] = None
        self.allow_non_restored_state = False

    def in_edges(self, vertex_id: int) -> List[JobEdge]:
        return [e for e in self.edges if e.target_vertex_id == vertex_id]

    def out_edges(self, vertex_id: int) -> List[JobEdge]:
        return [e for e in self.edges if e.source_vertex_id == vertex_id]

    def topological_vertices(self) -> List[JobVertex]:
        order: List[JobVertex] = []
        visited = set()

        def visit(vid: int):
            if vid in visited:
                return
            visited.add(vid)
            for e in self.in_edges(vid):
                if not e.is_feedback:   # a back edge would cycle
                    visit(e.source_vertex_id)
            order.append(self.vertices[vid])

        for vid in self.vertices:
            visit(vid)
        return order


def is_chainable(edge: StreamEdge, graph: StreamGraph) -> bool:
    """Forward partitioner, main stream, same parallelism, single
    input, chaining allowed on both ends."""
    up = graph.nodes[edge.source_id]
    down = graph.nodes[edge.target_id]
    return (isinstance(edge.partitioner, ForwardPartitioner)
            and edge.side_output_tag is None
            and not edge.is_feedback
            and up.parallelism == down.parallelism
            and len(graph.in_edges(down.id)) == 1
            and down.chaining_strategy == "always"
            and up.chaining_strategy != "never")


def create_job_graph(stream_graph: StreamGraph) -> JobGraph:
    """Greedy chain construction from the sources."""
    jg = JobGraph(stream_graph.job_name)
    node_to_vertex: Dict[int, int] = {}
    vertex_counter = itertools.count(1)

    def build_chain(head_id: int) -> int:
        if head_id in node_to_vertex:
            return node_to_vertex[head_id]
        chain = [stream_graph.nodes[head_id]]
        chain_edges: List[StreamEdge] = []
        cur = head_id
        while True:
            outs = stream_graph.out_edges(cur)
            if len(outs) != 1 or not is_chainable(outs[0], stream_graph):
                break
            chain_edges.append(outs[0])
            cur = outs[0].target_id
            chain.append(stream_graph.nodes[cur])
        vid = next(vertex_counter)
        jg.vertices[vid] = JobVertex(vid, chain, chain_edges)
        for n in chain:
            node_to_vertex[n.id] = vid
        return vid

    # heads = sources + any node with a non-chainable incoming edge
    heads = [n.id for n in stream_graph.sources()]
    heads += [e.target_id for e in stream_graph.edges
              if not is_chainable(e, stream_graph)]
    for h in heads:
        build_chain(h)
    for nid in stream_graph.nodes:
        if nid not in node_to_vertex:
            build_chain(nid)

    chained = {id(e) for v in jg.vertices.values() for e in v.chain_edges}
    for e in stream_graph.edges:
        if id(e) not in chained:
            jg.edges.append(JobEdge(
                node_to_vertex[e.source_id], node_to_vertex[e.target_id],
                e.partitioner, e.type_number, source_node_id=e.source_id,
                side_output_tag=e.side_output_tag, is_feedback=e.is_feedback))
    return jg
