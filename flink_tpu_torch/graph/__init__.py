"""Graph processing library, the Gelly analogue (port of
``flink_tpu/graph``).  A graph is columnar (vertex ids -> contiguous
indices, edges as src / dst / value columns) and one superstep is one
gather and one segment combine over every edge on the card: the
message passing that Gelly runs record by record through DataSet delta
iterations."""

from flink_tpu_torch.graph.graph import Edge, Graph, Vertex
from flink_tpu_torch.graph.iterations import (
    GatherSumApplyIteration,
    PregelIteration,
    ScatterGatherIteration,
)
from flink_tpu_torch.graph.library import (
    AdamicAdar,
    ClusteringCoefficient,
    CommunityDetection,
    ConnectedComponents,
    HITS,
    JaccardIndex,
    LabelPropagation,
    PageRank,
    SingleSourceShortestPaths,
    TriangleCount,
)

__all__ = [
    "Edge", "Graph", "Vertex",
    "ScatterGatherIteration", "GatherSumApplyIteration",
    "PregelIteration",
    "PageRank", "ConnectedComponents", "SingleSourceShortestPaths",
    "TriangleCount", "LabelPropagation", "CommunityDetection", "HITS",
    "JaccardIndex", "AdamicAdar", "ClusteringCoefficient",
]
