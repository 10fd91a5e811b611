"""Failover strategies: full restart vs pipelined-region restart (port
of ``flink_tpu/runtime/failover.py``).

Rebuilds the reference's failover-strategy family
(flink-runtime/.../executiongraph/failover/FailoverStrategy.java,
RestartAllStrategy.java, RestartPipelinedRegionStrategy.java,
FailoverRegion.java, FailoverStrategyLoader.java — selected by
`jobmanager.execution.failover-strategy`):

- **full** — any task failure cancels and restarts the whole job from
  the latest checkpoint (the default, what all executors do);
- **region** — only the failed task's PIPELINED REGION restarts: the
  connected component of subtasks linked through result partitions.
  All-to-all edges fuse both vertex's whole subtask sets into one
  region; pointwise edges connect only the actually wired subtask
  pairs, so an embarrassingly parallel job (source_i → map_i →
  sink_i) has one region per slice and a single slice's failure does
  not disturb the others.

Region computation happens at SUBTASK granularity with a union-find
over the same pointwise/all-to-all wiring rules the executors use."""

from __future__ import annotations

from typing import Dict, FrozenSet, List, Set, Tuple

TaskKey = Tuple[int, int]  # (vertex_id, subtask_index)


class TaskFailureException(Exception):
    """A task failure attributed to its subtask — the
    `updateTaskExecutionState` payload that lets the failover strategy
    scope the restart (ref: Execution.fail → FailoverStrategy
    .onTaskFailure)."""

    def __init__(self, task_key: TaskKey, cause: BaseException):
        super().__init__(f"task {task_key} failed: {cause}")
        self.task_key = task_key
        self.cause = cause


class _UnionFind:
    def __init__(self):
        self.parent: Dict[TaskKey, TaskKey] = {}

    def find(self, x: TaskKey) -> TaskKey:
        self.parent.setdefault(x, x)
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[x] != root:  # path compression
            self.parent[x], x = root, self.parent[x]
        return root

    def union(self, a: TaskKey, b: TaskKey) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[ra] = rb


def pointwise_targets(up_index: int, n_up: int, n_down: int) -> List[int]:
    """The POINTWISE wiring rule shared with the executors
    (build_and_wire_subtasks / TaskExecutor._wire)."""
    if n_down >= n_up:
        return list(range(up_index * n_down // n_up,
                          (up_index + 1) * n_down // n_up))
    return [up_index * n_down // n_up]


def compute_pipelined_regions(job_graph) -> List[FrozenSet[TaskKey]]:
    """Connected components of the subtask graph (ref:
    FailoverRegion computation in RestartPipelinedRegionStrategy)."""
    uf = _UnionFind()
    for vid, vertex in job_graph.vertices.items():
        for i in range(vertex.parallelism):
            uf.find((vid, i))
    for edge in job_graph.edges:
        n_up = job_graph.vertices[edge.source_vertex_id].parallelism
        n_down = job_graph.vertices[edge.target_vertex_id].parallelism
        for i in range(n_up):
            if edge.partitioner.is_pointwise:
                targets = pointwise_targets(i, n_up, n_down)
            else:
                targets = range(n_down)
            for t in targets:
                uf.union((edge.source_vertex_id, i),
                         (edge.target_vertex_id, t))
    groups: Dict[TaskKey, Set[TaskKey]] = {}
    for key in list(uf.parent):
        groups.setdefault(uf.find(key), set()).add(key)
    return [frozenset(g) for g in groups.values()]


def build_region_index(regions: List[FrozenSet[TaskKey]]
                       ) -> Dict[TaskKey, FrozenSet[TaskKey]]:
    """TaskKey -> region map, built once per attempt so per-failure
    lookups are O(1) instead of a linear scan over every region (a
    10k-subtask embarrassingly parallel job has 10k regions)."""
    index: Dict[TaskKey, FrozenSet[TaskKey]] = {}
    for region in regions:
        for key in region:
            index[key] = region
    return index


def region_of(regions: List[FrozenSet[TaskKey]],
              task_key: TaskKey,
              index: Dict[TaskKey, FrozenSet[TaskKey]] = None
              ) -> FrozenSet[TaskKey]:
    if index is not None:
        region = index.get(task_key)
        if region is not None:
            return region
    else:
        for region in regions:
            if task_key in region:
                return region
    # unattributed failures scope to everything (full restart)
    return frozenset().union(*regions) if regions else frozenset()
