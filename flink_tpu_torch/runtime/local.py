"""Local executor for one chain at parallelism 1 (port of
``flink_tpu/runtime/local.py:110-200, 466-760, 1226-1400``).

Source → timestamps → keyed window → sink: sources step cooperatively
on one loop, records and watermarks flow by direct calls through each
chain and across vertex edges, every input keeps the per-channel
watermark valve (an operator sees a watermark only when the minimum
over its input channels advances), and end of input sends a final
``MAX_TIMESTAMP`` watermark so every window fires.  Every keyed
operator gets its own keyed-state backend from ``load_state_backend``
on the environment's ``state.backend`` and device; side outputs travel
on their own edges.  Checkpoints, failover, metrics, processing time
and the cluster executors are later slices.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from flink_tpu_torch.core.keygroups import compute_key_group_range_for_operator_index
from flink_tpu_torch.device import DeviceLike
from flink_tpu_torch.state.loader import load_state_backend
from flink_tpu_torch.streaming.elements import (MAX_WATERMARK, MIN_TIMESTAMP,
                                                Watermark)
from flink_tpu_torch.streaming.graph import JobGraph, JobVertex
from flink_tpu_torch.streaming.operators import Output, StreamOperator
from flink_tpu_torch.streaming.sources import StreamSource


class JobExecutionResult:
    def __init__(self, job_name: str):
        self.job_name = job_name
        self.accumulators: Dict[str, Any] = {}


class _ChainedOutput(Output):
    """Direct call into the next operator of the chain; side outputs
    leave through the chain's router."""

    __slots__ = ("op", "router")

    def __init__(self, op: StreamOperator, router: "_RouterOutput"):
        self.op = op
        self.router = router

    def collect(self, record):
        self.op.set_key_context(record)
        self.op.process_element(record)

    def emit_watermark(self, watermark):
        self.op.process_watermark(watermark)

    def collect_side(self, tag, record):
        self.router.collect_side(tag, record)


class _RouterOutput(Output):
    """Chain-tail output: each out-edge's partitioner picks the
    downstream channel of every record; watermarks and end of stream
    go to every channel."""

    def __init__(self):
        #: (partitioner, [(subtask, input_index, channel_id)], side tag)
        self.routes: List[Tuple[Any, List[Tuple["SubtaskInstance", int, int]],
                                Any]] = []

    def add_route(self, partitioner, targets, side_tag=None) -> None:
        self.routes.append((partitioner, targets, side_tag))

    def _send(self, record, tag) -> None:
        for partitioner, targets, side_tag in self.routes:
            if side_tag == tag:
                sub, inp, _ = targets[partitioner.select_channel(record, len(targets))]
                sub.process_record(inp, record)

    def collect(self, record):
        self._send(record, None)

    def collect_side(self, tag, record):
        self._send(record, tag)

    def emit_watermark(self, watermark):
        for _, targets, _ in self.routes:
            for sub, inp, ch in targets:
                sub.process_channel_watermark(inp, ch, watermark)

    def broadcast_end_of_stream(self):
        for _, targets, _ in self.routes:
            for sub, _, _ in targets:
                sub.on_end_of_stream()


class SubtaskInstance:
    """One parallel instance of a JobVertex: the chain's operators,
    wired head to tail, with the router behind the tail."""

    def __init__(self, vertex: JobVertex, state_backend=None,
                 device: DeviceLike = None, subtask_index: int = 0,
                 num_subtasks: int = 1):
        self.vertex = vertex
        self.operators: List[StreamOperator] = [
            node.operator_factory() for node in vertex.chain]
        self.router = _RouterOutput()
        for i, (node, op) in enumerate(zip(vertex.chain, self.operators)):
            out = (_ChainedOutput(self.operators[i + 1], self.router)
                   if i + 1 < len(self.operators) else self.router)
            keyed = None
            if node.key_selector is not None:
                keyed = load_state_backend(
                    state_backend, compute_key_group_range_for_operator_index(
                        node.max_parallelism, num_subtasks, subtask_index),
                    node.max_parallelism, device=device)
            op.setup(out, keyed_backend=keyed, key_selector=node.key_selector,
                     operator_id=node.uid, subtask_index=subtask_index,
                     num_subtasks=num_subtasks,
                     max_parallelism=node.max_parallelism)
        #: input_index -> {channel_id: watermark}
        self._watermarks: Dict[int, Dict[int, int]] = {}
        self._current_wm: Dict[int, int] = {}
        self._channel_count = 0
        self._eos_count = 0
        self.finished = False

    @property
    def head(self) -> StreamOperator:
        return self.operators[0]

    @property
    def is_source(self) -> bool:
        return isinstance(self.head, StreamSource)

    def new_channel(self, input_index: int) -> int:
        ch = self._channel_count
        self._channel_count += 1
        self._watermarks.setdefault(input_index, {})[ch] = MIN_TIMESTAMP
        return ch

    # ---- lifecycle --------------------------------------------------
    def open(self):
        for op in self.operators:
            op.open()

    def finish(self):
        for op in self.operators:
            op.finish()

    def close(self):
        for op in self.operators:
            op.close()

    # ---- source path ------------------------------------------------
    def source_step(self, max_records: int) -> bool:
        """Emit up to max_records; True while the source has more."""
        fn = self.head.user_function
        if hasattr(fn, "emit_step"):
            if not hasattr(self, "_ctx"):
                self._ctx = self.head.make_context()
            more = fn.emit_step(self._ctx, max_records)
        else:
            self.head.run()
            more = False
        if not more:
            self.finish_source()
        return more

    def finish_source(self):
        """End of input: event time to the end (the chain sees the final
        watermark), then end of stream downstream."""
        if self.finished:
            return
        self.head.output.emit_watermark(MAX_WATERMARK)
        self.finished = True
        self.finish()
        self.router.broadcast_end_of_stream()

    # ---- input path -------------------------------------------------
    def process_record(self, input_index: int, record):
        head = self.head
        head.set_key_context(record)
        head.process_element(record)

    def process_channel_watermark(self, input_index: int, channel_id: int,
                                  watermark: Watermark):
        """Per-channel min-combine of watermarks."""
        chans = self._watermarks[input_index]
        if watermark.timestamp <= chans[channel_id]:
            return
        chans[channel_id] = watermark.timestamp
        new_min = min(chans.values())
        if new_min <= self._current_wm.get(input_index, MIN_TIMESTAMP):
            return
        self._current_wm[input_index] = new_min
        self.head.process_watermark(Watermark(new_min))

    def on_end_of_stream(self):
        self._eos_count += 1
        if self._eos_count == self._channel_count and not self.finished:
            self.finished = True
            self.finish()
            self.router.broadcast_end_of_stream()


def gather_accumulators(all_tasks, into: Dict[str, Any]) -> None:
    """User-function accumulators into the job result; lists
    concatenate, numbers add (one contribution per function instance)."""
    seen = set()
    for st in all_tasks:
        for op in st.operators:
            fn = getattr(op, "user_function", None)
            get_accs = getattr(fn, "accumulators", None)
            if callable(get_accs) and id(fn) not in seen:
                seen.add(id(fn))
                for name, value in get_accs().items():
                    if name in into and isinstance(value, (list, int, float)):
                        into[name] = into[name] + value
                    else:
                        into[name] = value


class LocalExecutor:
    """Runs a JobGraph in this process, every vertex at parallelism 1.
    ``state_backend`` (a name or a Configuration) and ``device`` build
    the keyed operators' backends."""

    #: records a source emits per loop step before the next source runs
    SOURCE_BUDGET = 1024

    def __init__(self, state_backend=None, device: DeviceLike = None):
        self.state_backend = state_backend
        self.device = device

    def build_subtasks(self, job_graph: JobGraph) -> Dict[int, SubtaskInstance]:
        subtasks = {}
        for v in job_graph.topological_vertices():
            if v.parallelism != 1:
                raise NotImplementedError(
                    f"vertex {v.name!r} runs at parallelism {v.parallelism}; "
                    "the port's executor runs parallelism 1 (parallel "
                    "subtasks arrive with the mesh slice)")
            subtasks[v.id] = SubtaskInstance(v, self.state_backend,
                                             self.device)
        for e in job_graph.edges:
            dst = subtasks[e.target_vertex_id]
            ch = dst.new_channel(e.type_number)
            subtasks[e.source_vertex_id].router.add_route(
                e.partitioner, [(dst, e.type_number, ch)], e.side_output_tag)
        return subtasks

    def execute(self, job_graph: JobGraph) -> JobExecutionResult:
        result = JobExecutionResult(job_graph.job_name)
        subtasks = list(self.build_subtasks(job_graph).values())
        opened: List[SubtaskInstance] = []
        try:
            for st in reversed(subtasks):   # consumers before producers
                st.open()
                opened.append(st)
            active = [st for st in subtasks if st.is_source]
            while active:
                active = [st for st in active
                          if st.source_step(self.SOURCE_BUDGET)]
        finally:
            for st in opened:
                st.close()
        gather_accumulators(subtasks, result.accumulators)
        return result
