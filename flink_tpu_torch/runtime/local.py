"""Local executor: every vertex of a job at its parallelism, in this
process (port of ``flink_tpu/runtime/local.py:110-300, 466-760,
900-960, 1947-2003``).

Each JobVertex runs as N subtasks.  A keyed operator of subtask i owns
the key-group range ``compute_key_group_range_for_operator_index(
max_parallelism, N, i)`` and its own keyed-state backend from
``load_state_backend`` on the environment's ``state.backend`` and
device.  An edge wires every upstream subtask to every downstream one
(a pointwise partitioner to a contiguous group) through input channels;
each channel keeps its watermark, and an operator sees a watermark only
when the minimum over its input channels advances.

Records and RecordBatches flow by direct calls, cooperative and on one
thread: sources step in turn on one loop, a chain hands batches whole
from operator to operator, and the chain-tail router splits a batch by
key group (``split_batch``) into one sub-batch per channel.  A subtask
compiles its fused chain program (``chain_fusion.try_fuse_subtask``)
at the end of ``open()``, when its routes are wired; the chain head and
every chained output hand a batch to the program anchored on their
operator when it wants the batch.  End of input sends a final
``MAX_TIMESTAMP`` watermark so every window fires.  Every operator
gets the executor's processing-time clock, a manually advanced
``TestProcessingTimeService`` at 0 (the reference executor's default):
an evicting window over ``GlobalWindows`` reads "now" from it.
Checkpoints, failover, metrics, the wall-clock processing-time services
and the end-of-input drain of processing-time timers, threaded input
channels and the cluster executors are later slices.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Tuple

from flink_tpu_torch.core.keygroups import compute_key_group_range_for_operator_index
from flink_tpu_torch.device import DeviceLike
from flink_tpu_torch.state.loader import load_state_backend
from flink_tpu_torch.streaming.elements import (MAX_WATERMARK, MIN_TIMESTAMP,
                                                Watermark)
from flink_tpu_torch.streaming.graph import JobGraph, JobVertex
from flink_tpu_torch.streaming.operators import Output, StreamOperator
from flink_tpu_torch.streaming.sources import StreamSource
from flink_tpu_torch.streaming.timers import (ProcessingTimeService,
                                              TestProcessingTimeService)


class JobExecutionResult:
    def __init__(self, job_name: str):
        self.job_name = job_name
        self.accumulators: Dict[str, Any] = {}


class _InputChannel:
    """One input channel of a subtask: an upstream router pushes records,
    batches and watermarks into it, and the subtask takes each at once."""

    __slots__ = ("subtask", "input_index", "channel_id")

    def __init__(self, subtask: "SubtaskInstance", input_index: int,
                 channel_id: int):
        self.subtask = subtask
        self.input_index = input_index
        self.channel_id = channel_id

    def push(self, element) -> None:
        if element.is_record:
            self.subtask.process_record(self.input_index, element)
        elif element.is_watermark:
            self.subtask.process_channel_watermark(
                self.input_index, self.channel_id, element)
        else:
            self.subtask.process_batch_element(self.input_index, element)


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

    def collect_batch(self, batch):
        # a fused chain program anchored on the next operator takes the
        # whole run; otherwise the operator's kernel (or its boxing
        # fallback) decides
        op = self.op
        fused = op._fused_chain
        if fused is not None and fused.wants(batch):
            fused.run(batch)
            return
        op.process_batch(batch)

    def emit_watermark(self, watermark):
        self.op.process_watermark(watermark)

    def collect_side(self, tag, record):
        self.router.collect_side(tag, record)


class _RouterOutput(Output):
    """Chain-tail output: each out-edge's partitioner picks the
    channels of every record, a batch is split per channel whole
    (``split_batch``), and watermarks and end of stream go to every
    channel."""

    def __init__(self):
        #: (partitioner, [_InputChannel], side tag)
        self.routes: List[Tuple[Any, List[_InputChannel], Any]] = []

    def add_route(self, partitioner, channels, side_tag=None) -> None:
        partitioner.setup(len(channels))
        self.routes.append((partitioner, channels, side_tag))

    def collect(self, record):
        for partitioner, channels, side_tag in self.routes:
            if side_tag is not None:
                continue
            if len(channels) == 1:
                channels[0].push(record)
                continue
            for idx in partitioner.select_channels(record.value, len(channels)):
                channels[idx].push(record)

    def collect_batch(self, batch):
        if len(batch) == 0:
            return
        boxed = None
        for partitioner, channels, side_tag in self.routes:
            if side_tag is not None:
                continue
            if len(channels) == 1:
                channels[0].push(batch)
                continue
            split = partitioner.split_batch(batch, len(channels))
            if split is not None:
                for idx, sub in split:
                    channels[idx].push(sub)
                continue
            if boxed is None:
                boxed = batch.to_records()
            for record in boxed:
                for idx in partitioner.select_channels(record.value,
                                                       len(channels)):
                    channels[idx].push(record)

    def collect_side(self, tag, record):
        for partitioner, channels, side_tag in self.routes:
            if side_tag is not None and side_tag.tag_id == tag.tag_id:
                for idx in partitioner.select_channels(record.value,
                                                       len(channels)):
                    channels[idx].push(record)

    def emit_watermark(self, watermark):
        for _, channels, _ in self.routes:
            for ch in channels:
                ch.push(watermark)

    def broadcast_end_of_stream(self):
        for _, channels, _ in self.routes:
            for ch in channels:
                ch.subtask.on_end_of_stream()


class SubtaskInstance:
    """One parallel instance of a JobVertex: the chain's operators,
    wired head to tail, with the router behind the tail."""

    def __init__(self, vertex: JobVertex, state_backend=None,
                 device: DeviceLike = None, subtask_index: int = 0,
                 num_subtasks: int = 1, *,
                 processing_time_service: ProcessingTimeService):
        self.vertex = vertex
        self.subtask_index = subtask_index
        #: where device state and a fused chain program run
        self.device = device
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
            op.setup(out, keyed_backend=keyed,
                     processing_time_service=processing_time_service,
                     key_selector=node.key_selector,
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

    def new_channel(self, input_index: int) -> _InputChannel:
        ch = _InputChannel(self, input_index, self._channel_count)
        self._channel_count += 1
        self._watermarks.setdefault(input_index, {})[ch.channel_id] = MIN_TIMESTAMP
        return ch

    # ---- lifecycle --------------------------------------------------
    def open(self):
        for op in self.operators:
            op.open()
        # routes are wired before open(), so the compiler sees the
        # final channel fan-out
        from flink_tpu_torch.streaming.chain_fusion import try_fuse_subtask
        try_fuse_subtask(self)

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

    def process_batch_element(self, input_index: int, batch):
        """A RecordBatch through the head: its fused chain program when
        it wants the batch, else the operator's ``process_batch``."""
        head = self.head
        fused = head._fused_chain
        if fused is not None and fused.wants(batch):
            fused.run(batch)
        else:
            head.process_batch(batch)

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


def pointwise_targets(up_index: int, n_up: int, n_down: int) -> List[int]:
    """The downstream subtasks a pointwise edge wires upstream subtask
    ``up_index`` to: a contiguous group."""
    if n_down >= n_up:
        return list(range(up_index * n_down // n_up,
                          (up_index + 1) * n_down // n_up))
    return [up_index * n_down // n_up]


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
    """Runs a JobGraph in this process, each vertex at its parallelism.
    ``state_backend`` (a name or a Configuration) and ``device`` build
    the keyed operators' backends; every operator reads processing
    time from the executor's one ``TestProcessingTimeService``."""

    #: records a source emits per loop step before the next source runs
    SOURCE_BUDGET = 1024

    def __init__(self, state_backend=None, device: DeviceLike = None):
        self.state_backend = state_backend
        self.device = device
        self.pts = TestProcessingTimeService()

    def build_subtasks(self, job_graph: JobGraph
                       ) -> Dict[int, List[SubtaskInstance]]:
        """Every vertex's subtasks, and every edge's channels: all to
        all, or pointwise groups for a pointwise partitioner."""
        subtasks = {}
        for v in job_graph.topological_vertices():
            subtasks[v.id] = [
                SubtaskInstance(v, self.state_backend, self.device, i,
                                v.parallelism, processing_time_service=self.pts)
                for i in range(v.parallelism)]
        for e in job_graph.edges:
            ups = subtasks[e.source_vertex_id]
            downs = subtasks[e.target_vertex_id]
            for i, up in enumerate(ups):
                targets = ([downs[t] for t in
                            pointwise_targets(i, len(ups), len(downs))]
                           if e.partitioner.is_pointwise else downs)
                channels = [d.new_channel(e.type_number) for d in targets]
                up.router.add_route(copy.copy(e.partitioner), channels,
                                    e.side_output_tag)
        return subtasks

    def execute(self, job_graph: JobGraph) -> JobExecutionResult:
        result = JobExecutionResult(job_graph.job_name)
        subtasks = [st for group in self.build_subtasks(job_graph).values()
                    for st in group]
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
