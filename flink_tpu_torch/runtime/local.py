"""Local executor: every vertex of a job at its parallelism, in this
process, with checkpoints, restarts and savepoints (port of
``flink_tpu/runtime/local.py:110-1160, 1226-1947``).

Each JobVertex runs as N subtasks.  A keyed operator of subtask i owns
the key-group range ``compute_key_group_range_for_operator_index(
max_parallelism, N, i)`` and its own keyed-state backend from
``load_state_backend`` on the environment's ``state.backend`` and
device.  An edge wires every upstream subtask to every downstream one
(a pointwise partitioner to a contiguous group) through input channels;
each channel keeps its watermark, and an operator sees a watermark only
when the minimum over its input channels advances.

Elements flow by direct calls, cooperative and on one thread: sources
step in turn on one loop, a chain hands batches whole from operator to
operator, and the chain-tail router splits a batch by key group
(``split_batch``) into one sub-batch per channel.  A subtask compiles
its fused chain program (``chain_fusion.try_fuse_subtask``) at the end
of ``open()``, when its routes are wired.  End of input sends a final
``MAX_TIMESTAMP`` watermark and then ``END_OF_STREAM`` down every
channel.

Processing time: every operator reads the executor's one
``ProcessingTimeService`` (the environment's, else a
``TestProcessingTimeService`` at 0).  A polled service fires its due
timers once per loop turn, on this thread; at the end of input the
test service fires every pending timer until nothing moves, so a
finite job's processing-time windows emit their tails, and then every
operator's ``finish`` runs, in topological order.

Checkpoints (``enable_checkpointing``): the ``CheckpointCoordinator``
marks the sources between steps; each source snapshots its chain,
sends a ``CheckpointBarrier`` down every channel and acks.  In
``exactly_once`` mode a subtask with several input channels holds what
a channel delivers after its barrier in that channel's buffer until
every live channel's barrier is in, snapshots, forwards the barrier and
then replays the buffers; ``at_least_once`` only counts barriers.  A
completed checkpoint is persisted, and ``notify_checkpoint_complete``
reaches every operator.  A failure restarts the job under the restart
strategy from the latest completed checkpoint (or, first, from
``set_savepoint_restore``); a changed parallelism re-splits the state
(``compute_restore_assignments``).  With ``set_failover_strategy(
"region")`` only the failed subtask's pipelined region restores, the
others carry their live state across.  ``execute_async`` runs the job
on a thread of its own and returns a ``JobClient`` (cancel, savepoints).

Metrics (``runtime/metrics.py``): the executor's ``MetricRegistry``
holds, per job, the reference's scopes: ``<job>.<vid>_<vertex>.<i>``
with ``numRecordsIn`` / ``numRecordsOut`` and the time-attribution
gauges, the operators' groups below it, ``latency`` histograms fed by
the ``LatencyMarker`` every source emits each
``latency_interval_ms``, and the process-wide ``state``, ``device``,
``profiler``, ``native``, ``jit``, ``cuda`` and ``tracing`` groups.
With ``sample_interval_ms`` a ``MetricsJournal`` samples the registry
once per loop turn when due and a ``HealthEvaluator`` runs its rules on
each sample.  While the tracer is on, each record or batch a subtask
takes runs in an ``op.<vertex>.process`` span and barriers leave
``checkpoint.barrier`` spans and ``checkpoint.align.begin`` instants.

Records route by direct calls here, so no router ever lacks capacity:
the backpressure gauges and the backpressured share of the time
attribution read 0 until threaded channels exist.  Alignment spill and
its abort cap, sources on threads of their own and the cluster
executors are later slices.
"""

from __future__ import annotations

import copy
import random
import threading
import time as _time
from collections import deque
from typing import Any, Dict, List, Optional, Set, Tuple

from flink_tpu_torch.core.keygroups import compute_key_group_range_for_operator_index
from flink_tpu_torch.device import DeviceLike
from flink_tpu_torch.runtime import faults
from flink_tpu_torch.runtime.backpressure import (TimeAccounting,
                                                  derive_upstreams,
                                                  locate_bottleneck,
                                                  observe_subtask,
                                                  read_vertex_stats,
                                                  register_backpressure_gauges,
                                                  register_time_attribution_gauges)
from flink_tpu_torch.runtime.checkpoints import (CheckpointCoordinator,
                                                 load_savepoint,
                                                 make_checkpoint_storage,
                                                 make_restart_strategy)
from flink_tpu_torch.runtime.failover import (TaskFailureException,
                                              build_region_index,
                                              compute_pipelined_regions,
                                              pointwise_targets, region_of)
from flink_tpu_torch.runtime.device_stats import (TELEMETRY,
                                                  register_device_gauges)
from flink_tpu_torch.runtime.metrics import (LatencyStats, MetricRegistry,
                                             TaskIOMetricGroup,
                                             register_checkpoint_gauges,
                                             register_faulttolerance_gauges,
                                             register_state_gauges,
                                             register_state_introspection_gauges)
from flink_tpu_torch.runtime.profiler import (get_profiler,
                                              register_profiler_gauges)
from flink_tpu_torch.runtime.tracing import (LAUNCH_LEDGER, get_tracer,
                                             register_runtime_profile_gauges)
from flink_tpu_torch.state.loader import load_state_backend
from flink_tpu_torch.state.portable import OperatorStateSnapshot
from flink_tpu_torch.streaming.elements import (END_OF_STREAM, MAX_WATERMARK,
                                                MIN_TIMESTAMP,
                                                CheckpointBarrier, EndOfStream,
                                                LatencyMarker, Watermark)
from flink_tpu_torch.streaming.graph import JobGraph, JobVertex
from flink_tpu_torch.streaming.operators import Output, StreamOperator
from flink_tpu_torch.streaming.sources import StreamSource
from flink_tpu_torch.streaming.timers import (ProcessingTimeService,
                                              TestProcessingTimeService)

#: channel choice for latency-marker forwarding
_rand = random.Random(0)


class JobExecutionResult:
    def __init__(self, job_name: str):
        self.job_name = job_name
        self.accumulators: Dict[str, Any] = {}
        self.checkpoints_completed = 0
        self.restarts = 0
        #: restarts scoped to the failed pipelined region (the healthy
        #: regions carried their live state across)
        self.region_restarts = 0
        self.cancelled = False


class JobCancelledException(Exception):
    pass


class SuppressRestartsException(Exception):
    """A failure that must not restart the job: one in the end-of-input
    finish phase, after every input was consumed."""

    def __init__(self, cause: BaseException):
        super().__init__(str(cause))
        self.cause = cause


class _InputChannel:
    """One input channel of a subtask.  An upstream router pushes
    elements into it and the subtask takes each at once, unless the
    channel is blocked for a barrier alignment: then the channel holds
    them, in order, until the alignment ends."""

    __slots__ = ("subtask", "input_index", "channel_id", "blocked",
                 "held", "eos")

    def __init__(self, subtask: "SubtaskInstance", input_index: int,
                 channel_id: int):
        self.subtask = subtask
        self.input_index = input_index
        self.channel_id = channel_id
        self.blocked = False
        self.held: deque = deque()
        self.eos = False

    def push(self, element) -> None:
        if self.blocked or self.held:
            self.held.append(element)
            return
        self.subtask.receive(self, element)


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

    def emit_latency_marker(self, marker):
        self.op.process_latency_marker(marker)


class _RouterOutput(Output):
    """Chain-tail output: each out-edge's partitioner picks the
    channels of every record, a batch is split per channel whole
    (``split_batch``), and watermarks, barriers and end of stream go to
    every channel."""

    def __init__(self):
        #: (partitioner, [_InputChannel], side tag)
        self.routes: List[Tuple[Any, List[_InputChannel], Any]] = []
        #: numRecordsOut, set by the task layer
        self.records_out_counter = None
        #: the backpressure plane's stamp of the last moment without
        #: capacity (never set here: routing is by direct call)
        self.last_blocked_mono = 0.0

    def has_capacity(self) -> bool:
        """Direct calls never queue, so a record always has a place."""
        return True

    def has_queued_output(self) -> bool:
        return False

    def add_route(self, partitioner, channels, side_tag=None) -> None:
        partitioner.setup(len(channels))
        self.routes.append((partitioner, channels, side_tag))

    def collect(self, record):
        if self.records_out_counter is not None:
            self.records_out_counter.count += 1
        for partitioner, channels, side_tag in self.routes:
            if side_tag is not None:
                continue
            if len(channels) == 1:
                channels[0].push(record)
                continue
            for idx in partitioner.select_channels(record.value, len(channels)):
                channels[idx].push(record)

    def collect_batch(self, batch):
        n = len(batch)
        if n == 0:
            return
        if self.records_out_counter is not None:
            self.records_out_counter.count += n
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

    def _broadcast(self, element):
        for _, channels, _ in self.routes:
            for ch in channels:
                ch.push(element)

    def emit_watermark(self, watermark):
        self._broadcast(watermark)

    def emit_latency_marker(self, marker):
        # one random channel per route, not a broadcast: a fan-out would
        # multiply markers by the parallelism at every shuffle
        for _, channels, side_tag in self.routes:
            if side_tag is None and channels:
                channels[_rand.randrange(len(channels))].push(marker)

    def broadcast_barrier(self, barrier: CheckpointBarrier):
        self._broadcast(barrier)

    def broadcast_end_of_stream(self):
        self._broadcast(END_OF_STREAM)


class SubtaskInstance:
    """One parallel instance of a JobVertex: the chain's operators,
    wired head to tail, with the router behind the tail, its input
    channels and their barrier alignment."""

    def __init__(self, vertex: JobVertex, state_backend=None,
                 device: DeviceLike = None, subtask_index: int = 0,
                 num_subtasks: int = 1, *,
                 processing_time_service: ProcessingTimeService,
                 metrics_group=None, latency_stats=None):
        self.vertex = vertex
        self.subtask_index = subtask_index
        self.task_key = (vertex.id, subtask_index)
        #: where device state and a fused chain program run
        self.device = device
        self.operators: List[StreamOperator] = [
            node.operator_factory() for node in vertex.chain]
        self.router = _RouterOutput()
        # metrics: the subtask's group and IO counters, a fresh set per
        # attempt; busy/idle/backpressured time observed once per turn
        self.metrics_group = metrics_group
        self.latency_stats = latency_stats
        self.io_metrics = (TaskIOMetricGroup(metrics_group)
                           if metrics_group is not None else None)
        self.time_accounting = TimeAccounting()
        if metrics_group is not None:
            register_time_attribution_gauges(metrics_group,
                                             self.time_accounting)
            self.router.records_out_counter = self.io_metrics.num_records_out
        # span names built once: the per-element path formats nothing
        self._span_process = f"op.{vertex.name}.process"
        self._span_checkpoint = "checkpoint.barrier"
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
            if metrics_group is not None:
                op.register_standard_metrics(metrics_group.add_group(node.uid))
        self.input_channels: List[_InputChannel] = []
        #: input_index -> {channel_id: watermark}
        self._watermarks: Dict[int, Dict[int, int]] = {}
        self._current_wm: Dict[int, int] = {}
        self.finished = False
        # exactly-once alignment
        self._align_id: Optional[int] = None
        self._align_barrier: Optional[CheckpointBarrier] = None
        self._align_received: Set[int] = set()
        # at-least-once barrier counts: id -> (barrier, channel ids)
        self._tracker_counts: Dict[int, Tuple[CheckpointBarrier, Set[int]]] = {}
        #: set by the executor: callable(task_key, checkpoint_id, snapshot)
        self.ack_fn = None
        #: sources: (checkpoint_id, timestamp, options) to inject
        self.pending_trigger: Optional[Tuple[int, int, dict]] = None
        self._ctx = None

    @property
    def head(self) -> StreamOperator:
        return self.operators[0]

    @property
    def is_source(self) -> bool:
        return isinstance(self.head, StreamSource)

    def new_channel(self, input_index: int) -> _InputChannel:
        ch = _InputChannel(self, input_index, len(self.input_channels))
        self.input_channels.append(ch)
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
    def source_step(self, max_records: int) -> None:
        """Inject a pending barrier, then emit up to max_records; at the
        end of input, finish the source."""
        if self.finished:
            return
        try:
            self.handle_pending_trigger()
            fn = self.head.user_function
            if hasattr(fn, "emit_step"):
                if self._ctx is None:
                    self._ctx = self.head.make_context()
                more = fn.emit_step(self._ctx, max_records)
            else:
                self.head.run()
                more = False
            if not more:
                self.finish_source()
        except TaskFailureException:
            raise
        except Exception as e:  # noqa: BLE001
            raise TaskFailureException(self.task_key, e) from e

    def finish_source(self):
        """End of input: a pending barrier first, then event time to the
        end (the chain sees the final watermark), then end of stream
        downstream."""
        if self.finished:
            return
        self.handle_pending_trigger()
        self.head.output.emit_watermark(MAX_WATERMARK)
        self.finished = True
        self.router.broadcast_end_of_stream()

    def handle_pending_trigger(self):
        """Snapshot the source's chain and send the barrier, at a
        record boundary."""
        trig = self.pending_trigger
        if trig is None or self.finished:
            return
        self.pending_trigger = None
        cid, ts, options = trig
        # linked to the coordinator's trigger by the barrier's context
        ctx = options.get("trace") if isinstance(options, dict) else None
        with get_tracer().span_linked(self._span_checkpoint, ctx,
                                      checkpoint_id=cid,
                                      task=self.vertex.name,
                                      subtask=self.subtask_index):
            snapshot = self.snapshot(cid)
            self.router.broadcast_barrier(CheckpointBarrier(cid, ts, options))
            if self.ack_fn is not None:
                self.ack_fn(self.task_key, cid, snapshot)

    # ---- input path -------------------------------------------------
    def receive(self, ch: _InputChannel, element) -> None:
        """One element of channel ``ch``; a failure is attributed to
        this subtask (the failover strategy scopes the restart by it)."""
        try:
            if element.is_record:
                tracer = get_tracer()
                if tracer.enabled:
                    with tracer.span(self._span_process):
                        self.process_record(ch.input_index, element)
                else:
                    self.process_record(ch.input_index, element)
            elif element.is_watermark:
                self.process_channel_watermark(ch.input_index, ch.channel_id,
                                               element)
            elif element.is_barrier:
                self._on_barrier(ch, element)
            elif isinstance(element, EndOfStream):
                self._on_end_of_stream(ch)
            elif element.is_latency_marker:
                if self.latency_stats is not None:
                    self.latency_stats.record(
                        element, self.head.operator_id,
                        _time.time() * 1000.0 - element.marked_time)
                self.head.process_latency_marker(element)
            else:
                tracer = get_tracer()
                if tracer.enabled:
                    with tracer.span(self._span_process):
                        self.process_batch_element(ch.input_index, element)
                else:
                    self.process_batch_element(ch.input_index, element)
        except TaskFailureException:
            raise
        except Exception as e:  # noqa: BLE001
            raise TaskFailureException(self.task_key, e) from e

    def process_record(self, input_index: int, record):
        if faults._active is not None:
            faults.fire("task.process")
        if self.io_metrics is not None:
            self.io_metrics.num_records_in.count += 1
        head = self.head
        head.set_key_context(record)
        head.process_element(record)

    def process_batch_element(self, input_index: int, batch):
        """A RecordBatch through the head: its fused chain program when
        it wants the batch, else the operator's ``process_batch``."""
        if faults._active is not None:
            faults.fire("task.process")
        if self.io_metrics is not None:
            self.io_metrics.num_records_in.count += len(batch)
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

    # ---- barriers ---------------------------------------------------
    def _live_channel_ids(self) -> Set[int]:
        return {c.channel_id for c in self.input_channels if not c.eos}

    def _on_barrier(self, ch: _InputChannel, barrier: CheckpointBarrier):
        cid = barrier.checkpoint_id
        if barrier.options.get("mode") == "at_least_once":
            entry = self._tracker_counts.setdefault(cid, (barrier, set()))
            entry[1].add(ch.channel_id)
            if entry[1] >= self._live_channel_ids():
                del self._tracker_counts[cid]
                self._complete_checkpoint(barrier)
            return
        if self._align_id is not None and cid != self._align_id:
            # a newer barrier abandons the alignment in flight
            self._release_alignment()
        if self._align_id is None:
            self._align_id = cid
            self._align_barrier = barrier
            self._align_received = set()
            tracer = get_tracer()
            if tracer.enabled:
                # one marker per alignment, linked to the coordinator's
                # trigger by the barrier's context
                ctx = barrier.options.get("trace") \
                    if isinstance(barrier.options, dict) else None
                tracer.record_instant(
                    "checkpoint.align.begin", checkpoint_id=cid,
                    task=self.vertex.name, subtask=self.subtask_index,
                    **({"trace_id": ctx["trace_id"],
                        "parent_span_id": ctx["span_id"]} if ctx else {}))
        self._align_received.add(ch.channel_id)
        ch.blocked = True
        self._maybe_complete_alignment()

    def _maybe_complete_alignment(self):
        if self._align_id is None \
                or not self._align_received >= self._live_channel_ids():
            return
        barrier = self._align_barrier
        self._align_id = None
        self._align_barrier = None
        self._align_received = set()
        self._complete_checkpoint(barrier)
        self._release_alignment()

    def _release_alignment(self):
        """Unblock every channel and replay what each held, in order;
        a replayed barrier may block its channel again."""
        self._align_id = None
        self._align_barrier = None
        self._align_received = set()
        for c in self.input_channels:
            c.blocked = False
        for c in self.input_channels:
            while c.held and not c.blocked:
                self.receive(c, c.held.popleft())

    def _complete_checkpoint(self, barrier: CheckpointBarrier):
        """Every live channel delivered the barrier: snapshot, forward
        the barrier, ack."""
        ctx = (barrier.options.get("trace")
               if isinstance(barrier.options, dict) else None)
        with get_tracer().span_linked(self._span_checkpoint, ctx,
                                      checkpoint_id=barrier.checkpoint_id,
                                      task=self.vertex.name,
                                      subtask=self.subtask_index):
            snapshot = self.snapshot(barrier.checkpoint_id)
            self.router.broadcast_barrier(barrier)
            if self.ack_fn is not None:
                self.ack_fn(self.task_key, barrier.checkpoint_id, snapshot)

    def _on_end_of_stream(self, ch: _InputChannel):
        ch.eos = True
        self._maybe_complete_alignment()
        if not self.finished and all(c.eos for c in self.input_channels):
            self.finished = True
            self.router.broadcast_end_of_stream()

    # ---- snapshots --------------------------------------------------
    def snapshot(self, checkpoint_id: Optional[int] = None) -> dict:
        return {"operators": {op.operator_id: op.snapshot_state(checkpoint_id)
                              for op in self.operators}}

    def restore(self, snapshots: List[dict]) -> None:
        for op in self.operators:
            per_op = [s["operators"][op.operator_id] for s in snapshots
                      if op.operator_id in s.get("operators", {})]
            if per_op:
                op.restore_state(per_op)

    def notify_checkpoint_complete(self, checkpoint_id: int) -> None:
        for op in self.operators:
            op.notify_checkpoint_complete(checkpoint_id)


class JobClient:
    """Handle on a job: its result, cancel and savepoints."""

    def __init__(self):
        self._cancel = threading.Event()
        self._done = threading.Event()
        self._result: Optional[JobExecutionResult] = None
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        #: the running attempt: {"subtasks", "coordinator"}
        self.executor_state: Optional[dict] = None

    def cancel(self) -> None:
        self._cancel.set()

    @property
    def cancel_requested(self) -> bool:
        return self._cancel.is_set()

    def wait(self, timeout: Optional[float] = None) -> JobExecutionResult:
        self._done.wait(timeout)
        if not self._done.is_set():
            raise TimeoutError("job still running")
        if self._error is not None:
            raise self._error
        return self._result

    def trigger_savepoint(self, directory: str,
                          timeout: float = 60.0) -> str:
        """Blocks until the savepoint is written; returns its path."""
        # the job thread publishes executor_state while it sets the
        # attempt up: a request right after the submit waits for it
        deadline = _time.monotonic() + min(timeout, 5.0)
        coordinator = None
        while _time.monotonic() < deadline and not self.done:
            coordinator = (self.executor_state or {}).get("coordinator")
            if coordinator is not None:
                break
            _time.sleep(0.002)
        if coordinator is None:
            if self.done:
                raise RuntimeError(
                    "cannot savepoint: the job is no longer running")
            raise RuntimeError("savepoints require checkpointing to be "
                               "enabled (env.enable_checkpointing)")
        return coordinator.trigger_savepoint(directory).wait(timeout)

    def stop_with_savepoint(self, directory: str,
                            timeout: float = 60.0) -> str:
        """Savepoint, then cancel.  What the job processes between the
        two reaches its sinks again after a restore from the
        savepoint."""
        path = self.trigger_savepoint(directory, timeout)
        self.cancel()
        self._done.wait(timeout)
        return path

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def _finish(self, result=None, error=None):
        self._result = result
        self._error = error
        self._done.set()


def gather_accumulators(all_tasks, into: Dict[str, Any]) -> None:
    """User-function accumulators into the job result; lists
    concatenate, numbers add, once per function instance."""
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
    the keyed operators' backends; ``restart_strategy`` is a dict as
    ``make_restart_strategy`` takes it; ``failover_strategy`` is
    ``full`` or ``region``."""

    #: records a source emits per loop step before the next source runs
    SOURCE_BUDGET = 1024

    def __init__(self, state_backend=None, device: DeviceLike = None,
                 restart_strategy: Optional[dict] = None,
                 processing_time_service: Optional[ProcessingTimeService] = None,
                 failover_strategy: str = "full",
                 latency_interval_ms: Optional[int] = None,
                 sample_interval_ms: Optional[int] = None,
                 metrics_history_size: int = 1024):
        self.state_backend = state_backend
        self.device = device
        self.restart_strategy_config = restart_strategy or {"strategy": "none"}
        self.pts = processing_time_service or TestProcessingTimeService()
        self.failover_strategy = failover_strategy
        self.metrics = MetricRegistry()
        register_state_gauges(self.metrics)
        register_state_introspection_gauges(self.metrics)
        register_device_gauges(self.metrics)
        register_profiler_gauges(self.metrics)
        #: sources emit a LatencyMarker this often (None: never)
        self.latency_interval_ms = latency_interval_ms
        #: the metrics journal's cadence (None: no journal exists)
        self.sample_interval_ms = sample_interval_ms
        self.metrics_history_size = metrics_history_size

    def build_subtasks(self, job_graph: JobGraph
                       ) -> Dict[int, List[SubtaskInstance]]:
        """Every vertex's subtasks, and every edge's channels: all to
        all, or pointwise groups for a pointwise partitioner."""
        job_group = self.metrics.job_group(job_graph.job_name)
        latency_stats = LatencyStats(job_group)
        register_runtime_profile_gauges(self.metrics)
        subtasks = {}
        for v in job_graph.topological_vertices():
            vertex_group = job_group.add_group(f"{v.id}_{v.name}")
            subtasks[v.id] = [
                SubtaskInstance(v, self.state_backend, self.device, i,
                                v.parallelism, processing_time_service=self.pts,
                                metrics_group=vertex_group.add_group(str(i)),
                                latency_stats=latency_stats)
                for i in range(v.parallelism)]
            # the sampling profiler's attribution, stamped once here
            for i, st in enumerate(subtasks[v.id]):
                st.profiler_scope = (job_graph.job_name, f"{v.id}_{v.name}", i)
            register_backpressure_gauges(vertex_group, subtasks[v.id])
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

    # ---- public API -------------------------------------------------
    def execute(self, job_graph: JobGraph) -> JobExecutionResult:
        client = JobClient()
        self._run_job(job_graph, client)
        return client.wait()

    def execute_async(self, job_graph: JobGraph) -> JobClient:
        """Run the job on a thread of its own.  Operators on the card
        switch torch's process-wide default dtype around fused chain
        stages, so the caller runs no torch work while the job runs;
        it waits on the client, cancels it or asks for savepoints."""
        client = JobClient()
        t = threading.Thread(target=self._run_job, args=(job_graph, client),
                             daemon=True, name="job-executor")
        client._thread = t
        t.start()
        return client

    # ---- the job, with restarts ------------------------------------
    def _run_job(self, job_graph: JobGraph, client: JobClient) -> None:
        result = JobExecutionResult(job_graph.job_name)
        cp_config = job_graph.checkpoint_config
        try:
            journal, evaluator = make_health_plane(
                self.metrics, self.sample_interval_ms,
                self.metrics_history_size, job_graph.job_name, client)
            storage = make_checkpoint_storage(cp_config) if cp_config else None
            restart = make_restart_strategy(self.restart_strategy_config)
            restore_from = initial_restore_point(job_graph)
            carryover = None
            regions = (compute_pipelined_regions(job_graph)
                       if self.failover_strategy == "region" else None)
            region_index = (build_region_index(regions)
                            if regions is not None else None)
            while True:
                try:
                    self._run_attempt(job_graph, client, result, storage,
                                      restore_from, carryover, journal,
                                      evaluator)
                    _resolve_launch_ledger()
                    self._finish(client, job_graph, result=result)
                    return
                except JobCancelledException:
                    result.cancelled = True
                    self._finish(client, job_graph, result=result)
                    return
                except SuppressRestartsException as e:
                    raise e.cause
                except Exception as e:  # noqa: BLE001
                    restart.notify_failure(_time.monotonic() * 1000.0)
                    if client.cancel_requested or not restart.can_restart():
                        if isinstance(e, TaskFailureException):
                            raise e.cause from e
                        raise
                    result.restarts += 1
                    if restart.delay_ms:
                        _time.sleep(restart.delay_ms / 1000.0)
                    restore_from = storage.latest() if storage else None
                    carryover = None
                    if (regions is not None
                            and isinstance(e, TaskFailureException)
                            and getattr(e, "live_state", None) is not None):
                        failed = set(region_of(regions, e.task_key,
                                               region_index))
                        # a healthy subtask whose capture failed pulls
                        # its whole region into the restart
                        for fk in getattr(e, "capture_failed_keys", []):
                            failed |= region_of(regions, fk, region_index)
                        healthy = {k for k in e.live_state if k not in failed}
                        if healthy:
                            carryover = {k: e.live_state[k] for k in healthy}
                            result.region_restarts += 1
                            if restore_from is not None:
                                restore_from = {
                                    **restore_from,
                                    "tasks": {k: v for k, v
                                              in restore_from["tasks"].items()
                                              if k in failed}}
        except BaseException as e:  # noqa: BLE001
            self._finish(client, job_graph, error=e)

    def _finish(self, client: JobClient, job_graph: JobGraph,
                **outcome) -> None:
        """The job's end: its gauges keep the values they read now and
        let go of its operators, then the client learns the outcome."""
        self.metrics.job_group(job_graph.job_name).freeze()
        client._finish(**outcome)

    def _run_attempt(self, job_graph: JobGraph, client: JobClient,
                     result: JobExecutionResult, storage,
                     restore_from: Optional[dict],
                     carryover: Optional[dict] = None,
                     journal=None, evaluator=None) -> None:
        reset = getattr(self.pts, "reset_timers", None)
        if reset is not None:
            reset()  # timers of a failed attempt's operators
        subtasks = self.build_subtasks(job_graph)
        all_tasks = [st for v in job_graph.topological_vertices()
                     for st in subtasks[v.id]]
        sources = [st for st in all_tasks if st.is_source]
        opened: List[SubtaskInstance] = []
        coordinator = None
        try:
            for st in reversed(all_tasks):   # consumers before producers
                st.open()
                opened.append(st)
            # restore after open: the keyed backends take a restore once
            # the operators bound their state descriptors
            if carryover is not None:
                for st in all_tasks:
                    cap = carryover.get(st.task_key)
                    if cap is not None:
                        _restore_live_capture(st, cap)
                    elif restore_from is not None \
                            and st.task_key in restore_from["tasks"]:
                        st.restore([restore_from["tasks"][st.task_key]])
                # what the healthy subtasks held goes on downstream now
                for st in all_tasks:
                    st._release_alignment()
            elif restore_from is not None:
                assign_restore_snapshots(job_graph, restore_from, subtasks)

            ack_queue: deque = deque()
            cfg = job_graph.checkpoint_config
            if storage is not None and cfg.get("interval"):
                def trigger_sources(cid, ts, options):
                    if any(s.finished for s in sources):
                        return False
                    for s in sources:
                        s.pending_trigger = (cid, ts, options)
                    return True

                def notify_complete(cid):
                    for st in all_tasks:
                        st.notify_checkpoint_complete(cid)

                coordinator = CheckpointCoordinator(
                    interval_ms=cfg["interval"],
                    mode=cfg.get("mode", "exactly_once"),
                    storage=storage,
                    expected_tasks={st.task_key for st in all_tasks},
                    trigger_sources=trigger_sources,
                    notify_complete=notify_complete,
                    min_pause_ms=cfg.get("min_pause", 0),
                    async_persist=bool(cfg.get("async_persist", False)),
                    checkpoint_timeout_ms=cfg.get("timeout"),
                    tolerable_checkpoint_failures=cfg.get("tolerable_failures"))
                coordinator.vertex_parallelisms = {
                    vid: v.parallelism for vid, v in job_graph.vertices.items()}
                register_checkpoint_gauges(self.metrics, job_graph.job_name,
                                           coordinator)
                register_faulttolerance_gauges(self.metrics,
                                               job_graph.job_name, coordinator)
                # ids go on across restarts
                ids = storage.checkpoint_ids()
                if ids:
                    coordinator._id_counter = ids[-1]

            def ack(task_key, cid, snapshot):
                if faults.check("checkpoint.ack"):
                    return  # lost in transit: the checkpoint times out
                ack_queue.append((task_key, cid, snapshot))

            for st in all_tasks:
                st.ack_fn = ack
            client.executor_state = {
                "subtasks": subtasks, "coordinator": coordinator,
                "checkpoints_base": getattr(result, "_cp_base", 0),
                "journal": journal, "health": evaluator,
                "upstreams": derive_upstreams(job_graph)}
            try:
                self._loop(client, result, coordinator, ack_queue,
                           all_tasks, sources, journal, evaluator)
            except TaskFailureException as tfe:
                if self.failover_strategy == "region":
                    tfe.live_state, tfe.capture_failed_keys = \
                        _capture_live_state(all_tasks, tfe.task_key)
                raise
        finally:
            if coordinator is not None:
                try:
                    coordinator.drain()  # land the writes in flight
                except Exception:  # noqa: BLE001 - the attempt's outcome
                    pass           # is decided already
                result.checkpoints_completed = (
                    getattr(result, "_cp_base", 0) + coordinator.completed_count)
                result._cp_base = result.checkpoints_completed
                coordinator.stopped = True
                coordinator.fail_pending_savepoints(RuntimeError(
                    "job attempt ended before the savepoint completed"))
            for s in sources:
                try:
                    s.head.cancel()
                except Exception:  # noqa: BLE001
                    pass
            for st in opened:
                st.close()

    # ---- the loop ---------------------------------------------------
    def _loop(self, client, result, coordinator, ack_queue, all_tasks,
              sources, journal=None, evaluator=None):
        pts = self.pts
        pts_poll = getattr(pts, "fire_due", None)
        active = list(sources)
        profiler = get_profiler()
        non_sources = [st for st in all_tasks if not st.is_source]
        last_latency_emit = _time.monotonic()
        while True:
            if client.cancel_requested:
                raise JobCancelledException()
            # periodic latency markers from the sources
            if self.latency_interval_ms is not None:
                now = _time.monotonic()
                if (now - last_latency_emit) * 1000.0 >= self.latency_interval_ms:
                    last_latency_emit = now
                    now_ms = _time.time() * 1000.0
                    for s in active:
                        s.head.output.emit_latency_marker(LatencyMarker(
                            now_ms, s.head.operator_id, s.subtask_index))
            # a due checkpoint's barrier goes ahead of this turn's records
            if coordinator is not None and all(not s.finished for s in sources):
                coordinator.maybe_trigger()
            for s in active:
                if profiler.enabled:
                    profiler.set_scope(s)
                before = s.io_metrics.num_records_out.count \
                    if s.io_metrics is not None else 0
                s.source_step(self.SOURCE_BUDGET)
                observe_subtask(s, s.io_metrics is not None and
                                s.io_metrics.num_records_out.count != before)
            # the other subtasks ran inside the sources' calls: one
            # observation each per turn, busy when records came in
            for st in non_sources:
                io = st.io_metrics
                if io is None:
                    continue
                seen = io.num_records_in.count
                observe_subtask(st, seen != getattr(st, "_seen_in", 0))
                st._seen_in = seen
            active = [s for s in active if not s.finished]
            if pts_poll is not None:
                pts_poll()
            if coordinator is not None:
                self._take_acks(coordinator, ack_queue)
                # a source that finished with a trigger it never took can
                # never ack it
                for s in sources:
                    if s.finished and s.pending_trigger is not None:
                        cid = s.pending_trigger[0]
                        s.pending_trigger = None
                        coordinator.decline(cid)
            # the metrics journal's tick, and the health rules on a sample
            if journal is not None and journal.maybe_sample():
                evaluator.evaluate()
            if not active:
                break
        # end of input: the test clock's pending timers fire until none
        # is left, so processing-time windows emit their tails (their
        # output reaches the sinks by direct calls and may register
        # further timers)
        if isinstance(pts, TestProcessingTimeService):
            for _ in range(1000):
                pts.fire_all_pending()
                if not pts.has_pending():
                    break
        if coordinator is not None:
            self._take_acks(coordinator, ack_queue)
        # finish phase: end-of-input flushes, topologically; the input is
        # consumed, so a failure here does not restart the job
        try:
            for st in all_tasks:
                st.finish()
        except Exception as e:  # noqa: BLE001
            raise SuppressRestartsException(e) from e
        gather_accumulators(all_tasks, result.accumulators)

    @staticmethod
    def _take_acks(coordinator, ack_queue) -> None:
        while ack_queue:
            task_key, cid, snapshot = ack_queue.popleft()
            coordinator.acknowledge(task_key, cid, snapshot)


# ---- restore assignment ----------------------------------------------

def _resolve_launch_ledger() -> None:
    """The job's end: the launch ledger's pending CUDA events resolve
    (one synchronize) while the plane is on."""
    if get_tracer().enabled or TELEMETRY.enabled:
        LAUNCH_LEDGER.resolve()


def make_health_plane(metrics, sample_interval_ms: Optional[int],
                      history_size: int, job_name: str, client):
    """Journal and health evaluator of one job, shared by its restart
    attempts so history survives a failover; (None, None) when sampling
    is off, so the loop's tick is one None check (ref
    ``flink_tpu/runtime/local.py:1162-1190``)."""
    if sample_interval_ms is None:
        return None, None
    from flink_tpu_torch.runtime.timeseries import (HealthEvaluator,
                                                    MetricsJournal,
                                                    register_health_gauges)
    journal = MetricsJournal(metrics, interval_ms=sample_interval_ms,
                             history_size=history_size)

    def bottleneck_supplier():
        state = getattr(client, "executor_state", None) or {}
        return locate_bottleneck(state.get("upstreams") or {},
                                 read_vertex_stats(metrics.dump(), job_name))

    evaluator = HealthEvaluator(
        journal,
        coordinator_supplier=lambda: (
            getattr(client, "executor_state", None) or {}).get("coordinator"),
        bottleneck_supplier=bottleneck_supplier)
    register_health_gauges(metrics, job_name, evaluator)
    return journal, evaluator


def _op_snap_has_state(opsnap: dict) -> bool:
    """Does one operator's snapshot carry anything whose loss would
    change results?"""
    for k, v in opsnap.items():
        if k == "keyed":
            if getattr(v, "key_group_bytes", None):
                return True
        elif k == "operator":
            if getattr(v, "list_states", None) \
                    or getattr(v, "broadcast_states", None):
                return True
        elif k == "timers":
            if isinstance(v, dict) and (v.get("event") or v.get("proc")):
                return True
        elif k == "restore_old_parallelism":
            continue
        else:
            return True
    return False


def _vertex_has_state(snaps: List[dict]) -> bool:
    return any(_op_snap_has_state(op)
               for s in snaps
               for op in s.get("operators", {}).values())


def compute_restore_assignments(vertex_parallelisms: Dict[int, int],
                                restore_from: dict,
                                vertex_uids: Optional[Dict[int, set]] = None,
                                allow_non_restored: bool = False
                                ) -> Dict[Tuple[int, int], List[dict]]:
    """A checkpoint's or savepoint's task snapshots mapped onto the
    (maybe rescaled) subtasks: task_key -> snapshot list.

    With ``vertex_uids`` (new vertex id -> its chain's operator uids)
    old vertices match new ones by operator uid; an old operator with
    real state that matches no uid raises unless ``allow_non_restored``.
    Without it the mapping is by vertex id.  At the same parallelism
    the mapping is one to one.  At another one, keyed state and timers
    go to every new subtask (each keeps its key-group range; each
    operator snapshot is marked ``restore_old_parallelism`` so an
    engine re-splits its own state), operator list state re-splits
    round robin, and each old subtask's function state goes to exactly
    one new subtask."""
    task_snaps: Dict[Tuple[int, int], dict] = restore_from["tasks"]
    old_par: Dict[int, int] = dict(restore_from.get("parallelisms") or {})
    for (vid, idx) in task_snaps:
        old_par[vid] = max(old_par.get(vid, 0), idx + 1)

    def vsnaps_of(vid):
        return [task_snaps[(vid, i)] for i in range(old_par[vid])
                if (vid, i) in task_snaps]

    edges: Dict[int, List[int]] = {}
    if vertex_uids is None:
        for vid in old_par:
            if vid in vertex_parallelisms:
                edges[vid] = [vid]
    else:
        for vid in old_par:
            uids = {op_id for s in vsnaps_of(vid)
                    for op_id in s.get("operators", {})}
            edges[vid] = [nvid for nvid, nuids in vertex_uids.items()
                          if uids & nuids]
    # orphans by operator when uids are known: a vertex may match by
    # one uid while a chained operator's uid moved
    if vertex_uids is not None:
        live_uids = set()
        for uids in vertex_uids.values():
            live_uids |= uids
        orphan_ops = sorted({
            op_id
            for vid in old_par
            for s in vsnaps_of(vid)
            for op_id, opsnap in s.get("operators", {}).items()
            if op_id not in live_uids and _op_snap_has_state(opsnap)})
        detail = (f"checkpoint state for operators {orphan_ops} matches no "
                  f"operator uid in the restored topology (did the plan "
                  f"shape change without stable .uid()s?)")
    else:
        orphaned = [vid for vid in old_par if vid not in vertex_parallelisms]
        orphan_ops = sorted(vid for vid in orphaned
                            if _vertex_has_state(vsnaps_of(vid)))
        detail = (f"checkpoint state for vertices {orphan_ops} matches no "
                  f"vertex in the restored topology")
    if orphan_ops:
        if not allow_non_restored:
            raise RuntimeError(
                detail + "; restoring would silently drop state. Set "
                "allow_non_restored_state to proceed without it.")
        import warnings
        warnings.warn(detail + "; DROPPED (allow_non_restored_state)",
                      stacklevel=2)

    out: Dict[Tuple[int, int], List[dict]] = {}
    for vid, new_vids in edges.items():
        if old_par.get(vid, 0) == 0:
            continue
        for nvid in new_vids:
            new_p = vertex_parallelisms[nvid]
            if old_par[vid] == new_p:
                for i in range(new_p):
                    if (vid, i) in task_snaps:
                        out.setdefault((nvid, i), []).append(task_snaps[(vid, i)])
                continue
            vsnaps = vsnaps_of(vid)
            stripped = []
            op_state_parts: Dict[str, List] = {}
            fn_states: Dict[str, List] = {}
            for snap in vsnaps:
                ops = {}
                for op_id, opsnap in snap.get("operators", {}).items():
                    cp = {k: v for k, v in opsnap.items()
                          if k not in ("operator", "function")}
                    cp["restore_old_parallelism"] = old_par[vid]
                    ops[op_id] = cp
                    if "operator" in opsnap:
                        op_state_parts.setdefault(op_id, []).append(
                            opsnap["operator"])
                    if "function" in opsnap:
                        fn_states.setdefault(op_id, []).append(
                            opsnap["function"])
                stripped.append({"operators": ops})
            redistributed = {
                op_id: OperatorStateSnapshot.redistribute(parts, new_p)
                for op_id, parts in op_state_parts.items()}
            for i in range(new_p):
                extras = [{"operators": {
                    op_id: {"operator": parts[i]}
                    for op_id, parts in redistributed.items()}}]
                for op_id, states in fn_states.items():
                    for fstate in states[i::new_p]:
                        extras.append({"operators": {op_id:
                                                     {"function": fstate}}})
                out.setdefault((nvid, i), []).extend(stripped + extras)
    return out


def assign_restore_snapshots(job_graph: JobGraph, restore_from: dict,
                             subtasks: Dict[int, List[SubtaskInstance]]
                             ) -> None:
    mapping = compute_restore_assignments(
        {vid: v.parallelism for vid, v in job_graph.vertices.items()},
        restore_from,
        vertex_uids={vid: {n.uid for n in v.chain}
                     for vid, v in job_graph.vertices.items()},
        allow_non_restored=job_graph.allow_non_restored_state)
    for sts in subtasks.values():
        for st in sts:
            snaps = mapping.get(st.task_key)
            if snaps:
                st.restore(snaps)


def initial_restore_point(job_graph: JobGraph) -> Optional[dict]:
    """The savepoint the job graph names (``set_savepoint_restore``)."""
    path = job_graph.savepoint_restore_path
    return None if path is None else load_savepoint(path)


# ---- region failover: live state of the healthy subtasks ---------------

def _capture_live_state(all_tasks, failed_key):
    """Operator snapshots, held channel elements, end-of-stream flags
    and watermarks of every subtask but the failed one.  Returns
    (captured, keys whose capture failed); a failed capture pulls its
    region into the restart.  Barriers and alignments do not carry over:
    the checkpoint in flight cannot complete, and the new attempt
    reuses ids from the last completed one."""
    out = {}
    capture_failed = []
    for st in all_tasks:
        if st.task_key == failed_key:
            continue
        try:
            out[st.task_key] = {
                "snap": st.snapshot(),
                "finished": st.finished,
                "held": [[el for el in ch.held if not el.is_barrier]
                         for ch in st.input_channels],
                "eos": [ch.eos for ch in st.input_channels],
                "wm": (copy.deepcopy(st._watermarks), dict(st._current_wm)),
            }
        except Exception:  # noqa: BLE001 - widen the restart instead
            capture_failed.append(st.task_key)
    return out, capture_failed


def _restore_live_capture(st: SubtaskInstance, cap) -> None:
    st.restore([cap["snap"]])
    st.finished = cap["finished"]
    for ch, held, eos in zip(st.input_channels, cap["held"], cap["eos"]):
        ch.held.extend(held)
        ch.eos = eos
    st._watermarks, st._current_wm = cap["wm"]
