"""DataStream API (port of ``flink_tpu/streaming/datastream.py``):

    env = StreamExecutionEnvironment.get_execution_environment()
    env.set_state_backend("gpu")
    (env.from_collection(events)
        .assign_timestamps_and_watermarks(BoundedOutOfOrdernessTimestampExtractor(0, ts_of))
        .key_by(key_of)
        .window(TumblingEventTimeWindows.of(1000))
        .allowed_lateness(500)
        .aggregate(HyperLogLogAggregate(12), window_function)
        .add_sink(CollectSink(out)))
    env.execute()

The environment runs on the card unless it is created with
``device="cpu"``; keyed operators get a keyed-state backend from the
``state.backend`` setting (``set_state_backend`` or a
``Configuration``).  ``WindowedStream.aggregate`` makes the reference's
three-way choice.  On tumbling, sliding (size a multiple of the slide)
and session windows with the default trigger, no evictor, lateness 0
and no late-data tag, a ``DeviceAggregateFunction`` runs on
``DeviceWindowOperator`` (the device engines) and any other Python
``AggregateFunction`` on ``GenericWindowOperator`` (the generic tier,
host numpy).  Everything else, and every job after
``disable_device_operator()``, runs on ``WindowOperator`` over the
keyed backend, as do ``reduce`` / ``fold`` / ``apply`` / ``process`` /
``sum`` / ``min`` / ``max``; a stream with an evictor runs on
``EvictingWindowOperator``.  ``trigger`` / ``evictor`` take a stream off
both batch tiers.  ``count_window`` and ``count_window_all`` are
``GlobalWindows`` with a (purging) ``CountTrigger``, and with a slide a
``CountEvictor``; ``window_all`` keys every record to 0 and runs at
parallelism 1.  With ``env.set_mesh(mesh)`` a tumbling device aggregate
runs sharded over the mesh (``flink_tpu_torch.parallel``): the operator
is added at parallelism 1, since the mesh is the parallelism, or, with
a mesh factory, at the environment's parallelism, each subtask
building its own mesh.  Other assigners run without the mesh, as in
the reference.

``process`` hosts a ``ProcessFunction`` (keyed: with keyed state and
timers); a keyed stream's ``reduce`` / ``sum`` / ``min`` / ``max`` /
``min_by`` / ``max_by`` emit the running reduction per element.
``rebalance``, ``rescale``, ``shuffle``, ``broadcast``, ``global_``,
``forward`` and ``partition_custom`` set the next edge's partitioner;
``disable_chaining`` and ``start_new_chain`` control chaining.
``join`` / ``co_group`` (windowed) and ``interval_join`` build on
union, tags, a window apply and a keyed process function
(``joining.py``).

``set_stream_time_characteristic("processing")`` makes ``time_window``
pick the processing-time assigners and drops the sources' timestamps;
``"ingestion"`` stamps records with the processing-time clock at the
source.  ``env.processing_time_service`` is the clock the executor
hands every operator (a ``TestProcessingTimeService`` at 0 when None;
a ``PolledProcessingTimeService`` for the wall clock).

``add_source`` runs a source at the parallelism it is given (a
``ParallelSourceFunction`` may take more than 1), each subtask with its
own copy of the function and, for a rich function, its own runtime
context; a source without ``emit_step`` runs on a thread of its own.
``socket_text_stream`` (lines from a TCP socket) and ``read_text_file``
are such sources, ``write_as_text`` writes a line per element, and a
sink that decodes retract pairs (``enable_retract_decoding``) is told
so when it is added to a Table's ``to_retract_stream()``.

``connect`` joins two streams into one two-input operator:
``ConnectedStreams.map`` / ``flat_map`` / ``process`` (a
``CoMapFunction``, ``CoFlatMapFunction`` or co-process function;
``key_by(k1, k2)`` keys both inputs, with keyed state and timers), and
with ``broadcast(*descriptors)`` the broadcast state pattern: a
``(Keyed)BroadcastProcessFunction`` reads the broadcast state on the
data side and writes it on the broadcast side, on every instance.  An
operator of two inputs sees one watermark per input, its own the
minimum.  ``split(selector)`` / ``select(*names)`` route by names,
``iterate()`` / ``close_with(feedback)`` wire a loop (the back edge
carries no barrier and no end of stream), ``AsyncDataStream.
ordered_wait`` / ``unordered_wait`` run async I/O with a capacity and
a timeout, and ``KeyedStream.as_queryable_state`` keeps a keyed state
readable from other threads (``runtime/queryable.py``).

``enable_checkpointing`` turns on barrier checkpoints into the storage
``set_checkpoint_storage`` picks (``memory``, or ``filesystem`` with a
directory); ``set_restart_strategy`` / ``set_failover_strategy``
decide what a failure does, ``set_savepoint_restore`` starts the next
execution from a savepoint, and ``execute_async`` returns a
``JobClient`` (see ``runtime/local.py``).
"""

from __future__ import annotations

import copy
from typing import Any, Iterable, List, Optional

from flink_tpu_torch.core.config import Configuration
from flink_tpu_torch.core.functions import (AggregateFunction,
                                            as_filter_function,
                                            as_flat_map_function,
                                            as_key_selector, as_map_function,
                                            as_reduce_function)
from flink_tpu_torch.core.state import (AggregatingStateDescriptor,
                                        FoldingStateDescriptor,
                                        ListStateDescriptor,
                                        ReducingStateDescriptor)
from flink_tpu_torch.device import DeviceLike, resolve_device
from flink_tpu_torch.streaming.device_window_operator import (
    DeviceWindowOperator, is_device_eligible, is_mesh_factory)
from flink_tpu_torch.streaming.generic_agg import (GenericWindowOperator,
                                                   is_generic_eligible)
from flink_tpu_torch.streaming.graph import (StreamEdge, StreamGraph,
                                             StreamNode, create_job_graph)
from flink_tpu_torch.state.backend import VOID_NAMESPACE
from flink_tpu_torch.streaming.operators import (AsyncWaitOperator,
                                                CoBroadcastOperator,
                                                CoProcessOperator,
                                                CoStreamFlatMap, CoStreamMap,
                                                KeyedProcessOperator,
                                                ProcessOperator,
                                                StreamFilter, StreamFlatMap,
                                                StreamGroupedReduce,
                                                StreamMap, StreamSink)
from flink_tpu_torch.streaming.partitioners import (BroadcastPartitioner,
                                                    CustomPartitionerWrapper,
                                                    ForwardPartitioner,
                                                    GlobalPartitioner,
                                                    KeyGroupStreamPartitioner,
                                                    RebalancePartitioner,
                                                    RescalePartitioner,
                                                    ShufflePartitioner,
                                                    StreamPartitioner)
from flink_tpu_torch.streaming.sources import (CollectSink, FileTextSource,
                                               FromCollectionSource, PrintSink,
                                               SocketTextStreamSource,
                                               SourceFunction, StreamSource,
                                               TimestampsAndWatermarksOperator,
                                               WriteAsTextSink)
from flink_tpu_torch.streaming.two_phase import TwoPhaseCommitSinkFunction
from flink_tpu_torch.streaming.window_operator import (EvictingWindowOperator,
                                                      WindowOperator)
from flink_tpu_torch.streaming.windowing import (
    CountEvictor, CountTrigger, GlobalWindows, PurgingTrigger,
    SlidingEventTimeWindows, SlidingProcessingTimeWindows, Time,
    TumblingEventTimeWindows, TumblingProcessingTimeWindows, WindowAssigner)


class StreamExecutionEnvironment:
    """Builds the stream graph and executes it locally."""

    def __init__(self, configuration: Optional[Configuration] = None, *,
                 device: DeviceLike = None):
        if configuration is not None and not isinstance(configuration, Configuration):
            raise TypeError("configuration must be a "
                            "flink_tpu_torch.core.config.Configuration")
        #: where device state lives (the card unless "cpu")
        self.device = resolve_device(device)
        #: the keys the port reads: state.backend and its tuning keys
        self.config = configuration if configuration is not None else Configuration()
        self.graph = StreamGraph()
        #: nodes of two-phase commit sinks (held to parallelism 1)
        self._two_phase_sinks = []
        self.parallelism = 1
        self.max_parallelism = 128
        #: device window aggregation sharded over this mesh (set_mesh)
        self.mesh = None
        self.mesh_axis = "kg"
        self.time_characteristic = "event"
        #: the executor's processing-time clock (None: a test clock at 0)
        self.processing_time_service = None
        self.checkpoint_config: Optional[dict] = None
        self.checkpoint_storage: dict = {"storage": "memory", "retain": 1}
        self.restart_strategy: dict = {"strategy": "none"}
        self.failover_strategy = "full"
        self.savepoint_restore_path: Optional[str] = None
        self.allow_non_restored_state = False
        #: sources emit a LatencyMarker this often (None: never)
        self.latency_tracking_interval: Optional[int] = None
        self._last_executor = None

    @staticmethod
    def get_execution_environment(configuration: Optional[Configuration] = None,
                                  *, device: DeviceLike = None
                                  ) -> "StreamExecutionEnvironment":
        return StreamExecutionEnvironment(configuration, device=device)

    def set_state_backend(self, backend: str) -> "StreamExecutionEnvironment":
        """The keyed-state backend of keyed operators: ``heap``, or
        ``gpu`` (or the reference's ``tpu``/``rocksdb``/``device``/``hbm``)."""
        self.config.set("state.backend", backend)
        return self

    def set_mesh(self, mesh, axis: str = "kg") -> "StreamExecutionEnvironment":
        """Shard device window aggregation over ``mesh[axis]``
        (``flink_tpu_torch.parallel.Mesh``): the keyBy exchange becomes a
        pack into per-shard buckets and an all_to_all.  ``mesh`` may be a
        callable that builds a Mesh in each subtask."""
        self.mesh = mesh
        self.mesh_axis = axis
        return self

    def set_parallelism(self, parallelism: int) -> "StreamExecutionEnvironment":
        self.parallelism = parallelism
        return self

    def set_stream_time_characteristic(self, tc: str) -> "StreamExecutionEnvironment":
        """``event`` (default), ``processing`` or ``ingestion``."""
        if tc not in ("event", "processing", "ingestion"):
            raise ValueError(f"unknown time characteristic {tc!r}")
        self.time_characteristic = tc
        return self

    # ---- fault tolerance --------------------------------------------
    def enable_checkpointing(self, interval_ms: int,
                             mode: str = "exactly_once",
                             async_persist: bool = False,
                             timeout_ms: Optional[int] = None,
                             tolerable_failures: Optional[int] = None
                             ) -> "StreamExecutionEnvironment":
        """A checkpoint every ``interval_ms`` of wall clock.  ``mode``:
        ``exactly_once`` aligns barriers, ``at_least_once`` does not.
        ``async_persist`` writes completed checkpoints on a writer
        thread (operators hear of completion after the write);
        ``timeout_ms`` aborts a checkpoint not fully acknowledged in
        time; ``tolerable_failures`` = N tolerates N consecutive failed
        checkpoints before the job fails (None: a failed write fails the
        job, aborts never do)."""
        if mode not in ("exactly_once", "at_least_once"):
            raise ValueError(f"unknown checkpointing mode {mode!r}")
        self.checkpoint_config = {"interval": interval_ms, "mode": mode,
                                  "async_persist": async_persist}
        if timeout_ms is not None:
            self.checkpoint_config["timeout"] = timeout_ms
        if tolerable_failures is not None:
            self.checkpoint_config["tolerable_failures"] = tolerable_failures
        return self

    def set_checkpoint_storage(self, storage: str, directory: Optional[str] = None,
                               retain: int = 1) -> "StreamExecutionEnvironment":
        """``memory``, or ``filesystem`` under ``directory`` (a path or
        a registered scheme such as ``mem://``), keeping the newest
        ``retain`` checkpoints."""
        self.checkpoint_storage = {"storage": storage, "retain": retain}
        if directory is not None:
            self.checkpoint_storage["dir"] = directory
        return self

    def set_restart_strategy(self, strategy: str, **kw) -> "StreamExecutionEnvironment":
        """``none``, ``fixed_delay(restart_attempts, delay_ms)`` or
        ``failure_rate(max_failures, failure_interval_ms, delay_ms)``."""
        self.restart_strategy = {"strategy": strategy, **kw}
        return self

    def set_failover_strategy(self, strategy: str) -> "StreamExecutionEnvironment":
        """``full`` (default) restarts the whole job; ``region`` only
        the failed subtask's pipelined region."""
        if strategy not in ("full", "region"):
            raise ValueError(f"unknown failover strategy {strategy!r}")
        self.failover_strategy = strategy
        return self

    def set_savepoint_restore(self, path: str,
                              allow_non_restored_state: bool = False
                              ) -> "StreamExecutionEnvironment":
        """Start the next execution from the savepoint at ``path`` (a
        file of either package).  At another parallelism keyed state
        re-splits by key-group range.  State whose operator uid matches
        nothing in the job fails the restore unless
        ``allow_non_restored_state``."""
        self.savepoint_restore_path = path
        self.allow_non_restored_state = allow_non_restored_state
        return self

    def set_max_parallelism(self, max_parallelism: int) -> "StreamExecutionEnvironment":
        self.max_parallelism = max_parallelism
        return self

    # ---- sources ----------------------------------------------------
    def add_source(self, source_function: SourceFunction,
                   name: str = "source", parallelism: int = 1) -> "DataStream":
        node = self.graph.add_node(StreamNode(
            self.graph.new_node_id(), name,
            _source_factory(source_function, self.time_characteristic),
            parallelism=parallelism, max_parallelism=self.max_parallelism,
            is_source=True))
        return DataStream(self, node)

    def from_collection(self, items: Iterable[Any],
                        timestamped: bool = False) -> "DataStream":
        return self.add_source(
            FromCollectionSource(list(items), timestamped=timestamped),
            name="from_collection")

    def from_elements(self, *items) -> "DataStream":
        return self.from_collection(list(items))

    def socket_text_stream(self, hostname: str, port: int,
                           delimiter: str = "\n",
                           max_retries: int = 0) -> "DataStream":
        return self.add_source(
            SocketTextStreamSource(hostname, port, delimiter, max_retries),
            name="socket_source")

    def read_text_file(self, path: str) -> "DataStream":
        return self.add_source(FileTextSource(path), name="file_source")

    # ---- execution --------------------------------------------------
    def get_stream_graph(self) -> StreamGraph:
        return self.graph

    def get_job_graph(self):
        for node in self._two_phase_sinks:
            if node.parallelism > 1:
                # its subtasks would share one function and its open
                # transaction: one subtask's barrier would pre-commit
                # records another processed after its own barrier
                raise ValueError(
                    f"two-phase commit sink {node.name!r} runs at "
                    f"parallelism {node.parallelism}; it needs 1")
        jg = create_job_graph(self.graph)
        if self.checkpoint_config is not None:
            jg.checkpoint_config = {**self.checkpoint_config,
                                    **self.checkpoint_storage}
        jg.savepoint_restore_path = self.savepoint_restore_path
        jg.allow_non_restored_state = self.allow_non_restored_state
        return jg

    def set_latency_tracking_interval(self, interval_ms: Optional[int]
                                      ) -> "StreamExecutionEnvironment":
        """Sources emit a ``LatencyMarker`` every ``interval_ms``; each
        subtask it reaches records its age in the job's ``latency``
        histograms."""
        self.latency_tracking_interval = interval_ms
        return self

    def get_metric_registry(self):
        """The registry of the last executor (filled by ``execute`` /
        ``execute_async``), or None before the first."""
        return self._last_executor.metrics if self._last_executor else None

    def enable_tracing(self, enabled: bool = True
                       ) -> "StreamExecutionEnvironment":
        """Turn the process-wide tracer on (or off): operator, device
        flush and fire, host-runtime, CUDA launch and checkpoint spans
        land in its Chrome trace-event ring.  Export after the job with
        ``env.get_tracer().write_chrome_trace(path)``."""
        from flink_tpu_torch.runtime.tracing import get_tracer
        get_tracer().enabled = enabled
        return self

    def get_tracer(self):
        """The process-wide ``runtime.tracing.Tracer``."""
        from flink_tpu_torch.runtime.tracing import get_tracer
        return get_tracer()

    def _make_executor(self, job_name: str):
        from flink_tpu_torch.core.config import MetricOptions
        from flink_tpu_torch.runtime.local import LocalExecutor
        self.graph.job_name = job_name
        self._last_executor = LocalExecutor(
            state_backend=self.config, device=self.device,
            restart_strategy=self.restart_strategy,
            processing_time_service=self.processing_time_service,
            failover_strategy=self.failover_strategy,
            latency_interval_ms=self.latency_tracking_interval,
            sample_interval_ms=self.config.get_integer(
                MetricOptions.SAMPLE_INTERVAL_MS),
            metrics_history_size=self.config.get_integer(
                MetricOptions.HISTORY_SIZE,
                MetricOptions.HISTORY_SIZE_DEFAULT))
        return self._last_executor

    def execute(self, job_name: str = "job"):
        return self._make_executor(job_name).execute(self.get_job_graph())

    def execute_async(self, job_name: str = "job"):
        """Run the job on a thread of its own; returns its
        ``JobClient``.  No torch work may run on the caller's thread
        until the job ends (see ``LocalExecutor.execute_async``)."""
        return self._make_executor(job_name).execute_async(self.get_job_graph())


def _source_factory(source_function: SourceFunction,
                    time_characteristic: str):
    """A fresh copy of the function for every subtask and attempt."""
    def factory():
        return StreamSource(copy.deepcopy(source_function),
                            time_characteristic)
    return factory


def _op_factory(cls, fn_factory):
    def factory():
        return cls(fn_factory())
    return factory


class DataStream:
    def __init__(self, env: StreamExecutionEnvironment, node: StreamNode,
                 partitioner: Optional[StreamPartitioner] = None,
                 side_tag=None):
        self.env = env
        self.node = node
        #: partitioner for the next edge out of this stream
        self._partitioner = partitioner
        #: set: edges out of this stream carry this side output
        self._side_tag = side_tag

    def _edge_partitioner(self, target_parallelism: int) -> StreamPartitioner:
        """The next edge's partitioner: the stream's own (keyBy), else
        forward between equal parallelism and round robin otherwise."""
        if self._partitioner is not None:
            return self._partitioner
        if self.node.parallelism == target_parallelism:
            return ForwardPartitioner()
        return RebalancePartitioner()

    def _add_op(self, name: str, operator_factory, key_selector=None,
                chaining: str = "always",
                parallelism: Optional[int] = None,
                extra_inputs: Optional[List["DataStream"]] = None
                ) -> "DataStream":
        """A node fed by this stream (input 0) and by each of
        ``extra_inputs`` (inputs 1, 2, ...)."""
        p = self.env.parallelism if parallelism is None else parallelism
        node = self.env.graph.add_node(StreamNode(
            self.env.graph.new_node_id(), name, operator_factory,
            parallelism=p, max_parallelism=self.env.max_parallelism,
            key_selector=key_selector, chaining_strategy=chaining))
        self.env.graph.add_edge(StreamEdge(
            self.node.id, node.id, self._edge_partitioner(p),
            side_output_tag=self._side_tag))
        for i, other in enumerate(extra_inputs or [], start=1):
            self.env.graph.add_edge(StreamEdge(
                other.node.id, node.id, other._edge_partitioner(p), i,
                side_output_tag=other._side_tag))
        return DataStream(self.env, node)

    def map(self, fn, name: str = "map") -> "DataStream":
        f = as_map_function(fn)
        return self._add_op(name, _op_factory(StreamMap, lambda: f))

    def flat_map(self, fn, name: str = "flat_map") -> "DataStream":
        f = as_flat_map_function(fn)
        return self._add_op(name, _op_factory(StreamFlatMap, lambda: f))

    def filter(self, fn, name: str = "filter") -> "DataStream":
        f = as_filter_function(fn)
        return self._add_op(name, _op_factory(StreamFilter, lambda: f))

    def process(self, process_function, name: str = "process") -> "DataStream":
        """``process_function.process_element(value, ctx, out)`` per
        element (a ``ProcessFunction``)."""
        return self._add_op(name, _op_factory(ProcessOperator,
                                              lambda: process_function))

    def disable_chaining(self) -> "DataStream":
        """This operator chains to neither neighbour."""
        self.node.chaining_strategy = "never"
        return self

    def start_new_chain(self) -> "DataStream":
        """This operator heads a new chain; later operators may chain
        to it."""
        self.node.chaining_strategy = "head"
        return self

    # ---- partitioning of the next edge -------------------------------
    def rebalance(self) -> "DataStream":
        return DataStream(self.env, self.node, RebalancePartitioner(),
                          self._side_tag)

    def rescale(self) -> "DataStream":
        return DataStream(self.env, self.node, RescalePartitioner(),
                          self._side_tag)

    def shuffle(self) -> "DataStream":
        return DataStream(self.env, self.node, ShufflePartitioner(),
                          self._side_tag)

    def broadcast(self, *broadcast_state_descriptors):
        """Every record to every downstream subtask.  With
        ``MapStateDescriptor``s: a ``BroadcastStream`` for the broadcast
        state pattern (``connect`` it to a data stream)."""
        bs = DataStream(self.env, self.node, BroadcastPartitioner(),
                        self._side_tag)
        if broadcast_state_descriptors:
            return BroadcastStream(bs, broadcast_state_descriptors)
        return bs

    def global_(self) -> "DataStream":
        return DataStream(self.env, self.node, GlobalPartitioner(),
                          self._side_tag)

    def forward(self) -> "DataStream":
        return DataStream(self.env, self.node, ForwardPartitioner(),
                          self._side_tag)

    def partition_custom(self, partitioner, key_selector=None) -> "DataStream":
        """``partitioner(key, num_channels)`` picks each record's
        channel; the key is ``key_selector``'s, or the whole record."""
        ks = as_key_selector(key_selector) if key_selector is not None else None
        return DataStream(self.env, self.node,
                          CustomPartitionerWrapper(partitioner, ks),
                          self._side_tag)

    # ---- joins ---------------------------------------------------------
    def join(self, other: "DataStream"):
        """``.where(k1).equal_to(k2).window(assigner).apply(fn)``:
        ``fn(left, right)`` per pair of equal keys in one window."""
        from flink_tpu_torch.streaming.joining import JoinedStreams
        return JoinedStreams(self, other)

    def co_group(self, other: "DataStream"):
        """As ``join``, with ``fn(lefts, rights)`` once per key and
        window."""
        from flink_tpu_torch.streaming.joining import CoGroupedStreams
        return CoGroupedStreams(self, other)

    def interval_join(self, other: "DataStream"):
        """``.where(k1).equal_to(k2).between(lower_ms, upper_ms)
        .apply(fn)``: ``fn(l, r)`` for every pair of equal keys with
        r.ts - l.ts in [lower, upper], stamped with the later time."""
        from flink_tpu_torch.streaming.joining import IntervalJoinedStreams
        return IntervalJoinedStreams(self, other)

    def connect(self, other):
        """Two streams into one two-input operator:
        ``ConnectedStreams`` (co-map, co-flat-map, co-process), or with a
        ``BroadcastStream`` a ``BroadcastConnectedStream``."""
        if isinstance(other, BroadcastStream):
            return BroadcastConnectedStream(self.env, self, other)
        return ConnectedStreams(self.env, self, other)

    def split(self, output_selector) -> "SplitStream":
        """``output_selector(value)`` names each record's routes;
        ``select(*names)`` keeps the records routed to any of them."""
        return SplitStream(self.env, self.node, output_selector,
                           partitioner=self._partitioner,
                           side_tag=self._side_tag)

    def iterate(self) -> "IterativeStream":
        """The iteration head, an identity map of its own vertex; wire
        the loop with ``close_with(feedback)``.  Records on the back
        edge go round until they leave the loop; the back edge carries
        no barrier and no end of stream (an iteration is outside the
        exactly-once guarantee)."""
        head = self._add_op("iteration_head",
                            _op_factory(StreamMap,
                                        lambda: as_map_function(lambda v: v)),
                            chaining="never")
        return IterativeStream(self.env, head.node)

    def union(self, *streams: "DataStream") -> "DataStream":
        """One stream of this one and ``streams``: a pass-through node
        with an input channel from each."""
        f = as_map_function(lambda x: x)
        node = self.env.graph.add_node(StreamNode(
            self.env.graph.new_node_id(), "union",
            _op_factory(StreamMap, lambda: f),
            parallelism=self.node.parallelism,
            max_parallelism=self.env.max_parallelism,
            chaining_strategy="never"))
        for s in (self,) + streams:
            self.env.graph.add_edge(StreamEdge(
                s.node.id, node.id, s._edge_partitioner(node.parallelism),
                side_output_tag=s._side_tag))
        return DataStream(self.env, node)

    def set_parallelism(self, parallelism: int) -> "DataStream":
        """This operator's parallelism; a node of another parallelism
        than its neighbours gets a vertex of its own."""
        self.node.parallelism = parallelism
        return self

    def get_side_output(self, tag) -> "DataStream":
        """The side output ``tag`` of this stream's operator."""
        return DataStream(self.env, self.node, side_tag=tag)

    def name(self, name: str) -> "DataStream":
        self.node.name = name
        return self

    def uid(self, uid: str) -> "DataStream":
        self.node.uid = uid
        return self

    def key_by(self, key_selector) -> "KeyedStream":
        return KeyedStream(self.env, self.node, as_key_selector(key_selector),
                           self._side_tag)

    # ---- windows over a stream without keys --------------------------
    def window_all(self, assigner: WindowAssigner) -> "AllWindowedStream":
        """Every record into one key: the window runs at parallelism 1."""
        return AllWindowedStream(self.key_by(lambda x: 0), assigner)

    def count_window_all(self, size: int) -> "AllWindowedStream":
        ws = AllWindowedStream(self.key_by(lambda x: 0), GlobalWindows.create())
        ws._trigger = PurgingTrigger.of(CountTrigger(size))
        return ws

    def assign_timestamps_and_watermarks(self, assigner,
                                         watermark_interval: int = 1) -> "DataStream":
        return self._add_op(
            "timestamps",
            lambda: TimestampsAndWatermarksOperator(assigner, watermark_interval))

    def add_sink(self, sink_function, name: str = "sink") -> "DataStreamSink":
        # a Table's to_retract_stream() marks its stream; a sink that
        # decodes retract pairs learns it here (plain streams are never
        # sniffed for pair-shaped values)
        if getattr(self, "carries_retract_pairs", False) and \
                hasattr(sink_function, "enable_retract_decoding"):
            sink_function.enable_retract_decoding()
        node = self._add_op(name, _op_factory(StreamSink, lambda: sink_function))
        if isinstance(sink_function, TwoPhaseCommitSinkFunction):
            self.env._two_phase_sinks.append(node.node)
        return DataStreamSink(node)

    def print_(self, prefix: str = "") -> "DataStreamSink":
        return self.add_sink(PrintSink(prefix), name="print")

    def write_as_text(self, path: str) -> "DataStreamSink":
        return self.add_sink(WriteAsTextSink(path), name="write_text")

    def collect_into(self, target: list) -> "DataStreamSink":
        return self.add_sink(CollectSink(target), name="collect")


class DataStreamSink:
    def __init__(self, stream: DataStream):
        self._stream = stream
        self.node = stream.node

    def set_parallelism(self, parallelism: int) -> "DataStreamSink":
        self.node.parallelism = parallelism
        return self

    def name(self, name: str) -> "DataStreamSink":
        self.node.name = name
        return self


class KeyedStream(DataStream):
    def __init__(self, env, node, key_selector, side_tag=None):
        super().__init__(env, node,
                         KeyGroupStreamPartitioner(key_selector, env.max_parallelism),
                         side_tag)
        self.key_selector = key_selector

    def _add_keyed_op(self, name: str, operator_factory) -> DataStream:
        return self._add_op(name, operator_factory,
                            key_selector=self.key_selector)

    def process(self, process_function, name: str = "keyed_process") -> DataStream:
        """A ``ProcessFunction`` with keyed state and timers."""
        return self._add_keyed_op(
            name, _op_factory(KeyedProcessOperator, lambda: process_function))

    def as_queryable_state(self, name: str, descriptor=None) -> DataStream:
        """Keep the stream's latest value per key (or, with an
        aggregating or reducing descriptor, its aggregate) queryable as
        ``name`` while the job runs: ``runtime.queryable.
        QueryableStateClient().get_kv_state(name, key)``.  Reads are
        dirty, as the reference's.  On the GPU backend an aggregating
        descriptor of a device aggregate is read on the card."""
        from flink_tpu_torch.core.state import ValueStateDescriptor
        from flink_tpu_torch.runtime.queryable import DEFAULT_REGISTRY

        desc = descriptor or ValueStateDescriptor(name)
        desc.set_queryable(name)

        class _QueryableOp(KeyedProcessOperator):
            def open(self):
                super().open()
                self._qstate = self.keyed_backend.get_or_create_keyed_state(desc)
                DEFAULT_REGISTRY.register(
                    name, self.keyed_backend.key_group_range,
                    self.keyed_backend, desc)

            def process_element(self, record):
                self._qstate.set_current_namespace(VOID_NAMESPACE)
                if hasattr(self._qstate, "update"):
                    self._qstate.update(record.value)
                else:
                    self._qstate.add(record.value)

            def close(self):
                # device states micro-batch their adds: the final values
                # become visible to queries when the task stops
                flush_all = getattr(self.keyed_backend, "flush_all", None)
                if flush_all is not None:
                    flush_all()
                super().close()

        class _Noop:
            def process_element(self, value, ctx, out):
                pass

        return self._add_keyed_op(f"queryable-{name}",
                                  lambda: _QueryableOp(_Noop()))

    def reduce(self, fn, name: str = "reduce") -> DataStream:
        """The running reduction of each key, emitted per element."""
        f = as_reduce_function(fn)
        return self._add_keyed_op(name, _op_factory(StreamGroupedReduce,
                                                    lambda: f))

    def sum(self, field=None) -> DataStream:
        return self.reduce(_field_reduce(field, lambda a, b: a + b), name="sum")

    def min(self, field=None) -> DataStream:
        return self.reduce(_field_reduce(field, min), name="min")

    def max(self, field=None) -> DataStream:
        return self.reduce(_field_reduce(field, max), name="max")

    def min_by(self, field) -> DataStream:
        """The element with the least ``field`` so far (the earlier one
        on a tie)."""
        getter = _field_getter(field)
        return self.reduce(lambda a, b: a if getter(a) <= getter(b) else b,
                           name="min_by")

    def max_by(self, field) -> DataStream:
        getter = _field_getter(field)
        return self.reduce(lambda a, b: a if getter(a) >= getter(b) else b,
                           name="max_by")

    def window(self, assigner: WindowAssigner) -> "WindowedStream":
        return WindowedStream(self, assigner)

    def time_window(self, size: Time, slide: Optional[Time] = None
                    ) -> "WindowedStream":
        """Tumbling windows, sliding ones with ``slide``: of processing
        time under the ``processing`` characteristic, else of event
        time."""
        if self.env.time_characteristic == "processing":
            assigner = (TumblingProcessingTimeWindows.of(size) if slide is None
                        else SlidingProcessingTimeWindows.of(size, slide))
        else:
            assigner = (TumblingEventTimeWindows.of(size) if slide is None
                        else SlidingEventTimeWindows.of(size, slide))
        return WindowedStream(self, assigner)

    def count_window(self, size: int, slide: Optional[int] = None
                     ) -> "WindowedStream":
        """Windows of ``size`` elements per key; with ``slide``, a
        window of the newest ``size`` elements every ``slide``."""
        ws = WindowedStream(self, GlobalWindows.create())
        if slide is None:
            ws._trigger = PurgingTrigger.of(CountTrigger(size))
        else:
            ws._trigger = CountTrigger(slide)
            ws._evictor = CountEvictor.of(size)
        return ws


def _field_getter(field):
    """Field ``field`` of an element: a tuple or list position, an
    attribute, a callable's result, or the element itself when None."""
    if field is None:
        return lambda x: x
    if callable(field):
        return field
    return lambda x: x[field] if isinstance(x, (tuple, list)) else getattr(x, field)


def _field_reduce(field, combine):
    """A reduce function combining field ``field`` of two elements (a
    tuple or list position, or an attribute; the whole element when
    None) and keeping the first element's other fields."""
    if field is None:
        return lambda a, b: combine(a, b)

    def reducer(a, b):
        if isinstance(a, tuple):
            lst = list(a)
            lst[field] = combine(a[field], b[field])
            return tuple(lst)
        if isinstance(a, list):
            lst = list(a)
            lst[field] = combine(a[field], b[field])
            return lst
        setattr(a, field, combine(getattr(a, field), getattr(b, field)))
        return a

    return reducer


class WindowedStream:
    def __init__(self, keyed: KeyedStream, assigner: WindowAssigner):
        self._keyed = keyed
        self._assigner = assigner
        self._trigger = None
        self._evictor = None
        self._allowed_lateness = 0
        self._late_tag = None
        self._device_enabled = True

    def disable_device_operator(self) -> "WindowedStream":
        """Run on WindowOperator over the keyed backend even where a
        device window engine or the generic tier would take the
        aggregate."""
        self._device_enabled = False
        return self

    def trigger(self, trigger) -> "WindowedStream":
        """Replace the assigner's default trigger (takes the stream off
        the device and generic tiers)."""
        self._trigger = trigger
        return self

    def evictor(self, evictor) -> "WindowedStream":
        """Keep the raw elements and evict before the window function
        (``EvictingWindowOperator``)."""
        self._evictor = evictor
        return self

    def allowed_lateness(self, lateness) -> "WindowedStream":
        self._allowed_lateness = (lateness.milliseconds
                                  if isinstance(lateness, Time) else int(lateness))
        return self

    def side_output_late_data(self, tag) -> "WindowedStream":
        """Records too late for every window go to side output ``tag``
        (``get_side_output(tag)`` on the result) instead of being
        dropped."""
        self._late_tag = tag
        return self

    def _build(self, name, state_descriptor, window_function,
               single_value=None) -> DataStream:
        """WindowOperator over the keyed backend, or
        EvictingWindowOperator when an evictor is set."""
        keyed = self._keyed
        assigner, trigger, evictor = self._assigner, self._trigger, self._evictor
        lateness, late_tag = self._allowed_lateness, self._late_tag
        if evictor is not None:
            pre = _pre_aggregator_for(state_descriptor) if single_value else None

            def factory():
                return EvictingWindowOperator(assigner, window_function,
                                              trigger, evictor, lateness,
                                              late_tag, pre_aggregator=pre)
        else:
            def factory():
                return WindowOperator(assigner, state_descriptor,
                                      window_function, trigger, lateness,
                                      late_tag,
                                      single_value_contents=single_value)
        return keyed._add_op(name, factory, key_selector=keyed.key_selector,
                             chaining="head")

    # ---- terminal operations ----------------------------------------
    def aggregate(self, aggregate_function: AggregateFunction,
                  window_function=None, name: str = "window_aggregate") -> DataStream:
        """The device engines for an eligible DeviceAggregateFunction,
        the generic tier for any other aggregate on the same window
        shapes, else WindowOperator (see the module docstring)."""
        keyed = self._keyed
        assigner = self._assigner
        gate = (assigner, aggregate_function, self._trigger, self._evictor,
                self._allowed_lateness, self._late_tag, window_function)
        if self._device_enabled and is_device_eligible(*gate):
            device = keyed.env.device
            mesh, mesh_axis = keyed.env.mesh, keyed.env.mesh_axis
            if not isinstance(assigner, TumblingEventTimeWindows):
                mesh = None  # only tumbling windows shard over the mesh

            def factory():
                return DeviceWindowOperator(assigner, aggregate_function,
                                            window_function, device=device,
                                            mesh=mesh, mesh_axis=mesh_axis)
            if mesh is not None and not is_mesh_factory(mesh):
                # the mesh is the parallelism: one subtask drives every
                # shard; the keyed edge still routes (to that subtask)
                return keyed._add_op(name, factory,
                                     key_selector=keyed.key_selector,
                                     chaining="head", parallelism=1)
            return keyed._add_op(name, factory,
                                 key_selector=keyed.key_selector,
                                 chaining="head")
        if self._device_enabled and is_generic_eligible(*gate):
            def gfactory():
                return GenericWindowOperator(assigner, aggregate_function,
                                             window_function)
            return keyed._add_op(name, gfactory,
                                 key_selector=keyed.key_selector,
                                 chaining="head")
        return self._build(name, AggregatingStateDescriptor(
            "window-contents", aggregate_function), window_function,
            single_value=True)

    def reduce(self, fn, window_function=None,
               name: str = "window_reduce") -> DataStream:
        return self._build(name, ReducingStateDescriptor(
            "window-contents", as_reduce_function(fn)), window_function,
            single_value=True)

    def fold(self, initial_value, fold_function,
             window_function=None) -> DataStream:
        return self._build("window_fold", FoldingStateDescriptor(
            "window-contents", initial_value, fold_function),
            window_function, single_value=True)

    def apply(self, window_function, name: str = "window_apply") -> DataStream:
        """``window_function`` over the window's elements (a
        WindowFunction, a ProcessWindowFunction or a callable(key,
        window, elements) -> iterable)."""
        return self._build(name, ListStateDescriptor("window-contents"),
                           window_function, single_value=False)

    def process(self, process_window_function,
                name: str = "window_process") -> DataStream:
        return self._build(name, ListStateDescriptor("window-contents"),
                           process_window_function, single_value=False)

    def sum(self, field=None) -> DataStream:
        return self.reduce(_field_reduce(field, lambda a, b: a + b),
                           name="window_sum")

    def min(self, field=None) -> DataStream:
        return self.reduce(_field_reduce(field, min), name="window_min")

    def max(self, field=None) -> DataStream:
        return self.reduce(_field_reduce(field, max), name="window_max")


def _pre_aggregator_for(state_descriptor):
    """The fire-time aggregation over raw elements on the evictor path:
    the descriptor's reduce, aggregate or fold over the elements the
    evictor kept."""
    if isinstance(state_descriptor, ReducingStateDescriptor):
        reduce = state_descriptor.reduce_function.reduce

        def pre(values):
            it = iter(values)
            acc = next(it)
            for v in it:
                acc = reduce(acc, v)
            return acc
        return pre
    if isinstance(state_descriptor, AggregatingStateDescriptor):
        agg = state_descriptor.aggregate_function

        def pre(values):
            acc = agg.create_accumulator()
            for v in values:
                acc = agg.add(v, acc)
            return agg.get_result(acc)
        return pre
    if isinstance(state_descriptor, FoldingStateDescriptor):
        fold = state_descriptor.fold_function

        def pre(values):
            acc = state_descriptor.get_default_value()
            for v in values:
                acc = fold(acc, v)
            return acc
        return pre
    return None


class AllWindowedStream(WindowedStream):
    """Windows over a stream without keys (``window_all``): every record
    has key 0, and the window operator runs at parallelism 1."""

    def _build(self, name, state_descriptor, window_function,
               single_value=None) -> DataStream:
        stream = super()._build(name, state_descriptor, window_function,
                                single_value)
        stream.node.parallelism = 1
        return stream


class ConnectedStreams:
    """Two streams into one two-input operator; ``key_by(k1, k2)`` keys
    both (the operator then has keyed state and timers, each input with
    its own key selector)."""

    def __init__(self, env, first: DataStream, second: DataStream):
        self.env = env
        self.first = first
        self.second = second

    def _add_two_input(self, name, factory) -> DataStream:
        ks1 = getattr(self.first, "key_selector", None)
        ks2 = getattr(self.second, "key_selector", None)

        def wrapped_factory():
            op = factory()
            if hasattr(op, "key_selector2"):
                op.key_selector2 = ks2
            return op

        return self.first._add_op(name, wrapped_factory, key_selector=ks1,
                                  chaining="never",
                                  extra_inputs=[self.second])

    def map(self, co_map_function) -> DataStream:
        return self._add_two_input("co_map",
                                   lambda: CoStreamMap(co_map_function))

    def flat_map(self, co_flat_map_function) -> DataStream:
        return self._add_two_input(
            "co_flat_map", lambda: CoStreamFlatMap(co_flat_map_function))

    def process(self, co_process_function) -> DataStream:
        return self._add_two_input(
            "co_process", lambda: CoProcessOperator(co_process_function))

    def key_by(self, key_selector1, key_selector2) -> "ConnectedStreams":
        return ConnectedStreams(self.env, self.first.key_by(key_selector1),
                                self.second.key_by(key_selector2))


class SplitStream(DataStream):
    """A stream whose records carry route names; ``select`` is a filter
    on them."""

    def __init__(self, env, node, output_selector, partitioner=None,
                 side_tag=None):
        super().__init__(env, node, partitioner, side_tag)
        self._selector = output_selector

    def select(self, *names: str) -> DataStream:
        wanted = set(names)
        selector = self._selector

        def keep(value):
            return any(r in wanted for r in (selector(value) or ()))

        return self.filter(keep, name=f"select[{','.join(names)}]")


class IterativeStream(DataStream):
    """The iteration head: consumed like any stream, and
    ``close_with(feedback)`` adds the back edge into it."""

    def close_with(self, feedback: DataStream) -> DataStream:
        partitioner = (ForwardPartitioner()
                       if feedback.node.parallelism == self.node.parallelism
                       else RebalancePartitioner())
        edge = StreamEdge(feedback.node.id, self.node.id, partitioner, 0)
        edge.is_feedback = True
        self.env.graph.add_edge(edge)
        return feedback


class BroadcastStream:
    """A broadcast-partitioned stream and the broadcast state
    descriptors its records update."""

    def __init__(self, stream: DataStream, descriptors):
        self.stream = stream
        self.descriptors = tuple(descriptors)


class BroadcastConnectedStream:
    """A data stream (input 1, keyed or not) connected to a broadcast
    stream (input 2); ``process`` takes a (Keyed)BroadcastProcessFunction."""

    def __init__(self, env, data_stream: DataStream,
                 broadcast: BroadcastStream):
        self.env = env
        self.data = data_stream
        self.broadcast = broadcast

    def process(self, fn, name: str = "broadcast_process") -> DataStream:
        ks = getattr(self.data, "key_selector", None)
        return self.data._add_op(name, lambda: CoBroadcastOperator(fn),
                                 key_selector=ks, chaining="never",
                                 extra_inputs=[self.broadcast.stream])


class AsyncDataStream:
    """Async I/O: ``ordered_wait`` emits results in input order,
    ``unordered_wait`` as they complete; at most ``capacity`` requests
    in flight, each failing after ``timeout_ms`` (None: never)."""

    @staticmethod
    def ordered_wait(stream: DataStream, async_function,
                     timeout_ms: Optional[int] = None,
                     capacity: int = 100) -> DataStream:
        return AsyncDataStream._wait(stream, async_function, timeout_ms,
                                     capacity, ordered=True)

    @staticmethod
    def unordered_wait(stream: DataStream, async_function,
                       timeout_ms: Optional[int] = None,
                       capacity: int = 100) -> DataStream:
        return AsyncDataStream._wait(stream, async_function, timeout_ms,
                                     capacity, ordered=False)

    @staticmethod
    def _wait(stream, fn, timeout_ms, capacity, ordered):
        mode = "ordered" if ordered else "unordered"
        return stream._add_op(
            f"async_wait_{mode}",
            lambda: AsyncWaitOperator(fn, capacity=capacity,
                                      timeout_ms=timeout_ms, ordered=ordered),
            chaining="head")
