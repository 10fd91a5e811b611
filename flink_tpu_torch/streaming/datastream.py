"""DataStream API (port of ``flink_tpu/streaming/datastream.py:90-500,
512-760, 787-1015``):

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
``Configuration``).  ``WindowedStream.aggregate`` routes as the
reference does: a device-eligible aggregate (a DeviceAggregateFunction,
default trigger, lateness 0, no late-data tag) runs on
``DeviceWindowOperator``, anything else on ``WindowOperator`` over the
keyed backend.  The reference's two other routes are not ported and
raise ``NotImplementedError``: its device engines for sliding and
session windows, and ``GenericWindowOperator`` for other aggregates
over the same window shapes; ``disable_device_operator()`` sends
either to ``WindowOperator``.
"""

from __future__ import annotations

import copy
from typing import Any, Iterable, Optional

from flink_tpu_torch.core.config import Configuration
from flink_tpu_torch.core.functions import AggregateFunction, as_key_selector
from flink_tpu_torch.core.state import AggregatingStateDescriptor
from flink_tpu_torch.device import DeviceLike, resolve_device
from flink_tpu_torch.ops.device_agg import DeviceAggregateFunction
from flink_tpu_torch.streaming.device_window_operator import (
    DeviceWindowOperator, assigner_supported, batch_window_eligible)
from flink_tpu_torch.streaming.graph import (StreamEdge, StreamGraph,
                                             StreamNode, create_job_graph)
from flink_tpu_torch.streaming.operators import StreamSink
from flink_tpu_torch.streaming.partitioners import (ForwardPartitioner,
                                                    KeyGroupStreamPartitioner,
                                                    StreamPartitioner)
from flink_tpu_torch.streaming.sources import (CollectSink,
                                               FromCollectionSource, PrintSink,
                                               SourceFunction, StreamSource,
                                               TimestampsAndWatermarksOperator)
from flink_tpu_torch.streaming.window_operator import WindowOperator
from flink_tpu_torch.streaming.windowing import (Time, TumblingEventTimeWindows,
                                                 WindowAssigner)


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
        self.parallelism = 1
        self.max_parallelism = 128
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

    def set_parallelism(self, parallelism: int) -> "StreamExecutionEnvironment":
        self.parallelism = parallelism
        return self

    def set_max_parallelism(self, max_parallelism: int) -> "StreamExecutionEnvironment":
        self.max_parallelism = max_parallelism
        return self

    # ---- sources ----------------------------------------------------
    def add_source(self, source_function: SourceFunction,
                   name: str = "source") -> "DataStream":
        def factory():
            return StreamSource(copy.deepcopy(source_function))
        node = self.graph.add_node(StreamNode(
            self.graph.new_node_id(), name, factory, parallelism=1,
            max_parallelism=self.max_parallelism, is_source=True))
        return DataStream(self, node)

    def from_collection(self, items: Iterable[Any],
                        timestamped: bool = False) -> "DataStream":
        return self.add_source(
            FromCollectionSource(list(items), timestamped=timestamped),
            name="from_collection")

    def from_elements(self, *items) -> "DataStream":
        return self.from_collection(list(items))

    # ---- execution --------------------------------------------------
    def get_stream_graph(self) -> StreamGraph:
        return self.graph

    def get_job_graph(self):
        return create_job_graph(self.graph)

    def execute(self, job_name: str = "job"):
        from flink_tpu_torch.runtime.local import LocalExecutor
        self.graph.job_name = job_name
        self._last_executor = LocalExecutor(state_backend=self.config,
                                            device=self.device)
        return self._last_executor.execute(self.get_job_graph())


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

    def _add_op(self, name: str, operator_factory, key_selector=None,
                chaining: str = "always") -> "DataStream":
        node = self.env.graph.add_node(StreamNode(
            self.env.graph.new_node_id(), name, operator_factory,
            parallelism=self.env.parallelism,
            max_parallelism=self.env.max_parallelism,
            key_selector=key_selector, chaining_strategy=chaining))
        self.env.graph.add_edge(StreamEdge(
            self.node.id, node.id, self._partitioner or ForwardPartitioner(),
            side_output_tag=self._side_tag))
        return DataStream(self.env, node)

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

    def assign_timestamps_and_watermarks(self, assigner,
                                         watermark_interval: int = 1) -> "DataStream":
        return self._add_op(
            "timestamps",
            lambda: TimestampsAndWatermarksOperator(assigner, watermark_interval))

    def add_sink(self, sink_function, name: str = "sink") -> "DataStreamSink":
        node = self._add_op(name, _op_factory(StreamSink, lambda: sink_function))
        return DataStreamSink(node)

    def print_(self, prefix: str = "") -> "DataStreamSink":
        return self.add_sink(PrintSink(prefix), name="print")

    def collect_into(self, target: list) -> "DataStreamSink":
        return self.add_sink(CollectSink(target), name="collect")


class DataStreamSink:
    def __init__(self, stream: DataStream):
        self._stream = stream
        self.node = stream.node

    def name(self, name: str) -> "DataStreamSink":
        self.node.name = name
        return self


class KeyedStream(DataStream):
    def __init__(self, env, node, key_selector, side_tag=None):
        super().__init__(env, node,
                         KeyGroupStreamPartitioner(key_selector, env.max_parallelism),
                         side_tag)
        self.key_selector = key_selector

    def window(self, assigner: WindowAssigner) -> "WindowedStream":
        return WindowedStream(self, assigner)

    def time_window(self, size: Time) -> "WindowedStream":
        return WindowedStream(self, TumblingEventTimeWindows.of(size))


class WindowedStream:
    def __init__(self, keyed: KeyedStream, assigner: WindowAssigner):
        self._keyed = keyed
        self._assigner = assigner
        self._allowed_lateness = 0
        self._late_tag = None
        self._device_enabled = True

    def disable_device_operator(self) -> "WindowedStream":
        """Run on WindowOperator over the keyed backend even where a
        device window engine or the generic tier would take the
        aggregate."""
        self._device_enabled = False
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

    def aggregate(self, aggregate_function: AggregateFunction,
                  window_function=None, name: str = "window_aggregate") -> DataStream:
        keyed = self._keyed
        assigner = self._assigner
        lateness, late_tag = self._allowed_lateness, self._late_tag
        batch = self._device_enabled and batch_window_eligible(
            assigner, lateness, late_tag, window_function)
        if batch and isinstance(aggregate_function, DeviceAggregateFunction):
            if not assigner_supported(assigner):
                raise NotImplementedError(
                    f"the device window engine for {assigner!r} is not "
                    "ported (the port's engine covers tumbling windows); "
                    ".disable_device_operator() runs this aggregate on "
                    "WindowOperator")
            device = keyed.env.device

            def factory():
                return DeviceWindowOperator(assigner, aggregate_function,
                                            window_function, device=device)
        elif batch:
            raise NotImplementedError(
                "GenericWindowOperator, the reference's vectorized tier for "
                "aggregates that are not device aggregates, is not ported by "
                "slice 2; .disable_device_operator() runs this aggregate on "
                "WindowOperator")
        else:
            descriptor = AggregatingStateDescriptor("window-contents",
                                                    aggregate_function)

            def factory():
                return WindowOperator(assigner, descriptor, window_function,
                                      allowed_lateness=lateness,
                                      late_data_tag=late_tag,
                                      single_value_contents=True)
        return keyed._add_op(name, factory, key_selector=keyed.key_selector,
                             chaining="head")

