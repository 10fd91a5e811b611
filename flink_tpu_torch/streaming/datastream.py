"""DataStream API (port of ``flink_tpu/streaming/datastream.py:90-500,
512-760, 787-975``, the slice-1 surface):

    env = StreamExecutionEnvironment.get_execution_environment()
    (env.from_collection(events)
        .assign_timestamps_and_watermarks(BoundedOutOfOrdernessTimestampExtractor(0, ts_of))
        .key_by(key_of)
        .window(TumblingEventTimeWindows.of(1000))
        .aggregate(HyperLogLogAggregate(12), window_function)
        .add_sink(CollectSink(out)))
    env.execute()

The environment runs on the card unless it is created with
``device="cpu"``.  ``WindowedStream.aggregate`` takes the device branch
only; any other aggregate raises ``NotImplementedError`` (the scalar
WindowOperator on a keyed-state backend is slice 2).
"""

from __future__ import annotations

import copy
from typing import Any, Iterable, Optional

from flink_tpu_torch.core.functions import AggregateFunction, as_key_selector
from flink_tpu_torch.device import DeviceLike, resolve_device
from flink_tpu_torch.streaming.device_window_operator import (
    DeviceWindowOperator, is_device_eligible)
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
from flink_tpu_torch.streaming.windowing import (Time, TumblingEventTimeWindows,
                                                 WindowAssigner)


class StreamExecutionEnvironment:
    """Builds the stream graph and executes it locally."""

    def __init__(self, *, device: DeviceLike = None):
        #: where device window state lives (the card unless "cpu")
        self.device = resolve_device(device)
        self.graph = StreamGraph()
        self.parallelism = 1
        self.max_parallelism = 128
        self._last_executor = None

    @staticmethod
    def get_execution_environment(*, device: DeviceLike = None
                                  ) -> "StreamExecutionEnvironment":
        return StreamExecutionEnvironment(device=device)

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
        self._last_executor = LocalExecutor()
        return self._last_executor.execute(self.get_job_graph())


def _op_factory(cls, fn_factory):
    def factory():
        return cls(fn_factory())
    return factory


class DataStream:
    def __init__(self, env: StreamExecutionEnvironment, node: StreamNode,
                 partitioner: Optional[StreamPartitioner] = None):
        self.env = env
        self.node = node
        #: partitioner for the next edge out of this stream
        self._partitioner = partitioner

    def _add_op(self, name: str, operator_factory, key_selector=None,
                chaining: str = "always") -> "DataStream":
        node = self.env.graph.add_node(StreamNode(
            self.env.graph.new_node_id(), name, operator_factory,
            parallelism=self.env.parallelism,
            max_parallelism=self.env.max_parallelism,
            key_selector=key_selector, chaining_strategy=chaining))
        self.env.graph.add_edge(StreamEdge(
            self.node.id, node.id, self._partitioner or ForwardPartitioner()))
        return DataStream(self.env, node)

    def name(self, name: str) -> "DataStream":
        self.node.name = name
        return self

    def uid(self, uid: str) -> "DataStream":
        self.node.uid = uid
        return self

    def key_by(self, key_selector) -> "KeyedStream":
        return KeyedStream(self.env, self.node, as_key_selector(key_selector))

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
    def __init__(self, env, node, key_selector):
        super().__init__(env, node,
                         KeyGroupStreamPartitioner(key_selector, env.max_parallelism))
        self.key_selector = key_selector

    def window(self, assigner: WindowAssigner) -> "WindowedStream":
        return WindowedStream(self, assigner)

    def time_window(self, size: Time) -> "WindowedStream":
        return WindowedStream(self, TumblingEventTimeWindows.of(size))


class WindowedStream:
    def __init__(self, keyed: KeyedStream, assigner: WindowAssigner):
        self._keyed = keyed
        self._assigner = assigner

    def aggregate(self, aggregate_function: AggregateFunction,
                  window_function=None, name: str = "window_aggregate") -> DataStream:
        """Device-eligible aggregates (a DeviceAggregateFunction over
        tumbling event-time windows, default trigger, no evictor,
        lateness 0) run on the device window engine."""
        if not is_device_eligible(self._assigner, aggregate_function, None,
                                  None, 0, None, window_function):
            raise NotImplementedError(
                "only device-eligible window aggregates are ported (a "
                "DeviceAggregateFunction over tumbling event-time windows "
                "with the default trigger, no evictor and lateness 0); the "
                "scalar WindowOperator on a keyed-state backend arrives "
                "with slice 2")
        assigner = self._assigner
        device = self._keyed.env.device

        def factory():
            return DeviceWindowOperator(assigner, aggregate_function,
                                        window_function, device=device)
        keyed = self._keyed
        return keyed._add_op(name, factory, key_selector=keyed.key_selector,
                             chaining="head")
