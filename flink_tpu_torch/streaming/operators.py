"""Operator lifecycle and the operators slice 1 runs (port of
``flink_tpu/streaming/operators.py:68-370, 389-460, 729-752``).

setup → open → process* → finish → close.  Keyed state backends,
timers, columnar batches and the column-kernel mixins are later
slices; the device window operator is its own keyed state.
"""

from __future__ import annotations

import abc
from typing import Optional

from flink_tpu_torch.core.functions import KeySelector, RichFunction, RuntimeContext
from flink_tpu_torch.streaming.elements import MIN_TIMESTAMP, StreamRecord, Watermark


class Output(abc.ABC):
    """Where an operator emits."""

    @abc.abstractmethod
    def collect(self, record: StreamRecord) -> None: ...

    @abc.abstractmethod
    def emit_watermark(self, watermark: Watermark) -> None: ...

    def close(self) -> None:  # noqa: B027
        pass


class TimestampedCollector:
    """Collector bound to one timestamp."""

    __slots__ = ("_output", "timestamp")

    def __init__(self, output: Output, timestamp: Optional[int] = None):
        self._output = output
        self.timestamp = timestamp

    def collect(self, value) -> None:
        self._output.collect(StreamRecord(value, self.timestamp))

    def set_absolute_timestamp(self, ts: Optional[int]) -> None:
        self.timestamp = ts


class StreamOperator(abc.ABC):
    """Operator lifecycle: setup → open → process* → finish → close."""

    def __init__(self):
        self.output: Optional[Output] = None
        self.current_watermark: int = MIN_TIMESTAMP
        self.key_selector: Optional[KeySelector] = None
        self.operator_id: str = ""
        self.subtask_index: int = 0
        self.num_subtasks: int = 1
        self.max_parallelism: int = 128

    def setup(self, output: Output, key_selector: Optional[KeySelector] = None,
              operator_id: str = "", subtask_index: int = 0,
              num_subtasks: int = 1, max_parallelism: int = 128) -> None:
        self.output = output
        self.key_selector = key_selector
        self.operator_id = operator_id or type(self).__name__
        self.subtask_index = subtask_index
        self.num_subtasks = num_subtasks
        self.max_parallelism = max_parallelism

    def open(self) -> None:  # noqa: B027
        pass

    def finish(self) -> None:  # noqa: B027
        """End of input reached (after the final watermark, before
        close): flush buffered output."""

    def close(self) -> None:  # noqa: B027
        pass

    @abc.abstractmethod
    def process_element(self, record: StreamRecord) -> None: ...

    def process_watermark(self, watermark: Watermark) -> None:
        self.current_watermark = watermark.timestamp
        self.output.emit_watermark(watermark)

    def set_key_context(self, record: StreamRecord) -> None:  # noqa: B027
        """Key extraction for keyed state backends (a later slice)."""


class AbstractUdfStreamOperator(StreamOperator):
    """Hosts a user function, forwarding open/close."""

    def __init__(self, user_function):
        super().__init__()
        self.user_function = user_function

    def open(self):
        if isinstance(self.user_function, RichFunction):
            self.user_function.set_runtime_context(RuntimeContext(
                task_name=self.operator_id,
                index_of_subtask=self.subtask_index,
                parallelism=self.num_subtasks,
                max_parallelism=self.max_parallelism))
            self.user_function.open(None)

    def finish(self):
        fn = self.user_function
        if hasattr(fn, "finish"):
            fn.finish()

    def close(self):
        if isinstance(self.user_function, RichFunction):
            self.user_function.close()


class StreamSink(AbstractUdfStreamOperator):
    """Operator hosting a SinkFunction."""

    def process_element(self, record):
        self.user_function.invoke(record.value,
                                  SinkContext(record.timestamp, self))


class SinkContext:
    __slots__ = ("timestamp", "_op")

    def __init__(self, timestamp, op):
        self.timestamp = timestamp
        self._op = op
