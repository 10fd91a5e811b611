"""Operator lifecycle and the operators the port runs (port of
``flink_tpu/streaming/operators.py:68-370, 389-460, 729-752``).

setup → open → process* → finish → close.  ``setup`` takes the
operator's keyed backend and processing-time service and builds its
``InternalTimerService``; ``process_watermark`` advances the timers,
``set_key_context`` sets the backend's current key, and
``snapshot_state`` / ``restore_state`` carry keyed state and timers.
Operator state, metrics and the column-kernel mixins are later
slices; the device window operator is its own keyed state.
"""

from __future__ import annotations

import abc
from typing import List, Optional

from flink_tpu_torch.core.functions import KeySelector, RichFunction, RuntimeContext
from flink_tpu_torch.streaming.elements import MIN_TIMESTAMP, StreamRecord, Watermark
from flink_tpu_torch.streaming.timers import (InternalTimerService,
                                              ProcessingTimeService)


class OutputTag:
    """Names a side output."""

    __slots__ = ("tag_id",)

    def __init__(self, tag_id: str):
        self.tag_id = tag_id

    def __eq__(self, other):
        return isinstance(other, OutputTag) and self.tag_id == other.tag_id

    def __hash__(self):
        return hash(self.tag_id)

    def __repr__(self):
        return f"OutputTag({self.tag_id!r})"


class Output(abc.ABC):
    """Where an operator emits."""

    @abc.abstractmethod
    def collect(self, record: StreamRecord) -> None: ...

    @abc.abstractmethod
    def emit_watermark(self, watermark: Watermark) -> None: ...

    def collect_side(self, tag: OutputTag, record: StreamRecord) -> None:
        """Dropped unless a side output is wired."""

    def close(self) -> None:  # noqa: B027
        pass


class CollectorOutput(Output):
    """Keeps emissions in lists (the test harness's output)."""

    def __init__(self):
        self.records: List[StreamRecord] = []
        self.watermarks: List[Watermark] = []
        self.side: dict = {}

    def collect(self, record):
        self.records.append(record)

    def emit_watermark(self, watermark):
        self.watermarks.append(watermark)

    def collect_side(self, tag, record):
        self.side.setdefault(tag.tag_id, []).append(record)


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
        self.keyed_backend = None
        self.processing_time_service: Optional[ProcessingTimeService] = None
        self.timer_service: Optional[InternalTimerService] = None
        self.current_watermark: int = MIN_TIMESTAMP
        self.key_selector: Optional[KeySelector] = None
        self.operator_id: str = ""
        self.subtask_index: int = 0
        self.num_subtasks: int = 1
        self.max_parallelism: int = 128

    def setup(self, output: Output, keyed_backend=None,
              processing_time_service: Optional[ProcessingTimeService] = None,
              key_selector: Optional[KeySelector] = None,
              operator_id: str = "", subtask_index: int = 0,
              num_subtasks: int = 1, max_parallelism: int = 128) -> None:
        self.output = output
        self.keyed_backend = keyed_backend
        self.processing_time_service = processing_time_service
        self.key_selector = key_selector
        self.operator_id = operator_id or type(self).__name__
        self.subtask_index = subtask_index
        self.num_subtasks = num_subtasks
        self.max_parallelism = max_parallelism
        if keyed_backend is not None:
            self.timer_service = InternalTimerService(
                f"{self.operator_id}-timers", keyed_backend,
                processing_time_service, self)

    def open(self) -> None:  # noqa: B027
        pass

    def finish(self) -> None:  # noqa: B027
        """End of input reached (after the final watermark, before
        close): flush buffered output."""

    def close(self) -> None:  # noqa: B027
        pass

    @abc.abstractmethod
    def process_element(self, record: StreamRecord) -> None: ...

    def process_batch(self, batch) -> None:
        """Consume a RecordBatch: box it into records and run the
        per-record path (operators with a column path override)."""
        for record in batch.to_records():
            self.set_key_context(record)
            self.process_element(record)

    def process_watermark(self, watermark: Watermark) -> None:
        self.current_watermark = watermark.timestamp
        if self.timer_service is not None:
            self.timer_service.advance_watermark(watermark.timestamp)
        self.output.emit_watermark(watermark)

    def set_key_context(self, record: StreamRecord) -> None:
        """The record's key becomes the backend's current key."""
        if self.key_selector is not None and self.keyed_backend is not None:
            self.keyed_backend.set_current_key(
                self.key_selector.get_key(record.value))

    # ---- timers -----------------------------------------------------
    def on_event_time(self, timer) -> None:  # noqa: B027
        pass

    def on_processing_time(self, timer) -> None:  # noqa: B027
        pass

    # ---- snapshot ---------------------------------------------------
    def snapshot_state(self) -> dict:
        """Keyed state (pending micro-batches flushed first) and timers."""
        snap = {}
        if self.keyed_backend is not None:
            flush = getattr(self.keyed_backend, "flush_all", None)
            if flush is not None:
                flush()
            snap["keyed"] = self.keyed_backend.snapshot()
        if self.timer_service is not None:
            snap["timers"] = self.timer_service.snapshot()
        return snap

    def restore_state(self, snapshots: List[dict]) -> None:
        keyed = [s["keyed"] for s in snapshots if "keyed" in s]
        if keyed and self.keyed_backend is not None:
            self.keyed_backend.restore(keyed)
        timers = [s["timers"] for s in snapshots if "timers" in s]
        if timers and self.timer_service is not None:
            self.timer_service.restore(timers)


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
