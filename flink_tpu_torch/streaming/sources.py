"""Source and sink contracts and the built-ins slice 1 runs (port of
``flink_tpu/streaming/sources.py:25-230, 346-380, 404-504``).

A source emits inside ``run()`` (or cooperatively through
``emit_step``) via its context; event-time sources carry timestamps
and watermarks; a timestamp assigner operator stamps records and emits
periodic watermarks downstream.
"""

from __future__ import annotations

import abc
from typing import Any, Iterable, List, Optional

from flink_tpu_torch.core.functions import RichFunction
from flink_tpu_torch.streaming.elements import (MAX_TIMESTAMP, MAX_WATERMARK,
                                                StreamRecord, Watermark)
from flink_tpu_torch.streaming.operators import AbstractUdfStreamOperator, Output


class SourceContext(abc.ABC):
    @abc.abstractmethod
    def collect(self, value) -> None: ...

    @abc.abstractmethod
    def collect_with_timestamp(self, value, timestamp: int) -> None: ...

    @abc.abstractmethod
    def emit_watermark(self, watermark: Watermark) -> None: ...


class SourceFunction(abc.ABC):
    """run() emits via the context until exhausted or cancel()ed."""

    @abc.abstractmethod
    def run(self, ctx: SourceContext) -> None: ...

    def cancel(self) -> None:  # noqa: B027
        pass


class SinkFunction(abc.ABC):
    @abc.abstractmethod
    def invoke(self, value, context=None) -> None: ...


class RichSinkFunction(SinkFunction, RichFunction):
    def __init__(self):
        RichFunction.__init__(self)


class ManualWatermarkContext(SourceContext):
    """Event time: the source provides timestamps and watermarks."""

    def __init__(self, output: Output):
        self._output = output

    def collect(self, value):
        self._output.collect(StreamRecord(value, None))

    def collect_with_timestamp(self, value, timestamp):
        self._output.collect(StreamRecord(value, timestamp))

    def emit_watermark(self, watermark):
        self._output.emit_watermark(watermark)


class StreamSource(AbstractUdfStreamOperator):
    """Operator hosting a SourceFunction (event time)."""

    def make_context(self) -> SourceContext:
        return ManualWatermarkContext(self.output)

    def run(self) -> None:
        self.user_function.run(self.make_context())

    def cancel(self) -> None:
        self.user_function.cancel()

    def process_element(self, record):
        raise RuntimeError("sources have no input")


class FromCollectionSource(SourceFunction):
    """Items are plain values, or (value, timestamp) pairs when
    ``timestamped=True``."""

    def __init__(self, items: Iterable[Any], timestamped: bool = False,
                 final_watermark: bool = True):
        self.items = list(items)
        self.timestamped = timestamped
        self.final_watermark = final_watermark
        self._cancelled = False
        #: resume offset
        self.offset = 0

    def run(self, ctx: SourceContext):
        while self.emit_step(ctx, len(self.items) + 1):
            pass

    def emit_step(self, ctx: SourceContext, max_records: int) -> bool:
        """Emit up to `max_records`; True while more remain."""
        n = 0
        while self.offset < len(self.items) and n < max_records:
            if self._cancelled:
                return False
            item = self.items[self.offset]
            if self.timestamped:
                value, ts = item
                ctx.collect_with_timestamp(value, ts)
            else:
                ctx.collect(item)
            self.offset += 1
            n += 1
        if self.offset < len(self.items):
            return True
        if self.final_watermark:
            ctx.emit_watermark(MAX_WATERMARK)
            self.final_watermark = False  # emit once
        return False

    def cancel(self):
        self._cancelled = True


class CollectSink(SinkFunction):
    """Accumulates into a list; the values also come back in
    ``JobExecutionResult.accumulators[accumulator_name]``."""

    def __init__(self, target: Optional[List[Any]] = None,
                 accumulator_name: str = "collected"):
        self.values: List[Any] = target if target is not None else []
        self.accumulator_name = accumulator_name

    def invoke(self, value, context=None):
        self.values.append(value)

    def accumulators(self):
        return {self.accumulator_name: list(self.values)}


class PrintSink(SinkFunction):
    def __init__(self, prefix: str = ""):
        self.prefix = prefix

    def invoke(self, value, context=None):
        print(f"{self.prefix}{value}" if self.prefix else str(value))


class AssignerWithPeriodicWatermarks(abc.ABC):
    @abc.abstractmethod
    def extract_timestamp(self, element, previous_timestamp: Optional[int]) -> int: ...

    @abc.abstractmethod
    def get_current_watermark(self) -> Optional[Watermark]: ...


class BoundedOutOfOrdernessTimestampExtractor(AssignerWithPeriodicWatermarks):
    """Watermark = max timestamp seen - delay - 1."""

    def __init__(self, max_out_of_orderness_ms: int, extractor):
        self.delay = max_out_of_orderness_ms
        self._extract = extractor
        self._max_ts = None

    def extract_timestamp(self, element, previous_timestamp):
        ts = self._extract(element)
        if self._max_ts is None or ts > self._max_ts:
            self._max_ts = ts
        return ts

    def get_current_watermark(self):
        if self._max_ts is None:
            return None
        return Watermark(self._max_ts - self.delay - 1)


class TimestampsAndWatermarksOperator(AbstractUdfStreamOperator):
    """Applies a periodic assigner, probed every `watermark_interval`
    elements (the single-process runtime has no timer thread between
    elements)."""

    def __init__(self, assigner, watermark_interval: int = 1):
        super().__init__(assigner)
        self.watermark_interval = max(1, watermark_interval)
        self._since_last = 0
        self._last_emitted = None

    def process_element(self, record):
        ts = self.user_function.extract_timestamp(record.value, record.timestamp)
        self.output.collect(StreamRecord(record.value, ts))
        self._since_last += 1
        if self._since_last >= self.watermark_interval:
            self._since_last = 0
            wm = self.user_function.get_current_watermark()
            if wm is not None and (self._last_emitted is None
                                   or wm.timestamp > self._last_emitted):
                self._last_emitted = wm.timestamp
                self.output.emit_watermark(wm)

    def process_watermark(self, watermark):
        """Upstream watermarks are swallowed except the final flush."""
        if watermark.timestamp == MAX_TIMESTAMP:
            super().process_watermark(watermark)
