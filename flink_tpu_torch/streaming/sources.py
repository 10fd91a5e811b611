"""Source and sink contracts and the built-ins the port runs (port of
``flink_tpu/streaming/sources.py``).

A source emits inside ``run()`` (or cooperatively through
``emit_step``) via its context, which the time characteristic picks:
event-time sources carry timestamps and watermarks
(``ManualWatermarkContext``), processing time drops them
(``NonTimestampContext``) and ingestion time stamps each record with
the processing-time clock and emits a watermark per interval
(``AutomaticWatermarkContext``).  A timestamp assigner operator stamps
records and emits watermarks downstream: periodic ones every
``watermark_interval`` elements, punctuated ones when the assigner
returns one for an element.  A replayable source keeps its read
position in ``snapshot_function_state`` / ``restore_function_state``,
which the operator carries in checkpoints.

A source without ``emit_step`` runs ``run()`` on a thread of its own
(``runtime/local.py``); its context then hands every element to the
executor's loop, and ``get_checkpoint_lock()`` is the lock the loop
holds while it snapshots the source and injects a barrier.  A source
that advances its read position inside that lock, together with the
emission, gets a snapshot that covers exactly the records ahead of the
barrier.  ``SocketTextStreamSource`` (``socket_text_stream``) and
``FileTextSource`` (``read_text_file``) are such sources.
"""

from __future__ import annotations

import abc
import socket as _socket
import threading
import time as _time
from typing import Any, Iterable, List, Optional

from flink_tpu_torch.core.functions import RichFunction
from flink_tpu_torch.streaming.elements import (MAX_TIMESTAMP, MAX_WATERMARK,
                                                RecordBatch, StreamRecord,
                                                Watermark)
from flink_tpu_torch.streaming.operators import AbstractUdfStreamOperator, Output


class SourceContext(abc.ABC):
    #: the emission lock a thread-hosted source's executor sets; made
    #: on first use otherwise
    _checkpoint_lock = None

    @abc.abstractmethod
    def collect(self, value) -> None: ...

    @abc.abstractmethod
    def collect_with_timestamp(self, value, timestamp: int) -> None: ...

    @abc.abstractmethod
    def emit_watermark(self, watermark: Watermark) -> None: ...

    def collect_batch(self, batch) -> None:
        """Emit a whole RecordBatch; contexts that cannot forward
        batches box per row, keeping each row's timestamp."""
        for v, t in zip(batch.row_values(), batch.timestamps()):
            if t is None:
                self.collect(v)
            else:
                self.collect_with_timestamp(v, t)

    def get_checkpoint_lock(self):
        """The lock a thread-hosted source advances its read position
        under, in the same critical section as the emission: a barrier
        is injected only while the executor holds it.  Reentrant
        (``collect`` takes it too)."""
        if self._checkpoint_lock is None:
            self._checkpoint_lock = threading.RLock()
        return self._checkpoint_lock

    def mark_as_temporarily_idle(self) -> None:  # noqa: B027
        """Accepted and ignored: no channel is left out of the
        watermark minimum for idleness yet."""


class SourceFunction(abc.ABC):
    """run() emits via the context until exhausted or cancel()ed."""

    @abc.abstractmethod
    def run(self, ctx: SourceContext) -> None: ...

    def cancel(self) -> None:  # noqa: B027
        pass


class ParallelSourceFunction(SourceFunction):
    """Marker: the source may run at parallelism > 1."""


class RichSourceFunction(SourceFunction, RichFunction):
    def __init__(self):
        RichFunction.__init__(self)


class RichParallelSourceFunction(ParallelSourceFunction, RichFunction):
    def __init__(self):
        RichFunction.__init__(self)


class SinkFunction(abc.ABC):
    @abc.abstractmethod
    def invoke(self, value, context=None) -> None: ...


class RichSinkFunction(SinkFunction, RichFunction):
    def __init__(self):
        RichFunction.__init__(self)


class NonTimestampContext(SourceContext):
    """Processing time: records carry no timestamp and source
    watermarks are dropped."""

    def __init__(self, output: Output):
        self._output = output

    def collect(self, value):
        self._output.collect(StreamRecord(value, None))

    def collect_with_timestamp(self, value, timestamp):
        self.collect(value)

    def collect_batch(self, batch):
        if batch.ts is None:
            self._output.collect_batch(batch)
        else:
            # the same rows without their stamps, as per-row collect()
            # would give
            self._output.collect_batch(RecordBatch(batch.cols))

    def emit_watermark(self, watermark):
        pass


class ManualWatermarkContext(SourceContext):
    """Event time: the source provides timestamps and watermarks."""

    def __init__(self, output: Output):
        self._output = output

    def collect(self, value):
        self._output.collect(StreamRecord(value, None))

    def collect_with_timestamp(self, value, timestamp):
        self._output.collect(StreamRecord(value, timestamp))

    def collect_batch(self, batch):
        self._output.collect_batch(batch)

    def emit_watermark(self, watermark):
        self._output.emit_watermark(watermark)


class AutomaticWatermarkContext(SourceContext):
    """Ingestion time: each record gets the processing-time clock as
    its timestamp, and a watermark follows each new ``interval_ms``
    bucket of the clock."""

    def __init__(self, output: Output, processing_time_service,
                 interval_ms: int = 200):
        self._output = output
        self._pts = processing_time_service
        self._interval = interval_ms
        self._last_wm = None

    def collect(self, value):
        now = self._pts.get_current_processing_time()
        self._output.collect(StreamRecord(value, now))
        self._maybe_watermark(now)

    def collect_with_timestamp(self, value, timestamp):
        self.collect(value)  # ingestion time overrides source stamps

    def emit_watermark(self, watermark):
        pass  # watermarks are automatic

    def _maybe_watermark(self, now: int):
        bucket = now - (now % self._interval)
        if self._last_wm is None or bucket > self._last_wm:
            self._last_wm = bucket
            self._output.emit_watermark(Watermark(bucket - 1))


class StreamSource(AbstractUdfStreamOperator):
    """Operator hosting a SourceFunction; ``time_characteristic``
    (``event``, ``processing`` or ``ingestion``) picks its context."""

    #: the source factory copies the function for each subtask already
    COPY_UDF_PER_SUBTASK = False

    def __init__(self, source_function: SourceFunction,
                 time_characteristic: str = "event"):
        super().__init__(source_function)
        self.time_characteristic = time_characteristic

    def make_context(self, output: Optional[Output] = None) -> SourceContext:
        """``output`` replaces the operator's own: the executor's
        hand-off to its loop for a thread-hosted source."""
        out = output if output is not None else self.output
        if self.time_characteristic == "processing":
            return NonTimestampContext(out)
        if self.time_characteristic == "ingestion":
            return AutomaticWatermarkContext(out, self.processing_time_service)
        return ManualWatermarkContext(out)

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

    # the read position is the source's checkpointed state
    def snapshot_function_state(self, checkpoint_id=None) -> dict:
        return {"offset": self.offset}

    def restore_function_state(self, state: dict) -> None:
        self.offset = state["offset"]


class SocketTextStreamSource(SourceFunction):
    """Lines of text from a TCP socket (BASELINE config #1's source),
    split at ``delimiter``; the source ends when the peer closes the
    connection.  A failed connection retries ``max_retries`` times,
    half a second apart.  ``cancel`` shuts the socket down, which ends
    a blocked read."""

    #: seconds a read waits before it looks at the cancel flag again
    POLL_S = 0.2

    def __init__(self, hostname: str, port: int, delimiter: str = "\n",
                 max_retries: int = 0):
        self.hostname = hostname
        self.port = port
        self.delimiter = delimiter
        self.max_retries = max_retries
        self._cancelled = False
        self._sock: Optional[_socket.socket] = None

    def run(self, ctx: SourceContext):
        attempts = 0
        while not self._cancelled:
            try:
                with _socket.create_connection((self.hostname, self.port)) as sock:
                    self._sock = sock
                    sock.settimeout(self.POLL_S)
                    buf = ""
                    while not self._cancelled:
                        try:
                            data = sock.recv(1 << 16)
                        except _socket.timeout:
                            continue
                        if not data:
                            return
                        buf += data.decode("utf-8", errors="replace")
                        *lines, buf = buf.split(self.delimiter)
                        for line in lines:
                            ctx.collect(line)
                    return
            except OSError:
                if self._cancelled:
                    return
                attempts += 1
                if attempts > self.max_retries:
                    raise
                _time.sleep(0.5)

    def cancel(self):
        self._cancelled = True
        sock = self._sock
        if sock is not None:
            try:
                sock.shutdown(_socket.SHUT_RDWR)
            except OSError:
                pass


class FileTextSource(SourceFunction):
    """The lines of a text file, without their newlines."""

    def __init__(self, path: str):
        self.path = path
        self._cancelled = False

    def run(self, ctx: SourceContext):
        with open(self.path, "r") as f:
            for line in f:
                if self._cancelled:
                    return
                ctx.collect(line.rstrip("\n"))

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

    def invoke_batch(self, batch) -> None:
        """A batch in one call: its row values, in order."""
        self.values.extend(batch.row_values())

    def accumulators(self):
        return {self.accumulator_name: list(self.values)}


class PrintSink(SinkFunction):
    def __init__(self, prefix: str = ""):
        self.prefix = prefix

    def invoke(self, value, context=None):
        print(f"{self.prefix}{value}" if self.prefix else str(value))


class WriteAsTextSink(RichSinkFunction):
    """``str(value)`` a line into the file at ``path``."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        self._fh = None

    def open(self, configuration):
        self._fh = open(self.path, "w")

    def invoke(self, value, context=None):
        self._fh.write(str(value) + "\n")

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None


class AssignerWithPeriodicWatermarks(abc.ABC):
    @abc.abstractmethod
    def extract_timestamp(self, element, previous_timestamp: Optional[int]) -> int: ...

    @abc.abstractmethod
    def get_current_watermark(self) -> Optional[Watermark]: ...


class AssignerWithPunctuatedWatermarks(abc.ABC):
    @abc.abstractmethod
    def extract_timestamp(self, element, previous_timestamp: Optional[int]) -> int: ...

    @abc.abstractmethod
    def check_and_get_next_watermark(self, element,
                                     extracted_timestamp: int) -> Optional[Watermark]: ...


class AscendingTimestampExtractor(AssignerWithPeriodicWatermarks):
    """Timestamps ascend per subtask; watermark = the last one - 1.  A
    record older than the last keeps its own timestamp, and the
    watermark stays where it was."""

    def __init__(self, extractor):
        self._extract = extractor
        self._current = None

    def extract_timestamp(self, element, previous_timestamp):
        ts = self._extract(element)
        if self._current is None or ts >= self._current:
            self._current = ts
        return ts

    def get_current_watermark(self):
        return None if self._current is None else Watermark(self._current - 1)


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
    """Applies an assigner.  A punctuated one is asked for a watermark
    at every element; a periodic one every ``watermark_interval``
    elements (the executor has no timer thread between elements).  A
    watermark goes out only when it is newer than the last."""

    def __init__(self, assigner, watermark_interval: int = 1):
        super().__init__(assigner)
        self.watermark_interval = max(1, watermark_interval)
        self._since_last = 0
        self._last_emitted = None

    def process_element(self, record):
        fn = self.user_function
        ts = fn.extract_timestamp(record.value, record.timestamp)
        self.output.collect(StreamRecord(record.value, ts))
        if isinstance(fn, AssignerWithPunctuatedWatermarks):
            self._emit_newer(fn.check_and_get_next_watermark(record.value, ts))
            return
        self._since_last += 1
        if self._since_last >= self.watermark_interval:
            self._since_last = 0
            self._emit_newer(fn.get_current_watermark())

    def _emit_newer(self, wm: Optional[Watermark]) -> None:
        if wm is not None and (self._last_emitted is None
                               or wm.timestamp > self._last_emitted):
            self._last_emitted = wm.timestamp
            self.output.emit_watermark(wm)

    def process_watermark(self, watermark):
        """Upstream watermarks are swallowed except the final flush."""
        if watermark.timestamp == MAX_TIMESTAMP:
            super().process_watermark(watermark)
