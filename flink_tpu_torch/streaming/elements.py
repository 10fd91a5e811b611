"""StreamElement model (port of ``flink_tpu/streaming/elements.py:23-200``).

Records and watermarks flow through operator pipelines.  Timestamps are
int milliseconds (event time); ``MAX_WATERMARK`` flushes all event-time
state at end of input.  ``RecordBatch`` carries the subset of the
reference's columnar batch that ``WindowOperator.process_batch`` and
the test harness use; routing batches through the job graph, stream
status, latency markers and checkpoint barriers arrive with later
slices.
"""

from __future__ import annotations

from typing import Any, Optional

MAX_TIMESTAMP = 2**63 - 1
MIN_TIMESTAMP = -(2**63)


class StreamElement:
    __slots__ = ()

    is_record = False
    is_watermark = False


class StreamRecord(StreamElement):
    """A value and an optional timestamp."""

    __slots__ = ("value", "timestamp")

    is_record = True

    def __init__(self, value: Any, timestamp: Optional[int] = None):
        self.value = value
        self.timestamp = timestamp

    def __repr__(self):
        return f"Record({self.value!r} @ {self.timestamp})"

    def __eq__(self, other):
        return (isinstance(other, StreamRecord) and self.value == other.value
                and self.timestamp == other.timestamp)

    def __hash__(self):
        return hash((self.value if not isinstance(self.value, (list, dict)) else id(self.value),
                     self.timestamp))


class RecordBatch(StreamElement):
    """A batch of rows as named numpy columns and event timestamps.

    A single column named ``"v"`` means scalar rows (the row value is
    the cell); any other column set means tuple rows in column order
    (``"f0".."fk"``).  ``ts`` is an optional int64 timestamp column;
    ``ts_mask`` (optional bool, True = the row has a timestamp) keeps
    None timestamps, so boxing gives the exact per-record stream.
    """

    __slots__ = ("cols", "ts", "ts_mask")

    def __init__(self, cols, ts=None, ts_mask=None):
        #: {name: np.ndarray}, all of one length
        self.cols = cols
        self.ts = ts
        self.ts_mask = ts_mask

    def __len__(self) -> int:
        return len(next(iter(self.cols.values()))) if self.cols else 0

    @property
    def is_scalar(self) -> bool:
        return len(self.cols) == 1 and "v" in self.cols

    def row_values(self) -> list:
        """Row values as operators see them: the cell for scalar
        batches, a tuple over the columns otherwise."""
        arrays = list(self.cols.values())
        if self.is_scalar:
            return arrays[0].tolist()
        return list(zip(*[a.tolist() for a in arrays]))

    def value_arrays(self):
        """One ndarray for scalar batches, a tuple of ndarrays otherwise."""
        arrays = tuple(self.cols.values())
        return arrays[0] if self.is_scalar else arrays

    def to_records(self) -> list:
        """Box into per-row StreamRecords, as the row-at-a-time path
        would have carried the same rows."""
        values = self.row_values()
        if self.ts is None:
            return [StreamRecord(v) for v in values]
        stamps = self.ts.tolist()
        if self.ts_mask is None:
            return [StreamRecord(v, t) for v, t in zip(values, stamps)]
        return [StreamRecord(v, t if ok else None)
                for v, t, ok in zip(values, stamps, self.ts_mask.tolist())]

    def __repr__(self):
        return (f"RecordBatch({list(self.cols)} x {len(self)}"
                f"{' +ts' if self.ts is not None else ''})")


class Watermark(StreamElement):
    """Event-time progress marker: no records with timestamp <= this
    follow."""

    __slots__ = ("timestamp",)

    is_watermark = True

    def __init__(self, timestamp: int):
        self.timestamp = timestamp

    def __repr__(self):
        return f"Watermark({self.timestamp})"

    def __eq__(self, other):
        return isinstance(other, Watermark) and self.timestamp == other.timestamp

    def __hash__(self):
        return hash(("wm", self.timestamp))


MAX_WATERMARK = Watermark(MAX_TIMESTAMP)
