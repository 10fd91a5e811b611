"""StreamElement model (port of ``flink_tpu/streaming/elements.py:23-200``).

Records and watermarks flow through operator pipelines.  Timestamps are
int milliseconds (event time); ``MAX_WATERMARK`` flushes all event-time
state at end of input.  ``RecordBatch`` is a stream element of its
own: sources emit batches, column kernels and the fused chain program
consume them, and the router splits them by key group.  A
``CheckpointBarrier`` travels in band from the sources and
``END_OF_STREAM`` closes a channel.  Stream status and latency markers
arrive with later slices.
"""

from __future__ import annotations

from typing import Any, Optional

MAX_TIMESTAMP = 2**63 - 1
MIN_TIMESTAMP = -(2**63)


class StreamElement:
    __slots__ = ()

    is_record = False
    is_watermark = False
    is_barrier = False
    is_latency_marker = False


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
    Columns stay numpy on the host between operators.  A batch is
    immutable once emitted: operators build new batches.
    """

    __slots__ = ("cols", "ts", "ts_mask", "routing")

    def __init__(self, cols, ts=None, ts_mask=None, routing=None):
        #: {name: np.ndarray}, all of one length
        self.cols = cols
        self.ts = ts
        self.ts_mask = ts_mask
        #: optional uint64 per-row routing hashes (splitmix64 of the
        #: key column, what KeyGroupStreamPartitioner would compute);
        #: ``take`` drops them, since a gather breaks the pairing.  No
        #: operator of the port sets them yet (the reference's fused
        #: ``attach`` mode does; it is not ported)
        self.routing = routing

    def __len__(self) -> int:
        return len(next(iter(self.cols.values()))) if self.cols else 0

    @property
    def is_scalar(self) -> bool:
        return len(self.cols) == 1 and "v" in self.cols

    def rows(self):
        """Row tuples over all columns (scalar batches give 1-tuples)."""
        return zip(*[a.tolist() for a in self.cols.values()])

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

    def timestamps(self) -> list:
        """Per-row timestamps, None where the row has none."""
        if self.ts is None:
            return [None] * len(self)
        stamps = self.ts.tolist()
        if self.ts_mask is None:
            return stamps
        return [t if ok else None
                for t, ok in zip(stamps, self.ts_mask.tolist())]

    def take(self, index) -> "RecordBatch":
        """The rows selected by a bool mask, an index array or a slice."""
        return RecordBatch(
            {k: v[index] for k, v in self.cols.items()},
            self.ts[index] if self.ts is not None else None,
            self.ts_mask[index] if self.ts_mask is not None else None)

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


class CheckpointBarrier(StreamElement):
    """In-band barrier of checkpoint ``checkpoint_id``.  ``options``:
    ``mode`` ``exactly_once`` aligns a subtask's channels,
    ``at_least_once`` only counts them; a savepoint sets
    ``savepoint``."""

    __slots__ = ("checkpoint_id", "timestamp", "options")

    is_barrier = True

    def __init__(self, checkpoint_id: int, timestamp: int,
                 options: Optional[dict] = None):
        self.checkpoint_id = checkpoint_id
        self.timestamp = timestamp
        self.options = options or {}

    def __repr__(self):
        return f"Barrier(#{self.checkpoint_id})"

    def __eq__(self, other):
        return (isinstance(other, CheckpointBarrier)
                and self.checkpoint_id == other.checkpoint_id)

    def __hash__(self):
        return hash(self.checkpoint_id)


class LatencyMarker(StreamElement):
    """A marker a source emits every latency-tracking interval; each
    subtask it reaches records its age in the job's latency histograms
    and forwards it down one channel (port of
    ``flink_tpu/streaming/elements.py:231``)."""

    __slots__ = ("marked_time", "operator_id", "subtask_index")

    is_latency_marker = True

    def __init__(self, marked_time: float, operator_id: str,
                 subtask_index: int):
        self.marked_time = marked_time
        self.operator_id = operator_id
        self.subtask_index = subtask_index

    def __repr__(self):
        return (f"LatencyMarker({self.marked_time} from "
                f"{self.operator_id}/{self.subtask_index})")


class EndOfStream(StreamElement):
    """The last element of a channel."""

    __slots__ = ()

    def __repr__(self):
        return "EndOfStream"


END_OF_STREAM = EndOfStream()
