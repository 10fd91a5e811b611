"""StreamElement model (port of ``flink_tpu/streaming/elements.py:23-200``).

Records and watermarks flow through operator pipelines.  Timestamps are
int milliseconds (event time); ``MAX_WATERMARK`` flushes all event-time
state at end of input.  Columnar batches, stream status, latency
markers and checkpoint barriers arrive with later slices.
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
