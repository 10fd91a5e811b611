"""Windows and assigners (port of ``flink_tpu/streaming/windowing.py:18-112,
450-500``).

A ``TimeWindow`` covers [start, end); max_timestamp = end - 1; tumbling
starts align to ``timestamp - (timestamp - offset) % size``.  Slice 1
carries tumbling event-time windows; sliding and session windows,
triggers and evictors are later slices (the device engine fires on the
default event-time trigger's schedule).
"""

from __future__ import annotations

import abc
from typing import Iterable


class Time:
    """Duration helper, value in ms."""

    __slots__ = ("milliseconds",)

    def __init__(self, milliseconds: int):
        self.milliseconds = int(milliseconds)

    @staticmethod
    def milliseconds_of(ms) -> "Time":
        return Time(ms)

    @staticmethod
    def seconds(s) -> "Time":
        return Time(s * 1000)

    @staticmethod
    def minutes(m) -> "Time":
        return Time(m * 60 * 1000)

    @staticmethod
    def hours(h) -> "Time":
        return Time(h * 60 * 60 * 1000)

    def to_milliseconds(self) -> int:
        return self.milliseconds

    def __repr__(self):
        return f"Time({self.milliseconds}ms)"


def _ms(t) -> int:
    if isinstance(t, Time):
        return t.milliseconds
    return int(t)


class Window(abc.ABC):
    @abc.abstractmethod
    def max_timestamp(self) -> int:
        ...


class TimeWindow(Window):
    """[start, end)."""

    __slots__ = ("start", "end")

    def __init__(self, start: int, end: int):
        self.start = start
        self.end = end

    def max_timestamp(self) -> int:
        return self.end - 1

    @staticmethod
    def get_window_start_with_offset(timestamp: int, offset: int, window_size: int) -> int:
        return timestamp - (timestamp - offset + window_size) % window_size

    def __eq__(self, other):
        return (isinstance(other, TimeWindow) and self.start == other.start
                and self.end == other.end)

    def __hash__(self):
        return hash((self.start, self.end))

    def __lt__(self, other):
        return (self.start, self.end) < (other.start, other.end)

    def __repr__(self):
        return f"TimeWindow[{self.start}, {self.end})"


class WindowAssigner(abc.ABC):
    @abc.abstractmethod
    def assign_windows(self, element, timestamp: int, ctx) -> Iterable[Window]:
        ...

    @abc.abstractmethod
    def is_event_time(self) -> bool:
        ...

    def is_merging(self) -> bool:
        return False


class TumblingEventTimeWindows(WindowAssigner):
    """Fixed-size, non-overlapping event-time windows."""

    def __init__(self, size, offset=0):
        self.size = _ms(size)
        self.offset = _ms(offset)
        if not (0 <= self.offset < self.size):
            raise ValueError("offset must satisfy 0 <= offset < size")

    @staticmethod
    def of(size, offset=0) -> "TumblingEventTimeWindows":
        return TumblingEventTimeWindows(size, offset)

    def assign_windows(self, element, timestamp, ctx):
        if timestamp is None:
            raise ValueError(
                "record has no timestamp — event-time windowing requires "
                "timestamp assignment (assign_timestamps_and_watermarks)")
        start = TimeWindow.get_window_start_with_offset(timestamp, self.offset, self.size)
        return [TimeWindow(start, start + self.size)]

    def is_event_time(self):
        return True

    def __repr__(self):
        return f"TumblingEventTimeWindows({self.size})"
