"""Windows, assigners and triggers (port of
``flink_tpu/streaming/windowing.py:18-238, 450-613``).

A ``TimeWindow`` covers [start, end); max_timestamp = end - 1; its
namespace in keyed state is the tuple (start, end).  Tumbling and
sliding starts align to ``timestamp - (timestamp - offset) % slide``;
a session window is [timestamp, timestamp + gap) and merges with every
window it intersects.  The port carries event-time assigners and the
default ``EventTimeTrigger``; processing-time assigners, the other
triggers and evictors are later slices.
"""

from __future__ import annotations

import abc
from typing import Iterable, Tuple


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

    def intersects(self, other: "TimeWindow") -> bool:
        return self.start <= other.end and self.end >= other.start

    def cover(self, other: "TimeWindow") -> "TimeWindow":
        return TimeWindow(min(self.start, other.start), max(self.end, other.end))

    def to_namespace(self) -> Tuple[int, int]:
        return (self.start, self.end)

    @staticmethod
    def from_namespace(ns: Tuple[int, int]) -> "TimeWindow":
        return TimeWindow(ns[0], ns[1])

    @staticmethod
    def get_window_start_with_offset(timestamp: int, offset: int, window_size: int) -> int:
        return timestamp - (timestamp - offset + window_size) % window_size

    def __eq__(self, other):
        # a TimeWindow of either package: a session snapshot crosses the
        # two packages holding the writer's own window class, and the
        # reader finds a stored window of the other class by this test
        # (a dict lookup asks the stored key).  One way only: the JAX
        # package's TimeWindow equals its own class alone, so a port
        # window held in its mappings is found, but `jax == port` is
        # False where `port == jax` is True.
        if type(other).__name__ != "TimeWindow":
            return NotImplemented
        return self.start == other.start and self.end == other.end

    def __hash__(self):
        return hash((self.start, self.end))

    def __lt__(self, other):
        return (self.start, self.end) < (other.start, other.end)

    def __repr__(self):
        return f"TimeWindow[{self.start}, {self.end})"


# ---------------------------------------------------------------------
# Triggers
# ---------------------------------------------------------------------

class TriggerResult:
    CONTINUE = 0
    FIRE = 1
    PURGE = 2
    FIRE_AND_PURGE = 3

    @staticmethod
    def is_fire(r: int) -> bool:
        return r in (TriggerResult.FIRE, TriggerResult.FIRE_AND_PURGE)

    @staticmethod
    def is_purge(r: int) -> bool:
        return r in (TriggerResult.PURGE, TriggerResult.FIRE_AND_PURGE)


class TriggerContext(abc.ABC):
    """What a trigger may do: timers and partitioned trigger state."""

    @abc.abstractmethod
    def register_event_time_timer(self, time: int) -> None: ...

    @abc.abstractmethod
    def register_processing_time_timer(self, time: int) -> None: ...

    @abc.abstractmethod
    def delete_event_time_timer(self, time: int) -> None: ...

    @abc.abstractmethod
    def delete_processing_time_timer(self, time: int) -> None: ...

    @abc.abstractmethod
    def get_current_watermark(self) -> int: ...

    @abc.abstractmethod
    def get_current_processing_time(self) -> int: ...

    @abc.abstractmethod
    def get_partitioned_state(self, descriptor): ...


class Trigger(abc.ABC):
    def on_element(self, element, timestamp: int, window, ctx: TriggerContext) -> int:
        return TriggerResult.CONTINUE

    def on_event_time(self, time: int, window, ctx: TriggerContext) -> int:
        return TriggerResult.CONTINUE

    def on_processing_time(self, time: int, window, ctx: TriggerContext) -> int:
        return TriggerResult.CONTINUE

    def can_merge(self) -> bool:
        return False

    def on_merge(self, window, ctx) -> None:
        raise NotImplementedError(f"{type(self).__name__} cannot merge")

    def clear(self, window, ctx: TriggerContext) -> None:  # noqa: B027
        pass


class EventTimeTrigger(Trigger):
    """FIRE when the watermark passes window.max_timestamp()."""

    def on_element(self, element, timestamp, window, ctx):
        if window.max_timestamp() <= ctx.get_current_watermark():
            return TriggerResult.FIRE  # late, within allowed lateness
        ctx.register_event_time_timer(window.max_timestamp())
        return TriggerResult.CONTINUE

    def on_event_time(self, time, window, ctx):
        return (TriggerResult.FIRE if time == window.max_timestamp()
                else TriggerResult.CONTINUE)

    def can_merge(self):
        return True

    def on_merge(self, window, ctx):
        if window.max_timestamp() > ctx.get_current_watermark():
            ctx.register_event_time_timer(window.max_timestamp())

    def clear(self, window, ctx):
        ctx.delete_event_time_timer(window.max_timestamp())

    def __repr__(self):
        return "EventTimeTrigger()"


# ---------------------------------------------------------------------
# Window assigners
# ---------------------------------------------------------------------

class WindowAssigner(abc.ABC):
    @abc.abstractmethod
    def assign_windows(self, element, timestamp: int, ctx) -> Iterable[Window]:
        ...

    def get_default_trigger(self) -> Trigger:
        return EventTimeTrigger()

    @abc.abstractmethod
    def is_event_time(self) -> bool:
        ...

    def is_merging(self) -> bool:
        return False

    def window_type(self):
        return TimeWindow


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


class SlidingEventTimeWindows(WindowAssigner):
    """Windows of ``size`` every ``slide``; a record lands in each."""

    def __init__(self, size, slide, offset=0):
        self.size = _ms(size)
        self.slide = _ms(slide)
        self.offset = _ms(offset)

    @staticmethod
    def of(size, slide, offset=0) -> "SlidingEventTimeWindows":
        return SlidingEventTimeWindows(size, slide, offset)

    def assign_windows(self, element, timestamp, ctx):
        if timestamp is None:
            raise ValueError("record has no timestamp for event-time windowing")
        windows = []
        start = TimeWindow.get_window_start_with_offset(
            timestamp, self.offset, self.slide)
        while start > timestamp - self.size:
            windows.append(TimeWindow(start, start + self.size))
            start -= self.slide
        return windows

    def is_event_time(self):
        return True

    def __repr__(self):
        return f"SlidingEventTimeWindows({self.size}/{self.slide})"


class EventTimeSessionWindows(WindowAssigner):
    """[timestamp, timestamp + gap) per record, merged with every
    window it intersects."""

    def __init__(self, gap):
        self.gap = _ms(gap)

    @staticmethod
    def with_gap(gap) -> "EventTimeSessionWindows":
        return EventTimeSessionWindows(gap)

    def assign_windows(self, element, timestamp, ctx):
        if timestamp is None:
            raise ValueError("record has no timestamp for event-time windowing")
        return [TimeWindow(timestamp, timestamp + self.gap)]

    def is_event_time(self):
        return True

    def is_merging(self):
        return True

    def __repr__(self):
        return f"EventTimeSessionWindows({self.gap})"
