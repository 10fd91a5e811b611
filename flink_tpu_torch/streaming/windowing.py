"""Windows, assigners, triggers and evictors (port of
``flink_tpu/streaming/windowing.py``).

A ``TimeWindow`` covers [start, end); max_timestamp = end - 1; its
namespace in keyed state is the tuple (start, end).  Tumbling and
sliding starts align to ``timestamp - (timestamp - offset) % slide``;
a session window is [timestamp, timestamp + gap) (the gap per element
for ``DynamicEventTimeSessionWindows``) and merges with every window it
intersects.  ``GlobalWindows`` puts everything into the one
``GlobalWindow`` (namespace ``("__global__",)``, max_timestamp
``MAX_TIMESTAMP``), which fires only by a trigger.  Triggers:
``EventTimeTrigger`` (the event-time default), ``ProcessingTimeTrigger``
(the processing-time default), ``CountTrigger``, ``PurgingTrigger``,
``ContinuousEventTimeTrigger``, ``ContinuousProcessingTimeTrigger`` and
``DeltaTrigger``; evictors (``CountEvictor``, ``TimeEvictor``,
``DeltaEvictor``) run in ``EvictingWindowOperator``.  The
processing-time assigners (tumbling, sliding, sessions with a fixed or
a per-element gap) place a record by the operator's processing-time
clock at arrival instead of its timestamp.
"""

from __future__ import annotations

import abc
from typing import Any, Callable, Iterable, List, Optional, Tuple

from flink_tpu_torch.core.state import (ReducingStateDescriptor,
                                        ValueStateDescriptor)
from flink_tpu_torch.streaming.elements import MAX_TIMESTAMP


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

    @staticmethod
    def days(d) -> "Time":
        return Time(d * 24 * 60 * 60 * 1000)

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


class GlobalWindow(Window):
    """The one window covering everything."""

    _instance: Optional["GlobalWindow"] = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def max_timestamp(self) -> int:
        return MAX_TIMESTAMP

    def __eq__(self, other):
        return isinstance(other, GlobalWindow)

    def __hash__(self):
        return hash("GlobalWindow")

    def __repr__(self):
        return "GlobalWindow"

    def to_namespace(self):
        return ("__global__",)

    @staticmethod
    def from_namespace(ns) -> "GlobalWindow":
        return GlobalWindow()


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


class ProcessingTimeTrigger(Trigger):
    """FIRE when the processing-time clock passes the window's end."""

    def on_element(self, element, timestamp, window, ctx):
        ctx.register_processing_time_timer(window.max_timestamp())
        return TriggerResult.CONTINUE

    def on_processing_time(self, time, window, ctx):
        return TriggerResult.FIRE

    def can_merge(self):
        return True

    def on_merge(self, window, ctx):
        ctx.register_processing_time_timer(window.max_timestamp())

    def clear(self, window, ctx):
        ctx.delete_processing_time_timer(window.max_timestamp())

    def __repr__(self):
        return "ProcessingTimeTrigger()"


class CountTrigger(Trigger):
    """FIRE every ``max_count`` elements; the count per (key, window)
    is partitioned trigger state."""

    def __init__(self, max_count: int):
        self.max_count = max_count
        self._desc = ReducingStateDescriptor("trigger-count",
                                             lambda a, b: a + b)

    def on_element(self, element, timestamp, window, ctx):
        count = ctx.get_partitioned_state(self._desc)
        count.add(1)
        if count.get() >= self.max_count:
            count.clear()
            return TriggerResult.FIRE
        return TriggerResult.CONTINUE

    def can_merge(self):
        return True

    def on_merge(self, window, ctx):
        # the merged windows' counts fold into the result window's
        if hasattr(ctx, "merge_partitioned_state"):
            ctx.merge_partitioned_state(self._desc)

    def clear(self, window, ctx):
        ctx.get_partitioned_state(self._desc).clear()

    def __repr__(self):
        return f"CountTrigger({self.max_count})"


class PurgingTrigger(Trigger):
    """Wraps a trigger, turning its FIRE into FIRE_AND_PURGE."""

    def __init__(self, inner: Trigger):
        self.inner = inner

    @staticmethod
    def of(inner: Trigger) -> "PurgingTrigger":
        return PurgingTrigger(inner)

    def _wrap(self, r: int) -> int:
        return TriggerResult.FIRE_AND_PURGE if TriggerResult.is_fire(r) else r

    def on_element(self, element, timestamp, window, ctx):
        return self._wrap(self.inner.on_element(element, timestamp, window, ctx))

    def on_event_time(self, time, window, ctx):
        return self._wrap(self.inner.on_event_time(time, window, ctx))

    def on_processing_time(self, time, window, ctx):
        return self._wrap(self.inner.on_processing_time(time, window, ctx))

    def can_merge(self):
        return self.inner.can_merge()

    def on_merge(self, window, ctx):
        self.inner.on_merge(window, ctx)

    def clear(self, window, ctx):
        self.inner.clear(window, ctx)

    def __repr__(self):
        return f"PurgingTrigger({self.inner!r})"


class ContinuousEventTimeTrigger(Trigger):
    """FIRE every ``interval`` of event time while the window is open,
    and at its end."""

    def __init__(self, interval):
        self.interval = _ms(interval)
        self._desc = ReducingStateDescriptor("fire-time", min)

    @staticmethod
    def of(interval) -> "ContinuousEventTimeTrigger":
        return ContinuousEventTimeTrigger(interval)

    def on_element(self, element, timestamp, window, ctx):
        if window.max_timestamp() <= ctx.get_current_watermark():
            return TriggerResult.FIRE
        ctx.register_event_time_timer(window.max_timestamp())
        fire = ctx.get_partitioned_state(self._desc)
        if fire.get() is None:
            start = timestamp - (timestamp % self.interval)
            nxt = start + self.interval
            ctx.register_event_time_timer(nxt)
            fire.add(nxt)
        return TriggerResult.CONTINUE

    def on_event_time(self, time, window, ctx):
        if time == window.max_timestamp():
            return TriggerResult.FIRE
        fire = ctx.get_partitioned_state(self._desc)
        t = fire.get()
        if t is not None and t == time:
            fire.clear()
            fire.add(time + self.interval)
            ctx.register_event_time_timer(time + self.interval)
            return TriggerResult.FIRE
        return TriggerResult.CONTINUE

    def can_merge(self):
        return True

    def on_merge(self, window, ctx):
        if window.max_timestamp() > ctx.get_current_watermark():
            ctx.register_event_time_timer(window.max_timestamp())

    def clear(self, window, ctx):
        fire = ctx.get_partitioned_state(self._desc)
        t = fire.get()
        if t is not None:
            ctx.delete_event_time_timer(t)
        fire.clear()

    def __repr__(self):
        return f"ContinuousEventTimeTrigger({self.interval})"


class ContinuousProcessingTimeTrigger(Trigger):
    """FIRE every ``interval`` of processing time, aligned to the
    interval grid."""

    def __init__(self, interval):
        self.interval = _ms(interval)
        self._desc = ReducingStateDescriptor("fire-time-proc", min)

    def on_element(self, element, timestamp, window, ctx):
        now = ctx.get_current_processing_time()
        fire = ctx.get_partitioned_state(self._desc)
        if fire.get() is None:
            start = now - (now % self.interval)
            nxt = start + self.interval
            ctx.register_processing_time_timer(nxt)
            fire.add(nxt)
        return TriggerResult.CONTINUE

    def on_processing_time(self, time, window, ctx):
        fire = ctx.get_partitioned_state(self._desc)
        t = fire.get()
        if t is not None and t == time:
            fire.clear()
            fire.add(time + self.interval)
            ctx.register_processing_time_timer(time + self.interval)
            return TriggerResult.FIRE
        return TriggerResult.CONTINUE

    def can_merge(self):
        return True

    def on_merge(self, window, ctx):
        pass

    def clear(self, window, ctx):
        fire = ctx.get_partitioned_state(self._desc)
        t = fire.get()
        if t is not None:
            ctx.delete_processing_time_timer(t)
        fire.clear()

    def __repr__(self):
        return f"ContinuousProcessingTimeTrigger({self.interval})"


class DeltaTrigger(Trigger):
    """FIRE when ``delta_function(last fired element, element)`` exceeds
    ``threshold``; the first element of a (key, window) only sets the
    reference point."""

    def __init__(self, threshold: float,
                 delta_function: Callable[[Any, Any], float]):
        self.threshold = threshold
        self.delta_function = delta_function
        self._desc = ValueStateDescriptor("delta-last")

    def on_element(self, element, timestamp, window, ctx):
        last = ctx.get_partitioned_state(self._desc)
        if last.value() is None:
            last.update(element)
            return TriggerResult.CONTINUE
        if self.delta_function(last.value(), element) > self.threshold:
            last.update(element)
            return TriggerResult.FIRE
        return TriggerResult.CONTINUE

    def clear(self, window, ctx):
        ctx.get_partitioned_state(self._desc).clear()

    def __repr__(self):
        return f"DeltaTrigger({self.threshold})"


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


class TumblingProcessingTimeWindows(WindowAssigner):
    """Fixed-size, non-overlapping windows of processing time."""

    def __init__(self, size, offset=0):
        self.size = _ms(size)
        self.offset = _ms(offset)

    @staticmethod
    def of(size, offset=0) -> "TumblingProcessingTimeWindows":
        return TumblingProcessingTimeWindows(size, offset)

    def assign_windows(self, element, timestamp, ctx):
        now = ctx.get_current_processing_time()
        start = TimeWindow.get_window_start_with_offset(now, self.offset, self.size)
        return [TimeWindow(start, start + self.size)]

    def get_default_trigger(self):
        return ProcessingTimeTrigger()

    def is_event_time(self):
        return False

    def __repr__(self):
        return f"TumblingProcessingTimeWindows({self.size})"


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


class SlidingProcessingTimeWindows(WindowAssigner):
    """Windows of ``size`` every ``slide`` of processing time."""

    def __init__(self, size, slide, offset=0):
        self.size = _ms(size)
        self.slide = _ms(slide)
        self.offset = _ms(offset)

    @staticmethod
    def of(size, slide, offset=0) -> "SlidingProcessingTimeWindows":
        return SlidingProcessingTimeWindows(size, slide, offset)

    def assign_windows(self, element, timestamp, ctx):
        now = ctx.get_current_processing_time()
        windows = []
        start = TimeWindow.get_window_start_with_offset(now, self.offset,
                                                        self.slide)
        while start > now - self.size:
            windows.append(TimeWindow(start, start + self.size))
            start -= self.slide
        return windows

    def get_default_trigger(self):
        return ProcessingTimeTrigger()

    def is_event_time(self):
        return False

    def __repr__(self):
        return f"SlidingProcessingTimeWindows({self.size}/{self.slide})"


class _SessionWindowsBase(WindowAssigner):
    def is_merging(self):
        return True


class EventTimeSessionWindows(_SessionWindowsBase):
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

    def __repr__(self):
        return f"EventTimeSessionWindows({self.gap})"


class ProcessingTimeSessionWindows(_SessionWindowsBase):
    """[now, now + gap) of processing time per record, merged with
    every window it intersects."""

    def __init__(self, gap):
        self.gap = _ms(gap)

    @staticmethod
    def with_gap(gap) -> "ProcessingTimeSessionWindows":
        return ProcessingTimeSessionWindows(gap)

    def assign_windows(self, element, timestamp, ctx):
        now = ctx.get_current_processing_time()
        return [TimeWindow(now, now + self.gap)]

    def get_default_trigger(self):
        return ProcessingTimeTrigger()

    def is_event_time(self):
        return False

    def __repr__(self):
        return f"ProcessingTimeSessionWindows({self.gap})"


class DynamicEventTimeSessionWindows(_SessionWindowsBase):
    """Sessions whose gap ``gap_extractor(element)`` gives per
    element."""

    def __init__(self, gap_extractor: Callable[[Any], int]):
        self.gap_extractor = gap_extractor

    @staticmethod
    def with_dynamic_gap(extractor) -> "DynamicEventTimeSessionWindows":
        return DynamicEventTimeSessionWindows(extractor)

    def assign_windows(self, element, timestamp, ctx):
        gap = self.gap_extractor(element)
        if gap <= 0:
            raise ValueError("session gap must be positive")
        return [TimeWindow(timestamp, timestamp + gap)]

    def is_event_time(self):
        return True

    def __repr__(self):
        return "DynamicEventTimeSessionWindows()"


class DynamicProcessingTimeSessionWindows(_SessionWindowsBase):
    """Processing-time sessions whose gap ``gap_extractor(element)``
    gives per element."""

    def __init__(self, gap_extractor: Callable[[Any], int]):
        self.gap_extractor = gap_extractor

    @staticmethod
    def with_dynamic_gap(extractor) -> "DynamicProcessingTimeSessionWindows":
        return DynamicProcessingTimeSessionWindows(extractor)

    def assign_windows(self, element, timestamp, ctx):
        now = ctx.get_current_processing_time()
        gap = self.gap_extractor(element)
        if gap <= 0:
            raise ValueError("session gap must be positive")
        return [TimeWindow(now, now + gap)]

    def get_default_trigger(self):
        return ProcessingTimeTrigger()

    def is_event_time(self):
        return False

    def __repr__(self):
        return "DynamicProcessingTimeSessionWindows()"


class GlobalWindows(WindowAssigner):
    """Everything into the one GlobalWindow; it fires only by a trigger
    (the default never fires)."""

    class NeverTrigger(Trigger):
        def can_merge(self):
            return True

        def on_merge(self, window, ctx):
            pass

        def __repr__(self):
            return "NeverTrigger()"

    @staticmethod
    def create() -> "GlobalWindows":
        return GlobalWindows()

    def assign_windows(self, element, timestamp, ctx):
        return [GlobalWindow()]

    def get_default_trigger(self):
        return GlobalWindows.NeverTrigger()

    def is_event_time(self):
        return False

    def window_type(self):
        return GlobalWindow

    def __repr__(self):
        return "GlobalWindows()"


# ---------------------------------------------------------------------
# Evictors
# ---------------------------------------------------------------------

class Evictor(abc.ABC):
    """Works on the raw element buffer of an EvictingWindowOperator:
    a list of (timestamp, value) pairs, oldest first."""

    @abc.abstractmethod
    def evict_before(self, elements: List[Tuple[int, Any]], size: int,
                     window, current_time: int) -> List[Tuple[int, Any]]:
        ...

    def evict_after(self, elements: List[Tuple[int, Any]], size: int,
                    window, current_time: int) -> List[Tuple[int, Any]]:
        return elements


class CountEvictor(Evictor):
    """Keep the newest ``max_count`` elements."""

    def __init__(self, max_count: int):
        self.max_count = max_count

    @staticmethod
    def of(max_count: int) -> "CountEvictor":
        return CountEvictor(max_count)

    def evict_before(self, elements, size, window, current_time):
        if size <= self.max_count:
            return elements
        return elements[size - self.max_count:]


class TimeEvictor(Evictor):
    """Keep the elements within ``window_size`` of the newest
    timestamp."""

    def __init__(self, window_size):
        self.window_size = _ms(window_size)

    @staticmethod
    def of(window_size) -> "TimeEvictor":
        return TimeEvictor(window_size)

    def evict_before(self, elements, size, window, current_time):
        if not elements:
            return elements
        if not any(ts is not None for ts, _ in elements):
            return elements
        max_ts = max(ts for ts, _ in elements if ts is not None)
        cutoff = max_ts - self.window_size
        return [(ts, v) for ts, v in elements if ts is None or ts > cutoff]


class DeltaEvictor(Evictor):
    """Evict the elements whose delta to the newest is at or over
    ``threshold``."""

    def __init__(self, threshold: float,
                 delta_function: Callable[[Any, Any], float]):
        self.threshold = threshold
        self.delta_function = delta_function

    @staticmethod
    def of(threshold, delta_function) -> "DeltaEvictor":
        return DeltaEvictor(threshold, delta_function)

    def evict_before(self, elements, size, window, current_time):
        if not elements:
            return elements
        newest = elements[-1][1]
        return [(ts, v) for ts, v in elements
                if self.delta_function(v, newest) < self.threshold]
