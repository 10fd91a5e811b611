"""Timer services (port of ``flink_tpu/streaming/timers.py``).

``InternalTimerService`` keeps an operator's keyed event-time and
processing-time timers in two heaps of (timestamp, seq, key,
namespace), with a set that makes registering the same (timestamp,
key, namespace) twice a no-op.  ``advance_watermark`` fires every due
event-time timer in (timestamp, registration) order;
``pop_due_event_time_timers`` pops them all as columns for the batched
window fire.  Processing-time timers register their earliest deadline
on the operator's ``ProcessingTimeService``.  Timers are state:
``snapshot`` groups them per key group and ``restore`` keeps the groups
of the backend's range.

Three processing-time services: ``TestProcessingTimeService`` is a
manually advanced clock (the test harness's, and the executor's
default); ``PolledProcessingTimeService`` reads the wall clock and
fires due timers only when its owner calls ``fire_due`` (the executor
polls it once per loop turn, so callbacks, and the kernels they
launch, run on the executor's thread); ``SystemProcessingTimeService``
fires on ``threading.Timer`` threads under a callback lock, or, once
the executor sets its ``dispatcher``, hands each due callback to the
executor's loop, which runs it on its own thread.
"""

from __future__ import annotations

import abc
import heapq
import threading
import time as _time
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from flink_tpu_torch.core.keygroups import assign_to_key_group
from flink_tpu_torch.streaming.elements import MIN_TIMESTAMP


class ProcessingTimeService(abc.ABC):
    @abc.abstractmethod
    def get_current_processing_time(self) -> int:
        ...

    @abc.abstractmethod
    def register_timer(self, timestamp: int, callback: Callable[[int], None]):
        ...

    def shutdown(self) -> None:  # noqa: B027
        pass


class SystemProcessingTimeService(ProcessingTimeService):
    """Wall-clock timers on ``threading.Timer`` threads.  Without a
    ``dispatcher`` each callback runs on its timer's thread under the
    callback lock; with one (the executor sets it for a job) a due
    callback is handed to it as a no-argument call, and the executor's
    loop runs it, so every kernel a timer reaches launches from the
    loop's thread."""

    def __init__(self, lock: Optional[threading.Lock] = None):
        self._lock = lock or threading.Lock()
        self._timers: Set[threading.Timer] = set()
        self._shutdown = False
        #: callable(fn) that runs fn on the executor's loop, or None
        self.dispatcher: Optional[Callable[[Callable[[], None]], None]] = None

    def get_current_processing_time(self) -> int:
        return int(_time.time() * 1000)

    def register_timer(self, timestamp: int, callback):
        delay = max(0.0, (timestamp - self.get_current_processing_time()) / 1000.0)
        t_box = []

        def fire():
            with self._lock:
                self._timers.discard(t_box[0])
                if self._shutdown:
                    return
                if self.dispatcher is not None:
                    self.dispatcher(lambda: callback(timestamp))
                else:
                    callback(timestamp)

        t = threading.Timer(delay, fire)
        t_box.append(t)
        t.daemon = True
        self._timers.add(t)
        t.start()
        return t

    def shutdown(self):
        with self._lock:
            self._shutdown = True
        self.reset_timers()

    def reset_timers(self) -> None:
        """Cancel every pending timer: a restarted attempt's operators
        register their own."""
        with self._lock:
            timers = list(self._timers)
            self._timers.clear()
        for t in timers:
            t.cancel()


class PolledProcessingTimeService(ProcessingTimeService):
    """Wall-clock timers fired on the caller's thread by ``fire_due``."""

    def __init__(self):
        self._queue: List[Tuple[int, int, Callable]] = []
        self._seq = 0
        # a source thread may register (ingestion-time contexts) while
        # fire_due pops on the executor's thread
        self._lock = threading.Lock()

    def get_current_processing_time(self) -> int:
        return int(_time.time() * 1000)

    def register_timer(self, timestamp: int, callback):
        with self._lock:
            heapq.heappush(self._queue, (timestamp, self._seq, callback))
            self._seq += 1

    def next_timer(self) -> Optional[int]:
        """The earliest registered timestamp, or None."""
        with self._lock:
            return self._queue[0][0] if self._queue else None

    def fire_due(self) -> int:
        """Fire every timer due at the current clock; returns how many
        fired.  Callbacks run outside the heap lock."""
        now = self.get_current_processing_time()
        fired = 0
        while True:
            with self._lock:
                if not self._queue or self._queue[0][0] > now:
                    break
                ts, _, cb = heapq.heappop(self._queue)
            cb(ts)
            fired += 1
        return fired

    def fire_all_pending(self) -> None:
        """End-of-input drain: fire every timer registered at entry
        whatever the clock says, up to the latest of them, so timers
        that re-arm themselves past it (continuous triggers) stop."""
        with self._lock:
            if not self._queue:
                return
            horizon = max(ts for ts, _, _ in self._queue)
        while True:
            with self._lock:
                if not self._queue or self._queue[0][0] > horizon:
                    return
                ts, _, cb = heapq.heappop(self._queue)
            cb(ts)

    def has_pending(self) -> bool:
        with self._lock:
            return bool(self._queue)

    def reset_timers(self) -> None:
        """Drop every registered timer: a restarted attempt's operators
        register their own."""
        with self._lock:
            self._queue.clear()


class TestProcessingTimeService(ProcessingTimeService):
    """Manually advanced clock for harness tests."""

    def __init__(self):
        self._now = 0
        #: (timestamp, seq, callback) min-heap
        self._queue: List[Tuple[int, int, Callable]] = []
        self._seq = 0

    def get_current_processing_time(self) -> int:
        return self._now

    def register_timer(self, timestamp: int, callback):
        heapq.heappush(self._queue, (timestamp, self._seq, callback))
        self._seq += 1

    def set_current_time(self, now: int) -> None:
        """Advance the clock, firing due timers in order."""
        self._now = now
        while self._queue and self._queue[0][0] <= now:
            ts, _, cb = heapq.heappop(self._queue)
            cb(ts)

    def advance(self, delta: int) -> None:
        self.set_current_time(self._now + delta)

    def fire_all_pending(self) -> None:
        """Advance the clock to the latest registered timer, firing
        everything due; timers that re-arm past it (continuous
        triggers) stop, which bounds a finite job's end-of-input
        drain."""
        if not self._queue:
            return
        horizon = max(ts for ts, _, _ in self._queue)
        self.set_current_time(max(horizon, self._now))

    def has_pending(self) -> bool:
        return bool(self._queue)

    def reset_timers(self) -> None:
        """Drop every registered timer (the clock stays): a restarted
        attempt's operators register their own."""
        self._queue.clear()


class InternalTimer:
    __slots__ = ("timestamp", "key", "namespace")

    def __init__(self, timestamp: int, key, namespace):
        self.timestamp = timestamp
        self.key = key
        self.namespace = namespace

    def __repr__(self):
        return f"Timer({self.timestamp}, {self.key!r}, {self.namespace!r})"


class InternalTimerService:
    """Keyed event-time and processing-time timers for one operator."""

    def __init__(self, name: str, keyed_backend,
                 processing_time_service: ProcessingTimeService,
                 triggerable):
        self.name = name
        self._backend = keyed_backend
        self._pts = processing_time_service
        #: the operator: has on_event_time(timer) / on_processing_time(timer)
        self._triggerable = triggerable
        self.current_watermark = MIN_TIMESTAMP
        # heaps of (timestamp, seq, key, namespace); set for dedup
        self._event_heap: List[Tuple[int, int, Any, Any]] = []
        self._event_set: Set[Tuple[int, Any, Any]] = set()
        self._proc_heap: List[Tuple[int, int, Any, Any]] = []
        self._proc_set: Set[Tuple[int, Any, Any]] = set()
        self._seq = 0
        self._next_proc_registered: Optional[int] = None

    # ---- registration (key = backend's current key) -----------------
    def register_event_time_timer(self, namespace, timestamp: int) -> None:
        key = self._backend.current_key
        entry = (timestamp, key, namespace)
        if entry in self._event_set:
            return
        self._event_set.add(entry)
        heapq.heappush(self._event_heap, (timestamp, self._seq, key, namespace))
        self._seq += 1

    def register_event_time_timers_bulk(self, namespace, timestamp: int,
                                        keys) -> None:
        """Register the same (namespace, timestamp) timer for MANY keys
        without touching the backend's current-key context — the
        batched window path registers one trigger/cleanup timer per
        distinct key in a sub-batch.  Semantics per key are identical
        to register_event_time_timer."""
        push = heapq.heappush
        heap = self._event_heap
        seen = self._event_set
        for key in keys:
            entry = (timestamp, key, namespace)
            if entry in seen:
                continue
            seen.add(entry)
            push(heap, (timestamp, self._seq, key, namespace))
            self._seq += 1

    def delete_event_time_timer(self, namespace, timestamp: int) -> None:
        # lazy deletion: remove from the set; heap entries are skipped
        self._event_set.discard((timestamp, self._backend.current_key, namespace))

    def register_processing_time_timer(self, namespace, timestamp: int) -> None:
        key = self._backend.current_key
        entry = (timestamp, key, namespace)
        if entry in self._proc_set:
            return
        self._proc_set.add(entry)
        heapq.heappush(self._proc_heap, (timestamp, self._seq, key, namespace))
        self._seq += 1
        if self._next_proc_registered is None or timestamp < self._next_proc_registered:
            self._next_proc_registered = timestamp
            self._pts.register_timer(timestamp, self._on_processing_time)

    def delete_processing_time_timer(self, namespace, timestamp: int) -> None:
        self._proc_set.discard((timestamp, self._backend.current_key, namespace))

    def num_event_time_timers(self) -> int:
        return len(self._event_set)

    def num_processing_time_timers(self) -> int:
        return len(self._proc_set)

    # ---- firing -----------------------------------------------------
    def advance_watermark(self, watermark: int) -> None:
        """Fire every event-time timer <= watermark."""
        self.current_watermark = watermark
        while self._event_heap and self._event_heap[0][0] <= watermark:
            ts, _, key, namespace = heapq.heappop(self._event_heap)
            entry = (ts, key, namespace)
            if entry not in self._event_set:
                continue  # deleted
            self._event_set.remove(entry)
            self._backend.set_current_key(key)
            self._triggerable.on_event_time(InternalTimer(ts, key, namespace))

    def pop_due_event_time_timers(
            self, watermark: int) -> Tuple[List[int], List[Any], List[Any]]:
        """Bulk sweep: pop EVERY due event-time timer <= watermark and
        return (timestamps, keys, namespaces) as parallel columns in
        the exact per-row order advance_watermark would have fired
        them (heap (timestamp, seq) order; lazily-deleted entries
        skipped).  The watermark advances exactly as advance_watermark
        does; FIRING is the caller's job.

        Contract: only valid when the caller's timer callbacks would
        not have registered NEW timers <= watermark mid-drain (the
        batched window fire path qualifies: the default
        EventTimeTrigger registers nothing from on_event_time) — a
        timer registered during the sweep's processing fires on the
        NEXT watermark instead of the current one."""
        self.current_watermark = watermark
        heap = self._event_heap
        live = self._event_set
        timestamps: List[int] = []
        keys: List[Any] = []
        namespaces: List[Any] = []
        pop = heapq.heappop
        while heap and heap[0][0] <= watermark:
            ts, _, key, namespace = pop(heap)
            entry = (ts, key, namespace)
            if entry not in live:
                continue  # deleted
            live.remove(entry)
            timestamps.append(ts)
            keys.append(key)
            namespaces.append(namespace)
        return timestamps, keys, namespaces

    def delete_event_time_timers_bulk(self, entries) -> None:
        """Bulk lazy delete: `entries` yields (timestamp, key,
        namespace) triples.  Semantics per entry are identical to
        delete_event_time_timer (set removal; stale heap nodes are
        skipped on pop) without touching the backend's current-key
        context — the batched fire path drops every cleaned window's
        trigger timer in one call."""
        self._event_set.difference_update(entries)

    def pop_due_processing_time_timers(
            self, now: int) -> Tuple[List[int], List[Any], List[Any]]:
        """Bulk sweep of every due processing-time timer <= now, as
        (timestamps, keys, namespaces) columns in the order the
        per-timer drain fires them (deleted entries skipped); firing is
        the caller's job.  The same contract as
        ``pop_due_event_time_timers``: valid when the callbacks would
        register no new timer <= now."""
        heap = self._proc_heap
        live = self._proc_set
        timestamps: List[int] = []
        keys: List[Any] = []
        namespaces: List[Any] = []
        pop = heapq.heappop
        while heap and heap[0][0] <= now:
            ts, _, key, namespace = pop(heap)
            entry = (ts, key, namespace)
            if entry not in live:
                continue
            live.remove(entry)
            timestamps.append(ts)
            keys.append(key)
            namespaces.append(namespace)
        return timestamps, keys, namespaces

    def _on_processing_time(self, fired_at: int) -> None:
        """Fire the due processing-time timers: as one batch when the
        operator takes it (``on_processing_time_batch`` returns True),
        else one callback a timer."""
        self._next_proc_registered = None
        now = self._pts.get_current_processing_time()
        fire_batch = getattr(self._triggerable, "on_processing_time_batch",
                             None)
        if fire_batch is not None and fire_batch(now):
            pass
        else:
            self._fire_processing_time_timers(now)
        if self._proc_heap:
            nxt = self._proc_heap[0][0]
            self._next_proc_registered = nxt
            self._pts.register_timer(nxt, self._on_processing_time)

    def _fire_processing_time_timers(self, now: int) -> None:
        while self._proc_heap and self._proc_heap[0][0] <= now:
            ts, _, key, namespace = heapq.heappop(self._proc_heap)
            entry = (ts, key, namespace)
            if entry not in self._proc_set:
                continue
            self._proc_set.remove(entry)
            self._backend.set_current_key(key)
            self._triggerable.on_processing_time(InternalTimer(ts, key, namespace))

    # ---- snapshot (timers are state, keyed per key group) -----------
    def snapshot(self) -> dict:
        per_kg_event: Dict[int, list] = {}
        per_kg_proc: Dict[int, list] = {}
        mp = self._backend.max_parallelism
        for ts, key, namespace in self._event_set:
            per_kg_event.setdefault(assign_to_key_group(key, mp), []).append(
                (ts, key, namespace))
        for ts, key, namespace in self._proc_set:
            per_kg_proc.setdefault(assign_to_key_group(key, mp), []).append(
                (ts, key, namespace))
        return {"watermark": self.current_watermark,
                "event": per_kg_event, "proc": per_kg_proc}

    def restore(self, snapshots: List[dict]) -> None:
        self._event_heap.clear()
        self._event_set.clear()
        self._proc_heap.clear()
        self._proc_set.clear()
        rng = self._backend.key_group_range
        saved_key = self._backend.current_key
        for snap in snapshots:
            for kg, timers in snap.get("event", {}).items():
                if not rng.contains(kg):
                    continue
                for ts, key, namespace in timers:
                    self._backend.set_current_key(key)
                    self.register_event_time_timer(namespace, ts)
            for kg, timers in snap.get("proc", {}).items():
                if not rng.contains(kg):
                    continue
                for ts, key, namespace in timers:
                    self._backend.set_current_key(key)
                    self.register_processing_time_timer(namespace, ts)
        if saved_key is not None:
            self._backend.set_current_key(saved_key)
