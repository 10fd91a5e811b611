"""End-to-end tracing and kernel profiling (port of
``flink_tpu/runtime/tracing.py``; span, ledger and gauge names are the
reference's, so one job gives the same observability output in both
packages).

Four cooperating pieces share one registry surface:

* **Span tracing** — :class:`Tracer` with a ``span(name, **attrs)``
  context manager, a thread-local span stack (parent/child + self-time
  attribution), a bounded ring of finished spans with a drop count, and
  Chrome trace-event JSON export (Perfetto / ``chrome://tracing``).
  When disabled, ``span()`` returns a shared no-op object: one
  attribute check, nothing allocated.

* **Host-runtime profiling** — ``record_kernel(name, t0_ns, t1_ns)``,
  called by the wrappers in :mod:`flink_tpu_torch.native` around every
  C++ host-runtime entry while the tracer or the device telemetry is
  on: dispatch counters and wall-time reservoirs per ``native.<name>``.

* **The CUDA launch ledger** — ``LAUNCH_LEDGER``, fed by
  ``kernels.loader.launch``: while the tracer or the device telemetry
  is on, each launch of a hand-written kernel is counted under
  ``cuda.<kernel>`` and bracketed by a pair of CUDA timing events on
  the launch's stream.  The pairs wait in a bounded pending list and
  are resolved without a sync on the hot path: by ``kernel_stats()``,
  ``Tracer.chrome_trace()``, ``DeviceTelemetry.payload()`` or the
  job's end, after one ``torch.cuda.synchronize()``.  The count is
  taken at the launch, so it equals the ``kernels.LAUNCHES`` delta
  exactly; a launch whose pair fell out of a full pending list still
  counts, as ``untimed``.

* **Dispatch accounting** — :func:`traced_call` is the port's twin of
  the reference's ``traced_jit``: the same per-label dispatch count,
  wall time and bytes in/out into ``DeviceTelemetry``, under the
  reference's labels, without compile tracking (the port compiles
  nothing per shape).  Builds report through
  :func:`record_compile_event`: each nvcc kernel build as
  ``cuda.build.<kernel>``, the host runtime's g++ build as
  ``native.build.host_runtime``.

All of it feeds :class:`MetricRegistry` through
:func:`register_runtime_profile_gauges`; names that appear after
registration back-fill into every registered registry.
"""
from __future__ import annotations

import json
import os
import threading
import time
import uuid
import weakref
from collections import deque
from typing import Any, Callable, Dict, List, Optional

__all__ = [
    "Tracer",
    "get_tracer",
    "set_tracer",
    "make_trace_context",
    "clock_anchor",
    "estimate_clock_offset",
    "build_cluster_trace",
    "traced_call",
    "LAUNCH_LEDGER",
    "record_kernel",
    "record_compile_event",
    "kernel_stats",
    "jit_stats",
    "reset_kernel_stats",
    "reset_jit_stats",
    "register_runtime_profile_gauges",
]

_perf_ns = time.perf_counter_ns

# one lock guards the aggregate stores (kernel + jit + span stats and
# the registered-registry list); all updates are batch-level, not
# per-record, so contention is negligible
_LOCK = threading.Lock()


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


class _Reservoir:
    """Bounded sliding reservoir of recent durations (milliseconds)."""

    __slots__ = ("values",)

    def __init__(self, size: int = 512):
        self.values: deque = deque(maxlen=size)

    def update(self, v: float) -> None:
        self.values.append(v)

    def quantile(self, q: float) -> float:
        return _percentile(sorted(self.values), q)


# ---------------------------------------------------------------------
# span tracing
# ---------------------------------------------------------------------

class _NullSpan:
    """Shared no-op context manager returned while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set_attr(self, key: str, value: Any) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("tracer", "name", "attrs", "start_ns", "child_ns",
                 "parent")

    def __init__(self, tracer: "Tracer", name: str, attrs: Optional[dict]):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs
        self.child_ns = 0
        self.parent: Optional[_Span] = None

    def set_attr(self, key: str, value: Any) -> None:
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value

    def __enter__(self):
        stack = self.tracer._stack()
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self.start_ns = _perf_ns()
        return self

    def __exit__(self, *exc):
        end_ns = _perf_ns()
        stack = self.tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        dur_ns = end_ns - self.start_ns
        if self.parent is not None:
            self.parent.child_ns += dur_ns
        self.tracer._finish(self, dur_ns)
        return False


class _SpanStat:
    __slots__ = ("count", "total_ms", "self_ms", "reservoir")

    def __init__(self):
        self.count = 0
        self.total_ms = 0.0
        self.self_ms = 0.0
        self.reservoir = _Reservoir()


class Tracer:
    """Span recorder with Chrome trace-event export and per-name
    aggregate stats.  One tracer is process-global (``get_tracer()``);
    instrumentation points check ``tracer.enabled`` and skip all work
    when off."""

    def __init__(self, max_events: int = 100_000):
        self.enabled = False
        self.max_events = max_events
        self._events: deque = deque(maxlen=max_events)
        self._stats: Dict[str, _SpanStat] = {}
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._pid = os.getpid()
        #: spans evicted by the bounded ring (deque maxlen drops the
        #: oldest silently; this makes truncation self-describing)
        self.dropped = 0
        self._seq = 0
        # metric groups (weakrefs) that want per-span-name gauges
        self._metric_groups: List[weakref.ref] = []

    # ---- recording --------------------------------------------------
    def span(self, name: str, **attrs):
        """Context manager timing one unit of work.  Near-free when
        the tracer is disabled (returns a shared no-op)."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, attrs or None)

    def span_linked(self, name: str, ctx: Optional[dict], **attrs):
        """Like :meth:`span`, but causally linked to a propagated
        trace context (``make_trace_context()`` dict stamped on a
        barrier's options or a netchannel frame): the consumer-side
        span carries the producer's ``trace_id`` and points at its
        ``span_id``, so cross-host viewers can stitch the tree."""
        if not self.enabled:
            return _NULL_SPAN
        if ctx:
            attrs["trace_id"] = ctx.get("trace_id")
            attrs["parent_span_id"] = ctx.get("span_id")
        return _Span(self, name, attrs or None)

    # ---- logical lanes ----------------------------------------------
    # All task-manager runners in the single-process executors share
    # THIS tracer; a thread-local lane label partitions their events so
    # the merged cluster trace can render one process lane per worker.
    def set_lane(self, label: Optional[str]) -> None:
        """Tag every event recorded by the CURRENT thread with a
        worker-lane label (e.g. ``tm-0``)."""
        self._tls.lane = label

    def current_lane(self) -> Optional[str]:
        return getattr(self._tls, "lane", None)

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = []
            self._tls.stack = stack
        return stack

    def _append_locked(self, event: dict) -> None:
        # caller holds self._lock; the ring is full exactly when the
        # next append will evict its oldest event
        if len(self._events) == self.max_events:
            self.dropped += 1
        self._seq += 1
        event["seq"] = self._seq
        self._events.append(event)

    def _finish(self, span: _Span, dur_ns: int) -> None:
        event = {
            "name": span.name,
            "ph": "X",
            "ts": span.start_ns / 1000.0,
            "dur": dur_ns / 1000.0,
            "pid": self._pid,
            "tid": threading.get_ident(),
        }
        lane = getattr(self._tls, "lane", None)
        if lane is not None:
            event["lane"] = lane
        if span.parent is not None:
            event["parent"] = span.parent.name
        if span.attrs:
            event["args"] = span.attrs
        total_ms = dur_ns / 1e6
        self_ms = (dur_ns - span.child_ns) / 1e6
        with self._lock:
            self._append_locked(event)
            stat = self._stats.get(span.name)
            if stat is None:
                stat = self._stats[span.name] = _SpanStat()
                self._register_span_gauges(span.name, stat)
            stat.count += 1
            stat.total_ms += total_ms
            stat.self_ms += self_ms
            stat.reservoir.update(total_ms)

    def record_instant(self, name: str, **attrs) -> None:
        """Record a zero-duration marker event (checkpoint triggers,
        compile events...)."""
        if not self.enabled:
            return
        event = {
            "name": name,
            "ph": "i",
            "ts": _perf_ns() / 1000.0,
            "pid": self._pid,
            "tid": threading.get_ident(),
            "s": "t",
        }
        lane = getattr(self._tls, "lane", None)
        if lane is not None:
            event["lane"] = lane
        if attrs:
            event["args"] = attrs
        with self._lock:
            self._append_locked(event)

    # ---- export -----------------------------------------------------
    def recent(self, limit: int = 200) -> List[dict]:
        """Most recent finished spans, oldest first."""
        with self._lock:
            events = list(self._events)
        return events[-limit:]

    def chrome_trace(self) -> dict:
        """The Chrome trace-event JSON object (``traceEvents`` uses
        complete events: ``ph``/``ts``/``dur``/``pid``/``tid``/
        ``name``; timestamps are microseconds).  When the bounded ring
        has evicted events, the export says so in ``metadata`` instead
        of silently presenting a truncated timeline as complete.  The
        launch ledger's pending CUDA events resolve first (one
        synchronize), so the ``device`` lane is complete."""
        LAUNCH_LEDGER.resolve()
        with self._lock:
            events = list(self._events)
            dropped = self.dropped
        trace = {"traceEvents": events, "displayTimeUnit": "ms"}
        if dropped:
            trace["metadata"] = {
                "dropped_events": dropped,
                "warning": (f"trace truncated: {dropped} oldest events "
                            f"dropped at the {self.max_events}-event "
                            f"ring limit"),
            }
        return trace

    def export_since(self, seq: int, lane: Optional[str] = None) -> dict:
        """Incremental buffer export for cross-process shipping: every
        event appended after sequence number ``seq`` (optionally only
        one lane's), plus a clock anchor pairing this process's
        ``perf_counter`` epoch with its wall clock — the receiver
        converts span timestamps to wall time, then applies the
        RPC-estimated inter-host offset."""
        LAUNCH_LEDGER.resolve()
        with self._lock:
            events = [e for e in self._events if e.get("seq", 0) > seq]
            max_seq = self._seq
        if lane is not None:
            events = [e for e in events if e.get("lane") == lane]
        return {"events": events, "anchor": clock_anchor(),
                "seq": max_seq, "pid": self._pid}

    def lane_buffers(self, default_lane: str = "main") -> Dict[str, dict]:
        """The full event buffer partitioned by worker lane, each with
        the (shared, same-process) clock anchor — the single-process
        executors' input to :func:`build_cluster_trace`."""
        LAUNCH_LEDGER.resolve()
        anchor = clock_anchor()
        with self._lock:
            events = list(self._events)
        buffers: Dict[str, dict] = {}
        for ev in events:
            lane = ev.get("lane", default_lane)
            buf = buffers.get(lane)
            if buf is None:
                buf = buffers[lane] = {"events": [], "anchor": anchor}
            buf["events"].append(ev)
        return buffers

    def write_chrome_trace(self, path: str) -> int:
        """Write the trace file; returns the number of events."""
        trace = self.chrome_trace()
        with open(path, "w") as f:
            json.dump(trace, f)
        return len(trace["traceEvents"])

    def stats(self) -> Dict[str, dict]:
        """Aggregated per-span-name stats."""
        out = {}
        with self._lock:
            for name, st in self._stats.items():
                vals = sorted(st.reservoir.values)
                out[name] = {
                    "count": st.count,
                    "total_ms": st.total_ms,
                    "self_ms": st.self_ms,
                    "p50_ms": _percentile(vals, 0.50),
                    "p99_ms": _percentile(vals, 0.99),
                }
        return out

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._stats.clear()
            self.dropped = 0

    # ---- metric registry feed --------------------------------------
    def install_metrics(self, group) -> None:
        """Register per-span-name aggregate gauges under ``group``
        (a ``MetricGroup``); names that appear later back-fill."""
        with self._lock:
            self._metric_groups.append(weakref.ref(group))
            group.gauge("dropped", lambda: self.dropped)
            for name, stat in self._stats.items():
                self._add_gauges(group, name, stat)

    def _register_span_gauges(self, name: str, stat: _SpanStat) -> None:
        # caller holds self._lock
        alive = []
        for ref in self._metric_groups:
            group = ref()
            if group is None:
                continue
            alive.append(ref)
            self._add_gauges(group, name, stat)
        self._metric_groups[:] = alive

    @staticmethod
    def _add_gauges(group, name: str, stat: _SpanStat) -> None:
        g = group.add_group(name)
        g.gauge("count", lambda s=stat: s.count)
        g.gauge("totalMs", lambda s=stat: s.total_ms)
        g.gauge("selfMs", lambda s=stat: s.self_ms)
        g.gauge("p50Ms", lambda s=stat: s.reservoir.quantile(0.50))
        g.gauge("p99Ms", lambda s=stat: s.reservoir.quantile(0.99))


_tracer = Tracer()


def get_tracer() -> Tracer:
    return _tracer


def set_tracer(tracer: Tracer) -> Tracer:
    global _tracer
    _tracer = tracer
    return tracer


# ---------------------------------------------------------------------
# cluster-causal tracing: context propagation + clock alignment
# ---------------------------------------------------------------------

def make_trace_context() -> dict:
    """A Dapper-style propagation context (Sigelman et al., 2010):
    stamped onto checkpoint-barrier options and netchannel frames so
    consumer-side spans on other hosts link back to the producer."""
    return {"trace_id": uuid.uuid4().hex[:16],
            "span_id": uuid.uuid4().hex[:16]}


def clock_anchor() -> dict:
    """One (perf_counter, wall clock) pair sampled together: converts
    this process's span timestamps (perf-epoch µs) to wall-clock µs."""
    return {"perf_us": _perf_ns() / 1000.0,
            "wall_us": time.time() * 1e6}


def estimate_clock_offset(probe: Callable[[], float],
                          samples: int = 8) -> dict:
    """Min-RTT-midpoint clock-offset estimate (the NTP idea, one
    peer): ``probe()`` round-trips to the remote and returns its wall
    clock in µs; the sample with the smallest RTT bounds the offset
    tightest, and the midpoint assumption splits that RTT evenly.
    Returns ``{"offset_us": remote − local, "rtt_us": best}``."""
    best_rtt: Optional[float] = None
    best_off = 0.0
    for _ in range(max(1, samples)):
        t0 = time.time()
        remote_us = probe()
        t1 = time.time()
        rtt_us = (t1 - t0) * 1e6
        offset_us = remote_us - (t0 * 1e6 + rtt_us / 2.0)
        if best_rtt is None or rtt_us < best_rtt:
            best_rtt = rtt_us
            best_off = offset_us
    return {"offset_us": best_off, "rtt_us": best_rtt or 0.0}


def build_cluster_trace(buffers: Dict[str, dict],
                        offsets: Optional[Dict[str, float]] = None
                        ) -> dict:
    """Merge per-worker tracer buffers into ONE Chrome trace with one
    process lane per worker and clock-aligned timestamps.

    ``buffers`` maps a lane label to ``{"events": [...], "anchor":
    {"perf_us", "wall_us"}}`` (the :meth:`Tracer.export_since` /
    :meth:`Tracer.lane_buffers` shape); ``offsets`` maps a lane to its
    host's wall-clock offset in µs relative to the assembler
    (``estimate_clock_offset`` — subtracted to align).  Timestamps are
    normalized to the earliest aligned event so the merged view starts
    at t=0."""
    offsets = offsets or {}
    merged: List[dict] = []
    lanes_meta: Dict[str, dict] = {}
    lane_order = sorted(buffers)
    for idx, lane in enumerate(lane_order, start=1):
        buf = buffers[lane] or {}
        anchor = buf.get("anchor") or {}
        shift = (anchor.get("wall_us", 0.0) - anchor.get("perf_us", 0.0)
                 - float(offsets.get(lane, 0.0)))
        events = buf.get("events") or []
        lanes_meta[lane] = {"pid": idx,
                            "offset_us": float(offsets.get(lane, 0.0)),
                            "events": len(events)}
        for ev in events:
            e = dict(ev)
            e["ts"] = float(ev.get("ts", 0.0)) + shift
            e["pid"] = idx
            e.pop("seq", None)
            merged.append(e)
    if merged:
        t0 = min(e["ts"] for e in merged)
        for e in merged:
            e["ts"] -= t0
    merged.sort(key=lambda e: e["ts"])
    events: List[dict] = [
        {"name": "process_name", "ph": "M", "pid": idx, "tid": 0,
         "args": {"name": lane}}
        for idx, lane in enumerate(lane_order, start=1)]
    events.extend(merged)
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "metadata": {"lanes": lanes_meta}}


# ---------------------------------------------------------------------
# host-runtime profiling (fed by flink_tpu_torch.native wrappers)
# ---------------------------------------------------------------------

class _KernelStat:
    __slots__ = ("dispatches", "total_ms", "reservoir")

    def __init__(self):
        self.dispatches = 0
        self.total_ms = 0.0
        self.reservoir = _Reservoir()


_kernel_stats: Dict[str, _KernelStat] = {}


def record_kernel(name: str, t0_ns: int, t1_ns: int) -> None:
    """Account one host-runtime dispatch (called by the wrappers in
    ``flink_tpu_torch/native/__init__.py`` while the tracer or the
    device telemetry is on)."""
    ms = (t1_ns - t0_ns) / 1e6
    with _LOCK:
        stat = _kernel_stats.get(name)
        if stat is None:
            stat = _kernel_stats[name] = _KernelStat()
            _backfill_kernel_gauges(name, stat)
        stat.dispatches += 1
        stat.total_ms += ms
        stat.reservoir.update(ms)
    tracer = _tracer
    if tracer.enabled:
        event = {
            "name": "native." + name,
            "ph": "X",
            "ts": t0_ns / 1000.0,
            "dur": (t1_ns - t0_ns) / 1000.0,
            "pid": tracer._pid,
            "tid": threading.get_ident(),
        }
        lane = tracer.current_lane()
        if lane is not None:
            event["lane"] = lane
        with tracer._lock:
            tracer._append_locked(event)


def kernel_stats() -> Dict[str, dict]:
    """Per-kernel dispatch counters + time summaries: the host-runtime
    entries by name (wall time), and the CUDA kernels as
    ``cuda.<kernel>`` (device time from the launch ledger, resolved
    here after one synchronize; ``dispatches`` is the launch count)."""
    out = {}
    with _LOCK:
        for name, st in _kernel_stats.items():
            vals = sorted(st.reservoir.values)
            out[name] = {
                "dispatches": st.dispatches,
                "total_ms": st.total_ms,
                "p50_ms": _percentile(vals, 0.50),
                "p99_ms": _percentile(vals, 0.99),
            }
    for name, st in LAUNCH_LEDGER.stats().items():
        out[name] = {"dispatches": st["launches"],
                     "total_ms": st["device_ms"],
                     "p50_ms": st["p50_ms"], "p99_ms": st["p99_ms"],
                     "untimed": st["untimed"]}
    return out


def reset_kernel_stats() -> None:
    with _LOCK:
        _kernel_stats.clear()
    LAUNCH_LEDGER.reset()


# ---------------------------------------------------------------------
# the CUDA launch ledger (fed by kernels.loader.launch)
# ---------------------------------------------------------------------

#: Chrome-trace thread id of device d's row: DEVICE_TID_BASE + d, apart
#: from every host thread
DEVICE_TID_BASE = 1 << 20


class _LaunchStat:
    __slots__ = ("launches", "timed", "untimed", "device_ms", "reservoir")

    def __init__(self):
        self.launches = 0
        self.timed = 0
        self.untimed = 0
        self.device_ms = 0.0
        self.reservoir = _Reservoir()


def _cuda_event():
    import torch
    return torch.cuda.Event(enable_timing=True)


def _cuda_device() -> int:
    import torch
    return torch.cuda.current_device()


def _cuda_synchronize(device: int) -> None:
    import torch
    torch.cuda.synchronize(device)


class LaunchLedger:
    """Per-kernel launch counts and device time of the hand-written
    CUDA kernels, from CUDA timing events.

    ``record(kernel, call)`` runs one launch: it counts it, records a
    start event, calls ``call()`` (the ctypes launch on the current
    stream), records an end event and queues the pair.  Nothing waits
    for the card there.  ``resolve()`` synchronizes once, reads every
    queued pair's elapsed time into the per-kernel stats and, while the
    tracer is on, turns each into a ``cuda.<kernel>`` complete event on
    the ``device`` lane of the Chrome trace.

    Placement on the trace clock is approximate: the first launch on a
    device after a reset also records an anchor event there, paired
    with the host's ``perf_counter_ns`` at that moment, and each
    launch's start lands at anchor + (its start event − the anchor
    event).  The gap between
    the anchor's host stamp and the moment the card reaches it shifts
    every device event by the same amount.

    ``enabled`` is not stored here: the caller launches through the
    ledger while the tracer or the device telemetry is on.

    Threads may launch at once (a queryable-state read launches from
    its client's thread while the job's loop launches): one lock covers
    a launch's count, its event pair and the call between them, and
    every read of the queue, so no count is lost, no pair is accounted
    twice and no pair brackets another thread's launch."""

    #: queued event pairs before launches go untimed
    MAX_PENDING = 1 << 16

    def __init__(self, max_pending: int = MAX_PENDING):
        self.max_pending = max_pending
        self._pending: List[tuple] = []
        self._stats: Dict[str, _LaunchStat] = {}
        #: device index -> (anchor event, perf_ns)
        self._anchors: Dict[int, tuple] = {}
        self._lock = threading.RLock()
        #: the CUDA hooks (tests substitute host stand-ins)
        self.event_factory = _cuda_event
        self.current_device = _cuda_device
        self.synchronize = _cuda_synchronize

    def record(self, kernel: str, call: Callable[[], Any]) -> Any:
        with self._lock:
            stat = self._stats.get(kernel)
            if stat is None:
                stat = self._stats[kernel] = _LaunchStat()
            stat.launches += 1
            if len(self._pending) >= self.max_pending:
                self._drain_completed()
            if len(self._pending) >= self.max_pending:
                stat.untimed += 1
                return call()
            ev = self.event_factory
            dev = self.current_device()
            if dev not in self._anchors:
                anchor = ev()
                anchor.record()
                self._anchors[dev] = (anchor, _perf_ns())
            start, end = ev(), ev()
            start.record()
            out = call()
            end.record()
            self._pending.append((kernel, start, end, dev))
            return out

    def _drain_completed(self) -> None:
        """Resolve the oldest pairs whose end event the card has passed
        (``query()`` does not block)."""
        with self._lock:
            done = 0
            for item in self._pending:
                if not item[2].query():
                    break
                done += 1
            if done:
                items = self._pending[:done]
                del self._pending[:done]
                self._account(items)

    def resolve(self) -> None:
        """Synchronize once and account every queued pair."""
        with self._lock:
            if not self._pending:
                return
            for dev in sorted({item[3] for item in self._pending}):
                self.synchronize(dev)
            items, self._pending = self._pending, []
            self._account(items)

    def _account(self, items) -> None:
        tracer = _tracer
        events = []
        for kernel, start, end, dev in items:
            ms = start.elapsed_time(end)
            stat = self._stats[kernel]
            stat.timed += 1
            stat.device_ms += ms
            stat.reservoir.update(ms)
            anchor = self._anchors.get(dev)
            if tracer.enabled and anchor is not None:
                ts = (anchor[1] / 1000.0
                      + anchor[0].elapsed_time(start) * 1000.0)
                events.append({"name": "cuda." + kernel, "ph": "X",
                               "ts": ts, "dur": ms * 1000.0,
                               "pid": tracer._pid,
                               "tid": DEVICE_TID_BASE + dev,
                               "lane": "device",
                               "args": {"device": dev,
                                        "placement": "approximate"}})
        if events:
            with tracer._lock:
                for e in events:
                    tracer._append_locked(e)

    def stats(self, resolve: bool = True) -> Dict[str, dict]:
        """``{"cuda.<kernel>": {launches, timed, untimed, device_ms,
        p50_ms, p99_ms}}``, after a resolve unless ``resolve`` is
        False."""
        if resolve:
            self.resolve()
        out = {}
        with self._lock:
            stats = sorted(self._stats.items())
        for kernel, st in stats:
            vals = sorted(st.reservoir.values)
            out["cuda." + kernel] = {
                "launches": st.launches, "timed": st.timed,
                "untimed": st.untimed, "device_ms": st.device_ms,
                "p50_ms": _percentile(vals, 0.50),
                "p99_ms": _percentile(vals, 0.99)}
        return out

    def pending(self) -> int:
        return len(self._pending)

    def reset(self) -> None:
        """Drop the stats and every queued pair (unresolved pairs are
        lost), and take a new anchor at the next launch."""
        with self._lock:
            self._pending = []
            self._stats.clear()
            self._anchors.clear()


LAUNCH_LEDGER = LaunchLedger()


# ---------------------------------------------------------------------
# dispatch accounting (the reference's traced_jit) and build events
# ---------------------------------------------------------------------

class _JitStat:
    __slots__ = ("recompiles", "compile_time_ms", "cache_hits",
                 "last_shape_sig", "shape_sigs")

    def __init__(self):
        self.recompiles = 0
        self.compile_time_ms = 0.0
        self.cache_hits = 0
        self.last_shape_sig = ""
        self.shape_sigs: set = set()


_jit_stats: Dict[str, _JitStat] = {}


def _jit_entry(name: str) -> _JitStat:
    with _LOCK:
        stat = _jit_stats.get(name)
        if stat is None:
            stat = _jit_stats[name] = _JitStat()
            _backfill_jit_gauges(name, stat)
        return stat


def traced_call(fn: Callable, name: Optional[str] = None) -> Callable:
    """``fn`` with the reference ``traced_jit``'s dispatch accounting:
    while the device telemetry is on, each call adds its wall time and
    the bytes of its arguments and result (``tree_nbytes``) to the
    telemetry's kernel entry ``name``.  Off, the call costs one
    attribute check.  The port runs eagerly, so there is no compile to
    track."""
    from flink_tpu_torch.runtime.device_stats import TELEMETRY, tree_nbytes

    label = name or getattr(fn, "__name__", None) or "call"

    def wrapper(*args, **kwargs):
        if not TELEMETRY.enabled:
            return fn(*args, **kwargs)
        t0 = _perf_ns()
        out = fn(*args, **kwargs)
        TELEMETRY.record_kernel_dispatch(
            label, (_perf_ns() - t0) / 1e6,
            tree_nbytes((args, kwargs)), tree_nbytes(out))
        return out

    wrapper.__name__ = "traced_" + label.replace(".", "_")
    wrapper._traced_label = label
    wrapper._fn = fn
    return wrapper


def record_compile_event(name: str, seconds: float) -> None:
    """Account one build (an nvcc kernel build, the host runtime's g++
    build) in the compile store."""
    stat = _jit_entry(name)
    ms = seconds * 1000.0
    with _LOCK:
        stat.recompiles += 1
        stat.compile_time_ms += ms
    tracer = _tracer
    if tracer.enabled:
        tracer.record_instant("compile." + name, compile_ms=round(ms, 3))


def jit_stats() -> Dict[str, dict]:
    out = {}
    with _LOCK:
        for name, st in _jit_stats.items():
            out[name] = {
                "recompiles": st.recompiles,
                "compile_time_ms": st.compile_time_ms,
                "cache_hits": st.cache_hits,
                "shape_variants": len(st.shape_sigs),
                "last_shape_sig": st.last_shape_sig,
            }
    return out


def reset_jit_stats() -> None:
    with _LOCK:
        _jit_stats.clear()


# ---------------------------------------------------------------------
# registry wiring
# ---------------------------------------------------------------------

# (weakref-to-root-group, kind) pairs; kernel/jit names discovered
# after registration back-fill into every live registered group
_profile_groups: List[weakref.ref] = []
_registered_registry_ids: "weakref.WeakSet" = weakref.WeakSet()


def _backfill_kernel_gauges(name: str, stat: _KernelStat) -> None:
    # caller holds _LOCK
    for ref in list(_profile_groups):
        root = ref()
        if root is None:
            _profile_groups.remove(ref)
            continue
        _add_kernel_gauges(root.add_group("native"), name, stat)


def _backfill_jit_gauges(name: str, stat: _JitStat) -> None:
    # caller holds _LOCK
    for ref in list(_profile_groups):
        root = ref()
        if root is None:
            _profile_groups.remove(ref)
            continue
        _add_jit_gauges(root.add_group("jit"), name, stat)


def _add_kernel_gauges(group, name: str, stat: _KernelStat) -> None:
    g = group.add_group(name)
    g.gauge("dispatches", lambda s=stat: s.dispatches)
    g.gauge("totalMs", lambda s=stat: s.total_ms)
    g.gauge("p50Ms", lambda s=stat: s.reservoir.quantile(0.50))
    g.gauge("p99Ms", lambda s=stat: s.reservoir.quantile(0.99))


def _add_jit_gauges(group, name: str, stat: _JitStat) -> None:
    g = group.add_group(name)
    g.gauge("recompiles", lambda s=stat: s.recompiles)
    g.gauge("compileTimeMs", lambda s=stat: s.compile_time_ms)
    g.gauge("cacheHits", lambda s=stat: s.cache_hits)
    g.gauge("shapeVariants", lambda s=stat: len(s.shape_sigs))
    g.gauge("lastArgShapes", lambda s=stat: s.last_shape_sig)


def register_runtime_profile_gauges(registry) -> None:
    """Publish host-runtime dispatch stats, build stats, the CUDA
    launch ledger's counts and span aggregates into ``registry`` (a :class:`MetricRegistry`).
    Idempotent per registry; kernel/jit/span names that first appear
    after registration (engines tier-select on first flush) back-fill
    automatically."""
    if registry in _registered_registry_ids:
        return
    _registered_registry_ids.add(registry)
    root = registry.root
    with _LOCK:
        _profile_groups.append(weakref.ref(root))
        native_group = root.add_group("native")
        for name, stat in _kernel_stats.items():
            _add_kernel_gauges(native_group, name, stat)
        jit_group = root.add_group("jit")
        for name, stat in _jit_stats.items():
            _add_jit_gauges(jit_group, name, stat)
    _tracer.install_metrics(root.add_group("tracing"))
    # the launch ledger: counts are exact at any read; device ms cover
    # the pairs resolved so far (a gauge read never synchronizes)
    cuda = root.add_group("cuda")
    cuda.gauge("launches", lambda: {
        k: st.launches for k, st in LAUNCH_LEDGER._stats.items()})
    cuda.gauge("deviceMs", lambda: {
        k: st.device_ms for k, st in LAUNCH_LEDGER._stats.items()})
    cuda.gauge("pending", LAUNCH_LEDGER.pending)
