"""Metrics: counters, gauges, histograms, meters, hierarchical groups,
registry + reporters, latency tracking, checkpoint stats (port of
``flink_tpu/runtime/metrics.py``; the metric names, scopes and dump
shape are the reference's, so one job dumps the same keys in both
packages).

The network, lint and typeflow gauge surfaces wait for the threaded
channels and the static analysis of later slices.

Re-designs the reference metrics stack (flink-metrics-core `Metric`,
`Counter`, `Gauge`, `Histogram`, `Meter`;
flink-runtime/.../metrics/MetricRegistryImpl.java; hierarchical groups
flink-runtime/.../metrics/groups/{TaskManagerMetricGroup,
TaskMetricGroup,OperatorMetricGroup,TaskIOMetricGroup}.java; scope
formats .../metrics/scope/ScopeFormat.java; latency tracking
LatencyStats; checkpoint stats
flink-runtime/.../checkpoint/CheckpointStatsTracker.java; reporters
flink-metrics/flink-metrics-{prometheus,slf4j}/...).

Design notes (single-owner loop): metrics are
updated only from the owning executor loop (or under the source
emission lock), so none of them need atomics; `dump()` may race a
concurrent reader but only ever reads plain ints/floats, which is the
same monitoring-read contract the reference accepts.
"""

from __future__ import annotations

import bisect
import json
import math
import time as _time
from typing import Any, Callable, Dict, List, Optional, Tuple


# ---------------------------------------------------------------------------
# metric types (ref: flink-metrics-core)
# ---------------------------------------------------------------------------

class Counter:
    """(ref: flink-metrics-core Counter / SimpleCounter)"""

    __slots__ = ("count",)

    def __init__(self):
        self.count = 0

    def inc(self, n: int = 1) -> None:
        self.count += n

    def dec(self, n: int = 1) -> None:
        self.count -= n

    def get_count(self) -> int:
        return self.count


class Gauge:
    """Wraps a supplier (ref: flink-metrics-core Gauge<T>).  An optional
    human description feeds the Prometheus `# HELP` line."""

    __slots__ = ("_fn", "description")

    def __init__(self, fn: Callable[[], Any],
                 description: Optional[str] = None):
        self._fn = fn
        self.description = description

    def get_value(self) -> Any:
        return self._fn()


class Histogram:
    """Sliding-reservoir histogram over the last `window` updates
    (ref: DescriptiveStatisticsHistogram in flink-metrics-dropwizard /
    runtime latency histograms)."""

    def __init__(self, window: int = 1024):
        self.window = window
        self._values: List[float] = []
        self._pos = 0
        self.total_count = 0

    def update(self, value: float) -> None:
        self.total_count += 1
        if len(self._values) < self.window:
            self._values.append(float(value))
        else:
            self._values[self._pos] = float(value)
            self._pos = (self._pos + 1) % self.window

    def get_count(self) -> int:
        return self.total_count

    def get_statistics(self) -> "HistogramStatistics":
        return HistogramStatistics(list(self._values))


class HistogramStatistics:
    def __init__(self, values: List[float]):
        self._sorted = sorted(values)

    @property
    def count(self) -> int:
        return len(self._sorted)

    @property
    def min(self) -> float:
        return self._sorted[0] if self._sorted else float("nan")

    @property
    def max(self) -> float:
        return self._sorted[-1] if self._sorted else float("nan")

    @property
    def mean(self) -> float:
        return (sum(self._sorted) / len(self._sorted)
                if self._sorted else float("nan"))

    @property
    def stddev(self) -> float:
        n = len(self._sorted)
        if n < 2:
            return 0.0 if n else float("nan")
        m = self.mean
        return math.sqrt(sum((v - m) ** 2 for v in self._sorted) / (n - 1))

    def quantile(self, q: float) -> float:
        if not self._sorted:
            return float("nan")
        idx = min(len(self._sorted) - 1, int(q * len(self._sorted)))
        return self._sorted[idx]


class Meter:
    """Event-rate meter: count + rate over a sliding minute
    (ref: flink-metrics-core Meter / MeterView's 60s update window)."""

    def __init__(self, clock: Callable[[], float] = _time.monotonic,
                 window_s: float = 60.0):
        self._clock = clock
        self._window_s = window_s
        self.count = 0
        self._events: List[Tuple[float, int]] = []  # (t, cumulative)

    def mark_event(self, n: int = 1) -> None:
        self.count += n
        now = self._clock()
        self._events.append((now, self.count))
        cutoff = now - self._window_s
        drop = bisect.bisect_left(self._events, (cutoff, -1))
        if drop:
            del self._events[:drop]

    def get_count(self) -> int:
        return self.count

    def get_rate(self) -> float:
        if not self._events:
            return 0.0
        now = self._clock()
        cutoff = now - self._window_s
        i = bisect.bisect_left(self._events, (cutoff, -1))
        if i >= len(self._events):
            # mark_event prunes at mark time only, so at READ time
            # every retained event can predate the window: nothing
            # happened within it — the rate is zero, not the stale
            # (count - base) extrapolation over dead events
            return 0.0
        base = self._events[i - 1][1] if i else (
            self._events[0][1] - 1)  # approximate pre-window base
        span = min(self._window_s, now - self._events[0][0]) or 1e-9
        return max(0.0, (self.count - base) / span)


# ---------------------------------------------------------------------------
# groups + registry
# ---------------------------------------------------------------------------

class MetricGroup:
    """A node in the metric scope tree (ref: AbstractMetricGroup /
    scope formats <host>.<job>.<task>.<operator>.<metric>)."""

    def __init__(self, registry: "MetricRegistry",
                 scope: Tuple[str, ...]):
        self._registry = registry
        self.scope = scope
        self.metrics: Dict[str, Any] = {}
        self._children: Dict[str, "MetricGroup"] = {}

    # -- construction --------------------------------------------------
    def add_group(self, name: str) -> "MetricGroup":
        g = self._children.get(name)
        if g is None:
            g = MetricGroup(self._registry, self.scope + (str(name),))
            self._children[name] = g
        return g

    def _register(self, name: str, metric) :
        existing = self.metrics.get(name)
        if existing is not None:
            return existing
        self.metrics[name] = metric
        self._registry._on_register(self, name, metric)
        return metric

    def counter(self, name: str) -> Counter:
        return self._register(name, Counter())

    def gauge(self, name: str, fn: Callable[[], Any],
              description: Optional[str] = None) -> Gauge:
        # gauges re-register on restart attempts: the new supplier
        # must win (it closes over the live coordinator/operator)
        g = Gauge(fn, description)
        self.metrics[name] = g
        self._registry._on_register(self, name, g)
        return g

    def histogram(self, name: str, window: int = 1024) -> Histogram:
        return self._register(name, Histogram(window))

    def meter(self, name: str) -> Meter:
        return self._register(name, Meter())

    def freeze(self) -> None:
        """Every gauge of this group and its children keeps the value
        it reads now and drops its supplier (a finished job's gauges
        would otherwise hold its operators and their device state)."""
        for m in self.metrics.values():
            if isinstance(m, Gauge):
                value = _metric_value(m)
                m._fn = lambda v=value: v
        for child in self._children.values():
            child.freeze()

    # -- introspection -------------------------------------------------
    def scope_string(self, delimiter: str = ".") -> str:
        return delimiter.join(self.scope)

    def dump(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        prefix = self.scope_string()
        for name, m in self.metrics.items():
            key = f"{prefix}.{name}" if prefix else name
            out[key] = _metric_value(m)
        for child in self._children.values():
            out.update(child.dump())
        return out


def _metric_value(m) -> Any:
    if isinstance(m, Counter):
        return m.count
    if isinstance(m, Gauge):
        try:
            return m.get_value()
        except Exception:  # noqa: BLE001 — a broken gauge must not kill reporting
            return None
    if isinstance(m, Meter):
        return {"count": m.count, "rate": round(m.get_rate(), 3)}
    if isinstance(m, Histogram):
        s = m.get_statistics()
        if not s.count:
            return {"count": m.total_count}
        return {
            "count": m.total_count,
            "min": s.min, "max": s.max,
            "mean": round(s.mean, 3),
            "p50": s.quantile(0.50),
            "p95": s.quantile(0.95),
            "p99": s.quantile(0.99),
        }
    return repr(m)


class MetricReporter:
    """(ref: flink-metrics-core MetricReporter SPI)"""

    def open(self, registry: "MetricRegistry") -> None:  # noqa: B027
        """Called once when attached via `add_reporter` — gives the
        reporter access to registry-level metadata (descriptions)."""
        pass

    def notify_of_added_metric(self, metric, name: str,
                               group: MetricGroup) -> None:  # noqa: B027
        pass

    def report(self, snapshot: Dict[str, Any]) -> None:  # noqa: B027
        """`snapshot` is either a flat metrics dict or the timestamped
        envelope produced by `MetricRegistry.report()` — use
        `unwrap_snapshot` to accept both."""
        pass


def unwrap_snapshot(snapshot: Dict[str, Any]) -> Dict[str, Any]:
    """Peel the timestamp envelope off a `report()` payload; flat
    metric dumps pass through unchanged."""
    if "metrics" in snapshot and "t_mono_ms" in snapshot:
        return snapshot["metrics"]
    return snapshot


class JsonLinesReporter(MetricReporter):
    """Writes one JSON object per report to a file or stream (the
    slf4j-reporter analogue; ref: flink-metrics-slf4j Slf4jReporter)."""

    def __init__(self, path: Optional[str] = None, stream=None):
        self._path = path
        self._stream = stream

    def report(self, snapshot: Dict[str, Any]) -> None:
        envelope = {"ts": _time.time(),
                    "t_mono_ms": snapshot.get("t_mono_ms"),
                    "t_wall_ms": snapshot.get("t_wall_ms"),
                    "metrics": unwrap_snapshot(snapshot)}
        line = json.dumps(envelope, default=str)
        if self._path is not None:
            with open(self._path, "a") as f:
                f.write(line + "\n")
        if self._stream is not None:
            self._stream.write(line + "\n")


class PrometheusTextReporter(MetricReporter):
    """Renders the Prometheus text exposition format on demand
    (ref: flink-metrics-prometheus PrometheusReporter — ours renders
    to a string the caller serves however it likes)."""

    def __init__(self):
        self._last: Dict[str, Any] = {}
        self._registry: Optional["MetricRegistry"] = None

    def open(self, registry: "MetricRegistry") -> None:
        self._registry = registry

    def report(self, snapshot: Dict[str, Any]) -> None:
        self._last = unwrap_snapshot(snapshot)

    @staticmethod
    def _sanitize(key: str) -> str:
        return "".join(c if (c.isalnum() or c == "_") else "_" for c in key)

    @staticmethod
    def _emit(lines: List[str], name: str, value,
              help_text: Optional[str] = None) -> None:
        if value != value:  # NaN — invalid exposition value; flag it
            lines.append(f"# flink_tpu: skipped NaN sample {name}")
            return
        help_text = (help_text or name).replace("\\", "\\\\") \
                                       .replace("\n", "\\n")
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {value}")

    def render(self) -> str:
        lines: List[str] = []
        descriptions = (self._registry.descriptions
                        if self._registry is not None else {})
        for key, value in sorted(self._last.items()):
            name = "flink_tpu_" + self._sanitize(key)
            # registered gauges may carry a description; everything
            # else gets the raw dotted key as its HELP text
            help_text = descriptions.get(key, key)
            if isinstance(value, dict):
                for sub, v in value.items():
                    if isinstance(v, (int, float)) and not isinstance(v, bool):
                        self._emit(lines, f"{name}_{self._sanitize(sub)}", v,
                                   f"{help_text} ({sub})")
            elif isinstance(value, (int, float)) and not isinstance(value, bool):
                self._emit(lines, name, value, help_text)
        return "\n".join(lines) + ("\n" if lines else "")


class MetricRegistry:
    """Root of the metric tree + reporter fan-out
    (ref: MetricRegistryImpl.java)."""

    def __init__(self):
        self.root = MetricGroup(self, ())
        self.reporters: List[MetricReporter] = []
        #: dotted metric key -> HELP description for described gauges
        self.descriptions: Dict[str, str] = {}

    def add_reporter(self, reporter: MetricReporter) -> MetricReporter:
        self.reporters.append(reporter)
        reporter.open(self)
        return reporter

    def _on_register(self, group: MetricGroup, name: str, metric) -> None:
        desc = getattr(metric, "description", None)
        if desc:
            prefix = group.scope_string()
            self.descriptions[f"{prefix}.{name}" if prefix else name] = desc
        for r in self.reporters:
            r.notify_of_added_metric(metric, name, group)

    # scope helpers (ref: TaskManagerMetricGroup.addTaskForJob chain)
    def job_group(self, job_name: str) -> MetricGroup:
        return self.root.add_group(job_name)

    def dump(self) -> Dict[str, Any]:
        return self.root.dump()

    def report(self) -> Dict[str, Any]:
        """Snapshot every metric and fan out to the reporters.  The
        returned envelope stamps the snapshot with both clocks so
        journal samples and reporter output align with tracer spans."""
        envelope = {
            "t_mono_ms": _time.monotonic() * 1000.0,
            "t_wall_ms": _time.time() * 1000.0,
            "metrics": self.dump(),
        }
        for r in self.reporters:
            r.report(envelope)
        return envelope


# ---------------------------------------------------------------------------
# task-level helpers
# ---------------------------------------------------------------------------

class TaskIOMetricGroup:
    """Built-in per-subtask IO metrics (ref: TaskIOMetricGroup.java:
    numRecordsIn/Out, numRecordsInPerSecond via MeterView).

    Construction marks the start of an execution ATTEMPT: counters are
    reset so post-failover numbers reflect the recovering attempt, not
    an accumulation over replays (the reference creates a fresh
    TaskMetricGroup per attempt)."""

    def __init__(self, task_group: MetricGroup):
        self.group = task_group
        self.num_records_in = task_group.counter("numRecordsIn")
        self.num_records_out = task_group.counter("numRecordsOut")
        self.num_bytes_in = task_group.counter("numBytesIn")
        self.num_bytes_out = task_group.counter("numBytesOut")
        for c in (self.num_records_in, self.num_records_out,
                  self.num_bytes_in, self.num_bytes_out):
            c.count = 0


class LatencyStats:
    """Per (source-operator, sink-operator) latency histograms fed by
    LatencyMarker flow (ref: AbstractStreamOperator.LatencyGauge /
    LatencyStats in the reference; markers emitted by sources and
    forwarded through the graph — §5 tracing row)."""

    def __init__(self, group: MetricGroup, window: int = 1024):
        self.group = group.add_group("latency")
        self.window = window
        # markers arrive per source-interval per channel: resolving
        # two group levels + a histogram registration each time is
        # pure allocation churn — the mapping is static per attempt
        self._histograms: Dict[Tuple[str, int, str], Histogram] = {}

    def record(self, marker, operator_id: str, latency_ms: float) -> None:
        key = (marker.operator_id, marker.subtask_index, operator_id)
        h = self._histograms.get(key)
        if h is None:
            h = self.group.add_group(
                f"source_{marker.operator_id}_{marker.subtask_index}"
            ).histogram(f"operator_{operator_id}", self.window)
            self._histograms[key] = h
        h.update(latency_ms)


def register_checkpoint_gauges(metrics: MetricRegistry, job_name: str,
                               coordinator) -> None:
    """Publish the standard checkpoint gauges for a job's coordinator
    (ref: CheckpointStatsTracker.java metrics).  Shared by every
    executor (LocalExecutor, MiniCluster) so the metric surface cannot
    diverge between them; gauges re-register per restart attempt and
    the fresh suppliers win (they close over the live coordinator)."""
    g = metrics.job_group(job_name).add_group("checkpointing")
    g.gauge("numberOfCompletedCheckpoints",
            lambda: coordinator.completed_count)
    g.gauge("lastCompletedCheckpointId",
            lambda: coordinator.latest_completed_id)
    g.gauge(
        "lastCheckpointDuration",
        lambda: (coordinator.stats[coordinator.latest_completed_id].duration_ms
                 if coordinator.latest_completed_id in coordinator.stats
                 else None))
    g.gauge(
        "lastCheckpointSize",
        lambda: (coordinator.stats[coordinator.latest_completed_id].state_bytes
                 if coordinator.latest_completed_id in coordinator.stats
                 else None))


def register_faulttolerance_gauges(metrics: MetricRegistry, job_name: str,
                                   coordinator=None) -> None:
    """Publish the `faulttolerance.*` gauge surface: the process-wide
    retry/fallback counters maintained by `runtime.faults` plus the
    coordinator's abort/consecutive-failure bookkeeping when one is
    supplied.  Like the checkpoint gauges this re-registers per
    attempt and the fresh suppliers win."""
    from flink_tpu_torch.runtime import faults

    g = metrics.job_group(job_name).add_group("faulttolerance")
    for name in ("storage_retries", "rpc_connect_retries",
                 "netchannel_connect_retries", "retries_total",
                 "checkpoint_fallbacks", "checkpoint_timeouts",
                 "checkpoint_failures"):
        g.gauge(name, (lambda n=name: faults.retry_counters.get(n, 0)))
    if coordinator is not None:
        g.gauge("numberOfAbortedCheckpoints",
                lambda: coordinator.aborted_count)
        g.gauge("numberOfTimedOutCheckpoints",
                lambda: coordinator.timeout_aborts)
        g.gauge("consecutiveFailedCheckpoints",
                lambda: coordinator.consecutive_failures)


def register_lint_gauges(metrics: MetricRegistry, job_name: str,
                         report) -> None:
    """Publish ``<job>.lint.*`` from a pre-flight ``Diagnostics`` report:
    the severity counts and one gauge per FT code (``codes.<code>``).
    A repeated execute() re-registers and the fresh values win."""
    g = metrics.job_group(job_name).add_group("lint")
    counts = report.counts()
    g.gauge("errors", lambda c=counts.get("error", 0): c)
    g.gauge("warnings", lambda c=counts.get("warning", 0): c)
    g.gauge("infos", lambda c=counts.get("info", 0): c)
    codes = g.add_group("codes")
    for code in report.codes():
        codes.gauge(code, lambda n=len(report.by_code(code)): n)


def register_typeflow_gauges(metrics: MetricRegistry, job_name: str,
                             typeflow) -> None:
    """Publish ``<job>.typeflow.*`` from a ``TypeflowReport``: conclusive
    edges, proven (probe-free) kernels, pickle-tier exchange edges and
    the predicted device-state bytes, fixed at submission (the report
    is made ahead of time); the operators' ``columnar.decided_by`` and
    ``columnar.probes`` gauges tell what the run did."""
    summary = typeflow.summary()
    g = metrics.job_group(job_name).add_group("typeflow")
    for key in ("edges_total", "edges_conclusive", "kernels_total",
                "kernels_proven", "pickle_edges",
                "predicted_state_bytes"):
        g.gauge(key, lambda v=summary[key]: v)


def register_state_gauges(metrics: MetricRegistry) -> None:
    """Publish the `state.*` gauge surface for a process: batch-ingest
    vs row-fallback row counts from `state.stats.STATE_STATS`, device
    micro-batch flush sizes, columnar-vs-row snapshot traffic, and the
    aggregate device-tier picture (slots in use, capacity, evictions,
    host-spill promotions, pending-ring depth) over every live
    `DeviceAggregatingState`.  Registered under the registry root —
    the state tier is process-wide, like the data plane."""
    from flink_tpu_torch.state.stats import STATE_STATS, device_state_summary

    s = STATE_STATS
    g = metrics.root.add_group("state")
    g.gauge("batchRows", lambda: s.batch_rows)
    g.gauge("rowFallbackRows", lambda: s.row_fallback_rows)
    g.gauge("batchCalls", lambda: s.batch_calls)
    g.gauge("rowFallbackCalls", lambda: s.row_fallback_calls)
    g.gauge("flushBatches", lambda: s.flush_batches)
    g.gauge("flushRows", lambda: s.flush_rows)
    g.gauge("flushSizeMean", lambda: s.flush_size_mean())
    g.gauge("flushSizeMax", lambda: s.flush_size_max())
    g.gauge("snapshotColumns", lambda: s.snapshot_columns)
    g.gauge("snapshotRows", lambda: s.snapshot_rows)

    def _dev(field):
        return device_state_summary().get(field, 0)

    d = g.add_group("device")
    d.gauge("states", lambda: _dev("states"))
    d.gauge("slotsInUse", lambda: _dev("slots_in_use"))
    d.gauge("capacity", lambda: _dev("capacity"))
    d.gauge("spilledEntries", lambda: _dev("spilled_entries"))
    d.gauge("evictions", lambda: _dev("evictions"))
    d.gauge("promotions", lambda: _dev("promotions"))
    d.gauge("pendingDepth", lambda: _dev("pending_depth"))

    # per-state attribution of the batch/fallback split (the aggregate
    # gauge names above are pinned; these are the drill-down)
    ps = g.add_group("perState")
    ps.gauge("batchRows", lambda: dict(s.per_state_batch_rows))
    ps.gauge("batchCalls", lambda: dict(s.per_state_batch_calls))
    ps.gauge("rowFallbackRows", lambda: dict(s.per_state_fallback_rows))
    ps.gauge("rowFallbackCalls", lambda: dict(s.per_state_fallback_calls))


def register_state_introspection_gauges(metrics: MetricRegistry) -> None:
    """Publish the keyed-state introspection plane's gauge surface
    under the same root `state` group (add_group dedups): skew ratio,
    hottest key group, occupied key groups, top hot-key share and
    hot-key count, plus the enabled flag.  All read the cheap
    tracker-side summary — no accounting table walk per journal tick.
    Zeros while the plane is disabled, so the `key-skew-sustained`
    health rule stays quiet."""
    from flink_tpu_torch.state.introspect import get_introspection

    t = get_introspection()
    g = metrics.root.add_group("state")
    g.gauge("introspectionEnabled", lambda: 1 if t.enabled else 0)

    def _skew(field):
        return t.skew_summary()[field]

    g.gauge("keyGroupSkew", lambda: _skew("ratio"))
    g.gauge("hotKeyGroup", lambda: _skew("hot_key_group"))
    g.gauge("occupiedKeyGroups", lambda: _skew("occupied_key_groups"))
    g.gauge("hotKeyShare", lambda: _skew("hot_key_share"))
    g.gauge("hotKeys", lambda: _skew("hot_keys"))
