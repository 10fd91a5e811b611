"""Metrics time-series journal + health alerts — the job history plane
(port of ``flink_tpu/runtime/timeseries.py``; the archive that the
reference's history server reads is not ported).

`MetricsJournal` snapshots a `MetricRegistry` into fixed-size ring
buffers per metric on a configurable cadence
(`metrics.sample.interval.ms` / `metrics.history.size` in
`core/config.py`), so point-in-time gauges become queryable trends:
the `/jobs/<name>/metrics/history` payload (``query``) and a reactive
autoscaler both read from here.  `HealthEvaluator` runs
threshold rules over those trends and emits structured alert events
(`/jobs/<name>/alerts`, `health.*` gauges).

Reference analogues: the journal plays the role of Flink's metric
fetcher + store behind the web frontend
(flink-runtime/.../webmonitor/metrics/MetricStore.java), the alerts
are the trigger predicate a reactive-mode autoscaler consumes.

Design notes (single-owner loop): sampling is driven by the executor
loop (`maybe_sample` is a two-comparison no-op when disabled or not
yet due), while REST handler threads query concurrently — a plain
lock guards the ring buffers; sampling cadence is tens of ms so the
contention is negligible.  Cross-process TaskExecutors ship raw
registry dumps to the JobMaster over the RPC plane (`ingest`), which
re-stamps them with the master's monotonic clock — wall-clock is the
query axis, monotonic aligns samples with tracer spans.
"""

from __future__ import annotations

import fnmatch
import threading
import time as _time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

__all__ = [
    "MetricsJournal",
    "HealthEvaluator",
    "register_health_gauges",
    "rollup",
]

#: sample tuple layout: (t_mono_ms, t_wall_ms, value)
Sample = Tuple[float, float, float]


def _numeric_items(metrics: Dict[str, Any]):
    """Flatten a registry dump into (key, float) pairs: dict-valued
    metrics (histograms, meters) expand to `key.sub`; strings, bools
    and None are dropped — the journal stores numbers only."""
    for key, value in metrics.items():
        if isinstance(value, dict):
            for sub, v in value.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    yield f"{key}.{sub}", float(v)
        elif isinstance(value, (int, float)) and not isinstance(value, bool):
            yield key, float(value)


def rollup(values: List[float]) -> Dict[str, float]:
    """min/max/avg/p95 over a list of samples (empty -> count 0)."""
    if not values:
        return {"count": 0}
    ordered = sorted(values)
    n = len(ordered)
    return {
        "count": n,
        "min": ordered[0],
        "max": ordered[-1],
        "avg": sum(ordered) / n,
        "p95": ordered[min(n - 1, int(0.95 * n))],
    }


class MetricsJournal:
    """Fixed-size per-metric ring buffers over registry snapshots.

    Disabled (interval_ms None) the per-loop cost is one attribute
    read and one comparison in `maybe_sample`; enabled, a snapshot
    runs every `interval_ms` at most.
    """

    def __init__(self, registry=None, interval_ms: Optional[int] = None,
                 history_size: int = 1024,
                 clock: Callable[[], float] = None,
                 wall_clock: Callable[[], float] = None):
        self.registry = registry
        self.interval_ms = interval_ms
        self.history_size = max(2, int(history_size or 1024))
        self._clock = clock or (lambda: _time.monotonic() * 1000.0)
        self._wall = wall_clock or (lambda: _time.time() * 1000.0)
        self._lock = threading.Lock()
        self._series: Dict[str, Deque[Sample]] = {}
        self._next_due = 0.0
        self.samples_taken = 0

    @property
    def enabled(self) -> bool:
        return self.interval_ms is not None

    # ---- recording ---------------------------------------------------
    def maybe_sample(self, now_ms: Optional[float] = None) -> bool:
        """Called from the owning executor loop every iteration; takes
        a snapshot when one is due.  Returns True iff it sampled."""
        if self.interval_ms is None:
            return False
        now = self._clock() if now_ms is None else now_ms
        if now < self._next_due:
            return False
        self._next_due = now + self.interval_ms
        self.sample_now(now)
        return True

    def sample_now(self, now_ms: Optional[float] = None) -> None:
        """Take one snapshot of the attached registry immediately."""
        if self.registry is None:
            return
        t_mono = self._clock() if now_ms is None else now_ms
        self._record(t_mono, self._wall(), self.registry.dump())

    def ingest(self, t_wall_ms: float, metrics: Dict[str, Any]) -> None:
        """Record a snapshot shipped from another process (cluster
        TaskExecutors).  The remote monotonic clock is meaningless
        here, so samples are re-stamped with the local one."""
        self._record(self._clock(), t_wall_ms, metrics)

    def _record(self, t_mono: float, t_wall: float,
                metrics: Dict[str, Any]) -> None:
        with self._lock:
            for key, value in _numeric_items(metrics):
                series = self._series.get(key)
                if series is None:
                    series = deque(maxlen=self.history_size)
                    self._series[key] = series
                series.append((t_mono, t_wall, value))
            self.samples_taken += 1

    # ---- querying ----------------------------------------------------
    def keys(self, pattern: str = "*") -> List[str]:
        with self._lock:
            return sorted(k for k in self._series
                          if fnmatch.fnmatchcase(k, pattern))

    def series(self, key: str,
               since_wall_ms: Optional[float] = None) -> List[Sample]:
        with self._lock:
            samples = list(self._series.get(key, ()))
        if since_wall_ms is not None:
            samples = [s for s in samples if s[1] >= since_wall_ms]
        return samples

    def latest(self, key: str) -> Optional[float]:
        with self._lock:
            series = self._series.get(key)
            return series[-1][2] if series else None

    def query(self, pattern: str = "*",
              since_wall_ms: Optional[float] = None,
              buckets: Optional[int] = None) -> Dict[str, Any]:
        """The REST `/jobs/<name>/metrics/history` payload: per
        matching metric the raw (t_wall_ms, value) samples, an overall
        rollup, and — when `buckets` is given — per-time-bucket
        rollups of the covered window."""
        out: Dict[str, Any] = {}
        for key in self.keys(pattern):
            samples = self.series(key, since_wall_ms)
            if not samples:
                continue
            entry: Dict[str, Any] = {
                "samples": [[s[1], s[2]] for s in samples],
                "rollup": rollup([s[2] for s in samples]),
            }
            if buckets and buckets > 0 and len(samples) > 1:
                entry["buckets"] = self._bucketize(samples, buckets)
            out[key] = entry
        return {
            "metric": pattern,
            "since": since_wall_ms,
            "sample_interval_ms": self.interval_ms,
            "history_size": self.history_size,
            "series": out,
        }

    @staticmethod
    def _bucketize(samples: List[Sample], buckets: int) -> List[dict]:
        t0, t1 = samples[0][1], samples[-1][1]
        width = max((t1 - t0) / buckets, 1e-9)
        binned: List[List[float]] = [[] for _ in range(buckets)]
        for _, t_wall, value in samples:
            idx = min(buckets - 1, int((t_wall - t0) / width))
            binned[idx].append(value)
        return [dict(t_start_ms=t0 + i * width, t_end_ms=t0 + (i + 1) * width,
                     **rollup(vals))
                for i, vals in enumerate(binned)]

    # ---- archiving ---------------------------------------------------
    def to_payload(self) -> Dict[str, Any]:
        """JSON-safe dump for the FsJobArchivist bundle."""
        with self._lock:
            series = {k: [list(s) for s in v]
                      for k, v in self._series.items()}
        return {
            "interval_ms": self.interval_ms,
            "history_size": self.history_size,
            "samples_taken": self.samples_taken,
            "series": series,
        }

    @classmethod
    def from_payload(cls, payload: Dict[str, Any]) -> "MetricsJournal":
        """Rehydrate an archived journal so an archive reader can
        serve the same `/metrics/history` queries as live REST."""
        j = cls(registry=None,
                interval_ms=payload.get("interval_ms"),
                history_size=payload.get("history_size") or 1024)
        for key, samples in (payload.get("series") or {}).items():
            j._series[key] = deque(
                (tuple(s) for s in samples), maxlen=j.history_size)
        j.samples_taken = payload.get("samples_taken", 0)
        return j


# ---------------------------------------------------------------------------
# health rules
# ---------------------------------------------------------------------------

class HealthEvaluator:
    """Threshold rules over the journal, emitting structured alerts.

    Each rule has EPISODE semantics: it fires exactly once when its
    predicate first holds and re-arms only after the predicate clears
    — a sustained condition produces one alert, not one per sample.
    This predicate surface is what a reactive autoscaler
    will consume.

    Rules:
      * ``backpressure-sustained`` — a ``*.backpressure.ratio`` series
        stayed above `bp_ratio_threshold` for `bp_consecutive`
        consecutive samples.
      * ``watermark-lag-growing`` — a ``*.watermarkLag`` series grew
        strictly monotonically over `lag_consecutive` samples.
      * ``checkpoint-duration-over-budget`` — the coordinator's
        completed-checkpoint duration p95 exceeds
        `checkpoint_p95_budget_ms` (rule disabled while the budget is
        None).
      * ``bottleneck-stable`` — bottleneck localization
        (`bottleneck_supplier`, runtime/backpressure.py
        `locate_bottleneck`) named the SAME vertex for
        `bottleneck_consecutive` consecutive evaluations — a stable
        localization, not a transient blip (the autoscaler's scale-up
        target signal).
      * ``transfer-tax`` — the device ledger's D2H-fire-reads per
        fired-window ratio (deltas of ``device.fireReads`` over
        ``device.windowsFired``) stayed above
        `transfer_tax_threshold` for `transfer_tax_consecutive`
        consecutive sample intervals: the job is paying a per-result
        device readback tax (the per-key fire path) instead
        of amortizing fires over batched reads.
      * ``key-skew-sustained`` — the keyed-state introspection plane's
        ``state.keyGroupSkew`` gauge (max/mean occupied key-group
        load) stayed above `key_skew_threshold` for
        `key_skew_consecutive` consecutive samples: one or a few hot
        key groups carry the traffic.  The alert names the hottest key
        group (``state.hotKeyGroup``) — the rescale/partitioning input
        a rescale decision consumes.  Quiet while introspection is
        disabled (the gauge reads 0).
    """

    def __init__(self, journal: MetricsJournal,
                 bp_ratio_threshold: float = 0.5,
                 bp_consecutive: int = 5,
                 lag_consecutive: int = 8,
                 checkpoint_p95_budget_ms: Optional[float] = None,
                 coordinator_supplier: Optional[Callable[[], Any]] = None,
                 bottleneck_supplier: Optional[Callable[[], Any]] = None,
                 bottleneck_consecutive: int = 5,
                 transfer_tax_threshold: float = 4.0,
                 transfer_tax_consecutive: int = 5,
                 key_skew_threshold: float = 3.0,
                 key_skew_consecutive: int = 3,
                 max_alerts: int = 256,
                 wall_clock: Callable[[], float] = None):
        self.journal = journal
        self.bp_ratio_threshold = bp_ratio_threshold
        self.bp_consecutive = max(2, bp_consecutive)
        self.lag_consecutive = max(3, lag_consecutive)
        self.checkpoint_p95_budget_ms = checkpoint_p95_budget_ms
        self.coordinator_supplier = coordinator_supplier
        self.bottleneck_supplier = bottleneck_supplier
        self.bottleneck_consecutive = max(2, bottleneck_consecutive)
        self.transfer_tax_threshold = transfer_tax_threshold
        self.transfer_tax_consecutive = max(2, transfer_tax_consecutive)
        self.key_skew_threshold = key_skew_threshold
        self.key_skew_consecutive = max(2, key_skew_consecutive)
        self.max_alerts = max_alerts
        self._wall = wall_clock or (lambda: _time.time() * 1000.0)
        self._lock = threading.Lock()
        self.alerts: List[dict] = []
        self.alerts_total = 0
        #: rule-instance key -> currently-firing episode flag
        self._active: Dict[Tuple[str, str], bool] = {}
        #: bottleneck streak: (vertex_id, consecutive evaluations)
        self._bottleneck_streak: Tuple[Optional[Any], int] = (None, 0)
        #: the last stable localization (served on demand)
        self.last_bottleneck: Optional[dict] = None

    # ---- emission ----------------------------------------------------
    def _fire(self, rule: str, metric: str, message: str,
              value) -> None:
        with self._lock:
            self.alerts_total += 1
            self.alerts.append({
                "rule": rule,
                "metric": metric,
                "message": message,
                "value": value,
                "t_wall_ms": self._wall(),
                "seq": self.alerts_total,
            })
            if len(self.alerts) > self.max_alerts:
                del self.alerts[:len(self.alerts) - self.max_alerts]

    def _episode(self, rule: str, metric: str, firing: bool,
                 message: str, value) -> None:
        key = (rule, metric)
        was = self._active.get(key, False)
        if firing and not was:
            self._fire(rule, metric, message, value)
        self._active[key] = firing

    def snapshot_alerts(self) -> List[dict]:
        with self._lock:
            return list(self.alerts)

    @property
    def active_rules(self) -> List[str]:
        return sorted({r for (r, _m), on in self._active.items() if on})

    # ---- evaluation --------------------------------------------------
    def evaluate(self) -> None:
        """Run every rule once; call after each journal sample."""
        self._eval_backpressure()
        self._eval_watermark_lag()
        self._eval_checkpoint_budget()
        self._eval_bottleneck()
        self._eval_transfer_tax()
        self._eval_key_skew()

    def _tail(self, key: str, n: int) -> List[float]:
        samples = self.journal.series(key)
        return [s[2] for s in samples[-n:]]

    def _eval_backpressure(self) -> None:
        k = self.bp_consecutive
        for key in self.journal.keys("*.backpressure.ratio"):
            tail = self._tail(key, k)
            firing = (len(tail) == k
                      and all(v > self.bp_ratio_threshold for v in tail))
            self._episode(
                "backpressure-sustained", key, firing,
                f"backpressure ratio > {self.bp_ratio_threshold} for "
                f"{k} consecutive samples", tail[-1] if tail else None)

    def _eval_watermark_lag(self) -> None:
        k = self.lag_consecutive
        for key in self.journal.keys("*.watermarkLag"):
            tail = self._tail(key, k)
            firing = (len(tail) == k
                      and all(b > a for a, b in zip(tail, tail[1:])))
            self._episode(
                "watermark-lag-growing", key, firing,
                f"watermark lag grew monotonically over {k} samples",
                tail[-1] if tail else None)

    def _eval_checkpoint_budget(self) -> None:
        budget = self.checkpoint_p95_budget_ms
        if budget is None or self.coordinator_supplier is None:
            return
        coordinator = self.coordinator_supplier()
        if coordinator is None:
            return
        durations = [st.duration_ms for st in
                     getattr(coordinator, "stats", {}).values()
                     if getattr(st, "duration_ms", None) is not None]
        if not durations:
            return
        p95 = rollup(durations)["p95"]
        self._episode(
            "checkpoint-duration-over-budget", "checkpointing.duration",
            p95 > budget,
            f"completed-checkpoint duration p95 {p95:.1f} ms exceeds "
            f"budget {budget:.1f} ms", p95)

    def _eval_transfer_tax(self) -> None:
        thr = self.transfer_tax_threshold
        if thr is None:
            return
        k = self.transfer_tax_consecutive
        # both are cumulative counters: the rule runs on per-interval
        # deltas, so k firing intervals need k+1 samples of each
        reads = self._tail("device.fireReads", k + 1)
        fired = self._tail("device.windowsFired", k + 1)
        firing = False
        value = None
        if len(reads) == k + 1 and len(fired) == k + 1:
            d_reads = [b - a for a, b in zip(reads, reads[1:])]
            d_fired = [b - a for a, b in zip(fired, fired[1:])]
            ratios = [dr / df for dr, df in zip(d_reads, d_fired)
                      if df > 0]
            firing = len(ratios) == k and all(r > thr for r in ratios)
            value = ratios[-1] if ratios else None
        self._episode(
            "transfer-tax", "device.fireReads", firing,
            f"sustained device readback tax: > {thr} D2H fire reads "
            f"per fired window for {k} consecutive sample intervals "
            "(see docs/state.md, per-key fire path)", value)

    def _eval_key_skew(self) -> None:
        thr = self.key_skew_threshold
        if thr is None:
            return
        k = self.key_skew_consecutive
        tail = self._tail("state.keyGroupSkew", k)
        firing = (len(tail) == k and all(v > thr for v in tail))
        hot_kg = self.journal.latest("state.hotKeyGroup")
        hot_kg = int(hot_kg) if hot_kg is not None and hot_kg >= 0 else None
        self._episode(
            "key-skew-sustained", "state.keyGroupSkew", firing,
            f"keyed-state skew > {thr}x the mean occupied key-group "
            f"load for {k} consecutive samples (hot key group "
            f"{hot_kg}; see /jobs/<name>/state for the hot-key list)",
            tail[-1] if tail else None)

    def _eval_bottleneck(self) -> None:
        if self.bottleneck_supplier is None:
            return
        try:
            located = self.bottleneck_supplier()
        except Exception:  # noqa: BLE001 — localization must not kill
            return         # the evaluation pass
        vid = located.get("vertex_id") if located else None
        prev_vid, streak = self._bottleneck_streak
        streak = streak + 1 if (vid is not None and vid == prev_vid) \
            else (1 if vid is not None else 0)
        self._bottleneck_streak = (vid, streak)
        firing = streak >= self.bottleneck_consecutive
        if firing:
            self.last_bottleneck = located
        name = (located or {}).get("name") or vid
        self._episode(
            "bottleneck-stable", "bottleneck.vertex", firing,
            f"bottleneck stable at vertex {name} (id {vid}) for "
            f"{streak} consecutive evaluations "
            f"(busy {((located or {}).get('busyMsPerSecond') or 0):.0f} "
            f"ms/s, backpressured upstreams "
            f"{[u['vertex_id'] for u in (located or {}).get('backpressured_upstreams', [])]})",
            vid)


def register_health_gauges(metrics, job_name: str,
                           evaluator: HealthEvaluator) -> None:
    """Publish the `health.*` gauge surface for a job.  Re-registers
    per restart attempt like the checkpoint gauges — fresh suppliers
    close over the live evaluator."""
    g = metrics.job_group(job_name).add_group("health")
    g.gauge("alertsTotal", lambda: evaluator.alerts_total,
            description="total alerts emitted by the health evaluator")
    g.gauge("rulesFiring", lambda: len(evaluator.active_rules),
            description="health rules currently in a firing episode")
    g.gauge("lastAlertRule",
            lambda: (evaluator.alerts[-1]["rule"]
                     if evaluator.alerts else None),
            description="rule name of the most recent alert")
