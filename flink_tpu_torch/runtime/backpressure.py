"""Back-pressure sampling, time attribution and bottleneck location
(port of ``flink_tpu/runtime/backpressure.py``).

The port's executor runs every subtask on one cooperative thread and
routes records by direct calls, so a router never lacks capacity:
``router_blocked`` and ``sample_backpressure`` report "ok" (ratio 0) and
the backpressured share of ``TimeAccounting`` stays 0 until threaded
channels with bounded queues exist.  Everything here works on any
router that has the reference's ``has_capacity()``, so the functions
are the reference's.

The reference samples task threads' stacks over REST and reports the
ratio blocked in `requestBufferBlocking`
(flink-runtime/.../rest/handler/legacy/backpressure/
StackTraceSampleCoordinator.java:52, BackPressureStatsTrackerImpl
.java:66 — ratio OK < 0.10 <= LOW < 0.50 <= HIGH).  The rebuild's
runnability condition is explicit rather than thread-stack-implicit:
a subtask is backpressured exactly when its router has no output
capacity (`_RouterOutput.has_capacity()` false — bounded downstream
queues full / remote credit exhausted).  So a "sample" here reads
that predicate directly, N times over a window, per subtask."""

from __future__ import annotations

import time as _time
from typing import Dict, List, Optional


#: the reference's thresholds (BackPressureStatsTrackerImpl)
OK_THRESHOLD = 0.10
LOW_THRESHOLD = 0.50

#: how long one observed out-of-capacity moment keeps a subtask
#: counting as blocked in the gauge read.  A truly blocked producer
#: thread briefly shows free capacity right after the consumer pops a
#: record and before the producer refills (its wait-loop poll needs
#: the GIL, switch interval 5 ms) — the producer stamps
#: `router.last_blocked_mono` while waiting, and the gauge honours
#: stamps this recent, so a point read cannot race the refill.  Kept
#: well under one alert window (5 samples) so a single transient
#: blockage cannot read as sustained.
BLOCKED_STICKY_WINDOW_S = 0.015


def classify(ratio: float) -> str:
    if ratio < OK_THRESHOLD:
        return "ok"
    if ratio < LOW_THRESHOLD:
        return "low"
    return "high"


def sample_backpressure(subtasks_by_vertex: Dict[int, List],
                        num_samples: int = 20,
                        delay_s: float = 0.005) -> Dict[int, dict]:
    """`subtasks_by_vertex` is the executor's live map (vertex_id ->
    [SubtaskInstance]).  Returns per-vertex ratios + levels (the
    OperatorBackPressureStats shape)."""
    from flink_tpu_torch.runtime.profiler import sample_windowed
    counts: Dict[int, List[int]] = {
        vid: [0] * len(sts) for vid, sts in subtasks_by_vertex.items()}

    def probe(_s: int) -> None:
        for vid, sts in subtasks_by_vertex.items():
            for i, st in enumerate(sts):
                # reading queue lengths cross-thread is safe (len on
                # deques); a torn read only perturbs one sample
                if not st.router.has_capacity():
                    counts[vid][i] += 1

    # the profiler owns the tree's one windowed-sampling core; this
    # sampler only supplies the capacity-predicate probe
    sample_windowed(probe, num_samples, delay_s)
    out: Dict[int, dict] = {}
    for vid, per_subtask in counts.items():
        ratios = [c / num_samples for c in per_subtask]
        worst = max(ratios) if ratios else 0.0
        out[vid] = {"subtask_ratios": ratios, "max_ratio": worst,
                    "level": classify(worst)}
    return out


def sample_client(client, num_samples: int = 20,
                  delay_s: float = 0.005) -> Dict[int, dict]:
    """Sample a running job via its JobClient (executor_state)."""
    state = client.executor_state or {}
    subtasks = state.get("subtasks")
    if not subtasks:
        return {}
    return sample_backpressure(subtasks, num_samples, delay_s)


def router_blocked(router, now: Optional[float] = None) -> bool:
    """The sticky-window blocked predicate shared by the gauge read
    and time attribution: out of capacity right now, or a producer
    stamped ``last_blocked_mono`` within the sticky window (a point
    read cannot race the consumer's refill)."""
    if now is None:
        now = _time.monotonic()
    if not router.has_capacity():
        router.last_blocked_mono = now
        return True
    return (now - getattr(router, "last_blocked_mono", 0.0)
            < BLOCKED_STICKY_WINDOW_S)


def register_backpressure_gauges(vertex_group, subtasks: List) -> None:
    """Publish the vertex's backpressure classification as gauges
    (``backpressure.ratio`` numeric + ``backpressure.level`` string).
    Read-time sampling is a single pass over the capacity predicate
    plus the producers' recent-blockage stamps (the
    ``backPressuredTimeMsPerSecond`` idea: time-aware, not a racy
    instant) — cheap enough for every metrics dump; callers wanting
    the smoothed N-sample window keep using
    :func:`sample_backpressure`."""
    group = vertex_group.add_group("backpressure")

    def ratio() -> float:
        if not subtasks:
            return 0.0
        now = _time.monotonic()
        return (sum(1 for st in subtasks
                    if router_blocked(st.router, now))
                / len(subtasks))

    group.gauge("ratio", ratio)
    group.gauge("level", lambda: classify(ratio()))


def read_backpressure_gauges(dump: Dict[str, object],
                             job_name: str) -> Dict[int, dict]:
    """Serve backpressure from an already-collected registry dump (the
    ``<job>.<vid>_<vname>.backpressure.ratio`` sticky-window gauges)
    instead of re-sampling inline — a REST hit must not block its
    caller for the sampler's full num_samples × delay window.  Returns
    the :func:`sample_backpressure` shape so consumers cannot tell the
    difference (``subtask_ratios`` carries the single vertex-level
    read; the active sampler remains for per-subtask resolution)."""
    prefix = job_name + "."
    suffix = ".backpressure.ratio"
    out: Dict[int, dict] = {}
    for key, value in dump.items():
        if not (key.startswith(prefix) and key.endswith(suffix)):
            continue
        token = key[len(prefix):-len(suffix)]
        try:
            vid = int(token.split("_", 1)[0])
            ratio = float(value)  # type: ignore[arg-type]
        except (ValueError, TypeError):
            continue
        out[vid] = {"subtask_ratios": [ratio], "max_ratio": ratio,
                    "level": classify(ratio)}
    return out


# ---------------------------------------------------------------------
# time attribution (ref: busyTimeMsPerSecond / idleTimeMsPerSecond /
# backPressuredTimeMsPerSecond on TaskIOMetricGroup)
# ---------------------------------------------------------------------

class TimeAccounting:
    """Per-subtask wall-time attribution.  The executor loop observes
    each subtask once per pass; the interval since that subtask's
    previous observation is classified into EXACTLY one bucket —
    progress ⇒ busy, router-blocked ⇒ backpressured, otherwise idle —
    so the three cumulative counters tile elapsed time with no gap or
    double count, and the per-second rate gauges sum to ~1000 ms/s by
    construction (the invariant the tests pin)."""

    __slots__ = ("busy_ns", "idle_ns", "backpressured_ns", "_last_ns",
                 "_win_start_ns", "_win", "_rates", "last_class")

    #: refresh the windowed rate gauges at most this often (~5 Hz)
    WINDOW_NS = 200_000_000

    def __init__(self):
        self.busy_ns = 0
        self.idle_ns = 0
        self.backpressured_ns = 0
        self._last_ns: Optional[int] = None
        self._win_start_ns: Optional[int] = None
        self._win = [0, 0, 0]
        self._rates = (0.0, 0.0, 0.0)
        #: the class of the most recent observation in the sampling
        #: profiler's encoding (0 on-CPU/busy, 1 off-CPU/idle,
        #: 2 backpressured) — read cross-thread by the profiler to
        #: classify stack samples; None until the first interval
        self.last_class: Optional[int] = None

    def observe(self, made_progress: bool, blocked: bool,
                now_ns: Optional[int] = None) -> None:
        now = _time.perf_counter_ns() if now_ns is None else now_ns
        last = self._last_ns
        self._last_ns = now
        if last is None:
            self._win_start_ns = now
            return
        dt = now - last
        if dt <= 0:
            return
        if made_progress:
            self.busy_ns += dt
            self._win[0] += dt
            self.last_class = 0
        elif blocked:
            self.backpressured_ns += dt
            self._win[2] += dt
            self.last_class = 2
        else:
            self.idle_ns += dt
            self._win[1] += dt
            self.last_class = 1
        span = now - self._win_start_ns
        if span >= self.WINDOW_NS:
            # ns-in-bucket / ns-elapsed × 1000 ⇒ ms per second; the
            # tuple swap is atomic so gauge reads never tear
            scale = 1000.0 / span
            self._rates = (self._win[0] * scale, self._win[1] * scale,
                           self._win[2] * scale)
            self._win = [0, 0, 0]
            self._win_start_ns = now

    def rates(self) -> tuple:
        """(busy, idle, backPressured) in ms/s over the last completed
        window; zeros until the first window elapses."""
        return self._rates


def register_time_attribution_gauges(subtask_group, acct: TimeAccounting
                                     ) -> None:
    """Per-subtask attribution gauges, journaled with everything else
    the MetricsJournal samples."""
    subtask_group.gauge("busyTimeMsPerSecond", lambda: acct.rates()[0])
    subtask_group.gauge("idleTimeMsPerSecond", lambda: acct.rates()[1])
    subtask_group.gauge("backPressuredTimeMsPerSecond",
                        lambda: acct.rates()[2])


def observe_subtask(st, progressed) -> None:
    """One attribution observation for a stepped subtask (called by
    every executor loop after the subtask's step/source_step)."""
    acct = getattr(st, "time_accounting", None)
    if acct is None:
        return
    if progressed:
        acct.observe(True, False)
    else:
        acct.observe(False, router_blocked(st.router))


def observe_threaded_source(st) -> None:
    """Attribution for a threaded source: its emissions happen on the
    source thread, so the emit wait-loop's ``last_blocked_mono`` stamps
    take precedence — a blocked-but-trickling source spends the pass
    waiting on capacity, not working.  Otherwise progress is inferred
    from the router's records-out counter delta (falling back to
    queued output when metrics are off)."""
    acct = getattr(st, "time_accounting", None)
    if acct is None:
        return
    counter = getattr(st.router, "records_out_counter", None)
    if counter is not None:
        count = counter.count
        progressed = count != getattr(st, "_attribution_last_out", None)
        st._attribution_last_out = count
    else:
        progressed = st.router.has_queued_output()
    if router_blocked(st.router):
        acct.observe(False, True)
    else:
        acct.observe(progressed, False)


# ---------------------------------------------------------------------
# bottleneck localization
# ---------------------------------------------------------------------

#: a vertex counts as busy-saturated when its busiest subtask spends
#: at least this much of each second doing work
BUSY_SATURATION_MS_PER_S = 500.0


def derive_upstreams(job_graph) -> Dict[int, List[int]]:
    """vertex_id -> upstream vertex_ids, from the JobGraph's edges
    (feedback edges excluded: a cycle must not make a vertex its own
    upstream for the walk)."""
    ups: Dict[int, List[int]] = {vid: [] for vid in job_graph.vertices}
    for edge in job_graph.edges:
        if getattr(edge, "is_feedback", False):
            continue
        src, dst = edge.source_vertex_id, edge.target_vertex_id
        if src != dst and src not in ups.setdefault(dst, []):
            ups[dst].append(src)
    return ups


def read_vertex_stats(dump: Dict[str, object],
                      job_name: str) -> Dict[int, dict]:
    """Per-vertex bottleneck inputs from a registry dump: the
    sticky-window ``backpressure.ratio`` gauge and the max
    ``busyTimeMsPerSecond`` across the vertex's subtasks."""
    prefix = job_name + "."
    stats: Dict[int, dict] = {}

    def entry(token: str) -> Optional[dict]:
        head = token.split("_", 1)
        try:
            vid = int(head[0])
        except ValueError:
            return None
        e = stats.get(vid)
        if e is None:
            e = stats[vid] = {
                "vertex_id": vid,
                "name": head[1] if len(head) > 1 else token,
                "busy_ms_per_s": None, "backpressure_ratio": 0.0}
        return e

    bp_suffix = ".backpressure.ratio"
    busy_suffix = ".busyTimeMsPerSecond"
    for key, value in dump.items():
        if not key.startswith(prefix):
            continue
        rest = key[len(prefix):]
        if rest.endswith(bp_suffix):
            e = entry(rest[:-len(bp_suffix)])
            if e is not None:
                try:
                    e["backpressure_ratio"] = float(value)  # type: ignore
                except (ValueError, TypeError):
                    pass
        elif rest.endswith(busy_suffix):
            # <vid>_<vname>.<subtask>.busyTimeMsPerSecond
            e = entry(rest[:-len(busy_suffix)].rsplit(".", 1)[0])
            if e is not None:
                try:
                    v = float(value)  # type: ignore[arg-type]
                except (ValueError, TypeError):
                    continue
                e["busy_ms_per_s"] = (v if e["busy_ms_per_s"] is None
                                      else max(e["busy_ms_per_s"], v))
    return stats


def locate_bottleneck(upstreams: Dict[int, List[int]],
                      vertex_stats: Dict[int, dict],
                      busy_threshold: float = BUSY_SATURATION_MS_PER_S,
                      ratio_threshold: float = LOW_THRESHOLD
                      ) -> Optional[dict]:
    """Walk the graph downstream-first: the bottleneck is the MOST
    DOWNSTREAM busy-saturated vertex with at least one backpressured
    upstream — pressure propagates upstream from the slow consumer, so
    the deepest such vertex is where the capacity is actually missing
    (everything above it is a victim, everything below is starved)."""
    depth: Dict[int, int] = {}

    def _depth(v: int, seen: tuple = ()) -> int:
        if v in depth:
            return depth[v]
        if v in seen:
            return 0
        ups = upstreams.get(v) or []
        d = 1 + max((_depth(u, seen + (v,)) for u in ups), default=-1)
        depth[v] = d
        return d

    vids = set(upstreams) | set(vertex_stats)
    for v in vids:
        _depth(v)
    candidates = []
    for vid in vids:
        st = vertex_stats.get(vid) or {}
        busy = st.get("busy_ms_per_s")
        if busy is None or busy < busy_threshold:
            continue
        bp_ups = []
        for u in upstreams.get(vid) or []:
            ust = vertex_stats.get(u) or {}
            ratio = ust.get("backpressure_ratio") or 0.0
            if ratio >= ratio_threshold:
                bp_ups.append({"vertex_id": u, "name": ust.get("name"),
                               "ratio": ratio})
        if bp_ups:
            candidates.append((depth.get(vid, 0), vid, st, bp_ups))
    if not candidates:
        return None
    candidates.sort(key=lambda c: (c[0], c[1]))
    d, vid, st, bp_ups = candidates[-1]
    return {"vertex_id": vid, "name": st.get("name"),
            "busyMsPerSecond": st.get("busy_ms_per_s"),
            "backpressured_upstreams": bp_ups, "depth": d}
