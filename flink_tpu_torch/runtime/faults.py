"""Deterministic fault injection for the runtime (port of
``flink_tpu/runtime/faults.py``; chaos engineering,
ref: Basiri et al., "Chaos Engineering", IEEE Software 2016; the
reference's flink-tests fault-tolerance harnesses reach the same goal
with throwing user functions — this layer instead shakes the
*infrastructure* paths those tests cannot reach).

A process-wide, seeded :class:`FaultInjector` owns named fault points:

    storage.persist       checkpoint file/chunk commit (fs.replace)
    storage.fetch_chunk   incremental-checkpoint chunk read
    rpc.connect           RPC client socket connect
    rpc.call              RPC frame send
    netchannel.connect    data-plane subscribe connect
    netchannel.send       data-plane frame send
    task.process          per-record subtask processing
    checkpoint.ack        subtask -> coordinator checkpoint ack

Each point accepts independent schedules:

    fail_n_times(point, n)            next n fires raise FaultInjected
    fail_with_probability(point, p)   each fire fails with prob p (seeded)
    delay(point, ms[, probability])   sleep before proceeding
    crash_once(point)                 one fire raises InjectedCrash
                                      (BaseException — models a hard
                                      process death, not a task error)

Disabled cost: ``fire()`` is a module-global ``None`` check — no lock,
no dict lookup — so production paths pay one attribute read when no
injector is installed.  All mutation is lock-protected (a job may run
on its own thread, beside a checkpoint writer thread); the seeded
RNG stream is consumed under the same lock, so a fixed seed plus a
deterministic fire order (the LocalExecutor's single loop) replays
identically.

The module also provides :func:`retry_with_backoff`, the bounded
exponential-backoff helper the hardened storage/RPC/netchannel paths
share, and the process-wide ``faulttolerance.*`` counters those paths
increment.  The port's local executor fires ``task.process``,
``checkpoint.ack``, ``storage.persist`` and ``storage.fetch_chunk``;
the rpc and netchannel points have no caller in the port.
"""

from __future__ import annotations

import threading
import time
from random import Random
from typing import Callable, Dict, List, Optional

POINTS = (
    "storage.persist",
    "storage.fetch_chunk",
    "rpc.connect",
    "rpc.call",
    "netchannel.connect",
    "netchannel.send",
    "task.process",
    "checkpoint.ack",
)


class FaultInjected(Exception):
    """An induced, recoverable fault (the retry/restart machinery is
    expected to absorb it)."""


class InjectedCrash(BaseException):
    """An induced hard crash.  Deliberately a BaseException so generic
    ``except Exception`` recovery code does NOT absorb it — it models
    the process dying at this point."""


class _Schedule:
    __slots__ = ("kind", "remaining", "probability", "delay_ms", "after",
                 "fired")

    def __init__(self, kind, remaining=0, probability=0.0, delay_ms=0.0,
                 after=0):
        self.kind = kind              # fail_n | fail_prob | delay | crash_once
        self.remaining = remaining    # fail_n / crash_once budget
        self.probability = probability
        self.delay_ms = delay_ms
        self.after = after            # skip the first `after` fires
        self.fired = 0


class FaultInjector:
    """Seeded, process-wide fault injector.  Install with
    :func:`install` (or ``FaultInjector(seed).install()``); remove with
    :func:`deactivate`.  ``injector.fired`` counts injected faults per
    point for test assertions."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._rng = Random(seed)
        self._lock = threading.Lock()
        self._schedules: Dict[str, List[_Schedule]] = {}
        self.fired: Dict[str, int] = {}     # point -> injected fault count
        self.fire_counts: Dict[str, int] = {}  # point -> total fire() calls

    # -- schedule builders (chainable) --------------------------------

    def _sched(self, point: str, sched: _Schedule) -> "FaultInjector":
        if point not in POINTS:
            raise ValueError(f"unknown fault point {point!r}; "
                             f"choose from {POINTS}")
        with self._lock:
            self._schedules.setdefault(point, []).append(sched)
        return self

    def fail_n_times(self, point: str, n: int,
                     after: int = 0) -> "FaultInjector":
        """Fail the next `n` fires — skipping the first `after` fires,
        so a schedule can target e.g. the post-restart attempt."""
        return self._sched(point, _Schedule("fail_n", remaining=n,
                                            after=after))

    def fail_with_probability(self, point: str, probability: float,
                              after: int = 0) -> "FaultInjector":
        return self._sched(point,
                           _Schedule("fail_prob", probability=probability,
                                     after=after))

    def delay(self, point: str, delay_ms: float,
              probability: float = 1.0) -> "FaultInjector":
        return self._sched(point, _Schedule("delay", delay_ms=delay_ms,
                                            probability=probability))

    def crash_once(self, point: str, after: int = 0) -> "FaultInjector":
        return self._sched(point, _Schedule("crash_once", remaining=1,
                                            after=after))

    def reset(self) -> "FaultInjector":
        with self._lock:
            self._schedules.clear()
            self.fired.clear()
            self.fire_counts.clear()
            self._rng = Random(self.seed)
        return self

    def install(self) -> "FaultInjector":
        install(self)
        return self

    # -- firing -------------------------------------------------------

    def _evaluate(self, point: str):
        """Under the lock: decide (delay_ms, failure_exc) for one fire."""
        delay_ms = 0.0
        failure: Optional[BaseException] = None
        self.fire_counts[point] = self.fire_counts.get(point, 0) + 1
        for sched in self._schedules.get(point, ()):
            if sched.kind != "delay" and sched.after > 0:
                sched.after -= 1
                continue
            if sched.kind == "delay":
                if sched.probability >= 1.0 \
                        or self._rng.random() < sched.probability:
                    sched.fired += 1
                    delay_ms += sched.delay_ms
            elif failure is not None:
                continue
            elif sched.kind == "fail_n":
                if sched.remaining > 0:
                    sched.remaining -= 1
                    sched.fired += 1
                    failure = FaultInjected(
                        f"injected fault at {point} "
                        f"(#{sched.fired}, fail_n)")
            elif sched.kind == "fail_prob":
                if self._rng.random() < sched.probability:
                    sched.fired += 1
                    failure = FaultInjected(
                        f"injected fault at {point} "
                        f"(#{sched.fired}, p={sched.probability})")
            elif sched.kind == "crash_once":
                if sched.remaining > 0:
                    sched.remaining -= 1
                    sched.fired += 1
                    failure = InjectedCrash(
                        f"injected crash at {point}")
        if failure is not None:
            self.fired[point] = self.fired.get(point, 0) + 1
        return delay_ms, failure

    def fire(self, point: str) -> None:
        """Raise/delay per the schedules for `point` (no-op otherwise)."""
        with self._lock:
            delay_ms, failure = self._evaluate(point)
        if delay_ms > 0:
            time.sleep(delay_ms / 1000.0)
        if failure is not None:
            raise failure

    def check(self, point: str) -> bool:
        """Like :meth:`fire` but returns True instead of raising
        FaultInjected — for drop semantics (a lost ack is *absorbed*,
        not thrown).  InjectedCrash still raises."""
        with self._lock:
            delay_ms, failure = self._evaluate(point)
        if delay_ms > 0:
            time.sleep(delay_ms / 1000.0)
        if isinstance(failure, InjectedCrash):
            raise failure
        return failure is not None

    def injected(self, point: str) -> int:
        with self._lock:
            return self.fired.get(point, 0)


# ---------------------------------------------------------------------
# process-wide installation — the disabled fast path is one module
# attribute read + None check
# ---------------------------------------------------------------------

_active: Optional[FaultInjector] = None


def install(injector: Optional[FaultInjector]) -> Optional[FaultInjector]:
    global _active
    _active = injector
    return injector


def deactivate() -> None:
    global _active
    _active = None


def get_injector() -> Optional[FaultInjector]:
    return _active


def fire(point: str) -> None:
    inj = _active
    if inj is not None:
        inj.fire(point)


def check(point: str) -> bool:
    inj = _active
    if inj is not None:
        return inj.check(point)
    return False


# ---------------------------------------------------------------------
# faulttolerance.* counters (process-wide; exported as gauges by
# metrics.register_faulttolerance_gauges) + the shared retry helper
# ---------------------------------------------------------------------

_counters_lock = threading.Lock()
retry_counters: Dict[str, int] = {}


def count(name: str, n: int = 1) -> None:
    with _counters_lock:
        retry_counters[name] = retry_counters.get(name, 0) + n


def counter_snapshot() -> Dict[str, int]:
    with _counters_lock:
        return dict(retry_counters)


def reset_counters() -> None:
    with _counters_lock:
        retry_counters.clear()


def retry_with_backoff(fn: Callable, *, attempts: int = 4,
                       base_delay_ms: float = 10.0,
                       max_delay_ms: float = 500.0,
                       deadline_ms: Optional[float] = None,
                       retry_on=(OSError, FaultInjected),
                       counter: Optional[str] = None,
                       clock=time.monotonic,
                       sleep=time.sleep):
    """Run ``fn()``; on a retryable exception back off exponentially
    (base * 2^k, capped) and try again, up to ``attempts`` total tries
    or until ``deadline_ms`` of wall time has elapsed — whichever is
    sooner.  The last failure propagates.  Each RETRY (not the first
    try) bumps ``faulttolerance.<counter>``.

    InjectedCrash is a BaseException and therefore never retried: a
    crash is a crash.
    """
    start = clock()
    delay_ms = base_delay_ms
    last_exc: Optional[BaseException] = None
    for attempt in range(max(1, attempts)):
        if attempt > 0:
            if counter:
                count(counter)
            count("retries_total")
        try:
            return fn()
        except retry_on as e:  # noqa: PERF203 — retry loop
            last_exc = e
            elapsed_ms = (clock() - start) * 1000.0
            out_of_time = (deadline_ms is not None
                           and elapsed_ms + delay_ms >= deadline_ms)
            if attempt == max(1, attempts) - 1 or out_of_time:
                if counter:
                    count(f"{counter}_exhausted")
                raise
            sleep(delay_ms / 1000.0)
            delay_ms = min(delay_ms * 2.0, max_delay_ms)
    raise last_exc  # pragma: no cover — loop always returns or raises
