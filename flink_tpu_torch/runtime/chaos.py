"""Chaos harness: seeded fault schedules against a reference job (port
of ``flink_tpu/runtime/chaos.py``, on the local executor).

Runs the same keyed windowed-aggregation job twice — once fault-free,
once under a deterministic `FaultInjector` schedule — and hands back
both output multisets plus the fault-tolerance counters, so callers
can assert
exactly-once delivery: the chaos run's output must EQUAL the
fault-free run's, record for record, despite storage-write failures,
lost checkpoint acks, and induced task crashes (ref: Basiri et al.,
"Chaos Engineering", IEEE Software 2016; the reference's
StreamFaultToleranceTestBase family).

The job is event-time windowed, so injected delays never change the
expected output — only the schedule's failures do, and recovery must
erase them.  The source is checkpoint-GATED (the
StreamFaultToleranceTestBase idiom): it
trickles once `FREE` records are out until a checkpoint completes, so
a fault targeting a later record always has a restore point — without
one, a restart replays from scratch and re-fires windows the shared
sink already saw, which is at-least-once, not a runtime bug.
"""

from __future__ import annotations

import collections
import tempfile
import time as _time
from typing import Callable, Optional

from flink_tpu_torch.core.functions import AggregateFunction
from flink_tpu_torch.device import DeviceLike
from flink_tpu_torch.runtime import faults
from flink_tpu_torch.runtime.faults import FaultInjector
from flink_tpu_torch.streaming.sources import FromCollectionSource


class KeyedSumAgg(AggregateFunction):
    """Sum per key, carrying the key into the result so the output
    multiset is checkable per (key, sum) pair."""

    def create_accumulator(self):
        return (None, 0)

    def add(self, value, acc):
        return (value[0], acc[1] + value[1])

    def get_result(self, acc):
        return acc

    def merge(self, a, b):
        return (a[0] if a[0] is not None else b[0], a[1] + b[1])


class CheckpointGatedSource(FromCollectionSource):
    """Emits `FREE` records at full speed, then trickles one record
    per step until a checkpoint COMPLETES, then floods the rest.  Any
    injected fault aimed past the gate (e.g. `after=600` with
    FREE=400) is therefore guaranteed to land with a completed
    checkpoint to restore from, whatever the host load — on a starved
    box the checkpoint round trip can outlast many records, and a
    crash with no restore point replays from offset 0, duplicating
    already-fired windows into the non-transactional sink.  The flag
    rides on a class attribute because the source factory deep-copies
    the function per attempt."""

    FREE = 400          # records emitted before the gate closes
    completed = False   # class attr: reset per run by the harness

    def notify_checkpoint_complete(self, checkpoint_id):
        type(self).completed = True

    def emit_step(self, ctx, max_records):
        if not type(self).completed:
            if self.offset >= self.FREE:
                _time.sleep(0.001)
                return super().emit_step(ctx, 1)
            # the gate closes at FREE whatever the step's budget
            max_records = min(max_records, self.FREE - self.offset)
        return super().emit_step(ctx, max_records)


def windowed_records(n_keys: int = 6, per_key: int = 250):
    """(key, 1) records spread over event-time windows of 1000ms."""
    records = []
    for i in range(per_key):
        for k in range(n_keys):
            records.append(((f"k{k}", 1), i * 10))
    return records


def standard_schedule(inj: FaultInjector) -> FaultInjector:
    """The canonical chaos mix — one schedule of every supported kind
    across three distinct fault classes: storage-write failures
    (healed by backoff retry), lost checkpoint acks (healed by the
    checkpoint timeout re-trigger), an induced task crash (healed by
    restart-from-checkpoint), and a netchannel connect failure (healed
    by connect retry; inert on the local executor, which has no data
    plane)."""
    inj.fail_n_times("storage.persist", 2)
    # the first checkpoint's acks vanish; the pending holds the
    # max_concurrent slot until checkpoint_timeout_ms aborts it
    inj.fail_n_times("checkpoint.ack", 2)
    # crash past the source's FREE=400 gate, so the timeout re-trigger
    # has healed and a completed checkpoint exists to restore from
    inj.fail_n_times("task.process", 1, after=600)
    inj.fail_n_times("netchannel.connect", 1)
    # stretch per-record processing so the job outlives the checkpoint
    # timeout deterministically (event time: output is unaffected)
    inj.delay("task.process", 0.2)
    return inj


def run_windowed_job(executor: str = "local", *,
                     n_keys: int = 6, per_key: int = 250,
                     checkpoint_interval_ms: int = 10,
                     checkpoint_timeout_ms: Optional[int] = 40,
                     tolerable_failures: Optional[int] = 16,
                     restart_attempts: int = 5,
                     checkpoint_dir: Optional[str] = None,
                     job_name: str = "chaos-window",
                     device: DeviceLike = None):
    """One run of the reference job; returns (sink values, result).
    The port runs it on the local executor only."""
    from flink_tpu_torch.streaming.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.streaming.sources import CollectSink
    from flink_tpu_torch.streaming.windowing import Time

    if executor != "local":
        raise ValueError(f"unknown chaos executor '{executor}' (the port "
                         "runs the local executor)")
    if checkpoint_dir is None:
        checkpoint_dir = tempfile.mkdtemp(prefix="flink_tpu_torch_chaos_")
    sink = CollectSink()
    env = StreamExecutionEnvironment(device=device)
    env.enable_checkpointing(checkpoint_interval_ms,
                             timeout_ms=checkpoint_timeout_ms,
                             tolerable_failures=tolerable_failures)
    env.set_checkpoint_storage("filesystem", directory=checkpoint_dir,
                               retain=2)
    env.set_restart_strategy("fixed_delay",
                             restart_attempts=restart_attempts,
                             delay_ms=0)
    CheckpointGatedSource.completed = False
    (env.add_source(CheckpointGatedSource(windowed_records(n_keys, per_key),
                                          timestamped=True),
                    name="from_collection")
        .key_by(lambda v: v[0])
        .time_window(Time.milliseconds_of(1000))
        .aggregate(KeyedSumAgg())
        .add_sink(sink))
    result = env.execute(job_name)
    return list(sink.values), result


def run_chaos_case(executor: str = "local", seed: int = 0,
                   schedule: Callable[[FaultInjector], FaultInjector]
                   = standard_schedule,
                   **job_kw) -> dict:
    """Fault-free run, then the same job under the seeded schedule.

    Returns a dict with `baseline`/`chaos` output multisets
    (collections.Counter), the chaos run's `restarts`, the
    `faulttolerance.*` counter snapshot, the per-point fire counts,
    and the injector itself for schedule-specific asserts.  The
    injector is always deactivated on exit, even when the chaos run
    fails.
    """
    faults.deactivate()
    faults.reset_counters()
    baseline_values, baseline_result = run_windowed_job(executor, **job_kw)

    inj = schedule(FaultInjector(seed=seed))
    faults.reset_counters()
    faults.install(inj)
    try:
        chaos_values, chaos_result = run_windowed_job(executor, **job_kw)
    finally:
        faults.deactivate()
    return {
        "baseline": collections.Counter(baseline_values),
        "chaos": collections.Counter(chaos_values),
        "baseline_restarts": baseline_result.restarts,
        "restarts": chaos_result.restarts,
        "checkpoints_completed": chaos_result.checkpoints_completed,
        "counters": faults.counter_snapshot(),
        "fire_counts": dict(inj.fire_counts),
        "injector": inj,
    }
