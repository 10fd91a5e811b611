"""Checkpoints, recovery and savepoints in the port against the JAX
package, on the CPU: the same jobs through both packages'
environments (the port on ``device="cpu"``) with equal results.

Ported cases: tests/test_checkpointing.py (exactly-once recovery on the
heap and GPU backends, no restart, exhausted attempts, Fs retention,
at-least-once mode, alignment over union inputs, the restart
strategies, memory retention, declined / timed-out / late-acked
checkpoints, tolerable failures, the orphan sweep),
tests/test_savepoints.py, tests/test_incremental_checkpoints.py and the
local-executor cases of tests/test_chaos.py.  Added: a
DeviceWindowOperator job on every tier that fails after a checkpoint
and equals the uninterrupted run, a rescaled restore on the log tier,
the string-keyed rescale error, region failover, and checkpoint
directories and savepoints of each package restoring a job of the
other.

Failures are gated on a completed checkpoint (a function hears
``notify_checkpoint_complete``) and savepoints on a source that holds
its stream: the checks compare results, never checkpoint counts beyond
"at least one", and no test sleeps on a wall-clock deadline to pass.
"""

import os
import threading
import time
import warnings

import numpy as np
import pytest

import flink_tpu.core.functions as jfn
import flink_tpu.runtime.chaos as jchaos
import flink_tpu.runtime.checkpoints as jcp
import flink_tpu.runtime.faults as jfaults
import flink_tpu.runtime.local as jlocal
import flink_tpu.state.shared_registry as jsr
from flink_tpu.ops.device_agg import SumAggregate as JaxSum
from flink_tpu.ops.sketches import HyperLogLogAggregate as JaxHll
from flink_tpu.streaming import datastream as jds
from flink_tpu.streaming import log_windows as jlw
from flink_tpu.streaming import sources as jsrc
from flink_tpu.streaming import windowing as jw
import flink_tpu_torch.core.functions as tfn
import flink_tpu_torch.runtime.chaos as tchaos
import flink_tpu_torch.runtime.checkpoints as tcp
import flink_tpu_torch.runtime.faults as tfaults
import flink_tpu_torch.runtime.local as tlocal
import flink_tpu_torch.state.shared_registry as tsr
from flink_tpu_torch.ops.device_agg import SumAggregate as TorchSum
from flink_tpu_torch.ops.sketches import HyperLogLogAggregate as TorchHll
from flink_tpu_torch.streaming import datastream as tds
from flink_tpu_torch.streaming import log_windows as tlw
from flink_tpu_torch.streaming import sources as tsrc
from flink_tpu_torch.streaming import windowing as tw

PKG = {"torch": dict(ds=tds, w=tw, src=tsrc, fn=tfn, cp=tcp, faults=tfaults,
                     local=tlocal, sr=tsr, lw=tlw, chaos=tchaos,
                     sum=TorchSum, hll=TorchHll),
       "jax": dict(ds=jds, w=jw, src=jsrc, fn=jfn, cp=jcp, faults=jfaults,
                   local=jlocal, sr=jsr, lw=jlw, chaos=jchaos,
                   sum=JaxSum, hll=JaxHll)}
PKGS = ["torch", "jax"]
#: (port backend, JAX backend)
BACKEND_NAMES = {"heap": {"torch": "heap", "jax": "heap"},
                 "gpu": {"torch": "gpu", "jax": "tpu"}}


@pytest.fixture(autouse=True)
def _clean_faults():
    for pkg in PKGS:
        PKG[pkg]["faults"].deactivate()
        PKG[pkg]["faults"].reset_counters()
    yield
    for pkg in PKGS:
        PKG[pkg]["faults"].deactivate()
        PKG[pkg]["faults"].reset_counters()


# ---------------------------------------------------------------------
# per-package user classes: one mixin, made into a subclass of each
# package's base class
# ---------------------------------------------------------------------

_CLASSES = {}


def _cls(pkg, name, mixin, base):
    key = (pkg, name)
    if key not in _CLASSES:
        _CLASSES[key] = type(name, (mixin, base), {})
    return _CLASSES[key]


class _SumAggMixin:
    def create_accumulator(self):
        return 0

    def add(self, value, acc):
        return acc + value[1]

    def get_result(self, acc):
        return acc

    def merge(self, a, b):
        return a + b


class _FailOnceMixin:
    """Throws once, after a checkpoint completed (the class flags
    survive the deep copies an operator factory makes)."""

    completed = False
    failed = False
    seen = 0

    @classmethod
    def reset(cls):
        cls.completed = False
        cls.failed = False
        cls.seen = 0

    def notify_checkpoint_complete(self, checkpoint_id):
        type(self).completed = True

    def map(self, value):
        cls = type(self)
        cls.seen += 1
        if cls.completed and not cls.failed:
            cls.failed = True
            raise RuntimeError("induced failure after checkpoint")
        return value


class _HoldingSourceMixin:
    """Emits ``HOLD`` records, then holds the stream (emits nothing,
    stays alive) until ``released``; ``reached`` is set once it holds.
    The class attributes survive the source factory's deep copy."""

    HOLD = 600
    released = False
    reached = None

    @classmethod
    def reset(cls, hold=600):
        cls.HOLD = hold
        cls.released = False
        cls.reached = threading.Event()

    def emit_step(self, ctx, max_records):
        cls = type(self)
        if not cls.released and self.offset >= cls.HOLD:
            cls.reached.set()
            time.sleep(0.0005)
            return True
        if not cls.released:
            max_records = min(max_records, cls.HOLD - self.offset)
        return super().emit_step(ctx, max_records)


class _GatedSourceMixin:
    """Emits ``FREE`` records, then one a step until a checkpoint
    completes (a failure aimed past the gate has a restore point)."""

    FREE = 400
    completed = False

    def notify_checkpoint_complete(self, checkpoint_id):
        type(self).completed = True

    def emit_step(self, ctx, max_records):
        cls = type(self)
        if not cls.completed and self.offset >= cls.FREE:
            time.sleep(0.0005)
            return super().emit_step(ctx, 1)
        return super().emit_step(ctx, min(max_records, cls.FREE - self.offset)
                                 if self.offset < cls.FREE else max_records)


def sum_agg(pkg):
    return _cls(pkg, "SumAgg", _SumAggMixin, PKG[pkg]["fn"].AggregateFunction)()


def failer_cls(pkg):
    return _cls(pkg, "FailOnce", _FailOnceMixin, PKG[pkg]["fn"].MapFunction)


def holding_cls(pkg):
    return _cls(pkg, "Holding", _HoldingSourceMixin,
                PKG[pkg]["src"].FromCollectionSource)


def gated_cls(pkg):
    return _cls(pkg, "Gated", _GatedSourceMixin,
                PKG[pkg]["src"].FromCollectionSource)


def _env(pkg, backend="heap", parallelism=1):
    p = PKG[pkg]
    env = (p["ds"].StreamExecutionEnvironment(device="cpu") if pkg == "torch"
           else p["ds"].StreamExecutionEnvironment())
    env.set_state_backend(BACKEND_NAMES[backend][pkg])
    env.set_parallelism(parallelism)
    return env


def _records(n_keys=6, per_key=300):
    return [((f"k{k}", 1), i * 10) for i in range(per_key) for k in range(n_keys)]


def _window_fn(key, window, vals):
    return [(key, window.start, v) for v in vals]


def _window_job(pkg, env, source_fn, sink, with_failer=False,
                agg=None, window_ms=1000):
    stream = env.add_source(source_fn, name="src")
    if with_failer:
        stream = stream.map(failer_cls(pkg)(), name="failer")
    (stream.key_by(lambda v: v[0])
        .time_window(PKG[pkg]["w"].Time.milliseconds_of(window_ms))
        .aggregate(agg if agg is not None else sum_agg(pkg), _window_fn)
        .add_sink(sink))


# ---------------------------------------------------------------------
# tests/test_checkpointing.py
# ---------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["heap", "gpu"])
def test_exactly_once_window_recovery(backend):
    """Fails mid-stream after a completed checkpoint, restarts under
    fixed_delay: the (key, window, sum) rows equal an uninterrupted run
    and the JAX package's."""
    records = _records(n_keys=6, per_key=300)
    outs = {}
    for pkg in PKGS:
        p = PKG[pkg]
        clean = p["src"].CollectSink()
        env = _env(pkg, backend)
        _window_job(pkg, env, p["src"].FromCollectionSource(records, True), clean)
        env.execute("clean")

        failer_cls(pkg).reset()
        gated_cls(pkg).completed = False
        sink = p["src"].CollectSink()
        env = _env(pkg, backend)
        env.enable_checkpointing(5)
        env.set_restart_strategy("fixed_delay", restart_attempts=3, delay_ms=0)
        _window_job(pkg, env, gated_cls(pkg)(records, timestamped=True), sink,
                    with_failer=True)
        result = env.execute("exactly-once-recovery")
        assert failer_cls(pkg).failed
        assert result.restarts == 1 and result.checkpoints_completed >= 1
        # the source resumed at the checkpointed offset, not at 0
        assert failer_cls(pkg).seen < 2 * len(records)
        assert sorted(sink.values) == sorted(clean.values)
        outs[pkg] = sorted(sink.values)
    assert outs["torch"] == outs["jax"]
    assert sum(v[2] for v in outs["torch"]) == 6 * 300


@pytest.mark.parametrize("pkg", PKGS)
def test_no_restart_strategy_propagates_failure(pkg):
    p = PKG[pkg]
    failer_cls(pkg).reset()
    gated_cls(pkg).completed = False
    env = _env(pkg)
    env.enable_checkpointing(5)
    _window_job(pkg, env, gated_cls(pkg)(_records(), timestamped=True),
                p["src"].CollectSink(), with_failer=True)
    with pytest.raises(RuntimeError, match="induced failure"):
        env.execute("no-restart")


@pytest.mark.parametrize("pkg", PKGS)
def test_restart_attempts_exhausted(pkg):
    p = PKG[pkg]

    class AlwaysFail(p["fn"].MapFunction):
        def map(self, v):
            raise ValueError("permanent")

    env = _env(pkg)
    env.enable_checkpointing(1000)
    env.set_restart_strategy("fixed_delay", restart_attempts=2, delay_ms=0)
    (env.from_collection([1, 2, 3]).map(AlwaysFail())
        .add_sink(p["src"].CollectSink()))
    with pytest.raises(ValueError, match="permanent"):
        env.execute("exhausted")


def test_periodic_checkpoints_and_storage_retention(tmp_path):
    """Fs storage: checkpoint files under the directory, retained two
    deep, each with every subtask's snapshot; equal sink output in
    both packages."""
    records = _records(n_keys=4, per_key=400)
    outs = {}
    for pkg in PKGS:
        p = PKG[pkg]
        d = str(tmp_path / pkg)
        gated_cls(pkg).completed = False
        sink = p["src"].CollectSink()
        env = _env(pkg)
        env.enable_checkpointing(5)
        env.set_checkpoint_storage("filesystem", directory=d, retain=2)
        _window_job(pkg, env, gated_cls(pkg)(records, timestamped=True), sink)
        result = env.execute("fs-storage")
        assert result.checkpoints_completed >= 1
        storage = p["cp"].FsCheckpointStorage(d)
        ids = storage.checkpoint_ids()
        assert 1 <= len(ids) <= 2
        latest = storage.latest()
        assert latest["checkpoint_id"] == ids[-1]
        assert len(latest["tasks"]) == 2
        uids = {uid for snap in latest["tasks"].values()
                for uid in snap["operators"]}
        assert any("window" in u for u in uids) and any("sink" in u for u in uids)
        outs[pkg] = sorted(sink.values)
    assert outs["torch"] == outs["jax"]


def test_at_least_once_mode_checkpoints():
    records = _records(n_keys=3, per_key=300)
    outs = {}
    for pkg in PKGS:
        p = PKG[pkg]
        gated_cls(pkg).completed = False
        sink = p["src"].CollectSink()
        env = _env(pkg)
        env.enable_checkpointing(5, mode="at_least_once")
        _window_job(pkg, env, gated_cls(pkg)(records, timestamped=True), sink)
        result = env.execute("at-least-once")
        assert result.checkpoints_completed >= 1
        outs[pkg] = sorted(sink.values)
    assert outs["torch"] == outs["jax"]
    assert sum(v[2] for v in outs["torch"]) == 3 * 300


def test_barrier_alignment_across_union_inputs():
    """Two sources union into one keyed window: the window subtask
    aligns the barriers of both channels before its snapshot; a failure
    after a checkpoint restores an aligned cut."""
    recs_a = [((f"k{i % 3}", 1), i * 10) for i in range(1200)]
    recs_b = [((f"k{i % 3}", 2), i * 10) for i in range(1200)]
    outs = {}
    for pkg in PKGS:
        p = PKG[pkg]
        gated_cls(pkg).completed = False
        failer_cls(pkg).reset()
        sink = p["src"].CollectSink()
        env = _env(pkg)
        env.enable_checkpointing(5)
        env.set_restart_strategy("fixed_delay", restart_attempts=2, delay_ms=0)
        a = env.add_source(gated_cls(pkg)(recs_a, timestamped=True), name="a")
        b = env.add_source(p["src"].FromCollectionSource(recs_b, True), name="b")
        (a.union(b).map(failer_cls(pkg)(), name="failer")
            .key_by(lambda v: v[0])
            .time_window(p["w"].Time.milliseconds_of(10000))
            .aggregate(sum_agg(pkg), _window_fn)
            .add_sink(sink))
        result = env.execute("aligned-union")
        assert result.checkpoints_completed >= 1
        assert failer_cls(pkg).failed and result.restarts == 1
        outs[pkg] = sorted(sink.values)
    assert outs["torch"] == outs["jax"]
    assert sum(v[2] for v in outs["torch"]) == 1200 * 3


def test_alignment_holds_post_barrier_elements():
    """The port's alignment at the subtask: what a channel delivers
    after its barrier waits in the channel until the other channel's
    barrier is in; the snapshot sees only pre-barrier records, and the
    held ones follow the forwarded barrier."""
    from flink_tpu_torch.streaming.elements import (CheckpointBarrier,
                                                    StreamRecord)
    from flink_tpu_torch.streaming.graph import JobVertex, StreamNode
    from flink_tpu_torch.streaming.operators import StreamOperator
    from flink_tpu_torch.streaming.timers import TestProcessingTimeService

    class Counter(StreamOperator):
        def __init__(self):
            super().__init__()
            self.n = 0

        def process_element(self, record):
            self.n += record.value

        def snapshot_state(self, checkpoint_id=None):
            return {"n": self.n}

    vertex = JobVertex(1, [StreamNode(1, "c", Counter)], [])
    st = tlocal.SubtaskInstance(vertex, device="cpu",
                                processing_time_service=TestProcessingTimeService())
    acks = []
    st.ack_fn = lambda key, cid, snap: acks.append((cid, snap))
    a, b = st.new_channel(0), st.new_channel(0)
    a.push(StreamRecord(1))
    a.push(CheckpointBarrier(1, 0, {"mode": "exactly_once"}))
    a.push(StreamRecord(10))     # after a's barrier: held
    b.push(StreamRecord(100))    # b has no barrier yet: processed
    assert st.head.n == 101 and acks == [] and len(a.held) == 1
    b.push(CheckpointBarrier(1, 0, {"mode": "exactly_once"}))
    assert acks == [(1, {"operators": {"op-1-c": {"n": 101}}})]
    assert st.head.n == 111 and not a.held and not a.blocked


@pytest.mark.parametrize("pkg", PKGS)
def test_fixed_delay_strategy(pkg):
    s = PKG[pkg]["cp"].FixedDelayRestartStrategy(2, delay_ms=7)
    assert s.can_restart()
    s.notify_failure(0)
    assert s.can_restart()
    s.notify_failure(1)
    assert not s.can_restart()
    assert s.delay_ms == 7


@pytest.mark.parametrize("pkg", PKGS)
def test_failure_rate_strategy(pkg):
    s = PKG[pkg]["cp"].FailureRateRestartStrategy(max_failures=2,
                                                 failure_interval_ms=1000)
    s.notify_failure(0)
    assert s.can_restart()
    s.notify_failure(100)
    assert not s.can_restart()
    s.notify_failure(2000)
    assert s.can_restart()


@pytest.mark.parametrize("pkg", PKGS)
def test_make_restart_strategy(pkg):
    cp = PKG[pkg]["cp"]
    assert isinstance(cp.make_restart_strategy(None), cp.NoRestartStrategy)
    assert isinstance(cp.make_restart_strategy(
        {"strategy": "fixed_delay", "restart_attempts": 1}),
        cp.FixedDelayRestartStrategy)
    assert isinstance(cp.make_restart_strategy(
        {"strategy": "failure_rate", "max_failures": 3}),
        cp.FailureRateRestartStrategy)
    with pytest.raises(ValueError):
        cp.make_restart_strategy({"strategy": "bogus"})


def test_failure_rate_restarts_a_job():
    """A job under failure_rate recovers like one under fixed_delay."""
    records = _records(n_keys=3, per_key=200)
    outs = {}
    for pkg in PKGS:
        p = PKG[pkg]
        failer_cls(pkg).reset()
        gated_cls(pkg).completed = False
        sink = p["src"].CollectSink()
        env = _env(pkg)
        env.enable_checkpointing(5)
        env.set_restart_strategy("failure_rate", max_failures=2,
                                 failure_interval_ms=60_000)
        _window_job(pkg, env, gated_cls(pkg)(records, timestamped=True), sink,
                    with_failer=True)
        result = env.execute("failure-rate")
        assert result.restarts == 1
        outs[pkg] = sorted(sink.values)
    assert outs["torch"] == outs["jax"]


@pytest.mark.parametrize("pkg", PKGS)
def test_memory_storage_retention(pkg):
    st = PKG[pkg]["cp"].MemoryCheckpointStorage(retain=2)
    for cid in (1, 2, 3):
        st.persist(cid, {}, {(1, 0): {"x": cid}})
    assert st.checkpoint_ids() == [2, 3]
    assert st.latest()["checkpoint_id"] == 3
    assert st.load(1) is None


def _make_coordinator(pkg, **kw):
    cp = PKG[pkg]["cp"]
    clock = [1000.0]
    triggered = []

    def trigger_sources(cid, ts, options):
        triggered.append(cid)
        return True

    coord = cp.CheckpointCoordinator(
        interval_ms=10, mode="exactly_once",
        storage=cp.MemoryCheckpointStorage(retain=2),
        expected_tasks={(1, 0), (2, 0)}, trigger_sources=trigger_sources,
        notify_complete=lambda cid: None, clock=lambda: clock[0], **kw)
    return coord, clock, triggered


@pytest.mark.parametrize("pkg", PKGS)
def test_declined_checkpoint_releases_slot(pkg):
    coord, clock, _ = _make_coordinator(pkg)
    cid1 = coord.maybe_trigger()
    assert cid1 is not None
    clock[0] += 20
    assert coord.maybe_trigger() is None
    coord.decline(cid1)
    assert not coord.pending
    clock[0] += 20
    assert coord.maybe_trigger() == cid1 + 1
    assert coord.aborted_count == 1


@pytest.mark.parametrize("pkg", PKGS)
def test_timed_out_checkpoint_releases_slot(pkg):
    coord, clock, _ = _make_coordinator(pkg, checkpoint_timeout_ms=50)
    cid1 = coord.maybe_trigger()
    coord.acknowledge((1, 0), cid1, {"s": 1})
    clock[0] += 60
    assert coord.maybe_trigger() == cid1 + 1
    assert cid1 not in coord.pending
    assert coord.timeout_aborts == 1 and coord.completed_count == 0


@pytest.mark.parametrize("pkg", PKGS)
def test_late_ack_of_aborted_checkpoint_ignored(pkg):
    coord, clock, _ = _make_coordinator(pkg, checkpoint_timeout_ms=50)
    cid1 = coord.maybe_trigger()
    coord.acknowledge((1, 0), cid1, {"s": 1})
    clock[0] += 60
    cid2 = coord.maybe_trigger()
    coord.acknowledge((2, 0), cid1, {"s": 2})
    assert coord.completed_count == 0 and cid1 not in coord.pending
    coord.acknowledge((1, 0), cid2, {"s": 1})
    coord.acknowledge((2, 0), cid2, {"s": 2})
    assert coord.completed_count == 1 and coord.latest_completed_id == cid2


@pytest.mark.parametrize("pkg", PKGS)
def test_tolerable_failures_escalates_after_budget(pkg):
    coord, clock, _ = _make_coordinator(pkg, tolerable_checkpoint_failures=2)
    for _ in range(2):
        cid = coord.maybe_trigger()
        coord.decline(cid)
        clock[0] += 20
    cid = coord.maybe_trigger()
    with pytest.raises(PKG[pkg]["cp"].CheckpointFailuresExceeded):
        coord.decline(cid)


@pytest.mark.parametrize("pkg", PKGS)
def test_completed_checkpoint_resets_consecutive_failures(pkg):
    coord, clock, _ = _make_coordinator(pkg, tolerable_checkpoint_failures=1)
    coord.decline(coord.maybe_trigger())
    clock[0] += 20
    cid = coord.maybe_trigger()
    coord.acknowledge((1, 0), cid, {"s": 1})
    coord.acknowledge((2, 0), cid, {"s": 2})
    assert coord.completed_count == 1 and coord.consecutive_failures == 0
    clock[0] += 20
    coord.decline(coord.maybe_trigger())
    assert coord.consecutive_failures == 1


@pytest.mark.parametrize("pkg", PKGS)
def test_fs_storage_sweeps_orphaned_part_files(pkg, tmp_path):
    cp = PKG[pkg]["cp"]
    d = str(tmp_path / "chk")
    storage = cp.FsCheckpointStorage(d, retain=2)
    storage.persist(1, {"mode": "exactly_once"}, {(1, 0): {"s": 1}})
    os.makedirs(os.path.join(d, "shared"), exist_ok=True)
    for orphan in [os.path.join(d, "chk-9.part"),
                   os.path.join(d, "shared", "chunk-abc.part")]:
        with open(orphan, "wb") as f:
            f.write(b"torn")
    reopened = cp.FsCheckpointStorage(d, retain=2)
    assert reopened.checkpoint_ids() == [1]
    assert not [n for n in os.listdir(d) if n.endswith(".part")]
    assert not [n for n in os.listdir(os.path.join(d, "shared"))
                if n.endswith(".part")]
    assert reopened.latest()["checkpoint_id"] == 1


# ---------------------------------------------------------------------
# tests/test_savepoints.py
# ---------------------------------------------------------------------

def _savepoint_origin(pkg, records, directory, parallelism=1, backend="heap",
                      stop=False, agg=None):
    """Run the job until its source holds, then savepoint (and stop)."""
    p = PKG[pkg]
    holding_cls(pkg).reset(hold=len(records) // 2)
    sink = p["src"].CollectSink()
    env = _env(pkg, backend, parallelism)
    env.enable_checkpointing(60_000)   # savepoints only
    _window_job(pkg, env, holding_cls(pkg)(records, timestamped=True), sink,
                agg=agg)
    client = env.execute_async("savepoint-origin")
    assert holding_cls(pkg).reached.wait(60)
    if stop:
        path = client.stop_with_savepoint(directory)
    else:
        path = client.trigger_savepoint(directory)
        client.cancel()
    result = client.wait(60)
    assert result.cancelled and os.path.exists(path)
    return path, list(sink.values)


def _resume(pkg, records, path, parallelism=1, backend="heap", agg=None,
            **restore_kw):
    p = PKG[pkg]
    holding_cls(pkg).reset()
    holding_cls(pkg).released = True
    sink = p["src"].CollectSink()
    env = _env(pkg, backend, parallelism)
    env.set_savepoint_restore(path, **restore_kw)
    _window_job(pkg, env, holding_cls(pkg)(records, timestamped=True), sink,
                agg=agg)
    result = env.execute("savepoint-resume")
    assert result.restarts == 0
    return list(sink.values)


def _clean_run(pkg, records, parallelism=1, backend="heap", agg=None):
    p = PKG[pkg]
    sink = p["src"].CollectSink()
    env = _env(pkg, backend, parallelism)
    _window_job(pkg, env, p["src"].FromCollectionSource(records, True), sink,
                agg=agg)
    env.execute("clean")
    return sorted(sink.values)


@pytest.mark.parametrize("pkg", PKGS)
def test_savepoint_and_resume_same_parallelism(pkg, tmp_path):
    records = _records()
    path, before = _savepoint_origin(pkg, records, str(tmp_path / "sp"))
    after = _resume(pkg, records, path)
    assert sorted(before + after) == _clean_run(pkg, records)


@pytest.mark.parametrize("pkg", PKGS)
def test_stop_with_savepoint_and_rescale(pkg, tmp_path):
    """Savepoint at parallelism 1, resume at 2; savepoint at 2, resume
    at 1."""
    records = _records()
    want = _clean_run(pkg, records)
    path, before = _savepoint_origin(pkg, records, str(tmp_path / "sp1"),
                                     stop=True)
    assert sorted(before + _resume(pkg, records, path, parallelism=2)) == want
    path2, before2 = _savepoint_origin(pkg, records, str(tmp_path / "sp2"),
                                       parallelism=2, stop=True)
    assert sorted(before2 + _resume(pkg, records, path2, parallelism=1)) == want


@pytest.mark.parametrize("pkg", PKGS)
def test_savepoint_requires_checkpointing(pkg, tmp_path):
    p = PKG[pkg]
    holding_cls(pkg).reset(hold=100)
    env = _env(pkg)
    _window_job(pkg, env, holding_cls(pkg)(_records(per_key=50), True),
                p["src"].CollectSink())
    client = env.execute_async("no-cp")
    with pytest.raises(RuntimeError, match="checkpointing"):
        client.trigger_savepoint(str(tmp_path / "nowhere"))
    holding_cls(pkg).released = True
    client.wait(60)


@pytest.mark.parametrize("pkg", PKGS)
def test_stateful_orphan_fails_restore_unless_allowed(pkg):
    compute = PKG[pkg]["local"].compute_restore_assignments
    restore = {"tasks": {(7, 0): {"operators": {
        "stateful-op": {"my_engine_state": {"x": 1}},
        "stateless-op": {}}}}}
    new_uids = {1: {"some-other-op"}}
    with pytest.raises(RuntimeError, match="stateful-op"):
        compute({1: 1}, restore, vertex_uids=new_uids)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = compute({1: 1}, restore, vertex_uids=new_uids,
                      allow_non_restored=True)
    assert any("DROPPED" in str(x.message) for x in w) and out == {}
    restore2 = {"tasks": {(7, 0): {"operators": {"stateless-op": {}}}}}
    with warnings.catch_warnings(record=True) as w2:
        warnings.simplefilter("always")
        assert compute({1: 1}, restore2, vertex_uids=new_uids) == {}
    assert not w2


@pytest.mark.parametrize("pkg", PKGS)
def test_chained_operator_orphan_detected_inside_matched_vertex(pkg):
    compute = PKG[pkg]["local"].compute_restore_assignments
    restore = {"tasks": {(3, 0): {"operators": {
        "pinned-agg": {"engine": {"windows": 1}},
        "op-4-sink": {"function": {"pending": ["txn"]}}}}}}
    with pytest.raises(RuntimeError, match="op-4-sink"):
        compute({2: 1}, restore, vertex_uids={2: {"pinned-agg", "op-3-sink"}})


def test_function_state_assigned_exactly_once_on_rescale():
    """Each old subtask's function state goes to exactly one new
    subtask, in both packages alike."""
    restore = {"tasks": {(1, i): {"operators": {"op": {
        "function": {"i": i}, "timers": {}}}} for i in range(3)}}
    outs = []
    for pkg in PKGS:
        out = PKG[pkg]["local"].compute_restore_assignments({1: 2}, restore)
        outs.append({k: sorted(s["operators"]["op"]["function"]["i"]
                               for s in v if "function" in s["operators"].get("op", {}))
                     for k, v in out.items()})
    assert outs[0] == outs[1] == {(1, 0): [0, 2], (1, 1): [1]}


# ---------------------------------------------------------------------
# tests/test_incremental_checkpoints.py
# ---------------------------------------------------------------------

def _chunked_snapshot(sr, payloads):
    return {(1, 0): {"windows": {s: sr.SharedChunk(p) for s, p in payloads.items()}}}


@pytest.mark.parametrize("pkg", PKGS)
def test_unchanged_chunks_cost_zero_bytes(pkg):
    p = PKG[pkg]
    storage = p["cp"].MemoryCheckpointStorage(retain=2)
    big = {"keys": np.arange(200_000, dtype=np.uint64)}
    size1 = storage.persist(1, {}, _chunked_snapshot(p["sr"], {0: big}))
    size2 = storage.persist(2, {}, _chunked_snapshot(p["sr"], {0: big}))
    assert size1 > 1_000_000 and size2 < 2_000
    for cid in (1, 2):
        w = storage.load(cid)["tasks"][(1, 0)]["windows"][0]
        assert np.array_equal(w["keys"], big["keys"])


@pytest.mark.parametrize("pkg", PKGS)
def test_chunk_refcount_and_retention(pkg):
    p = PKG[pkg]
    storage = p["cp"].MemoryCheckpointStorage(retain=2)
    a, b = {"x": np.ones(1000)}, {"x": np.zeros(1000)}
    storage.persist(1, {}, _chunked_snapshot(p["sr"], {0: a}))
    storage.persist(2, {}, _chunked_snapshot(p["sr"], {0: a, 1: b}))
    assert len(storage._chunks) == 2
    storage.persist(3, {}, _chunked_snapshot(p["sr"], {1: b}))
    assert len(storage._chunks) == 2
    storage.persist(4, {}, _chunked_snapshot(p["sr"], {1: b}))
    assert set(storage._chunks) == {p["sr"].content_hash(b)}


def test_content_hash_equal_across_packages():
    payload = {"keys": np.arange(100, dtype=np.uint64), "n": [1, (2, b"x")]}
    assert tsr.content_hash(payload) == jsr.content_hash(payload)


@pytest.mark.parametrize("pkg", PKGS)
def test_fs_storage_chunks_and_fresh_process_recovery(pkg, tmp_path):
    p = PKG[pkg]
    d = str(tmp_path / "chk")
    storage = p["cp"].FsCheckpointStorage(d, retain=2)
    big = {"keys": np.arange(100_000, dtype=np.uint64)}
    size1 = storage.persist(1, {}, _chunked_snapshot(p["sr"], {0: big}))
    size2 = storage.persist(2, {}, _chunked_snapshot(p["sr"], {0: big}))
    assert size2 < size1 / 50
    s2 = p["cp"].FsCheckpointStorage(d, retain=2)
    w = s2.latest()["tasks"][(1, 0)]["windows"][0]
    assert np.array_equal(w["keys"], big["keys"])
    small = {"k": np.ones(10)}
    for cid in (3, 4, 5):
        s2.persist(cid, {}, _chunked_snapshot(p["sr"], {1: small}))
    assert s2.latest()["checkpoint_id"] == 5
    # the big chunk went with the last checkpoint that held it
    assert len(os.listdir(os.path.join(d, "shared"))) == 1


@pytest.mark.parametrize("pkg", PKGS)
def test_payload_elision_requires_known_hash(pkg):
    p = PKG[pkg]
    storage = p["cp"].MemoryCheckpointStorage(retain=2)
    payload = {"x": np.ones(10)}
    h = p["sr"].content_hash(payload)
    with pytest.raises(KeyError, match="elided"):
        storage.persist(1, {}, {(1, 0): p["sr"].SharedChunk(None, h)})
    storage.persist(2, {}, {(1, 0): p["sr"].SharedChunk(payload)})
    storage.persist(3, {}, {(1, 0): p["sr"].SharedChunk(None, h)})
    assert np.array_equal(storage.load(3)["tasks"][(1, 0)]["x"], payload["x"])


def test_log_engine_unchanged_window_reuses_chunk_hash():
    """The log tier's per-window chunks dedupe across checkpoints, and
    the port's chunk hashes equal the JAX package's."""
    hashes = {}
    for pkg in PKGS:
        p = PKG[pkg]
        kw = {"device": "cpu"} if pkg == "torch" else {}
        eng = p["lw"].LogStructuredTumblingWindows(p["sum"](np.float64), 1000, **kw)
        keys = np.arange(5000, dtype=np.uint64)
        eng.process_batch(keys, np.full(5000, 100), np.ones(5000))
        eng.process_batch(keys[:10], np.full(10, 1100), np.ones(10))
        s1 = eng.snapshot()
        h1 = {start: c.hash for start, c in s1["windows"].items()}
        eng.process_batch(keys[:5], np.full(5, 1150), np.ones(5))
        s2 = eng.snapshot()
        assert s2["windows"][0].hash == h1[0]
        assert s2["windows"][1000].hash != h1[1000]
        storage = p["cp"].MemoryCheckpointStorage(retain=2)
        sz1 = storage.persist(1, {}, {(1, 0): s1})
        sz2 = storage.persist(2, {}, {(1, 0): s2})
        assert sz2 < sz1 / 10
        restored = p["lw"].LogStructuredTumblingWindows(p["sum"](np.float64),
                                                        1000, **kw)
        restored.restore(storage.load(2)["tasks"][(1, 0)])
        restored.advance_watermark(10_000)
        eng.advance_watermark(10_000)
        assert sorted(map(tuple, restored.emitted)) == sorted(map(tuple, eng.emitted))
        hashes[pkg] = [s2["windows"][w].hash for w in sorted(s2["windows"])]
    assert hashes["torch"] == hashes["jax"]


def test_keyed_backend_per_key_group_chunks_dedupe():
    from flink_tpu_torch.core.keygroups import KeyGroupRange
    from flink_tpu_torch.core.state import ValueStateDescriptor
    from flink_tpu_torch.state.heap_backend import HeapKeyedStateBackend
    be = HeapKeyedStateBackend(KeyGroupRange(0, 127), 128)
    desc = ValueStateDescriptor("v")
    for k in range(2000):
        be.set_current_key(k)
        be.get_partitioned_state((), desc).update(k)
    snap1 = be.snapshot()
    storage = tcp.MemoryCheckpointStorage(retain=2)
    sz1 = storage.persist(1, {}, {(1, 0): snap1})
    be.set_current_key(7)
    be.get_partitioned_state((), desc).update(-1)
    snap2 = be.snapshot()
    sz2 = storage.persist(2, {}, {(1, 0): snap2})
    assert sz2 < sz1 / 4
    kinds = (tsr.SharedChunk,)
    changed = ({c.hash for c in tsr.find_chunks(snap2, [], kinds)}
               - {c.hash for c in tsr.find_chunks(snap1, [], kinds)})
    assert len(changed) == 1


def _gated_storage(pkg):
    """A memory storage whose persist records its thread's name, says it
    has begun and then waits until the test releases it."""
    base = PKG[pkg]["cp"].MemoryCheckpointStorage

    class Gated(base):
        def __init__(self):
            super().__init__(retain=2)
            self.threads = []
            self.entered = threading.Event()
            self.release = threading.Event()

        def persist(self, checkpoint_id, metadata, task_snapshots):
            self.threads.append(threading.current_thread().name)
            self.entered.set()
            assert self.release.wait(60), "the test never released persist"
            return super().persist(checkpoint_id, metadata, task_snapshots)
    return Gated()


@pytest.mark.parametrize("pkg", PKGS)
def test_async_persist_off_barrier_path(pkg):
    notified = []
    storage = _gated_storage(pkg)
    coord = PKG[pkg]["cp"].CheckpointCoordinator(
        interval_ms=None, mode="exactly_once", storage=storage,
        expected_tasks={(1, 0)}, trigger_sources=lambda cid, ts, o: None,
        notify_complete=notified.append, async_persist=True)
    cid = coord.trigger()
    # persist blocks until released: an acknowledge that returns while it
    # is held did not write on the barrier path
    coord.acknowledge((1, 0), cid, {"s": 1})
    assert storage.entered.wait(60)
    assert storage.threads == ["checkpoint-writer"]
    assert coord.completed_count == 0 and notified == []
    st = coord.stats[cid]
    assert st.sync_duration_ms is not None and st.complete_ms is None
    storage.release.set()
    coord.drain()
    assert coord.completed_count == 1 and notified == [cid]
    assert st.complete_ms is not None and st.sync_duration_ms <= st.duration_ms
    assert storage.threads == ["checkpoint-writer"]


@pytest.mark.parametrize("pkg", PKGS)
def test_async_persist_visible_after_drain_for_recovery(pkg):
    storage = _gated_storage(pkg)
    coord = PKG[pkg]["cp"].CheckpointCoordinator(
        interval_ms=None, mode="exactly_once", storage=storage,
        expected_tasks={(1, 0)}, trigger_sources=lambda cid, ts, o: None,
        notify_complete=lambda cid: None, async_persist=True)
    cid = coord.trigger()
    coord.acknowledge((1, 0), cid, {"s": 42})
    storage.release.set()
    coord.drain()
    assert storage.latest()["tasks"][(1, 0)]["s"] == 42


def test_async_persist_end_to_end_job(tmp_path):
    records = [((i % 7, 1.0), (i % 500) * 4) for i in range(20_000)]
    outs = {}
    for pkg in PKGS:
        p = PKG[pkg]
        agg = p["sum"](np.float64)
        agg.extract_value = lambda v: v[1]
        gated_cls(pkg).completed = False
        sink = p["src"].CollectSink()
        env = _env(pkg)
        env.enable_checkpointing(5, async_persist=True)
        env.set_checkpoint_storage("filesystem", directory=str(tmp_path / pkg))
        _window_job(pkg, env, gated_cls(pkg)(records, timestamped=True), sink,
                    agg=agg, window_ms=2000)
        result = env.execute("async-cp")
        assert result.checkpoints_completed >= 1
        outs[pkg] = sorted(sink.values)
    assert outs["torch"] == outs["jax"]
    assert sum(v[2] for v in outs["torch"]) == 20_000


# ---------------------------------------------------------------------
# tests/test_chaos.py, local executor
# ---------------------------------------------------------------------

def test_chaos_exactly_once(tmp_path):
    r = tchaos.run_chaos_case("local", seed=7, device="cpu",
                              checkpoint_dir=str(tmp_path / "chk"))
    assert r["baseline_restarts"] == 0
    assert r["chaos"] == r["baseline"], r["counters"]
    assert r["restarts"] == 1
    assert r["injector"].injected("task.process") == 1
    assert r["injector"].injected("storage.persist") == 2
    assert r["counters"].get("storage_retries") == 2
    assert r["injector"].injected("checkpoint.ack") == 2
    assert r["counters"].get("checkpoint_timeouts", 0) >= 1
    assert r["checkpoints_completed"] >= 1
    # the same job and schedule on the JAX package: the same output
    j = jchaos.run_chaos_case("local", seed=7,
                              checkpoint_dir=str(tmp_path / "jax"))
    assert j["chaos"] == r["chaos"]


def test_chaos_deterministic_replay(tmp_path):
    a = tchaos.run_chaos_case("local", seed=21, device="cpu",
                              checkpoint_dir=str(tmp_path / "a"))
    b = tchaos.run_chaos_case("local", seed=21, device="cpu",
                              checkpoint_dir=str(tmp_path / "b"))
    assert dict(a["injector"].fired) == dict(b["injector"].fired)
    assert a["chaos"] == b["chaos"] == a["baseline"]


def test_injected_crash_is_not_absorbed(tmp_path):
    tfaults.FaultInjector(seed=0).crash_once("task.process", after=50).install()
    with pytest.raises(tfaults.InjectedCrash):
        tchaos.run_windowed_job("local", per_key=100, device="cpu",
                                checkpoint_dir=str(tmp_path / "chk"))


def test_corrupted_latest_falls_back_at_restore(tmp_path):
    chk_dir = str(tmp_path / "chk")
    tfaults.FaultInjector(seed=0).delay("task.process", 0.2).install()
    try:
        tchaos.run_windowed_job("local", per_key=150, device="cpu",
                                checkpoint_dir=chk_dir)
    finally:
        tfaults.deactivate()
    ids = tcp.FsCheckpointStorage(chk_dir, retain=2).checkpoint_ids()
    assert len(ids) >= 2
    with open(os.path.join(chk_dir, f"chk-{ids[-1]}"), "r+b") as f:
        f.seek(12)
        f.write(b"\xff\xff\xff\xff")
    entry = tcp.FsCheckpointStorage(chk_dir, retain=2).latest()
    assert entry is not None and entry["checkpoint_id"] == ids[-2]
    assert tfaults.counter_snapshot().get("checkpoint_fallbacks", 0) >= 1


def test_disabled_injector_fire_is_cheap():
    n = 200_000
    start = time.perf_counter()
    for _ in range(n):
        tfaults.fire("task.process")
    assert time.perf_counter() - start < 1.0


def test_schedule_after_offset_and_determinism():
    inj = tfaults.FaultInjector(seed=9)
    inj.fail_n_times("rpc.call", 2, after=3)
    outcomes = []
    for _ in range(8):
        try:
            inj.fire("rpc.call")
            outcomes.append(False)
        except tfaults.FaultInjected:
            outcomes.append(True)
    assert outcomes == [False, False, False, True, True, False, False, False]

    def prob_outcomes(faults_mod):
        p = faults_mod.FaultInjector(seed=9)
        p.fail_with_probability("rpc.call", 0.4)
        out = []
        for _ in range(64):
            try:
                p.fire("rpc.call")
                out.append(False)
            except faults_mod.FaultInjected:
                out.append(True)
        return out

    assert prob_outcomes(tfaults) == prob_outcomes(tfaults) == prob_outcomes(jfaults)


def _random_schedule(inj):
    inj.fail_with_probability("storage.persist", 0.10)
    inj.fail_with_probability("checkpoint.ack", 0.05)
    inj.fail_n_times("task.process", 1, after=400)
    inj.delay("task.process", 0.2)
    return inj


@pytest.mark.parametrize("seed", [1, 2])
def test_chaos_sweep_local(seed, tmp_path):
    r = tchaos.run_chaos_case("local", seed=seed, schedule=_random_schedule,
                              device="cpu", checkpoint_dir=str(tmp_path / "chk"))
    assert r["chaos"] == r["baseline"]
