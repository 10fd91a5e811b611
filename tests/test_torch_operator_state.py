"""Operator state in the port against the JAX package, on the CPU.

Ported cases: tests/test_state_backends.py's operator-state round trip
and redistribution (here at 2 -> 3 and 3 -> 2, on both packages, and
each package's snapshot restored into the other).  Added: the restore
assignment of a rescaled savepoint, a job whose source keeps its read
position in operator list state (``initialize_state``) failing after a
checkpoint and restarting, and a savepoint holding that list state
resumed in the other package, both ways (``state/portable.py``).
"""

import os
import pickle
import threading
import time

import numpy as np
import pytest

import flink_tpu.core.functions as jfn
import flink_tpu.runtime.local as jlocal
import flink_tpu.state.operator_state as jos
from flink_tpu.streaming import datastream as jds
from flink_tpu.streaming import elements as jel
from flink_tpu.streaming import sources as jsrc
from flink_tpu.streaming import windowing as jw
import flink_tpu_torch.core.functions as tfn
import flink_tpu_torch.runtime.local as tlocal
import flink_tpu_torch.state.operator_state as tos
from flink_tpu_torch.state import portable
from flink_tpu_torch.streaming import datastream as tds
from flink_tpu_torch.streaming import elements as tel
from flink_tpu_torch.streaming import sources as tsrc
from flink_tpu_torch.streaming import windowing as tw

PKG = {"torch": dict(ds=tds, w=tw, src=tsrc, fn=tfn, os=tos, el=tel,
                     local=tlocal),
       "jax": dict(ds=jds, w=jw, src=jsrc, fn=jfn, os=jos, el=jel,
                   local=jlocal)}
PKGS = ["torch", "jax"]
BACKEND_NAMES = {"heap": {"torch": "heap", "jax": "heap"},
                 "gpu": {"torch": "gpu", "jax": "tpu"}}


def _to_torch(jax_snap):
    """A JAX-package snapshot as the port reads it from a file."""
    return portable.loads(pickle.dumps(jax_snap))


def _to_jax(torch_snap):
    """A port snapshot as the JAX package reads it from a file."""
    return pickle.loads(portable.dumps(torch_snap))


def _lists(backend, names):
    return {n: backend._list_states[n].get() for n in names}


# ---------------------------------------------------------------------
# the backend
# ---------------------------------------------------------------------

@pytest.mark.parametrize("origin", PKGS)
@pytest.mark.parametrize("target", PKGS)
def test_list_union_and_broadcast_round_trip(origin, target):
    b = PKG[origin]["os"].OperatorStateBackend()
    b.get_list_state("offsets").add_all([("p0", 5), ("p1", 7)])
    b.get_union_list_state("all").add(("u", 1))
    b.get_broadcast_state("rules").put("r1", "drop")
    b.get_broadcast_state("rules").put(("k", 2), [1.5, None])
    snap = b.snapshot()
    if origin != target:
        snap = _to_torch(snap) if target == "torch" else _to_jax(snap)
    assert type(snap) is PKG[target]["os"].OperatorStateSnapshot
    b2 = PKG[target]["os"].OperatorStateBackend()
    b2.restore(snap)
    assert b2.get_list_state("offsets").get() == [("p0", 5), ("p1", 7)]
    assert b2.get_union_list_state("all").get() == [("u", 1)]
    rules = b2.get_broadcast_state("rules")
    assert rules.get("r1") == "drop" and rules.get(("k", 2)) == [1.5, None]
    assert sorted(map(repr, rules.keys())) == sorted(map(repr, ["r1", ("k", 2)]))


@pytest.mark.parametrize("pkg", PKGS)
def test_list_modes_do_not_mix(pkg):
    b = PKG[pkg]["os"].OperatorStateBackend()
    b.get_list_state("x")
    with pytest.raises(ValueError, match="already registered"):
        b.get_union_list_state("x")


def _subtask_snapshots(pkg, n_old):
    snaps = []
    for subtask in range(n_old):
        b = PKG[pkg]["os"].OperatorStateBackend()
        b.get_list_state("split").add_all(
            [f"s{subtask}-{i}" for i in range(3 + subtask)])
        b.get_union_list_state("union").add(f"u{subtask}")
        b.get_broadcast_state("rules").put("r", n_old)
        snaps.append(b.snapshot())
    return snaps


@pytest.mark.parametrize("n_old,n_new", [(2, 3), (3, 2)])
def test_redistribution_at_rescale_equals_the_reference(n_old, n_new):
    """Split lists deal round robin, union lists go whole to each new
    subtask, broadcast state to each: the same parts in both packages,
    and the port redistributes the JAX package's snapshots the same."""
    parts = {}
    for pkg in PKGS:
        out = PKG[pkg]["os"].OperatorStateSnapshot.redistribute(
            _subtask_snapshots(pkg, n_old), n_new)
        assert len(out) == n_new
        backends = []
        for part in out:
            b = PKG[pkg]["os"].OperatorStateBackend()
            b.restore(part)
            backends.append(b)
        parts[pkg] = [(_lists(b, ["split", "union"]),
                       b.get_broadcast_state("rules").entries())
                      for b in backends]
    mixed = tos.OperatorStateSnapshot.redistribute(
        [_to_torch(s) for s in _subtask_snapshots("jax", n_old)], n_new)
    mixed_parts = []
    for part in mixed:
        b = tos.OperatorStateBackend()
        b.restore(part)
        mixed_parts.append((_lists(b, ["split", "union"]),
                            b.get_broadcast_state("rules").entries()))
    assert parts["torch"] == parts["jax"] == mixed_parts
    every = sorted(x for p, _ in parts["torch"] for x in p["split"])
    assert every == sorted(f"s{s}-{i}" for s in range(n_old)
                           for i in range(3 + s))
    for p, rules in parts["torch"]:
        assert sorted(p["union"]) == [f"u{s}" for s in range(n_old)]
        assert rules == [("r", n_old)]


@pytest.mark.parametrize("n_old,n_new", [(2, 3), (3, 2)])
def test_restore_assignment_splits_operator_state(n_old, n_new):
    """A savepoint's operator state reaches the rescaled subtasks as
    the reference assigns it: split items dealt over the new subtasks,
    union items to every one."""
    got = {}
    for pkg in PKGS:
        snaps = _subtask_snapshots(pkg, n_old)
        restore_from = {"tasks": {(1, i): {"operators": {"src": {
            "operator": snaps[i]}}} for i in range(n_old)}}
        mapping = PKG[pkg]["local"].compute_restore_assignments(
            {1: n_new}, restore_from, vertex_uids={1: {"src"}})
        per = []
        for i in range(n_new):
            b = PKG[pkg]["os"].OperatorStateBackend()
            ops = [s["operators"]["src"]["operator"]
                   for s in mapping[(1, i)]
                   if "operator" in s["operators"].get("src", {})]
            assert len(ops) == 1
            b.restore(ops[0])
            per.append(_lists(b, ["split", "union"]))
        got[pkg] = per
    assert got["torch"] == got["jax"]


# ---------------------------------------------------------------------
# jobs: a source whose read position is operator list state
# ---------------------------------------------------------------------

_CLASSES = {}


def _cls(pkg, name, mixin, base):
    key = (pkg, name)
    if key not in _CLASSES:
        _CLASSES[key] = type(name, (mixin, base), {})
    return _CLASSES[key]


class _ListOffsetSourceMixin:
    """Emits ``items`` ((value, timestamp) pairs) and keeps its read
    position only in the operator list state ``offset``, reached
    through ``initialize_state``.  Class flags survive the factory's
    deep copy: with ``gate`` it trickles one record a step after
    ``gate`` records until a checkpoint completes; with ``hold`` it
    stops at ``hold`` records until ``released``."""

    gate = None
    completed = False
    hold = None
    released = True
    reached = None

    @classmethod
    def reset(cls, gate=None, hold=None):
        cls.gate, cls.completed = gate, False
        cls.hold, cls.released = hold, hold is None
        cls.reached = threading.Event()

    def __init__(self, items):
        self.items = list(items)
        self._op = None

    def initialize_state(self, op):
        self._op = op

    def _offset_state(self):
        return self._op.operator_state_backend.get_list_state("offset")

    def notify_checkpoint_complete(self, checkpoint_id):
        type(self).completed = True

    def run(self, ctx):
        while self.emit_step(ctx, 1024):
            pass

    def emit_step(self, ctx, max_records):
        cls = type(self)
        state = self._offset_state()
        offset = (state.get() or [0])[0]
        if not cls.released and offset >= cls.hold:
            cls.reached.set()
            time.sleep(0.0005)
            return True
        end = min(len(self.items), offset + max_records)
        if not cls.released:
            end = min(end, cls.hold)
        if cls.gate is not None and not cls.completed and end > cls.gate:
            end = max(offset + 1, cls.gate) if offset < cls.gate else offset + 1
            end = min(end, len(self.items))
            time.sleep(0.0002)
        for value, ts in self.items[offset:end]:
            ctx.collect_with_timestamp(value, ts)
        state.update([end])
        return end < len(self.items)


class _FailOnceMixin:
    completed = False
    failed = False

    @classmethod
    def reset(cls):
        cls.completed = cls.failed = False

    def notify_checkpoint_complete(self, checkpoint_id):
        type(self).completed = True

    def map(self, value):
        cls = type(self)
        if cls.completed and not cls.failed:
            cls.failed = True
            raise RuntimeError("induced failure after checkpoint")
        return value


class _SumAggMixin:
    def create_accumulator(self):
        return 0

    def add(self, value, acc):
        return acc + value[1]

    def get_result(self, acc):
        return acc

    def merge(self, a, b):
        return a + b


def source_cls(pkg):
    return _cls(pkg, "ListOffset", _ListOffsetSourceMixin,
                PKG[pkg]["src"].SourceFunction)


def failer_cls(pkg):
    return _cls(pkg, "FailOnce", _FailOnceMixin, PKG[pkg]["fn"].MapFunction)


def sum_agg(pkg):
    return _cls(pkg, "SumAgg", _SumAggMixin, PKG[pkg]["fn"].AggregateFunction)()


def _env(pkg, backend="heap"):
    p = PKG[pkg]
    env = (p["ds"].StreamExecutionEnvironment(device="cpu") if pkg == "torch"
           else p["ds"].StreamExecutionEnvironment())
    env.set_state_backend(BACKEND_NAMES[backend][pkg])
    return env


def _items(n=3000, n_keys=7, seed=5):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n_keys, n)
    return [((f"k{int(k)}", 1), int(i) * 3) for i, k in enumerate(keys)]


def _job(pkg, env, items, sink, failer=False):
    stream = env.add_source(source_cls(pkg)(items), name="src").uid("src")
    if failer:
        stream = stream.map(failer_cls(pkg)(), name="failer")
    (stream.key_by(lambda v: v[0])
        .time_window(PKG[pkg]["w"].Time.milliseconds_of(1000))
        .aggregate(sum_agg(pkg), lambda k, w, vals: [(k, w.start, v)
                                                     for v in vals])
        .add_sink(sink))


def _expected(items):
    want = {}
    for (k, v), ts in items:
        want[(k, ts - ts % 1000)] = want.get((k, ts - ts % 1000), 0) + v
    return sorted((k, s, v) for (k, s), v in want.items())


@pytest.mark.parametrize("backend", ["heap", "gpu"])
def test_job_with_operator_list_state_fails_and_restarts(backend):
    """The source's offset lives in operator list state only: a failure
    after a completed checkpoint restores it, and the windows count
    every record exactly once, in both packages."""
    items = _items()
    outs = {}
    for pkg in PKGS:
        source_cls(pkg).reset(gate=1000)
        failer_cls(pkg).reset()
        sink = PKG[pkg]["src"].CollectSink()
        env = _env(pkg, backend)
        env.enable_checkpointing(5)
        env.set_restart_strategy("fixed_delay", restart_attempts=3, delay_ms=0)
        _job(pkg, env, items, sink, failer=True)
        result = env.execute("operator-state-restart")
        assert failer_cls(pkg).failed and result.restarts == 1
        assert result.checkpoints_completed >= 1
        outs[pkg] = sorted(sink.values)
    assert outs["torch"] == outs["jax"] == _expected(items)


@pytest.mark.parametrize("origin,target", [("jax", "torch"), ("torch", "jax")])
def test_savepoint_with_operator_lists_crosses_the_packages(origin, target,
                                                            tmp_path):
    """A savepoint whose source offset is operator list state, taken by
    one package while the source holds, resumes in the other: the
    resumed job reads on from the offset, so both halves together equal
    an uninterrupted run."""
    items = _items(2000, seed=9)
    source_cls(origin).reset(hold=len(items) // 2)
    before = PKG[origin]["src"].CollectSink()
    env = _env(origin)
    env.enable_checkpointing(60_000)   # savepoints only
    _job(origin, env, items, before)
    client = env.execute_async("savepoint-origin")
    assert source_cls(origin).reached.wait(60)
    path = client.trigger_savepoint(str(tmp_path / "sp"))
    client.cancel()
    assert client.wait(60).cancelled and os.path.exists(path)

    source_cls(target).reset()
    after = PKG[target]["src"].CollectSink()
    env = _env(target)
    env.set_savepoint_restore(path)
    _job(target, env, items, after)
    assert env.execute("savepoint-resume").restarts == 0
    assert sorted(before.values + after.values) == _expected(items)
