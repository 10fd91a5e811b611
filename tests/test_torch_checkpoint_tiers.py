"""Recovery of the device window operator and checkpoint files that cross
the packages, on the CPU.

A job on each tier of ``DeviceWindowOperator`` (the scatter tier with
composite keys, the log tier with integer keys and with interned string
keys, the fused string sum, the mesh log tier on four virtual CPU
shards) fails once after a checkpoint taken mid-stream and restarts:
its output equals the uninterrupted run's, and the JAX package's.  A
log-tier savepoint taken at parallelism 2 restores at 3; a string-keyed
one refuses another parallelism as the JAX package does.  A checkpoint
directory and a savepoint written by each package restore a job of
the other, the joined output equal to the uninterrupted run's.  Region
failover restarts only the failed pipelined region.

The source emits the first part of its input in one step and then holds
the stream until a checkpoint taken while it holds completes, so that
checkpoint carries real mid-stream state; nothing sleeps on a deadline.
"""

import os
import threading
import time

import numpy as np
import pytest

import flink_tpu.core.functions as jfn
from flink_tpu.ops.device_agg import SumAggregate as JaxSum
from flink_tpu.ops.sketches import HyperLogLogAggregate as JaxHll
from flink_tpu.streaming import datastream as jds
from flink_tpu.streaming import sources as jsrc
from flink_tpu.streaming import windowing as jw
import flink_tpu_torch.core.functions as tfn
from flink_tpu_torch.ops.device_agg import SumAggregate as TorchSum
from flink_tpu_torch.ops.sketches import HyperLogLogAggregate as TorchHll
from flink_tpu_torch.streaming import datastream as tds
from flink_tpu_torch.streaming import sources as tsrc
from flink_tpu_torch.streaming import windowing as tw
from torch_port_util import hll_atol

PKG = {"torch": dict(ds=tds, w=tw, src=tsrc, fn=tfn, sum=TorchSum,
                     hll=TorchHll),
       "jax": dict(ds=jds, w=jw, src=jsrc, fn=jfn, sum=JaxSum, hll=JaxHll)}
PKGS = ["torch", "jax"]

_CLASSES = {}


def _cls(pkg, name, mixin, base):
    if (pkg, name) not in _CLASSES:
        _CLASSES[(pkg, name)] = type(name, (mixin, base), {})
    return _CLASSES[(pkg, name)]


class _Gate:
    """Shared by a job's source and its failing map (class attributes
    survive the deep copies of the operator factories)."""

    hold = 0
    released = False
    reached = None
    held_cid = None
    fail = False
    failed = False
    seen = 0

    @classmethod
    def reset(cls, hold, fail=True):
        cls.hold, cls.released, cls.held_cid = hold, False, None
        cls.reached = threading.Event()
        cls.fail, cls.failed, cls.seen = fail, False, 0


class _HoldMixin:
    """Emits records up to the gate's ``hold`` in one step, then holds
    the stream; a checkpoint whose barrier it took while holding opens
    the gate when it completes.  After the gate the rest goes in one
    step."""

    def emit_step(self, ctx, max_records):
        if _Gate.released or self.offset < _Gate.hold:
            end = len(self.items) if _Gate.released else _Gate.hold
            return super().emit_step(ctx, end - self.offset)
        _Gate.reached.set()
        time.sleep(0.0005)
        return True

    def snapshot_function_state(self, checkpoint_id=None):
        if self.offset >= _Gate.hold and not _Gate.released \
                and checkpoint_id is not None:
            _Gate.held_cid = checkpoint_id
        return super().snapshot_function_state(checkpoint_id)

    def notify_checkpoint_complete(self, checkpoint_id):
        # a savepoint's job keeps holding until it is stopped
        if _Gate.fail and checkpoint_id == _Gate.held_cid:
            _Gate.released = True


class _FailMixin:
    """Fails on the first record after the gate opened, once."""

    def map(self, value):
        _Gate.seen += 1
        if _Gate.fail and _Gate.released and not _Gate.failed:
            _Gate.failed = True
            raise RuntimeError("induced failure after a mid-stream checkpoint")
        return value


def _source(pkg, items):
    return _cls(pkg, "Hold", _HoldMixin, PKG[pkg]["src"].FromCollectionSource)(
        items, timestamped=True)


def _failer(pkg):
    return _cls(pkg, "Fail", _FailMixin, PKG[pkg]["fn"].MapFunction)()


def _env(pkg, backend="heap", parallelism=1):
    p = PKG[pkg]
    env = (p["ds"].StreamExecutionEnvironment(device="cpu") if pkg == "torch"
           else p["ds"].StreamExecutionEnvironment())
    env.set_state_backend({"torch": backend, "jax": "tpu" if backend == "gpu"
                           else backend}[pkg])
    env.set_parallelism(parallelism)
    return env


def _hll(pkg, p=8):
    agg = PKG[pkg]["hll"](p)
    agg.extract_value = lambda v: v[1]
    return agg


def _fsum(pkg):
    agg = PKG[pkg]["sum"](np.float64)
    agg.extract_value = lambda v: v[1]
    return agg


def _plain(x):
    return x.item() if hasattr(x, "item") else x


def _wf(key, window, vals):
    key = (tuple(_plain(k) for k in key) if isinstance(key, (tuple, np.ndarray))
           else _plain(key))
    return [(key, window.start, float(v)) for v in vals]


def _job(pkg, env, items, sink, agg, key_of, fail=False, mesh=None):
    stream = env.add_source(_source(pkg, items), name="src")
    if fail:
        stream = stream.map(_failer(pkg), name="failer")
    if mesh is not None:
        env.set_mesh(mesh)
    (stream.key_by(key_of)
        .window(PKG[pkg]["w"].TumblingEventTimeWindows.of(1000))
        .aggregate(agg, _wf)
        .add_sink(sink))


def _run(pkg, items, agg_of, key_of, fail, backend="heap", mesh=None,
         storage=None, parallelism=1):
    p = PKG[pkg]
    _Gate.reset(hold=len(items) // 2 if fail else 0, fail=fail)
    _Gate.released = not fail
    sink = p["src"].CollectSink()
    env = _env(pkg, backend, parallelism)
    if fail:
        env.enable_checkpointing(1)
        env.set_restart_strategy("fixed_delay", restart_attempts=2, delay_ms=0)
        if storage is not None:
            env.set_checkpoint_storage("filesystem", directory=storage, retain=2)
    _job(pkg, env, items, sink, agg_of(pkg), key_of, fail=fail, mesh=mesh)
    result = env.execute("tier-recovery")
    if fail:
        assert _Gate.failed and result.restarts == 1
        assert result.checkpoints_completed >= 1
        # the restore rewound to the held offset, not to 0
        assert _Gate.seen < len(items) + len(items) // 2 + 2
    return sorted(sink.values)


def _events(n=4000, n_keys=300, span=4000, seed=11, key=int):
    rng = np.random.default_rng(seed)
    ks = rng.integers(0, n_keys, n)
    users = rng.integers(0, 5000, n)
    ts = np.sort(rng.integers(0, span, n))
    return [((key(k), int(u)), int(t)) for k, u, t in zip(ks, users, ts)]


def _assert_hll_rows(got, want, m):
    assert [g[:2] for g in got] == [w[:2] for w in want] and got
    np.testing.assert_allclose([g[2] for g in got], [w[2] for w in want],
                               rtol=1e-5, atol=hll_atol(m))


TIERS = {
    # composite keys: the scatter tier (hll_update on the card).  The
    # keys are strings in both packages: the JAX package sends integer
    # pairs to its log tier, merging them by their first column
    "scatter": (lambda e: (f"g{e[0] % 7}", e[0]), int, _hll, "hll"),
    # integer keys: the log tier
    "log": (lambda e: e[0], int, _hll, "hll"),
    # string keys, interned to dense ids: the log tier and its
    # string-key directory
    "log_strings": (lambda e: e[0], lambda k: f"u{k}", _hll, "hll"),
    # string keys with a float sum: the fused string-sum engine
    "string_sum": (lambda e: e[0], lambda k: f"w{k}", _fsum, "sum"),
}


@pytest.mark.parametrize("tier", list(TIERS))
def test_device_tier_recovers_to_the_uninterrupted_run(tier, tmp_path):
    key_of, key, agg_of, kind = TIERS[tier]
    items = _events(key=key)
    outs = {}
    for pkg in PKGS:
        clean = _run(pkg, items, agg_of, key_of, fail=False)
        failed = _run(pkg, items, agg_of, key_of, fail=True,
                      storage=str(tmp_path / pkg))
        assert failed == clean
        outs[pkg] = clean
    if kind == "hll":
        _assert_hll_rows(outs["torch"], outs["jax"], 1 << 8)
    else:
        assert outs["torch"] == outs["jax"]


def test_device_tier_snapshot_tags_the_tier():
    """The operator snapshot names its tier as the JAX package does."""
    from flink_tpu_torch.streaming.device_window_operator import \
        DeviceWindowOperator
    from flink_tpu_torch.streaming.harness import \
        OneInputStreamOperatorTestHarness
    tags = {}
    for tier, (key_of, key, agg_of, _) in TIERS.items():
        op = DeviceWindowOperator(tw.TumblingEventTimeWindows.of(1000),
                                  agg_of("torch"), _wf, device="cpu")
        h = OneInputStreamOperatorTestHarness(op, key_selector=key_of,
                                              device="cpu")
        h.open()
        for v, t in _events(n=50, key=key):
            h.process_element(v, t)
        snap = op.snapshot_state(1)
        tags[tier] = (snap["device_tier"], "string_key_directory" in snap)
    assert tags == {"scatter": ("vectorized", False), "log": ("log", False),
                    "log_strings": ("log", True),
                    "string_sum": ("string_sum", False)}


def test_mesh_log_tier_recovers_to_the_uninterrupted_run(tmp_path):
    from flink_tpu_torch.parallel import Mesh
    items = _events()
    clean = _run("torch", items, _hll, lambda e: e[0], fail=False,
                 mesh=Mesh(["cpu"] * 4))
    failed = _run("torch", items, _hll, lambda e: e[0], fail=True,
                  mesh=Mesh(["cpu"] * 4), storage=str(tmp_path / "m"))
    assert failed == clean
    # the same windows as the JAX package's job without a mesh
    _assert_hll_rows(clean, _run("jax", items, _hll, lambda e: e[0],
                                 fail=False), 1 << 8)


@pytest.mark.parametrize("backend", ["heap", "gpu"])
def test_keyed_backend_job_recovers_with_lateness(backend, tmp_path):
    """WindowOperator (allowed lateness takes the job off the device
    engines) on the heap and GPU backends."""
    items = _events(n=3000)

    def run(pkg, fail):
        p = PKG[pkg]
        _Gate.reset(hold=len(items) // 2 if fail else 0, fail=fail)
        _Gate.released = not fail
        sink = p["src"].CollectSink()
        env = _env(pkg, backend)
        if fail:
            env.enable_checkpointing(1)
            env.set_restart_strategy("fixed_delay", restart_attempts=2,
                                     delay_ms=0)
        stream = env.add_source(_source(pkg, items), name="src")
        if fail:
            stream = stream.map(_failer(pkg), name="failer")
        (stream.key_by(lambda e: e[0])
            .window(p["w"].TumblingEventTimeWindows.of(1000))
            .allowed_lateness(500)
            .aggregate(_hll(pkg), _wf).add_sink(sink))
        env.execute("keyed")
        return sorted(sink.values)

    for pkg in PKGS:
        assert run(pkg, True) == run(pkg, False)


# ---------------------------------------------------------------------
# savepoints: rescale and the string-keyed refusal
# ---------------------------------------------------------------------

def _savepoint(pkg, items, agg_of, key_of, directory, parallelism=1,
               backend="heap"):
    """Run to the hold, stop with a savepoint; (path, output so far)."""
    p = PKG[pkg]
    _Gate.reset(hold=len(items) // 2, fail=False)
    sink = p["src"].CollectSink()
    env = _env(pkg, backend, parallelism)
    env.enable_checkpointing(60_000)
    _job(pkg, env, items, sink, agg_of(pkg), key_of)
    client = env.execute_async("savepoint-origin")
    assert _Gate.reached.wait(60)
    path = client.stop_with_savepoint(directory)
    assert client.wait(60).cancelled and os.path.exists(path)
    return path, list(sink.values)


def _restore(pkg, items, agg_of, key_of, path, parallelism=1, backend="heap",
             fail_at_open=False, storage=None):
    p = PKG[pkg]
    _Gate.reset(hold=0, fail=False)
    _Gate.released = True
    sink = p["src"].CollectSink()
    env = _env(pkg, backend, parallelism)
    if path is not None:
        env.set_savepoint_restore(path)
    if storage is not None:
        # the restart reads the other package's latest checkpoint
        env.enable_checkpointing(60_000)
        env.set_checkpoint_storage("filesystem", directory=storage, retain=2)
        env.set_restart_strategy("fixed_delay", restart_attempts=2, delay_ms=0)
    stream = env.add_source(_source(pkg, items), name="src")
    if fail_at_open:
        stream = stream.map(_open_failer(pkg), name="failer")
    (stream.key_by(key_of)
        .window(p["w"].TumblingEventTimeWindows.of(1000))
        .aggregate(agg_of(pkg), _wf).add_sink(sink))
    result = env.execute("restored")
    return list(sink.values), result


def test_log_tier_savepoint_rescales_2_to_3(tmp_path):
    items = _events(n=6000, n_keys=500)
    key_of = lambda e: e[0]  # noqa: E731
    want = _run("torch", items, _hll, key_of, fail=False)
    path, before = _savepoint("torch", items, _hll, key_of,
                              str(tmp_path / "sp"), parallelism=2)
    after, _ = _restore("torch", items, _hll, key_of, path, parallelism=3)
    assert sorted(before + after) == want


@pytest.mark.parametrize("pkg", PKGS)
def test_string_keyed_rescale_refused(pkg, tmp_path):
    items = _events(key=lambda k: f"u{k}")
    path, _ = _savepoint(pkg, items, _hll, lambda e: e[0], str(tmp_path / "sp"))
    with pytest.raises(ValueError, match="string-keyed"):
        _restore(pkg, items, _hll, lambda e: e[0], path, parallelism=2)


# ---------------------------------------------------------------------
# files across the packages
# ---------------------------------------------------------------------

CROSS_JOBS = {
    "heap_window": (lambda e: e[0], lambda k: f"k{k}", None),
    "log_tier": (lambda e: e[0], int, _hll),
    "scatter_tier": (lambda e: (f"g{e[0] % 7}", e[0]), int, _hll),
}


def _cross_agg(job):
    agg_of = CROSS_JOBS[job][2]
    if agg_of is not None:
        return agg_of

    def python_sum(pkg):
        class PySum(PKG[pkg]["fn"].AggregateFunction):
            def create_accumulator(self):
                return 0

            def add(self, v, acc):
                return acc + v[1]

            def get_result(self, acc):
                return acc

            def merge(self, a, b):
                return a + b
        return PySum()
    return python_sum


@pytest.mark.parametrize("direction", ["torch_to_jax", "jax_to_torch"])
@pytest.mark.parametrize("job", list(CROSS_JOBS))
def test_savepoint_restores_in_the_other_package(job, direction, tmp_path):
    key_of, key, _ = CROSS_JOBS[job]
    agg_of = _cross_agg(job)
    src, dst = direction.split("_to_")
    items = _events(key=key)
    path, before = _savepoint(src, items, agg_of, key_of, str(tmp_path / "sp"))
    after, _ = _restore(dst, items, agg_of, key_of, path)
    got = sorted(before + after)
    want = _run(dst, items, agg_of, key_of, fail=False)
    if job == "heap_window":
        assert got == want
    else:
        _assert_hll_rows(got, want, 1 << 8)


class _OpenFailMixin:
    """Fails in open() the first time (before the job's own first
    checkpoint), so the restart restores the storage's latest."""

    opened = 0

    def open(self, configuration=None):
        type(self).opened += 1
        if type(self).opened == 1:
            raise RuntimeError("fail at open, once")

    def map(self, value):
        return value


def _open_fail_cls(pkg):
    fn = PKG[pkg]["fn"]
    if ("open", pkg) not in _CLASSES:
        _CLASSES[("open", pkg)] = type("OpenFail", (_OpenFailMixin, fn.MapFunction,
                                                    fn.RichFunction), {})
    return _CLASSES[("open", pkg)]


def _open_failer(pkg):
    return _open_fail_cls(pkg)()


@pytest.mark.parametrize("direction", ["torch_to_jax", "jax_to_torch"])
def test_checkpoint_directory_restores_in_the_other_package(direction,
                                                            tmp_path):
    """A job of one package fails after a mid-stream checkpoint into
    an Fs directory and stops (no restart); a job of the other package
    on that directory fails at open once and restarts from the latest
    checkpoint there.  Both packages' output joined equals the
    uninterrupted run."""
    src, dst = direction.split("_to_")
    items = _events(key=lambda k: f"k{k}")
    key_of = lambda e: e[0]  # noqa: E731
    agg_of = _cross_agg("heap_window")
    d = str(tmp_path / "chk")
    p = PKG[src]
    _Gate.reset(hold=len(items) // 2)
    sink = p["src"].CollectSink()
    env = _env(src)
    env.enable_checkpointing(1)
    env.set_checkpoint_storage("filesystem", directory=d, retain=2)
    _job(src, env, items, sink, agg_of(src), key_of, fail=True)
    with pytest.raises(RuntimeError, match="induced failure"):
        env.execute("origin")
    before = list(sink.values)
    _open_fail_cls(dst).opened = 0
    after, result = _restore(dst, items, agg_of, key_of, None,
                             fail_at_open=True, storage=d)
    assert result.restarts == 1
    assert sorted(before + after) == _run(dst, items, agg_of, key_of,
                                          fail=False)


# ---------------------------------------------------------------------
# region failover
# ---------------------------------------------------------------------

def test_region_failover_restarts_only_the_failed_region():
    """Two disconnected pipelines: one fails after a checkpoint; only
    its region restores, the other keeps its live state; both outputs
    equal their uninterrupted runs."""
    items_a = _events(seed=1)
    items_b = _events(seed=2)
    want = {}
    for name, items in (("a", items_a), ("b", items_b)):
        want[name] = _run("torch", items, _cross_agg("heap_window"),
                          lambda e: e[0], fail=False)
    _Gate.reset(hold=len(items_a) // 2)
    sinks = {"a": tsrc.CollectSink(), "b": tsrc.CollectSink()}
    env = _env("torch")
    env.enable_checkpointing(1)
    env.set_restart_strategy("fixed_delay", restart_attempts=2, delay_ms=0)
    env.set_failover_strategy("region")
    _job("torch", env, items_a, sinks["a"], _cross_agg("heap_window")("torch"),
         lambda e: e[0], fail=True)
    (env.from_collection(items_b, timestamped=True)
        .key_by(lambda e: e[0])
        .window(tw.TumblingEventTimeWindows.of(1000))
        .aggregate(_cross_agg("heap_window")("torch"), _wf)
        .add_sink(sinks["b"]))
    result = env.execute("regions")
    assert result.restarts == 1 and result.region_restarts == 1
    assert sorted(sinks["a"].values) == want["a"]
    assert sorted(sinks["b"].values) == want["b"]
