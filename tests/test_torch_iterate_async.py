"""split/select, iterate and async I/O in the port against the JAX
package, on the CPU: the cases of ``tests/test_datastream_extensions.py``
(split and select, the Collatz-style loop, async ordered, unordered,
overlap, timeout and error) through both packages, and beyond them a
loop at parallelism 3, a loop whose exits feed an event-time window, an
async operator feeding a window, and a checkpoint with requests in
flight followed by a failure: the restart loses no request.

Sinks are compared sorted where the two executors may interleave
differently; the ordered async output is compared in order.
"""

import time

import numpy as np
import pytest

import flink_tpu.core.functions as jfn
import flink_tpu.streaming.operators as jops
import flink_tpu_torch.core.functions as tfn
import flink_tpu_torch.streaming.operators as tops
from flink_tpu.streaming import datastream as jds
from flink_tpu.streaming import sources as jsrc
from flink_tpu.streaming import windowing as jw
from flink_tpu_torch.streaming import datastream as tds
from flink_tpu_torch.streaming import sources as tsrc
from flink_tpu_torch.streaming import windowing as tw

import test_torch_operator_state as opst

PKG = {"torch": dict(ds=tds, src=tsrc, fn=tfn, ops=tops, w=tw),
       "jax": dict(ds=jds, src=jsrc, fn=jfn, ops=jops, w=jw)}
PKGS = ["torch", "jax"]
_CLASSES = {}


def _env(pkg, backend="heap"):
    return opst._env(pkg, backend)


def _run_both(build, name="job"):
    """``build(pkg, env, sink)`` in each package; the sinks' values."""
    out = {}
    for pkg in PKGS:
        env = _env(pkg)
        sink = PKG[pkg]["src"].CollectSink()
        build(pkg, env, sink)
        env.execute(name)
        out[pkg] = sink.values
    return out


# ---------------------------------------------------------------------
# split / select
# ---------------------------------------------------------------------

def test_split_select():
    for pkg in PKGS:
        env = _env(pkg)
        split = env.from_collection(range(10)).split(
            lambda v: ["even"] if v % 2 == 0 else ["odd"])
        evens = PKG[pkg]["src"].CollectSink()
        odds = PKG[pkg]["src"].CollectSink()
        split.select("even").add_sink(evens)
        split.select("odd").add_sink(odds)
        env.execute("split")
        assert sorted(evens.values) == [0, 2, 4, 6, 8]
        assert sorted(odds.values) == [1, 3, 5, 7, 9]


def test_split_multi_route():
    def build(pkg, env, sink):
        split = env.from_collection(range(6)).split(
            lambda v: (["small"] if v < 4 else []) + (["even"] if v % 2 == 0 else []))
        split.select("small", "even").add_sink(sink)
    out = _run_both(build, "split-multi")
    assert sorted(out["torch"]) == sorted(out["jax"]) == [0, 1, 2, 3, 4]


def test_split_routes_nothing_and_many():
    vals = list(np.random.default_rng(1).integers(0, 1000, 500))

    def build(pkg, env, sink):
        split = env.from_collection([int(v) for v in vals]).split(
            lambda v: None if v % 7 == 0 else [f"r{v % 3}", f"r{v % 5}"])
        split.select("r0").map(lambda v: ("r0", v)).add_sink(sink)
        split.select("r1", "r4").map(lambda v: ("r14", v)).add_sink(sink)
    out = _run_both(build, "split-many")
    assert sorted(out["torch"]) == sorted(out["jax"])
    want = sorted([("r0", v) for v in vals if v % 7 and (v % 3 == 0 or v % 5 == 0)]
                  + [("r14", v) for v in vals if v % 7 and
                     ({v % 3, v % 5} & {1, 4})])
    assert sorted(out["torch"]) == [(k, int(v)) for k, v in want]


# ---------------------------------------------------------------------
# iterate
# ---------------------------------------------------------------------

def _collatz(v):
    return v // 2 if v % 2 == 0 else 3 * v + 1


def test_iterate_collatz_style_loop():
    def build(pkg, env, sink):
        it = env.from_collection([8, 5, 3]).iterate()
        stepped = it.map(_collatz, name="step")
        it.close_with(stepped.filter(lambda v: v >= 2, name="feedback_filter"))
        stepped.filter(lambda v: v < 2, name="exit_filter").add_sink(sink)
    out = _run_both(build, "iterate")
    assert sorted(out["torch"]) == sorted(out["jax"]) == [1, 1, 1]


def test_iterate_with_parallel_ops():
    def build(pkg, env, sink):
        it = env.from_collection([10, 20]).iterate()
        dec = it.map(lambda v: v - 7, name="dec")
        it.close_with(dec.filter(lambda v: v > 0, name="fb"))
        dec.filter(lambda v: v <= 0, name="out").add_sink(sink)
    out = _run_both(build, "iterate-2")
    assert sorted(out["torch"]) == sorted(out["jax"]) == [-4, -1]


def _steps(seed):
    n, k = seed, 0
    while n != 1:
        n, k = _collatz(n), k + 1
    return k


@pytest.mark.parametrize("parallelism", [1, 3])
def test_collatz_loop_over_many_seeds(parallelism):
    """Each record goes round once per Collatz step (up to 181 rounds
    here) and leaves with its seed and step count."""
    seeds = list(range(2, 2002))

    def build(pkg, env, sink):
        env.set_parallelism(parallelism)
        it = env.from_collection([(s, s, 0) for s in seeds]).iterate()
        step = it.map(lambda t: (t[0], _collatz(t[1]), t[2] + 1), name="step")
        it.close_with(step.filter(lambda t: t[1] != 1, name="again"))
        step.filter(lambda t: t[1] == 1, name="done").add_sink(sink)
    out = _run_both(build, "collatz")
    want = sorted((s, 1, _steps(s)) for s in seeds)
    assert sorted(out["torch"]) == sorted(out["jax"]) == want


def test_loop_exits_feed_an_event_time_window():
    """A record leaves the loop before the source's next watermark goes
    past the head, so a Sum window behind the exits counts every seed's
    steps (the port only: the reference's iteration head holds its
    watermark at its back edge's, which the head itself feeds, so no
    watermark passes it before the end)."""
    seeds = list(range(2, 3002))
    env = _env("torch")
    sink = tsrc.CollectSink()
    src = env.from_collection([((s, s, 0), s * 10) for s in seeds],
                              timestamped=True)
    it = src.iterate()
    step = it.map(lambda t: (t[0], _collatz(t[1]), t[2] + 1), name="step")
    it.close_with(step.filter(lambda t: t[1] != 1, name="again"))
    (step.filter(lambda t: t[1] == 1, name="done")
        .map(lambda t: (t[0] % 2, t[2]))
        .key_by(lambda t: t[0])
        .time_window(tw.Time.milliseconds_of(5000))
        .sum(1)
        .add_sink(sink))
    env.execute("collatz-window")
    want = {}
    for s in seeds:
        key = (s % 2, s * 10 // 5000)
        want[key] = want.get(key, 0) + _steps(s)
    assert sorted(sink.values) == sorted((p, total) for (p, _), total
                                         in want.items())


# ---------------------------------------------------------------------
# async I/O
# ---------------------------------------------------------------------

class _SlowDoubleMixin:
    def __init__(self, delay_s=0.01):
        self.delay_s = delay_s

    def async_invoke(self, value, result_future):
        time.sleep(self.delay_s)
        result_future.complete([value * 2])


def _slow(pkg, delay):
    key = (pkg, "SlowDouble")
    if key not in _CLASSES:
        _CLASSES[key] = type(f"SlowDouble_{pkg}",
                             (_SlowDoubleMixin, PKG[pkg]["ops"].AsyncFunction), {})
    return _CLASSES[key](delay)


def test_async_ordered_preserves_order():
    def build(pkg, env, sink):
        PKG[pkg]["ds"].AsyncDataStream.ordered_wait(
            env.from_collection(list(range(50))), _slow(pkg, 0.002),
            capacity=8).add_sink(sink)
    out = _run_both(build, "async-ordered")
    assert out["torch"] == out["jax"] == [v * 2 for v in range(50)]


def test_async_unordered_delivers_all():
    def build(pkg, env, sink):
        PKG[pkg]["ds"].AsyncDataStream.unordered_wait(
            env.from_collection(list(range(50))), _slow(pkg, 0.002),
            capacity=8).add_sink(sink)
    out = _run_both(build, "async-unordered")
    assert sorted(out["torch"]) == sorted(out["jax"]) == [v * 2 for v in range(50)]


@pytest.mark.parametrize("ordered", [True, False])
def test_async_concurrency_beats_serial(ordered):
    n, delay = 30, 0.02
    for pkg in PKGS:
        env = _env(pkg)
        sink = PKG[pkg]["src"].CollectSink()
        ads = PKG[pkg]["ds"].AsyncDataStream
        wait = ads.ordered_wait if ordered else ads.unordered_wait
        wait(env.from_collection(list(range(n))), _slow(pkg, delay),
             capacity=16).add_sink(sink)
        t0 = time.perf_counter()
        env.execute("async-concurrent")
        elapsed = time.perf_counter() - t0
        assert sorted(sink.values) == [2 * v for v in range(n)]
        assert elapsed < n * delay * 0.8, f"{pkg}: no overlap: {elapsed:.2f}s"


@pytest.mark.parametrize("ordered", [True, False])
def test_async_timeout_raises(ordered):
    for pkg in PKGS:
        env = _env(pkg)
        ads = PKG[pkg]["ds"].AsyncDataStream
        wait = ads.ordered_wait if ordered else ads.unordered_wait
        wait(env.from_collection([1]), _slow(pkg, 1.0), timeout_ms=30,
             capacity=2).add_sink(PKG[pkg]["src"].CollectSink())
        with pytest.raises(TimeoutError):
            env.execute("async-timeout")


def test_async_error_propagates():
    for pkg in PKGS:
        class Boom(PKG[pkg]["ops"].AsyncFunction):
            def async_invoke(self, value, result_future):
                raise RuntimeError("client blew up")

        env = _env(pkg)
        PKG[pkg]["ds"].AsyncDataStream.ordered_wait(
            env.from_collection([1]), Boom()).add_sink(PKG[pkg]["src"].CollectSink())
        with pytest.raises(RuntimeError, match="client blew up"):
            env.execute("async-error")


class _LookupMixin:
    """A lookup that answers (value, value % 7) after a delay that
    varies by value, so completions come out of order."""

    def async_invoke(self, value, result_future):
        time.sleep(0.0005 * (value % 4))
        result_future.complete([(value[0], value[1] % 7)]
                               if isinstance(value, tuple) else [(value, value % 7)])


def _lookup(pkg):
    key = (pkg, "Lookup")
    if key not in _CLASSES:
        _CLASSES[key] = type(f"Lookup_{pkg}",
                             (_LookupMixin, PKG[pkg]["ops"].AsyncFunction), {})
    return _CLASSES[key]()


@pytest.mark.parametrize("ordered", [True, False])
def test_async_output_feeds_an_event_time_window(ordered):
    """Watermarks wait for the requests ahead of them, so a window
    behind the async operator counts every record."""
    n = 3000
    rng = np.random.default_rng(4)
    vals = [int(v) for v in rng.integers(0, 10_000, n)]

    def build(pkg, env, sink):
        src = env.from_collection([(v, i * 3) for i, v in enumerate(vals)],
                                  timestamped=True)
        ads = PKG[pkg]["ds"].AsyncDataStream
        wait = ads.ordered_wait if ordered else ads.unordered_wait
        (wait(src, _lookup(pkg), capacity=50)
            .map(lambda t: (t[1], 1))
            .key_by(lambda t: t[0])
            .time_window(PKG[pkg]["w"].Time.milliseconds_of(1000))
            .sum(1)
            .add_sink(sink))
    out = _run_both(build, "async-window")
    assert sorted(out["torch"]) == sorted(out["jax"])
    want = {}
    for i, v in enumerate(vals):
        want[(v % 7, i * 3 // 1000)] = want.get((v % 7, i * 3 // 1000), 0) + 1
    assert sorted(c for _, c in out["torch"]) == sorted(want.values())


class _AsyncAddMixin:
    def async_invoke(self, value, result_future):
        time.sleep(0.001)
        result_future.complete([value])


def _async_add(pkg):
    key = (pkg, "AsyncAdd")
    if key not in _CLASSES:
        _CLASSES[key] = type(f"AsyncAdd_{pkg}",
                             (_AsyncAddMixin, PKG[pkg]["ops"].AsyncFunction), {})
    return _CLASSES[key]()


@pytest.mark.parametrize("ordered", [True, False])
@pytest.mark.parametrize("backend", ["heap", "gpu"])
def test_checkpoint_with_requests_in_flight_loses_none(ordered, backend):
    """Checkpoints every 5 ms land while requests are in flight (a
    snapshot waits until they are out), then a failure after one
    completed: the windows behind the async operator count every record
    exactly once, equal to the reference."""
    items = opst._items(2000, n_keys=9, seed=21)
    outs = {}
    for pkg in PKGS:
        opst.source_cls(pkg).reset(gate=600)
        opst.failer_cls(pkg).reset()
        sink = PKG[pkg]["src"].CollectSink()
        env = _env(pkg, backend)
        env.enable_checkpointing(5)
        env.set_restart_strategy("fixed_delay", restart_attempts=3, delay_ms=0)
        ads = PKG[pkg]["ds"].AsyncDataStream
        wait = ads.ordered_wait if ordered else ads.unordered_wait
        stream = env.add_source(opst.source_cls(pkg)(items), name="src").uid("src")
        stream = wait(stream, _async_add(pkg), capacity=32).uid("async")
        (stream.map(opst.failer_cls(pkg)(), name="failer")
            .key_by(lambda v: v[0])
            .time_window(PKG[pkg]["w"].Time.milliseconds_of(1000))
            .aggregate(opst.sum_agg(pkg), lambda k, w, vals: [(k, w.start, v)
                                                            for v in vals])
            .add_sink(sink))
        result = env.execute("async-checkpoint")
        assert opst.failer_cls(pkg).failed and result.restarts == 1
        outs[pkg] = sorted(sink.values)
    assert outs["torch"] == outs["jax"] == opst._expected(items)
