"""Processing time in the port against the JAX package, output for
output: the reference's processing-time operator cases
(tests/test_window_operator.py) and sliding windows, the continuous
processing-time trigger and sessions with a fixed and a per-element gap
through both packages' test harness with the clock set step by step, on
the heap and GPU backends (the JAX package's heap and TPU backends);
HLL sketches on processing-time windows; ingestion time, the
``processing`` characteristic's end-of-input flush
(tests/test_datastream_api.py) and a window tail that crosses a keyed
edge after the end of input (tests/test_checkpointing.py) through both
packages' environments; and the polled wall-clock service on a clock
the test sets."""

import numpy as np
import pytest

from flink_tpu.core import state as jstate
from flink_tpu.ops.device_agg import SumAggregate as JaxSum
from flink_tpu.ops.sketches import HyperLogLogAggregate as JaxHll
from flink_tpu.streaming import datastream as jds
from flink_tpu.streaming import harness as jh
from flink_tpu.streaming import sources as jsrc
from flink_tpu.streaming import timers as jt
from flink_tpu.streaming import window_operator as jwo
from flink_tpu.streaming import windowing as jw
from flink_tpu_torch.core import state as tstate
from flink_tpu_torch.ops.device_agg import SumAggregate as TorchSum
from flink_tpu_torch.ops.sketches import HyperLogLogAggregate as TorchHll
from flink_tpu_torch.streaming import datastream as tds
from flink_tpu_torch.streaming import harness as th
from flink_tpu_torch.streaming import sources as tsrc
from flink_tpu_torch.streaming import timers as tt
from flink_tpu_torch.streaming import window_operator as two
from flink_tpu_torch.streaming import windowing as tw
from torch_port_util import assert_hll_close

PKG = {"torch": dict(ds=tds, w=tw, src=tsrc, wo=two, h=th, st=tstate,
                     t=tt, sum=TorchSum, hll=TorchHll),
       "jax": dict(ds=jds, w=jw, src=jsrc, wo=jwo, h=jh, st=jstate,
                   t=jt, sum=JaxSum, hll=JaxHll)}
#: (port backend, JAX backend)
BACKENDS = [("heap", "heap"), ("gpu", "tpu")]


def _sum_op(pkg, assigner, trigger=None):
    """keyBy(t[0]) window sum(t[1]) -> (key, sum, start, end)."""
    p = PKG[pkg]
    agg = p["sum"](np.float32)
    agg.extract_value = lambda v: v[1]

    def fn(key, window, elements):
        for v in elements:
            yield (key, float(v), window.start, window.end)

    return p["wo"].WindowOperator(
        assigner, p["st"].AggregatingStateDescriptor("win-sum", agg),
        window_function=fn, trigger=trigger)


def _harness(pkg, op, backend):
    h = PKG[pkg]["h"].OneInputStreamOperatorTestHarness(
        op, key_selector=lambda x: x[0], state_backend=backend,
        **({"device": "cpu"} if pkg == "torch" else {}))
    h.open()
    return h


def _drive(pkg, backend, build, script):
    """Run ``script`` — ("t", now) sets the clock, ("e", value) feeds a
    record without a timestamp — and return the output after each
    clock step."""
    h = _harness(pkg, build(pkg), backend)
    out = []
    seen = 0
    for kind, arg in script:
        if kind == "t":
            h.set_processing_time(arg)
            records = h.get_output()
            out.append(sorted((r.value, r.timestamp) for r in records[seen:]))
            seen = len(records)
        else:
            h.process_element(arg, None)
    return out


def _cases():
    return {
        # tests/test_window_operator.py:183
        "tumbling": (
            lambda pkg: _sum_op(pkg, PKG[pkg]["w"].TumblingProcessingTimeWindows
                                .of(PKG[pkg]["w"].Time.seconds(1))),
            [("t", 100), ("e", ("p", 1)), ("e", ("p", 2)), ("t", 999),
             ("t", 1000), ("e", ("p", 4)), ("t", 2000)],
            [[], [(("p", 3.0, 0, 1000), 999)], [],
             [(("p", 4.0, 1000, 2000), 1999)]]),
        # tests/test_window_operator.py:199
        "session": (
            lambda pkg: _sum_op(pkg, PKG[pkg]["w"].ProcessingTimeSessionWindows
                                .with_gap(PKG[pkg]["w"].Time.seconds(1))),
            [("t", 0), ("e", ("s", 1)), ("t", 500), ("e", ("s", 2)),
             ("t", 1498), ("t", 1499)],
            [[], [], [], [(("s", 3.0, 0, 1500), 1499)]]),
        "sliding": (
            lambda pkg: _sum_op(pkg, PKG[pkg]["w"].SlidingProcessingTimeWindows
                                .of(1000, 500)),
            [("t", 100), ("e", ("a", 1)), ("e", ("b", 2)), ("t", 600),
             ("e", ("a", 4)), ("t", 1200), ("e", ("b", 8)), ("t", 3000)],
            None),
        "continuous": (
            lambda pkg: _sum_op(
                pkg, PKG[pkg]["w"].TumblingProcessingTimeWindows.of(1000),
                trigger=PKG[pkg]["w"].ContinuousProcessingTimeTrigger(250)),
            [("t", 10), ("e", ("c", 1)), ("t", 260), ("e", ("c", 2)),
             ("e", ("d", 5)), ("t", 510), ("t", 760), ("e", ("c", 4)),
             ("t", 1001), ("t", 2500)],
            None),
        "dynamic_session": (
            lambda pkg: _sum_op(
                pkg, PKG[pkg]["w"].DynamicProcessingTimeSessionWindows
                .with_dynamic_gap(lambda v: 100 * v[1])),
            [("t", 0), ("e", ("x", 3)), ("e", ("y", 1)), ("t", 150),
             ("e", ("x", 2)), ("e", ("y", 1)), ("t", 250), ("t", 349),
             ("t", 351), ("e", ("y", 5)), ("t", 2000)],
            None),
    }


@pytest.mark.parametrize("backends", BACKENDS, ids=["heap", "gpu"])
@pytest.mark.parametrize("case", ["tumbling", "session", "sliding",
                                  "continuous", "dynamic_session"])
def test_processing_time_operator_cases_equal_reference(case, backends):
    build, script, want = _cases()[case]
    outs = [_drive(pkg, backend, build, script)
            for pkg, backend in zip(("torch", "jax"), backends)]
    assert outs[0] == outs[1]
    assert any(outs[0]), "nothing fired"
    if want is not None:
        assert outs[0] == want


@pytest.mark.parametrize("backends", BACKENDS, ids=["heap", "gpu"])
def test_processing_time_hll_windows_equal_reference(backends):
    """HLL per key over tumbling processing-time windows, the clock
    advanced after each chunk of records."""
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 40, 2000).tolist()
    users = rng.integers(0, 500, 2000).tolist()
    outs = {}
    for pkg, backend in zip(("torch", "jax"), backends):
        p = PKG[pkg]
        agg = p["hll"](8)
        agg.extract_value = lambda v: v[1]

        def fn(key, window, elements):
            for v in elements:
                yield (key, window.start, float(v))

        op = p["wo"].WindowOperator(
            p["w"].TumblingProcessingTimeWindows.of(1000),
            p["st"].AggregatingStateDescriptor("hll", agg), window_function=fn)
        h = _harness(pkg, op, backend)
        for i in range(4):
            h.set_processing_time(1000 * i)     # fires window i - 1
            for k, u in zip(keys[i * 500:(i + 1) * 500],
                            users[i * 500:(i + 1) * 500]):
                h.process_element((k, u), None)
        h.set_processing_time(4000)
        outs[pkg] = sorted(r.value for r in h.get_output())
    got, want = outs["torch"], outs["jax"]
    assert [g[:2] for g in got] == [w[:2] for w in want] and len(got) == 160
    assert {g[1] for g in got} == {0, 1000, 2000, 3000}
    assert_hll_close([g[2] for g in got], [w[2] for w in want], 1 << 8)


def _env(pkg, backend="heap", tc="processing"):
    p = PKG[pkg]
    env = (p["ds"].StreamExecutionEnvironment(device="cpu") if pkg == "torch"
           else p["ds"].StreamExecutionEnvironment())
    env.set_state_backend(backend)
    env.set_stream_time_characteristic(tc)
    return env


@pytest.mark.parametrize("backends", BACKENDS, ids=["heap", "gpu"])
def test_processing_time_windows_flush_at_end(backends):
    """tests/test_datastream_api.py:329 through both environments."""
    outs = {}
    for pkg, backend in zip(("torch", "jax"), backends):
        env = _env(pkg, backend)
        out = []
        (env.from_collection([("p", 1), ("p", 2), ("q", 5)])
            .key_by(lambda t: t[0])
            .time_window(PKG[pkg]["w"].Time.seconds(5))
            .sum(1)
            .collect_into(out))
        env.execute()
        outs[pkg] = sorted(out)
    assert outs["torch"] == outs["jax"] == [("p", 3), ("q", 5)]


def test_processing_time_window_tail_crosses_edges():
    """tests/test_checkpointing.py:422: the end-of-input timer fire
    emits across a second keyed edge, whose records must still reach
    the sink."""
    outs = {}
    for pkg in ("torch", "jax"):
        p = PKG[pkg]

        class SumAgg(p["ds"].AggregateFunction):
            def create_accumulator(self):
                return 0

            def add(self, value, acc):
                return acc + value[1]

            def get_result(self, acc):
                return acc

            def merge(self, a, b):
                return a + b

        env = _env(pkg)
        sink = p["src"].CollectSink()
        (env.from_collection([("a", 1)] * 10 + [("b", 1)] * 5)
            .key_by(lambda v: v[0])
            .window(p["w"].TumblingProcessingTimeWindows.of(
                p["w"].Time.milliseconds_of(100)))
            .aggregate(SumAgg())
            .key_by(lambda v: v)
            .map(lambda v: ("tail", v))
            .add_sink(sink))
        env.execute("proc-time-tail")
        outs[pkg] = sorted(sink.values)
    assert outs["torch"] == outs["jax"] == [("tail", 5), ("tail", 10)]


@pytest.mark.parametrize("backends", BACKENDS, ids=["heap", "gpu"])
def test_processing_time_hll_job_equals_heap_and_reference(backends):
    """A ``processing`` job with an HLL aggregate: one window at the
    test clock's 0, flushed at the end of input, equal on both
    backends and to the JAX package."""
    rng = np.random.default_rng(5)
    rows = list(zip(rng.integers(0, 30, 3000).tolist(),
                    rng.integers(0, 400, 3000).tolist()))
    outs = {}
    for pkg, backend in zip(("torch", "jax"), backends):
        p = PKG[pkg]
        agg = p["hll"](10)
        agg.extract_value = lambda v: v[1]
        env = _env(pkg, backend)
        out = []
        (env.from_collection(rows).key_by(lambda v: v[0])
            .time_window(p["w"].Time.seconds(1))
            .aggregate(agg, lambda k, w, vals: [(k, w.start, float(v))
                                                for v in vals])
            .collect_into(out))
        env.execute()
        outs[pkg] = sorted(out)
    got, want = outs["torch"], outs["jax"]
    assert [g[:2] for g in got] == [w[:2] for w in want] and len(got) == 30
    assert_hll_close([g[2] for g in got], [w[2] for w in want], 1 << 10)


def test_ingestion_time_equals_reference():
    """Ingestion time: the source stamps records with the clock, event-
    time windows fire on the automatic and the final watermarks."""
    outs = {}
    for pkg in ("torch", "jax"):
        p = PKG[pkg]
        env = _env(pkg, tc="ingestion")
        out = []
        (env.from_collection([("i", v) for v in range(7)] + [("j", 9)])
            .key_by(lambda t: t[0])
            .time_window(p["w"].Time.seconds(1))
            .sum(1)
            .collect_into(out))
        env.execute()
        outs[pkg] = sorted(out)
    assert outs["torch"] == outs["jax"] == [("i", 21), ("j", 9)]


class _Clock:
    """A clock the test moves; a map function moves it per record."""

    now = 0


def _polled(pkg):
    svc = PKG[pkg]["t"].PolledProcessingTimeService()
    svc.get_current_processing_time = lambda: _Clock.now
    return svc


def test_polled_service_fire_due_and_fire_all_pending():
    for pkg in ("torch", "jax"):
        _Clock.now = 0
        svc = _polled(pkg)
        fired = []
        for ts in (30, 10, 20, 50):
            svc.register_timer(ts, fired.append)
        assert svc.fire_due() == 0 and svc.has_pending()
        _Clock.now = 20
        assert svc.fire_due() == 2 and fired == [10, 20]

        def rearm(ts):
            fired.append(ts)
            svc.register_timer(ts + 5, rearm)   # past the drain's horizon
        svc.register_timer(40, rearm)
        svc.fire_all_pending()
        # the drain fires up to the latest timer at entry (50), the
        # re-armed ones at 45 and 50 too, and stops before 55
        assert fired == [10, 20, 30, 40, 45, 50, 50]
        assert svc.has_pending()


@pytest.mark.parametrize("backend", ["heap", "gpu"])
def test_polled_service_job_fires_on_its_clock(backend):
    """A job on a polled clock that a map moves forward per record: a
    record lands in the window of the clock at its arrival, windows fire
    when the executor polls past their end, and the window still open
    at the end of input stays pending (a wall clock is not drained).
    The JAX package's queued channels see the clock later than the
    port's direct calls, so the result is held against its own
    definition, not against the JAX package."""
    _Clock.now = 0
    env = _env("torch", backend)
    env.processing_time_service = _polled("torch")

    def tick(v):
        _Clock.now += 7
        return v

    out = []
    (env.from_collection([(f"k{i % 3}", i) for i in range(600)])
        .map(tick)
        .key_by(lambda t: t[0])
        .window(tw.TumblingProcessingTimeWindows.of(500))
        .reduce(lambda a, b: (a[0], a[1] + b[1]),
                lambda k, w, vals: [(k, w.start, v[1]) for v in vals])
        .collect_into(out))
    env.execute()
    want = {}
    for i in range(600):
        start = (7 * (i + 1)) // 500 * 500
        if start + 499 <= _Clock.now:
            want[(f"k{i % 3}", start)] = want.get((f"k{i % 3}", start), 0) + i
    assert sorted(out) == sorted((k, s, v) for (k, s), v in want.items())
    assert len(out) == 3 * 8


def test_processing_time_job_restart_drops_the_failed_attempts_timers():
    """A processing-time job that fails after a checkpoint and restarts:
    the timers the failed attempt's operators registered on the shared
    clock are dropped, so the end-of-input drain fires the restored
    windows once; the output equals the uninterrupted run's."""
    from flink_tpu_torch.core.functions import MapFunction

    class Failer(MapFunction):
        done = False
        failed = False

        def notify_checkpoint_complete(self, cid):
            type(self).done = True

        def map(self, v):
            if type(self).done and not type(self).failed:
                type(self).failed = True
                raise RuntimeError("induced")
            return v

    class Gated(tsrc.FromCollectionSource):
        opened = False

        def notify_checkpoint_complete(self, cid):
            if self.offset >= 300:
                type(self).opened = True

        def emit_step(self, ctx, n):
            if not type(self).opened and self.offset >= 300:
                return True
            return super().emit_step(ctx, min(n, max(1, 300 - self.offset))
                                     if not type(self).opened else n)

    rows = [(f"k{i % 4}", i) for i in range(600)]

    def run(fail):
        env = _env("torch")
        out = []
        stream = env.add_source(Gated(rows), name="src")
        if fail:
            env.enable_checkpointing(1)
            env.set_restart_strategy("fixed_delay", restart_attempts=2,
                                     delay_ms=0)
            stream = stream.map(Failer(), name="failer")
        (stream.key_by(lambda t: t[0])
            .window(tw.TumblingProcessingTimeWindows.of(1000))
            .reduce(lambda a, b: (a[0], a[1] + b[1]))
            .collect_into(out))
        result = env.execute()
        return sorted(out), result

    Gated.opened = True
    want, _ = run(False)
    Gated.opened = False
    got, result = run(True)
    assert Failer.failed and result.restarts == 1
    assert got == want == sorted((f"k{k}", sum(range(k, 600, 4)))
                                 for k in range(4))
