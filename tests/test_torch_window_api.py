"""The rest of the event-time window API through both packages'
StreamExecutionEnvironment (the port on ``device="cpu"``), output for
output: ``reduce`` / ``fold`` / ``apply`` / ``process`` / ``sum`` /
``min`` / ``max`` on tumbling, sliding and session windows on the heap
and GPU backends (the JAX package's heap and TPU backends), every
trigger, evictor and assigner of this slice, ``count_window`` with and
without a slide, ``window_all``, ``count_window_all``, and a Python
aggregate on ``GenericWindowOperator``.  Then the reference's own
operator cases (tests/test_window_operator.py) through both packages'
test harness, and a device Sum under ``count_window`` whose v2 snapshot
crosses to the JAX package's backend and back."""

import numpy as np
import pytest

from flink_tpu.core import state as jstate
from flink_tpu.core.functions import AggregateFunction as JaxAgg
from flink_tpu.ops.device_agg import SumAggregate as JaxSum
from flink_tpu.ops.sketches import HyperLogLogAggregate as JaxHll
from flink_tpu.state.backend import KeyedStateSnapshot as JaxSnapshot
from flink_tpu.streaming import datastream as jds
from flink_tpu.streaming import harness as jh
from flink_tpu.streaming import sources as jsrc
from flink_tpu.streaming import window_operator as jwo
from flink_tpu.streaming import windowing as jw
from flink_tpu_torch.core import state as tstate
from flink_tpu_torch.core.functions import AggregateFunction as TorchAgg
from flink_tpu_torch.ops.device_agg import SumAggregate as TorchSum
from flink_tpu_torch.ops.sketches import HyperLogLogAggregate as TorchHll
from flink_tpu_torch.state import snapshot_from_chunks
from flink_tpu_torch.streaming import datastream as tds
from flink_tpu_torch.streaming import generic_agg as tga
from flink_tpu_torch.streaming import harness as th
from flink_tpu_torch.streaming import sources as tsrc
from flink_tpu_torch.streaming import window_operator as two
from flink_tpu_torch.streaming import windowing as tw
from torch_port_util import assert_hll_close

PKG = {"torch": dict(ds=tds, w=tw, src=tsrc, wo=two, h=th, st=tstate,
                     sum=TorchSum, hll=TorchHll, agg=TorchAgg),
       "jax": dict(ds=jds, w=jw, src=jsrc, wo=jwo, h=jh, st=jstate,
                   sum=JaxSum, hll=JaxHll, agg=JaxAgg)}
#: (port backend, JAX backend)
BACKENDS = [("heap", "heap"), ("gpu", "tpu")]


def _events(seed=7, n=600, n_keys=5, span=6000, late=True):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n_keys, n)
    vals = rng.integers(0, 100, n)
    ts = np.sort(rng.integers(0, span, n))
    if late:
        ts[n // 2: n // 2 + 10] -= 1500        # late stragglers
    return list(zip(keys.tolist(), vals.tolist(), np.maximum(ts, 0).tolist()))


def _env(pkg, backend, parallelism=1):
    p = PKG[pkg]
    env = (p["ds"].StreamExecutionEnvironment(device="cpu") if pkg == "torch"
           else p["ds"].StreamExecutionEnvironment())
    env.set_state_backend(backend)
    env.set_parallelism(parallelism)
    return env


def _keyed(pkg, env, events, out_of_order=100):
    p = PKG[pkg]
    return (env.from_collection(events)
            .assign_timestamps_and_watermarks(
                p["src"].BoundedOutOfOrdernessTimestampExtractor(
                    out_of_order, lambda e: e[2]))
            .key_by(lambda e: e[0]))


def _run_both(job, backends=BACKENDS[0], parallelism=1):
    """job(pkg, env, sink) builds the job; returns (port output, JAX
    output) in emission order."""
    outs = {}
    for pkg, backend in zip(("torch", "jax"), backends):
        env = _env(pkg, backend, parallelism)
        out = []
        job(pkg, env, PKG[pkg]["src"].CollectSink(out))
        env.execute("window-api")
        outs[pkg] = out
    return outs["torch"], outs["jax"]


def _assigner(w, kind):
    if kind == "tumbling":
        return w.TumblingEventTimeWindows.of(1000)
    if kind == "sliding":
        return w.SlidingEventTimeWindows.of(1500, 500)
    return w.EventTimeSessionWindows.with_gap(40)


def _process_fn(pkg):
    class Describe(PKG[pkg]["wo"].ProcessWindowFunction):
        def process(self, key, context, elements, out):
            vals = sorted(e[1] for e in elements)
            out.collect((key, context.window.start, context.window.end,
                         context.current_watermark(), vals))
    return Describe()


def _apply(ws, pkg, op):
    if op == "reduce":
        return ws.reduce(lambda a, b: (a[0], a[1] + b[1], max(a[2], b[2])),
                         window_function=lambda k, w, vals: [
                             (k, w.max_timestamp(), vals[0])])
    if op == "fold":
        return ws.fold((0, 0), lambda acc, e: (acc[0] + e[1], acc[1] + 1))
    if op == "apply":
        return ws.apply(lambda k, w, elements: [
            (k, w.max_timestamp(), sorted(e[1] for e in elements))])
    if op == "process":
        return ws.process(_process_fn(pkg))
    return getattr(ws, op)(1)           # sum / min / max of field 1


OPS = ["reduce", "fold", "apply", "process", "sum", "min", "max"]


@pytest.mark.parametrize("backends", BACKENDS, ids=["heap", "gpu"])
@pytest.mark.parametrize("kind", ["tumbling", "sliding", "session"])
@pytest.mark.parametrize("op", OPS)
def test_window_functions_equal_reference(op, kind, backends):
    events = _events()

    def job(pkg, env, sink):
        ws = _keyed(pkg, env, events).window(_assigner(PKG[pkg]["w"], kind))
        _apply(ws, pkg, op).add_sink(sink)

    got, want = _run_both(job, backends)
    assert got == want and len(got) > 20


def _trigger_case(w, name):
    """(assigner, trigger, evictor) of one trigger/evictor case."""
    tumbling = w.TumblingEventTimeWindows.of(1000)
    delta = lambda a, b: abs(b[1] - a[1])      # noqa: E731
    return {
        "count": (tumbling, w.CountTrigger(3), None),
        "purging_count": (tumbling, w.PurgingTrigger.of(w.CountTrigger(4)), None),
        "continuous": (tumbling, w.ContinuousEventTimeTrigger(250), None),
        "delta": (w.GlobalWindows.create(), w.DeltaTrigger(60, delta), None),
        "delta_tumbling": (tumbling, w.DeltaTrigger(60, delta), None),
        "count_evictor": (tumbling, None, w.CountEvictor.of(3)),
        "time_evictor": (tumbling, None, w.TimeEvictor.of(300)),
        "delta_evictor": (tumbling, None, w.DeltaEvictor.of(30, delta)),
        "global_count_evictor": (w.GlobalWindows.create(), w.CountTrigger(5),
                                 w.TimeEvictor.of(400)),
        "session_count": (w.EventTimeSessionWindows.with_gap(200),
                          w.CountTrigger(3), None),
        "session_continuous": (w.EventTimeSessionWindows.with_gap(200),
                               w.ContinuousEventTimeTrigger(100), None),
        "dynamic_session": (w.DynamicEventTimeSessionWindows.with_dynamic_gap(
            lambda e: 50 + 10 * e[0]), None, None),
        "dynamic_session_purging": (
            w.DynamicEventTimeSessionWindows.with_dynamic_gap(
                lambda e: 50 + 10 * e[0]),
            w.PurgingTrigger.of(w.CountTrigger(2)), None),
    }[name]


TRIGGER_CASES = ["count", "purging_count", "continuous", "delta",
                 "delta_tumbling", "count_evictor", "time_evictor",
                 "delta_evictor", "global_count_evictor", "session_count",
                 "session_continuous", "dynamic_session",
                 "dynamic_session_purging"]


@pytest.mark.parametrize("backends", BACKENDS, ids=["heap", "gpu"])
@pytest.mark.parametrize("op", ["reduce", "apply", "aggregate"])
@pytest.mark.parametrize("case", TRIGGER_CASES)
def test_triggers_and_evictors_equal_reference(case, op, backends):
    """Each trigger, evictor and assigner with a reduce, an apply and a
    device Sum (an aggregate under a trigger or an evictor runs on
    WindowOperator: DeviceAggregatingState on the GPU backend)."""
    events = _events(seed=8)

    def job(pkg, env, sink):
        p = PKG[pkg]
        assigner, trigger, evictor = _trigger_case(p["w"], case)
        ws = _keyed(pkg, env, events).window(assigner)
        if trigger is not None:
            ws = ws.trigger(trigger)
        if evictor is not None:
            ws = ws.evictor(evictor)
        if op == "aggregate":
            agg = p["sum"](np.float64)
            agg.extract_value = lambda e: e[1]
            out = ws.aggregate(agg, window_function=lambda k, w, vals: [
                (k, w.max_timestamp(), float(vals[0]))])
        else:
            out = _apply(ws, pkg, op)
        out.add_sink(sink)

    got, want = _run_both(job, backends)
    assert got == want and len(got) > 5


@pytest.mark.parametrize("backends", BACKENDS, ids=["heap", "gpu"])
def test_hll_under_continuous_trigger(backends):
    """HLL (precision 8) on tumbling windows firing every 250 ms of
    event time: windows and fire order equal, estimates within the HLL
    slack of tests/torch_port_util.py."""
    events = _events(seed=9, n=2000, n_keys=20)

    def job(pkg, env, sink):
        p = PKG[pkg]
        agg = p["hll"](8)
        agg.extract_value = lambda e: e[1]
        (_keyed(pkg, env, events).window(p["w"].TumblingEventTimeWindows.of(1000))
            .trigger(p["w"].ContinuousEventTimeTrigger(250))
            .aggregate(agg, window_function=lambda k, w, vals: [
                (k, w.start, float(vals[0]))])
            .add_sink(sink))

    got, want = _run_both(job, backends)
    assert [r[:2] for r in got] == [r[:2] for r in want]
    assert len(got) > 2 * len({r[:2] for r in got})   # early fires
    assert_hll_close([r[2] for r in got], [r[2] for r in want], 1 << 8)


@pytest.mark.parametrize("backends", BACKENDS, ids=["heap", "gpu"])
@pytest.mark.parametrize("slide", [None, 4])
def test_count_window_equals_reference(slide, backends):
    events = _events(seed=10, late=False)

    def job(pkg, env, sink):
        (env.from_collection(events).key_by(lambda e: e[0])
            .count_window(10, slide)
            .reduce(lambda a, b: (a[0], a[1] + b[1], b[2]))
            .add_sink(sink))

    got, want = _run_both(job, backends)
    assert got == want and len(got) > 10


@pytest.mark.parametrize("backends", BACKENDS, ids=["heap", "gpu"])
def test_count_window_device_sum(backends):
    events = _events(seed=11, late=False)

    def job(pkg, env, sink):
        agg = PKG[pkg]["sum"](np.float64)
        agg.extract_value = lambda e: e[1]
        (env.from_collection(events).key_by(lambda e: e[0]).count_window(25)
            .aggregate(agg, window_function=lambda k, w, vals: [
                (k, float(vals[0]))])
            .add_sink(sink))

    got, want = _run_both(job, backends)
    assert got == want and len(got) == sum(
        np.bincount([e[0] for e in events]) // 25)


@pytest.mark.parametrize("parallelism", [1, 3])
def test_window_all_and_count_window_all(parallelism):
    events = _events(seed=12, late=False)

    def all_job(pkg, env, sink):
        p = PKG[pkg]
        # timestamps at the source's parallelism: no record is late on
        # one channel's watermark
        (env.from_collection(events)
            .assign_timestamps_and_watermarks(
                p["src"].BoundedOutOfOrdernessTimestampExtractor(0, lambda e: e[2]))
            .set_parallelism(1)
            .window_all(p["w"].SlidingEventTimeWindows.of(1000, 500))
            .apply(lambda k, w, elements: [(k, w.start, sum(e[1] for e in elements))])
            .add_sink(sink))

    def count_all_job(pkg, env, sink):
        (env.from_collection([e[1] for e in events]).count_window_all(7)
            .reduce(lambda a, b: a + b).add_sink(sink))

    for job in (all_job, count_all_job):
        got, want = _run_both(job, parallelism=parallelism)
        if parallelism > 1:
            # the sink's subtasks collect in each executor's interleaving
            got, want = sorted(got), sorted(want)
        assert got == want and len(got) > 10
    got, _ = _run_both(count_all_job, parallelism=parallelism)
    assert got == [sum(e[1] for e in events[i:i + 7])
                   for i in range(0, len(events) - 6, 7)]


class _MeanMax:
    def create_accumulator(self):
        return (0.0, 0.0, -np.inf)

    def add(self, v, acc):
        return (acc[0] + v[1], acc[1] + 1.0, np.maximum(acc[2], v[1]))

    def get_result(self, acc):
        return (acc[0] / acc[1], acc[2])

    def merge(self, a, b):
        return (a[0] + b[0], a[1] + b[1], np.maximum(a[2], b[2]))


class _Branchy(_MeanMax):
    def add(self, v, acc):
        if v[1] > 50:
            return (acc[0] + 2 * v[1], acc[1] + 1.0, max(acc[2], v[1]))
        return (acc[0] + v[1], acc[1] + 1.0, max(acc[2], v[1]))


AGGS = {pkg: {"MeanMax": type("MeanMax", (_MeanMax, PKG[pkg]["agg"]), {}),
              "Branchy": type("Branchy", (_Branchy, PKG[pkg]["agg"]), {})}
        for pkg in PKG}


def _operator_kinds(env):
    return {type(node.operator_factory()).__name__
            for node in env.get_stream_graph().nodes.values()}


@pytest.mark.parametrize("agg", ["MeanMax", "Branchy"])
@pytest.mark.parametrize("kind", ["tumbling", "sliding", "session"])
def test_python_aggregate_runs_on_the_generic_tier(kind, agg):
    """A Python AggregateFunction that is not a device aggregate (the
    shape that raised before this slice) runs on GenericWindowOperator,
    equal to the JAX package's job and to the port's WindowOperator
    (``disable_device_operator``)."""
    events = _events(seed=13, n=1500, n_keys=30, late=False)

    def job(pkg, env, sink, generic=True):
        ws = _keyed(pkg, env, events, out_of_order=0).window(
            _assigner(PKG[pkg]["w"], kind))
        if not generic:
            ws = ws.disable_device_operator()
        (ws.aggregate(AGGS[pkg][agg](), window_function=lambda k, w, vals: [
            (k, w.start, w.end, tuple(float(x) for x in vals[0]))])
            .add_sink(sink))

    got, want = _run_both(job)
    assert got == want and len(got) > 30
    env = _env("torch", "heap")
    out = []
    job("torch", env, tsrc.CollectSink(out), generic=False)
    env.execute()
    assert sorted(out) == sorted(got)
    assert {"GenericWindowOperator", "WindowOperator"} & _operator_kinds(env) \
        == {"WindowOperator"}
    env = _env("torch", "heap")
    job("torch", env, tsrc.CollectSink([]))
    assert {"GenericWindowOperator", "WindowOperator"} & _operator_kinds(env) \
        == {"GenericWindowOperator"}


def test_trigger_and_evictor_take_the_stream_off_the_batch_tiers():
    for method, arg in (("trigger", tw.CountTrigger(2)),
                        ("evictor", tw.CountEvictor.of(2))):
        for agg in (AGGS["torch"]["MeanMax"](), TorchSum(np.float64)):
            env = _env("torch", "heap")
            ws = _keyed("torch", env, [(1, 2, 3)]).window(
                tw.TumblingEventTimeWindows.of(1000))
            getattr(ws, method)(arg).aggregate(agg).add_sink(tsrc.CollectSink([]))
            kinds = _operator_kinds(env)
            want = ("EvictingWindowOperator" if method == "evictor"
                    else "WindowOperator")
            assert want in kinds
            assert not kinds & {"GenericWindowOperator", "DeviceWindowOperator"}
    assert not tga.is_generic_eligible(tw.TumblingEventTimeWindows.of(10),
                                       AGGS["torch"]["MeanMax"](), None, None,
                                       5, None, None)


#: (assigner, trigger, evictor, lateness, late tag, window function)
#: shapes, built for either package; the gates of both batch tiers
GATE_SHAPES = {
    "tumbling": lambda w: (w.TumblingEventTimeWindows.of(1000), None, None,
                           0, None, None),
    "tumbling_offset": lambda w: (w.TumblingEventTimeWindows.of(1000, 7),
                                  None, None, 0, None, None),
    "sliding": lambda w: (w.SlidingEventTimeWindows.of(3000, 1000), None,
                          None, 0, None, len),
    "sliding_ragged": lambda w: (w.SlidingEventTimeWindows.of(3000, 700),
                                 None, None, 0, None, None),
    "session": lambda w: (w.EventTimeSessionWindows.with_gap(500), None,
                          None, 0, None, None),
    "dynamic_session": lambda w: (
        w.DynamicEventTimeSessionWindows.with_dynamic_gap(lambda e: 5),
        None, None, 0, None, None),
    "global": lambda w: (w.GlobalWindows.create(), None, None, 0, None, None),
    "trigger": lambda w: (w.TumblingEventTimeWindows.of(1000),
                          w.CountTrigger(2), None, 0, None, None),
    "evictor": lambda w: (w.TumblingEventTimeWindows.of(1000), None,
                          w.CountEvictor.of(2), 0, None, None),
    "lateness": lambda w: (w.TumblingEventTimeWindows.of(1000), None, None,
                           5, None, None),
    "late_tag": lambda w: (w.TumblingEventTimeWindows.of(1000), None, None,
                           0, "late", None),
    "window_fn_not_callable": lambda w: (w.TumblingEventTimeWindows.of(1000),
                                         None, None, 0, None, 3),
}


@pytest.mark.parametrize("agg", ["MeanMax", "Sum"])
@pytest.mark.parametrize("shape", sorted(GATE_SHAPES))
def test_batch_tier_gates_equal_the_reference(shape, agg):
    """The device gate and the generic gate take the window shapes the
    reference's two gates take, for a device and a Python aggregate."""
    from flink_tpu.streaming.device_window_operator import \
        is_device_eligible as jax_device
    from flink_tpu.streaming.generic_agg import \
        is_generic_eligible as jax_generic
    from flink_tpu_torch.streaming.device_window_operator import \
        is_device_eligible as torch_device
    aggs = {pkg: (AGGS[pkg]["MeanMax"]() if agg == "MeanMax"
                  else PKG[pkg]["sum"](np.float64)) for pkg in PKG}
    t_args = GATE_SHAPES[shape](tw)
    j_args = GATE_SHAPES[shape](jw)
    gate = lambda f, a, args: f(args[0], a, *args[1:])  # noqa: E731
    assert (gate(torch_device, aggs["torch"], t_args)
            == gate(jax_device, aggs["jax"], j_args))
    assert (gate(tga.is_generic_eligible, aggs["torch"], t_args)
            == gate(jax_generic, aggs["jax"], j_args))


def test_time_window_with_slide_and_days():
    assert tw.Time.days(2).milliseconds == jw.Time.days(2).milliseconds
    assert tw.ContinuousEventTimeTrigger.of(250).interval == 250
    events = _events(seed=14, late=False)

    def job(pkg, env, sink):
        (_keyed(pkg, env, events, out_of_order=0)
            .time_window(PKG[pkg]["w"].Time.seconds(2), PKG[pkg]["w"].Time.seconds(1))
            .sum(1).add_sink(sink))

    got, want = _run_both(job)
    assert got == want and len(got) > 10


def test_processing_time_assigners_still_raise():
    """Processing-time assigners no longer raise: a tumbling one fires
    on the harness clock in both packages alike (the full processing-time
    cases are in test_torch_processing_time.py)."""
    outs = {}
    for pkg in ("torch", "jax"):
        w = PKG[pkg]["w"]
        h = _harness(pkg, _kv_sum_op(
            pkg, w.TumblingProcessingTimeWindows.of(w.Time.seconds(1))), "heap")
        h.set_processing_time(10)
        h.process_element(("p", 1), None)
        h.process_element(("p", 2), None)
        h.set_processing_time(999)
        outs[pkg] = [(r.value, r.timestamp) for r in h.get_output()]
    assert outs["torch"] == outs["jax"] == [(("p", 3.0, 0, 1000), 999)]
    two.WindowOperator(tw.GlobalWindows.create(), tstate.ListStateDescriptor("w"))


# ---------------------------------------------------------------------
# the reference's operator cases, through both packages' harness
# ---------------------------------------------------------------------

def _kv_sum_op(pkg, assigner, **kw):
    p = PKG[pkg]
    agg = p["sum"](np.float32)
    agg.extract_value = lambda v: v[1] if isinstance(v, tuple) else v

    def fn(key, window, elements):
        for v in elements:
            if hasattr(window, "start"):
                yield (key, float(v), window.start, window.end)
            else:
                yield (key, float(v))

    return p["wo"].WindowOperator(
        assigner, p["st"].AggregatingStateDescriptor("win-sum", agg),
        window_function=fn, **kw)


def _harness(pkg, op, backend):
    h = PKG[pkg]["h"].OneInputStreamOperatorTestHarness(
        op, key_selector=lambda x: x[0], state_backend=backend,
        **({"device": "cpu"} if pkg == "torch" else {}))
    h.open()
    return h


def _operator_cases(pkg):
    p = PKG[pkg]
    w, wo, st = p["w"], p["wo"], p["st"]

    def reduce_fn(key, window, elements):
        for v in elements:
            yield (key, v)

    def list_fn(key, window, elements):
        yield (key, sorted(v[1] for v in elements))

    return {
        "global_purging_count": (
            lambda: _kv_sum_op(pkg, w.GlobalWindows.create(),
                               trigger=w.PurgingTrigger.of(w.CountTrigger(2))),
            [(("g", 1), 0), (("g", 2), 1), (("g", 10), 2), (("g", 20), 3)],
            None, [("g", 3.0), ("g", 30.0)]),
        "count_without_purge": (
            lambda: _kv_sum_op(pkg, w.GlobalWindows.create(),
                               trigger=w.CountTrigger(2)),
            [(("g", v), 0) for v in (1, 2, 3, 4)], None,
            [("g", 3.0), ("g", 10.0)]),
        "reduce_state": (
            lambda: wo.WindowOperator(
                w.TumblingEventTimeWindows.of(w.Time.seconds(1)),
                st.ReducingStateDescriptor("win-red",
                                           lambda a, b: (a[0], a[1] + b[1])),
                window_function=reduce_fn),
            [(("r", 1), 0), (("r", 5), 500)], 999, [("r", ("r", 6))]),
        "apply_list": (
            lambda: wo.WindowOperator(
                w.TumblingEventTimeWindows.of(w.Time.seconds(1)),
                st.ListStateDescriptor("win-list"), window_function=list_fn,
                single_value_contents=False),
            [(("l", 3), 0), (("l", 1), 100), (("l", 2), 200)], 999,
            [("l", [1, 2, 3])]),
        "count_evictor": (
            lambda: wo.EvictingWindowOperator(
                w.TumblingEventTimeWindows.of(w.Time.seconds(1)),
                window_function=list_fn, evictor=w.CountEvictor.of(2)),
            [(("e", v), i) for i, v in enumerate([10, 20, 30, 40])], 999,
            [("e", [30, 40])]),
    }


@pytest.mark.parametrize("backends", BACKENDS, ids=["heap", "gpu"])
@pytest.mark.parametrize("case", ["global_purging_count", "count_without_purge",
                                  "reduce_state", "apply_list", "count_evictor"])
def test_reference_operator_cases(case, backends):
    outs = {}
    for pkg, backend in zip(("torch", "jax"), backends):
        build, rows, wm, want = _operator_cases(pkg)[case]
        h = _harness(pkg, build(), backend)
        for v, t in rows:
            h.process_element(v, t)
        if wm is not None:
            h.process_watermark(wm)
        outs[pkg] = [(r.value, r.timestamp) for r in h.get_output()]
        assert [v[:2] if isinstance(v, tuple) and len(v) == 4 else v
                for v, _ in outs[pkg]] == want
    assert outs["torch"] == outs["jax"]


def _cross(snap, to_pkg):
    keyed = snap["keyed"]
    blobs, meta = dict(keyed.blobs()), keyed.meta
    keyed = (snapshot_from_chunks(blobs, meta) if to_pkg == "torch"
             else JaxSnapshot(blobs, meta))
    return {"keyed": keyed, "timers": snap["timers"]}


@pytest.mark.parametrize("direction", ["torch_to_jax", "jax_to_torch"])
def test_count_window_device_sum_snapshot_crosses_packages(direction):
    """A device Sum under GlobalWindows + CountTrigger on the GPU backend
    keeps its slots under the ("__global__",) namespace; its v2
    snapshot restores into the JAX package's TPU backend, and the JAX
    one's into the port's, and both go on counting to the same fires."""
    src, dst = direction.split("_to_")
    backend = {"torch": "gpu", "jax": "tpu"}
    rng = np.random.default_rng(15)
    rows = [((int(k), int(v)), i) for i, (k, v) in enumerate(
        zip(rng.integers(0, 6, 300), rng.integers(0, 50, 300)))]

    def op(pkg):
        w = PKG[pkg]["w"]
        return _kv_sum_op(pkg, w.GlobalWindows.create(),
                          trigger=w.PurgingTrigger.of(w.CountTrigger(7)))

    whole = _harness(src, op(src), backend[src])
    for v, t in rows:
        whole.process_element(v, t)
    want = [(r.value, r.timestamp) for r in whole.get_output()]

    first = _harness(src, op(src), backend[src])
    for v, t in rows[:150]:
        first.process_element(v, t)
    head = [(r.value, r.timestamp) for r in first.get_output()]
    snap = first.snapshot()
    second = _harness(dst, op(dst), backend[dst])
    second.initialize_state(_cross(snap, dst))
    if dst == "torch":
        dstate = second.operator.window_state
        assert {ns for _, ns in dstate.slot_index} == {("__global__",)}
    for v, t in rows[150:]:
        second.process_element(v, t)
    got = head + [(r.value, r.timestamp) for r in second.get_output()]
    assert got == want and len(want) > 30
    # and back: the restored side's snapshot into the first package
    back = _harness(src, op(src), backend[src])
    back.initialize_state(_cross(second.snapshot(), src))
    back.process_element((0, 1), 10 ** 6)
    assert back.operator.window_state is not None
