"""The metric registry (``flink_tpu_torch/runtime/metrics.py``) and the
metrics the port's executor, operators and backends publish, against
the reference's on the same jobs.

The metric types run the same script on both modules and compare what
comes out.  For jobs, the same events go through both packages: the
registry's metric names (the reference's scopes,
``<job>.<vid>_<vertex>.<subtask>.<...>``) and the values of
``numRecordsIn`` / ``numRecordsOut`` / ``numLateRecordsDropped`` must
agree, as must ``checkpoint_stats_payload`` on one scripted sequence
of triggers, acks, declines and timeouts.

Stated differences: the reference registers ``lint.*`` gauges from its
pre-flight analysis, which the port has not ported; and a latency
marker's age depends on each executor's scheduling (threads and
channel queues in the reference, direct calls in the port), so the
latency histograms are compared by name, not by value."""

import io
import json

import numpy as np
import pytest

from flink_tpu.runtime import metrics as jm
from flink_tpu_torch.runtime import metrics as tm
from test_torch_device_stats import CASES, JAX, PORT, run_job

MODULES = pytest.mark.parametrize("m", [jm, tm], ids=["jax", "port"])


def _ported(names):
    """The job's metric names (the process-wide groups hold whatever the
    process ran before), without the reference's lint surface."""
    return sorted(n for n in names
                  if n.startswith("job.") and ".lint." not in n)


# ---- the metric types ------------------------------------------------------

def _types_script(m, clock):
    reg = m.MetricRegistry()
    g = reg.job_group("job").add_group("v").add_group("0")
    c = g.counter("numRecordsIn")
    c.inc(5)
    c.dec()
    h = g.histogram("lat", window=4)
    for v in (5.0, 1.0, 3.0, 9.0, 7.0):
        h.update(v)
    meter = m.Meter(clock=lambda: clock[0], window_s=10.0)
    for _ in range(5):
        clock[0] += 1.0
        meter.mark_event(2)
    g.gauge("g", lambda: 42, description="the answer")
    g.gauge("broken", lambda: 1 / 0)
    prom = m.PrometheusTextReporter()
    reg.add_reporter(prom)
    buf = io.StringIO()
    reg.add_reporter(m.JsonLinesReporter(stream=buf))
    env = reg.report()
    return (reg.dump(), meter.get_count(), round(meter.get_rate(), 6),
            prom.render(), sorted(json.loads(buf.getvalue())["metrics"]),
            sorted(env), dict(reg.descriptions))


def test_metric_types_dump_and_reporters_equal_reference():
    got = _types_script(tm, [0.0])
    want = _types_script(jm, [0.0])
    assert got == want
    dump = got[0]
    assert dump["job.v.0.numRecordsIn"] == 4
    assert dump["job.v.0.lat"]["count"] == 5 and dump["job.v.0.broken"] is None


@MODULES
def test_histogram_statistics_and_empty_meter(m):
    s = m.HistogramStatistics([3.0, 1.0, 2.0])
    assert (s.min, s.max, s.mean, s.quantile(0.5)) == (1.0, 3.0, 2.0, 2.0)
    assert m.HistogramStatistics([]).count == 0
    clock = [100.0]
    meter = m.Meter(clock=lambda: clock[0], window_s=1.0)
    meter.mark_event()
    clock[0] += 5.0
    assert meter.get_rate() == 0.0


@MODULES
def test_latency_stats_caches_one_histogram_per_path(m):
    from types import SimpleNamespace
    reg = m.MetricRegistry()
    ls = m.LatencyStats(reg.job_group("job"))
    marker = SimpleNamespace(operator_id="src", subtask_index=1)
    for v in (1.0, 2.0, 4.0):
        ls.record(marker, "sink", v)
    assert len(ls._histograms) == 1
    assert reg.dump()["job.latency.source_src_1.operator_sink"]["count"] == 3


def test_gauge_surfaces_have_the_reference_names():
    from types import SimpleNamespace
    coord = SimpleNamespace(completed_count=0, latest_completed_id=None,
                            stats={}, aborted_count=0, timeout_aborts=0,
                            consecutive_failures=0)
    names = []
    for m in (jm, tm):
        reg = m.MetricRegistry()
        m.register_state_gauges(reg)
        m.register_state_introspection_gauges(reg)
        m.register_checkpoint_gauges(reg, "job", coord)
        m.register_faulttolerance_gauges(reg, "job", coord)
        names.append(sorted(reg.dump()))
    assert names[1] == names[0]


# ---- jobs ------------------------------------------------------------------

def late_events(seed=7, n=6000, n_keys=150, span=6000):
    """Sorted events with 20 stragglers 2.5 s behind (late at lateness 0,
    timestamps assigned at the source's parallelism)."""
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.integers(0, span, n))
    ts[n // 2: n // 2 + 20] -= 2500
    return list(zip(rng.integers(0, n_keys, n).tolist(),
                    rng.integers(0, 1000, n).tolist(), ts.tolist()))


@pytest.fixture(scope="module")
def ev():
    return late_events()


IO = ("numRecordsIn", "numRecordsOut", "numLateRecordsDropped")


@pytest.mark.parametrize("case", sorted(CASES))
def test_job_metric_names_and_io_counts_equal_reference(case, ev):
    ref, port = run_job(JAX, case, ev), run_job(PORT, case, ev)
    assert _ported(port["dump"]) == _ported(ref["dump"])
    io_ref = {k: v for k, v in ref["dump"].items() if k.endswith(IO)}
    io_port = {k: v for k, v in port["dump"].items() if k.endswith(IO)}
    assert io_port == io_ref
    late = [v for k, v in io_port.items() if k.endswith(IO[2])]
    assert late and sum(late) > 0
    assert sum(v for k, v in io_port.items() if k.endswith("window_aggregate"
                                                           " -> sink.0."
                                                           "numRecordsIn")) \
        == len(ev)


def _generic_job(pkg, ev):
    ds, src, win, dst, tr, da, sk = pkg
    base = __import__(ds.__name__.split(".")[0] + ".core.functions",
                      fromlist=["x"]).AggregateFunction

    class MeanOf(base):
        def create_accumulator(self):
            return (0.0, 0.0)

        def add(self, v, acc):
            return (acc[0] + v[1], acc[1] + 1.0)

        def get_result(self, acc):
            return acc[0] / acc[1]

        def merge(self, a, b):
            return (a[0] + b[0], a[1] + b[1])

    out = []
    env = ds.StreamExecutionEnvironment.get_execution_environment(
        **({"device": "cpu"} if pkg is PORT else {}))
    (env.from_collection(ev)
        .assign_timestamps_and_watermarks(
            src.BoundedOutOfOrdernessTimestampExtractor(50, lambda e: e[2]))
        .key_by(lambda e: e[0]).window(win.TumblingEventTimeWindows.of(1000))
        .aggregate(MeanOf()).add_sink(src.CollectSink(out)))
    env.execute("job")
    return out, env.get_metric_registry().dump()


def test_generic_tier_lift_gauges_and_late_counter_equal_reference(ev):
    out_r, ref = _generic_job(JAX, ev)
    out_p, port = _generic_job(PORT, ev)
    assert len(out_p) == len(out_r) > 0
    assert _ported(port) == _ported(ref)
    for key in ref:
        if key.endswith(("lift.decision", "lift.decided_by",
                         "lift.fallback_reason") + IO):
            assert port[key] == ref[key], key
    assert any(k.endswith("lift.decision") and v != "undecided"
               for k, v in port.items())


def _marker_job(pkg, ev):
    ds, src, win, dst, tr, da, sk = pkg
    out = []
    env = ds.StreamExecutionEnvironment.get_execution_environment(
        **({"device": "cpu"} if pkg is PORT else {}))
    env.set_latency_tracking_interval(0)
    agg = da.SumAggregate()
    agg.extract_value = lambda e: e[1]
    (env.from_collection(ev)
        .assign_timestamps_and_watermarks(
            src.BoundedOutOfOrdernessTimestampExtractor(50, lambda e: e[2]))
        .key_by(lambda e: e[0]).window(win.TumblingEventTimeWindows.of(1000))
        .aggregate(agg).add_sink(src.CollectSink(out)))
    env.execute("job")
    return {k: v for k, v in env.get_metric_registry().dump().items()
            if ".latency." in k}


def test_latency_markers_reach_the_same_histograms(ev):
    ref, port = _marker_job(JAX, ev), _marker_job(PORT, ev)
    assert sorted(port) == sorted(ref)
    assert port and all(v["count"] > 0 and v["min"] >= 0
                        for v in port.values())


# ---- checkpoint stats ------------------------------------------------------

def _checkpointed_job(pkg, tmp_path):
    ds, src, win, dst, tr, da, sk = pkg
    top = ds.__name__.split(".")[0]
    fns = __import__(top + ".core.functions", fromlist=["x"])
    ck = __import__(top + ".runtime.checkpoints", fromlist=["x"])

    class Sum(fns.AggregateFunction):
        def create_accumulator(self):
            return 0

        def add(self, v, acc):
            return acc + v[1]

        def get_result(self, acc):
            return acc

        def merge(self, a, b):
            return a + b

    class Gated(src.FromCollectionSource):
        """Emits 100 records a step; holds after every 200 until a
        checkpoint completes, so each run takes the same checkpoints."""
        open_until = 200

        def notify_checkpoint_complete(self, cid):
            type(self).open_until = self.offset + 200

        def emit_step(self, ctx, n):
            if self.offset >= type(self).open_until:
                return True
            return super().emit_step(ctx, min(n, 100))

    Gated.open_until = 200
    items = [((f"k{i % 5}", 1), 10 * i) for i in range(1000)]
    env = ds.StreamExecutionEnvironment.get_execution_environment(
        **({"device": "cpu"} if pkg is PORT else {}))
    env.enable_checkpointing(1)
    env.set_checkpoint_storage("filesystem", directory=str(tmp_path))
    sink = src.CollectSink()
    (env.add_source(Gated(items, timestamped=True), name="src")
        .key_by(lambda e: e[0]).window(win.TumblingEventTimeWindows.of(1000))
        .aggregate(Sum()).add_sink(sink))
    client = env.execute_async("job")
    client.wait(120)
    coord = client.executor_state["coordinator"]
    return ck.checkpoint_stats_payload(coord), env.get_metric_registry().dump()


def _scripted_coordinator(ck):
    """The same trigger / ack / decline / timeout sequence on each
    package's coordinator, on one fake clock (ms)."""
    clock = [0.0]
    tasks = {(1, 0), (2, 0), (2, 1)}
    coord = ck.CheckpointCoordinator(
        interval_ms=10, mode="exactly_once",
        storage=ck.make_checkpoint_storage({"storage": "memory", "retain": 2}),
        expected_tasks=tasks, trigger_sources=lambda cid, ts, opts: True,
        notify_complete=lambda cid: None, clock=lambda: clock[0],
        checkpoint_timeout_ms=50, tolerable_checkpoint_failures=5)
    for step in range(6):
        clock[0] += 11.0
        cid = coord.maybe_trigger()
        if cid is None:
            continue
        for i, task in enumerate(sorted(tasks)):
            clock[0] += 1.0 + i
            if step == 2 and task == (2, 1):
                continue             # lost: times out below
            if step == 4:
                coord.decline(cid)
                break
            coord.acknowledge(task, cid, {"state": b"x" * (10 * (i + 1))})
        if step == 2:
            clock[0] += 60.0
            coord.maybe_trigger()
    coord.drain()
    return ck.checkpoint_stats_payload(coord, completed_base=3)


def test_checkpoint_stats_payload_equals_reference_on_one_script():
    from flink_tpu.runtime import checkpoints as jck
    from flink_tpu_torch.runtime import checkpoints as tck
    ref, port = _scripted_coordinator(jck), _scripted_coordinator(tck)
    assert port == ref
    assert port["counts"]["aborted"] >= 1 and port["counts"]["completed"] > 3


def test_checkpoint_stats_payload_after_a_checkpointed_job(tmp_path):
    """The same checkpointed job in both packages.  How many checkpoints
    a job takes follows each executor's timing (a 1 ms interval against
    a loop turn), so the job is held to the payload's shape and its
    invariants; the scripted test above holds the fields to the
    reference's exactly."""
    ref, ref_dump = _checkpointed_job(JAX, tmp_path / "jax")
    port, port_dump = _checkpointed_job(PORT, tmp_path / "port")
    for p in (ref, port):
        hist = p["history"]
        assert p["counts"]["completed"] >= 4 and p["counts"]["failed"] == 0
        assert all(h["status"] == "completed" for h in hist)
        assert p["latest_completed_id"] == hist[-1]["id"]
        assert p["summary"]["count"] == len(hist)
        assert all(sorted(h["ack_latency_ms"]) == sorted(hist[0]["ack_latency_ms"])
                   for h in hist)
    assert set(port) == set(ref) and set(port["counts"]) == set(ref["counts"])
    assert set(port["summary"]) == set(ref["summary"])
    assert set(port["history"][0]) == set(ref["history"][0])
    assert sorted(port["history"][0]["ack_latency_ms"]) == \
        sorted(ref["history"][0]["ack_latency_ms"])
    cp = sorted(k for k in port_dump if ".checkpointing." in k
                or ".faulttolerance." in k)
    assert cp == sorted(k for k in ref_dump if ".checkpointing." in k
                        or ".faulttolerance." in k)
    assert port_dump["job.checkpointing.numberOfCompletedCheckpoints"] == \
        port["counts"]["completed"]


def test_state_plane_counters_equal_reference(ev):
    """``state.*``: the keyed backends' batch/fallback split and flushes
    after the same keyed-backend job (the gpu backend against the
    reference's tpu backend)."""
    from flink_tpu.state.stats import STATE_STATS as JS
    from flink_tpu_torch.state.stats import STATE_STATS as TS
    for s in (JS, TS):
        s.reset()
    ref, port = run_job(JAX, "gpu_backend", ev), run_job(PORT, "gpu_backend", ev)
    keys = [k for k in ref["dump"] if k.startswith("state.")
            and not k.startswith("state.device.")
            and k.split(".")[-1] not in ("flushSizeMean", "flushSizeMax")]
    assert keys
    assert {k: port["dump"][k] for k in keys} == {k: ref["dump"][k]
                                                   for k in keys}
    assert port["dump"]["state.flushBatches"] > 0


# ---- a finished job lets go of its state -----------------------------------

@pytest.mark.parametrize("case", ["scatter_tumbling", "scatter_sliding",
                                  "scatter_session", "gpu_backend"])
def test_finished_job_keeps_no_engine_or_device_state(case, ev, monkeypatch):
    """After ``env.execute()`` returns, the environment (and the registry
    it serves) holds no engine and no device state of the job: the
    job's gauges keep the values they read at its end, which a dump
    still shows."""
    import gc
    import weakref

    from flink_tpu_torch.state import stats
    from test_torch_device_stats import tds, tsrc, twin, tda

    seen = []

    class _Seen(weakref.WeakSet):
        def add(self, item):
            seen.append(weakref.ref(item))
            super().add(item)

    monkeypatch.setattr(stats, "_LIVE_ENGINES", _Seen())
    monkeypatch.setattr(stats, "_LIVE_DEVICE_STATES", _Seen())
    make_agg, make_win, backend = CASES[case]
    agg = make_agg(tda, None)
    agg.extract_value = lambda e: e[1]
    out = []
    env = tds.StreamExecutionEnvironment.get_execution_environment(
        device="cpu")
    if backend is not None:
        env.set_state_backend("gpu")
    w = (env.from_collection(ev)
         .assign_timestamps_and_watermarks(
             tsrc.BoundedOutOfOrdernessTimestampExtractor(50, lambda e: e[2]))
         .key_by(lambda e: e[0]).window(make_win(twin)))
    if backend is not None:
        w = w.disable_device_operator()
    w.aggregate(agg).add_sink(tsrc.CollectSink(out))
    env.execute("job")
    gc.collect()
    assert out and seen
    assert [r for r in seen if r() is not None] == []
    dump = env.get_metric_registry().dump()
    assert sum(v for k, v in dump.items()
               if k.endswith("window_aggregate -> sink.0.numRecordsIn")) \
        == len(ev)


@pytest.mark.parametrize("kind", ["tumbling", "sliding", "session"])
def test_engine_is_freed_without_the_cycle_collector(kind):
    """The engines' traced calls bind the engine at each access, so an
    engine that has run goes as soon as its last reference does."""
    import gc
    import weakref

    from flink_tpu_torch.ops.device_agg import MaxAggregate
    from flink_tpu_torch.streaming.vectorized import (
        VectorizedSlidingWindows, VectorizedTumblingWindows)
    from flink_tpu_torch.streaming.vectorized_sessions import \
        VectorizedSessionWindows

    make = {"tumbling": lambda: VectorizedTumblingWindows(
                MaxAggregate(), 1000, initial_capacity=64, device="cpu"),
            "sliding": lambda: VectorizedSlidingWindows(
                MaxAggregate(), 2000, 1000, initial_capacity=64,
                device="cpu"),
            "session": lambda: VectorizedSessionWindows(
                MaxAggregate(), 30, initial_capacity=64, device="cpu")}[kind]
    rng = np.random.default_rng(3)
    gc.collect()
    gc.disable()
    try:
        eng = make()
        eng.process_batch(rng.integers(0, 50, 500),
                          np.sort(rng.integers(0, 3000, 500)),
                          rng.random(500).astype(np.float32))
        eng.advance_watermark(5000)
        assert eng.emitted
        ref = weakref.ref(eng)
        del eng
        assert ref() is None
    finally:
        gc.enable()
