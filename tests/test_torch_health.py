"""The health plane (``flink_tpu_torch/runtime/{timeseries,backpressure,profiler}.py``)
against the reference's: one recorded metrics journal through both
``HealthEvaluator``s, one registry dump through both bottleneck
locators, the same time-attribution observations, and the same folded
stacks through both profilers' exports and flame graphs.

Stated difference: the port's executor runs every subtask on one
cooperative thread and routes records by direct calls, so a router
never lacks capacity.  ``router_blocked`` is False, the backpressure
gauges read 0 ("ok") and a subtask's backpressured time stays 0 until
threaded channels exist."""

from types import SimpleNamespace

import numpy as np
import pytest

from flink_tpu.runtime import backpressure as jbp
from flink_tpu.runtime import profiler as jpr
from flink_tpu.runtime import timeseries as jts
from flink_tpu.runtime.metrics import MetricRegistry as JReg
from flink_tpu_torch.runtime import backpressure as tbp
from flink_tpu_torch.runtime import profiler as tpr
from flink_tpu_torch.runtime import timeseries as tts
from flink_tpu_torch.runtime.metrics import MetricRegistry as TReg

PAIRS = [(jts, jbp, jpr, JReg), (tts, tbp, tpr, TReg)]


def _recorded_dumps(seed=3, n=40):
    """A recorded run: per sample a registry dump with a sustained
    backpressure episode, a growing watermark lag, a transfer tax and a
    key-skew episode."""
    rng = np.random.default_rng(seed)
    dumps = []
    fired = reads = 0
    for i in range(n):
        fired += int(rng.integers(1, 5))
        reads += int(rng.integers(20, 40)) if 10 <= i < 25 else 1
        dumps.append({
            "job.1_src.backpressure.ratio": 0.9 if 5 <= i < 15 else 0.05,
            "job.2_win.backpressure.ratio": 0.0,
            "job.2_win.0.op-2.watermarkLag": float(i * 10 if i < 20 else 5),
            "job.2_win.0.busyTimeMsPerSecond": 900.0 if i > 3 else 10.0,
            "job.1_src.0.busyTimeMsPerSecond": 200.0,
            "device.fireReads": float(reads),
            "device.windowsFired": float(fired),
            "state.keyGroupSkew": 5.0 if 30 <= i < 36 else 1.2,
            "state.hotKeyGroup": 17.0,
            "job.2_win.0.lat": {"count": i, "p99": float(i)},
            "job.name": "not a number",
        })
    return dumps


def _evaluate(ts, bp, dumps):
    journal = ts.MetricsJournal(None, interval_ms=10, history_size=64,
                                clock=lambda: 0.0, wall_clock=lambda: 0.0)
    upstreams = {1: [], 2: [1]}
    current = {}
    ev = ts.HealthEvaluator(
        journal, bottleneck_supplier=lambda: bp.locate_bottleneck(
            upstreams, bp.read_vertex_stats(current, "job")),
        wall_clock=lambda: 0.0)
    for i, d in enumerate(dumps):
        current.clear()
        current.update(d)
        journal._record(float(i), float(i), d)
        ev.evaluate()
    return journal, ev


def test_health_rules_fire_the_reference_alerts_on_one_journal():
    dumps = _recorded_dumps()
    (jj, je), (tj, te) = [_evaluate(ts, bp, dumps) for ts, bp, _, _ in PAIRS]
    assert te.snapshot_alerts() == je.snapshot_alerts()
    rules = {a["rule"] for a in te.snapshot_alerts()}
    assert {"backpressure-sustained", "watermark-lag-growing",
            "transfer-tax", "key-skew-sustained", "bottleneck-stable"} <= rules
    assert te.active_rules == je.active_rules
    assert te.last_bottleneck == je.last_bottleneck
    assert te.last_bottleneck["vertex_id"] == 2
    assert tj.query("job.*", buckets=4) == jj.query("job.*", buckets=4)
    assert tj.keys() == jj.keys()
    assert tts.MetricsJournal.from_payload(tj.to_payload()).to_payload() == \
        tj.to_payload()


def test_checkpoint_budget_rule_equals_reference():
    stats = {i: SimpleNamespace(duration_ms=float(d))
             for i, d in enumerate([10, 20, 500, 30])}
    coord = SimpleNamespace(stats=stats)
    alerts = []
    for ts, _, _, _ in PAIRS:
        j = ts.MetricsJournal(None, interval_ms=1)
        ev = ts.HealthEvaluator(j, checkpoint_p95_budget_ms=100.0,
                                coordinator_supplier=lambda: coord,
                                wall_clock=lambda: 0.0)
        ev.evaluate()
        ev.evaluate()
        alerts.append(ev.snapshot_alerts())
    assert alerts[1] == alerts[0] and len(alerts[1]) == 1


def test_rollup_and_disabled_journal():
    vals = [5.0, 1.0, 3.0]
    assert tts.rollup(vals) == jts.rollup(vals)
    assert tts.rollup([]) == {"count": 0}
    j = tts.MetricsJournal(TReg())
    assert not j.enabled and j.maybe_sample() is False


def test_bottleneck_from_one_dump_equals_reference():
    dump = _recorded_dumps()[10]
    ups = {1: [], 2: [1], 3: [2]}
    got = [bp.locate_bottleneck(ups, bp.read_vertex_stats(dump, "job"))
           for _, bp, _, _ in PAIRS]
    stats = [bp.read_vertex_stats(dump, "job") for _, bp, _, _ in PAIRS]
    assert stats[1] == stats[0] and got[1] == got[0]
    assert got[1]["vertex_id"] == 2
    assert tbp.read_backpressure_gauges(dump, "job") == \
        jbp.read_backpressure_gauges(dump, "job")


def test_derive_upstreams_equals_reference_on_the_same_job_graph():
    from flink_tpu.streaming import datastream as jds
    from flink_tpu_torch.streaming import datastream as tds
    graphs = []
    for ds in (jds, tds):
        env = ds.StreamExecutionEnvironment.get_execution_environment(
            **({"device": "cpu"} if ds is tds else {}))
        env.set_parallelism(2)
        (env.from_collection(list(range(10))).map(lambda x: x + 1)
            .key_by(lambda x: x % 2).window_all(
                __import__(ds.__name__.rsplit(".", 1)[0] + ".windowing",
                           fromlist=["x"]).GlobalWindows.create()))
        graphs.append(env.get_job_graph())
    ref = jbp.derive_upstreams(graphs[0])
    port = tbp.derive_upstreams(graphs[1])
    assert port == ref and any(port.values())


@pytest.mark.parametrize("bp", [jbp, tbp], ids=["jax", "port"])
def test_time_accounting_tiles_elapsed_time(bp):
    acct = bp.TimeAccounting()
    t = 0
    for i in range(50):
        acct.observe(i % 3 == 0, i % 3 == 1, now_ns=t)
        t += 10_000_000
    assert acct.busy_ns + acct.idle_ns + acct.backpressured_ns == 490_000_000
    assert sum(acct.rates()) == pytest.approx(1000.0)


def test_time_accounting_equals_reference():
    out = []
    for _, bp, _, _ in PAIRS:
        acct = bp.TimeAccounting()
        for i, t in enumerate(range(0, 10**9, 7_000_000)):
            acct.observe(i % 5 < 2, i % 5 == 4, now_ns=t)
        out.append((acct.busy_ns, acct.idle_ns, acct.backpressured_ns,
                    acct.rates(), acct.last_class))
    assert out[1] == out[0]


def test_the_ports_routers_never_block():
    """The stated condition: direct-call routing has no queue, so the
    sampler and the sticky predicate report no backpressure."""
    from flink_tpu_torch.runtime.local import _RouterOutput
    router = _RouterOutput()
    assert router.has_capacity() and not router.has_queued_output()
    assert tbp.router_blocked(router) is False
    st = SimpleNamespace(router=router, time_accounting=tbp.TimeAccounting())
    res = tbp.sample_backpressure({1: [st, st]}, num_samples=3, delay_s=0)
    assert res == {1: {"subtask_ratios": [0.0, 0.0], "max_ratio": 0.0,
                       "level": "ok"}}
    assert tbp.classify(0.2) == jbp.classify(0.2) == "low"


def test_job_health_plane_samples_and_registers_the_reference_gauges():
    """``metrics.sample.interval.ms`` turns the journal on for a job;
    the time attribution, backpressure and health gauges carry the
    reference's names."""
    from flink_tpu.core.config import Configuration as JConf
    from flink_tpu.core.config import MetricOptions as JMO
    from flink_tpu.streaming import datastream as jds
    from flink_tpu.streaming import sources as jsrc
    from flink_tpu_torch.core.config import Configuration as TConf
    from flink_tpu_torch.core.config import MetricOptions as TMO
    from flink_tpu_torch.streaming import datastream as tds
    from flink_tpu_torch.streaming import sources as tsrc
    names, clients = [], []
    for ds, src, conf in ((jds, jsrc, JConf().set(JMO.SAMPLE_INTERVAL_MS, 0)),
                          (tds, tsrc, TConf().set(TMO.SAMPLE_INTERVAL_MS, 0))):
        env = ds.StreamExecutionEnvironment.get_execution_environment(
            conf, **({"device": "cpu"} if ds is tds else {}))
        out = []
        env.from_collection(list(range(3000))).map(lambda x: x * 2) \
            .add_sink(src.CollectSink(out))
        client = env.execute_async("job")
        client.wait(60)
        clients.append(client)
        dump = env.get_metric_registry().dump()
        names.append(sorted(k for k in dump if k.startswith("job.")
                            and ".lint." not in k))
    assert names[1] == names[0]
    assert any(n.endswith(".health.alertsTotal") for n in names[1])
    assert any(n.endswith(".busyTimeMsPerSecond") for n in names[1])
    journal = clients[1].executor_state["journal"]
    assert journal.samples_taken > 0
    assert journal.latest("job.health.alertsTotal") == 0.0


# ---- the sampling profiler ---------------------------------------------

def _frames(*names):
    f = None
    for n in names:
        f = SimpleNamespace(f_code=SimpleNamespace(co_filename=f"/x/{n}.py",
                                                   co_name=n), f_back=f)
    return f


def _profile(pr):
    p = pr.SamplingProfiler()
    p.max_nodes = 9     # the trie needs 12: some samples truncate
    stacks = [("main", "loop", "step"), ("main", "loop", "flush"),
              ("main", "loop", "step"), ("main", "other")]
    for i in range(30):
        frame = _frames(*stacks[i % len(stacks)])
        p.ingest("job", "2_win" if i % 3 else "1_src", i % 2,
                 pr.fold_stack(frame), i % 3)
    return p


def test_profiler_export_and_flame_graph_equal_reference():
    pj, pt = _profile(jpr), _profile(tpr)
    ej, et = pj.export(), pt.export()
    et["enabled"] = ej["enabled"]
    assert et == ej
    for mode in tpr.MODES:
        assert tpr.flamegraph_payload(et, "job", mode=mode) == \
            jpr.flamegraph_payload(ej, "job", mode=mode)
        assert tpr.collapsed_lines(et, mode=mode) == \
            jpr.collapsed_lines(ej, mode=mode)
    tree = tpr.flamegraph_payload(et, "job", vertex="2")["tree"]
    assert tpr.hottest_frame(tree) == jpr.hottest_frame(
        jpr.flamegraph_payload(ej, "job", vertex="2")["tree"])
    merged_t = tpr.merge_export(tpr.empty_export(), pt.export(delta=True))
    merged_j = jpr.merge_export(jpr.empty_export(), pj.export(delta=True))
    assert merged_t == merged_j
    assert pt.dropped == pj.dropped > 0
    assert pt.export(delta=True)["samples"]["total"] == 0


def test_profiler_classifies_by_time_accounting_and_registers_gauges():
    st = SimpleNamespace(router=SimpleNamespace(has_capacity=lambda: True,
                                                last_blocked_mono=0.0),
                         time_accounting=SimpleNamespace(last_class=1))
    assert tpr.classify_subtask(st) == jpr.classify_subtask(st) == tpr.OFF_CPU
    names = []
    for _, _, pr, reg_cls in PAIRS:
        reg = reg_cls()
        pr.register_profiler_gauges(reg)
        names.append(sorted(reg.dump()))
    assert names[1] == names[0]
    assert tpr.sample_windowed(lambda i: None, 3, 0) == 3


def test_profiler_samples_a_running_thread():
    import threading
    import time
    p = tpr.SamplingProfiler()
    stop = threading.Event()
    scope = SimpleNamespace(profiler_scope=("job", "1_src", 0))

    def work():
        p.set_scope(scope)
        while not stop.is_set():
            sum(range(1000))

    t = threading.Thread(target=work)
    t.start()
    try:
        for _ in range(200):
            if p.sample_once():
                break
            time.sleep(0.001)
    finally:
        stop.set()
        t.join()
    assert sum(p.samples) >= 1
    assert "job" in p.export()["jobs"]
