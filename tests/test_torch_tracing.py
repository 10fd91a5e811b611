"""The span tracer, the host-runtime profile, the CUDA launch ledger and
``traced_call`` (``flink_tpu_torch/runtime/tracing.py``) against the
reference's ``flink_tpu/runtime/tracing.py``.

The tracer's own behaviour runs the same script on both modules and
compares what comes out.  For jobs, the same events go through both
packages with the tracer on: span names and counts per name, the
``native.<name>`` host-runtime dispatch counts and the registry's
profile gauges must agree.  The launch ledger needs CUDA events; on the
CPU it runs on host stand-ins for the events (the bookkeeping is what
is tested), and on the card ``tests/test_torch_device_stats.py`` holds
its counts to ``kernels.LAUNCHES``.  ``traced_jit`` has no twin for
compiles: the port compiles nothing per shape, and
``record_compile_event`` carries its builds."""

import json

import numpy as np
import pytest

from flink_tpu.runtime import tracing as jtr
from flink_tpu.runtime.metrics import MetricRegistry as JReg
from flink_tpu_torch.runtime import device_stats as tdst
from flink_tpu_torch.runtime import tracing as ttr
from flink_tpu_torch.runtime.metrics import MetricRegistry as TReg
from test_torch_device_stats import CASES, JAX, PORT, events, run_job

MODULES = pytest.mark.parametrize("tr", [jtr, ttr], ids=["jax", "port"])


def _script(tr, clock):
    """One scripted use of a Tracer on a fake clock: nested spans, an
    instant, lanes and attributes; returns its export and stats."""
    tracer = tr.Tracer(max_events=64)
    tracer.enabled = True
    with tracer.span("outer", n=1):
        clock[0] += 1000
        with tracer.span("inner"):
            clock[0] += 3000
        tracer.set_lane("tm-1")
        with tracer.span("inner"):
            clock[0] += 2000
        tracer.record_instant("mark", k="v")
        tracer.set_lane(None)
        clock[0] += 500
    return tracer


@pytest.fixture
def fake_clock(monkeypatch):
    clock = [10_000]
    for tr in (jtr, ttr):
        monkeypatch.setattr(tr, "_perf_ns", lambda: clock[0])
    return clock


def test_span_tree_self_time_and_export_equal_reference(fake_clock):
    ref = _script(jtr, fake_clock)
    fake_clock[0] = 10_000
    port = _script(ttr, fake_clock)

    def strip(events):
        return [{k: v for k, v in e.items() if k not in ("pid", "tid")}
                for e in events]

    assert strip(port.chrome_trace()["traceEvents"]) == \
        strip(ref.chrome_trace()["traceEvents"])
    assert port.stats() == ref.stats()
    st = port.stats()
    assert st["outer"]["total_ms"] == pytest.approx(0.0065)
    assert st["outer"]["self_ms"] == pytest.approx(0.0015)
    assert st["inner"]["count"] == 2
    assert {e.get("lane") for e in port.recent()} == {None, "tm-1"}


@MODULES
def test_disabled_tracer_records_nothing(tr):
    tracer = tr.Tracer()
    with tracer.span("x") as s:
        s.set_attr("a", 1)
    tracer.record_instant("y")
    assert tracer.span("x") is tr._NULL_SPAN
    assert tracer.recent() == [] and tracer.stats() == {}


@MODULES
def test_ring_overflow_counts_drops_and_annotates_export(tr):
    tracer = tr.Tracer(max_events=8)
    tracer.enabled = True
    for i in range(20):
        with tracer.span(f"s{i % 3}"):
            pass
    trace = tracer.chrome_trace()
    assert len(trace["traceEvents"]) == 8 and tracer.dropped == 12
    assert trace["metadata"]["dropped_events"] == 12
    assert tracer.stats()["s0"]["count"] == 7


@MODULES
def test_export_since_and_lane_buffers(tr):
    tracer = tr.Tracer()
    tracer.enabled = True
    with tracer.span("a"):
        pass
    seq = tracer.export_since(0)["seq"]
    tracer.set_lane("tm-0")
    with tracer.span("b"):
        pass
    tracer.set_lane(None)
    inc = tracer.export_since(seq)
    assert [e["name"] for e in inc["events"]] == ["b"]
    assert tracer.export_since(0, lane="tm-0")["events"][0]["name"] == "b"
    bufs = tracer.lane_buffers()
    assert sorted(bufs) == ["main", "tm-0"]
    merged = tr.build_cluster_trace(bufs)
    assert merged["metadata"]["lanes"]["tm-0"]["events"] == 1
    assert merged["traceEvents"][0]["ph"] == "M"


def test_build_cluster_trace_equals_reference():
    bufs = {"a": {"events": [{"name": "x", "ph": "X", "ts": 5.0, "dur": 1.0,
                              "seq": 1}],
                  "anchor": {"perf_us": 0.0, "wall_us": 100.0}},
            "b": {"events": [{"name": "y", "ph": "X", "ts": 1.0, "dur": 2.0,
                              "seq": 1}],
                  "anchor": {"perf_us": 0.0, "wall_us": 200.0}}}
    assert ttr.build_cluster_trace(bufs, {"b": 50.0}) == \
        jtr.build_cluster_trace(bufs, {"b": 50.0})


@MODULES
def test_clock_offset_and_trace_context(tr):
    est = tr.estimate_clock_offset(lambda: 0.0, samples=3)
    assert est["rtt_us"] >= 0 and est["offset_us"] < 0
    ctx = tr.make_trace_context()
    assert len(ctx["trace_id"]) == len(ctx["span_id"]) == 16


@MODULES
def test_write_chrome_trace_parses(tr, tmp_path):
    tracer = tr.Tracer()
    tracer.enabled = True
    with tracer.span("a", k=1):
        pass
    path = tmp_path / "t.json"
    assert tracer.write_chrome_trace(str(path)) == 1
    ev = json.loads(path.read_text())["traceEvents"][0]
    assert {"name", "ph", "ts", "dur", "pid", "tid"} <= set(ev)


# ---- jobs through both packages ----------------------------------------

@pytest.fixture(scope="module")
def ev():
    return events(seed=4)


@pytest.mark.parametrize("case", sorted(CASES))
def test_job_span_names_and_counts_equal_reference(case, ev):
    ref, port = run_job(JAX, case, ev), run_job(PORT, case, ev)
    cr = {k: v["count"] for k, v in ref["spans"].items()}
    cp = {k: v["count"] for k, v in port["spans"].items()}
    assert cp == cr
    assert cp  # every job leaves spans


@pytest.mark.parametrize("case", ["log_tumbling", "log_sliding",
                                  "scatter_tumbling"])
def test_host_runtime_dispatch_counts_equal_reference(case, ev):
    """``native.<name>``: the reference counts its host-runtime calls at
    all times, the port while a plane is on; both run with the plane
    on here.  Stated difference: the port hashes a batch of integer
    keys with numpy's splitmix64 (``core.keygroups.splitmix64_np``, bit
    for bit the same hash), where the reference calls the host
    runtime's, so the reference alone counts ``splitmix64``."""
    counts = []
    for pkg, tr in ((JAX, jtr), (PORT, ttr)):
        tr.reset_kernel_stats()
        run_job(pkg, case, ev)
        counts.append({k: v["dispatches"] for k, v in tr.kernel_stats().items()
                       if not k.startswith("cuda.")})
        tr.reset_kernel_stats()
    ref = dict(counts[0])
    assert ref.pop("splitmix64", 0) > 0 or case == "log_sliding"
    assert counts[1] == ref
    assert counts[1]


def test_job_trace_events_carry_layers_and_parse(ev, tmp_path):
    port = run_job(PORT, "scatter_tumbling", ev)
    names = {e["name"] for e in port["events"]}
    assert {"device_window.flush", "device_window.fire",
            "device.transfer"} <= names
    assert any(n.startswith("op.") and n.endswith(".process") for n in names)
    assert all("ph" in e and "ts" in e for e in port["events"])


def test_profile_gauges_have_the_reference_names():
    jr, tr_ = JReg(), TReg()
    jtr.register_runtime_profile_gauges(jr)
    ttr.register_runtime_profile_gauges(tr_)
    ref = {k for k in jr.dump() if k.startswith("tracing.")}
    port = {k for k in tr_.dump() if k.startswith("tracing.")}
    assert port == ref
    assert {"cuda.launches", "cuda.deviceMs", "cuda.pending"} <= set(tr_.dump())


def test_record_compile_event_reaches_jit_stats_and_the_registry():
    ttr.reset_jit_stats()
    reg = TReg()
    ttr.register_runtime_profile_gauges(reg)
    ttr.record_compile_event("cuda.build.hll_update", 1.5)
    ttr.record_compile_event("cuda.build.hll_update", 0.5)
    st = ttr.jit_stats()["cuda.build.hll_update"]
    assert st["recompiles"] == 2 and st["compile_time_ms"] == 2000.0
    assert reg.dump()["jit.cuda.build.hll_update.recompiles"] == 2
    ttr.reset_jit_stats()


def test_traced_call_accounts_only_while_the_telemetry_is_on():
    import torch
    calls = []
    fn = ttr.traced_call(lambda x: calls.append(1) or x * 2, "demo.kernel")
    tdst.TELEMETRY.reset()
    fn(torch.ones(4))
    assert tdst.TELEMETRY.payload()["kernels"] == {}
    tdst.TELEMETRY.enable()
    try:
        fn(torch.ones(4))
        fn(torch.ones(8))
    finally:
        tdst.TELEMETRY.disable()
    k = tdst.TELEMETRY.payload()["kernels"]["demo.kernel"]
    assert k["dispatches"] == 2 and len(calls) == 3
    assert k["bytes_in"] == k["bytes_out"] == 4 * 12
    tdst.TELEMETRY.reset()


# ---- the launch ledger on host stand-ins -----------------------------------

class _FakeEvent:
    """A CUDA event stand-in on a shared fake device clock (ms)."""
    clock = [0.0]

    def __init__(self):
        self.t = None

    def record(self):
        self.t = _FakeEvent.clock[0]

    def query(self):
        return True

    def elapsed_time(self, other):
        return other.t - self.t


@pytest.fixture
def fake_ledger(monkeypatch):
    ledger = ttr.LaunchLedger(max_pending=4)
    ledger.event_factory = _FakeEvent
    ledger.current_device = lambda: 0
    synced = []
    ledger.synchronize = synced.append
    ledger.synced = synced
    monkeypatch.setattr(ttr, "LAUNCH_LEDGER", ledger)
    return ledger


def test_loader_launch_goes_through_the_ledger_only_while_a_plane_is_on(
        fake_ledger, monkeypatch):
    """``loader.launch`` with a stand-in launcher: each launch counts in
    ``LAUNCHES``; while the telemetry is on, also in the ledger, whose
    count equals the LAUNCHES delta, with a device time per launch and
    no synchronize until a read."""
    from flink_tpu_torch.kernels import loader

    def launcher(*args):
        _FakeEvent.clock[0] += 0.25     # the kernel's device time
        return 0

    monkeypatch.setitem(loader._functions, "ft_clear_rows", launcher)
    monkeypatch.setattr(loader, "current_stream", lambda: 0)
    before = loader.LAUNCHES["clear_rows"]
    loader.launch("clear_rows", "ft_clear_rows", 1, 2)
    assert fake_ledger.stats(resolve=False) == {}
    tdst.TELEMETRY.enable()
    try:
        for _ in range(3):
            loader.launch("clear_rows", "ft_clear_rows", 1, 2)
    finally:
        tdst.TELEMETRY.disable()
    assert fake_ledger.synced == [] and fake_ledger.pending() == 3
    st = fake_ledger.stats()["cuda.clear_rows"]
    assert fake_ledger.synced == [0]
    assert st["launches"] == loader.LAUNCHES["clear_rows"] - before - 1 == 3
    assert st["timed"] == 3 and st["device_ms"] == pytest.approx(0.75)


def test_ledger_bounds_its_pending_pairs_and_places_device_events(
        fake_ledger):
    tracer = ttr.get_tracer()
    tracer.reset()
    tracer.enabled = True
    try:
        for i in range(6):
            def call():
                _FakeEvent.clock[0] += 1.0
                return 0
            fake_ledger.record("hll_update", call)
        # the list holds 4: the fifth launch drained the completed ones
        assert fake_ledger.pending() <= 4
        trace = tracer.chrome_trace()
    finally:
        tracer.enabled = False
    st = fake_ledger.stats()["cuda.hll_update"]
    assert st["launches"] == 6 and st["timed"] + st["untimed"] == 6
    dev = [e for e in trace["traceEvents"] if e["name"] == "cuda.hll_update"]
    assert len(dev) == st["timed"]
    assert all(e["lane"] == "device" and e["ph"] == "X"
               and e["dur"] == pytest.approx(1000.0) for e in dev)
    assert all(e["tid"] == ttr.DEVICE_TID_BASE for e in dev)
    ts = [e["ts"] for e in dev]
    assert ts == sorted(ts) and np.allclose(np.diff(ts), 1000.0)
    tracer.reset()


def test_ledger_counts_a_launch_whose_pair_cannot_queue(fake_ledger):
    class Busy(_FakeEvent):
        def query(self):
            return False        # the card has not reached it yet

    fake_ledger.event_factory = Busy
    for _ in range(7):
        fake_ledger.record("merge_rows", lambda: 0)
    st = fake_ledger.stats()["cuda.merge_rows"]
    assert st["launches"] == 7 and st["timed"] == 4 and st["untimed"] == 3
