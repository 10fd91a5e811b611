"""The device telemetry plane (``flink_tpu_torch/runtime/device_stats.py``)
against the reference's on the same jobs.

Each job runs once through each package's StreamExecutionEnvironment
with both planes on (``TELEMETRY`` and the tracer), on the same numpy
events.  What must agree:

* ``payload()["kernels"]``: the same labels (the reference's
  ``traced_jit`` names) with the same dispatch counts;
* the flush / fire-read / windows-fired counters;
* the transfer ledger's count per (direction, tag), and its bytes for
  every d2h tag.

The one difference by design: the reference pads a micro-batch to a
power of two and ships size-1 dummies for operands the aggregate does
not read, the port ships the records' own rows, so a flush tag's h2d
bytes are ``flush_rows`` times the row width in the port and more in
the reference.  The tests hold the port to its exact formula and the
reference to at least that.
"""

import sys
import time

import numpy as np
import pytest
import torch

from flink_tpu.ops import device_agg as jda
from flink_tpu.ops import sketches as jsk
from flink_tpu.runtime import device_stats as jdst
from flink_tpu.runtime import tracing as jtr
from flink_tpu.streaming import datastream as jds
from flink_tpu.streaming import sources as jsrc
from flink_tpu.streaming import windowing as jwin
from flink_tpu_torch.ops import device_agg as tda
from flink_tpu_torch.ops import sketches as tsk
from flink_tpu_torch.runtime import device_stats as tdst
from flink_tpu_torch.runtime import tracing as ttr
from flink_tpu_torch.streaming import datastream as tds
from flink_tpu_torch.streaming import sources as tsrc
from flink_tpu_torch.streaming import windowing as twin

JAX = (jds, jsrc, jwin, jdst, jtr, jda, jsk)
PORT = (tds, tsrc, twin, tdst, ttr, tda, tsk)


def events(seed=1, n=6000, n_keys=200, span=6000):
    rng = np.random.default_rng(seed)
    return list(zip(rng.integers(0, n_keys, n).tolist(),
                    rng.integers(0, 1000, n).tolist(),
                    np.sort(rng.integers(0, span, n)).tolist()))


#: name -> (aggregate factory, assigner factory, backend or None)
CASES = {
    "scatter_tumbling": (lambda da, sk: da.MaxAggregate(),
                         lambda w: w.TumblingEventTimeWindows.of(1000), None),
    "scatter_sliding": (lambda da, sk: da.MaxAggregate(),
                        lambda w: w.SlidingEventTimeWindows.of(2000, 1000), None),
    "scatter_session": (lambda da, sk: da.MaxAggregate(),
                        lambda w: w.EventTimeSessionWindows.with_gap(30), None),
    "scatter_hll_str_pair_keys": (
        lambda da, sk: sk.HyperLogLogAggregate(8),
        lambda w: w.TumblingEventTimeWindows.of(1000), None),
    "log_tumbling": (lambda da, sk: sk.HyperLogLogAggregate(10),
                     lambda w: w.TumblingEventTimeWindows.of(1000), None),
    "log_sliding": (lambda da, sk: da.SumAggregate(),
                    lambda w: w.SlidingEventTimeWindows.of(2000, 1000), None),
    "gpu_backend": (lambda da, sk: da.SumAggregate(),
                    lambda w: w.TumblingEventTimeWindows.of(1000), "device"),
}


def run_job(pkg, case, ev, plane=True):
    ds, src, win, dst, tr, da, sk = pkg
    make_agg, make_win, backend = CASES[case]
    agg = make_agg(da, sk)
    agg.extract_value = lambda e: e[1]
    tele, tracer = dst.TELEMETRY, tr.get_tracer()
    tele.reset()
    tracer.reset()
    if plane:
        tele.enable()
        tracer.enabled = True
    out = []
    try:
        env = ds.StreamExecutionEnvironment.get_execution_environment(
            **({"device": "cpu"} if ds is tds else {}))
        if backend is not None:
            env.set_state_backend("gpu" if ds is tds else "tpu")
        # (int, str) pairs take the scatter tier in both packages
        key = ((lambda e: (e[0], str(e[0] % 3)))
               if case == "scatter_hll_str_pair_keys" else (lambda e: e[0]))
        w = (env.from_collection(ev)
             .assign_timestamps_and_watermarks(
                 src.BoundedOutOfOrdernessTimestampExtractor(50, lambda e: e[2]))
             .key_by(key).window(make_win(win)))
        if backend is not None:
            w = w.disable_device_operator()
        w.aggregate(agg).add_sink(src.CollectSink(out))
        env.execute("job")
        return dict(payload=tele.payload(), spans=tracer.stats(), out=out,
                    dump=env.get_metric_registry().dump(),
                    events=tracer.chrome_trace()["traceEvents"])
    finally:
        tele.disable()
        tracer.enabled = False


@pytest.fixture(scope="module")
def ev():
    return events()


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_labels_and_dispatch_counts_equal_reference(case, ev):
    ref, port = run_job(JAX, case, ev), run_job(PORT, case, ev)
    assert len(port["out"]) == len(ref["out"]) > 0
    kr = {k: v["dispatches"] for k, v in ref["payload"]["kernels"].items()}
    kp = {k: v["dispatches"] for k, v in port["payload"]["kernels"].items()}
    assert kp == kr


@pytest.mark.parametrize("case", sorted(CASES))
def test_flush_fire_counters_equal_reference(case, ev):
    ref, port = run_job(JAX, case, ev), run_job(PORT, case, ev)
    keys = ("flushes", "flush_rows", "fire_reads", "windows_fired")
    cr = {k: ref["payload"]["counters"][k] for k in keys}
    cp = {k: port["payload"]["counters"][k] for k in keys}
    assert cp == cr
    assert cp["windows_fired"] == len(port["out"])
    assert port["payload"]["counters"]["fire_flush_ratio"] == \
        ref["payload"]["counters"]["fire_flush_ratio"]


#: bytes of one flushed row in the port: the slot (int32) and the value
#: column the aggregate reads
ROW_BYTES = {"scatter_tumbling": 8, "scatter_sliding": 8, "scatter_session": 8,
             # HLL ships its value hashes compressed: 3 bytes a record
             "scatter_hll_str_pair_keys": 7, "gpu_backend": 8}


@pytest.mark.parametrize("case", sorted(CASES))
def test_transfer_ledger_equals_reference_per_tag(case, ev):
    ref, port = run_job(JAX, case, ev), run_job(PORT, case, ev)
    tr, tp = ref["payload"]["transfers"], port["payload"]["transfers"]
    assert sorted(tp) == sorted(tr)
    rows = port["payload"]["counters"]["flush_rows"]
    for tag in tp:
        assert tp[tag]["count"] == tr[tag]["count"], tag
        if tag.startswith("d2h."):
            assert tp[tag]["bytes"] == tr[tag]["bytes"], tag
        else:
            # stated difference: the port's flush ships unpadded rows
            assert tag.endswith(".flush"), tag
            assert tp[tag]["bytes"] == rows * ROW_BYTES[case]
            assert tr[tag]["bytes"] >= tp[tag]["bytes"]
    totals = port["payload"]["totals"]
    assert totals["d2h"]["bytes"] == sum(
        v["bytes"] for k, v in tp.items() if k.startswith("d2h."))


def test_transfers_land_in_the_chrome_trace(ev):
    port = run_job(PORT, "scatter_tumbling", ev)
    xfers = [e for e in port["events"] if e["name"] == "device.transfer"]
    ledger = port["payload"]["transfers"]
    assert len(xfers) == sum(v["count"] for v in ledger.values())
    assert {e["args"]["tag"] for e in xfers} == {"window.flush", "window.fire"}
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in xfers)


def test_hbm_snapshot_falls_back_to_framework_accounting_on_cpu():
    eng = __import__("flink_tpu_torch.streaming.vectorized",
                     fromlist=["x"]).VectorizedTumblingWindows(
        tda.SumAggregate(), 1000, initial_capacity=1 << 10, device="cpu")
    snap = tdst.TELEMETRY.hbm_snapshot()
    assert snap["source"] == "framework"
    fw = tdst.TELEMETRY.framework_hbm()
    assert fw["bytes_in_use"] >= sum(v.nbytes for v in eng.state.values()) > 0
    assert fw["by_dtype"]
    # the reference's CPU fallback has the same shape
    jsnap = jdst.TELEMETRY.hbm_snapshot()
    assert set(jsnap) == set(snap)


def test_tree_nbytes_counts_tensors_and_arrays():
    tree = ({"a": torch.zeros(4, dtype=torch.int32), "b": np.zeros(3)},
            [torch.zeros(2, 2), 7, "x"], None)
    assert tdst.tree_nbytes(tree) == 16 + 24 + 16


def test_link_info_reports_unmeasured_without_probing():
    from flink_tpu_torch.ops import link_probe
    saved = dict(link_probe._cache)
    link_probe._cache.clear()
    try:
        assert tdst.TELEMETRY.link_info() == {"measured": False}
        link_probe.measure("cpu")
        info = tdst.TELEMETRY.link_info()
        assert info["measured"] and info["cpu_backend"]
        assert info["h2d_gbps"] is None and info["finish_tier"] == "host"
    finally:
        link_probe._cache.clear()
        link_probe._cache.update(saved)


def test_exchange_round_ledger_and_payload_shape_match_reference():
    for dst in (jdst, tdst):
        dst.TELEMETRY.reset()
        dst.TELEMETRY.record_exchange_round("mesh.log", 1.0, 2.0, 3.0, 4.0,
                                            128)
        dst.TELEMETRY.record_exchange_round("mesh.log", 1.0, 2.0, 3.0, 4.0,
                                            64)
    pr, pp = jdst.TELEMETRY.payload(), tdst.TELEMETRY.payload()
    assert pp["exchange_phases"] == pr["exchange_phases"]
    assert pp["recent_exchange_rounds"] == pr["recent_exchange_rounds"]
    assert set(pp) == set(pr) | {"cuda_launches"}
    for dst in (jdst, tdst):
        dst.TELEMETRY.reset()


def test_device_gauges_have_the_reference_names():
    from flink_tpu.runtime.metrics import MetricRegistry as JReg
    from flink_tpu_torch.runtime.metrics import MetricRegistry as TReg
    jr, tr = JReg(), TReg()
    jdst.register_device_gauges(jr)
    tdst.register_device_gauges(tr)
    assert sorted(tr.dump()) == sorted(jr.dump())


def test_mesh_engine_ledgers_the_exchange(monkeypatch):
    """The mesh log tier on 4 virtual CPU shards: each exchange round is
    an h2d and a d2h of ``mesh.exchange`` and one ``mesh.log`` phase
    round.  The reference's rounds run on its 8 virtual CPU devices;
    the round count depends on the mesh, so the port is held to its own
    invariants: rounds == h2d count == d2h count, bytes sent == the
    phase ledger's."""
    from flink_tpu_torch.parallel.mesh import Mesh
    from flink_tpu_torch.parallel.mesh_log import MeshLogTumblingWindows
    rng = np.random.default_rng(3)
    eng = MeshLogTumblingWindows(tsk.HyperLogLogAggregate(8), 1000,
                                 Mesh(["cpu"] * 4), "kg")
    tdst.TELEMETRY.reset()
    tdst.TELEMETRY.enable()
    try:
        for i in range(4):
            n = 4096
            eng.process_batch(rng.integers(0, 500, n),
                              np.sort(rng.integers(i * 1000, (i + 1) * 1000, n)),
                              rng.integers(0, 10**6, n))
            eng.flush()
            eng.advance_watermark((i + 1) * 1000 - 1)
        p = tdst.TELEMETRY.payload()
    finally:
        tdst.TELEMETRY.disable()
    rounds = p["exchange_phases"]["mesh.log"]["rounds"]
    assert rounds > 0
    assert p["transfers"]["h2d.mesh.exchange"]["count"] == rounds
    assert p["transfers"]["d2h.mesh.exchange"]["count"] == rounds
    assert p["transfers"]["h2d.mesh.exchange"]["bytes"] == \
        p["exchange_phases"]["mesh.log"]["bytes"]
    tdst.TELEMETRY.reset()


# ---- the disabled plane ----------------------------------------------

#: modules on the per-record and per-batch paths
HOT_MODULES = ("flink_tpu_torch.streaming.vectorized",
               "flink_tpu_torch.streaming.vectorized_sessions",
               "flink_tpu_torch.streaming.log_windows",
               "flink_tpu_torch.streaming.window_operator",
               "flink_tpu_torch.streaming.device_window_operator",
               "flink_tpu_torch.streaming.chain_fusion",
               "flink_tpu_torch.state.gpu_backend",
               "flink_tpu_torch.native",
               "flink_tpu_torch.kernels.loader",
               "flink_tpu_torch.runtime.tracing",
               "flink_tpu_torch.runtime.device_stats",
               "flink_tpu_torch.parallel.mesh_log",
               "flink_tpu_torch.parallel.mesh_agg")


@pytest.mark.parametrize("case", ["scatter_tumbling", "scatter_session",
                                  "log_tumbling", "gpu_backend"])
def test_disabled_plane_makes_no_timing_call_and_records_nothing(
        case, ev, monkeypatch):
    """Off (the default), no hot-path module calls perf_counter_ns, the
    tracer hands out its shared no-op span, and every ledger stays
    empty.  The executor's per-turn time attribution (one reading per
    loop turn and subtask, in runtime.backpressure) is not per record
    and is left out."""
    callers = {}
    real = time.perf_counter_ns

    def counting():
        mod = sys._getframe(1).f_globals.get("__name__", "?")
        callers[mod] = callers.get(mod, 0) + 1
        return real()

    monkeypatch.setattr(time, "perf_counter_ns", counting)
    for name in HOT_MODULES:
        mod = sys.modules.get(name) or __import__(name, fromlist=["x"])
        if hasattr(mod, "_perf_ns"):
            monkeypatch.setattr(mod, "_perf_ns", counting)
    launches = []
    monkeypatch.setattr(ttr.LAUNCH_LEDGER, "record",
                        lambda *a: launches.append(a))
    port = run_job(PORT, case, ev, plane=False)
    assert port["out"]
    assert not [m for m in callers if m in HOT_MODULES], callers
    assert ttr.get_tracer().span("x") is ttr._NULL_SPAN
    assert port["events"] == [] and port["spans"] == {}
    p = port["payload"]
    assert p["transfers"] == {} and p["kernels"] == {}
    assert p["counters"]["flushes"] == p["counters"]["windows_fired"] == 0
    assert launches == [] and ttr.LAUNCH_LEDGER.pending() == 0


# ---- on the card -------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the launch ledger reads CUDA events")
    return torch.device("cuda")


@pytest.mark.gpu
def test_launch_ledger_counts_equal_launches_on_the_card(cuda):
    from flink_tpu_torch import kernels as K
    from flink_tpu_torch.streaming.vectorized import VectorizedTumblingWindows
    rng = np.random.default_rng(5)
    eng = VectorizedTumblingWindows(tsk.HyperLogLogAggregate(12), 1000,
                                    initial_capacity=1 << 12, device=cuda)
    ttr.reset_kernel_stats()
    K.reset_launch_counts()
    tdst.TELEMETRY.enable()
    try:
        for i in range(4):
            n = 1 << 14
            eng.process_batch(rng.integers(0, 3000, n),
                              np.sort(rng.integers(i * 1000, (i + 1) * 1000, n)),
                              rng.integers(0, 10**9, n))
            eng.advance_watermark((i + 1) * 1000 - 1)
        stats = ttr.LAUNCH_LEDGER.stats()
    finally:
        tdst.TELEMETRY.disable()
    launched = {k: v for k, v in K.LAUNCHES.items() if v}
    assert launched
    assert {k[len("cuda."):]: v["launches"] for k, v in stats.items()} == launched
    for v in stats.values():
        assert v["timed"] == v["launches"] and v["device_ms"] > 0
