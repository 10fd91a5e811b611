"""The same job on both packages, through each one's
StreamExecutionEnvironment: from_collection → timestamps → key_by →
tumbling, sliding or session window → aggregate → CollectSink.

Both packages pick the same engine tier for a job (the log-structured
tier for integer keys and HLL / Sum / quantile cells, Count-Min
sessions; see tests/test_torch_tiers.py), and on the CPU the log
tier's fire is the same C++ in both (finish_tier "auto" picks the host
finish), so the job outputs are compared exactly.  The keyed-backend
jobs run WindowOperator in both packages; their HLL estimates go
through the float32 register path and compare with the linear-counting
log slack of tests/torch_port_util.py."""

import numpy as np
import pytest

from flink_tpu.ops.device_agg import SumAggregate as JaxSum
from flink_tpu.ops.sketches import CountMinSketchAggregate as JaxCountMin
from flink_tpu.ops.sketches import HyperLogLogAggregate as JaxHll
from flink_tpu.ops.sketches import QuantileSketchAggregate as JaxQuantile
from flink_tpu.streaming import datastream as jds
from flink_tpu.streaming import sources as jsrc
from flink_tpu.streaming import windowing as jwin
from flink_tpu.streaming.log_windows import LogStructuredTumblingWindows as JaxLog
from flink_tpu_torch.ops.device_agg import SumAggregate as TorchSum
from flink_tpu_torch.ops.sketches import CountMinSketchAggregate as TorchCountMin
from flink_tpu_torch.ops.sketches import HyperLogLogAggregate as TorchHll
from flink_tpu_torch.ops.sketches import QuantileSketchAggregate as TorchQuantile
from flink_tpu_torch.streaming import datastream as tds
from flink_tpu_torch.streaming import sources as tsrc
from flink_tpu_torch.streaming import windowing as twin
from torch_port_util import assert_hll_close


def _events(seed, n, n_keys, n_values, span):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n_keys, n)
    vals = rng.integers(0, n_values, n)
    ts = np.sort(rng.integers(0, span, n))
    ts[n // 2: n // 2 + 20] -= 2500           # out of order: late stragglers
    return list(zip(keys.tolist(), vals.tolist(), ts.tolist()))


def _job(ds, src, win, agg, events, size, **env_kw):
    agg.extract_value = lambda e: e[1]
    out = []
    env = ds.StreamExecutionEnvironment.get_execution_environment(**env_kw)
    (env.from_collection(events)
        .assign_timestamps_and_watermarks(
            src.BoundedOutOfOrdernessTimestampExtractor(50, lambda e: e[2]))
        .key_by(lambda e: e[0])
        .window(win.TumblingEventTimeWindows.of(size))
        .aggregate(agg, window_function=lambda k, w, vals: [
            (int(k), w.start, float(vals[0]))])
        .add_sink(src.CollectSink(out)))
    env.execute("port-vs-reference")
    return out


def _by_pair(out):
    d = {(k, s): v for k, s, v in out}
    assert len(d) == len(out)
    return d


@pytest.mark.parametrize("p", [8, 12])
def test_hll_job_matches_reference(p):
    events = _events(11, 20_000, 300, 5_000, 6_000)
    got = _by_pair(_job(tds, tsrc, twin, TorchHll(p), events, 1000, device="cpu"))
    want = _by_pair(_job(jds, jsrc, jwin, JaxHll(p), events, 1000))
    assert len(got) > 1000
    # both run the log tier's C++ host fire: bit-equal
    assert got == want
    # against the JAX log engine fed the events the job keeps: a record
    # is late when its window ended at or before the watermark in force
    # on its arrival (max earlier timestamp - 50 - 1)
    arr = np.array(events, np.int64)
    prev_max = np.maximum.accumulate(np.concatenate([[-2**62], arr[:-1, 2]]))
    kept = arr[arr[:, 2] - arr[:, 2] % 1000 + 999 > prev_max - 51]
    assert 0 < len(arr) - len(kept) <= 20
    eng = JaxLog(JaxHll(p), 1000, finish_tier="host")
    eng.process_batch(kept[:, 0], kept[:, 2], kept[:, 1])
    eng.advance_watermark(2**62)
    ref = {(int(kk), s): float(r) for kk, r, s, _ in eng.emitted}
    assert ref == got


def test_sum_job_exact():
    events = _events(12, 20_000, 400, 50, 12_000)
    got = _by_pair(_job(tds, tsrc, twin, TorchSum(np.float64), events, 5000,
                        device="cpu"))
    want = _by_pair(_job(jds, jsrc, jwin, JaxSum(np.float64), events, 5000))
    assert got == want and len(got) > 400


def test_print_sink_and_accumulators(capsys):
    env = tds.StreamExecutionEnvironment.get_execution_environment(device="cpu")
    agg = TorchSum(np.int64)
    agg.extract_value = lambda e: e[1]
    sink = tsrc.CollectSink()
    ws = (env.from_collection([(1, 2, 5), (1, 3, 7), (2, 4, 1500)])
          .assign_timestamps_and_watermarks(
              tsrc.BoundedOutOfOrdernessTimestampExtractor(0, lambda e: e[2]))
          .key_by(0).window(twin.TumblingEventTimeWindows.of(1000)))
    out = ws.aggregate(agg)
    out.add_sink(sink)
    out.print_("w")
    res = env.execute()
    assert sorted(sink.values) == [4, 5]
    assert sorted(res.accumulators["collected"]) == [4, 5]
    assert sorted(capsys.readouterr().out.split()) == ["w4", "w5"]


def _keyed_job(ds, src, win, ops, agg, events, backend, lateness, **env_kw):
    """The job on a keyed-state backend: allowed lateness takes it off
    the device window engine onto WindowOperator in both packages; the
    records too late even for the lateness go to a side output."""
    agg.extract_value = lambda e: e[1]
    out, late = [], []
    env = ds.StreamExecutionEnvironment.get_execution_environment(**env_kw)
    env.set_state_backend(backend)
    tag = ops.OutputTag("late")
    windowed = (env.from_collection(events)
                .assign_timestamps_and_watermarks(
                    src.BoundedOutOfOrdernessTimestampExtractor(50, lambda e: e[2]))
                .key_by(lambda e: e[0])
                .window(win.TumblingEventTimeWindows.of(1000))
                .allowed_lateness(lateness)
                .side_output_late_data(tag)
                .aggregate(agg, window_function=lambda k, w, vals: [
                    (int(k), w.start, float(vals[0]))]))
    windowed.add_sink(src.CollectSink(out))
    windowed.get_side_output(tag).add_sink(src.CollectSink(late))
    env.execute("keyed-backend")
    return out, late


@pytest.mark.parametrize("agg", ["sum", "hll"])
def test_gpu_backend_job_matches_tpu_backend_job(agg):
    from flink_tpu.streaming import operators as jops
    from flink_tpu_torch.streaming import operators as tops
    events = _events(13, 6_000, 200, 300, 6_000)
    rng = np.random.default_rng(14)
    for i in rng.choice(len(events), 60, replace=False):
        k, v, t = events[i]            # within the lateness or beyond it
        events[i] = (k, v, max(0, t - int(rng.integers(300, 1500))))
    make = {"sum": (lambda: TorchSum(np.float64), lambda: JaxSum(np.float64)),
            "hll": (lambda: TorchHll(8), lambda: JaxHll(8))}[agg]
    got, got_late = _keyed_job(tds, tsrc, twin, tops, make[0](), events, "gpu",
                               700, device="cpu")
    want, want_late = _keyed_job(jds, jsrc, jwin, jops, make[1](), events,
                                 "tpu", 700)
    heap, _ = _keyed_job(tds, tsrc, twin, tops, make[0](), events, "heap", 700,
                         device="cpu")
    # late refires emit one (key, window) more than once, in order
    assert len(got) > len({(k, s) for k, s, _ in got}) > 600
    assert got_late == want_late and len(got_late) > 0
    if agg == "sum":
        assert got == want == heap
    else:
        assert [r[:2] for r in got] == [r[:2] for r in want] == [r[:2] for r in heap]
        assert_hll_close([r[2] for r in got], [r[2] for r in want], 1 << 8)


# ---------------------------------------------------------------------
# sliding quantiles and session Count-Min through the DataStream API
# ---------------------------------------------------------------------

Q3 = dict(quantiles=(0.5, 0.99), relative_accuracy=0.05, min_value=1e-3,
          max_value=1e6)


def _window_job(ds, src, win, agg, events, assigner, heap=False, **env_kw):
    agg.extract_value = lambda e: e[1]
    out = []
    env = ds.StreamExecutionEnvironment.get_execution_environment(**env_kw)
    if heap:
        env.set_state_backend("heap")
    windowed = (env.from_collection(events)
                .assign_timestamps_and_watermarks(
                    src.BoundedOutOfOrdernessTimestampExtractor(50, lambda e: e[2]))
                .key_by(lambda e: e[0])
                .window(assigner))
    if heap:
        windowed = windowed.disable_device_operator()
    (windowed.aggregate(agg, window_function=lambda k, w, vals: [
        (str(k), w.start, w.end, np.asarray(vals[0], np.float64).tolist())])
        .add_sink(src.CollectSink(out)))
    env.execute("window-job")
    return sorted(out)


def _sketch_events(seed, kind, n=5000):
    """String keys (the JAX package interns them for its log tier);
    quantile values drawn away from bucket boundaries (see
    tests/test_torch_sketches.py), Count-Min items small integers
    (each is also its weight)."""
    rng = np.random.default_rng(seed)
    keys = [f"k{k}" for k in rng.integers(0, 200, n)]
    t = np.sort(rng.integers(0, 10_000, n))
    t[n // 2: n // 2 + 20] -= 2500                # late stragglers
    if kind == "quantile":
        lg = TorchQuantile(**Q3).log_gamma
        v = rng.lognormal(3.0, 1.0, 2 * n).astype(np.float32)
        x = np.log(v.astype(np.float64)) / lg
        v = v[np.abs(x - np.round(x)) > 4 * np.abs(np.spacing(np.float32(x)))][:n]
        vals = v.tolist()
    else:
        vals = rng.integers(1, 50, n).tolist()
    return list(zip(keys, vals, np.maximum(t, 0).tolist()))


def _sketch_job_cases(kind):
    if kind == "quantile":
        return (lambda: TorchQuantile(**Q3), lambda: JaxQuantile(**Q3),
                lambda w: w.SlidingEventTimeWindows.of(3000, 1000))
    return (lambda: TorchCountMin(4, 64), lambda: JaxCountMin(4, 64),
            lambda w: w.EventTimeSessionWindows.with_gap(300))


@pytest.mark.parametrize("kind", ["quantile", "countmin"])
def test_sketch_window_job_matches_reference(kind):
    """The port's device operator against the JAX package's job (both
    run the log tier) and against the port's own job on WindowOperator
    over the heap backend."""
    make_t, make_j, assigner = _sketch_job_cases(kind)
    events = _sketch_events(21, kind)
    got = _window_job(tds, tsrc, twin, make_t(), events, assigner(twin),
                      device="cpu")
    want = _window_job(jds, jsrc, jwin, make_j(), events, assigner(jwin))
    heap = _window_job(tds, tsrc, twin, make_t(), events, assigner(twin),
                       heap=True, device="cpu")
    assert len(got) > 1000
    assert [r[:3] for r in got] == [r[:3] for r in want] == [r[:3] for r in heap]
    g, w, h = (np.array([r[3] for r in x]) for x in (got, want, heap))
    np.testing.assert_array_equal(g, w)
    if kind == "countmin":
        np.testing.assert_array_equal(g, h)
    else:
        # the log tier's fire computes bucket values in float64, the
        # heap backend's sketch in float32: the same buckets, values a
        # few float32 ulps apart
        np.testing.assert_allclose(g, h, rtol=1e-6, atol=0)
