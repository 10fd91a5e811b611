"""Parallel subtasks in the port's executor (flink_tpu_torch/runtime/local.py)
against the reference's LocalExecutor on the same data: keyed windows
at parallelism 2 and 4 on the heap backend's WindowOperator and on the
log tier; every key on the subtask ``assign_operator_indexes_np`` names,
whether it travels in a record or in a batch; watermarks that
min-combine over several input channels; and the job
``source -> map -> filter -> key_by(0) -> time_window -> aggregate(HLL)``
with the window at parallelism 4, fused (route mode) and unfused."""

import numpy as np
import pytest

from flink_tpu.core import functions as jfn
from flink_tpu.ops.device_agg import SumAggregate as JSum
from flink_tpu.ops.sketches import HyperLogLogAggregate as JHll
from flink_tpu.streaming import chain_fusion as jcf
from flink_tpu.streaming import columnar as jcol
from flink_tpu.streaming import datastream as jds
from flink_tpu.streaming import sources as jsrc
from flink_tpu.streaming import windowing as jwin
from flink_tpu_torch.core import functions as tfn
from flink_tpu_torch.core.keygroups import (assign_operator_indexes_np,
                                            splitmix64_np)
from flink_tpu_torch.ops.device_agg import SumAggregate as TSum
from flink_tpu_torch.ops.sketches import HyperLogLogAggregate as THll
from flink_tpu_torch.streaming import chain_fusion as tcf
from flink_tpu_torch.streaming import columnar as tcol
from flink_tpu_torch.streaming import datastream as tds
from flink_tpu_torch.streaming import sources as tsrc
from flink_tpu_torch.streaming import windowing as twin

_PKG = {"port": (tds, tsrc, twin, tcol, tfn),
        "ref": (jds, jsrc, jwin, jcol, jfn)}


def _env(pkg):
    ds = _PKG[pkg][0]
    if pkg == "port":
        return ds.StreamExecutionEnvironment.get_execution_environment(device="cpu")
    return ds.StreamExecutionEnvironment.get_execution_environment()


def _events(seed, n, n_keys, span):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n_keys, n)
    vals = rng.integers(0, 1000, n)
    ts = np.sort(rng.integers(0, span, n))
    ts[n // 2: n // 2 + 20] -= 2500          # late stragglers
    return list(zip(keys.tolist(), vals.tolist(), ts.tolist()))


def _window_job(pkg, events, parallelism, tier):
    ds, src, win, _, _ = _PKG[pkg]
    if tier == "heap":
        agg = (TSum if pkg == "port" else JSum)(np.float64)
    else:
        agg = (THll if pkg == "port" else JHll)(10)
    agg.extract_value = lambda e: e[1]
    out = []
    env = _env(pkg)
    windowed = (env.from_collection(events)
                .assign_timestamps_and_watermarks(
                    src.BoundedOutOfOrdernessTimestampExtractor(50, lambda e: e[2]))
                .key_by(lambda e: e[0])
                .window(win.TumblingEventTimeWindows.of(1000)))
    if tier == "heap":
        windowed = windowed.disable_device_operator()
    (windowed.aggregate(agg, window_function=lambda k, w, vals: [
        (int(k), w.start, float(vals[0]))])
        .set_parallelism(parallelism)
        .add_sink(src.CollectSink(out)))
    env.execute("parallel")
    return sorted(out)


@pytest.mark.parametrize("tier", ["heap", "log"])
@pytest.mark.parametrize("parallelism", [2, 4])
def test_keyed_windows_at_parallelism(parallelism, tier):
    events = _events(1, 3000, 60, 6000)
    got = _window_job("port", events, parallelism, tier)
    want = _window_job("ref", events, parallelism, tier)
    assert len(got) > 60
    assert got == want
    # the same results as at parallelism 1
    assert got == _window_job("port", events, 1, tier)


class _WhereMixin:
    def map(self, value):
        return (value[0], self.get_runtime_context().index_of_this_subtask)


def _placement_job(pkg, keys, parallelism, batched):
    ds, src, _, col, fn = _PKG[pkg]

    class _Where(_WhereMixin, fn.MapFunction, fn.RichFunction):
        def __init__(self):
            fn.RichFunction.__init__(self)

    out = []
    env = _env(pkg)
    rows = [(int(k), i) for i, k in enumerate(keys)]
    stream = (env.add_source(col.VectorizedCollectionSource(rows, chunk=512))
              if batched else env.from_collection(rows))
    (stream.key_by(0).map(_Where()).set_parallelism(parallelism)
        .add_sink(src.CollectSink(out)))
    env.execute("placement")
    return sorted(out)


@pytest.mark.parametrize("batched", [False, True], ids=["records", "batches"])
@pytest.mark.parametrize("parallelism", [2, 4])
def test_every_key_lands_on_its_key_group_subtask(parallelism, batched):
    rng = np.random.default_rng(3)
    keys = rng.integers(-10**9, 10**9, 2000)
    got = _placement_job("port", keys, parallelism, batched)
    assert len(got) == len(keys)
    want = assign_operator_indexes_np(splitmix64_np(keys.astype(np.int64)),
                                      128, parallelism)
    owner = dict(zip(keys.tolist(), want.tolist()))
    assert all(owner[k] == sub for k, sub in got)
    assert {sub for _, sub in got} == set(range(parallelism))
    assert got == _placement_job("ref", keys, parallelism, batched)


def test_watermarks_min_combine_over_channels():
    from flink_tpu_torch.runtime.local import SubtaskInstance
    from flink_tpu_torch.streaming.graph import JobVertex, StreamNode
    from flink_tpu_torch.streaming.operators import StreamOperator
    from flink_tpu_torch.streaming.timers import TestProcessingTimeService

    class _Recorder(StreamOperator):
        def __init__(self):
            super().__init__()
            self.seen = []

        def process_element(self, record):
            pass

        def process_watermark(self, watermark):
            self.seen.append(watermark.timestamp)

    vertex = JobVertex(1, [StreamNode(1, "rec", _Recorder)], [])
    st = SubtaskInstance(vertex, device="cpu",
                         processing_time_service=TestProcessingTimeService())
    from flink_tpu_torch.streaming.elements import Watermark
    chans = [st.new_channel(0) for _ in range(3)]
    for ch, wm in ((0, 10), (1, 5), (2, 7), (1, 20), (0, 9), (2, 30), (0, 40)):
        chans[ch].push(Watermark(wm))
    assert st.head.seen == [5, 7, 10, 20]


def _two_exchange_job(pkg, events):
    """source -> key_by -> map at parallelism 4 -> key_by -> window at
    parallelism 1: the window's subtask reads four channels."""
    ds, src, win, _, _ = _PKG[pkg]
    agg = (TSum if pkg == "port" else JSum)(np.float64)
    agg.extract_value = lambda e: e[1]
    out = []
    env = _env(pkg)
    (env.from_collection(events)
        .assign_timestamps_and_watermarks(
            src.BoundedOutOfOrdernessTimestampExtractor(50, lambda e: e[2]))
        .key_by(lambda e: e[0] % 5).map(lambda e: (e[0], e[1] * 2, e[2]))
        .set_parallelism(4)
        .key_by(lambda e: e[0]).window(win.TumblingEventTimeWindows.of(1000))
        .disable_device_operator()
        .aggregate(agg, window_function=lambda k, w, vals: [
            (int(k), w.start, float(vals[0]))])
        .add_sink(src.CollectSink(out)))
    env.execute("two-exchanges")
    return sorted(out)


def test_window_behind_four_channels_matches_the_reference():
    events = _events(4, 2000, 30, 5000)
    got = _two_exchange_job("port", events)
    assert len(got) > 30
    assert got == _two_exchange_job("ref", events)


# ---------------------------------------------------------------------
# the slice's job, fused and unfused

def _hll_job(pkg, data, fused=True):
    ds, src, win, col, _ = _PKG[pkg]
    agg = (THll if pkg == "port" else JHll)(12)
    agg.extract_value = lambda e: e[1]
    out = []
    env = _env(pkg)
    (env.add_source(col.VectorizedCollectionSource(data, timestamped=True,
                                                   chunk=1024))
        .map(lambda t: (t[0], t[1] * 3))
        .filter(lambda t: t[1] % 7 != 0)
        .key_by(0)
        .time_window(win.Time.milliseconds_of(1000))
        .aggregate(agg, window_function=lambda k, w, vals: [
            (int(k), w.start, float(vals[0]))])
        .set_parallelism(4)
        .add_sink(src.CollectSink(out)))
    saved = tcf.FUSION_ENABLED
    tcf.FUSION_ENABLED = fused
    try:
        env.execute("fused-job")
    finally:
        tcf.FUSION_ENABLED = saved
    return sorted(out)


def test_fused_job_at_parallelism_4_matches_the_reference():
    rng = np.random.default_rng(11)
    n = 1 << 13
    keys = rng.integers(0, 500, n)
    vals = rng.integers(0, 1 << 40, n)
    ts = np.sort(rng.integers(0, 4000, n))
    data = [((int(k), int(v)), int(t)) for k, v, t in zip(keys, vals, ts)]
    tcf.FUSION_STATS.reset()
    unfused = _hll_job("port", data, fused=False)
    assert tcf.FUSION_STATS.fused_batches == 0
    fused = _hll_job("port", data, fused=True)
    assert tcf.FUSION_STATS.programs == 1
    assert tcf.FUSION_STATS.fused_batches == n // 1024
    assert tcf.FUSION_STATS.demotions == 0
    # the reference compiles the same run in route mode; on the
    # installed jax it demotes and runs per operator
    demotions = jcf.FUSION_STATS.demotions
    ref = _hll_job("ref", data)
    assert jcf.FUSION_STATS.demotions == demotions + 1
    assert jcf.FUSION_STATS.last_demotion[0] == "chain.op-2-map→op-3-filter"
    assert len(fused) > 500
    assert fused == unfused == ref
