"""DeviceWindowOperator's tier choice in the port against the JAX
package's: each row of the tier table runs as the same DataStream job
through both packages, which must pick engines of the same class and
give the same results (exactly where both run the same C++ on the log
tier or the fused string sum; within the HLL tolerance of
tests/torch_port_util.py, or exactly for integer counts, on the
scatter tier).  Then the operator-level cases of
tests/test_device_window_operator.py (tier by key dtype, the string
interner, the fused string sum over several flushes, the lazy
watermark fast-forward, the fallback for parameters the log tier
refuses), each on both packages."""

import collections

import numpy as np
import pytest

from flink_tpu.ops import device_agg as jagg
from flink_tpu.ops import sketches as jsk
from flink_tpu.streaming import datastream as jds
from flink_tpu.streaming import device_window_operator as jdwo
from flink_tpu.streaming import harness as jh
from flink_tpu.streaming import sources as jsrc
from flink_tpu.streaming import windowing as jwin
from flink_tpu_torch.ops import device_agg as tagg
from flink_tpu_torch.ops import sketches as tsk
from flink_tpu_torch.streaming import datastream as tds
from flink_tpu_torch.streaming import device_window_operator as tdwo
from flink_tpu_torch.streaming import harness as th
from flink_tpu_torch.streaming import sources as tsrc
from flink_tpu_torch.streaming import windowing as twin
from torch_port_util import assert_hll_close

Q = dict(quantiles=(0.5, 0.99), relative_accuracy=0.05, min_value=1e-3,
         max_value=1e6)

LOG, SLIDE_LOG, SESSION_LOG = ("LogStructuredTumblingWindows",
                               "LogStructuredSlidingWindows",
                               "LogStructuredSessionWindows")
STRING_SUM = "StringSumTumblingWindows"

# (keys, aggregate name and arguments, assigner, engine both pick, compare)
ROWS = [
    ("int", ("HyperLogLogAggregate", (8,)), "tumbling", LOG, "exact"),
    ("uint", ("HyperLogLogAggregate", (12,)), "sliding", SLIDE_LOG, "exact"),
    ("int", ("SumAggregate", (np.float64,)), "sliding", SLIDE_LOG, "exact"),
    ("int", ("QuantileSketchAggregate", Q), "tumbling", LOG, "exact"),
    ("int", ("QuantileSketchAggregate", Q), "sliding", SLIDE_LOG, "exact"),
    ("int", ("CountMinSketchAggregate", (4, 64)), "session", SESSION_LOG, "exact"),
    ("int", ("HyperLogLogAggregate", (8,)), "session",
     "VectorizedSessionWindows", "hll"),
    ("int", ("SumAggregate", (np.float64,)), "session",
     "VectorizedSessionWindows", "exact"),
    ("int", ("CountMinSketchAggregate", (4, 64)), "tumbling",
     "VectorizedTumblingWindows", "exact"),
    ("int", ("CountMinSketchAggregate", (4, 64)), "sliding",
     "VectorizedSlidingWindows", "exact"),
    ("int", ("CountAggregate", ()), "tumbling", "VectorizedTumblingWindows", "exact"),
    ("int", ("MaxAggregate", (np.float32,)), "sliding",
     "VectorizedSlidingWindows", "exact"),
    ("int", ("HyperLogLogAggregate", (17,)), "tumbling",
     "VectorizedTumblingWindows", "hll"),
    ("str", ("SumAggregate", (np.float64,)), "tumbling", STRING_SUM, "exact"),
    ("str", ("SumAggregate", (np.int64,)), "tumbling", LOG, "exact"),
    ("str", ("HyperLogLogAggregate", (8,)), "tumbling", LOG, "exact"),
    ("str", ("CountMinSketchAggregate", (4, 64)), "session", SESSION_LOG, "exact"),
    ("tuple", ("HyperLogLogAggregate", (8,)), "tumbling",
     "VectorizedTumblingWindows", "hll"),
]


def _make(pkg, name, args):
    for mod in ((jagg, jsk) if pkg == "jax" else (tagg, tsk)):
        cls = getattr(mod, name, None)
        if cls is not None:
            return cls(**args) if isinstance(args, dict) else cls(*args)
    raise AssertionError(name)


def _assigner(win, kind):
    return {"tumbling": lambda: win.TumblingEventTimeWindows.of(1000),
            "sliding": lambda: win.SlidingEventTimeWindows.of(2000, 1000),
            "session": lambda: win.EventTimeSessionWindows.with_gap(300)}[kind]()


def _events(keys, agg_name, n=3000, seed=3):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 60, n)
    ts = np.sort(rng.integers(0, 6000, n))
    if agg_name == "QuantileSketchAggregate":
        # values away from bucket edges (float32 logs may differ there)
        lg = tsk.QuantileSketchAggregate(**Q).log_gamma
        v = rng.lognormal(3.0, 1.0, 2 * n).astype(np.float32)
        x = np.log(v.astype(np.float64)) / lg
        vals = v[np.abs(x - np.round(x)) > 4 * np.abs(np.spacing(np.float32(x)))][:n]
        vals = vals.tolist()
    else:
        vals = rng.integers(1, 40, n).tolist()
    key_of = {"int": int, "uint": np.uint64, "str": lambda i: f"k{i}",
              "tuple": lambda i: (int(i), "x")}[keys]
    return [(key_of(a), b, int(c)) for a, b, c in zip(k, vals, ts)]


def _run(pkg, agg, events, assigner):
    ds, src, dwo = ((jds, jsrc, jdwo) if pkg == "jax" else (tds, tsrc, tdwo))
    agg.extract_value = lambda e: e[1]
    out = []
    env_kw = {} if pkg == "jax" else {"device": "cpu"}
    env = ds.StreamExecutionEnvironment.get_execution_environment(**env_kw)
    (env.from_collection(events)
        .assign_timestamps_and_watermarks(
            src.BoundedOutOfOrdernessTimestampExtractor(50, lambda e: e[2]))
        .key_by(lambda e: e[0]).window(assigner)
        .aggregate(agg, window_function=lambda k, w, vals: [
            (str(k), w.start, w.end, np.asarray(vals[0], np.float64).tolist())])
        .add_sink(src.CollectSink(out)))
    env.execute("tiers")
    return sorted(out)


@pytest.fixture
def picked(monkeypatch):
    """Engine class names the two packages' operators choose."""
    seen = {"jax": [], "torch": []}
    for pkg, cls in (("jax", jdwo.DeviceWindowOperator),
                     ("torch", tdwo.DeviceWindowOperator)):
        orig = cls._ensure_engine

        def wrapped(self, keys_arr, orig=orig, pkg=pkg):
            fresh = self.engine is None
            orig(self, keys_arr)
            if fresh:
                seen[pkg].append(type(self.engine).__name__)
        monkeypatch.setattr(cls, "_ensure_engine", wrapped)
    return seen


@pytest.mark.parametrize("keys, agg, assigner, engine, compare", ROWS,
                         ids=[f"{i}-{r[0]}-{r[1][0]}-{r[2]}"
                              for i, r in enumerate(ROWS)])
def test_tier_table_matches_reference(picked, keys, agg, assigner, engine, compare):
    events = _events(keys, agg[0])
    got = _run("torch", _make("torch", *agg), events, _assigner(twin, assigner))
    want = _run("jax", _make("jax", *agg), events, _assigner(jwin, assigner))
    assert set(picked["torch"]) == set(picked["jax"]) == {engine}
    assert len(got) > 50
    assert [r[:3] for r in got] == [r[:3] for r in want]
    g = np.array([r[3] for r in got], np.float64)
    w = np.array([r[3] for r in want], np.float64)
    if compare == "exact":
        np.testing.assert_array_equal(g, w)
    else:
        m = 1 << _make("torch", *agg).precision
        assert_hll_close(g, w, m)


# ---------------------------------------------------------------------
# operator-level cases, through each package's test harness
# ---------------------------------------------------------------------

def _harness_op(pkg, assigner_kind, agg, keys, wm=10_000):
    win, dwo, h = ((jwin, jdwo, jh) if pkg == "jax" else (twin, tdwo, th))
    kw = {} if pkg == "jax" else {"device": "cpu"}
    op = dwo.DeviceWindowOperator(_assigner(win, assigner_kind), agg, **kw)
    harness = h.OneInputStreamOperatorTestHarness(op, key_selector=lambda v: v,
                                                  **kw)
    harness.open()
    for i, k in enumerate(keys):
        harness.process_element(k, 100 + i)
    harness.process_watermark(wm)
    return op, harness


@pytest.mark.parametrize("keys, engine", [
    ([5, 7, 5], LOG), (["a", "b", "a"], LOG),
    ([(1, "x"), (2, "y"), (1, "x")], "VectorizedTumblingWindows")])
def test_engine_tier_selection_by_key_dtype(keys, engine):
    for pkg, agg in (("jax", jsk.HyperLogLogAggregate(8)),
                     ("torch", tsk.HyperLogLogAggregate(8))):
        op, _ = _harness_op(pkg, "tumbling", agg, keys)
        assert type(op.engine).__name__ == engine
        if isinstance(keys[0], str):
            assert op._interner is not None and op._interner.n == 2


def test_string_keys_emit_the_original_strings():
    rng = np.random.default_rng(5)
    words = [f"word{int(i)}" for i in rng.integers(0, 50, 4000)]
    ts = np.sort(rng.integers(0, 3000, 4000))
    events = [(w, 1.0, int(t)) for w, t in zip(words, ts)]
    out = {}
    for pkg, agg in (("jax", jagg.SumAggregate(np.int64)),
                     ("torch", tagg.SumAggregate(np.int64))):
        out[pkg] = _run(pkg, agg, events,
                        _assigner(jwin if pkg == "jax" else twin, "tumbling"))
    expect = collections.Counter((w, t - t % 1000) for w, _, t in events)
    assert out["torch"] == out["jax"]
    assert {(k, s): v for k, s, _, v in out["torch"]} == \
        {k: float(v) for k, v in expect.items()}
    assert all(k.startswith("word") for k, _, _, _ in out["torch"])


def test_string_sum_fused_engine_multi_flush(picked):
    """More records than flush_batch: every flush after the first keeps
    feeding the fused engine raw strings."""
    rng = np.random.default_rng(9)
    n = 30_000
    events = [(f"w{int(i)}", 1.0, int(t)) for i, t in
              zip(rng.integers(0, 40, n), np.sort(rng.integers(0, 2000, n)))]
    got = _run("torch", tagg.SumAggregate(np.float32), events,
               _assigner(twin, "tumbling"))
    want = _run("jax", jagg.SumAggregate(np.float32), events,
                _assigner(jwin, "tumbling"))
    assert picked["torch"] == picked["jax"] == [STRING_SUM]
    expect = collections.Counter((w, t - t % 1000) for w, _, t in events)
    assert got == want
    assert {(k, s): v for k, s, _, v in got} == dict(expect)


def test_lazy_engine_fast_forwards_watermark():
    for pkg, agg, win, dwo, h in (
            ("jax", jagg.SumAggregate(np.float64), jwin, jdwo, jh),
            ("torch", tagg.SumAggregate(np.float64), twin, tdwo, th)):
        kw = {} if pkg == "jax" else {"device": "cpu"}
        op = dwo.DeviceWindowOperator(win.TumblingEventTimeWindows.of(1000), agg,
                                      **kw)
        harness = h.OneInputStreamOperatorTestHarness(
            op, key_selector=lambda v: v, **kw)
        harness.open()
        harness.process_watermark(10_000)
        harness.process_element(5, 100)          # behind the watermark: late
        harness.process_watermark(11_000)
        assert harness.extract_output_values() == []
        assert op.num_late_records_dropped == 1
        assert type(op.engine).__name__ == LOG


def test_log_ineligible_params_fall_back_to_scatter_tier():
    """HLL precision 18 exceeds the log tier's u16 cells: integer keys
    run on the scatter tier in both packages."""
    outs = {}
    for pkg, agg in (("jax", jsk.HyperLogLogAggregate(18)),
                     ("torch", tsk.HyperLogLogAggregate(18))):
        op, harness = _harness_op(pkg, "tumbling", agg, [i % 5 for i in range(50)])
        assert type(op.engine).__name__ == "VectorizedTumblingWindows"
        outs[pkg] = harness.extract_output_values()
    assert len(outs["torch"]) == len(outs["jax"]) == 5
    assert_hll_close(outs["torch"], outs["jax"], 1 << 18)


@pytest.mark.parametrize("assigner_kind, agg_name, args", [
    ("tumbling", "SumAggregate", (np.float64,)),
    ("session", "CountMinSketchAggregate", (4, 64))])
def test_composite_integer_keys_stay_apart(picked, assigner_kind, agg_name, args):
    """Integer tuple keys are composite keys: the port keeps them off the
    log tier (which takes one integer column) and gives (1, 0) and
    (1, 1) their own windows, as the heap backend does.  (The JAX
    package sends such 2-D integer keys to its log tier, which merges
    them by their first column.)"""
    events = [((1, 0), 1.0, 10), ((1, 1), 1.0, 20), ((1, 1), 1.0, 30),
              ((2, 1), 1.0, 40)]
    got = _run("torch", getattr(tagg if agg_name == "SumAggregate" else tsk,
                                agg_name)(*args),
               events, _assigner(twin, assigner_kind))
    assert picked["torch"] == [{"tumbling": "VectorizedTumblingWindows",
                                "session": "VectorizedSessionWindows"}[assigner_kind]]
    assert {k: v for k, _, _, v in got} == {"[1 0]": 1.0, "[1 1]": 2.0,
                                            "[2 1]": 1.0}
