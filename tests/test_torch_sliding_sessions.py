"""The port's sliding and session window engines: the cases of
tests/test_vectorized_sliding_sessions.py on the port (against the
port's scalar WindowOperator on the heap backend, the semantics spec),
and each engine against the JAX engine on the same batches and
watermarks.

Emitted (key, result, start, end) compare per (key, window): Sum and
Count-Min totals exactly (integer data), HLL under
``torch_port_util.assert_hll_close``, quantiles with the same selected
bucket and values within rtol 1e-6 (the values are drawn away from
bucket boundaries, where float32 logs that differ by an ulp could
split them; see tests/test_torch_sketches.py).  Snapshots cross
between the packages mid-stream, both ways, and must give the
uninterrupted run's results."""

import functools

import numpy as np
import pytest

from flink_tpu.ops import device_agg as jd
from flink_tpu.ops import sketches as js
from flink_tpu.streaming.vectorized import VectorizedSlidingWindows as JaxSliding
from flink_tpu.streaming.vectorized_sessions import \
    VectorizedSessionWindows as JaxSessions
from flink_tpu_torch.core.state import AggregatingStateDescriptor
from flink_tpu_torch.ops import device_agg as td
from flink_tpu_torch.ops import sketches as ts
from flink_tpu_torch.streaming.harness import OneInputStreamOperatorTestHarness
from flink_tpu_torch.streaming.vectorized import VectorizedSlidingWindows
from flink_tpu_torch.streaming.vectorized_sessions import VectorizedSessionWindows
from flink_tpu_torch.streaming.window_operator import WindowOperator
from flink_tpu_torch.streaming.windowing import (EventTimeSessionWindows,
                                                 SlidingEventTimeWindows, Time)
from torch_port_util import assert_hll_close

Q3 = dict(quantiles=(0.5, 0.99), relative_accuracy=0.05, min_value=1e-3,
          max_value=1e6)


class _KVSum(td.SumAggregate):
    def __init__(self):
        super().__init__(np.float32)

    def extract_value(self, value):
        return value[1] if isinstance(value, tuple) else value


def scalar_window_results(assigner, agg, records, watermarks_at):
    """(key, value, ts) records through the port's WindowOperator on the
    heap backend, watermarks interleaved → sorted (key, result, start,
    end)."""
    def fn(key, window, elements):
        for v in elements:
            yield (key, float(v), window.start, window.end)

    op = WindowOperator(assigner, AggregatingStateDescriptor("diff", agg),
                        window_function=fn)
    h = OneInputStreamOperatorTestHarness(op, key_selector=lambda t: t[0],
                                          state_backend="heap")
    h.open()
    wm_iter = iter(watermarks_at)
    next_wm = next(wm_iter, None)
    for i, (k, v, t) in enumerate(records):
        if next_wm is not None and i == next_wm[0]:
            h.process_watermark(next_wm[1])
            next_wm = next(wm_iter, None)
        h.process_element((k, v), t)
    h.process_watermark(2**62)
    out = h.extract_output_values()
    h.close()
    return sorted((int(k), round(r, 2), s, e) for k, r, s, e in out)


def _sorted(emitted):
    return sorted((int(k), round(float(r), 2), s, e) for k, r, s, e in emitted)


# ---------------------------------------------------------------------
# the JAX package's cases, on the port
# ---------------------------------------------------------------------

def test_sliding_matches_window_operator_sum():
    rng = np.random.default_rng(11)
    n = 6000
    keys = rng.integers(0, 40, n)
    t = rng.integers(0, 20_000, n)
    vals = rng.random(n).astype(np.float32)
    size, slide = 5000, 1000
    runs = []
    for eng in (VectorizedSlidingWindows(_KVSum(), size, slide,
                                         initial_capacity=64, device="cpu"),
                JaxSliding(jd.SumAggregate(np.float32), size, slide,
                           initial_capacity=64)):
        half = n // 2
        eng.process_batch(keys[:half], t[:half], vals[:half])
        eng.advance_watermark(9_999)
        eng.process_batch(keys[half:], t[half:], vals[half:])
        eng.advance_watermark(2**62)
        runs.append(_sorted(eng.emitted))
    records = [(int(keys[i]), float(vals[i]), int(t[i])) for i in range(n)]
    want = scalar_window_results(
        SlidingEventTimeWindows.of(Time.milliseconds_of(size),
                                   Time.milliseconds_of(slide)),
        _KVSum(), records, [(n // 2, 9_999)])
    assert runs[0] == want == runs[1]


def test_sliding_pane_state_is_not_replicated():
    vec = VectorizedSlidingWindows(td.CountAggregate(), 10_000, 1000,
                                   initial_capacity=64, device="cpu")
    vec.process_batch(np.zeros(1000, np.int64), np.arange(1000))
    assert len(vec.windows) == 1
    assert vec.arena.high_water <= 2          # the key's slot (+ scratch)
    vec.advance_watermark(2**62)
    assert len(vec.emitted) == 10
    assert all(int(r) == 1000 for _, r, _, _ in vec.emitted)


def test_sliding_hll_merges_across_panes():
    vec = VectorizedSlidingWindows(ts.HyperLogLogAggregate(11), 4000, 1000,
                                   initial_capacity=32, device="cpu")
    users = np.arange(1000, dtype=np.uint64)
    for pane in range(4):
        vec.process_batch(np.zeros(1000, np.int64),
                          np.full(1000, pane * 1000 + 5), users)
    vec.advance_watermark(2**62)
    full = [r for _, r, s, e in vec.emitted if s == 0 and e == 4000]
    assert len(full) == 1
    assert abs(full[0] - 1000) / 1000 < 0.05


def test_sliding_rejects_unaligned():
    with pytest.raises(ValueError):
        VectorizedSlidingWindows(td.CountAggregate(), 5000, 1500, device="cpu")


def test_sliding_late_records_counted():
    vec = VectorizedSlidingWindows(td.CountAggregate(), 2000, 1000,
                                   device="cpu")
    vec.process_batch(np.array([1]), np.array([500]))
    vec.advance_watermark(2999)
    vec.process_batch(np.array([1, 1]), np.array([600, 3500]))
    assert vec.num_late_dropped == 1
    vec.advance_watermark(2**62)
    assert len(vec.emitted) == 4


def test_sessions_match_window_operator_sum():
    rng = np.random.default_rng(23)
    n = 4000
    keys = rng.integers(0, 25, n)
    t = (rng.integers(0, 40, n) * 1000 + rng.integers(0, 300, n)).astype(np.int64)
    vals = rng.random(n).astype(np.float32)
    gap, third = 700, n // 3
    runs = []
    for eng in (VectorizedSessionWindows(_KVSum(), gap, initial_capacity=64,
                                         device="cpu"),
                JaxSessions(jd.SumAggregate(np.float32), gap,
                            initial_capacity=64)):
        for lo, hi, wm in ((0, third, 12_000), (third, 2 * third, 25_000),
                           (2 * third, n, 2**62)):
            eng.process_batch(keys[lo:hi], t[lo:hi], vals[lo:hi])
            eng.advance_watermark(wm)
        runs.append(_sorted(eng.emitted))
    records = [(int(keys[i]), float(vals[i]), int(t[i])) for i in range(n)]
    want = scalar_window_results(
        EventTimeSessionWindows.with_gap(Time.milliseconds_of(gap)),
        _KVSum(), records, [(third, 12_000), (2 * third, 25_000)])
    assert runs[0] == want == runs[1]


def test_sessions_merge_within_and_across_batches():
    vec = VectorizedSessionWindows(td.CountAggregate(), 100, initial_capacity=16,
                                   device="cpu")
    vec.process_batch(np.array([7, 7]), np.array([0, 500]))
    assert sum(len(s) for s in vec.table.values()) == 2
    vec.process_batch(np.array([7]), np.array([250]))
    assert sum(len(s) for s in vec.table.values()) == 3
    vec.process_batch(np.array([7, 7]), np.array([80, 170]))
    sessions = [s for lst in vec.table.values() for s in lst]
    assert len(sessions) == 2
    merged = min(sessions, key=lambda s: s.start)
    assert (merged.start, merged.end) == (0, 350)
    vec.advance_watermark(2**62)
    got = sorted((int(r), s, e) for _, r, s, e in vec.emitted)
    assert got == [(1, 500, 600), (4, 0, 350)]


def test_sessions_hll_distinct_across_merge():
    vec = VectorizedSessionWindows(ts.HyperLogLogAggregate(11), 1000,
                                   initial_capacity=16, device="cpu")
    users = np.arange(2000, dtype=np.uint64)
    vec.process_batch(np.zeros(1000, np.int64), np.full(1000, 0), users[:1000])
    vec.process_batch(np.zeros(1500, np.int64), np.full(1500, 500),
                      users[500:2000])
    vec.advance_watermark(2**62)
    assert len(vec.emitted) == 1
    _, est, s, e = vec.emitted[0]
    assert (s, e) == (0, 1500)
    assert abs(est - 2000) / 2000 < 0.05


def test_sessions_late_drop_and_post_merge_leniency():
    vec = VectorizedSessionWindows(td.CountAggregate(), 100, device="cpu")
    vec.process_batch(np.array([1]), np.array([1000]))
    vec.advance_watermark(500)
    vec.process_batch(np.array([1]), np.array([100]))
    assert vec.num_late_dropped == 1
    vec.process_batch(np.array([1]), np.array([950]))
    assert vec.num_late_dropped == 1
    vec.advance_watermark(2**62)
    assert [(int(r), s, e) for _, r, s, e in vec.emitted] == [(2, 950, 1100)]


def test_sessions_slot_reuse():
    vec = VectorizedSessionWindows(td.CountAggregate(), 100, initial_capacity=8,
                                   device="cpu")
    for round_i in range(20):
        base = round_i * 10_000
        vec.process_batch(np.arange(4), np.full(4, base))
        vec.advance_watermark(base + 5000)
    assert len(vec.emitted) == 80
    assert vec.capacity <= 16


# ---------------------------------------------------------------------
# each engine against the JAX engine, per aggregate
# ---------------------------------------------------------------------

def _off_boundary(v, agg):
    """Drop values whose float64 log(v) / log(gamma) lies within 4
    float32 ulps of an integer (see tests/test_torch_sketches.py)."""
    x = np.log(v.astype(np.float64)) / agg.log_gamma
    ulp = np.abs(np.spacing(np.float32(x)).astype(np.float64))
    return np.abs(x - np.round(x)) > 4 * ulp


def _make(kind, pkg):
    m = {"sum": (td, jd), "hll": (ts, js), "quantile": (ts, js),
         "countmin": (ts, js)}[kind][pkg == "jax"]
    if kind == "sum":
        return m.SumAggregate(np.float64)
    if kind == "hll":
        return m.HyperLogLogAggregate(8)
    if kind == "quantile":
        return m.QuantileSketchAggregate(**Q3)
    return m.CountMinSketchAggregate(4, 64)


def _steps(kind, engine, seed=3, n_batches=12, n=500):
    """(keys, ts, values, watermark-after) steps: time moves forward a
    second per batch with stragglers (some late), the key count grows
    so state grows, and some batches end with a watermark."""
    rng = np.random.default_rng(seed)
    probe = _make("quantile", "torch")
    steps = []
    for b in range(n_batches):
        k = rng.integers(0, 20 + 15 * b, n)
        t = b * 1000 + rng.integers(-1500, 1500, n)
        t[:7] -= 4000                                 # late stragglers
        if kind == "quantile":
            v = rng.lognormal(3.0, 1.0, 4 * n).astype(np.float32)
            v = v[_off_boundary(v, probe)][:n]
        elif kind == "sum":
            v = rng.integers(-50, 50, n).astype(np.float64)
        else:
            v = rng.integers(1, 40, n)
        wm = b * 1000 - 1200 if b % 3 == 2 else None
        if engine == "sessions":
            t = b * 700 + rng.integers(0, 2500, n) * (rng.random(n) < 0.5)
            t[:7] -= 3000                             # late stragglers
            wm = b * 700 - 900 if b % 3 == 2 else None
        steps.append((k, np.maximum(t, 0), v, wm))
    return steps


def _engine(engine, kind, pkg):
    agg = _make(kind, pkg)
    kw = {} if pkg == "jax" else {"device": "cpu"}
    if engine == "sliding":
        cls = JaxSliding if pkg == "jax" else VectorizedSlidingWindows
        return cls(agg, 3000, 1000, initial_capacity=16, **kw)
    cls = JaxSessions if pkg == "jax" else VectorizedSessionWindows
    return cls(agg, 300, initial_capacity=16, **kw)


def _drive(eng, steps, snapshot_at=None, into=None):
    for i, (k, t, v, wm) in enumerate(steps):
        eng.process_batch(k, t, v)
        if wm is not None:
            eng.advance_watermark(wm)
        if i == snapshot_at:
            emitted = eng.emitted
            snap = eng.snapshot()
            eng = into
            eng.restore(snap)
            eng.emitted = emitted
    eng.advance_watermark(2**62)
    return eng


def _results(eng):
    out = {}
    for k, r, s, e in eng.emitted:
        assert (int(k), s, e) not in out
        out[(int(k), s, e)] = np.asarray(r, np.float64)
    return out


def _assert_same(kind, got, want):
    assert got.keys() == want.keys() and len(got) > 100
    keys = sorted(want)
    g = np.array([got[x] for x in keys])
    w = np.array([want[x] for x in keys])
    if kind == "hll":
        assert_hll_close(g, w, 1 << 8)
    elif kind == "quantile":
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
        assert (g > 0).all()
    else:
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("engine,kind", [
    ("sliding", "sum"), ("sliding", "hll"), ("sliding", "quantile"),
    ("sessions", "sum"), ("sessions", "hll"), ("sessions", "countmin")])
def test_engine_matches_jax(engine, kind):
    steps = _steps(kind, engine)
    got = _drive(_engine(engine, kind, "torch"), steps)
    want = _drive(_engine(engine, kind, "jax"), steps)
    _assert_same(kind, _results(got), _results(want))
    assert got.num_late_dropped == want.num_late_dropped > 0
    assert got.capacity == want.capacity > 16        # state grew
    assert got._scratch_slot_id == want._scratch_slot_id is not None


@functools.lru_cache(maxsize=None)
def _uninterrupted(engine, kind):
    return _results(_drive(_engine(engine, kind, "jax"), _steps(kind, engine, seed=5)))


@pytest.mark.parametrize("src,dst", [("torch", "jax"), ("jax", "torch")])
@pytest.mark.parametrize("engine,kind", [("sliding", "quantile"),
                                         ("sessions", "countmin")])
def test_snapshots_restore_across_packages(engine, kind, src, dst):
    crossed = _drive(_engine(engine, kind, src), _steps(kind, engine, seed=5),
                     snapshot_at=5, into=_engine(engine, kind, dst))
    _assert_same(kind, _results(crossed), _uninterrupted(engine, kind))
