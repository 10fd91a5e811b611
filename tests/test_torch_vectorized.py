"""The port's VectorizedTumblingWindows against the JAX one: the same
batches and watermarks go to both engines and the fired results must
agree per (key, window) — slot numbers may differ (the JAX engine may
use its native index), results may not.  Registers, counts and
integer-valued sums are exact; HLL estimates within rtol 1e-5.

The scenario covers several live windows, late records, state growth
mid-stream (a small initial capacity), slot reuse after fires, and all
three fire forms: full-arena, contiguous tile and gather (a small
FIRE_TILE reaches the last two).  (HLL tolerance: see
tests/torch_port_util.py.)  Snapshots cross between the
packages mid-stream and must equal an uninterrupted run."""

import numpy as np
import pytest

from flink_tpu.ops import device_agg as jd
from flink_tpu.ops import sketches as js
from flink_tpu.streaming.vectorized import VectorizedTumblingWindows as JaxEngine
from flink_tpu_torch.ops import device_agg as td
from flink_tpu_torch.ops import sketches as ts
from flink_tpu_torch.streaming.vectorized import VectorizedTumblingWindows as TorchEngine
from torch_port_util import assert_hll_close

SIZE = 100

AGGS = [
    ("hll", lambda m: m.HyperLogLogAggregate(10)),
    ("sum_f64", lambda m: m.SumAggregate(np.float64)),
    ("count", lambda m: m.CountAggregate()),
    ("min_i32", lambda m: m.MinAggregate(np.int32)),
    ("max_f32", lambda m: m.MaxAggregate(np.float32)),
    ("avg", lambda m: m.AvgAggregate()),
]


def _module(pkg, name):
    if name == "hll":
        return js if pkg == "jax" else ts
    return jd if pkg == "jax" else td


def _script(seed=0, n_batches=14):
    """(keys, ts, values, watermark-after) steps: windows advance one
    by one with overlap, stragglers go late, key counts rise so state
    grows, then shrink so freed slots are reused."""
    rng = np.random.default_rng(seed)
    steps = []
    for b in range(n_batches):
        n_keys = 40 + 30 * min(b, 6) - 20 * max(0, b - 9)
        n = 400
        base = (b // 2) * SIZE
        keys = rng.integers(0, n_keys, n)
        t = base + rng.integers(-SIZE // 2, 2 * SIZE, n)
        t[:5] = base - 3 * SIZE                 # late once the watermark passes
        vals = rng.integers(-100, 100, n)
        wm = base + SIZE // 2 - 1 if b % 2 else None
        steps.append((keys, t, vals, wm))
    # drain, then one window alone owning most of the arena: the full
    # fire form
    last = (n_batches // 2 + 2) * SIZE
    steps.append((None, None, None, last - 1))
    keys = np.arange(400)
    steps.append((keys, last + keys % SIZE, rng.integers(-100, 100, 400), None))
    steps.append((None, None, None, 2**62))
    return steps


def _run(engine, steps):
    for keys, t, vals, wm in steps:
        if keys is not None:
            engine.process_batch(keys, t, vals)
        if wm is not None:
            engine.flush()
            engine.advance_watermark(wm)
    return {(int(k), s): r for k, r, s, _ in engine.emitted}


def _engines(name, capacity=16, tile=16):
    jagg = AGGS[[a[0] for a in AGGS].index(name)][1](_module("jax", name))
    tagg = AGGS[[a[0] for a in AGGS].index(name)][1](_module("torch", name))
    je = JaxEngine(jagg, SIZE, initial_capacity=capacity, microbatch=256)
    te = TorchEngine(tagg, SIZE, initial_capacity=capacity, microbatch=256,
                     device="cpu")
    je.FIRE_TILE = te.FIRE_TILE = tile
    return je, te


def _assert_same(got, want, name):
    assert got.keys() == want.keys()
    g = np.array([got[k] for k in sorted(want)], np.float64)
    w = np.array([want[k] for k in sorted(want)], np.float64)
    if name == "hll":
        assert_hll_close(g, w, 1 << 10)
    else:
        np.testing.assert_array_equal(g, w)


class _FormSpy:
    """Counts which fire form the port's engine took."""

    def __init__(self, engine):
        self.forms = {"full": 0, "tile": 0, "gather": 0}
        agg = engine.agg
        dense, gather = agg.result_dense, agg.result

        def result_dense(state):
            n = next(iter(state.values())).shape[0]
            self.forms["full" if n == engine.capacity else "tile"] += 1
            return dense(state)

        def result(state, slots):
            self.forms["gather"] += 1
            return gather(state, slots)
        agg.result_dense, agg.result = result_dense, result


@pytest.mark.parametrize("name", [a[0] for a in AGGS])
def test_engine_matches_jax_per_key_window(name):
    je, te = _engines(name)
    spy = _FormSpy(te)
    steps = _script()
    want = _run(je, steps)
    got = _run(te, steps)
    _assert_same(got, want, name)
    assert te.num_late_dropped == je.num_late_dropped > 0
    assert te.capacity > 16                              # grew mid-stream
    assert all(v > 0 for v in spy.forms.values()), spy.forms
    assert te.arena.high_water < sum(len(s[0]) for s in steps if s[0] is not None)


@pytest.mark.parametrize("name", ["hll", "sum_f64"])
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_snapshot_crosses_packages_mid_stream(name, direction):
    steps = _script(seed=3)
    cut = 7
    ref_engine, _ = _engines(name)
    want = _run(ref_engine, steps)
    je, te = _engines(name)
    first, second = (je, te) if direction == "jax_to_torch" else (te, je)
    part1 = _run(first, steps[:cut])
    second.restore(first.snapshot())
    part2 = _run(second, steps[cut:])
    assert not part1.keys() & part2.keys()
    _assert_same({**part1, **part2}, want, name)


def test_emit_arrays_and_callback_forms_agree():
    steps = _script(seed=5)
    _, te = _engines("count")
    want = _run(te, steps)
    _, arr = _engines("count")
    arr.emit_arrays = True
    _run(arr, steps)
    got = {(int(k), s): r for ks, rs, s, _ in arr.fired for k, r in zip(ks, rs.tolist())}
    assert got == want
    _, cb = _engines("count")
    seen = {}
    cb.emit = lambda k, r, s, e: seen.__setitem__((int(k), s), r)
    _run(cb, steps)
    assert seen == want
