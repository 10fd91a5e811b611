"""The port's log-structured window engines against the JAX package's
(tests/test_log_windows.py's cases, each run through both packages on
the same numpy inputs).

With ``finish_tier="host"`` both fire through the same C++, so results
are bit-equal.  The port's ``"device"`` finish (``hll_log_finish``,
its plain version on the CPU) equals the host finish bit for bit (its
float64 segment sums are exact, its division is a true one and its
logs come from the C library's ``log``), and the JAX device finish
within rel 1e-3, the JAX package's own bound for its float32 cumsum.
Snapshots restore across the packages in both directions."""

import numpy as np
import pytest

from flink_tpu.ops.device_agg import SumAggregate as JSum
from flink_tpu.ops.sketches import CountMinSketchAggregate as JCountMin
from flink_tpu.ops.sketches import HyperLogLogAggregate as JHll
from flink_tpu.ops.sketches import QuantileSketchAggregate as JQuantile
from flink_tpu.streaming import log_windows as jlw
from flink_tpu.streaming.vectorized import hash_keys_np
from flink_tpu_torch.ops.device_agg import SumAggregate as TSum
from flink_tpu_torch.ops.sketches import CountMinSketchAggregate as TCountMin
from flink_tpu_torch.ops.sketches import HyperLogLogAggregate as THll
from flink_tpu_torch.ops.sketches import QuantileSketchAggregate as TQuantile
from flink_tpu_torch.streaming import log_windows as tlw
from flink_tpu_torch.streaming.vectorized import (VectorizedSlidingWindows,
                                                  VectorizedTumblingWindows)
from flink_tpu_torch.streaming.vectorized_sessions import VectorizedSessionWindows
from torch_port_util import assert_hll_close

Q = dict(quantiles=(0.5, 0.99), relative_accuracy=0.05, min_value=1e-3,
         max_value=1e6)


def synth(n, n_keys, t_span, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n_keys, n).astype(np.uint64)
    ts = np.sort(rng.integers(0, t_span, n).astype(np.int64))
    users = rng.integers(0, 2 ** 63, n).astype(np.uint64)
    return keys, ts, users


def fire_map(emitted):
    return {(int(k), s): float(r) for k, r, s, e in emitted}


def window_map(emitted):
    return {(int(k), s, e): np.asarray(r).tolist() for k, r, s, e in emitted}


def tumbling(jagg, tagg, size=1000, **kw):
    """The JAX engine and the port's (on the CPU), host finish unless
    the caller asks for another."""
    kw.setdefault("finish_tier", "host")
    return (jlw.LogStructuredTumblingWindows(jagg, size, **kw),
            tlw.LogStructuredTumblingWindows(tagg, size, device="cpu", **kw))


def test_hll_log_matches_reference_and_scatter_engine():
    keys, ts, users = synth(20_000, 700, 5000, seed=3)
    vh = hash_keys_np(users)
    j, t = tumbling(JHll(10), THll(10))
    for eng in (j, t):
        eng.process_batch(keys, ts, None, value_hashes=vh)
        eng.advance_watermark(10_000)
    got = fire_map(t.emitted)
    assert got == fire_map(j.emitted)
    # against the port's scatter engine: one semantics, two mechanisms
    vec = VectorizedTumblingWindows(THll(10), 1000, initial_capacity=2048,
                                    device="cpu")
    vec.process_batch(keys, ts, None, key_hashes=keys, value_hashes=vh)
    vec.flush()
    vec.advance_watermark(10_000)
    want = fire_map(vec.emitted)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-3)


def test_sum_log_exact_counts():
    n = 50_000
    keys, ts, _ = synth(n, 300, 3000, seed=5)
    j, t = tumbling(JSum(np.float64), TSum(np.float64))
    for eng in (j, t):
        eng.process_batch(keys, ts, np.ones(n))
        eng.advance_watermark(10_000)
    want = {}
    for k, s in zip(keys.tolist(), ts.tolist()):
        want[(k, s - s % 1000)] = want.get((k, s - s % 1000), 0) + 1
    assert fire_map(t.emitted) == fire_map(j.emitted) == want


def test_late_records_dropped():
    for eng in tumbling(JSum(np.float64), TSum(np.float64)):
        eng.process_batch(np.array([1, 2], np.uint64), np.array([100, 900]),
                          np.ones(2))
        assert eng.advance_watermark(999) == 2
        eng.process_batch(np.array([3], np.uint64), np.array([500]), np.ones(1))
        assert eng.num_late_dropped == 1
        eng.process_batch(np.array([4], np.uint64), np.array([1500]), np.ones(1))
        assert eng.advance_watermark(2000) == 1


def test_device_finish_matches_host_finish():
    keys, ts, users = synth(30_000, 500, 2000, seed=7)
    vh = hash_keys_np(users)
    engines = {
        "jax_host": jlw.LogStructuredTumblingWindows(JHll(12), 1000, finish_tier="host"),
        "jax_device": jlw.LogStructuredTumblingWindows(JHll(12), 1000,
                                                       finish_tier="device"),
        "host": tlw.LogStructuredTumblingWindows(THll(12), 1000, finish_tier="host",
                                                 device="cpu"),
        "device": tlw.LogStructuredTumblingWindows(THll(12), 1000,
                                                   finish_tier="device", device="cpu"),
    }
    for eng in engines.values():
        eng.process_batch(keys, ts, None, value_hashes=vh)
        eng.advance_watermark(5000)
    got = {name: fire_map(e.emitted) for name, e in engines.items()}
    assert got["host"] == got["jax_host"]
    k = sorted(got["host"])
    host = np.array([got["host"][x] for x in k])
    dev = np.array([got["device"][x] for x in k])
    np.testing.assert_array_equal(dev, host)
    np.testing.assert_allclose(dev, [got["jax_device"][x] for x in k], rtol=1e-3)
    assert set(got["device"]) == set(got["jax_device"])


def test_auto_finish_is_host_on_the_cpu():
    _, t = tumbling(JHll(8), THll(8), finish_tier="auto")
    assert t.mode.finish_tier == "host"


def test_compaction_preserves_results():
    n = 40_000
    keys, ts, users = synth(n, 200, 900, seed=9)   # one window
    vh = hash_keys_np(users)
    runs = {}
    for threshold in (64 << 20, 1000):
        pair = tumbling(JHll(10), THll(10), compact_threshold=threshold)
        for eng in pair:
            for i in range(0, n, 4096):
                sl = slice(i, i + 4096)
                eng.process_batch(keys[sl], ts[sl], None, value_hashes=vh[sl])
            eng.advance_watermark(2000)
            assert eng.windows == {}
        assert fire_map(pair[0].emitted) == fire_map(pair[1].emitted)
        runs[threshold] = fire_map(pair[1].emitted)
    a, b = runs.values()
    assert set(a) == set(b)
    for k in a:
        assert b[k] == pytest.approx(a[k], rel=1e-6)


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_snapshot_restore_mid_window_across_packages(direction):
    n = 20_000
    keys, ts, users = synth(n, 150, 1800, seed=11)
    vh = hash_keys_np(users)
    ref = jlw.LogStructuredTumblingWindows(JHll(10), 1000, finish_tier="host")
    ref.process_batch(keys, ts, None, value_hashes=vh)
    ref.advance_watermark(3000)
    half = n // 2
    j, t = tumbling(JHll(10), THll(10))
    src, dst = (j, t) if direction == "jax_to_torch" else (t, j)
    src.process_batch(keys[:half], ts[:half], None, value_hashes=vh[:half])
    dst.restore(src.snapshot())
    dst.process_batch(keys[half:], ts[half:], None, value_hashes=vh[half:])
    dst.advance_watermark(3000)
    assert fire_map(dst.emitted) == fire_map(ref.emitted)


def test_non_integer_keys_rejected():
    for eng in tumbling(JSum(np.float64), TSum(np.float64)):
        with pytest.raises(TypeError):
            eng.process_batch(np.array(["a", "b"], dtype=object),
                              np.array([1, 2]), np.ones(2))


# ---------------------------------------------------------------------
# sliding / session log engines
# ---------------------------------------------------------------------

def sliding(jagg, tagg, size, slide):
    return (jlw.LogStructuredSlidingWindows(jagg, size, slide, finish_tier="host"),
            tlw.LogStructuredSlidingWindows(tagg, size, slide, finish_tier="host",
                                            device="cpu"))


def test_sliding_sum_log_matches_reference_and_vectorized():
    n = 30_000
    keys, ts, _ = synth(n, 400, 8000, seed=13)
    j, t = sliding(JSum(np.float64), TSum(np.float64), 3000, 1000)
    for eng in (j, t):
        eng.process_batch(keys, ts, np.ones(n))
        eng.advance_watermark(20_000)
    vec = VectorizedSlidingWindows(TSum(np.float64), 3000, 1000,
                                   initial_capacity=4096, device="cpu")
    vec.process_batch(keys, ts, np.ones(n), key_hashes=keys)
    vec.advance_watermark(20_000)
    assert window_map(t.emitted) == window_map(j.emitted) == window_map(vec.emitted)


def test_sliding_sum_log_incremental_watermarks():
    n = 30_000
    keys, ts, _ = synth(n, 250, 9000, seed=15)
    ref_j, ref_t = sliding(JSum(np.float64), TSum(np.float64), 3000, 1000)
    for eng in (ref_j, ref_t):
        eng.process_batch(keys, ts, np.ones(n))
        eng.advance_watermark(20_000)
    j, t = sliding(JSum(np.float64), TSum(np.float64), 3000, 1000)
    for eng in (j, t):
        for i in range(0, n, 5000):
            sl = slice(i, i + 5000)
            eng.process_batch(keys[sl], ts[sl], np.ones(len(keys[sl])))
            eng.advance_watermark(int(ts[sl][-1]) - 1)
        eng.advance_watermark(20_000)
    assert window_map(t.emitted) == window_map(j.emitted) \
        == window_map(ref_t.emitted) == window_map(ref_j.emitted)


def test_sliding_quantile_log_matches_reference_and_vectorized():
    n = 20_000
    rng = np.random.default_rng(17)
    keys = rng.integers(0, 50, n).astype(np.uint64)
    ts = np.sort(rng.integers(0, 4000, n).astype(np.int64))
    vals = rng.lognormal(3.0, 1.0, n).astype(np.float32)
    j, t = sliding(JQuantile(**Q), TQuantile(**Q), 2000, 1000)
    for eng in (j, t):
        eng.process_batch(keys, ts, vals)
        eng.advance_watermark(10_000)
    got = window_map(t.emitted)
    assert got == window_map(j.emitted)
    vec = VectorizedSlidingWindows(TQuantile(**Q), 2000, 1000,
                                   initial_capacity=2048, device="cpu")
    vec.process_batch(keys, ts, vals, key_hashes=keys)
    vec.advance_watermark(10_000)
    want = window_map(vec.emitted)
    assert set(got) == set(want)
    # float32 bucketing on both tiers; a value on a bucket edge may land
    # one bucket over (~2 x the relative accuracy)
    for k in want:
        assert np.allclose(got[k], want[k], rtol=0.12), (k, got[k], want[k])


def sessions(jagg, tagg, gap):
    return (jlw.LogStructuredSessionWindows(jagg, gap),
            tlw.LogStructuredSessionWindows(tagg, gap, device="cpu"))


def test_session_log_matches_reference_and_vectorized():
    n = 25_000
    rng = np.random.default_rng(19)
    keys = rng.integers(0, 300, n).astype(np.uint64)
    ts = np.sort(rng.integers(0, 60_000, n).astype(np.int64))
    vh = hash_keys_np(rng.integers(0, 2 ** 63, n).astype(np.uint64))
    j, t = sessions(JCountMin(4, 64), TCountMin(4, 64), 500)
    vec = VectorizedSessionWindows(TCountMin(4, 64), 500, initial_capacity=4096,
                                   device="cpu")
    for eng in (j, t, vec):
        for i in range(0, n, 5000):
            sl = slice(i, i + 5000)
            eng.process_batch(keys[sl], ts[sl], np.ones(len(keys[sl]), np.float32),
                              key_hashes=keys[sl], value_hashes=vh[sl])
            if hasattr(eng, "flush"):
                eng.flush()
            eng.advance_watermark(int(ts[sl][-1]) - 1)
        eng.advance_watermark(200_000)
    got = {(int(k), s, e): int(r) for k, r, s, e in t.emitted}
    assert got == {(int(k), s, e): int(r) for k, r, s, e in j.emitted}
    assert got == {(int(k), s, e): int(r) for k, r, s, e in vec.emitted}


def test_session_abutting_events_merge():
    for eng in sessions(JCountMin(2, 32), TCountMin(2, 32), 1000):
        eng.process_batch(np.array([7, 7], np.uint64), np.array([0, 1000], np.int64),
                          np.ones(2, np.float32),
                          value_hashes=np.array([11, 12], np.uint64))
        eng.advance_watermark(10_000)
        assert [(int(k), int(r), s, e) for k, r, s, e in eng.emitted] == \
            [(7, 2, 0, 2000)]


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_session_log_snapshot_restore_across_packages(direction):
    n = 8000
    rng = np.random.default_rng(23)
    keys = rng.integers(0, 100, n).astype(np.uint64)
    ts = np.sort(rng.integers(0, 20_000, n).astype(np.int64))
    vh = rng.integers(0, 2 ** 63, n).astype(np.uint64)
    ref = jlw.LogStructuredSessionWindows(JCountMin(2, 32), 400)
    ref.process_batch(keys, ts, np.ones(n, np.float32), value_hashes=vh)
    ref.advance_watermark(50_000)
    j, t = sessions(JCountMin(2, 32), TCountMin(2, 32), 400)
    src, dst = (j, t) if direction == "jax_to_torch" else (t, j)
    src.process_batch(keys[:4000], ts[:4000], np.ones(4000, np.float32),
                      value_hashes=vh[:4000])
    src.advance_watermark(int(ts[3999]) - 1)     # retained open sessions
    dst.restore(src.snapshot())
    dst.process_batch(keys[4000:], ts[4000:], np.ones(4000, np.float32),
                      value_hashes=vh[4000:])
    dst.advance_watermark(50_000)
    assert sorted(map(tuple, src.emitted + dst.emitted)) == \
        sorted(map(tuple, ref.emitted))


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_sliding_snapshot_preserves_fired_horizon(direction):
    keys = np.array([1, 1, 1, 1, 1], np.uint64)
    ts = np.array([500, 1500, 2500, 3500, 4500], np.int64)
    j, t = sliding(JSum(np.float64), TSum(np.float64), 3000, 1000)
    src, dst = (j, t) if direction == "jax_to_torch" else (t, j)
    src.process_batch(keys, ts, np.ones(5))
    src.advance_watermark(4999)
    fired_before = {(s, e) for _, _, s, e in src.emitted}
    dst.restore(src.snapshot())
    dst.advance_watermark(7999)
    assert not {(s, e) for _, _, s, e in dst.emitted} & fired_before
    ref = jlw.LogStructuredSlidingWindows(JSum(np.float64), 3000, 1000)
    ref.process_batch(keys, ts, np.ones(5))
    ref.advance_watermark(4999)
    ref.emitted.clear()
    ref.advance_watermark(7999)
    assert sorted(map(tuple, dst.emitted)) == sorted(map(tuple, ref.emitted))


def test_sum_dense_table_spill_to_log():
    import flink_tpu_torch.native as tn
    rng = np.random.default_rng(29)
    keys = rng.integers(0, 5000, 40_000).astype(np.uint64)
    keys[:10] = 0
    vals = rng.random(40_000)
    states = {(pkg, cap): mod._SumTabLog(max_distinct=cap)
              for pkg, mod in (("jax", jlw), ("torch", tlw))
              for cap in (1 << 16, 1 << 10)}
    for st in states.values():
        for i in range(0, 40_000, 4096):
            st.append(keys[i:i + 4096], vals[i:i + 4096])
    for pkg in ("jax", "torch"):
        assert states[(pkg, 1 << 10)].log is not None
        assert states[(pkg, 1 << 16)].log is None
    want = {}
    for k, v in zip(keys.tolist(), vals.tolist()):
        want[k] = want.get(k, 0.0) + v
    for cap in (1 << 16, 1 << 10):
        tk, (tv,) = states[("torch", cap)].concat()
        jk, (jv,) = states[("jax", cap)].concat()
        np.testing.assert_array_equal(tk, jk)
        np.testing.assert_array_equal(tv, jv)
        got_k, got_v = tn.sum_log_fire(tk, tv)
        got = dict(zip(got_k.tolist(), got_v.tolist()))
        assert set(got) == set(want)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-9)


def test_sum_key_zero_and_sentinel_distinct():
    sentinel = 0x9E3779B97F4A7C15
    for eng in tumbling(JSum(np.float64), TSum(np.float64)):
        eng.process_batch(np.array([0, sentinel, 0], np.uint64),
                          np.array([10, 20, 30], np.int64),
                          np.array([1.0, 10.0, 100.0]))
        eng.advance_watermark(5000)
        got = {int(k): float(r) for k, r, s, e in eng.emitted}
        assert got == {0: 101.0, sentinel: 10.0}


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_signed_negative_keys_roundtrip(direction):
    keys = np.array([-5, 3, -5, -(2 ** 62)], np.int64)
    ts, vals = np.array([10, 20, 30, 40]), np.array([1.0, 2.0, 4.0, 8.0])
    for eng in tumbling(JSum(np.float64), TSum(np.float64)):
        eng.process_batch(keys, ts, vals)
        eng.advance_watermark(5000)
        assert {int(k): float(r) for k, r, s, e in eng.emitted} == \
            {-5: 5.0, 3: 2.0, -(2 ** 62): 8.0}
    j, t = tumbling(JSum(np.float64), TSum(np.float64))
    src, dst = (j, t) if direction == "jax_to_torch" else (t, j)
    src.process_batch(keys, ts, vals)
    dst.restore(src.snapshot())
    dst.advance_watermark(5000)
    assert {int(k): float(r) for k, r, s, e in dst.emitted} == \
        {-5: 5.0, 3: 2.0, -(2 ** 62): 8.0}


def test_quantile_log_compaction_exact_and_bounded():
    rng = np.random.default_rng(8)
    n, n_keys = 200_000, 40
    keys = rng.integers(0, n_keys, n).astype(np.int64)
    ts = np.sort(rng.integers(0, 1000, n)).astype(np.int64)
    vals = rng.gamma(2.0, 25.0, n)

    def run(pkg, threshold):
        mod, make = ((jlw, JQuantile) if pkg == "jax" else (tlw, TQuantile))
        kw = {} if pkg == "jax" else {"device": "cpu"}
        eng = mod.LogStructuredTumblingWindows(
            make(quantiles=(0.5, 0.9, 0.99)), 1000,
            compact_threshold=threshold, **kw)
        half = n // 2
        eng.process_batch(keys[:half], ts[:half], vals[:half])
        max_cells = max((lg.count for lg in eng.windows.values()), default=0)
        eng.process_batch(keys[half:], ts[half:], vals[half:])
        eng.advance_watermark(10_000)
        return ({(int(k), int(s)): tuple(np.asarray(v).tolist())
                 for k, v, s, _ in eng.emitted}, max_cells)

    got, cells_small = run("torch", 10_000)      # compacts repeatedly
    want, _ = run("torch", 1 << 30)              # never compacts
    assert got == run("jax", 10_000)[0]
    assert want == run("jax", 1 << 30)[0]
    assert {k: np.round(v, 9).tolist() for k, v in got.items()} == \
        {k: np.round(v, 9).tolist() for k, v in want.items()}
    assert len(got) == n_keys
    assert cells_small <= 2 * n_keys * TQuantile(quantiles=(0.5,)).buckets


def test_quantile_snapshot_upgrades_old_single_column_logs():
    keys = np.arange(50, dtype=np.int64) % 5
    ts = np.zeros(50, np.int64)
    vals = np.linspace(1.0, 100.0, 50)
    j = jlw.LogStructuredTumblingWindows(JQuantile(quantiles=(0.5,)), 1000)
    t = tlw.LogStructuredTumblingWindows(TQuantile(quantiles=(0.5,)), 1000,
                                         device="cpu")
    for eng in (j, t):
        eng.process_batch(keys, ts, vals)
    snap = j.snapshot()
    for chunk in snap["windows"].values():      # the old single-column format
        payload = getattr(chunk, "payload", chunk)
        payload["cols"] = [payload["cols"][0]]
    restored = tlw.LogStructuredTumblingWindows(TQuantile(quantiles=(0.5,)), 1000,
                                                device="cpu")
    restored.restore(snap)
    for e in (j, t, restored):
        e.advance_watermark(10_000)
    got = {(int(k), int(s)): tuple(v) for k, v, s, _ in restored.emitted}
    assert got == {(int(k), int(s)): tuple(v) for k, v, s, _ in t.emitted} \
        == {(int(k), int(s)): tuple(v) for k, v, s, _ in j.emitted}
    assert len(got) == 5


# ---------------------------------------------------------------------
# the string-keyed fused sum
# ---------------------------------------------------------------------

@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_string_sum_matches_reference_and_snapshots_cross(direction):
    rng = np.random.default_rng(31)
    n = 20_000
    words = np.array([f"w{i}" for i in rng.integers(0, 300, n)])
    ts = np.sort(rng.integers(0, 3000, n)).astype(np.int64)
    vals = rng.random(n)
    j = jlw.StringSumTumblingWindows(JSum(np.float64), 1000)
    t = tlw.StringSumTumblingWindows(TSum(np.float64), 1000, device="cpu")
    for eng in (j, t):
        eng.process_batch(words[: n // 2], ts[: n // 2], vals[: n // 2])
    src = j if direction == "jax_to_torch" else t
    dst = (tlw.StringSumTumblingWindows(TSum(np.float64), 1000, device="cpu")
           if src is j else jlw.StringSumTumblingWindows(JSum(np.float64), 1000))
    dst.restore(src.snapshot())
    for eng in (j, t, dst):
        eng.process_batch(words[n // 2:], ts[n // 2:], vals[n // 2:])
        eng.advance_watermark(10_000)
    want = {(k, s): float(r) for k, r, s, e in j.emitted}
    assert {(k, s): float(r) for k, r, s, e in t.emitted} == want
    assert {(k, s): float(r) for k, r, s, e in dst.emitted} == want


def test_hll_log_results_close_to_numpy_hll():
    """The log tier's estimates against the HLL the scatter tier's
    registers give (assert_hll_close: the scatter estimate is float32)."""
    keys, ts, users = synth(8000, 40, 900, seed=37)
    vh = hash_keys_np(users)
    _, t = tumbling(JHll(8), THll(8))
    t.process_batch(keys, ts, None, value_hashes=vh)
    t.advance_watermark(1000)
    vec = VectorizedTumblingWindows(THll(8), 1000, initial_capacity=64, device="cpu")
    vec.process_batch(keys, ts, None, key_hashes=keys, value_hashes=vh)
    vec.flush()
    vec.advance_watermark(1000)
    got, want = fire_map(t.emitted), fire_map(vec.emitted)
    k = sorted(want)
    assert_hll_close([got[x] for x in k], [want[x] for x in k], 1 << 8)


@pytest.mark.parametrize("p", [4, 12])
def test_device_finish_sums_are_exact(p):
    """hll_log_finish's optional inv_sum output (its plain version on the
    CPU) equals numpy's float64 sum of 2^-rank per key run plus the
    absent registers, exactly, and asking for it leaves the estimates
    as they are."""
    import torch

    from flink_tpu_torch import kernels as K
    from flink_tpu_torch import native as nat
    rng = np.random.default_rng(p)
    m = 1 << p
    keys = rng.integers(0, 500, 50_000).astype(np.uint64)
    vh = rng.integers(0, 2**63, 50_000).astype(np.uint64)
    regs, ranks = nat.hll_make_cells(vh, p)
    _, _, crk, ends = nat.hll_log_compact(keys, regs, ranks, p)
    r, e = torch.from_numpy(crk), torch.from_numpy(ends)
    sums = torch.empty(len(ends), dtype=torch.float64)
    alpha = THll(p).alpha
    est = K.hll_log_finish(r, e, m, alpha, inv_sum=sums)
    starts = np.concatenate([[0], ends[:-1]])
    want = np.add.reduceat(2.0 ** -crk.astype(np.float64), starts) \
        + (m - (ends - starts))
    np.testing.assert_array_equal(sums.numpy(), want)
    assert torch.equal(K.hll_log_finish(r, e, m, alpha), est)
