"""The port's Count-Min and quantile sketches against the JAX package's,
on the same seeded numpy inputs (kernels run their plain PyTorch
versions: the tensors lie on the CPU).

Count-Min columns, tables, totals and point queries are integer
arithmetic and must be bit-equal.  Quantile buckets come from float32
``log(v) / log(gamma)``: XLA's float32 log and PyTorch's may differ by
an ulp, so a value whose float64 ``log(v) / log(gamma)`` lies within 4
float32 ulps of an integer may land one bucket apart; the tests count
those values, and no other value may differ.  Quantile results select
the same bucket; its float32 value (``exp`` of the bucket) agrees
within rtol 1e-6, a few ulps of ``exp``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_tpu.ops import hashing as jh
from flink_tpu.ops import sketches as js
from flink_tpu_torch.ops import hashing as th
from flink_tpu_torch.ops import sketches as ts

#: BASELINE config #3's geometry (bench.py bench_sliding_quantile)
Q3 = dict(quantiles=(0.5, 0.99), relative_accuracy=0.05, min_value=1e-3,
          max_value=1e6)


def _lanes(rng, n):
    hi = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    hi[:4] = 0xFFFFFFFF
    lo[:2] = 0xFFFFFFFF
    hi[4:6] = 0
    return hi, lo


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("depth,width", [(4, 2048), (5, 1000), (3, 7)])
def test_countmin_rows_bit_equal(depth, width):
    hi, lo = _lanes(np.random.default_rng(depth), 5000)
    want = np.asarray(jh.countmin_rows(jnp.asarray(hi), jnp.asarray(lo),
                                       depth, width))
    for h, l_ in ((hi, lo), (hi.view(np.int32), lo.view(np.int32))):
        got = th.countmin_rows(_t(h), _t(l_), depth, width).numpy()
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def _cm_inputs(seed, n, c):
    rng = np.random.default_rng(seed)
    slots = rng.integers(0, c, n).astype(np.int32)
    # weights: integers, fractions (toward zero), negatives
    values = rng.choice(np.float32([1, 1, 1, 2, 3, 2.7, -1.5, 0.4, 7]), n)
    hi, lo = _lanes(rng, n)
    return slots, values.astype(np.float32), hi, lo


@pytest.mark.parametrize("width", [2048, 1000])
def test_countmin_update_and_point_query_bit_equal(width):
    c, n, n_valid = 37, 6000, 5500
    slots, values, hi, lo = _cm_inputs(1, n, c)
    jagg = js.CountMinSketchAggregate(4, width)
    tagg = ts.CountMinSketchAggregate(4, width)
    jst = jagg.update(jagg.init_state(c), jnp.asarray(slots),
                      jnp.asarray(values), jnp.asarray(hi), jnp.asarray(lo),
                      jnp.arange(n) < n_valid)
    tst = tagg.update(tagg.init_state(c, device="cpu"), _t(slots),
                      _t(values), _t(hi.view(np.int32)),
                      _t(lo.view(np.int32)), n_valid)
    for k in ("table", "total"):
        np.testing.assert_array_equal(tst[k].numpy(), np.asarray(jst[k]))
    assert int(tst["total"].sum()) != 0
    # point queries: every (slot, item) pair seen, plus unseen items
    qs, _, qhi, qlo = _cm_inputs(2, 3000, c)
    qhi[:1500], qlo[:1500] = hi[:1500], lo[:1500]
    qs[:1500] = slots[:1500]
    want = np.asarray(jagg.point_query(jst, jnp.asarray(qs), jnp.asarray(qhi),
                                       jnp.asarray(qlo)))
    got = tagg.point_query(tst, _t(qs), _t(qhi.view(np.int32)),
                           _t(qlo.view(np.int32))).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tagg.result(tst, _t(qs)).numpy(),
                                  np.asarray(jagg.result(jst, jnp.asarray(qs))))


def _near_boundary(values, agg) -> np.ndarray:
    """Values whose float64 log(v) / log(gamma) lies within 4 float32
    ulps of an integer (and above min_value): the ones whose bucket may
    differ between float32 logs that differ by an ulp."""
    v = np.asarray(values, np.float64)
    with np.errstate(invalid="ignore", over="ignore"):
        x = np.log(np.maximum(v, 1e-300)) / agg.log_gamma
        ulp = np.abs(np.spacing(np.float32(x)).astype(np.float64))
        return (np.abs(x - np.round(x)) <= 4 * ulp) & (
            np.float32(values) > np.float32(agg.min_value))


def _quantile_values(seed, n, agg):
    rng = np.random.default_rng(seed)
    v = rng.lognormal(3.0, 1.0, n).astype(np.float32)
    k = rng.integers(-60, 200, 200)
    special = np.concatenate([
        np.float32(np.exp(k * agg.log_gamma)),           # on bucket edges
        np.float32([0, -3, agg.min_value, agg.min_value * 0.5,
                    np.nextafter(np.float32(agg.min_value), np.float32(1)),
                    1e7, 1e30, np.inf, -np.inf, 1.0])])
    v[:len(special)] = special
    return v


@pytest.mark.parametrize("geometry", ["config3", "default"])
def test_quantile_buckets_agree_off_boundaries(geometry):
    kw = Q3 if geometry == "config3" else {}
    jagg, tagg = js.QuantileSketchAggregate(**kw), ts.QuantileSketchAggregate(**kw)
    v = _quantile_values(3, 20000, tagg)
    from flink_tpu_torch.kernels.quantile_update import bucket_of
    got = bucket_of(_t(v), tagg.min_value, tagg.log_gamma, tagg.offset,
                    tagg.buckets).numpy()
    want = np.asarray(jagg._bucket_of(jnp.asarray(v)))
    near = _near_boundary(v, tagg)
    # +inf: the reference's int32 1 + floor(inf) - offset overflows
    # (XLA saturates the floor to INT32_MAX) and clamps to bucket 1; the
    # port saturates in 64 bits and lands it in the top bucket
    pos_inf = np.isposinf(v)
    assert got[pos_inf].tolist() == [tagg.buckets - 1]
    assert want[pos_inf].tolist() == [1]
    differ = (got != want) & ~pos_inf
    assert near.sum() >= 50                    # the edge values are there
    assert not (differ & ~near).any(), v[differ & ~near]
    assert (np.abs(got - want)[differ] == 1).all()
    assert (got[v <= np.float32(tagg.min_value)] == 0).all()
    # histograms through update: equal once the boundary values are out
    c, keep = 23, v[~near & ~pos_inf]
    slots = np.random.default_rng(4).integers(0, c, len(keep)).astype(np.int32)
    n_valid = len(keep) - 100
    jst = jagg.update(jagg.init_state(c), jnp.asarray(slots), jnp.asarray(keep),
                      None, None, jnp.arange(len(keep)) < n_valid)
    tst = tagg.update(tagg.init_state(c, device="cpu"), _t(slots), _t(keep),
                      None, None, n_valid)
    np.testing.assert_array_equal(tst["hist"].numpy(), np.asarray(jst["hist"]))


def _histograms(seed, c, b):
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, 5, (c, b)).astype(np.int32)
    hist *= rng.random((c, b)) < 0.05            # sparse rows
    hist[:3] = 0                                 # empty slots
    hist[3, :] = 0
    hist[3, 0] = 9                               # all at or below min_value
    hist[4, :] = 0
    hist[4, -1] = 1                              # one value above the range
    return hist


@pytest.mark.parametrize("geometry", ["config3", "default"])
def test_quantile_result_selects_the_same_bucket(geometry):
    kw = Q3 if geometry == "config3" else {}
    qkw = dict(kw, quantiles=(0.0, 0.25, 0.5, 0.9, 0.99, 1.0))
    jagg, tagg = js.QuantileSketchAggregate(**qkw), ts.QuantileSketchAggregate(**qkw)
    c = 300
    hist = _histograms(5, c, tagg.buckets)
    slots = np.random.default_rng(6).integers(0, c, 500).astype(np.int32)
    slots[:5] = np.arange(5)
    jst = {"hist": jnp.asarray(hist)}
    tst = {"hist": _t(hist.copy())}
    want = np.asarray(jagg.result(jst, jnp.asarray(slots)))
    got = tagg.result(tst, _t(slots)).numpy()
    dense = tagg.result_dense(tst).numpy()
    np.testing.assert_array_equal(dense[slots], got)
    assert got.shape == (500, 6) and got.dtype == np.float32
    # the selected bucket, by an independent numpy scan
    cum = np.cumsum(hist[slots].astype(np.float64), axis=1)
    vals = tagg.bucket_values()
    for k, q in enumerate(qkw["quantiles"]):
        target = np.maximum(np.float32(q) * np.float32(cum[:, -1]), 1.0)
        ok = cum >= target[:, None]
        sel = np.where(ok.any(axis=1), ok.argmax(axis=1), 0)
        np.testing.assert_array_equal(got[:, k], vals[sel])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert (got[:3] == 0).all() and (want[:3] == 0).all()


@pytest.mark.parametrize("geometry", ["config3", "default"])
@pytest.mark.parametrize("start,stop", [(1, 300), (37, 38), (101, 262)])
def test_quantile_result_dense_on_a_slice_from_an_odd_row(geometry, start, stop):
    """A fire tile is a row slice ``hist[s:s + tile]`` at any row s (on
    the card a row of 210 int32 is only 8-byte aligned there): the
    port's result_dense on the slice against the reference's result of
    those slots and its result_dense of the same slice."""
    kw = Q3 if geometry == "config3" else {}
    qkw = dict(kw, quantiles=(0.1, 0.5, 0.99))
    jagg, tagg = js.QuantileSketchAggregate(**qkw), ts.QuantileSketchAggregate(**qkw)
    hist = _histograms(8, 300, tagg.buckets)
    hist[start] = 0                                   # an empty first row
    got = tagg.result_dense({"hist": _t(hist)[start:stop]}).numpy()
    want = np.asarray(jagg.result({"hist": jnp.asarray(hist)},
                                  jnp.arange(start, stop, dtype=jnp.int32)))
    want_dense = np.asarray(jagg.result_dense({"hist": jnp.asarray(hist[start:stop])}))
    assert got.shape == (stop - start, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(want, want_dense)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert (got[0] == 0).all()
    # the same bucket as the gathered form of the whole file
    full = tagg.result({"hist": _t(hist)}, torch.arange(start, stop, dtype=torch.int32))
    np.testing.assert_array_equal(got, full.numpy())


@pytest.mark.parametrize("kind", ["countmin", "quantile"])
def test_merges_match_merge_slots(kind):
    rng = np.random.default_rng(7)
    c = 64
    if kind == "countmin":
        jagg, tagg = js.CountMinSketchAggregate(3, 50), ts.CountMinSketchAggregate(3, 50)
        arrays = {"table": rng.integers(-5, 50, (c, 3, 50)).astype(np.int32),
                  "total": rng.integers(0, 500, c).astype(np.int32)}
    else:
        jagg, tagg = js.QuantileSketchAggregate(**Q3), ts.QuantileSketchAggregate(**Q3)
        arrays = {"hist": rng.integers(0, 9, (c, tagg.buckets)).astype(np.int32)}
    perm = rng.permutation(c).astype(np.int32)
    # repeated dst (session merges) and unique dst (sliding unions)
    for dst, src, unique in ((np.repeat(perm[:5], 3), perm[5:20], False),
                             (perm[:16], perm[16:32], True)):
        jst = {k: jnp.asarray(v) for k, v in arrays.items()}
        tst = {k: _t(v.copy()) for k, v in arrays.items()}
        jst = jagg.merge_slots(jst, jnp.asarray(dst), jnp.asarray(src))
        merge = tagg.merge_rows if unique else tagg.merge_slots
        tst = merge(tst, _t(dst), _t(src))
        for k in arrays:
            np.testing.assert_array_equal(tst[k].numpy(), np.asarray(jst[k]))


def test_countmin_scalar_contract_matches_reference():
    jagg, tagg = js.CountMinSketchAggregate(4, 64), ts.CountMinSketchAggregate(4, 64)
    items = [3, 3, 5, 2.5, 3.0, 11, 2, 2, 2, 4_000_000_000]
    ja, jb = jagg.create_accumulator(), jagg.create_accumulator()
    ta, tb = tagg.create_accumulator(), tagg.create_accumulator()
    for i, v in enumerate(items):
        if i % 2:
            ja, ta = jagg.add(v, ja), tagg.add(v, ta)
        else:
            jb, tb = jagg.add(v, jb), tagg.add(v, tb)
    for t, j in ((ta, ja), (tb, jb), (tagg.merge(ta, tb), jagg.merge(ja, jb))):
        for k in ("table", "total"):
            np.testing.assert_array_equal(np.asarray(t[k]).reshape(-1),
                                          np.asarray(j[k]).reshape(-1))
    got = tagg.get_result(tagg.merge(ta, tb))
    assert got == jagg.get_result(jagg.merge(ja, jb))


def test_countmin_refuses_an_item_without_a_weight():
    jagg, tagg = js.CountMinSketchAggregate(4, 64), ts.CountMinSketchAggregate(4, 64)
    # the value is the weight as well as the item: a string has no weight
    for agg in (jagg, tagg):
        with pytest.raises((ValueError, TypeError)):
            agg.add("x", agg.create_accumulator())


def test_quantile_scalar_contract_matches_reference():
    jagg, tagg = js.QuantileSketchAggregate(**Q3), ts.QuantileSketchAggregate(**Q3)
    v = _quantile_values(8, 400, tagg)
    v = v[~_near_boundary(v, tagg) & np.isfinite(v)]
    ja, jb = jagg.create_accumulator(), jagg.create_accumulator()
    ta, tb = tagg.create_accumulator(), tagg.create_accumulator()
    for i, x in enumerate(v.tolist()):
        if i % 3:
            ja, ta = jagg.add(x, ja), tagg.add(x, ta)
        else:
            jb, tb = jagg.add(x, jb), tagg.add(x, tb)
    jm, tm = jagg.merge(ja, jb), tagg.merge(ta, tb)
    np.testing.assert_array_equal(np.asarray(tm["hist"]).reshape(-1),
                                  np.asarray(jm["hist"]).reshape(-1))
    got, want = tagg.get_result(tm), jagg.get_result(jm)
    assert np.shape(got) == np.shape(want) == (2,)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    empty = tagg.get_result(tagg.create_accumulator())
    np.testing.assert_array_equal(empty, [0.0, 0.0])
