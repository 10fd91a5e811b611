"""Slots outside ``[0, C)`` through the port and the JAX package, on the
same seeded numpy state.

Reads follow the reference's index rule (numpy's, as JAX indexes): a
negative slot wraps once to ``s + C``, then the row clamps into
``[0, C)``.  Every aggregate's ``result`` and Count-Min's
``point_query`` must equal the reference's at each listed slot: exactly
for integers and the selected quantile bucket, within the HLL slack of
``torch_port_util`` for HLL estimates, within rtol 1e-6 for a quantile's
float32 value (``exp`` of its bucket, as ``test_torch_sketches.py``
holds it).

Writes differ by design: the reference's ``update`` and
``merge_slots`` wrap slot -1 to row ``C - 1``, while the port skips
every slot outside ``[0, C)`` (-1 is its engines' skip mark; the
reference's callers mask negative slots before an update).  The last
tests state that difference."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_tpu.ops import device_agg as jd
from flink_tpu.ops import sketches as js
from flink_tpu_torch import kernels as K
from flink_tpu_torch.ops import device_agg as td
from flink_tpu_torch.ops import sketches as ts
from flink_tpu_torch.ops.slot_index import gather_rows, torch_index
from torch_port_util import assert_hll_close

C = 6
I32 = np.iinfo(np.int32)
SLOTS = [I32.min, -C - 1, -C, -1, 0, C - 1, C, I32.max]
Q3 = dict(quantiles=(0.5, 0.99), relative_accuracy=0.05, min_value=1e-3,
          max_value=1e6)
HLL_P = 6


def _state(name, rng):
    """numpy state of C slots for the aggregate ``name``."""
    if name in ("sum", "min", "max"):
        return {name: rng.normal(size=C).astype(np.float32)}
    if name == "count":
        return {"count": rng.integers(0, 50, C).astype(np.int32)}
    if name == "avg":
        count = rng.integers(0, 5, C).astype(np.int32)
        count[0] = 0
        return {"sum": rng.integers(-40, 40, C).astype(np.float32), "count": count}
    if name == "hll":
        regs = rng.integers(0, 7, (C, 1 << HLL_P)).astype(np.uint8)
        regs[C - 1, : 1 << (HLL_P - 1)] = 0      # linear counting in one row
        return {"regs": regs}
    if name in ("countmin", "point_query"):
        return {"table": rng.integers(0, 1000, (C, 4, 64)).astype(np.int32),
                "total": rng.integers(0, 10_000, C).astype(np.int32)}
    assert name == "quantile"
    buckets = ts.QuantileSketchAggregate(**Q3).buckets
    hist = rng.integers(0, 3, (C, buckets)).astype(np.int32)
    hist[1] = 0                                  # an empty row
    return {"hist": hist}


def _aggs(name):
    return {"sum": (jd.SumAggregate(), td.SumAggregate()),
            "count": (jd.CountAggregate(), td.CountAggregate()),
            "min": (jd.MinAggregate(), td.MinAggregate()),
            "max": (jd.MaxAggregate(), td.MaxAggregate()),
            "avg": (jd.AvgAggregate(), td.AvgAggregate()),
            "hll": (js.HyperLogLogAggregate(HLL_P), ts.HyperLogLogAggregate(HLL_P)),
            "countmin": (js.CountMinSketchAggregate(4, 64),
                         ts.CountMinSketchAggregate(4, 64)),
            "point_query": (js.CountMinSketchAggregate(4, 64),
                            ts.CountMinSketchAggregate(4, 64)),
            "quantile": (js.QuantileSketchAggregate(**Q3),
                         ts.QuantileSketchAggregate(**Q3))}[name]


READS = ["sum", "count", "min", "max", "avg", "hll", "quantile", "countmin",
         "point_query"]


@pytest.mark.parametrize("slot", SLOTS)
@pytest.mark.parametrize("name", READS)
def test_reads_follow_the_reference_index_rule(name, slot):
    rng = np.random.default_rng(READS.index(name))
    arrays = _state(name, rng)
    jagg, tagg = _aggs(name)
    jst = {k: jnp.asarray(v) for k, v in arrays.items()}
    tst = {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}
    slots = np.array([slot, 2, slot], np.int32)
    if name == "point_query":
        hi = rng.integers(0, 2**32, 3, dtype=np.uint64).astype(np.uint32)
        lo = rng.integers(0, 2**32, 3, dtype=np.uint64).astype(np.uint32)
        want = np.asarray(jagg.point_query(jst, jnp.asarray(slots), jnp.asarray(hi),
                                           jnp.asarray(lo)))
        got = tagg.point_query(tst, torch.from_numpy(slots),
                               torch.from_numpy(hi.view(np.int32)),
                               torch.from_numpy(lo.view(np.int32))).numpy()
    else:
        want = np.asarray(jagg.result(jst, jnp.asarray(slots)))
        got = tagg.result(tst, torch.from_numpy(slots)).numpy()
    assert got.shape == want.shape
    if name == "hll":
        assert_hll_close(got, want, 1 << HLL_P)
    elif name == "quantile":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(got, want)
    # the row the rule names, read directly
    row = min(max(slot + C if slot < 0 else slot, 0), C - 1)
    if name in ("sum", "count", "min", "max"):
        assert got[0] == arrays[name][row]


@pytest.mark.parametrize("kernel", ["countmin_query", "hll_estimate",
                                    "quantile_result"])
def test_plain_gathers_wrap_minus_one_to_the_last_row(kernel):
    rng = np.random.default_rng(5)
    if kernel == "countmin_query":
        table = torch.from_numpy(rng.integers(0, 99, (C, 3, 16)).astype(np.int32))
        hi = torch.from_numpy(rng.integers(-2**31, 2**31, 4).astype(np.int32))
        lo = torch.from_numpy(rng.integers(-2**31, 2**31, 4).astype(np.int32))

        def fn(s):
            return K.countmin_query_plain(table, s, hi, lo)
    elif kernel == "hll_estimate":
        regs = torch.from_numpy(rng.integers(0, 9, (C, 64)).astype(np.uint8))

        def fn(s):
            return K.hll_estimate_plain(regs, 0.709, s)
    else:
        agg = ts.QuantileSketchAggregate(**Q3)
        hist = torch.from_numpy(rng.integers(0, 4, (C, agg.buckets)).astype(np.int32))
        qs, bv = agg._tables(torch.device("cpu"))

        def fn(s):
            return K.quantile_result_plain(hist, qs, bv, s)
    n = 4 if kernel == "countmin_query" else 2
    for slot, row in ((-1, C - 1), (-C, 0), (-C - 1, 0), (C, C - 1)):
        got = fn(torch.full((n,), slot, dtype=torch.int32))
        assert torch.equal(got, fn(torch.full((n,), row, dtype=torch.int32))), slot


def test_slot_index_helpers():
    s = torch.tensor(SLOTS, dtype=torch.int32)
    assert gather_rows(s, C).tolist() == [0, 0, 0, C - 1, 0, C - 1, C - 1, C - 1]
    assert torch_index(s, C).tolist() == [-C, -C, -C, -1, 0, C - 1, C - 1, C - 1]


WRITES = ["sum", "count", "hll", "countmin", "quantile"]


def _update_inputs(name, rng, n):
    vals = rng.integers(1, 4, n).astype(np.float32)
    hi = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    if name == "quantile":
        vals = rng.lognormal(3.0, 1.0, n).astype(np.float32)
    return vals, hi, lo


@pytest.mark.parametrize("name", WRITES)
def test_update_at_minus_one_writes_the_last_row_only_in_the_reference(name):
    rng = np.random.default_rng(WRITES.index(name) + 40)
    jagg, tagg = _aggs(name)
    jst = jagg.init_state(C)
    tst = tagg.init_state(C, device="cpu")
    vals, hi, lo = _update_inputs(name, rng, 3)
    slots = np.full(3, -1, np.int32)
    jst = jagg.update(jst, jnp.asarray(slots), jnp.asarray(vals), jnp.asarray(hi),
                      jnp.asarray(lo), jnp.ones(3, bool))
    tst = tagg.update(tst, torch.from_numpy(slots), torch.from_numpy(vals),
                      torch.from_numpy(hi.view(np.int32)),
                      torch.from_numpy(lo.view(np.int32)), 3)
    fresh = tagg.init_state(C, device="cpu")
    for k in tst:
        want = np.asarray(jst[k])
        # the reference wrote row C - 1 and nothing else
        assert not np.array_equal(want[C - 1], fresh[k][C - 1].numpy()), k
        np.testing.assert_array_equal(want[:C - 1], fresh[k][:C - 1].numpy())
        # the port wrote nothing
        assert torch.equal(tst[k], fresh[k]), k


@pytest.mark.parametrize("pair", [(-1, 2), (2, -1)], ids=["dst", "src"])
@pytest.mark.parametrize("name", WRITES)
def test_merge_slots_at_minus_one_changes_rows_only_in_the_reference(name, pair):
    rng = np.random.default_rng(WRITES.index(name) + 50)
    arrays = _state(name, rng)
    jagg, tagg = _aggs(name)
    jst = {k: jnp.asarray(v) for k, v in arrays.items()}
    tst = {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}
    dst, src = (np.array([x], np.int32) for x in pair)
    jst = jagg.merge_slots(jst, jnp.asarray(dst), jnp.asarray(src))
    tst = tagg.merge_slots(tst, torch.from_numpy(dst), torch.from_numpy(src))
    changed = C - 1 if pair[0] == -1 else 2
    for k, v in arrays.items():
        want = np.asarray(jst[k])
        assert not np.array_equal(want[changed], v[changed]), k
        rest = np.arange(C) != changed
        np.testing.assert_array_equal(want[rest], v[rest])
        np.testing.assert_array_equal(tst[k].numpy(), v)
