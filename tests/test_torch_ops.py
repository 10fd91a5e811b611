"""Aggregates of the port (plain PyTorch versions of the kernels, on the
CPU) against the JAX package's.  Inputs are made from a seed with numpy
and given to both.  HLL registers and integer sums are bit-equal;
HLL estimates agree within rtol 1e-5 (float32 sums taken in another
order); float sums use integer-valued data, which any order adds
exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_tpu.ops import device_agg as jd
from flink_tpu.ops import sketches as js
from flink_tpu_torch import kernels as K
from flink_tpu_torch.ops import device_agg as td
from flink_tpu_torch.ops import sketches as ts
from torch_port_util import assert_hll_close

CPU = "cpu"


def _np(state):
    return {k: np.asarray(v) for k, v in state.items()}


def _torch(state):
    return {k: torch.from_numpy(np.array(v)) for k, v in state.items()}


def _hll_batch(seed, n, c, p):
    rng = np.random.default_rng(seed)
    slots = rng.integers(0, c, n).astype(np.int32)
    hi = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    hi[: n // 8] >>= rng.integers(0, 32, n // 8).astype(np.uint32)
    hi[:2] = 0
    return slots, hi, lo


@pytest.mark.parametrize("p", [8, 12])
@pytest.mark.parametrize("compressed", [False, True])
def test_hll_update_bit_equal_with_masked_rows(p, compressed):
    c, n = 37, 5000
    live = n - 777                              # rows >= live are masked
    jagg, tagg = js.HyperLogLogAggregate(p), ts.HyperLogLogAggregate(p)
    jstate = jagg.init_state(c)
    tstate = tagg.init_state(c, device=CPU)
    for seed in range(3):
        slots, hi, lo = _hll_batch(seed, n, c, p)
        if compressed:
            hi, lo = tagg.compress_value_hash(hi, lo)
        mask = np.arange(n) < live
        jstate = jagg.update(jstate, jnp.asarray(slots), jnp.zeros(1), jnp.asarray(hi),
                             jnp.asarray(lo), jnp.asarray(mask))
        th = torch.from_numpy(hi if compressed else hi.view(np.int32))
        tl = torch.from_numpy(lo.view(np.int16) if compressed else lo.view(np.int32))
        tstate = tagg.update(tstate, torch.from_numpy(slots), None, th, tl, live)
    np.testing.assert_array_equal(tstate["regs"].numpy(), np.asarray(jstate["regs"]))


def test_hll_result_forms_within_rtol():
    p, c = 10, 300
    rng = np.random.default_rng(7)
    regs = rng.integers(0, 12, (c, 1 << p)).astype(np.uint8)
    regs[:50] = 0                               # empty: linear counting, est 0
    regs[50:120, : (1 << p) - 40] = 0           # mostly empty: linear counting
    regs[120:130] = 30                          # large range
    jagg, tagg = js.HyperLogLogAggregate(p), ts.HyperLogLogAggregate(p)
    slots = rng.integers(0, c, 111).astype(np.int32)
    want_dense = np.asarray(jagg.result_dense({"regs": jnp.asarray(regs)}))
    want = np.asarray(jagg.result({"regs": jnp.asarray(regs)}, jnp.asarray(slots)))
    t = {"regs": torch.from_numpy(regs)}
    m = 1 << p
    assert_hll_close(tagg.result_dense(t).numpy(), want_dense, m)
    assert_hll_close(tagg.result(t, torch.from_numpy(slots)).numpy(), want, m)
    # the plain version tiles: a small tile gives the same numbers
    np.testing.assert_array_equal(
        K.hll_estimate_plain(t["regs"], tagg.alpha, tile=7).numpy(),
        tagg.result_dense(t).numpy())
    np.testing.assert_array_equal(
        K.hll_estimate_plain(t["regs"][40:140], tagg.alpha).numpy(),
        tagg.result_dense(t).numpy()[40:140])


def test_hll_linear_counting_logs_are_correctly_rounded():
    """Every zero count of a p = 12 row: the linear branch equals
    m * (fl(log m) - fl(log z)) with correctly rounded float32 logs."""
    p, m = 12, 4096
    regs = np.ones((m, m), np.uint8)
    regs[np.tril_indices(m, -1)] = 0            # row z has z zeros
    got = K.hll_estimate_plain(torch.from_numpy(regs), ts.HyperLogLogAggregate(p).alpha)
    z = np.arange(1, m, dtype=np.float64)
    log32 = lambda x: np.log(x).astype(np.float32)   # noqa: E731
    want = np.float32(m) * (log32(np.float64(m)) - log32(z))
    linear = got.numpy()[1:] <= 2.5 * m
    np.testing.assert_array_equal(got.numpy()[1:][linear], want[linear])


def test_jax_float32_log_is_within_one_ulp():
    """The slack assert_hll_close allows for: XLA's float32 log of an
    integer zero count is at most one ulp from the correctly rounded
    value the port takes."""
    z = np.arange(1, 1 << 18, dtype=np.float32)
    got = np.asarray(jnp.log(jnp.asarray(z)))
    want = np.log(z.astype(np.float64)).astype(np.float32)
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32))
    assert ulps.max() <= 1
    # log m, as HyperLogLogAggregate._estimate takes it: of a float32
    # constant inside a jitted program, which XLA may fold
    for p in range(4, 19):
        got_m = np.float32(jax.jit(lambda: jnp.log(jnp.float32(1 << p)))())
        want_m = np.float32(np.log(float(1 << p)))
        assert abs(int(got_m.view(np.int32)) - int(want_m.view(np.int32))) <= 1


ARITH = [
    ("sum_f32", lambda m: m.SumAggregate(np.float32)),
    ("sum_f64", lambda m: m.SumAggregate(np.float64)),
    ("sum_i64", lambda m: m.SumAggregate(np.int64)),
    ("count", lambda m: m.CountAggregate()),
    ("min_f32", lambda m: m.MinAggregate(np.float32)),
    ("min_i32", lambda m: m.MinAggregate(np.int32)),
    ("max_f64", lambda m: m.MaxAggregate(np.float64)),
    ("max_i32", lambda m: m.MaxAggregate(np.int32)),
    ("avg", lambda m: m.AvgAggregate()),
]


@pytest.mark.parametrize("name,make", ARITH, ids=[a[0] for a in ARITH])
def test_arithmetic_update_result_clear_equal(name, make):
    c, n = 50, 3000
    jagg, tagg = make(jd), make(td)
    rng = np.random.default_rng(hash(name) % 2**32)
    jstate = jagg.init_state(c)
    tstate = tagg.init_state(c, device=CPU)
    for k in range(2):
        slots = rng.integers(0, c, n).astype(np.int32)
        vals = rng.integers(-500, 500, n).astype(jagg.value_dtype)
        live = n - 100 * (k + 1)
        mask = np.arange(n) < live
        jstate = jagg.update(jstate, jnp.asarray(slots), jnp.asarray(vals),
                             jnp.zeros(1, jnp.uint32), jnp.zeros(1, jnp.uint32),
                             jnp.asarray(mask))
        tvals = torch.from_numpy(vals.astype(td.device_dtype(vals.dtype)))
        tstate = tagg.update(tstate, torch.from_numpy(slots), tvals, None, None, live)
    for k in jstate:
        assert tstate[k].numpy().dtype == np.asarray(jstate[k]).dtype, k
        np.testing.assert_array_equal(tstate[k].numpy(), np.asarray(jstate[k]))
    q = rng.integers(0, c, 40).astype(np.int32)
    np.testing.assert_array_equal(tagg.result(tstate, torch.from_numpy(q)).numpy(),
                                  np.asarray(jagg.result(jstate, jnp.asarray(q))))
    cleared = rng.choice(c, 17, replace=False).astype(np.int32)
    jstate = jagg.clear_slots(jstate, jnp.asarray(cleared))
    tstate = tagg.clear_slots(tstate, torch.from_numpy(cleared))
    for k in jstate:
        np.testing.assert_array_equal(tstate[k].numpy(), np.asarray(jstate[k]))


def test_clear_slots_and_grow_hll():
    jagg, tagg = js.HyperLogLogAggregate(6), ts.HyperLogLogAggregate(6)
    slots, hi, lo = _hll_batch(9, 2000, 20, 6)
    jstate = jagg.update(jagg.init_state(20), jnp.asarray(slots), jnp.zeros(1),
                         jnp.asarray(hi), jnp.asarray(lo), jnp.ones(2000, bool))
    tstate = td.state_from_numpy(tagg, _np(jstate), CPU)
    tstate = tagg.grow_state(tstate, 33)
    jstate = jagg.grow_state(jstate, 33)
    cleared = np.array([0, 5, 19, 32], np.int32)
    jstate = jagg.clear_slots(jstate, jnp.asarray(cleared))
    tstate = tagg.clear_slots(tstate, torch.from_numpy(cleared))
    np.testing.assert_array_equal(td.state_to_numpy(tstate)["regs"],
                                  np.asarray(jstate["regs"]))
    tagg.clear_range(tstate, 3, 10)
    assert not tstate["regs"][3:13].any() and tstate["regs"][13:19].any()


@pytest.mark.parametrize("name,make", ARITH[:5], ids=[a[0] for a in ARITH[:5]])
def test_scalar_contract_matches_reference(name, make):
    jagg, tagg = make(jd), make(td)
    ja, ta = jagg.create_accumulator(), tagg.create_accumulator()
    for v in [3, -4, 10, 7]:
        ja, ta = jagg.add(v, ja), tagg.add(v, ta)
    assert tagg.get_result(ta) == pytest.approx(jagg.get_result(ja))
    merged_t, merged_j = tagg.merge(ta, ta), jagg.merge(ja, ja)
    assert tagg.get_result(merged_t) == pytest.approx(jagg.get_result(merged_j))


def test_hll_scalar_contract_matches_reference():
    jagg, tagg = js.HyperLogLogAggregate(8), ts.HyperLogLogAggregate(8)
    ja, ta = jagg.create_accumulator(), tagg.create_accumulator()
    for v in range(300):
        ja, ta = jagg.add(v, ja), tagg.add(v, ta)
    np.testing.assert_array_equal(ta["regs"], np.asarray(ja["regs"]))
    assert tagg.get_result(ta) == pytest.approx(jagg.get_result(ja), rel=1e-5)


def test_device_dtype_mirrors_jax_x64_off():
    for dt in (np.float64, np.int64, np.float32, np.int32, np.uint8):
        assert td.device_dtype(dt) == jnp.zeros(1, dt).dtype


def test_plain_kernel_versions_drop_out_of_range_slots():
    state = torch.zeros(4, dtype=torch.int32)
    K.scatter_combine(state, torch.tensor([0, 4, -1, 3], dtype=torch.int32), None, 4, "add")
    assert state.tolist() == [1, 0, 0, 1]
    comp = torch.ones((4, 2), dtype=torch.float32)
    K.clear_rows(comp, 0.0, slots=torch.tensor([1, 9], dtype=torch.int32))
    assert comp[:, 0].tolist() == [1.0, 0.0, 1.0, 1.0]
