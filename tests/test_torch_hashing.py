"""Hashes of the port against the JAX package's: the same keys and
lanes, made from a seed with numpy, go through both; every output must
be bit-equal (a key's hash picks its slot, a value's hash its HLL
register and rank)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_tpu.core import keygroups as jk
from flink_tpu.ops import hashing as jh
from flink_tpu.ops.sketches import HyperLogLogAggregate as JaxHll
from flink_tpu_torch.core import keygroups as tk
from flink_tpu_torch.ops import hashing as th
from flink_tpu_torch.ops.sketches import HyperLogLogAggregate as TorchHll


def _lanes(seed, n=4096):
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    # every leading-zero count 0..32 appears
    hi[:33] = np.array([0] + [1 << k for k in range(32)], np.uint32)
    hi[33:200] >>= rng.integers(0, 32, 167).astype(np.uint32)
    return hi, lo


def test_splitmix64_np_bit_equal():
    rng = np.random.default_rng(0)
    x = rng.integers(-2**63, 2**63 - 1, 10_000, dtype=np.int64)
    x[:4] = [0, -1, 2**63 - 1, -2**63]
    np.testing.assert_array_equal(tk.splitmix64_np(x), jk.splitmix64_np(x))


@pytest.mark.parametrize("keys", [
    [0, 1, -1, 2**63 - 1, 12345678901234, 7],
    ["", "a", "word", "ünïcödé", "a much longer key " * 10],
    [(1, 2), (1, "a"), ("x", (2, 3.5)), ()],
    [0.0, 1.0, -3.0, 2.5, float("inf"), float("nan")],
    [None, True, False, b"bytes"],
])
def test_stable_hash64_bit_equal(keys):
    for k in keys:
        assert tk.stable_hash64(k) == jk.stable_hash64(k), k
    assert tk.murmur_hash(tk.stable_hash64(keys[0])) == \
        jk.murmur_hash(jk.stable_hash64(keys[0]))


def test_stable_hashes_np_bit_equal():
    rng = np.random.default_rng(1)
    ints = rng.integers(-10**12, 10**12, 1000).tolist()
    np.testing.assert_array_equal(tk.stable_hashes_np(ints), jk.stable_hashes_np(ints))
    mixed = ints[:10] + ["s", (1, 2)]
    np.testing.assert_array_equal(tk.stable_hashes_np(mixed), jk.stable_hashes_np(mixed))


@pytest.mark.parametrize("lane_dtype", [torch.uint32, torch.int32, torch.int64])
def test_clz_popcount_fmix_bit_equal(lane_dtype):
    hi, _ = _lanes(2)
    t = torch.from_numpy(hi.view(np.int32)) if lane_dtype == torch.int32 else \
        torch.from_numpy(hi).to(lane_dtype)
    np.testing.assert_array_equal(th.clz32(t).numpy(), np.asarray(jh.clz32(jnp.asarray(hi))))
    np.testing.assert_array_equal(th.popcount32(t).numpy(),
                                  np.asarray(jh.popcount32(jnp.asarray(hi))))
    np.testing.assert_array_equal(th.fmix32(t).numpy(),
                                  np.asarray(jh.fmix32(jnp.asarray(hi))).astype(np.int64))


@pytest.mark.parametrize("precision", [4, 8, 12, 16, 18])
def test_hll_register_and_rank_bit_equal(precision):
    hi, lo = _lanes(3)
    reg_t, rank_t = th.hll_register_and_rank(torch.from_numpy(hi), torch.from_numpy(lo),
                                             precision)
    reg_j, rank_j = jh.hll_register_and_rank(jnp.asarray(hi), jnp.asarray(lo), precision)
    np.testing.assert_array_equal(reg_t.numpy(), np.asarray(reg_j))
    np.testing.assert_array_equal(rank_t.numpy(), np.asarray(rank_j))


@pytest.mark.parametrize("precision", [8, 12, 17])
def test_compress_value_hash_bit_equal(precision):
    hi, lo = _lanes(4)
    rank_t, reg_t = TorchHll(precision).compress_value_hash(hi, lo)
    rank_j, reg_j = JaxHll(precision).compress_value_hash(hi, lo)
    assert rank_t.dtype == rank_j.dtype and reg_t.dtype == reg_j.dtype
    np.testing.assert_array_equal(rank_t, rank_j)
    np.testing.assert_array_equal(reg_t, reg_j)
    # the host compression agrees with the exact device decomposition
    reg, rank = th.hll_register_and_rank(torch.from_numpy(hi), torch.from_numpy(lo),
                                         precision)
    np.testing.assert_array_equal(rank_t, rank.numpy())
    np.testing.assert_array_equal(reg_t, reg.numpy())


def test_split_hash64_np_bit_equal():
    h = jk.splitmix64_np(np.arange(1000, dtype=np.int64))
    for a, b in zip(th.split_hash64_np(h), jh.split_hash64_np(h)):
        np.testing.assert_array_equal(a, b)
