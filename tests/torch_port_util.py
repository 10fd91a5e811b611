"""Shared helpers of the port's tests: the tolerance for HLL estimates of
the port against the JAX package, and the per-shard view of a
row-sharded ``chain_route`` call.

HLL: both packages compute the linear-counting estimate m * (log m - log z) in
float32, z the zero count, 1 <= z <= m.  The port takes correctly
rounded float32 logs.  XLA's float32 log is at most one ulp from the
correctly rounded value, for the zero counts and for the constant
log m alike (tests/test_torch_ops.py checks both).  So the two
estimates differ by at most m * (ulp(log m) + ulp(log z)) before the
last rounding, and ulp(log z) <= ulp(log m) since z <= m: the
comparison allows 2 * m * ulp(log m) of absolute slack on top of its
relative tolerance (rtol 1e-5: float32 sums taken in another order,
and the final rounding of the subtraction).
"""

import numpy as np


def hll_atol(m: int) -> float:
    """One float32 ulp of log(m) for each of the two logs, times m."""
    return float(2 * m * np.spacing(np.float32(np.log(m))))


def assert_hll_close(got, want, m: int, rtol: float = 1e-5) -> None:
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=rtol, atol=hll_atol(m))


def shard_bounds(starts, n_shards: int, nclass: int):
    """Per-shard kept counts [n_shards] and class bounds [n_shards,
    nclass] (positions inside the shard's block: the reference's
    per-shard ``searchsorted``) from a row-sharded ``chain_route``'s
    class starts."""
    st = np.asarray(starts, np.int64).reshape(n_shards, nclass)
    bounds = st - st[:, :1]
    return bounds[:, -1], bounds
