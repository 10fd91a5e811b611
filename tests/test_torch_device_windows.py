"""The port's DeviceTumblingWindows against the JAX package's
(tests/test_vectorized.py's device-engine cases), as key -> result maps
per window.  Sums of integer-valued data are exact; HLL estimates go
through assert_hll_close (float32 estimates, the linear-counting log
slack of tests/torch_port_util.py); late drops and overflow counts are
equal (on the CPU the table replays the JAX claim rounds)."""

import numpy as np
import pytest

from flink_tpu.core.keygroups import splitmix64_np
from flink_tpu.ops.device_agg import SumAggregate as JSum
from flink_tpu.ops.sketches import HyperLogLogAggregate as JHll
from flink_tpu.streaming import device_windows as jdw
from flink_tpu_torch.ops.device_agg import SumAggregate as TSum
from flink_tpu_torch.ops.sketches import HyperLogLogAggregate as THll
from flink_tpu_torch.streaming import device_windows as tdw
from flink_tpu_torch.streaming.vectorized import VectorizedTumblingWindows
from torch_port_util import assert_hll_close


def _fired(eng):
    return {(int(k), s): float(r) for karr, res, s, e in eng.fired
            for k, r in zip(karr, res)}


def _split(h):
    return ((h >> np.uint64(32)).astype(np.uint32),
            (h & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def _pair(jagg, tagg, capacity):
    return (jdw.DeviceTumblingWindows(jagg, 1000, capacity=capacity),
            tdw.DeviceTumblingWindows(tagg, 1000, capacity=capacity, device="cpu"))


def test_lanes_from_int_keys_identity():
    keys = np.array([0, 1, 2**32 + 5, 2**63 + 7], np.uint64)
    for a, b in zip(tdw.lanes_from_int_keys(keys), jdw.lanes_from_int_keys(keys)):
        np.testing.assert_array_equal(a, b)


def test_device_windows_sum_matches_reference():
    rng = np.random.default_rng(5)
    n = 4000
    keys = rng.integers(0, 300, n).astype(np.uint64)
    keys[:4] = 0                                  # key (0, 0) is a key
    ts = rng.integers(0, 3000, n)
    vals = rng.integers(0, 20, n).astype(np.float32)
    j, t = _pair(JSum(np.float32), TSum(np.float32), 1024)
    hi, lo = tdw.lanes_from_int_keys(keys)
    for eng in (j, t):
        eng.process_batch(hi, lo, ts, values=vals)
        eng.advance_watermark(2999)
    got = _fired(t)
    assert got == _fired(j) and len(got) > 800
    assert any(k == 0 for k, _ in got)
    assert t.overflowed == j.overflowed == 0
    assert t.num_late_dropped == j.num_late_dropped
    # a late batch
    for eng in (j, t):
        eng.process_batch(hi[:5], lo[:5], np.full(5, 500), values=vals[:5])
    assert t.num_late_dropped == j.num_late_dropped == 5


def test_device_windows_hll_and_late():
    keys = np.arange(4, dtype=np.uint64).repeat(500)
    uh = splitmix64_np(np.arange(2000).astype(np.uint64))
    vh_hi, vh_lo = _split(uh)
    j, t = _pair(JHll(9), THll(9), 64)
    hi, lo = tdw.lanes_from_int_keys(keys)
    for eng in (j, t):
        eng.process_batch(hi, lo, np.full(2000, 100), vh_hi=vh_hi, vh_lo=vh_lo)
        eng.advance_watermark(999)
    (karr, res, s, e), = t.fired
    assert sorted(karr.tolist()) == [0, 1, 2, 3]
    assert all(abs(r - 500) / 500 < 0.15 for r in res)
    got, want = _fired(t), _fired(j)
    assert got.keys() == want.keys()
    k = sorted(want)
    assert_hll_close([got[x] for x in k], [want[x] for x in k], 1 << 9)
    for eng in (j, t):
        eng.process_batch(*tdw.lanes_from_int_keys(np.array([1], np.uint64)),
                          np.array([500]))
        assert eng.num_late_dropped == 1


def test_device_windows_hll_equals_scatter_engine():
    """Same registers, same hll_estimate: the device-indexed engine and
    the host-indexed scatter engine give equal estimates per key."""
    rng = np.random.default_rng(9)
    n = 6000
    keys = rng.integers(0, 500, n).astype(np.uint64)
    ts = np.sort(rng.integers(0, 2000, n))
    uh = splitmix64_np(rng.integers(0, 2**40, n).astype(np.uint64))
    t = tdw.DeviceTumblingWindows(THll(10), 1000, capacity=2048, device="cpu")
    t.process_batch(*tdw.lanes_from_int_keys(keys), ts, vh_hi=_split(uh)[0],
                    vh_lo=_split(uh)[1])
    t.advance_watermark(1999)
    vec = VectorizedTumblingWindows(THll(10), 1000, initial_capacity=1024,
                                    device="cpu")
    vec.process_batch(keys, ts, None, key_hashes=splitmix64_np(keys),
                      value_hashes=uh)
    vec.flush()
    vec.advance_watermark(1999)
    want = {(int(k), s): float(r) for k, r, s, _ in vec.emitted}
    assert _fired(t) == want


@pytest.mark.parametrize("capacity", [64, 200])
def test_device_windows_overflow_counts_equal(capacity):
    rng = np.random.default_rng(11)
    n = 3000
    keys = rng.integers(0, 400, n).astype(np.uint64)
    vals = np.ones(n, np.float32)
    j = jdw.DeviceTumblingWindows(JSum(np.float32), 1000, capacity=capacity,
                                  max_probes=8)
    t = tdw.DeviceTumblingWindows(TSum(np.float32), 1000, capacity=capacity,
                                  max_probes=8, device="cpu")
    hi, lo = tdw.lanes_from_int_keys(keys)
    for eng in (j, t):
        for i in range(0, n, 1024):
            eng.process_batch(hi[i:i + 1024], lo[i:i + 1024],
                              np.full(len(hi[i:i + 1024]), 10),
                              values=vals[i:i + 1024])
        eng.advance_watermark(999)
    assert t.overflowed == j.overflowed > 0
    assert _fired(t) == _fired(j)
    assert len(_fired(t)) <= capacity
