"""The port's WindowedHeavyHitters: the cases of
tests/test_heavy_hitters.py on the port, and each against the JAX
package's operator on the same records (Count-Min tables and point
queries are integer arithmetic, so ``hh_emitted`` must be equal, item
for item and estimate for estimate; items of equal estimate may come
out in either order)."""

import collections

import numpy as np
import pytest

from flink_tpu.streaming.heavy_hitters import WindowedHeavyHitters as JaxHH
from flink_tpu_torch.streaming.heavy_hitters import WindowedHeavyHitters


def _zipfish(n, n_keys, n_heavy, n_tail, seed=0, heavy_frac=0.6):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n_keys, n)
    items = np.where(rng.random(n) < heavy_frac,
                     rng.integers(0, n_heavy, n),
                     rng.integers(n_heavy, n_heavy + n_tail, n))
    ts = rng.integers(0, 2000, n)
    return keys, items, ts


def _truth(keys, items, ts, size=1000):
    per_item = collections.Counter()
    per_key = collections.Counter()
    for k, i, t in zip(keys.tolist(), items.tolist(), ts.tolist()):
        s = t - t % size
        per_item[(k, s, i)] += 1
        per_key[(k, s)] += 1
    return per_item, per_key


def _both(records, **kw):
    """The same records through the port (on the CPU) and the JAX
    package; returns the port's operator after checking that both
    emitted the same heavy hitters."""
    keys, items, ts = records
    got = WindowedHeavyHitters(1000, device="cpu", **kw)
    want = JaxHH(1000, **kw)
    for hh in (got, want):
        half = len(ts) // 2
        hh.process_items(keys[:half], ts[:half], items[:half])
        hh.process_items(keys[half:], ts[half:], items[half:])
        hh.advance_watermark(1999)

    def norm(emitted):
        # equal estimates may come out in either order: the candidates'
        # first-seen order follows each package's slot index
        return sorted((int(k), s, e, sorted((-float(est), int(i)) for i, est in h))
                      for k, h, s, e in emitted)
    assert norm(got.hh_emitted) == norm(want.hh_emitted)
    return got


def test_phi_threshold_no_false_negatives():
    keys, items, ts = _zipfish(20000, 5, 2, 500)
    hh = _both((keys, items, ts), phi=0.1, depth=4, width=4096)
    per_item, per_key = _truth(keys, items, ts)
    assert len(hh.hh_emitted) == 10          # 5 keys x 2 windows
    for key, hitters, s, e in hh.hh_emitted:
        assert e == s + 1000
        hit_items = {i for i, _ in hitters}
        true_heavy = {i for (k2, s2, i), c in per_item.items()
                      if k2 == key and s2 == s
                      and c >= 0.1 * per_key[(key, s)]}
        assert true_heavy <= hit_items
        for i, est in hitters:
            assert est >= per_item[(key, s, i)]


def test_top_k_selects_dominant_items():
    keys, items, ts = _zipfish(30000, 3, 3, 1000, seed=2, heavy_frac=0.8)
    hh = _both((keys, items, ts), k=3, depth=4, width=8192)
    assert len(hh.hh_emitted) == 6
    for key, hitters, s, e in hh.hh_emitted:
        assert len(hitters) <= 3
        assert {i for i, _ in hitters} == {0, 1, 2}
        ests = [est for _, est in hitters]
        assert ests == sorted(ests, reverse=True)


def test_narrow_sketch_overestimates_but_never_under():
    """A 64-wide sketch collides: estimates exceed the truth, never
    fall below it, and the port's equal the reference's."""
    keys, items, ts = _zipfish(20000, 40, 8, 3000, seed=4)
    hh = _both((keys, items, ts), phi=0.05, depth=3, width=64)
    per_item, _ = _truth(keys, items, ts)
    over = 0
    for key, hitters, s, _ in hh.hh_emitted:
        for i, est in hitters:
            assert est >= per_item[(key, s, i)]
            over += est > per_item[(key, s, i)]
    assert over > 0


def test_candidate_cap_raises():
    hh = WindowedHeavyHitters(1000, phi=0.5, max_candidates_per_window=10,
                              device="cpu")
    with pytest.raises(RuntimeError, match="candidates"):
        hh.process_items(np.zeros(100, np.int64), np.full(100, 10),
                         np.arange(100))


def test_late_records_do_not_create_candidates():
    hh = WindowedHeavyHitters(1000, phi=0.01, device="cpu")
    hh.process_items(np.array([1]), np.array([100]), np.array([7]))
    hh.advance_watermark(999)
    assert [(k, s) for k, _, s, _ in hh.hh_emitted] == [(1, 0)]
    before = len(hh.hh_emitted)
    hh.process_items(np.array([1]), np.array([200]), np.array([8]))  # late
    hh.advance_watermark(1999)
    assert len(hh.hh_emitted) == before
    assert hh.num_late_dropped == 1


def test_needs_phi_or_k():
    with pytest.raises(ValueError, match="phi"):
        WindowedHeavyHitters(1000, device="cpu")
