"""The port's host runtime (flink_tpu_torch/native) against the JAX
package's (flink_tpu.native) on the same arrays.  The C++ is the same
code, so every result is bit-equal; the slot index is also held, as a
key -> slot map, against the numpy VectorizedSlotIndex."""

import numpy as np
import pytest

import flink_tpu.native as jn
import flink_tpu_torch.native as tn
from flink_tpu_torch.streaming.vectorized import VectorizedSlotIndex

SENTINEL = 0x9E3779B97F4A7C15   # the C++ tables' remap of hash 0


def _keys(rng, n, n_keys, signed=False):
    k = rng.integers(-n_keys if signed else 0, n_keys, n)
    k[:5] = 0
    return k.astype(np.int64).view(np.uint64)


def _eq(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            _eq(x, y)
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_library_builds_into_the_package():
    path = tn.build()
    assert path.parent.name == "_build" and path.parent.parent.name == "native"
    assert path.parent.parent.parent.name == "flink_tpu_torch"
    assert tn.lib() is tn.lib()


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "host_runtime.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tn, "_SRC", bad)
    monkeypatch.setattr(tn, "_BUILD", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        tn.build()


def test_hashing_bit_equal():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 2**63, 5000, dtype=np.int64).view(np.uint64)
    x[:3] = (0, 1, SENTINEL)
    np.testing.assert_array_equal(tn.splitmix64(x), jn.splitmix64(x))
    for par, shards in ((128, 1), (128, 4), (4096, 7)):
        np.testing.assert_array_equal(tn.key_groups(x, par, shards),
                                      jn.key_groups(x, par, shards))


class _Arena:
    def __init__(self):
        self.next = 0

    def __call__(self, n):
        out = np.arange(self.next, self.next + n)
        self.next += n
        return out


def test_slot_index_matches_reference_and_numpy_twin():
    rng = np.random.default_rng(2)
    t, j, v = tn.NativeSlotIndex(16), jn.NativeSlotIndex(16), VectorizedSlotIndex(16)
    at, aj, av = _Arena(), _Arena(), _Arena()
    seen_t, seen_v = {}, {}
    for _ in range(6):
        h = rng.integers(0, 3000, 4000).astype(np.uint64)
        h[:4] = (0, SENTINEL, 0, SENTINEL)
        st, ft = t.lookup_or_insert(h, at)
        sj, _, fj = j.lookup_or_insert(h, aj)
        sv, fv = v.lookup_or_insert(h, av)
        np.testing.assert_array_equal(st, sj)
        np.testing.assert_array_equal(ft, fj)
        # the numpy twin numbers slots in another order: the two must
        # agree as a key -> slot map up to a bijection of slot numbers
        for key, a, b in zip(h.tolist(), st.tolist(), sv.tolist()):
            assert seen_t.setdefault(key, a) == a
            assert seen_v.setdefault(key, b) == b
        assert len(set(zip(st.tolist(), sv.tolist()))) == len(set(st.tolist()))
        assert sorted(np.asarray(h)[ft].tolist()) == sorted(np.asarray(h)[fv].tolist())
    assert t.n == j.n == v.n
    _eq(t.export(), j.export())
    # restore into a fresh index from the export
    hashes, slots = t.export()
    r = tn.NativeSlotIndex(8)
    r.set_bulk(hashes, slots)
    got, new = r.lookup_or_insert(hashes, _Arena())
    np.testing.assert_array_equal(got, slots)
    assert len(new) == 0


@pytest.mark.parametrize("signed", [False, True])
def test_hll_log_functions_bit_equal(signed):
    rng = np.random.default_rng(3)
    n, p = 30_000, 10
    keys = _keys(rng, n, 500, signed)
    keys[5:9] = SENTINEL
    vh = jn.splitmix64(rng.integers(0, 2**40, n).astype(np.uint64))
    cells_t, cells_j = tn.hll_make_cells(vh, p), jn.hll_make_cells(vh, p)
    _eq(cells_t, cells_j)
    regs, ranks = cells_t
    _eq(tn.hll_log_compact(keys, regs, ranks, p),
        jn.hll_log_compact(keys, regs, ranks, p))
    kt, et = tn.hll_log_fire(keys, regs, ranks, p)
    kj, ej = jn.hll_log_fire(keys, regs, ranks, p)
    np.testing.assert_array_equal(kt, kj)
    assert et.tobytes() == ej.tobytes()
    assert 0 in kt.tolist() and SENTINEL in kt.tolist()
    with pytest.raises(ValueError):
        tn.hll_make_cells(vh, 17)


def test_sum_log_and_sum_table_spill_bit_equal():
    rng = np.random.default_rng(4)
    keys = _keys(rng, 40_000, 5000)
    keys[5:9] = SENTINEL
    vals = rng.random(40_000)
    _eq(tn.sum_log_fire(keys, vals), jn.sum_log_fire(keys, vals))
    t, j = tn.NativeSumTable(16), jn.NativeSumTable(16)
    for i in range(0, 40_000, 4096):
        ct = t.ingest(keys[i:i + 4096], vals[i:i + 4096], 1 << 10)
        cj = j.ingest(keys[i:i + 4096], vals[i:i + 4096], 1 << 10)
        assert ct == cj
        if ct < len(keys[i:i + 4096]):
            break
    assert ct < 4096            # the distinct cap was hit: the spill point
    assert t.n == j.n
    _eq(t.export(), j.export())


def test_quantile_log_functions_bit_equal():
    rng = np.random.default_rng(5)
    n, nb = 20_000, 300
    keys = _keys(rng, n, 80)
    buckets = rng.integers(0, nb, n).astype(np.uint16)
    q, lg, off, corr = (0.5, 0.9, 0.99), np.log(1.1), -70, 1.0
    ct = tn.qsketch_log_compact(keys, buckets, None, nb)
    cj = jn.qsketch_log_compact(keys, buckets, None, nb)
    _eq(ct, cj)
    _eq(tn.qsketch_log_fire(keys, buckets, nb, q, lg, off, corr),
        jn.qsketch_log_fire(keys, buckets, nb, q, lg, off, corr))
    _eq(tn.qsketch_log_fire(ct[0], ct[1], nb, q, lg, off, corr, counts=ct[2]),
        jn.qsketch_log_fire(cj[0], cj[1], nb, q, lg, off, corr, counts=cj[2]))


def test_session_log_fire_bit_equal_with_retained_rows():
    rng = np.random.default_rng(6)
    n = 12_000
    keys = _keys(rng, n, 300)
    ts = np.sort(rng.integers(0, 30_000, n)).astype(np.int64)
    w = rng.integers(1, 5, n).astype(np.float32)
    vh = rng.integers(0, 2**63, n).astype(np.uint64)
    ret_t = ret_j = None
    for lo_, hi_ in ((0, 5000), (5000, n)):
        sl = slice(lo_, hi_)
        wm = int(ts[hi_ - 1]) - 1 if hi_ < n else 10**9
        out_t = tn.session_log_fire(keys[sl], ts[sl], w[sl], vh[sl], 500, wm,
                                    4, 64, retained=ret_t)
        out_j = jn.session_log_fire(keys[sl], ts[sl], w[sl], vh[sl], 500, wm,
                                    4, 64, retained=ret_j)
        _eq(out_t, out_j)
        ret_t, ret_j = out_t[4], out_j[4]
    assert len(ret_t[0]) == 0


@pytest.mark.parametrize("kind", ["U", "S"])
def test_interner_ids_and_first_idx_bit_equal(kind):
    rng = np.random.default_rng(7)
    t, j = tn.NativeStringInterner(16), jn.NativeStringInterner(16)
    for _ in range(3):
        words = np.array([f"w{i}" if i % 17 else "" for i in
                          rng.integers(0, 400, 3000)]).astype(kind)
        ids_t, first_t = t.intern(words)
        ids_j, first_j = j.intern(words)
        np.testing.assert_array_equal(ids_t, ids_j)
        np.testing.assert_array_equal(first_t, first_j)
    assert t.n == j.n
    empty = np.zeros(4, dtype=f"{kind}0")            # zero-width rows
    _eq(t.intern(empty), j.intern(empty))


def test_word_sums_bit_equal():
    rng = np.random.default_rng(8)
    it, ij = tn.NativeStringInterner(), jn.NativeStringInterner()
    wt, wj = tn.NativeWordSums(), jn.NativeWordSums()
    for weights in (None, rng.random(20_000)):
        words = np.array([f"word{i}" for i in rng.integers(0, 900, 20_000)])
        np.testing.assert_array_equal(wt.add(it, words, weights),
                                      wj.add(ij, words, weights))
    assert wt.touched == wj.touched
    ft, fj = wt.fire(), wj.fire()
    _eq(ft, fj)
    assert wt.touched == 0
    wt.load(*ft)
    wj.load(*fj)
    _eq(wt.fire(), wj.fire())


def _iv_batches(rng, n_batches, n, n_keys, span, zero_keys=False):
    """Time-sorted batches of (key hashes, timestamps), advancing."""
    out = []
    t0 = 0
    for _ in range(n_batches):
        kh = rng.integers(1, n_keys + 1, n).astype(np.uint64)
        if zero_keys:
            kh[:3] = 0
        ts = np.sort(rng.integers(t0, t0 + span, n)).astype(np.int64)
        t0 += span // 2
        out.append((kh, ts))
    return out


def _numpy_pairs(side, kh, ts, base, other, alive, lower, upper):
    """Pairs of a batch of ``side`` with the live rows of the other side
    by sort and searchsorted on (key, time): (left row, right row)."""
    if not other:
        return set()
    okh = np.array([r[0] for r in other], np.int64)
    ots = np.array([r[1] for r in other], np.int64)
    bias = 1 << 24
    comp = np.where(alive, (okh << 32) | (ots + bias), -1)
    order = np.argsort(comp, kind="stable")
    sc = comp[order]
    lo_off, hi_off = (lower, upper) if side == 0 else (-upper, -lower)
    k64 = kh.astype(np.int64) << 32
    lo = np.searchsorted(sc, k64 | (ts + lo_off + bias), "left")
    hi = np.searchsorted(sc, k64 | (ts + hi_off + bias), "right")
    out = set()
    for k in range(len(kh)):
        for r in order[lo[k]:hi[k]].tolist():
            out.add((base + k, r) if side == 0 else (r, base + k))
    return out


@pytest.mark.parametrize("lower,upper,n,n_keys", [
    (-50, 50, 200, 20),       # symmetric; counting sort of the batch
    (0, 0, 500, 5),           # equal times only
    (-300, -100, 3000, 40),   # the right side strictly earlier
    (10, 400, 300, 5000),     # small batches of many keys: comparison sort
])
def test_interval_join_pairs_and_prune_bit_equal(lower, upper, n, n_keys):
    """The batched interval join core: pairs (global row ids per side,
    in the core's order) after every push, with prunes between, equal
    to the reference's on the same hashes and timestamps, and equal as
    a set to a numpy join of the live rows."""
    rng = np.random.default_rng(n + n_keys)
    steps = _iv_batches(rng, 12, n, n_keys, 2000, zero_keys=True)
    t = tn.NativeIntervalJoin(lower, upper, capacity=16)
    j = jn.NativeIntervalJoin(lower, upper, capacity=16)
    rows = {0: [], 1: []}
    wm = -(2 ** 63)
    for i, (kh, ts) in enumerate(steps):
        side = i % 2
        got = t.push(side, kh, ts)
        _eq(got, j.push(side, kh, ts))
        horizon = upper if side == 1 else -lower
        other = rows[1 - side]
        alive = np.array([r[1] + horizon > wm for r in other], bool)
        want = _numpy_pairs(side, kh, ts, len(rows[side]), other, alive,
                            lower, upper)
        assert set(zip(got[0].tolist(), got[1].tolist())) == want
        rows[side] += list(zip(kh.tolist(), ts.tolist()))
        wm = int(ts[len(ts) // 2])
        t.prune(wm)
        j.prune(wm)


def test_interval_join_empty_push_and_free():
    t = tn.NativeIntervalJoin(-5, 5)
    e = np.empty(0, np.uint64), np.empty(0, np.int64)
    left, right = t.push(0, *e)
    assert len(left) == len(right) == 0
    t.prune(10)
    del t
