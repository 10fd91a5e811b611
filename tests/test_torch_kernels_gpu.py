"""Each hand-written CUDA kernel against its plain PyTorch version, on
the card.  Marked ``gpu``: without a CUDA device every test skips (the
fixture decides, never the import).  On a machine with a card:

    python -m pytest -m gpu --noconftest tests/test_torch_kernels_gpu.py

Registers, integer results, fills, Count-Min tables and queries,
quantile histograms, quantile results and shard_pack's buckets must be
bit-equal (the quantile plain version runs on the card, so both take
the card's float32 log); HLL estimates agree within rtol 1e-5 (the kernel's
reduction order differs from the plain version's); float32 sums use
integer-valued data, which float atomics add exactly in any order, or
are held within the bound of a sum taken in another order.  Popcounts
and KNN indices (ties included) are bit-equal.
"""

import numpy as np
import pytest
import torch

from flink_tpu_torch import kernels as K

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    K.build_all()
    return torch.device("cuda")


def _lanes(rng, n):
    hi = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    hi[: n // 16] >>= rng.integers(0, 32, n // 16).astype(np.uint32)
    hi[:3] = 0                      # rank 33
    return hi, lo


@pytest.mark.parametrize("form", ["raw", "u16", "u32"])
def test_hll_update_matches_plain(cuda, form):
    rng = np.random.default_rng(1)
    c, p, n_rows = 3000, 10, 40_000
    m = 1 << p
    slots = rng.integers(-2, c + 2, n_rows).astype(np.int32)   # a few OOB
    hi, lo = _lanes(rng, n_rows)
    if form == "raw":
        h, l_ = torch.from_numpy(hi.view(np.int32)), torch.from_numpy(lo.view(np.int32))
    else:
        x = hi.astype(np.float64)
        clz = np.where(hi == 0, 32, 31 - np.floor(np.log2(np.maximum(x, 1.0))).astype(np.int64))
        h = torch.from_numpy((clz + 1).astype(np.uint8))
        rdt = np.int16 if form == "u16" else np.int32
        l_ = torch.from_numpy((lo & (m - 1)).astype(rdt))
    n = n_rows - 1234                                        # masked tail
    base = torch.from_numpy(rng.integers(0, 3, (c, m)).astype(np.uint8))
    ref = base.clone()
    K.hll_update_plain(ref, torch.from_numpy(slots), h, l_, n)
    got = base.to(cuda)
    before = K.LAUNCHES["hll_update"]
    K.hll_update(got, torch.from_numpy(slots).to(cuda), h.to(cuda), l_.to(cuda), n)
    torch.cuda.synchronize()
    assert K.LAUNCHES["hll_update"] == before + 1
    assert torch.equal(got.cpu(), ref)


def test_hll_estimate_matches_plain(cuda):
    rng = np.random.default_rng(2)
    c, m = 5000, 4096
    regs = torch.from_numpy(rng.integers(0, 20, (c, m)).astype(np.uint8))
    regs[:100] = 0
    regs[100:200, :3000] = 0                                 # linear counting
    regs[200:210] = 40
    g = regs.to(cuda)
    alpha = 0.7213 / (1.0 + 1.079 / m)
    slots = torch.from_numpy(rng.integers(0, c, 777).astype(np.int32))
    # dense form, dense form over a row slice (a contiguous tile), gathered form
    for lo, hi, sl in ((0, c, None), (77, 1077, None), (0, c, slots)):
        ref = K.hll_estimate_plain(regs[lo:hi], alpha, sl)
        got = K.hll_estimate(g[lo:hi], alpha, None if sl is None else sl.to(cuda)).cpu()
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5)


@pytest.mark.parametrize("dtype,op", [
    (dt, op) for dt in (torch.float32, torch.int32) for op in ("add", "min", "max")
] + [(torch.int32, "count")])                          # counts are int32 state
def test_scatter_combine_matches_plain(cuda, dtype, op):
    rng = np.random.default_rng(3)
    c, n_rows = 500, 100_000
    slots = torch.from_numpy(rng.integers(-1, c + 1, n_rows).astype(np.int32))
    vals = torch.from_numpy(rng.integers(-1000, 1000, n_rows)).to(dtype)
    if op == "count":
        vals = None
    base = torch.from_numpy(rng.integers(-50, 50, c)).to(dtype)
    ref = base.clone()
    n = n_rows - 999
    K.scatter_combine_plain(ref, slots, vals, n, "add" if op == "count" else op)
    got = base.to(cuda)
    K.scatter_combine(got, slots.to(cuda), None if vals is None else vals.to(cuda),
                      n, "add" if op == "count" else op)
    assert torch.equal(got.cpu(), ref)


def _same_bits(got, want):
    """Bit for bit, except that a NaN equals any NaN."""
    got, want = got.cpu(), want.cpu()
    if got.dtype != torch.float32:
        return torch.equal(got, want)
    gn, wn = torch.isnan(got), torch.isnan(want)
    return torch.equal(gn, wn) and torch.equal(
        got[~gn].view(torch.int32), want[~wn].view(torch.int32))


_SPECIAL = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1.5, -1.5],
                    np.float32)


@pytest.mark.parametrize("slots_kind", ["uniform", "zipf"])
@pytest.mark.parametrize("dtype,op", [
    (dt, op) for dt in (torch.float32, torch.int32) for op in ("add", "min", "max")
] + [(torch.int32, "count"), (torch.float32, "count")])
def test_scatter_combine_edges_match_plain(cuda, dtype, op, slots_kind):
    """Every op and dtype: NaN, +-0 and
    +-inf in the values and in the state (float32 min/max in the
    reference's order), out-of-range slots, a uniform or a Zipf slot
    column, row counts that are no multiple of 4 or 8, and slot and
    value columns that start off their 16-byte alignment (the same
    offset, and offsets that differ)."""
    rng = np.random.default_rng(sum(map(ord, f"{dtype}{op}{slots_kind}")))
    c, n_rows = 777, 50_003
    if slots_kind == "zipf":
        slots_np = np.minimum(rng.zipf(1.3, n_rows) - 2, c).astype(np.int32)
    else:
        slots_np = rng.integers(-3, c + 3, n_rows).astype(np.int32)
    if dtype == torch.float32:
        vals_np = rng.integers(-1000, 1000, n_rows).astype(np.float32)
        if op in ("min", "max"):
            pick = rng.random(n_rows) < 0.3
            vals_np[pick] = rng.choice(_SPECIAL, pick.sum())
        base_np = rng.integers(-50, 50, c).astype(np.float32)
        if op in ("min", "max"):
            base_np[:40] = np.resize(np.concatenate(
                [_SPECIAL, np.array([0x7FC00000, 0xFFC00000], np.uint32).view(np.float32)]), 40)
    else:
        info = np.iinfo(np.int32)
        vals_np = rng.integers(info.min, info.max, n_rows, dtype=np.int64).astype(np.int32) \
            if op in ("min", "max") else rng.integers(-1000, 1000, n_rows).astype(np.int32)
        base_np = rng.integers(-50, 50, c).astype(np.int32)
    kind = "add" if op == "count" else op
    for s_off, v_off in ((0, 0), (1, 1), (3, 3), (1, 2), (2, 0)):
        n = n_rows - 17 - max(s_off, v_off)
        slots = torch.from_numpy(slots_np)
        vals = None if op == "count" else torch.from_numpy(vals_np)
        ref = torch.from_numpy(base_np.copy())
        K.scatter_combine_plain(ref, slots[s_off:], None if vals is None else vals[v_off:],
                                n, kind)
        got = torch.from_numpy(base_np.copy()).to(cuda)
        d_slots = slots.to(cuda)[s_off:]
        d_vals = None if vals is None else vals.to(cuda)[v_off:]
        before = K.LAUNCHES["scatter_combine"]
        K.scatter_combine(got, d_slots, d_vals, n, kind)
        torch.cuda.synchronize()
        assert K.LAUNCHES["scatter_combine"] == before + 1
        assert _same_bits(got, ref), (s_off, v_off)


@pytest.mark.parametrize("unique", [False, True])
@pytest.mark.parametrize("op", ["min", "max"])
def test_merge_rows_float_order_matches_plain(cuda, op, unique):
    """float32 min/max merges with NaN, +-0 and +-inf in the dst and src
    rows (the reference's order), both modes."""
    rng = np.random.default_rng(51 if op == "min" else 52)
    c = 3000
    specials = np.concatenate([_SPECIAL, np.array([0x7FC00000, 0xFFC00000],
                                                  np.uint32).view(np.float32)])
    base_np = rng.choice(specials, c).astype(np.float32)
    perm = rng.permutation(c).astype(np.int32)
    if unique:
        dst, src = perm[:800], perm[800:1600]
    else:
        dst = rng.choice(perm[:200], 1500).astype(np.int32)
        src = perm[200:1700]
    dst, src = torch.from_numpy(dst), torch.from_numpy(src)
    ref = torch.from_numpy(base_np.copy())
    K.merge_rows_plain(ref, dst, src, op, unique_dst=unique)
    got = torch.from_numpy(base_np.copy()).to(cuda)
    K.merge_rows(got, dst.to(cuda), src.to(cuda), op, unique_dst=unique)
    torch.cuda.synchronize()
    assert _same_bits(got, ref)


@pytest.mark.parametrize("shape,dtype,fill", [
    ((700, 64), torch.uint8, 0), ((700,), torch.float32, float(np.finfo(np.float32).max)),
    ((700,), torch.int32, -7), ((700, 3), torch.float32, 1.5)])
def test_clear_rows_matches_plain(cuda, shape, dtype, fill):
    rng = np.random.default_rng(4)
    base = torch.from_numpy(rng.integers(1, 100, shape)).to(dtype)
    slots = torch.from_numpy(rng.choice(shape[0], 200, replace=False).astype(np.int32))
    for kw in ({"slots": slots}, {"start": 13, "count": 400}, {}):
        ref = base.clone()
        K.clear_rows_plain(ref, fill, **kw)
        got = base.to(cuda)
        K.clear_rows(got, fill, **{k: (v.to(cuda) if isinstance(v, torch.Tensor) else v)
                                   for k, v in kw.items()})
        assert torch.equal(got.cpu(), ref)


def test_kernel_refuses_a_wrong_dtype(cuda):
    regs = torch.zeros((4, 16), dtype=torch.uint8, device=cuda)
    slots = torch.zeros(2, dtype=torch.int64, device=cuda)
    lanes = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        K.hll_update(regs, slots, lanes, lanes, 2)


@pytest.mark.parametrize("unique", [False, True])
@pytest.mark.parametrize("shape,dtype,op", [
    ((3000, 1024), torch.uint8, "max"), ((3000, 1024), torch.uint8, "min"),
    ((3000,), torch.float32, "add"), ((3000,), torch.float32, "min"),
    ((3000,), torch.float32, "max"), ((3000,), torch.int32, "add"),
    ((3000,), torch.int32, "max"), ((3000, 3), torch.int32, "add")])
def test_merge_rows_matches_plain(cuda, shape, dtype, op, unique):
    rng = np.random.default_rng(5)
    hi = 30 if dtype == torch.uint8 else 1000
    base = torch.from_numpy(rng.integers(0, hi, shape)).to(dtype)
    perm = rng.permutation(shape[0]).astype(np.int32)
    if unique:
        dst, src = perm[:800], perm[800:1600]
    else:                                   # each dst repeats up to 9 times
        dst = rng.choice(perm[:200], 1500).astype(np.int32)
        src = perm[200:1700]
    dst, src = torch.from_numpy(dst), torch.from_numpy(src)
    ref = base.clone()
    K.merge_rows_plain(ref, dst, src, op, unique_dst=unique)
    got = base.to(cuda)
    before = K.LAUNCHES["merge_rows"]
    K.merge_rows(got, dst.to(cuda), src.to(cuda), op, unique_dst=unique)
    torch.cuda.synchronize()
    assert K.LAUNCHES["merge_rows"] == before + 1
    assert torch.equal(got.cpu(), ref)


@pytest.mark.parametrize("shape,dtype", [((2000, 4096), torch.uint8),
                                         ((2000,), torch.float32),
                                         ((2000, 3), torch.int32),
                                         ((2000, 5), torch.uint8)])
@pytest.mark.parametrize("rows_on", ["host", "device"])
def test_set_rows_matches_plain(cuda, shape, dtype, rows_on):
    rng = np.random.default_rng(6)
    base = torch.from_numpy(rng.integers(0, 100, shape)).to(dtype)
    slots = torch.from_numpy(np.concatenate([
        rng.choice(shape[0], 300, replace=False), [-1, shape[0]]]).astype(np.int32))
    rows = torch.from_numpy(rng.integers(100, 200, (302, *shape[1:]))).to(dtype)
    ref = base.clone()
    K.set_rows_plain(ref, slots, rows)
    got = base.to(cuda)
    K.set_rows(got, slots.to(cuda), rows if rows_on == "host" else rows.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ref)


def _cm_inputs(rng, c, n_rows):
    slots = rng.integers(-2, c + 2, n_rows).astype(np.int32)    # a few OOB
    vals = rng.choice(np.float32([1, 1, 2, 3, 2.7, -1.5, 0.4, 1e10, np.nan]),
                      n_rows).astype(np.float32)
    hi, lo = _lanes(rng, n_rows)
    return (torch.from_numpy(slots), torch.from_numpy(vals),
            torch.from_numpy(hi.view(np.int32)), torch.from_numpy(lo.view(np.int32)))


@pytest.mark.parametrize("depth,width", [(4, 2048), (5, 1000)])
def test_countmin_update_and_query_match_plain(cuda, depth, width):
    rng = np.random.default_rng(7)
    c, n_rows = 300, 60_000
    slots, vals, hi, lo = _cm_inputs(rng, c, n_rows)
    n = n_rows - 777                                          # masked tail
    table = torch.from_numpy(rng.integers(0, 5, (c, depth, width)).astype(np.int32))
    total = torch.from_numpy(rng.integers(0, 5, c).astype(np.int32))
    rt, rtot = table.clone(), total.clone()
    K.countmin_update_plain(rt, rtot, slots, vals, hi, lo, n)
    gt, gtot = table.to(cuda), total.to(cuda)
    before = K.LAUNCHES["countmin_update"]
    K.countmin_update(gt, gtot, slots.to(cuda), vals.to(cuda), hi.to(cuda),
                      lo.to(cuda), n)
    torch.cuda.synchronize()
    assert K.LAUNCHES["countmin_update"] == before + 1
    assert torch.equal(gt.cpu(), rt) and torch.equal(gtot.cpu(), rtot)
    qs = slots[:20_000].clone()
    got = K.countmin_query(gt, qs.to(cuda), hi[:20_000].to(cuda), lo[:20_000].to(cuda))
    assert torch.equal(got.cpu(), K.countmin_query_plain(rt, qs, hi[:20_000], lo[:20_000]))


@pytest.mark.parametrize("geometry", [(0.05, 1e-3, 1e6), (0.01, 1e-9, 1e9)])
def test_quantile_update_matches_plain(cuda, geometry):
    from flink_tpu_torch.ops.sketches import QuantileSketchAggregate
    acc, mn, mx = geometry
    agg = QuantileSketchAggregate(relative_accuracy=acc, min_value=mn, max_value=mx)
    rng = np.random.default_rng(8)
    c, n_rows = 500, 200_000
    vals = rng.lognormal(3.0, 2.0, n_rows).astype(np.float32)
    k = rng.integers(-300, 300, 2000)
    vals[:2000] = np.float32(np.exp(k * agg.log_gamma))     # on bucket edges
    vals[2000:2010] = np.float32([0, -1, mn, mn / 2, 1e30, np.inf, -np.inf,
                                  np.nan, 1.0, mx])
    slots = torch.from_numpy(rng.integers(-1, c + 1, n_rows).astype(np.int32))
    v = torch.from_numpy(vals)
    n = n_rows - 321
    # the plain version on the card: its float32 logs are the card's
    ref_d = torch.zeros((c, agg.buckets), dtype=torch.int32, device=cuda)
    K.quantile_update_plain(ref_d, slots.to(cuda), v.to(cuda), n, mn,
                            agg.log_gamma, agg.offset)
    got = torch.zeros((c, agg.buckets), dtype=torch.int32, device=cuda)
    K.quantile_update(got, slots.to(cuda), v.to(cuda), n, mn, agg.log_gamma,
                      agg.offset)
    torch.cuda.synchronize()
    assert torch.equal(got, ref_d)


@pytest.mark.parametrize("geometry", [(0.05, 1e-3, 1e6), (0.01, 1e-9, 1e9)])
def test_quantile_result_matches_plain(cuda, geometry):
    from flink_tpu_torch.ops.sketches import QuantileSketchAggregate
    acc, mn, mx = geometry
    agg = QuantileSketchAggregate(quantiles=(0.0, 0.5, 0.9, 0.99, 1.0),
                                  relative_accuracy=acc, min_value=mn, max_value=mx)
    rng = np.random.default_rng(9)
    c = 3000
    hist = rng.integers(0, 6, (c, agg.buckets)).astype(np.int32)
    hist *= (rng.random((c, agg.buckets)) < 0.03).astype(np.int32)
    hist[:5] = 0                                              # empty slots
    hist[5, :] = 0
    hist[5, -1] = 1
    h = torch.from_numpy(hist)
    qs, bv = agg._tables(torch.device("cpu"))
    gq, gbv = agg._tables(cuda)
    slots = torch.from_numpy(rng.integers(-1, c + 1, 5000).astype(np.int32))
    g = h.to(cuda)
    for lo, hi, sl in ((0, c, None), (100, 1100, None), (0, c, slots)):
        ref = K.quantile_result_plain(h[lo:hi], qs, bv, sl)
        got = K.quantile_result(g[lo:hi], gq, gbv, None if sl is None else sl.to(cuda))
        assert torch.equal(got.cpu(), ref)
    assert (K.quantile_result(g, gq, gbv)[:5] == 0).all()


@pytest.mark.parametrize("p", [4, 12, 16])
def test_hll_log_finish_matches_plain_and_host_fire(cuda, p):
    """Sums bit-equal (exact dyadic float64), estimates bit-equal to the
    plain version and to the C++ host fire."""
    import flink_tpu_torch.native as nat
    from flink_tpu_torch.ops.sketches import HyperLogLogAggregate
    rng = np.random.default_rng(p)
    m = 1 << p
    n = 200_000
    keys = rng.integers(0, 3000, n).astype(np.uint64)
    keys[: 4 * m] = 7                      # one key with every register
    keys[-1] = 2**63 + 5                   # a key with one cell
    vh = rng.integers(0, 2**63, n).astype(np.uint64)
    vh[:40] &= np.uint64(0xFFFFFFFF)       # rank 33
    regs, ranks = nat.hll_make_cells(vh, p)
    _, _, crk, ends = nat.hll_log_compact(keys, regs, ranks, p)
    agg = HyperLogLogAggregate(p)
    r, e = torch.from_numpy(crk), torch.from_numpy(ends)
    want_sum = torch.empty(len(ends), dtype=torch.float64)
    want_est = K.hll_log_finish_plain(r, e, m, agg.alpha, inv_sum=want_sum)
    got_sum = torch.empty(len(ends), dtype=torch.float64, device=cuda)
    before = K.LAUNCHES["hll_log_finish"]
    got_est = K.hll_log_finish(r.to(cuda), e.to(cuda), m, agg.alpha, inv_sum=got_sum)
    torch.cuda.synchronize()
    assert K.LAUNCHES["hll_log_finish"] == before + 1
    assert torch.equal(got_sum.cpu(), want_sum)
    assert torch.equal(got_est.cpu(), want_est)
    assert torch.equal(K.hll_log_finish(r.to(cuda), e.to(cuda), m, agg.alpha).cpu(),
                       want_est)
    _, host = nat.hll_log_fire(keys, regs, ranks, p)
    np.testing.assert_array_equal(got_est.cpu().numpy(), host)


@pytest.mark.parametrize("case", ["empty", "half_full_and_hits", "full", "regions"])
def test_table_insert_matches_plain_as_key_map(cuda, case):
    from flink_tpu_torch.ops.device_table import key_map_faults, make_table
    rng = np.random.default_rng(21)
    cap, max_probes = 50_000, 64
    region = None
    region_size = 0
    n_keys = {"empty": 30_000, "half_full_and_hits": 25_000, "full": 80_000,
              "regions": 6_000}[case]
    keys = rng.integers(0, n_keys, 60_000).astype(np.uint64)
    keys[:100] = 0                                  # key (0, 0), duplicated
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    mask = rng.random(len(keys)) < 0.95
    n = len(keys) - 500
    live = mask & (np.arange(len(keys)) < n)
    if case == "regions":
        region_size = cap // 5
        cap = region_size * 5
        region = rng.integers(0, 5, len(keys)).astype(np.int32)
    plain = make_table(cap, device="cpu")
    card = make_table(cap, device=cuda)
    args = lambda t: (torch.from_numpy(hi.view(np.int32)).to(t),   # noqa: E731
                      torch.from_numpy(lo.view(np.int32)).to(t))
    rounds = 2 if case == "half_full_and_hits" else 1
    for _ in range(rounds):   # the second round is all hits
        ref = K.table_insert_plain(plain.key_hi, plain.key_lo, plain.occupied,
                                   *args("cpu"), n, max_probes,
                                   mask=torch.from_numpy(mask),
                                   region=None if region is None else torch.from_numpy(region),
                                   region_size=region_size).numpy()
        ov = torch.zeros(1, dtype=torch.int64, device=cuda)
        got = K.table_insert(card.key_hi, card.key_lo, card.occupied, *args(cuda),
                             n, max_probes, mask=torch.from_numpy(mask).to(cuda),
                             region=None if region is None
                             else torch.from_numpy(region).to(cuda),
                             region_size=region_size, overflow=ov)
        torch.cuda.synchronize()
        got = got.cpu().numpy()
        faults, _ = key_map_faults(card, hi, lo, got, max_probes, live, region,
                                   region_size,
                                   reference=None if case == "full" else plain)
        assert not any(faults.values()), faults
        assert int(ov) == int((live & (got < 0)).sum())
        assert int(card.occupied.sum()) <= cap
        if case == "full":
            assert int(ov) > 0 and (ref[live] < 0).any()
        else:
            assert int(ov) == 0 and (ref[live] >= 0).all()


@pytest.mark.parametrize("mode", ["plain", "route4", "route128", "window",
                                  "window_wide"])
def test_chain_route_matches_plain(cuda, mode):
    """Order, bounds, count, every moved column and the pane starts bit
    for bit; negative timestamps and a nonzero pane offset in window
    mode; a ragged last tile; 21 columns, more than one launch of the
    scatter moves ("window_wide")."""
    rng = np.random.default_rng(13)
    n = (1 << 18) + 77
    key = rng.integers(-2**62, 2**62, n)
    keep = rng.random(n) > 1 / 7
    ts = rng.integers(-10**6, 10**6, n)
    cols = [key, rng.random(n), rng.random(n).astype(np.float32),
            rng.integers(-2**15, 2**15, n).astype(np.int16),
            rng.integers(0, 256, n).astype(np.uint8), rng.random(n) > 0.5, ts]
    if mode == "window_wide":
        cols, mode = cols * 3, "window"
    nch = {"route4": 4, "route128": 128}.get(mode, 0)
    kw = dict(num_channels=nch, max_parallelism=128 if nch else 0,
              pane_offset=37 if mode == "window" else 0,
              slide=1000 if mode == "window" else 0)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))   # noqa: E731
    want = K.chain_route_plain([t(c).to(cuda) for c in cols], t(keep).to(cuda),
                               t(key).to(cuda) if nch else None,
                               ts=t(ts).to(cuda) if mode == "window" else None, **kw)
    before = K.LAUNCHES["chain_route"]
    got = K.chain_route([t(c).to(cuda) for c in cols], t(keep).to(cuda),
                        t(key).to(cuda) if nch else None,
                        ts=t(ts).to(cuda) if mode == "window" else None, **kw)
    torch.cuda.synchronize()
    assert K.LAUNCHES["chain_route"] == before + 1
    assert np.array_equal(got[2], want[2])
    assert got[2][-1] == keep.sum()
    for g, w in zip(got[0], want[0]):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w.cpu())
    if mode == "window":
        assert torch.equal(got[1].cpu(), want[1].cpu())
    else:
        assert got[1] is None


@pytest.mark.parametrize("mode", ["plain", "route4", "window"])
def test_chain_route_row_shards_match_plain(cuda, mode):
    """The mesh leg's composite classes (8 shards of 2^15 rows, the last
    one short): class starts bit-equal, and every shard's kept rows and
    pane starts at their places bit for bit."""
    from torch_port_util import shard_bounds
    rng = np.random.default_rng(31)
    S, m = 8, 1 << 15
    n = S * m - 1001
    key = rng.integers(-2**62, 2**62, n)
    keep = rng.random(n) > 1 / 7
    ts = rng.integers(-10**6, 10**6, n)
    cols = [key, rng.random(n).astype(np.float32),
            rng.integers(0, 256, n).astype(np.uint8), ts]
    nch = 4 if mode == "route4" else 0
    nclass = nch + 1 if nch else 2
    kw = dict(num_channels=nch, max_parallelism=128 if nch else 0,
              pane_offset=37 if mode == "window" else 0,
              slide=1000 if mode == "window" else 0, shard_rows=m, n_shards=S)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)   # noqa: E731
    args = lambda: ([t(c) for c in cols], t(keep), t(key) if nch else None)  # noqa: E731
    want = K.chain_route_plain(*args(), ts=t(ts) if mode == "window" else None, **kw)
    got = K.chain_route(*args(), ts=t(ts) if mode == "window" else None, **kw)
    torch.cuda.synchronize()
    assert np.array_equal(got[2], want[2]) and len(got[2]) == S * nclass
    counts, _ = shard_bounds(got[2], S, nclass)
    kept = np.concatenate([np.arange(got[2][s * nclass],
                                     got[2][s * nclass] + counts[s])
                           for s in range(S)])
    idx = torch.from_numpy(kept).to(cuda)
    for g, w in zip(got[0], want[0]):
        assert torch.equal(g[idx].cpu(), w[idx].cpu())
    if mode == "window":
        assert torch.equal(got[1][idx].cpu(), want[1][idx].cpu())


@pytest.mark.parametrize("case", ["ragged_n", "shard_below_a_tile",
                                  "shard_not_a_tile_multiple", "empty_shard",
                                  "one_class", "classes_2048", "columns_17",
                                  "widths_1_2", "window_negative"])
def test_chain_route_edge_cases(cuda, case):
    """The tiled kernel's edges, each bit-equal to the plain version (with
    row shards: the class starts and every shard's kept rows): n not a
    multiple of the 4096-row tile, shards shorter than a tile and shards
    that end inside one, an empty last shard, every row in one class,
    2047 channels (2048 classes), 17 columns (two scatter launches), 1-
    and 2-byte columns, panes of negative timestamps; and the launch's
    device starts equal to the host ones."""
    from torch_port_util import shard_bounds
    rng = np.random.default_rng(sum(map(ord, case)))
    n, nch, S, m = 3 * 4096 + 1234, 4, 0, 0
    if case == "shard_below_a_tile":
        S, m = 8, 1000
        n = S * m - 77
    elif case == "shard_not_a_tile_multiple":
        S, m = 5, 4096 + 2049
        n = S * m - 300
    elif case == "empty_shard":
        S, m = 6, 5000
        n = 4 * m + 10                 # shard 5 holds nothing
    elif case == "classes_2048":
        nch, n = 2047, 200_000
    key = rng.integers(-2**62, 2**62, n)
    keep = rng.random(n) > 1 / 7
    if case == "one_class":
        keep[:] = True
        nch = 1
    ts = rng.integers(-10**6, 10**6, n) - (10**6 if case == "window_negative" else 0)
    cols = [key, rng.integers(-2**31, 2**31, n).astype(np.int32), ts]
    if case == "columns_17":
        cols = [rng.integers(-2**62, 2**62, n) for _ in range(17)]
    if case == "widths_1_2":
        cols = [rng.integers(-128, 128, n).astype(np.int8),
                rng.integers(-2**15, 2**15, n).astype(np.int16),
                rng.random(n) > 0.5, rng.integers(0, 256, n).astype(np.uint8)]
    window = case == "window_negative"
    kw = dict(num_channels=0 if window else nch,
              max_parallelism=0 if window else max(128, nch),
              pane_offset=-37 if window else 0, slide=1000 if window else 0,
              shard_rows=m, n_shards=S)
    nclass = 2 if window else nch + 1
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)   # noqa: E731
    args = lambda: ([t(c) for c in cols], t(keep), None if window else t(key))  # noqa: E731
    tsd = t(ts) if window else None
    want = K.chain_route_plain(*args(), ts=tsd, **kw)
    got = K.chain_route(*args(), ts=tsd, **kw)
    dev_starts = K.chain_route_launch(*args(), ts=tsd, **kw)[2]
    torch.cuda.synchronize()
    assert np.array_equal(got[2], want[2])
    assert np.array_equal(dev_starts.cpu().numpy(), got[2])
    if S:
        counts, _ = shard_bounds(got[2], S, nclass)
        idx = torch.from_numpy(np.concatenate([
            np.arange(got[2][s * nclass], got[2][s * nclass] + counts[s])
            for s in range(S)])).to(cuda)
        if case == "empty_shard":
            assert counts[-1] == 0 and got[2][-nclass] == n
    else:
        assert got[2][-1] == keep.sum()
        idx = torch.arange(int(got[2][-1]), device=cuda)
    for g, w in zip(got[0], want[0]):
        assert g.dtype == w.dtype and torch.equal(g[idx].cpu(), w[idx].cpu())
    if window:
        assert torch.equal(got[1][idx].cpu(), want[1][idx].cpu())
        assert bool((got[1] < 0).any())


@pytest.mark.parametrize("layout", ["lanes_hashed", "lanes_target", "rows",
                                    "rows_over_cap"])
def test_shard_pack_matches_plain(cuda, layout):
    """Buckets (padding rows zero), counts and the packed mask lane bit
    for bit: the mesh engines' layout (lanes of 1, 4 and 8 bytes, targets
    from the key hash with a mask) and the mesh log's (K = 6 lanes of a
    row, given targets, a cap some buckets overflow)."""
    rng = np.random.default_rng(32)
    S, m = 8, 1 << 14
    n = S * m
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)   # noqa: E731
    lo = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    mask = rng.random(n) > 0.2
    tgt = rng.integers(0, S + 1, n).astype(np.int32)
    if layout.startswith("lanes"):
        lanes = [t(lo.view(np.int32)), t(rng.random(n).astype(np.float32)),
                 t(rng.integers(-2**62, 2**62, n)), t(mask)]
        kw = (dict(hash_lo=t(lo.view(np.int32)), max_parallelism=128,
                   mask=t(mask)) if layout == "lanes_hashed"
              else dict(target=t(tgt)))
        cap = m
    else:
        lanes = t(rng.integers(0, 2**31, (n, 6)).astype(np.int32))
        if layout == "rows_over_cap":
            tgt[rng.random(n) < 0.6] = 2
        kw = dict(target=t(tgt))
        cap = 4 * m // S
    want = K.shard_pack_plain(lanes, S, cap, **kw)
    before = K.LAUNCHES["shard_pack"]
    got = K.shard_pack(lanes, S, cap, **kw)
    torch.cuda.synchronize()
    assert K.LAUNCHES["shard_pack"] == before + 1
    assert torch.equal(got[1], want[1])
    if layout == "rows_over_cap":
        assert int(want[1].max()) == cap
    pairs = zip(got[0], want[0]) if isinstance(got[0], list) else [(got[0], want[0])]
    for g, w in pairs:
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.parametrize("case", ["m_not_a_tile_multiple", "one_shard",
                                  "one_source", "all_in_one_bucket_over_cap",
                                  "mask_all_false", "widths_1_2_4_8",
                                  "rows_k1", "rows_k3", "rows_k16"])
def test_shard_pack_edge_cases(cuda, case):
    """The tiled kernel's edges, each bit-equal to the plain version:
    a source block that ends inside a tile (m not a multiple of 4096),
    S = 1, one source, every row in one bucket past its cap, a mask that
    sends nothing, lanes of 1, 2, 4 and 8 bytes, and rows of 1, 3 and 16
    32-bit lanes (moved as 4, 12 and 64-byte rows)."""
    rng = np.random.default_rng(sum(map(ord, case)))
    S, m, sources = 8, 4096 * 3 + 123, None
    if case == "one_shard":
        S, m = 1, 20_000
    elif case == "one_source":
        sources, m = 1, 50_000
    n = m * (S if sources is None else sources)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)   # noqa: E731
    tgt = rng.integers(0, S + 1, n).astype(np.int32)
    lo = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    kw = dict(target=t(tgt))
    cap = m
    if case.startswith("rows"):
        k = int(case[len("rows_k"):])
        lanes = t(rng.integers(-2**31, 2**31, (n, k)).astype(np.int32))
        cap = m // 3
    else:
        lanes = [t(rng.integers(-128, 128, n).astype(np.int8)),
                 t(rng.integers(-2**15, 2**15, n).astype(np.int16)),
                 t(rng.random(n).astype(np.float32)),
                 t(rng.integers(-2**62, 2**62, n)),
                 t(rng.random(n) < 0.5)]
        if case == "all_in_one_bucket_over_cap":
            kw = dict(target=t(np.full(n, 3, np.int32)))
            cap = m // 5
        elif case == "mask_all_false":
            kw = dict(hash_lo=t(lo.view(np.int32)), max_parallelism=128,
                      mask=t(np.zeros(n, bool)))
    want = K.shard_pack_plain(lanes, S, cap, sources=sources, **kw)
    before = K.LAUNCHES["shard_pack"]
    got = K.shard_pack(lanes, S, cap, sources=sources, **kw)
    torch.cuda.synchronize()
    assert K.LAUNCHES["shard_pack"] == before + 1
    assert torch.equal(got[1], want[1])
    if case == "all_in_one_bucket_over_cap":
        assert int(want[1][:, 3].min()) == cap and int(want[1].sum()) == cap * S
    if case == "mask_all_false":
        assert int(want[1].sum()) == 0
    pairs = zip(got[0], want[0]) if isinstance(got[0], list) else [(got[0], want[0])]
    for g, w in pairs:
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.cpu(), w.cpu())


def test_fused_chain_on_the_card_matches_per_operator(cuda):
    from flink_tpu_torch.core.functions import _FieldKeySelector
    from flink_tpu_torch.core.functions import as_filter_function, as_map_function
    from flink_tpu_torch.streaming import chain_fusion as cf
    from flink_tpu_torch.streaming.elements import RecordBatch
    from flink_tpu_torch.streaming.operators import StreamFilter, StreamMap
    from flink_tpu_torch.streaming.partitioners import KeyGroupStreamPartitioner

    class _Ch:
        def __init__(self):
            self.got = []

        def push(self, element):
            self.got.append(element)

    class _Router:
        def __init__(self):
            self.part = KeyGroupStreamPartitioner(_FieldKeySelector(0), 128)
            self.channels = [_Ch() for _ in range(4)]
            self.routes = [(self.part, self.channels, None)]

        def collect_batch(self, batch):
            for idx, sub in self.part.split_batch(batch, 4):
                self.channels[idx].push(sub)

    class _Next:
        def __init__(self, op):
            self.op = op

        def collect_batch(self, batch):
            self.op.process_batch(batch)

    def chain(router):
        m = StreamMap(as_map_function(lambda t: (t[0], t[1] * 3, t[2] / 2)))
        f = StreamFilter(as_filter_function(lambda t: t[1] % 7 != 0))
        m.setup(_Next(f))
        f.setup(router)
        return m, f

    rng = np.random.default_rng(17)
    n = 1 << 16
    cols = {"f0": rng.integers(0, 10**6, n), "f1": rng.integers(0, 10**6, n),
            "f2": rng.integers(-10**6, 10**6, n)}
    ts = rng.integers(0, 10**4, n)
    ref, fused = _Router(), _Router()
    chain(ref)[0].process_batch(RecordBatch(dict(cols), ts.copy()))
    m, f = chain(fused)
    prog = cf.compile_chain([m, f], router=fused, device=cuda)
    before = K.LAUNCHES["chain_route"]
    prog.run(RecordBatch(dict(cols), ts.copy()))
    assert prog.active, prog.demoted_reason
    assert K.LAUNCHES["chain_route"] == before + 1
    for a, b in zip(fused.channels, ref.channels):
        assert len(a.got) == len(b.got) == 1
        (ga,), (gb,) = a.got, b.got
        assert list(ga.cols) == list(gb.cols)
        for k in gb.cols:
            assert ga.cols[k].dtype == gb.cols[k].dtype
            assert np.array_equal(ga.cols[k], gb.cols[k])
        assert np.array_equal(ga.ts, gb.ts)


# ---------------------------------------------------------------------
# the graph and ML kernels
# ---------------------------------------------------------------------

EPS32 = float(np.finfo(np.float32).eps)


def _sum_reorder_bound(terms, abs_sum):
    """Two float32 sums of the same ``terms`` numbers in any orders
    differ by at most 2 * terms * eps * (sum of their magnitudes)."""
    return 2.0 * terms * EPS32 * abs_sum


def _kronecker(rng, scale, edge_factor=16):
    """Graph500's Kronecker edges (A, B, C = 0.57, 0.19, 0.19), labels
    permuted: a power-law in-degree with many empty rows."""
    m = edge_factor << scale
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    for bit in range(scale):
        ii = rng.random(m) > 0.76
        jj = rng.random(m) > np.where(ii, 0.19 / 0.24, 0.57 / 0.76)
        src |= ii.astype(np.int64) << bit
        dst |= jj.astype(np.int64) << bit
    perm = rng.permutation(1 << scale)
    return perm[src], perm[dst]


def _segment_case(cuda, case, rng):
    """(x on the card, its plan, src, dst, n) of one test graph."""
    if case == "kronecker_hub":
        scale = 16
        src, dst = _kronecker(rng, scale)
        n = 1 << scale
        hub = np.full(120_000, 12_345)        # a row of >= 10^5 edges
        src = np.concatenate([src, rng.integers(0, n, len(hub))])
        dst = np.concatenate([dst, hub])
    elif case == "uniform":
        n, e = 100_000, 1 << 20
        src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    else:                                     # tiny: one tile
        n, e = 7, 5000
        src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    t = lambda a: torch.from_numpy(a.astype(np.int32)).to(cuda)  # noqa: E731
    plan = K.segment_plan(t(src), t(dst), n)
    return plan, t(src), t(dst), n


@pytest.mark.parametrize("case", ["kronecker_hub", "uniform", "tiny"])
def test_gather_segment_sum_matches_plain(cuda, case):
    """Within the reorder bound of the plain version (index_add_ with
    atomics); integer-valued x (sums below 2^24) exactly; two launches
    bit-identical."""
    rng = np.random.default_rng(21)
    plan, src, dst, n = _segment_case(cuda, case, rng)
    deg = torch.bincount(dst.long(), minlength=n).double()
    if case == "kronecker_hub":
        assert int(deg.max()) >= 100_000
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(cuda)
    before = K.LAUNCHES["gather_segment_sum"]
    got = K.gather_segment_sum(x, plan)
    assert K.LAUNCHES["gather_segment_sum"] == before + 1
    again = K.gather_segment_sum(x, plan)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = K.gather_segment_sum_plain(x, plan)
    mag = K.gather_segment_sum_plain(x.abs(), plan).double()
    err = (got.double() - want.double()).abs()
    assert bool((err <= _sum_reorder_bound(deg, mag)).all())
    # integer-valued x: every partial sum stays below 2^24, so exact
    xi = torch.from_numpy(rng.integers(-50, 50, n).astype(np.float32)).to(cuda)
    assert torch.equal(K.gather_segment_sum(xi, plan),
                       K.gather_segment_sum_plain(xi, plan))


def test_gather_segment_sum_refuses_a_plan_elsewhere(cuda):
    plan, _, _, n = _segment_case(cuda, "tiny", np.random.default_rng(1))
    with pytest.raises(ValueError, match="plan"):
        K.gather_segment_sum(torch.zeros(n), plan)


@pytest.mark.parametrize("n", [4096, 5000])       # uint4 rows and word rows
def test_edge_popcount_matches_plain(cuda, n):
    rng = np.random.default_rng(22)
    words = (n + 31) // 32
    adj = torch.from_numpy(rng.integers(-2**31, 2**31, (n, words)).astype(np.int32)).to(cuda)
    u = torch.from_numpy(rng.integers(0, n, 50_000).astype(np.int32)).to(cuda)
    v = torch.from_numpy(rng.integers(0, n, 50_000).astype(np.int32)).to(cuda)
    before = K.LAUNCHES["edge_popcount"]
    got = K.edge_popcount(adj, u, v)
    assert K.LAUNCHES["edge_popcount"] == before + 1
    assert torch.equal(got, K.edge_popcount_plain(adj, u, v))


@pytest.mark.parametrize("f", [1, 10, 64])
def test_gram_accumulate_matches_plain(cuda, f):
    from flink_tpu_torch.kernels.gram_accumulate import rating_csr
    rng = np.random.default_rng(23)
    n_rows, n_cols, nnz = 3000, 2000, 200_000
    rows = rng.integers(0, n_rows, nnz).astype(np.int32)
    rows[:5000] = 7                                    # one long row
    cols = rng.integers(0, n_cols, nnz).astype(np.int32)
    vals = rng.integers(1, 11, nnz).astype(np.float32) / 2
    fixed = torch.from_numpy(rng.standard_normal((n_cols, f)).astype(np.float32)).to(cuda)
    indptr, c, v = rating_csr(*(torch.from_numpy(a).to(cuda) for a in (rows, cols, vals)),
                              n_rows)
    before = K.LAUNCHES["gram_accumulate"]
    g, b = K.gram_accumulate(fixed, indptr, c, v)
    assert K.LAUNCHES["gram_accumulate"] == before + 1
    gw, bw = K.gram_accumulate_plain(fixed, indptr, c, v)
    gm, bm = K.gram_accumulate_plain(fixed.abs(), indptr, c, v.abs())
    terms = (indptr[1:] - indptr[:-1]).double()
    assert bool(((g.double() - gw.double()).abs()
                 <= _sum_reorder_bound(terms[:, None, None], gm.double())).all())
    assert bool(((b.double() - bw.double()).abs()
                 <= _sum_reorder_bound(terms[:, None], bm.double())).all())
    assert torch.equal(g, g.transpose(1, 2))           # symmetric bit for bit


def test_gram_accumulate_refuses_too_many_factors(cuda):
    from flink_tpu_torch.kernels.gram_accumulate import MAX_FACTORS
    fixed = torch.zeros((4, MAX_FACTORS + 1), device=cuda)
    indptr = torch.zeros(2, dtype=torch.int64, device=cuda)
    empty = torch.zeros(0, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="factors"):
        K.gram_accumulate(fixed, indptr, empty, empty.float())


@pytest.mark.parametrize("k", [1, 3, 17, 64])
@pytest.mark.parametrize("data", ["integer", "normal"])
def test_knn_topk_matches_plain(cuda, k, data):
    rng = np.random.default_rng(24)
    m, n, d = 300, 20_000, 16
    if data == "integer":                # exact distances, real ties
        Q = rng.integers(-2, 3, (m, d)).astype(np.float32)
        X = rng.integers(-2, 3, (n, d)).astype(np.float32)
    else:
        Q = rng.standard_normal((m, d)).astype(np.float32)
        X = rng.standard_normal((n, d)).astype(np.float32)
    Q, X = torch.from_numpy(Q).to(cuda), torch.from_numpy(X).to(cuda)
    qx = torch.matmul(Q, X.t())
    qn, xn = (Q * Q).sum(1), (X * X).sum(1)
    before = K.LAUNCHES["knn_topk"]
    got = K.knn_topk(qx, qn, xn, k)
    assert K.LAUNCHES["knn_topk"] == before + 1
    assert torch.equal(got, K.knn_topk_plain(qx, qn, xn, k))
