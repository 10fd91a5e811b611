"""Each hand-written CUDA kernel against its plain PyTorch version, on
the card.  Marked ``gpu``: without a CUDA device every test skips (the
fixture decides, never the import).  On a machine with a card:

    python -m pytest -m gpu --noconftest tests/test_torch_kernels_gpu.py

Registers, integer results, fills, Count-Min tables and queries,
quantile histograms and quantile results must be bit-equal (the
quantile plain version runs on the card, so both take the card's
float32 log); HLL estimates agree within rtol 1e-5 (the kernel's
reduction order differs from the plain version's); float32 sums use
integer-valued data, which float atomics add exactly in any order.
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
