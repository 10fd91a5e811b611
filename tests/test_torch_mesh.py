"""The port's mesh engines (flink_tpu_torch/parallel/) against the
reference's (flink_tpu/parallel/) on the same numpy inputs.

The reference runs on the 8 virtual CPU devices that the test
configuration forces; the port on ``Mesh(["cpu"] * 8)``, where
``shard_pack`` and ``table_insert`` run their plain versions (the
latter replays the reference's claim rounds, so a shard's table equals
the reference's position for position once both received the same rows
in the same order: source-major, then source order).

Tolerances: key lanes, occupancy, counts, routing, bucket contents and
integer results are bit-equal; float32 sums within rtol 1e-5 (sums taken
in another order); quantile results within rtol 1e-6 (a few ulps of
``exp``, as ``tests/test_torch_sketches.py`` allows); HLL estimates
within ``tests/torch_port_util.py``'s slack.  Each case mirrors one of ``tests/test_parallel.py``'s mesh
cases, ``tests/test_minicluster.py``'s engine cases or
``tests/test_mesh_log.py``'s cases without SQL or columnar operators.
"""

import collections
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import flink_tpu.ops.device_agg as jda
import flink_tpu.ops.sketches as jsk
import flink_tpu.parallel.mesh_agg as jma
import flink_tpu.parallel.mesh_log as jml
import flink_tpu.parallel.mesh_windows as jmw
import flink_tpu.streaming.log_windows as jlw
import flink_tpu_torch.ops.device_agg as tda
import flink_tpu_torch.ops.sketches as tsk
import flink_tpu_torch.parallel.mesh_agg as tma
import flink_tpu_torch.parallel.mesh_log as tml
import flink_tpu_torch.parallel.mesh_windows as tmw
import flink_tpu_torch.streaming.log_windows as tlw
from flink_tpu.core.keygroups import assign_key_groups_np
from flink_tpu.streaming.vectorized import hash_keys_np
from flink_tpu_torch.core.keygroups import splitmix64_np
from flink_tpu_torch.kernels import shard_pack, shard_pack_plain
from flink_tpu_torch.parallel import Mesh
from torch_port_util import assert_hll_close

class _Package(types.SimpleNamespace):
    """The modules of one package (hashable: it keys dicts)."""
    __hash__ = object.__hash__


J = _Package(da=jda, sk=jsk, agg=jma, mw=jmw, ml=jml, lw=jlw, lw_kw={})
T = _Package(da=tda, sk=tsk, agg=tma, mw=tmw, ml=tml, lw=tlw,
             lw_kw={"device": "cpu"})


@pytest.fixture(scope="module")
def meshes():
    devs = jax.devices()
    assert len(devs) >= 8, "the test configuration forces 8 virtual devices"
    return {J: JMesh(np.array(devs[:8]), ("kg",)), T: Mesh(["cpu"] * 8)}


def _both(meshes, run):
    """run(package, mesh) for the reference and the port."""
    return run(J, meshes[J]), run(T, meshes[T])


def _lanes(h64):
    h64 = np.asarray(h64, np.uint64)
    return ((h64 >> np.uint64(32)).astype(np.uint32),
            (h64 & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def _emitted(eng, key=int):
    return {(key(k), s, e): v for k, v, s, e in eng.emitted}


def _same_counts(a, b):
    assert set(a) == set(b)
    for k in a:
        assert int(a[k]) == int(b[k]), k


def _same_sums(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(float(b[k]), float(a[k]), rtol=1e-5)


def _same_quantiles(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(np.asarray(b[k]), np.asarray(a[k]),
                                   rtol=1e-6, atol=0)


def _tables(pkg, eng):
    """A tumbling/sliding engine's tables as host arrays [S, C]."""
    if pkg is J:
        return tuple(np.asarray(a) for a in eng.table)
    return tuple(eng.snapshot()["table"])


def _same_tables(jeng, teng):
    for a, b in zip(_tables(J, jeng), _tables(T, teng)):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                      np.asarray(b).astype(np.int64))


# ---------------------------------------------------------------------
# shard_pack's plain version against the reference's packs


def _rows(rng, n, S, skew):
    hi, lo = _lanes(splitmix64_np(rng.integers(0, 50 if skew else 10**6, n)
                                  .astype(np.uint64)))
    return hi, lo


@pytest.mark.parametrize("skew", [False, True], ids=["uniform", "skewed"])
def test_shard_pack_plain_equals_bucketize(skew):
    """K11a/K11b: each source block's buckets and mask equal the
    reference's ``_bucketize`` of that block, padding rows included."""
    rng = np.random.default_rng(1)
    S, M = 8, 96
    n = S * M
    hi, lo = _rows(rng, n, S, skew)
    vals = rng.random(n).astype(np.float32)
    ring = rng.integers(0, 5, n).astype(np.int32)
    mask = rng.random(n) > 0.25
    lanes = [torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)
             for a in (hi, lo, ring, vals)]
    (b_hi, b_lo, b_ring, b_val, b_mask), counts = shard_pack_plain(
        [*lanes, torch.from_numpy(mask)], S, M, hash_lo=lanes[1],
        max_parallelism=128, mask=torch.from_numpy(mask))
    for s in range(S):
        sl = slice(s * M, (s + 1) * M)
        tgt = jma._target_shard(jnp.asarray(lo[sl]), 128, S)
        (r_hi, r_lo, r_ring, r_val), r_mask = jma._bucketize(
            tgt, S, tuple(jnp.asarray(a[sl]) for a in (hi, lo, ring, vals)),
            jnp.asarray(mask[sl]))
        np.testing.assert_array_equal(b_hi[s].numpy().view(np.uint32), r_hi)
        np.testing.assert_array_equal(b_lo[s].numpy().view(np.uint32), r_lo)
        np.testing.assert_array_equal(b_ring[s].numpy(), r_ring)
        np.testing.assert_array_equal(b_val[s].numpy(), r_val)
        np.testing.assert_array_equal(b_mask[s].numpy(), r_mask)
        np.testing.assert_array_equal(counts[s].numpy(),
                                      np.asarray(r_mask).sum(axis=1))


@pytest.mark.parametrize("cap", [4, 12, 64], ids=lambda c: f"cap{c}")
def test_shard_pack_plain_and_all_to_all_equal_packed_exchange(meshes, cap):
    """K11c: the rows-layout pack plus ``Mesh.all_to_all`` equal the
    reference's ``_make_packed_exchange`` (pack fused with all_to_all),
    including buckets over the cap (truncated, counts clipped) and
    masked rows (target S)."""
    rng = np.random.default_rng(2)
    S, m, K = 8, 64, 6
    lanes = rng.integers(0, 2**32, (S * m, K), dtype=np.uint64).astype(np.uint32)
    tgt = rng.integers(0, S, S * m).astype(np.int32)
    tgt[rng.random(S * m) < 0.3] = 0          # an over-full target
    tgt[rng.random(S * m) < 0.1] = S          # masked rows
    ref = jml._make_packed_exchange(meshes[J], "kg", cap)
    r_recv, r_counts = (np.asarray(a) for a in ref(
        jnp.asarray(lanes.reshape(S, m, K)), jnp.asarray(tgt.reshape(S, m))))
    bucks, counts = shard_pack_plain(
        torch.from_numpy(lanes.view(np.int32)), S, cap,
        target=torch.from_numpy(tgt))
    sizes = np.stack([np.bincount(tgt[i * m:(i + 1) * m], minlength=S + 1)[:S]
                      for i in range(S)])
    assert (sizes > cap).any() == (cap < 64)
    np.testing.assert_array_equal(counts.numpy(), np.minimum(sizes, cap))
    mesh = meshes[T]
    recv = mesh.all_to_all(bucks).numpy().view(np.uint32)
    rcounts = mesh.all_to_all(counts).numpy()
    np.testing.assert_array_equal(recv, r_recv)
    np.testing.assert_array_equal(rcounts, r_counts)


def test_all_to_all_equals_the_lane_exchange(meshes):
    rng = np.random.default_rng(3)
    S, cap, K = 8, 5, 4
    bucks = rng.integers(0, 2**31, (S, S, cap, K)).astype(np.uint32)
    counts = rng.integers(0, cap + 1, (S, S)).astype(np.int32)
    r_recv, r_counts = (np.asarray(a) for a in jml._make_lane_exchange(
        meshes[J], "kg")(jnp.asarray(bucks), jnp.asarray(counts)))
    mesh = meshes[T]
    np.testing.assert_array_equal(
        mesh.all_to_all(torch.from_numpy(bucks.view(np.int32))).numpy()
        .view(np.uint32), r_recv)
    np.testing.assert_array_equal(
        mesh.all_to_all(torch.from_numpy(counts)).numpy(), r_counts)


_GLOO_RANK = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
send = np.random.default_rng(4).integers(0, 2**31, (world, world, 3, 2)).astype(np.int32)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
mine = torch.from_numpy(send[rank])            # [S_tgt, ...] of this source
recv = torch.empty_like(mine)
dist.all_to_all_single(recv, mine)
np.save(out, recv.numpy())
dist.destroy_process_group()
"""


def test_all_to_all_single_on_gloo_gives_the_mesh_layout(tmp_path):
    """The collective ``Mesh.all_to_all`` stands in for: on a 4-rank
    gloo group, rank j receives ``recv[j][s] = buckets[s][j]``."""
    import socket
    import subprocess
    import sys
    world = 4
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _GLOO_RANK, str(r), str(world), str(port),
         str(tmp_path / f"recv{r}.npy")]) for r in range(world)]
    try:
        rcs = [p.wait(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert rcs == [0] * world
    send = np.random.default_rng(4).integers(
        0, 2**31, (world, world, 3, 2)).astype(np.int32)
    want = Mesh(["cpu"] * world).all_to_all(torch.from_numpy(send)).numpy()
    for j in range(world):
        np.testing.assert_array_equal(np.load(tmp_path / f"recv{j}.npy"),
                                      want[j])


# ---------------------------------------------------------------------
# mesh_agg: test_parallel.py's mesh cases


def _prepare(keys, values, n_shards):
    h64 = splitmix64_np(np.asarray(keys, np.uint64))
    hi, lo = _lanes(h64)
    n = len(keys)
    total = -(-n // n_shards) * n_shards

    def padded(a, dtype):
        out = np.zeros(total, dtype)
        out[:n] = a
        return out

    mask = np.zeros(total, bool)
    mask[:n] = True
    return (padded(hi, np.uint32), padded(lo, np.uint32),
            padded(values, np.float32), padded(np.zeros(n), np.uint32),
            padded(np.zeros(n), np.uint32), mask, h64)


def _mwa(pkg, mesh, agg, cap):
    return pkg.agg.MeshWindowAggregation(mesh, "kg", agg, max_parallelism=128,
                                         capacity_per_shard=cap)


def _fire_equal(jout, tout, values="exact", m=None):
    for a, b in zip(jout[:2], tout[:2]):
        np.testing.assert_array_equal(np.asarray(a), b)
    np.testing.assert_array_equal(np.asarray(jout[3]), tout[3])
    occ = tout[3]
    jr, tr = np.asarray(jout[2])[occ], tout[2][occ]
    if values == "hll":
        assert_hll_close(tr, jr, m)
    elif values == "float":
        np.testing.assert_allclose(tr, jr, rtol=1e-5)
    else:
        np.testing.assert_array_equal(tr, jr)


def test_mesh_sum_matches_reference(meshes):
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 100, 1000)
    vals = rng.random(1000).astype(np.float32)
    prep = _prepare(keys, vals, 8)

    def run(pkg, mesh):
        mwa = _mwa(pkg, mesh, pkg.da.SumAggregate(np.float32), 256)
        mwa.step(*prep[:6])
        assert mwa.overflowed == 0
        return mwa.fire()
    jout, tout = _both(meshes, run)
    _fire_equal(jout, tout, "float")
    assert tout[3].sum() == len(np.unique(keys))


def test_mesh_keys_land_on_owner_shard(meshes):
    cap = 128
    prep = _prepare(np.arange(200), np.zeros(200), 8)
    jout, tout = _both(meshes, lambda pkg, mesh: (
        lambda w: (w.step(*prep[:6]), w.fire())[1])(
            _mwa(pkg, mesh, pkg.da.CountAggregate(), cap)))
    _fire_equal(jout, tout)
    khi, klo, _res, occ = tout
    owner = assign_key_groups_np(prep[6], 128).astype(np.int64) * 8 // 128
    pos = {(int(khi[i]), int(klo[i])): i // cap for i in np.nonzero(occ)[0]}
    for h, s in zip(prep[6], owner):
        assert pos[(int(h >> np.uint64(32)), int(h & np.uint64(0xFFFFFFFF)))] == s


def test_mesh_hll(meshes):
    n = 4000
    keys = np.repeat(np.arange(4), n // 4)
    hi, lo, v, _, _, mask, _ = _prepare(keys, np.zeros(n), 8)
    vhi, vlo = _lanes(splitmix64_np(np.arange(n, dtype=np.uint64)))

    def run(pkg, mesh):
        mwa = _mwa(pkg, mesh, pkg.sk.HyperLogLogAggregate(precision=9), 64)
        mwa.step(hi, lo, v, vhi, vlo, mask)
        return mwa.fire()
    jout, tout = _both(meshes, run)
    _fire_equal(jout, tout, "hll", 1 << 9)
    ests = tout[2][tout[3]]
    assert len(ests) == 4 and (np.abs(ests - 1000) / 1000 < 0.10).all()


def test_mesh_multiple_steps_accumulate(meshes):
    prep = _prepare(np.arange(16), np.zeros(16), 8)

    def run(pkg, mesh):
        mwa = _mwa(pkg, mesh, pkg.da.CountAggregate(), 64)
        for _ in range(3):
            mwa.step(*prep[:6])
        first = mwa.fire()
        mwa.step(*prep[:6])
        return first, mwa.fire()
    (j1, j2), (t1, t2) = _both(meshes, run)
    _fire_equal(j1, t1)
    _fire_equal(j2, t2)
    assert (t1[2][t1[3]] == 3).all() and (t2[2][t2[3]] == 1).all()


def test_mesh_padding_does_not_clobber_shard0(meshes):
    keys, k = [], 0
    while len(keys) < 8:
        h = splitmix64_np(np.array([k], np.uint64))
        if int(assign_key_groups_np(h, 128)[0]) * 8 // 128 == 0:
            keys.append(k)
        k += 1
    h64 = splitmix64_np(np.array(keys, np.uint64))
    per, total = 8, 64
    hi, lo = np.zeros(total, np.uint32), np.zeros(total, np.uint32)
    mask = np.zeros(total, bool)
    idx = np.arange(8) * per
    hi[idx], lo[idx] = _lanes(h64)
    mask[idx] = True
    zf, zu = np.zeros(total, np.float32), np.zeros(total, np.uint32)

    def run(pkg, mesh):
        mwa = _mwa(pkg, mesh, pkg.da.CountAggregate(), 128)
        mwa.step(hi, lo, zf, zu, zu, mask)
        return mwa.fire()
    jout, tout = _both(meshes, run)
    _fire_equal(jout, tout)
    assert tout[3].sum() == 8 and (tout[2][tout[3]] == 1).all()


def test_mesh_overflow_raises_unless_allowed(meshes):
    prep = _prepare(np.arange(400), np.zeros(400), 8)
    mesh = meshes[T]
    strict = tma.MeshWindowAggregation(mesh, "kg", tda.CountAggregate(),
                                       capacity_per_shard=4)
    with pytest.raises(RuntimeError, match="overflowed"):
        strict.step(*prep[:6])
    loose = tma.MeshWindowAggregation(mesh, "kg", tda.CountAggregate(),
                                      capacity_per_shard=4,
                                      allow_overflow=True)
    loose.step(*prep[:6])
    ref = jma.MeshWindowAggregation(meshes[J], "kg", jda.CountAggregate(),
                                    capacity_per_shard=4, allow_overflow=True)
    ref.step(*prep[:6])
    assert loose.overflowed == ref.overflowed > 0
    _fire_equal(ref.fire(), loose.fire())


# ---------------------------------------------------------------------
# mesh_windows: test_minicluster.py's engine cases


def _tumbling(pkg, mesh, agg, size, **kw):
    return pkg.mw.MeshTumblingWindows(agg, size, mesh, **kw)


def _sliding(pkg, mesh, agg, size, slide, **kw):
    return pkg.mw.MeshSlidingWindows(agg, size, slide, mesh, **kw)


def test_mesh_engine_multi_window_counts(meshes):
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 50, 500)
    ts = rng.integers(0, 3000, 500)
    engines = {}

    def run(pkg, mesh):
        eng = engines[pkg] = _tumbling(pkg, mesh, pkg.da.CountAggregate(), 1000,
                                       capacity_per_window_shard=256,
                                       step_batch=64)
        eng.process_batch(keys, ts)
        eng.flush()
        return eng
    jeng, teng = _both(meshes, run)
    _same_tables(jeng, teng)          # slot for slot, before any fire
    for eng in (jeng, teng):
        eng.advance_watermark(999)
        eng.advance_watermark(2999)
    expect = collections.Counter(
        (k, t - t % 1000) for k, t in zip(keys.tolist(), ts.tolist()))
    got = {(int(k), s): v for k, v, s, e in teng.emitted}
    assert got == dict(expect)
    _same_counts(_emitted(jeng), _emitted(teng))
    assert all(e == s + 1000 for _, _, s, e in teng.emitted)


def test_mesh_engine_sums_match_reference(meshes):
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 30, 400)
    ts = rng.integers(0, 2000, 400)
    vals = rng.random(400).astype(np.float32)

    def run(pkg, mesh):
        eng = _tumbling(pkg, mesh, pkg.da.SumAggregate(), 500,
                        capacity_per_window_shard=256, step_batch=64)
        eng.process_batch(keys, ts, vals)
        eng.advance_watermark(1999)
        return _emitted(eng)
    jres, tres = _both(meshes, run)
    _same_sums(jres, tres)
    expect = collections.defaultdict(float)
    for k, t, v in zip(keys.tolist(), ts.tolist(), vals.tolist()):
        expect[(k, t - t % 500, t - t % 500 + 500)] += v
    assert set(tres) == set(expect)


def test_mesh_engine_hll_matches_reference(meshes):
    rng = np.random.default_rng(8)
    keys = rng.integers(0, 40, 3000)
    ts = rng.integers(0, 3000, 3000)
    users = rng.integers(0, 10**6, 3000)

    def run(pkg, mesh):
        eng = _tumbling(pkg, mesh, pkg.sk.HyperLogLogAggregate(10), 1000,
                        capacity_per_window_shard=64, step_batch=256)
        eng.process_batch(keys, ts, users)
        eng.advance_watermark(2999)
        return _emitted(eng)
    jres, tres = _both(meshes, run)
    assert set(jres) == set(tres)
    keys_ = sorted(jres)
    assert_hll_close([tres[k] for k in keys_], [jres[k] for k in keys_], 1 << 10)


def test_mesh_engine_drops_late_records(meshes):
    def run(pkg, mesh):
        eng = _tumbling(pkg, mesh, pkg.da.CountAggregate(), 1000,
                        capacity_per_window_shard=64, step_batch=64)
        eng.process_batch(np.array([1, 2]), np.array([100, 1100]))
        eng.advance_watermark(999)
        eng.process_batch(np.array([3]), np.array([500]))
        assert eng.num_late_dropped == 1
        eng.advance_watermark(1999)
        return _emitted(eng)
    jres, tres = _both(meshes, run)
    _same_counts(jres, tres)
    assert set(tres) == {(1, 0, 1000), (2, 1000, 2000)}


@pytest.mark.parametrize("jump", [False, True], ids=["two_steps", "one_jump"])
def test_mesh_engine_far_future_parks_and_ingests(meshes, jump):
    def run(pkg, mesh):
        eng = _tumbling(pkg, mesh, pkg.da.CountAggregate(), 1000, ring=2,
                        capacity_per_window_shard=64, step_batch=64)
        eng.process_batch(np.array([1]), np.array([100]))
        eng.process_batch(np.array([2]), np.array([2100]))
        assert eng.pending
        if jump:
            eng.advance_watermark(2 ** 62)
            assert eng.num_late_dropped == 0
            assert not eng.pending and not eng.live and not eng.key_directory
        else:
            eng.advance_watermark(999)
            eng.advance_watermark(2999)
        return _emitted(eng)
    jres, tres = _both(meshes, run)
    _same_counts(jres, tres)
    assert set(tres) == {(1, 0, 1000), (2, 2000, 3000)}


def test_mesh_engine_overflow_raises(meshes):
    for pkg in (J, T):
        eng = _tumbling(pkg, meshes[pkg], pkg.da.CountAggregate(), 1000,
                        capacity_per_window_shard=2, step_batch=64,
                        max_probes=2)
        with pytest.raises(pkg.mw.MeshWindowOverflowError):
            eng.process_batch(np.arange(1000), np.full(1000, 10))
            eng.flush()


def test_mesh_engine_snapshot_restore_midwindow(meshes):
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 40, 300)
    ts = rng.integers(0, 2000, 300)

    def run(pkg, mesh):
        kw = dict(capacity_per_window_shard=256, step_batch=64)
        eng = _tumbling(pkg, mesh, pkg.da.CountAggregate(), 1000, **kw)
        eng.process_batch(keys[:150], ts[:150])
        snap = eng.snapshot()
        eng2 = _tumbling(pkg, mesh, pkg.da.CountAggregate(), 1000, **kw)
        eng2.restore(snap)
        eng2.process_batch(keys[150:], ts[150:])
        eng2.flush()
        tables = _tables(pkg, eng2)
        eng2.advance_watermark(1999)
        return _emitted(eng2), tables
    (jres, jtab), (tres, ttab) = _both(meshes, run)
    _same_counts(jres, tres)
    for a, b in zip(jtab, ttab):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                      b.astype(np.int64))
    expect = collections.Counter(
        (k, t - t % 1000, t - t % 1000 + 1000)
        for k, t in zip(keys.tolist(), ts.tolist()))
    assert tres == dict(expect)


def test_mesh_engine_restore_checks_max_parallelism(meshes):
    mesh = meshes[T]
    eng = tmw.MeshTumblingWindows(tda.CountAggregate(), 1000, mesh,
                                  capacity_per_window_shard=64)
    other = tmw.MeshTumblingWindows(tda.CountAggregate(), 1000, mesh,
                                    max_parallelism=256,
                                    capacity_per_window_shard=64)
    with pytest.raises(ValueError, match="max_parallelism"):
        other.restore(eng.snapshot())


def test_mesh_sliding_counts_match_reference(meshes):
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 40, 600)
    ts = np.sort(rng.integers(0, 6000, 600))

    def run(pkg, mesh):
        eng = _sliding(pkg, mesh, pkg.da.CountAggregate(), 3000, 1000,
                       capacity_per_window_shard=256, step_batch=64)
        eng.process_batch(keys, ts)
        eng.advance_watermark(20_000)
        return _emitted(eng)
    jres, tres = _both(meshes, run)
    _same_counts(jres, tres)
    expect = collections.Counter()
    for k, t in zip(keys.tolist(), ts.tolist()):
        pane = t - t % 1000
        for w in range(pane - 2000, pane + 1000, 1000):
            expect[(k, w, w + 3000)] += 1
    assert tres == dict(expect)


def test_mesh_sliding_incremental_watermarks_match_vectorized(meshes):
    from flink_tpu_torch.streaming.vectorized import VectorizedSlidingWindows
    rng = np.random.default_rng(5)
    n = 800
    keys = rng.integers(0, 30, n).astype(np.uint64)
    ts = np.sort(rng.integers(0, 8000, n))
    vals = rng.random(n).astype(np.float32)

    def run(pkg, mesh):
        eng = _sliding(pkg, mesh, pkg.da.SumAggregate(), 2000, 1000,
                       capacity_per_window_shard=128, step_batch=64)
        for i in range(0, n, 200):
            sl = slice(i, i + 200)
            eng.process_batch(keys[sl], ts[sl], vals[sl])
            eng.advance_watermark(int(ts[sl][-1]) - 1)
        eng.advance_watermark(30_000)
        return _emitted(eng)
    jres, tres = _both(meshes, run)
    _same_sums(jres, tres)
    ref = VectorizedSlidingWindows(tda.SumAggregate(), 2000, 1000,
                                   initial_capacity=512, device="cpu")
    ref.process_batch(keys, ts, vals)
    ref.advance_watermark(30_000)
    _same_sums(_emitted(ref), tres)


def test_mesh_sliding_quantiles_match_reference(meshes):
    """Quantile sketches: the pane merge folds int32 histograms; the
    (key, window) results agree within a few ulps of ``exp`` (values
    lie away from bucket boundaries)."""
    rng = np.random.default_rng(12)
    n = 1500
    keys = rng.integers(0, 25, n)
    ts = np.sort(rng.integers(0, 5000, n))
    vals = np.round(rng.gamma(2.0, 10.0, n), 1) + 0.05

    def run(pkg, mesh):
        eng = _sliding(pkg, mesh, pkg.sk.QuantileSketchAggregate(
            quantiles=(0.5, 0.99)), 2000, 1000,
            capacity_per_window_shard=64, step_batch=128)
        eng.process_batch(keys, ts, vals)
        eng.advance_watermark(20_000)
        return _emitted(eng)
    jres, tres = _both(meshes, run)
    _same_quantiles(jres, tres)
    assert len(tres) > 0


def test_mesh_sliding_snapshot_restore(meshes):
    rng = np.random.default_rng(7)
    n = 400
    keys = rng.integers(0, 20, n)
    ts = np.sort(rng.integers(0, 5000, n))

    def run(pkg, mesh):
        kw = dict(capacity_per_window_shard=128, step_batch=64)
        a = _sliding(pkg, mesh, pkg.da.CountAggregate(), 2000, 1000, **kw)
        a.process_batch(keys[:200], ts[:200])
        a.advance_watermark(int(ts[199]) - 1)
        b = _sliding(pkg, mesh, pkg.da.CountAggregate(), 2000, 1000, **kw)
        b.restore(a.snapshot())
        b.process_batch(keys[200:], ts[200:])
        b.advance_watermark(20_000)
        combined = _emitted(a)
        combined.update(_emitted(b))
        return combined
    jres, tres = _both(meshes, run)
    _same_counts(jres, tres)


def test_mesh_sliding_parked_pane_not_lost(meshes):
    rng = np.random.default_rng(11)
    keys = rng.integers(0, 10, 300)
    ts = rng.integers(0, 10_000, 300)

    def run(pkg, mesh):
        eng = _sliding(pkg, mesh, pkg.da.CountAggregate(), 2000, 1000,
                       capacity_per_window_shard=64, step_batch=32,
                       extra_ring=4)
        eng.process_batch(keys, ts)
        eng.advance_watermark(50_000)
        return _emitted(eng)
    jres, tres = _both(meshes, run)
    _same_counts(jres, tres)
    expect = collections.Counter()
    for k, t in zip(keys.tolist(), ts.tolist()):
        pane = t - t % 1000
        for w in range(pane - 1000, pane + 1000, 1000):
            expect[(k, w, w + 2000)] += 1
    assert tres == dict(expect)


def test_mesh_sliding_blocked_window_fires_on_later_call(meshes):
    def run(pkg, mesh):
        def build():
            return _sliding(pkg, mesh, pkg.da.CountAggregate(), 2000, 1000,
                            capacity_per_window_shard=64, step_batch=32,
                            extra_ring=4)
        eng = build()
        eng.process_batch(np.array([1, 1, 1]), np.array([6500, 6600, 6700]))
        eng.process_batch(np.array([2, 2]), np.array([500, 600]))
        assert eng.advance_watermark(1999) == 0 and eng.emitted == []
        restored = build()
        restored.restore(eng.snapshot())
        out = []
        for e in (eng, restored):
            e.advance_watermark(7999)
            out.append(_emitted(e))
        return out
    jres, tres = _both(meshes, run)
    want = {(2, -1000, 1000): 2, (2, 0, 2000): 2, (1, 5000, 7000): 3,
            (1, 6000, 8000): 3}
    for j, t in zip(jres, tres):
        _same_counts(j, t)
        assert t == want


# ---------------------------------------------------------------------
# snapshots across the packages: one package's mid-window snapshot
# restores into the other's engine, and the restored run fires what an
# uninterrupted run fires


def _snapshot_inputs(keys):
    rng = np.random.default_rng(21)
    n = 600
    ids = rng.integers(0, 40, n)
    k = {"str": lambda: np.array([f"user-{i}" for i in ids]),
         "int": lambda: ids.astype(np.int64),
         "pair": lambda: np.stack([ids, ids % 3], axis=1)}[keys]()
    ts = np.sort(rng.integers(0, 4000, n)).astype(np.int64)
    vals = rng.integers(1, 50, n).astype(np.float32)
    return k, ts, vals


def _window_engine(pkg, mesh, engine, agg):
    a = pkg.da.CountAggregate() if agg == "count" else pkg.da.SumAggregate()
    kw = dict(capacity_per_window_shard=128, step_batch=64)
    if engine == "tumbling":
        return _tumbling(pkg, mesh, a, 1000, **kw)
    return _sliding(pkg, mesh, a, 2000, 1000, **kw)


def _window_run(pkg, mesh, engine, agg, keys, cut=None, restore_into=None):
    """Feed the inputs in 3 batches with a watermark after each; with
    ``cut``, snapshot after that many batches and go on in a fresh engine
    of package ``restore_into`` restored from it.  Returns the fired
    (key, start, end) -> value of both engines together."""
    k, ts, vals = _snapshot_inputs(keys)
    v = None if agg == "count" else vals
    eng = _window_engine(pkg, mesh, engine, agg)
    out = {}
    for b, sl in enumerate(np.array_split(np.arange(len(k)), 3)):
        if b == cut:
            out.update(_emitted(eng, str))
            pkg, mesh = restore_into
            fresh = _window_engine(pkg, mesh, engine, agg)
            fresh.restore(eng.snapshot())
            eng = fresh
        eng.process_batch(k[sl], ts[sl], None if v is None else v[sl])
        eng.advance_watermark(int(ts[sl][-1]) - 1)
    eng.advance_watermark(20_000)
    out.update(_emitted(eng, str))
    return out


@pytest.mark.parametrize("keys", ["int", "str", "pair"])
@pytest.mark.parametrize("agg", ["count", "sum"])
@pytest.mark.parametrize("engine", ["tumbling", "sliding"])
@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_mesh_window_snapshot_crosses_packages(meshes, direction, engine, agg,
                                               keys):
    src, dst = (J, T) if direction == "reference_to_port" else (T, J)
    key = (engine, agg, keys)
    for pkg in (J, T):        # the uninterrupted runs, shared by both directions
        if (pkg, *key) not in _WHOLE_RUNS:
            _WHOLE_RUNS[(pkg, *key)] = _window_run(pkg, meshes[pkg], *key)
    # the snapshot after the first of three batches falls mid-window
    got = _window_run(src, meshes[src], *key, 1, (dst, meshes[dst]))
    same = _same_counts if agg == "count" else _same_sums
    same(_WHOLE_RUNS[(dst, *key)], got)
    same(_WHOLE_RUNS[(src, *key)], got)
    assert len(got) > 0


_WHOLE_RUNS: dict = {}


@pytest.mark.parametrize("layout", ["flat", "tuple"])
@pytest.mark.parametrize("engine", ["tumbling", "sliding"])
def test_mesh_window_older_directory_layouts_restore(meshes, engine, layout):
    """The legacy flat ``{hash: key}`` directory (every live window draws
    on it) and the port's older ``{start: (hashes, keys)}`` still restore,
    and a snapshot without max_parallelism is taken as 128."""
    mesh = meshes[T]
    whole = _window_run(T, mesh, engine, "count", "str")
    k, ts, _ = _snapshot_inputs("str")
    eng = _window_engine(T, mesh, engine, "count")
    sl = np.array_split(np.arange(len(k)), 3)
    eng.process_batch(k[sl[0]], ts[sl[0]])
    eng.advance_watermark(int(ts[sl[0]][-1]) - 1)
    out = _emitted(eng, str)
    snap = eng.snapshot()
    dirs = snap["key_directory"]
    assert all(isinstance(d, dict) for d in dirs.values())
    if layout == "flat":
        flat = {}
        for d in dirs.values():
            flat.update(d)
        snap["key_directory"] = flat
    else:
        snap["key_directory"] = {
            s: (np.array(sorted(d), np.uint64),
                np.array([d[h] for h in sorted(d)])) for s, d in dirs.items()}
    del snap["max_parallelism"]
    fresh = _window_engine(T, mesh, engine, "count")
    fresh.restore(snap)
    for part in sl[1:]:
        fresh.process_batch(k[part], ts[part])
        fresh.advance_watermark(int(ts[part][-1]) - 1)
    fresh.advance_watermark(20_000)
    out.update(_emitted(fresh, str))
    _same_counts(whole, out)


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_mesh_log_snapshot_crosses_packages(meshes, direction):
    k, ts, v = _snapshot_inputs("int")
    v = v.astype(np.float64)
    src, dst = (J, T) if direction == "reference_to_port" else (T, J)

    def build(pkg):
        return pkg.ml.MeshLogTumblingWindows(pkg.da.SumAggregate(np.float64),
                                             1000, meshes[pkg], step_batch=128)
    half = len(k) // 2
    a = build(src)
    a.process_batch(k[:half], ts[:half], v[:half])
    a.advance_watermark(int(ts[half - 1]) - 1)
    b = build(dst)
    b.restore(a.snapshot())
    whole = build(dst)
    whole.process_batch(k, ts, v)
    whole.advance_watermark(10_000)
    b.process_batch(k[half:], ts[half:], v[half:])
    b.advance_watermark(10_000)
    got = _log_results(a)
    got.update(_log_results(b))
    assert got == _log_results(whole) and len(got) > 0


# ---------------------------------------------------------------------
# mesh_log: test_mesh_log.py's cases


def _hll_inputs(n=5000, keys=37, seed=0):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, keys, n).astype(np.int64)
    ts = np.sort(rng.integers(0, 3000, n)).astype(np.int64)
    users = rng.integers(0, 500, n)
    return k, ts, users


def _single(pkg, cls, *args, **kw):
    return getattr(pkg.lw, cls)(*args, **kw, **pkg.lw_kw)


def _log_results(eng, value=float):
    return {(int(k), int(s), int(e)): value(v) for k, v, s, e in eng.emitted}


def test_mesh_log_hll_tumbling_matches(meshes):
    k, ts, users = _hll_inputs()
    vh = hash_keys_np(users)

    def run(pkg, mesh):
        agg = pkg.sk.HyperLogLogAggregate(precision=10)
        eng = pkg.ml.MeshLogTumblingWindows(agg, 1000, mesh, step_batch=512,
                                            finish_tier="host")
        ref = _single(pkg, "LogStructuredTumblingWindows", agg, 1000,
                      finish_tier="host")
        for e in (eng, ref):
            e.process_batch(k, ts, None, value_hashes=vh)
            e.advance_watermark(10_000)
        assert _log_results(eng) == _log_results(ref)
        return _log_results(eng), eng
    (jres, _), (tres, teng) = _both(meshes, run)
    assert set(jres) == set(tres)
    keys_ = sorted(jres)
    assert_hll_close([tres[x] for x in keys_], [jres[x] for x in keys_], 1 << 10)
    assert teng.num_packed_steps > 0 and teng.num_hostpack_steps == 0


def test_mesh_log_sum_sliding_matches(meshes):
    rng = np.random.default_rng(1)
    n = 4000
    k = rng.integers(0, 23, n).astype(np.int64)
    ts = np.sort(rng.integers(0, 2500, n)).astype(np.int64)
    v = rng.integers(1, 100, n).astype(np.float64)

    def run(pkg, mesh):
        agg = pkg.da.SumAggregate(np.float64)
        eng = pkg.ml.MeshLogSlidingWindows(agg, 1000, 500, mesh, step_batch=512)
        ref = _single(pkg, "LogStructuredSlidingWindows", agg, 1000, 500)
        for e in (eng, ref):
            e.process_batch(k, ts, v)
            e.advance_watermark(10_000)
        assert _log_results(eng) == _log_results(ref)
        return _log_results(eng)
    jres, tres = _both(meshes, run)
    assert jres == tres


def test_mesh_log_quantile_matches(meshes):
    rng = np.random.default_rng(2)
    n = 3000
    k = rng.integers(0, 11, n).astype(np.int64)
    ts = np.sort(rng.integers(0, 2000, n)).astype(np.int64)
    v = np.round(rng.gamma(2.0, 10.0, n), 1) + 0.05

    def run(pkg, mesh):
        agg = pkg.sk.QuantileSketchAggregate(quantiles=(0.5, 0.99))
        eng = pkg.ml.MeshLogTumblingWindows(agg, 1000, mesh, step_batch=512)
        ref = _single(pkg, "LogStructuredTumblingWindows", agg, 1000)
        out = []
        for e in (eng, ref):
            e.process_batch(k, ts, v)
            e.advance_watermark(10_000)
            out.append(_log_results(e, np.asarray))
        _same_quantiles(*out)
        return out[0]
    jres, tres = _both(meshes, run)
    _same_quantiles(jres, tres)


def test_mesh_log_sessions_match(meshes):
    rng = np.random.default_rng(3)
    n = 3000
    k = rng.integers(0, 29, n).astype(np.int64)
    ts = np.sort(rng.integers(0, 50_000, n)).astype(np.int64)
    vh = hash_keys_np(rng.integers(0, 64, n))
    ones = np.ones(n, np.float64)

    def run(pkg, mesh):
        agg = pkg.sk.CountMinSketchAggregate(depth=4, width=256)
        eng = pkg.ml.MeshLogSessionWindows(agg, 100, mesh, step_batch=512)
        ref = _single(pkg, "LogStructuredSessionWindows", agg, 100)
        for e in (eng, ref):
            h = n // 2
            e.process_batch(k[:h], ts[:h], ones[:h], value_hashes=vh[:h])
            e.advance_watermark(int(ts[h - 1]) - 200)
            e.process_batch(k[h:], ts[h:], ones[h:], value_hashes=vh[h:])
            e.advance_watermark(100_000)
        assert _log_results(eng, int) == _log_results(ref, int)
        return _log_results(eng, int)
    jres, tres = _both(meshes, run)
    assert jres == tres


def test_mesh_log_watermark_mid_stream_and_late_drops(meshes):
    k1 = np.arange(40, dtype=np.int64) % 7
    ts1 = np.linspace(0, 1999, 40).astype(np.int64)

    def run(pkg, mesh):
        agg = pkg.da.SumAggregate(np.float64)
        eng = pkg.ml.MeshLogTumblingWindows(agg, 1000, mesh, step_batch=64)
        ref = _single(pkg, "LogStructuredTumblingWindows", agg, 1000)
        for e in (eng, ref):
            e.process_batch(k1, ts1, np.ones(40))
            e.advance_watermark(999)
            e.process_batch(np.array([1], np.int64), np.array([10], np.int64),
                            np.array([5.0]))
            e.advance_watermark(5000)
        assert eng.num_late_dropped == ref.num_late_dropped == 1
        assert _log_results(eng) == _log_results(ref)
        return _log_results(eng)
    jres, tres = _both(meshes, run)
    assert jres == tres


def test_mesh_log_snapshot_restore_roundtrip(meshes):
    k, ts, users = _hll_inputs(seed=4)
    vh = hash_keys_np(users)
    half = len(k) // 2

    def run(pkg, mesh):
        agg = pkg.sk.HyperLogLogAggregate(precision=10)
        kw = dict(step_batch=512, finish_tier="host")
        eng = pkg.ml.MeshLogTumblingWindows(agg, 1000, mesh, **kw)
        eng.process_batch(k[:half], ts[:half], None, value_hashes=vh[:half])
        eng2 = pkg.ml.MeshLogTumblingWindows(agg, 1000, mesh, **kw)
        eng2.restore(eng.snapshot())
        for e in (eng, eng2):
            e.process_batch(k[half:], ts[half:], None, value_hashes=vh[half:])
            e.advance_watermark(10_000)
        assert _log_results(eng2) == _log_results(eng)
        return _log_results(eng2)
    jres, tres = _both(meshes, run)
    keys_ = sorted(jres)
    assert keys_ == sorted(tres)
    assert_hll_close([tres[x] for x in keys_], [jres[x] for x in keys_], 1 << 10)


def test_mesh_log_shard_count_mismatch_rejected(meshes):
    agg = tda.SumAggregate(np.float64)
    e8 = tml.MeshLogTumblingWindows(agg, 1000, meshes[T])
    e4 = tml.MeshLogTumblingWindows(agg, 1000, Mesh(["cpu"] * 4))
    e8.process_batch(np.arange(16, dtype=np.int64), np.zeros(16, np.int64),
                     np.ones(16))
    with pytest.raises(ValueError, match="8 shards"):
        e4.restore(e8.snapshot())


def test_mesh_log_bucket_overflow_takes_the_host_pack(meshes):
    """One key for most rows: buckets exceed the cap, the step takes the
    host pack and routes the tail out of band; results equal the
    reference's and the single engine's, and the overflow counts agree."""
    rng = np.random.default_rng(9)
    n = 2048
    k = np.where(rng.random(n) < 0.7, 3, rng.integers(0, 50, n)).astype(np.int64)
    ts = np.sort(rng.integers(0, 2000, n)).astype(np.int64)
    v = rng.integers(1, 9, n).astype(np.float64)

    def run(pkg, mesh):
        agg = pkg.da.SumAggregate(np.float64)
        eng = pkg.ml.MeshLogTumblingWindows(agg, 1000, mesh, step_batch=512)
        ref = _single(pkg, "LogStructuredTumblingWindows", agg, 1000)
        for e in (eng, ref):
            e.process_batch(k, ts, v)
            e.advance_watermark(5000)
        assert _log_results(eng) == _log_results(ref)
        return _log_results(eng), eng.num_overflow_routed
    (jres, jov), (tres, tov) = _both(meshes, run)
    assert jres == tres and jov == tov > 0


def test_mesh_log_engine_factory_scope(meshes):
    from flink_tpu_torch.streaming.windowing import (EventTimeSessionWindows,
                                                     SlidingEventTimeWindows,
                                                     TumblingEventTimeWindows)
    mesh = meshes[T]
    hll = tsk.HyperLogLogAggregate(precision=10)
    f = tml.mesh_log_engine_for_assigner
    assert isinstance(f(TumblingEventTimeWindows.of(1000), hll, mesh),
                      tml.MeshLogTumblingWindows)
    assert isinstance(f(SlidingEventTimeWindows.of(1000, 500), hll, mesh),
                      tml.MeshLogSlidingWindows)
    assert isinstance(f(EventTimeSessionWindows.with_gap(100),
                        tsk.CountMinSketchAggregate(), mesh),
                      tml.MeshLogSessionWindows)
    assert f(TumblingEventTimeWindows.of(1000), tda.MinAggregate(np.float64),
             mesh) is None


# ---------------------------------------------------------------------
# DataStream jobs on a mesh


def _session_events():
    rng = np.random.default_rng(11)
    n = 3000
    return sorted(((int(k), int(u), int(t)) for k, u, t in zip(
        rng.integers(0, 24, n), rng.integers(0, 64, n),
        rng.integers(0, 60_000, n))), key=lambda e: e[2])


def _run_job(pkg, mesh, events, agg, assigner, key_of, wf):
    if pkg is J:
        from flink_tpu.streaming.datastream import StreamExecutionEnvironment
        from flink_tpu.streaming.sources import (
            BoundedOutOfOrdernessTimestampExtractor, CollectSink)
        env = StreamExecutionEnvironment()
    else:
        from flink_tpu_torch.streaming.datastream import \
            StreamExecutionEnvironment
        from flink_tpu_torch.streaming.sources import (
            BoundedOutOfOrdernessTimestampExtractor, CollectSink)
        env = StreamExecutionEnvironment.get_execution_environment(device="cpu")
    if mesh is not None:
        env.set_mesh(mesh)
    sink = CollectSink()
    (env.from_collection(events)
        .assign_timestamps_and_watermarks(
            BoundedOutOfOrdernessTimestampExtractor(0, lambda e: e[2]))
        .key_by(key_of).window(assigner).aggregate(agg, window_function=wf)
        .add_sink(sink))
    env.execute("mesh-job")
    return sink.values


def test_datastream_session_job_on_mesh(meshes):
    from flink_tpu.streaming.windowing import EventTimeSessionWindows as JSess
    from flink_tpu_torch.streaming.windowing import EventTimeSessionWindows as TSess
    events = _session_events()
    wf = lambda key, w, vals: [(key, w.start, w.end, int(vals[0]))]  # noqa: E731
    out = {}
    for pkg, sess in ((J, JSess), (T, TSess)):
        for mesh in (meshes[pkg], None):
            agg = pkg.sk.CountMinSketchAggregate(depth=4, width=256)
            agg.extract_value = lambda rec: rec[1]
            out[(pkg, mesh is None)] = {
                (k, s, e): t for k, s, e, t in _run_job(
                    pkg, mesh, events, agg, sess.with_gap(500),
                    lambda e: e[0], wf)}
    assert out[(T, False)] == out[(T, True)] == out[(J, False)] \
        == out[(J, True)]
    assert len(out[(T, False)]) > 0


@pytest.mark.parametrize("keys", ["int", "composite"])
def test_datastream_tumbling_hll_job_on_mesh(meshes, keys):
    """Integer keys take the mesh log tier, composite keys the sharded
    scatter tier; both equal the meshless job and the reference's mesh
    job (HLL within the port slack)."""
    from flink_tpu.streaming.windowing import TumblingEventTimeWindows as JTumb
    from flink_tpu_torch.streaming.windowing import \
        TumblingEventTimeWindows as TTumb
    rng = np.random.default_rng(21)
    n = 4000
    events = [(int(k), int(u), int(t)) for k, u, t in zip(
        rng.integers(0, 60, n), rng.integers(0, 10**6, n),
        np.sort(rng.integers(0, 4000, n)))]
    key_of = ((lambda e: e[0]) if keys == "int"
              else (lambda e: (f"k{e[0] % 7}", e[0])))
    wf = lambda key, w, vals: [(str(key), w.start, float(vals[0]))]  # noqa: E731
    out = {}
    for pkg, tumb in ((J, JTumb), (T, TTumb)):
        for mesh in (meshes[pkg], None):
            agg = pkg.sk.HyperLogLogAggregate(10)
            agg.extract_value = lambda rec: rec[1]
            out[(pkg, mesh is None)] = {
                (k, s): v for k, s, v in _run_job(
                    pkg, mesh, events, agg, tumb.of(1000), key_of, wf)}
    assert out[(T, False)] == out[(T, True)]
    ref = out[(J, False)]
    assert set(ref) == set(out[(T, True)]) and len(ref) > 0
    ks = sorted(ref)
    assert_hll_close([out[(T, True)][x] for x in ks], [ref[x] for x in ks],
                     1 << 10)


def test_operator_picks_the_mesh_tiers(meshes):
    from flink_tpu_torch.streaming.device_window_operator import (
        DeviceWindowOperator, is_mesh_factory, resolve_mesh)
    from flink_tpu_torch.streaming.windowing import (SlidingEventTimeWindows,
                                                     TumblingEventTimeWindows)
    mesh = meshes[T]
    hll = tsk.HyperLogLogAggregate(10)

    def engine(assigner, agg, keys, m=mesh):
        op = DeviceWindowOperator(assigner, agg, device="cpu", mesh=m)
        op._ensure_engine(keys)
        return op, op.engine
    tumb, slid = TumblingEventTimeWindows.of(1000), SlidingEventTimeWindows.of(2000, 1000)
    ints = np.arange(4, dtype=np.int64)
    rows = np.array([["a", "1"], ["b", "2"]])
    assert isinstance(engine(tumb, hll, ints)[1], tml.MeshLogTumblingWindows)
    assert isinstance(engine(slid, hll, ints)[1], tml.MeshLogSlidingWindows)
    assert isinstance(engine(tumb, hll, rows)[1], tmw.MeshTumblingWindows)
    assert isinstance(engine(slid, tda.CountAggregate(), ints)[1],
                      tmw.MeshSlidingWindows)
    eng = engine(tumb, tda.CountAggregate(), rows)[1]
    assert eng.region_size == (1 << 14) // 8
    # a factory resolves at the first flush; the fused string sum is off
    op, eng = engine(tumb, tda.SumAggregate(np.float64),
                     np.array(["x", "y"]), m=lambda: mesh)
    assert op.mesh is mesh and not op._wants_fused_string_sum()
    assert is_mesh_factory(lambda: mesh) and not is_mesh_factory(mesh)
    assert resolve_mesh(None) is None


def test_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Mesh(["cuda"] * 8)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Mesh([None])
    assert Mesh(["cpu"] * 2).shape == {"kg": 2}


def test_shard_pack_wrapper_takes_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(6)
    rows = torch.from_numpy(rng.integers(0, 2**31, (64, 4)).astype(np.int32))
    tgt = torch.from_numpy(rng.integers(0, 5, 64).astype(np.int32))
    a = shard_pack(rows, 4, 5, target=tgt)
    b = shard_pack_plain(rows, 4, 5, target=tgt)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# ---------------------------------------------------------------------
# on cards: a mesh over distinct cards against virtual shards on one


@pytest.fixture(scope="module")
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    from flink_tpu_torch import kernels as K
    K.build_all()
    n = 1 << (torch.cuda.device_count().bit_length() - 1)
    return [torch.device("cuda", i) for i in range(n)]


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["tumbling_hll", "sliding_quantile",
                                    "log_hll"])
def test_mesh_over_cards_equals_virtual_shards(cards, engine):
    """Shard s on card s (tables, states, kernels launched inside
    ``mesh.on(s)``, the exchange as copies between cards) gives the
    results of the same shards as virtual shards of one card, bit for
    bit."""
    rng = np.random.default_rng(23)
    n = 1 << 16
    keys = rng.integers(0, 5000, n).astype(np.int64)
    ts = np.sort(rng.integers(0, 4000, n))
    users = rng.integers(0, 2**40, n)
    vals = np.round(rng.gamma(2.0, 10.0, n), 1) + 0.05

    def run(mesh):
        if engine == "tumbling_hll":
            eng = tmw.MeshTumblingWindows(tsk.HyperLogLogAggregate(12), 1000,
                                          mesh, capacity_per_window_shard=4096,
                                          step_batch=1 << 13)
            eng.process_batch(keys, ts, users)
        elif engine == "sliding_quantile":
            eng = tmw.MeshSlidingWindows(tsk.QuantileSketchAggregate(
                quantiles=(0.5, 0.99)), 2000, 1000, mesh,
                capacity_per_window_shard=4096, step_batch=1 << 13)
            eng.process_batch(keys, ts, vals)
        else:
            eng = tml.MeshLogTumblingWindows(tsk.HyperLogLogAggregate(12), 1000,
                                             mesh, step_batch=1 << 13,
                                             finish_tier="device")
            eng.process_batch(keys, ts, None,
                              value_hashes=splitmix64_np(users.astype(np.uint64)))
        eng.advance_watermark(10_000)
        return {k: np.asarray(v).tolist() for k, v in _emitted(eng).items()}
    spread = run(Mesh(cards))
    one = run(Mesh([cards[0]] * len(cards)))
    assert spread == one and len(spread) > 0
