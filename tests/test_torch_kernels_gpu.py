"""Each hand-written CUDA kernel against its plain PyTorch version, on
the card.  Marked ``gpu``: without a CUDA device every test skips (the
fixture decides, never the import).  On a machine with a card:

    python -m pytest -m gpu --noconftest tests/test_torch_kernels_gpu.py

Registers, integer results and fills must be bit-equal; HLL estimates
agree within rtol 1e-5 (the kernel's reduction order differs from the
plain version's); float32 sums use integer-valued data, which float
atomics add exactly in any order.
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
