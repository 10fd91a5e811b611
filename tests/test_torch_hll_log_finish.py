"""``hll_log_finish``'s split of the work, on the CPU: a numpy twin of
the kernel's loops (a key's run read in aligned 16-byte words, strided over
its group's lanes in batches, long runs over the warp, float64 sums of
the terms, each lane's in its own order) against the plain version's
exact float64 sums, across
lanes a key, memory offsets of the ranks, empty runs and keys with all
65,536 cells.  The kernel's constants are read from its source."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from flink_tpu_torch import kernels as K
from flink_tpu_torch.ops.sketches import HyperLogLogAggregate

SRC = (Path(__file__).resolve().parent.parent / "flink_tpu_torch" / "kernels"
       / "csrc" / "hll_log_finish.cu").read_text()
LF = {k: int(v) for k, v in re.findall(r"#define LF_(\w+) (\d+)", SRC)}


def kernel_twin(ranks: np.ndarray, ends: np.ndarray, group: int,
                off: int) -> np.ndarray:
    """The kernel's per-key sums of 2^-rank, by its own loops:
    ranks lie at byte ``off`` of 16-byte words; lane g of a key's group
    takes words a + g, a + g + group, ... in batches of BATCH, masking
    the bytes outside the run, and a run of more than LONG_WORDS words a
    lane (with fewer than 32 lanes a key) is summed by the 32 lanes of
    the warp instead."""
    batch, long_words = LF["BATCH"], LF["LONG_WORDS"]
    mem = np.concatenate([np.zeros(off, np.uint8), ranks,
                          np.zeros(16, np.uint8)]).astype(np.int64)

    def run_sum(first, b, step, lo, hi):
        s = 0.0
        for w0 in range(first, b, batch * step):
            for i in range(batch):
                w = w0 + i * step
                if w < b:
                    p0 = (w << 4) - off
                    for p in range(max(p0, lo), min(p0 + 16, hi)):
                        s += 2.0 ** -int(mem[p + off])
        return s

    acc = np.zeros(len(ends))
    for key in range(len(ends)):
        lo = 0 if key == 0 else int(ends[key - 1])
        hi = int(ends[key])
        a = (lo + off) >> 4
        b = ((hi - 1 + off) >> 4) + 1 if hi > lo else a
        if group < 32 and b - a > long_words * group:
            parts = [run_sum(a + lane, b, 32, lo, hi) for lane in range(32)]
        else:
            parts = [run_sum(a + g, b, group, lo, hi) for g in range(group)]
        acc[key] = sum(parts[::-1])     # the shuffles' order differs too
    return acc


def _runs(rng, p, layout):
    """(ranks, ends) of compacted cells: runs of at most m cells, ranks
    1..33 (a few 33s)."""
    m = 1 << p
    if layout == "one_key":
        lengths = np.array([m])
    elif layout == "long_runs":
        lengths = rng.integers(1, 12, 700)
        for j in (0, 31, 32, 500, 699):
            lengths[j] = m
        lengths[[5, 6, 40, 600]] = 0           # empty runs
    else:
        lengths = rng.integers(0, min(m, 40) + 1, 700)
    lengths = np.minimum(lengths, m)
    ends = np.cumsum(lengths).astype(np.int32)
    ranks = rng.integers(1, 34, int(ends[-1])).astype(np.uint8)
    ranks[::97] = 33
    return ranks, ends


@pytest.mark.parametrize("p", [4, 12, 16])
@pytest.mark.parametrize("layout", ["one_key", "long_runs", "short"])
@pytest.mark.parametrize("group,off", [(1, 0), (1, 1), (2, 7), (8, 15), (32, 3)])
def test_kernel_twin_sums_equal_plain(p, layout, group, off):
    rng = np.random.default_rng(p * 10 + off)
    ranks, ends = _runs(rng, p, layout)
    m = 1 << p
    want = torch.empty(len(ends), dtype=torch.float64)
    est = K.hll_log_finish_plain(torch.from_numpy(ranks), torch.from_numpy(ends),
                                 m, HyperLogLogAggregate(p).alpha, inv_sum=want)
    acc = kernel_twin(ranks, ends, group, off)
    present = np.diff(ends, prepend=0).astype(np.float64)
    got = (m - present) + acc
    np.testing.assert_array_equal(got, want.numpy())
    assert np.isfinite(est.numpy()).all()
