"""``knn_topk``'s kernel logic, on the CPU: a numpy twin of the
kernel's candidate key (the distance's bits in the total order of
float32 over the column index) against the reference's
``lax.top_k(-d)`` and the plain version, and the kernel's split of a
row's columns over its threads (head floats, 16-byte words, tail
floats) at every alignment.  The kernel's constants are read from its
source."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_tpu_torch import kernels as K

SRC = (Path(__file__).resolve().parent.parent / "flink_tpu_torch" / "kernels"
       / "csrc" / "knn_topk.cu").read_text()
# the threads a block of each launch takes (the last template argument)
THREADS = sorted({int(t) for t in re.findall(r"launch<\d+, \d+, (\d+)>", SRC)})


def key_twin(d: np.ndarray) -> np.ndarray:
    """The kernel's knn_key_of for float32 distances d [n] at columns
    0..n-1, as uint64."""
    b = d.astype(np.float32).view(np.uint32)
    o = np.where(b & 0x80000000, ~b, b | 0x80000000).astype(np.uint32)
    return (o.astype(np.uint64) << np.uint64(32)) | np.arange(len(d), dtype=np.uint64)


NEG_NAN = np.uint32(0xFFC00000).view(np.float32)


@pytest.mark.parametrize("kind", ["normal", "ties", "special"])
def test_key_order_is_the_reference_order(kind):
    rng = np.random.default_rng(5)
    n = 5000
    if kind == "normal":
        d = rng.standard_normal(n).astype(np.float32)
    elif kind == "ties":
        d = rng.integers(-4, 5, n).astype(np.float32)
    else:
        d = rng.integers(-3, 4, n).astype(np.float32)
        d[rng.random(n) < 0.05] = np.nan
        d[rng.random(n) < 0.05] = NEG_NAN
        d[rng.random(n) < 0.05] = np.inf
        d[rng.random(n) < 0.05] = -np.inf
        d[rng.random(n) < 0.05] = -0.0
        d[rng.random(n) < 0.05] = 0.0
    keys = key_twin(d)
    assert len(np.unique(keys)) == n
    want = np.asarray(jax.lax.top_k(-jnp.asarray(d), n)[1])
    np.testing.assert_array_equal(np.argsort(keys, kind="stable"), want)


@pytest.mark.parametrize("kind", ["ties", "special"])
@pytest.mark.parametrize("k", [1, 3, 16, 64])
def test_plain_version_is_the_key_order(kind, k):
    """knn_topk (on the CPU: its plain version) gives the k smallest keys
    of each row, in order."""
    rng = np.random.default_rng(k)
    m, n = 7, 1003
    qx = rng.integers(-2, 3, (m, n)).astype(np.float32)
    qn = rng.integers(0, 4, m).astype(np.float32)
    xn = rng.integers(0, 4, n).astype(np.float32)
    if kind == "special":
        qx[rng.random((m, n)) < 0.02] = np.nan
        qx[rng.random((m, n)) < 0.02] = NEG_NAN
        qx[2] = np.nan
        qx[4, :9] = -np.inf
    got = K.knn_topk(*(torch.from_numpy(a) for a in (qx, qn, xn)), k).numpy()
    d2 = (qn[:, None] + xn[None, :]) - np.float32(2.0) * qx
    for i in range(m):
        np.testing.assert_array_equal(got[i], np.argsort(key_twin(d2[i]))[:k])


def thread_columns(n: int, align: int, threads: int):
    """The columns each thread of the kernel's block takes in a row whose
    first float lies ``align`` floats past a 16-byte boundary: the head
    floats up to the next boundary and the tail floats after the last
    whole word, to threads 0.. in order; word g (columns h + 4g ..
    h + 4g + 3) to thread g % threads."""
    h = min((4 - align) % 4, n)
    words = (n - h) // 4
    tail = h + 4 * words
    cols = [[] for _ in range(threads)]
    for e in range(h + (n - tail)):
        cols[e].append(e if e < h else tail + (e - h))
    for g in range(words):
        cols[g % threads].extend(range(h + 4 * g, h + 4 * g + 4))
    return h, cols


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7, 1024, 1025, 4099, 60_000])
@pytest.mark.parametrize("align", [0, 1, 2, 3])
def test_every_column_is_taken_once(n, align):
    assert THREADS == [64, 256]
    for threads in THREADS:
        h, cols = thread_columns(n, align, threads)
        taken = sorted(c for t in cols for c in t)
        assert taken == list(range(n))
        # the body's words start on a 16-byte boundary
        assert (align + h) % 4 == 0 or h == n
