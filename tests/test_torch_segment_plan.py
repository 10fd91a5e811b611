"""The plan of ``gather_segment_sum`` (``kernels.segment_plan``) and the
segment sums through it, against ``jax.ops.segment_sum`` (the reference's
PageRank and HITS steps, ``flink_tpu/graph/library.py:40-49, 243-255``) on
the same numpy inputs, on the CPU.

The plan is a change of layout: its invariants (bounds, a stable order,
the kernel's merge-path tile coordinates) are exact.  The sums: integer
values below 2^24 add exactly in any order, so they are bit-equal to the
reference's; float32 values agree within ``reorder_bound`` (two float32
sums of the same t terms differ by at most 2 t eps sum|terms| in any two
orders).  On the CPU the wrapper runs the plain version, which adds in
the plan's order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_tpu_torch import kernels as K
from flink_tpu_torch.kernels.gather_segment_sum import TILE_ITEMS

EPS = float(np.finfo(np.float32).eps)


def reorder_bound(terms, abs_sum):
    return 2.0 * np.asarray(terms, np.float64) * EPS * np.asarray(abs_sum, np.float64)


def _graph(kind, seed=0):
    """(src, dst, n) of a small graph of one shape."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        n, e = 3000, 40_000
        return rng.integers(0, n, e), rng.integers(0, n, e), n
    if kind == "empty_segments":        # most vertices receive no edge
        n, e = 5000, 3000
        return rng.integers(0, n, e), rng.integers(0, 50, e) * 97, n
    if kind == "one_vertex_has_every_edge":
        n, e = 700, 9000
        return rng.integers(0, n, e), np.full(e, 311), n
    if kind == "skewed":                 # a power law: a few rows span tiles
        n, e = 4000, 60_000
        dst = np.minimum(rng.zipf(1.3, e) - 1, n - 1)
        return rng.integers(0, n, e), rng.permutation(n)[dst], n
    if kind == "no_edges":
        return np.zeros(0, np.int64), np.zeros(0, np.int64), 17
    raise ValueError(kind)


KINDS = ["random", "empty_segments", "one_vertex_has_every_edge", "skewed",
         "no_edges"]


def _plan(kind, dtype=torch.int32):
    src, dst, n = _graph(kind)
    plan = K.segment_plan(torch.from_numpy(src).to(dtype),
                          torch.from_numpy(dst).to(dtype), n)
    return src, dst, n, plan


@pytest.mark.parametrize("kind", KINDS)
def test_indptr_is_monotone_and_ends_at_e(kind):
    src, dst, n, plan = _plan(kind)
    ip = plan.indptr.numpy()
    assert plan.indptr.dtype == plan.cols.dtype == torch.int32
    assert len(ip) == n + 1 and ip[0] == 0 and ip[-1] == len(src)
    assert np.all(np.diff(ip) >= 0)
    np.testing.assert_array_equal(np.diff(ip), np.bincount(dst, minlength=n))
    if kind == "one_vertex_has_every_edge":
        assert ip[311] == 0 and ip[312] == len(src)
    if kind == "empty_segments":
        assert np.count_nonzero(np.diff(ip) == 0) > n - 60


@pytest.mark.parametrize("kind", KINDS)
def test_cols_are_stable_within_each_segment(kind):
    """cols = src in the order of a stable sort by dst: each segment's
    gathered indices keep the edges' order."""
    src, dst, n, plan = _plan(kind)
    want = src[np.argsort(dst, kind="stable")]
    np.testing.assert_array_equal(plan.cols.numpy(), want)
    assert plan.gathered == (int(src.max()) + 1 if len(src) else 0)


@pytest.mark.parametrize("kind", KINDS)
def test_tile_coordinates_lie_on_the_merge_path(kind):
    """Tile b starts TILE_ITEMS * b items into the merge of the row ends
    and the edges (a row end before the edge of the same index): the rows
    done are those whose end item i + indptr[i + 1] comes earlier."""
    src, dst, n, plan = _plan(kind)
    e = len(src)
    c = plan.coords.numpy().astype(np.int64)
    assert c.shape == (-(-(n + e) // TILE_ITEMS) + 1, 2)
    assert tuple(c[0]) == (0, 0) and tuple(c[-1]) == (n, e)
    d = c.sum(1)
    np.testing.assert_array_equal(d[:-1], np.arange(len(c) - 1) * TILE_ITEMS)
    assert np.all(np.diff(c, axis=0) >= 0)
    ends = plan.indptr.numpy()[1:].astype(np.int64)
    end_items = np.arange(n) + ends
    np.testing.assert_array_equal(c[:, 0], [np.count_nonzero(end_items < x) for x in d])
    # the edges done are exactly those of the rows done and the next row's
    # first ones: no edge of a later row
    starts = plan.indptr.numpy()[:-1].astype(np.int64)
    inside = c[:, 0] < n
    assert np.all(c[inside, 1] >= starts[c[inside, 0]])
    assert np.all(c[inside, 1] <= ends[c[inside, 0]])


@pytest.mark.parametrize("kind", KINDS)
def test_segment_sum_through_the_plan_matches_jax(kind):
    """PageRank's step, segment_sum((ranks / deg)[src], dst), through the
    plan: integer values bit-equal, float32 within reorder_bound."""
    src, dst, n, plan = _plan(kind)
    rng = np.random.default_rng(7)
    for x in (rng.integers(-50, 50, n).astype(np.float32),
              rng.random(n).astype(np.float32)):
        want = np.asarray(jax.ops.segment_sum(jnp.asarray(x)[jnp.asarray(src)],
                                              jnp.asarray(dst), num_segments=n))
        got = K.gather_segment_sum(torch.from_numpy(x), plan).numpy()
        assert got.dtype == np.float32 and got.shape == (n,)
        mag = np.zeros(n)
        np.add.at(mag, dst, np.abs(x[src]).astype(np.float64))
        bound = reorder_bound(np.bincount(dst, minlength=n), mag)
        assert np.all(np.abs(got.astype(np.float64) - want) <= bound)
        if x.dtype == np.float32 and np.all(x == np.round(x)):
            np.testing.assert_array_equal(got, want)


def test_the_plain_version_adds_in_the_plans_order():
    """On the CPU the wrapper is the plain version, and both equal a
    left-to-right float32 sum of each segment's values in plan order."""
    src, dst, n, plan = _plan("skewed")
    x = np.random.default_rng(3).standard_normal(n).astype(np.float32)
    xt = torch.from_numpy(x)
    got = K.gather_segment_sum(xt, plan)
    assert torch.equal(got, K.gather_segment_sum_plain(xt, plan))
    ip, cols = plan.indptr.numpy(), plan.cols.numpy()
    for i in np.argsort(np.diff(ip))[-5:]:
        acc = np.float32(0)
        for v in x[cols[ip[i]:ip[i + 1]]]:
            acc = np.float32(acc + v)
        assert got[i].item() == acc


@pytest.mark.parametrize("dtypes", [(torch.int32, torch.int32),
                                    (torch.int64, torch.int64),
                                    (torch.int64, torch.int32)])
def test_plan_takes_int32_and_int64_endpoints(dtypes):
    src, dst, n = _graph("random")
    plan = K.segment_plan(torch.from_numpy(src).to(dtypes[0]),
                          torch.from_numpy(dst).to(dtypes[1]), n)
    _, _, _, ref = _plan("random", torch.int32)
    for a, b in zip(plan[:3], ref[:3]):
        assert a.dtype == torch.int32 and torch.equal(a, b)


@pytest.mark.parametrize("bad", ["dst_out_of_range", "negative_src",
                                 "lengths", "float", "no_segments"])
def test_plan_refuses_what_the_kernel_cannot_take(bad):
    src = torch.tensor([0, 1, 2], dtype=torch.int32)
    dst = torch.tensor([1, 2, 0], dtype=torch.int32)
    n = 3
    if bad == "dst_out_of_range":
        dst = torch.tensor([1, 3, 0], dtype=torch.int32)
    elif bad == "negative_src":
        src = torch.tensor([0, -1, 2], dtype=torch.int32)
    elif bad == "lengths":
        dst = dst[:2]
    elif bad == "float":
        src = src.float()
    else:
        n = 0
    with pytest.raises((ValueError, TypeError)):
        K.segment_plan(src, dst, n)


def test_wrapper_raises_when_x_and_the_plan_lie_apart():
    """x on the CPU, a plan on another device (meta tensors here): the
    wrapper raises before it runs anything."""
    _, _, n, plan = _plan("random")
    elsewhere = K.SegmentPlan(*(t.to("meta") for t in plan[:3]), plan.n,
                              plan.gathered)
    with pytest.raises(ValueError, match="plan"):
        K.gather_segment_sum(torch.zeros(n), elsewhere)
    with pytest.raises(ValueError, match="gathers"):
        K.gather_segment_sum(torch.zeros(plan.gathered - 1), plan)
