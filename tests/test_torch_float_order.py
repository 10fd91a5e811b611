"""float32 min / max of the port against the JAX package's, in the
reference's order: XLA on the CPU propagates NaN and orders -0 below +0,
whatever the row order.  Each case goes through the plain versions of
``scatter_combine`` and ``merge_rows`` (both the unique-dst and the
scatter path), the Min / Max aggregates' update, merges and scalar merge,
and the graph iterations' ``segment_combine``, on the same numpy inputs
as the reference.  Results are compared bit for bit, except that a NaN
equals any NaN (the port stores 0xFFFFFFFF for a min's NaN and
0x7FFFFFFF for a max's; XLA keeps an input's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_tpu.ops import device_agg as jd
from flink_tpu_torch import kernels as K
from flink_tpu_torch.graph.iterations import segment_combine
from flink_tpu_torch.ops import device_agg as td

NAN_POS = np.array([0x7FC00000], np.uint32).view(np.float32)[0]
NAN_NEG = np.array([0xFFC00001], np.uint32).view(np.float32)[0]
CASES = ["zeros_pos_first", "zeros_neg_first", "nan_values", "nan_state",
         "inf", "ordinary"]
OPS = ["min", "max"]


def assert_same(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(got[ok].view(np.uint32), want[ok].view(np.uint32))


def make_case(case, op, seed=0):
    """(state [C], slots [N], values [N]) float32 / int32 numpy arrays."""
    rng = np.random.default_rng(seed + CASES.index(case) * 7 + OPS.index(op))
    fill = np.float32(7.0 if op == "min" else -7.0)
    if case.startswith("zeros"):
        pos_first = case == "zeros_pos_first"
        z = [0.0, -0.0] if pos_first else [-0.0, 0.0]
        # slot 0: both zeros as rows; slots 1 and 2: a zero in the state,
        # the other zero as a row; slot 3 untouched
        state = np.array([fill, z[0], z[1], fill], np.float32)
        slots = np.array([0, 0, 1, 2], np.int32)
        vals = np.array([z[0], z[1], z[1], z[0]], np.float32)
        return state, slots, vals
    c, n = 40, 600
    state = rng.normal(0, 10, c).astype(np.float32)
    slots = rng.integers(0, c, n).astype(np.int32)
    vals = rng.normal(0, 10, n).astype(np.float32)
    if case == "nan_values":
        pick = rng.random(n) < 0.05
        vals[pick] = np.where(rng.random(pick.sum()) < 0.5, NAN_POS, NAN_NEG)
    elif case == "nan_state":
        state[::5] = NAN_POS
        state[1::5] = NAN_NEG
    elif case == "inf":
        vals[rng.random(n) < 0.1] = np.inf
        vals[rng.random(n) < 0.1] = -np.inf
        state[::4] = np.inf
        state[1::4] = -np.inf
    return state, slots, vals


def jax_at(state, idx, vals, op):
    return np.asarray(getattr(jnp.asarray(state).at[jnp.asarray(idx)], op)(
        jnp.asarray(vals)))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("op", OPS)
def test_scatter_combine_plain_matches_at(op, case):
    state, slots, vals = make_case(case, op)
    got = torch.from_numpy(state.copy())
    K.scatter_combine_plain(got, torch.from_numpy(slots), torch.from_numpy(vals),
                            len(slots), op)
    assert_same(got.numpy(), jax_at(state, slots, vals, op))


def _merge_pairs(case, op, unique):
    """A state of 2C rows: rows [0, C) are dst rows, [C, 2C) src rows;
    each src row holds one of the case's values."""
    state, slots, vals = make_case(case, op)
    c = len(state)
    m = min(len(vals), c)
    full = np.concatenate([state, vals[:m], np.zeros(c - m, np.float32)]).astype(np.float32)
    src = np.arange(c, c + m, dtype=np.int32)
    dst = np.arange(m, dtype=np.int32) if unique else slots[:m]
    if not unique and case.startswith("zeros"):
        dst = np.zeros(m, np.int32)            # every zero into one row
    return full, dst, src


@pytest.mark.parametrize("unique", [True, False], ids=["unique_dst", "scatter"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("op", OPS)
def test_merge_rows_plain_matches_at(op, case, unique):
    full, dst, src = _merge_pairs(case, op, unique)
    got = torch.from_numpy(full.copy())
    K.merge_rows_plain(got, torch.from_numpy(dst), torch.from_numpy(src), op,
                       unique_dst=unique)
    assert_same(got.numpy(), jax_at(full, dst, full[src], op))


def _aggs(op):
    name = "MinAggregate" if op == "min" else "MaxAggregate"
    return getattr(jd, name)(np.float32), getattr(td, name)(np.float32)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("op", OPS)
def test_aggregate_update_matches_reference(op, case):
    state, slots, vals = make_case(case, op)
    jagg, tagg = _aggs(op)
    key = op
    jstate = jagg.update({key: jnp.asarray(state)}, jnp.asarray(slots),
                         jnp.asarray(vals), jnp.zeros(1, jnp.uint32),
                         jnp.zeros(1, jnp.uint32), jnp.ones(len(slots), bool))
    tstate = tagg.update({key: torch.from_numpy(state.copy())}, torch.from_numpy(slots),
                         torch.from_numpy(vals), None, None, len(slots))
    assert_same(tstate[key].numpy(), jstate[key])


@pytest.mark.parametrize("merge", ["merge_slots", "merge_rows"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("op", OPS)
def test_aggregate_merges_match_reference(op, case, merge):
    unique = merge == "merge_rows"
    full, dst, src = _merge_pairs(case, op, unique)
    jagg, tagg = _aggs(op)
    jstate = getattr(jagg, merge)({op: jnp.asarray(full)}, jnp.asarray(dst),
                                  jnp.asarray(src))
    tstate = getattr(tagg, merge)({op: torch.from_numpy(full.copy())},
                                  torch.from_numpy(dst), torch.from_numpy(src))
    assert_same(tstate[op].numpy(), jstate[op])


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("op", OPS)
def test_aggregate_scalar_merge_matches_reference(op, case):
    """The scalar contract's merge(a, b), both orders of every pair of a
    case's values."""
    state, _, vals = make_case(case, op)
    jagg, tagg = _aggs(op)
    values = np.concatenate([state[:4], vals[:4]])
    for a in values:
        for b in values:
            acc_a = {op: np.array([a], np.float32)}
            acc_b = {op: np.array([b], np.float32)}
            want = jagg.merge(acc_a, acc_b)[op]
            got = tagg.merge(acc_a, acc_b)[op]
            assert_same(np.reshape(got, -1), np.reshape(want, -1))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("op", OPS)
def test_segment_combine_matches_jax_segment(op, case):
    _, slots, vals = make_case(case, op)
    n = int(slots.max()) + 3                 # two segments get no message
    want = getattr(jax.ops, f"segment_{op}")(jnp.asarray(vals), jnp.asarray(slots),
                                             num_segments=n)
    got = segment_combine(op, torch.from_numpy(vals), torch.from_numpy(slots), n)
    assert_same(got.numpy(), want)

