"""``merge_rows_many`` (every component of a state in one call) against
the reference's ``merge_slots`` / ``merge_rows`` (``flink_tpu/ops/
device_agg.py``, ``flink_tpu/ops/sketches.py``), on the same numpy
states, on the CPU (the plain version), and the launch path's binding
and stream (``kernels/loader.py``) with the library stubbed.

Integer merges are exact; float32 states compare bit for bit, a NaN
equal to any NaN (min / max follow the reference's order: NaN wins,
-0 < +0; adds of integer-valued floats are exact).
"""

import numpy as np
import pytest
import torch

import flink_tpu.ops.device_agg as jda
import flink_tpu.ops.sketches as js
import flink_tpu_torch.ops.device_agg as tda
import flink_tpu_torch.ops.sketches as ts
import jax.numpy as jnp
from flink_tpu_torch import kernels as K
from flink_tpu_torch.kernels import loader

_SPECIAL = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1.5, -1.5, 3.0],
                    np.float32)
_Q = dict(relative_accuracy=0.05, min_value=1e-3, max_value=1e6)

AGGS = {
    "countmin": ("CountMinSketchAggregate", (3, 50)),
    "avg": ("AvgAggregate", ()),
    "hll": ("HyperLogLogAggregate", (6,)),
    "quantile": ("QuantileSketchAggregate", ()),
    "sum_i32": ("SumAggregate", (np.int32,)),
    "sum_f32": ("SumAggregate", (np.float32,)),
    "count": ("CountAggregate", ()),
    "min_i32": ("MinAggregate", (np.int32,)),
    "min_f32": ("MinAggregate", (np.float32,)),
    "max_i32": ("MaxAggregate", (np.int32,)),
    "max_f32": ("MaxAggregate", (np.float32,)),
}


def _aggs(name):
    cls, args = AGGS[name]
    kw = _Q if name == "quantile" else {}
    pkgs = (js, ts) if hasattr(js, cls) else (jda, tda)
    return (getattr(pkgs[0], cls)(*args, **kw), getattr(pkgs[1], cls)(*args, **kw))


def _state(tagg, name, c, rng):
    state = tagg.init_state(c, device="cpu")
    for k, comp in state.items():
        if comp.dtype == torch.uint8:
            vals = rng.integers(0, 30, comp.shape).astype(np.uint8)
        elif comp.dtype == torch.float32 and name.startswith(("min", "max")):
            vals = rng.choice(_SPECIAL, comp.shape).astype(np.float32)
        elif comp.dtype == torch.float32:
            vals = rng.integers(-500, 500, comp.shape).astype(np.float32)
        else:                               # int32 adds wrap: cross 2^31
            vals = rng.integers(-2**31, 2**31, comp.shape, dtype=np.int64).astype(np.int32)
        comp.copy_(torch.from_numpy(vals))
    return state


def _same(got, want):
    if got.dtype == np.float32:
        gn, wn = np.isnan(got), np.isnan(want)
        np.testing.assert_array_equal(gn, wn)
        np.testing.assert_array_equal(got[~gn].view(np.int32), want[~wn].view(np.int32))
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("unique", [False, True])
@pytest.mark.parametrize("name", sorted(AGGS))
def test_merge_rows_many_matches_jax(name, unique):
    rng = np.random.default_rng(71)
    c = 64
    jagg, tagg = _aggs(name)
    state = _state(tagg, name, c, rng)
    perm = rng.permutation(c).astype(np.int32)
    if unique:
        dst, src = perm[:16], perm[16:32]
    else:                                   # each of 5 dst 4 times
        dst, src = np.repeat(perm[:5], 4), perm[5:25]
    names = list(tagg.state_specs())
    got = {k: v.clone() for k, v in state.items()}
    K.merge_rows_many([got[k] for k in names], torch.from_numpy(dst),
                      torch.from_numpy(src), [tagg.combiners[k] for k in names],
                      unique_dst=unique)
    jstate = {k: jnp.asarray(v.numpy()) for k, v in state.items()}
    jfn = jagg.merge_rows if unique else jagg.merge_slots
    want = jfn(jstate, jnp.asarray(dst), jnp.asarray(src))
    for k in names:
        _same(got[k].numpy(), np.asarray(want[k]))


def test_a_merge_is_one_call_for_every_component(monkeypatch):
    """``merge_slots`` and ``merge_rows`` of a two-component state make
    one ``merge_rows_many`` call with both components."""
    calls = []
    real = tda.merge_rows_many
    monkeypatch.setattr(tda, "merge_rows_many",
                        lambda comps, *a, **kw: (calls.append(len(comps)),
                                                 real(comps, *a, **kw)))
    for agg in (ts.CountMinSketchAggregate(4, 16), tda.AvgAggregate()):
        state = agg.init_state(8, device="cpu")
        d, s = torch.tensor([0, 0], dtype=torch.int32), torch.tensor([1, 2], dtype=torch.int32)
        agg.merge_slots(state, d, s)
        agg.merge_rows(state, torch.tensor([3], dtype=torch.int32),
                       torch.tensor([4], dtype=torch.int32))
    assert calls == [2, 2, 2, 2]


def test_merge_rows_many_refuses_bad_arguments():
    comp = torch.zeros((8, 4), dtype=torch.int32)
    d, s = torch.tensor([1], dtype=torch.int32), torch.tensor([2], dtype=torch.int32)
    with pytest.raises(ValueError, match="ops"):
        K.merge_rows_many([comp, comp], d, s, ["add"])
    with pytest.raises(ValueError, match="op must be"):
        K.merge_rows_many([comp], d, s, ["mul"])
    with pytest.raises(ValueError, match="src rows"):
        K.merge_rows_many([comp], d, torch.tensor([2, 3], dtype=torch.int32), ["add"])


def test_launch_binds_each_function_once_and_passes_the_stream(monkeypatch):
    """``launch`` looks the exported function up once, passes the current
    stream's raw handle last, counts the launch and raises on an error."""
    seen, looked_up = [], []

    class Lib:
        def __getattr__(self, fn):
            looked_up.append(fn)
            return lambda *args: (seen.append(args), 0 if args[0] else 7)[1]

    monkeypatch.setattr(loader, "library", lambda name: Lib())
    monkeypatch.setattr(loader, "current_stream", lambda: 1234)
    monkeypatch.setattr(loader, "_functions", {})
    monkeypatch.setitem(loader.LAUNCHES, "merge_rows", 0)
    loader.launch("merge_rows", "ft_merge_rows", 1, 2)
    loader.launch("merge_rows", "ft_merge_rows", 3, 4)
    with pytest.raises(RuntimeError, match="error 7"):
        loader.launch("merge_rows", "ft_merge_rows", 0, 5)
    assert looked_up == ["ft_merge_rows"]
    assert seen == [(1, 2, 1234), (3, 4, 1234), (0, 5, 1234)]
    assert loader.LAUNCHES["merge_rows"] == 3
