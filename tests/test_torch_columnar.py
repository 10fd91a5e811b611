"""The port's columnar operator pipeline against the reference on the
same numpy inputs: the StreamMap / StreamFilter column kernels and
their first-batch probes, the liftability analyzer's verdicts, the
columnar sources and batch helpers, and the partitioners' batch split
(flink_tpu_torch/streaming/{operators,columnar,partitioners}.py,
flink_tpu_torch/analysis/liftability.py).  Comparisons are exact."""

import math
import random

import numpy as np
import pytest

from flink_tpu.analysis import liftability as jlift
from flink_tpu.core import functions as jfn
from flink_tpu.streaming import columnar as jcol
from flink_tpu.streaming import datastream as jds
from flink_tpu.streaming import operators as jops
from flink_tpu.streaming import partitioners as jpart
from flink_tpu.streaming import sources as jsrc
from flink_tpu.streaming.elements import RecordBatch as JBatch
from flink_tpu_torch.analysis import liftability as tlift
from flink_tpu_torch.core import functions as tfn
from flink_tpu_torch.streaming import columnar as tcol
from flink_tpu_torch.streaming import datastream as tds
from flink_tpu_torch.streaming import operators as tops
from flink_tpu_torch.streaming import partitioners as tpart
from flink_tpu_torch.streaming import sources as tsrc
from flink_tpu_torch.streaming.elements import RecordBatch as TBatch


class _Cap:
    """Operator output that keeps batches and boxed records apart."""

    def __init__(self):
        self.batches = []
        self.records = []

    def collect_batch(self, batch):
        self.batches.append(batch)

    def collect(self, record):
        self.records.append((record.value, record.timestamp))

    def emit_watermark(self, watermark):
        pass


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g.cols) == list(w.cols)
        for k in w.cols:
            assert g.cols[k].dtype == w.cols[k].dtype, k
            assert np.array_equal(g.cols[k], w.cols[k],
                                  equal_nan=g.cols[k].dtype.kind == "f"), k
        for a, b in ((g.ts, w.ts), (g.ts_mask, w.ts_mask)):
            assert (a is None) == (b is None)
            if a is not None:
                assert np.array_equal(a, b)


def _run_op(kind, pkg, fn, batches):
    """One StreamMap / StreamFilter of ``pkg`` over ``batches``; returns
    the operator and its output."""
    functions, ops = (tfn, tops) if pkg == "port" else (jfn, jops)
    cls = ops.StreamMap if kind == "map" else ops.StreamFilter
    wrap = (functions.as_map_function if kind == "map"
            else functions.as_filter_function)
    op = cls(wrap(fn))
    out = _Cap()
    op.setup(out, operator_id="op")
    op.open()
    for b in batches:
        op.process_batch(b)
    return op, out


def _batches(pkg, cols_list, ts=None, tsm=None):
    cls = TBatch if pkg == "port" else JBatch
    return [cls({k: v.copy() for k, v in cols.items()},
                None if ts is None else ts.copy(),
                None if tsm is None else tsm.copy()) for cols in cols_list]


_RNG = np.random.default_rng(4)
_TUPLES = [{"f0": _RNG.integers(0, 50, 300).astype(np.int64),
            "f1": _RNG.integers(-1000, 1000, 300).astype(np.int64),
            "f2": _RNG.random(300)} for _ in range(3)]
_SCALARS = [{"v": _RNG.integers(-100, 100, 200).astype(np.int64)}
            for _ in range(2)]
_OVERFLOW = [{"v": np.full(64, 100, np.int8)}]
_EMPTY_KEEP = [{"v": np.arange(10, dtype=np.int64)}]

_OP_CASES = [
    ("map", lambda t: (t[0], t[1] * 3, t[2] + 1.5), _TUPLES),
    ("map", lambda t: (t[0], t[1] / 2), _TUPLES),
    ("map", lambda t: (t[0], 7), _TUPLES),                      # constant field
    ("map", lambda v: v * 2 - 1, _SCALARS),
    ("map", lambda v: (v, v % 3), _SCALARS),
    ("map", lambda v: v * 2, _OVERFLOW),                        # probe mismatch
    ("map", lambda t: (t[0], float(t[1])), _TUPLES),            # scalar only
    ("map", lambda t: t[1] if t[0] > 3 else 0, _TUPLES),        # branches
    ("map", lambda v: math.floor(v / 3), _SCALARS),             # scalar only
    ("filter", lambda t: t[1] % 7 != 0, _TUPLES),
    ("filter", lambda t: t[0] >= 0, _TUPLES),                   # keeps all
    ("filter", lambda v: v > 100, _EMPTY_KEEP),                 # keeps none
    ("filter", lambda v: v + 1, _SCALARS),                      # not a mask
    ("filter", lambda t: len(t) > 2, _TUPLES),                  # not liftable
]


@pytest.mark.parametrize("case", range(len(_OP_CASES)))
def test_column_kernels_and_probes_match_the_reference(case):
    kind, fn, cols_list = _OP_CASES[case]
    ts = np.arange(len(next(iter(cols_list[0].values()))), dtype=np.int64) * 10
    p_op, p_out = _run_op(kind, "port", fn, _batches("port", cols_list, ts))
    j_op, j_out = _run_op(kind, "ref", fn, _batches("ref", cols_list, ts))
    _same_batches(p_out.batches, j_out.batches)
    assert p_out.records == j_out.records
    for attr in ("columnar_rows", "boxed_rows", "boxed_fallbacks",
                 "columnar_fallback_reason", "columnar_decided_by",
                 "kernel_probes", "_batch_kernel"):
        assert getattr(p_op, attr) == getattr(j_op, attr), attr


def test_batches_without_a_kernel_box_once():
    """A flat map has no column kernel: the batch boxes into records at
    that operator, with its timestamps and validity."""
    vals = np.arange(6, dtype=np.int64)
    ts = np.arange(6, dtype=np.int64) * 3
    tsm = np.array([1, 0, 1, 1, 0, 1], bool)
    outs = []
    for ops, functions, cls in ((tops, tfn, TBatch), (jops, jfn, JBatch)):
        op = ops.StreamFlatMap(functions.as_flat_map_function(
            lambda v: [v, -v] if v % 2 else []))
        out = _Cap()
        op.setup(out)
        op.open()
        op.process_batch(cls({"v": vals.copy()}, ts.copy(), tsm.copy()))
        outs.append((out.records, op.boxed_rows, op.columnar_fallback_reason))
    assert outs[0] == outs[1]
    assert outs[0][0] == [(1, None), (-1, None), (3, 9), (-3, 9), (5, 15), (-5, 15)]


# ---------------------------------------------------------------------
# the liftability analyzer

_K = 3
_STATE = []


def _impure_append(v):
    _STATE.append(v)
    return v


def _impure_random(v):
    return v + random.random()


def _loop(v):
    acc = 0
    for i in range(3):
        acc = acc + v * i
    return acc


class _Bound:
    def __init__(self):
        self.scale = 2

    def map(self, v):
        return v * self.scale


class _Counting:
    def __init__(self):
        self.n = 0

    def map(self, v):
        self.n += 1
        return v


_UDFS = [
    lambda v: v * 2 + 1,
    lambda t: (t[0], t[1] * 3),
    lambda t: (t[1] % 7) != 0,
    lambda v: np.where(v > 0, v, -v),
    lambda v: np.clip(v, 0, 10) * _K,
    lambda v: abs(v) - v.astype(np.float64),
    lambda v: np.sqrt(v) + np.log1p(v),
    lambda v: float(v),
    lambda v: max(v, 0),
    lambda v: v if v > 0 else 0,
    lambda v: math.floor(v),
    lambda v: str(v),
    _impure_append,
    _impure_random,
    lambda v: print(v),
    _loop,
    lambda v: len(v),
    lambda v: v.bit_length(),
    lambda v: [v, v],
    _Bound().map,
    _Counting().map,
    tfn.as_map_function(lambda v: v + 1),
    jfn.as_map_function(lambda v: v + 1),
    tfn.as_filter_function(lambda v: v > 1),
    math.sqrt,
    len,
]


@pytest.mark.parametrize("i", range(len(_UDFS)))
def test_liftability_verdicts_match_the_reference(i):
    fn = _UDFS[i]
    got, want = tlift.analyze_udf(fn), jlift.analyze_udf(fn)
    assert (got.verdict, got.reasons, got.name, got.location) == \
        (want.verdict, want.reasons, want.name, want.location)


def test_liftability_zoo_covers_every_verdict():
    verdicts = {tlift.analyze_udf(fn).verdict for fn in _UDFS}
    assert verdicts == {tlift.LIFTABLE, tlift.SCALAR_ONLY, tlift.IMPURE,
                        tlift.INCONCLUSIVE}


# ---------------------------------------------------------------------
# sources and batch helpers

_VALUES = [
    [1, 2, 3],
    [1.5, -2.0, 3.25],
    ["a", "bb", "c"],
    [(1, 2.5, "x"), (3, 4.5, "y")],
    [True, False],                     # bools do not columnarize
    [1, 2.0],                          # mixed types
    [(1, 2), (3,)],                    # ragged tuples
    [2 ** 70, 1],                      # beyond int64
    [],
]


@pytest.mark.parametrize("i", range(len(_VALUES)))
def test_columns_from_values_match_the_reference(i):
    got = tcol.columns_from_values(_VALUES[i])
    want = jcol.columns_from_values(_VALUES[i])
    assert (got is None) == (want is None)
    if got is not None:
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert got[k].tolist() == want[k].tolist()


@pytest.mark.parametrize("stamps", ["none", "all", "some"])
def test_vectorized_source_emits_the_reference_batches(stamps):
    rng = np.random.default_rng(8)
    vals = [(int(k), float(v)) for k, v in zip(rng.integers(0, 9, 50),
                                               rng.random(50))]
    ts = {"none": None, "all": list(range(50)),
          "some": [t if t % 3 else None for t in range(50)]}[stamps]
    got = tcol.batch_from_records(vals, ts)
    want = jcol.batch_from_records(vals, ts)
    _same_batches([got], [want])

    class _Ctx:
        def __init__(self):
            self.out = []

        def collect_batch(self, batch):
            self.out.append(batch)

    items = vals if ts is None else list(zip(vals, ts))
    timestamped = ts is not None
    p_src = tcol.VectorizedCollectionSource(items, timestamped=timestamped, chunk=16)
    j_src = jcol.VectorizedCollectionSource(items, timestamped=timestamped, chunk=16)
    p_ctx, j_ctx = _Ctx(), _Ctx()
    while p_src.emit_step(p_ctx, 1):
        pass
    while j_src.emit_step(j_ctx, 1):
        pass
    assert len(p_ctx.out) == 4
    _same_batches(p_ctx.out, j_ctx.out)
    # from ready columns, the same batches
    b_src = tcol.VectorizedCollectionSource.from_batch(got, chunk=16)
    b_ctx = _Ctx()
    while b_src.emit_step(b_ctx, 1):
        pass
    _same_batches(b_ctx.out, j_ctx.out)


def test_batch_from_arrays_matches_the_reference():
    a, b = np.arange(5), np.linspace(0, 1, 5)
    ts = np.arange(5, dtype=np.int64)
    for args in (((a, b),), (a,), ([a, b], ts)):
        _same_batches([tcol.batch_from_arrays(*args)],
                      [jcol.batch_from_arrays(*args)])


def test_vectorized_source_rejects_rows_that_do_not_fit_columns():
    with pytest.raises(TypeError):
        tcol.VectorizedCollectionSource([1, "a"])


# ---------------------------------------------------------------------
# the partitioners' batch split

_SELECTORS = [
    ("field", 0, 0),
    ("lambda", lambda t: t[0], lambda t: t[0]),
    ("string", lambda t: str(t[0]), lambda t: str(t[0])),
    ("tuple", lambda t: (t[0], t[0] % 3), lambda t: (t[0], t[0] % 3)),
]


@pytest.mark.parametrize("nch", [1, 3, 4, 128])
@pytest.mark.parametrize("sel", range(len(_SELECTORS)))
def test_key_group_split_matches_the_reference(sel, nch):
    _name, p_sel, j_sel = _SELECTORS[sel]
    rng = np.random.default_rng(12)
    n = 700
    cols = {"f0": rng.integers(-10**6, 10**6, n).astype(np.int64),
            "f1": rng.random(n)}
    ts = rng.integers(0, 1000, n).astype(np.int64)
    p = tpart.KeyGroupStreamPartitioner(tfn.as_key_selector(p_sel), 128)
    j = jpart.KeyGroupStreamPartitioner(jfn.as_key_selector(j_sel), 128)
    for _ in range(2):     # the first split probes the vectorized selector
        got = p.split_batch(TBatch(dict(cols), ts.copy()), nch)
        want = j.split_batch(JBatch(dict(cols), ts.copy()), nch)
        assert [c for c, _ in got] == [c for c, _ in want]
        _same_batches([b for _, b in got], [b for _, b in want])
    assert p._key_kernel == j._key_kernel
    # per record: the same channel as the batch split
    for c, sub in got:
        for value in sub.row_values():
            assert p.select_channels(value, nch) == [c]
            assert j.select_channels(value, nch) == [c]


def test_split_takes_precomputed_routing_hashes():
    from flink_tpu_torch.core.keygroups import splitmix64_np
    rng = np.random.default_rng(2)
    keys = rng.integers(0, 1000, 400).astype(np.int64)
    cols = {"f0": keys, "f1": np.arange(400, dtype=np.int64)}
    p = tpart.KeyGroupStreamPartitioner(tfn.as_key_selector(0), 128)
    plain = p.split_batch(TBatch(dict(cols)), 4)
    # hashes of other keys: the split follows them, not the column
    other = splitmix64_np(keys + 1)
    routed = p.split_batch(TBatch(dict(cols), routing=other), 4)
    j = jpart.KeyGroupStreamPartitioner(jfn.as_key_selector(0), 128)
    want = j.split_batch(JBatch(dict(cols), routing=other), 4)
    _same_batches([b for _, b in routed], [b for _, b in want])
    assert [c for c, _ in routed] == [c for c, _ in want]
    assert any(not np.array_equal(a.cols["f1"], b.cols["f1"])
               for (_, a), (_, b) in zip(plain, routed))


def test_forward_and_rebalance_split_whole_batches():
    batch = TBatch({"v": np.arange(10)})
    assert tpart.ForwardPartitioner().split_batch(batch, 1) == [(0, batch)]
    random.seed(3)
    p = tpart.RebalancePartitioner()
    p.setup(3)
    random.seed(3)
    j = jpart.RebalancePartitioner()
    j.setup(3)
    jb = JBatch({"v": np.arange(10)})
    assert [p.split_batch(batch, 3)[0][0] for _ in range(5)] == \
        [j.split_batch(jb, 3)[0][0] for _ in range(5)]
    assert [p.select_channels(1, 3) for _ in range(4)] == \
        [j.select_channels(1, 3) for _ in range(4)]


def test_columnar_collect_sink_matches_the_reference():
    rng = np.random.default_rng(6)
    cols = [{"f0": rng.integers(0, 9, 20), "f1": rng.random(20)},
            {"f0": rng.integers(0, 9, 5), "f1": rng.random(5)}]
    p_sink, j_sink = tcol.ColumnarCollectSink(), jcol.ColumnarCollectSink()
    for c in cols:
        p_sink.invoke(TBatch(dict(c)))
        j_sink.invoke(JBatch(dict(c)))
    assert p_sink.total_rows() == j_sink.total_rows() == 25
    assert list(p_sink.rows()) == list(j_sink.rows())


def _udf_job(pkg):
    ds, src = (tds, tsrc) if pkg == "port" else (jds, jsrc)
    kw = {"device": "cpu"} if pkg == "port" else {}
    env = ds.StreamExecutionEnvironment.get_execution_environment(**kw)
    out = []
    (env.from_collection([(i % 5, i) for i in range(200)])
        .flat_map(lambda t: [t, (t[0], -t[1])] if t[1] % 3 else [])
        .map(lambda t: (t[0], t[1] * 2))
        .filter(lambda t: t[1] % 4 != 0)
        .add_sink(src.CollectSink(out)))
    env.execute("udfs")
    return out


def test_map_filter_flat_map_records_match_the_reference():
    got = _udf_job("port")
    assert len(got) > 100
    assert got == _udf_job("ref")
