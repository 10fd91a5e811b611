"""The port's fused chain program (flink_tpu_torch/streaming/chain_fusion.py,
the UDF stages on tensors and the chain_route kernel's plain version on
the CPU) against three references on the same numpy inputs:

- the port's own per-operator path (StreamMap -> StreamFilter ->
  split_batch / WindowOperator.process_batch);
- the reference's FusedChainProgram._numpy_twin;
- the reference program itself, ``prog._device_fn(mode, scalar, False)``
  run under ``jax.enable_x64(True)`` (the reference's own dispatch
  cannot run it on the installed jax: its ``_execute`` imports
  ``jax.experimental.enable_x64``).

Every comparison is exact (NaN-aware for floats): columns, dtypes,
timestamps, timestamp masks, channel bounds and pane starts.  A
demotion must give the per-operator output.
"""

import jax
import numpy as np
import pytest
import torch

from flink_tpu.core.functions import FilterFunction as JFilterFunction
from flink_tpu.core.functions import MapFunction as JMapFunction
from flink_tpu.core.functions import _FieldKeySelector as JField
from flink_tpu.streaming import chain_fusion as jcf
from flink_tpu.streaming.elements import RecordBatch as JBatch
from flink_tpu.streaming.operators import StreamFilter as JFilter
from flink_tpu.streaming.operators import StreamMap as JMap
from flink_tpu.streaming.partitioners import KeyGroupStreamPartitioner as JKeyGroup
from flink_tpu_torch.core.functions import FilterFunction, MapFunction
from flink_tpu_torch.core.functions import _FieldKeySelector
from flink_tpu_torch.core.keygroups import (assign_operator_indexes_np,
                                            splitmix64_np)
from flink_tpu_torch.kernels import chain_route_plain
from flink_tpu_torch.streaming import chain_fusion as cf
from flink_tpu_torch.streaming.elements import RecordBatch
from flink_tpu_torch.streaming.operators import StreamFilter, StreamMap
from flink_tpu_torch.streaming.partitioners import KeyGroupStreamPartitioner


def _lmap(base):
    class _LMap(base):
        def __init__(self, fn):
            self._fn = fn

        def map(self, value):
            return self._fn(value)
    return _LMap


def _lfilter(base):
    class _LFilter(base):
        def __init__(self, fn):
            self._fn = fn

        def filter(self, value):
            return self._fn(value)
    return _LFilter


_TMap, _TFilter = _lmap(MapFunction), _lfilter(FilterFunction)
_JMap, _JFilter = _lmap(JMapFunction), _lfilter(JFilterFunction)


class _CapOut:
    def __init__(self):
        self.batches = []
        self.records = []

    def collect_batch(self, batch):
        self.batches.append(batch)

    def collect(self, record):
        self.records.append((record.value, record.timestamp))


class _ChainOut:
    def __init__(self, op):
        self.op = op

    def collect_batch(self, batch):
        self.op.process_batch(batch)

    def collect(self, record):
        self.op.process_element(record)


class _Ch:
    def __init__(self):
        self.got = []

    def push(self, element):
        self.got.append(element)


class _Router:
    """A chain tail with one key-group route, splitting batches as the
    executor's router does."""

    def __init__(self, part, nch):
        self.channels = [_Ch() for _ in range(nch)]
        self.routes = [(part, self.channels, None)]
        self.records_out_counter = None

    def flush_records(self):
        pass

    def collect_batch(self, batch):
        for part, channels, _tag in self.routes:
            for idx, sub in part.split_batch(batch, len(channels)):
                channels[idx].push(sub)


_MAP = lambda t: (t[0], t[1] * 3)            # noqa: E731
_FILTER = lambda t: (t[1] % 7) != 0          # noqa: E731


def _port_chain(out, map_fn=_MAP, filter_fn=_FILTER):
    m = StreamMap(_TMap(map_fn))
    f = StreamFilter(_TFilter(filter_fn))
    m.setup(_ChainOut(f), operator_id="map-1")
    f.setup(out, operator_id="filter-2")
    return m, f


def _ref_chain(out, map_fn=_MAP, filter_fn=_FILTER):
    m = JMap(_JMap(map_fn))
    f = JFilter(_JFilter(filter_fn))
    m.setup(_ChainOut(f), operator_id="map-1")
    f.setup(out, operator_id="filter-2")
    return m, f


@pytest.fixture(autouse=True)
def _fusion_env():
    saved = (cf.FUSION_ENABLED, cf.MIN_FUSED_ROWS, jcf.MIN_FUSED_ROWS)
    cf.FUSION_ENABLED = True
    cf.MIN_FUSED_ROWS = 256
    jcf.MIN_FUSED_ROWS = 256
    cf.FUSION_STATS.reset()
    yield
    cf.FUSION_ENABLED, cf.MIN_FUSED_ROWS, jcf.MIN_FUSED_ROWS = saved


def _eq(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(a, b, equal_nan=a.dtype.kind == "f"))


def _assert_batches_equal(got, ref):
    assert len(got) == len(ref)
    for gb, rb in zip(got, ref):
        assert list(gb.cols) == list(rb.cols)
        for k in rb.cols:
            assert _eq(gb.cols[k], rb.cols[k]), k
        assert _eq(gb.ts, rb.ts)
        assert _eq(gb.ts_mask, rb.ts_mask)


def _reference_program(jprog, cols, ts, tsm, mode):
    """The reference program's outputs, run as its ``_execute`` would
    (padded to its bucket), sliced to the kept rows: (cols, ts, tsm,
    count, bounds, pane)."""
    n = len(cols[0])
    bucket = max(jcf.MIN_FUSED_ROWS, 1 << (n - 1).bit_length())
    valid = np.zeros(bucket, bool)
    valid[:n] = True

    def pad(a, fill=0):
        if a is None:
            return None
        out = np.full(bucket, fill, a.dtype)
        out[:n] = a
        return out

    with jax.enable_x64(True):
        fn = jcf.FusedChainProgram._device_fn(jprog, mode, False, False)
        outs = fn(tuple(pad(a) for a in cols), pad(ts), pad(tsm, False), valid)
        host = jax.tree_util.tree_map(np.asarray, outs)
    out_cols, out_ts, out_tsm, _rows, count, bounds, _h, pane = host
    count = int(count)
    sl = lambda a: None if a is None else a[:count]   # noqa: E731
    return (tuple(sl(a) for a in out_cols), sl(out_ts), sl(out_tsm), count,
            None if bounds is None else np.asarray(bounds, np.int64), sl(pane))


def _fused_outputs(batches):
    """Emitted batches of a plain-mode run, joined."""
    if not batches:
        return None
    cat = lambda xs: None if xs[0] is None else np.concatenate(xs)  # noqa: E731
    keys = list(batches[0].cols)
    return (tuple(cat([b.cols[k] for b in batches]) for k in keys),
            cat([b.ts for b in batches]), cat([b.ts_mask for b in batches]))


# ---------------------------------------------------------------------
# plain mode: the reference's dtype zoo

_ZOO = [np.int8, np.int16, np.int32, np.int64, np.uint8, np.uint32,
        np.float32, np.float64, np.bool_]
#: dtypes whose UDF stages torch cannot run (ROADMAP queue 3)
_DEMOTES = {np.uint32: "remainder"}


@pytest.mark.parametrize("dtype", _ZOO, ids=lambda d: np.dtype(d).name)
def test_plain_dtype_zoo(dtype):
    rng = np.random.default_rng(3)
    n = 1024
    vals = (rng.random(n) * 50).astype(dtype)
    cols = {"f0": rng.integers(0, 9, n).astype(np.int64), "f1": vals}
    ts = rng.integers(0, 10_000, n).astype(np.int64)
    tsm = rng.random(n) > 0.2

    per_op = _CapOut()
    m1, f1 = _port_chain(per_op)
    m1.process_batch(RecordBatch(dict(cols), ts.copy(), tsm.copy()))

    fused = _CapOut()
    m2, f2 = _port_chain(fused)
    prog = cf.compile_chain([m2, f2], device="cpu")
    batch = RecordBatch(dict(cols), ts.copy(), tsm.copy())
    assert prog.wants(batch)
    prog.run(batch)
    _assert_batches_equal(fused.batches, per_op.batches)
    assert (m2.columnar_rows, f2.columnar_rows) == \
        (m1.columnar_rows, f1.columnar_rows)
    if dtype in _DEMOTES:
        assert not prog.active
        assert _DEMOTES[dtype] in prog.demoted_reason
        return
    assert prog.active, prog.demoted_reason
    assert m2.fused_rows == n and m2.columnar_decided_by == "fused"

    jm, jf = _ref_chain(_CapOut())
    jprog = jcf.compile_chain([jm, jf])
    jb = JBatch(dict(cols), ts.copy(), tsm.copy())
    twin = jprog._numpy_twin(jb, n, "plain")
    got_cols, got_ts, got_tsm = _fused_outputs(fused.batches)
    assert all(_eq(a, b) for a, b in zip(got_cols, twin[0]))
    assert _eq(got_ts, twin[1]) and _eq(got_tsm, twin[2])
    ref = _reference_program(jprog, tuple(cols.values()), ts, tsm, "plain")
    assert ref[3] == twin[3] == len(got_ts)
    assert all(_eq(a, b) for a, b in zip(got_cols, ref[0]))
    assert _eq(got_ts, ref[1]) and _eq(got_tsm, ref[2])


def test_small_batches_stay_per_operator():
    cols = {"f0": np.arange(64, dtype=np.int64),
            "f1": np.arange(64, dtype=np.int64)}
    out = _CapOut()
    m, f = _port_chain(out)
    prog = cf.compile_chain([m, f], device="cpu")
    assert prog is not None
    assert not prog.wants(RecordBatch(dict(cols)))
    assert prog.active
    assert cf.FUSION_STATS.small_batches == 1


def test_a_single_stage_does_not_fuse():
    m = StreamMap(_TMap(_MAP))
    m.setup(_CapOut())
    assert cf.compile_chain([m], device="cpu") is None


# ---------------------------------------------------------------------
# route mode: the key-group exchange against split_batch


@pytest.mark.parametrize("nch", [4, 128])
def test_route_mode_matches_split_batch(nch):
    rng = np.random.default_rng(7)
    n = 1500
    cols = {"f0": rng.integers(-200, 200, n).astype(np.int64),
            "f1": rng.integers(-50, 50, n).astype(np.int64)}
    ts = rng.integers(0, 10_000, n).astype(np.int64)

    ref_router = _Router(KeyGroupStreamPartitioner(_FieldKeySelector(0), 128), nch)
    m1, _ = _port_chain(ref_router)
    m1.process_batch(RecordBatch(dict(cols), ts.copy()))

    router = _Router(KeyGroupStreamPartitioner(_FieldKeySelector(0), 128), nch)
    m2, f2 = _port_chain(router)
    prog = cf.compile_chain([m2, f2], router=router, device="cpu")
    assert prog is not None and prog.route_field == 0
    prog.run(RecordBatch(dict(cols), ts.copy()))
    assert prog.active, prog.demoted_reason
    for c in range(nch):
        _assert_batches_equal(router.channels[c].got, ref_router.channels[c].got)
    assert sum(len(b) for ch in router.channels for b in ch.got) > 0

    # the reference's twin and program on the same batch
    jrouter = _Router(JKeyGroup(JField(0), 128), nch)
    jm, jf = _ref_chain(jrouter)
    jprog = jcf.compile_chain([jm, jf], router=jrouter)
    assert jprog.route_field == 0
    twin = jprog._numpy_twin(JBatch(dict(cols), ts.copy()), n, "route")
    ref = _reference_program(jprog, tuple(cols.values()), ts, None, "route")
    assert np.array_equal(twin[4], ref[4])
    for c in range(nch):
        lo, hi = int(ref[4][c]), int(ref[4][c + 1])
        got = router.channels[c].got
        if lo == hi:
            assert got == []
            continue
        (sub,) = got
        for j, k in enumerate(("f0", "f1")):
            assert _eq(sub.cols[k], ref[0][j][lo:hi])
            assert _eq(sub.cols[k], twin[0][j][lo:hi])
        assert _eq(sub.ts, ref[1][lo:hi]) and _eq(sub.ts, twin[1][lo:hi])


def test_route_mode_with_a_non_int64_key_demotes():
    rng = np.random.default_rng(9)
    n = 800
    cols = {"f0": rng.integers(0, 50, n).astype(np.int32),
            "f1": rng.integers(0, 50, n).astype(np.int64)}
    ref_router = _Router(KeyGroupStreamPartitioner(_FieldKeySelector(0), 128), 4)
    m1, _ = _port_chain(ref_router)
    m1.process_batch(RecordBatch(dict(cols)))
    router = _Router(KeyGroupStreamPartitioner(_FieldKeySelector(0), 128), 4)
    m2, f2 = _port_chain(router)
    prog = cf.compile_chain([m2, f2], router=router, device="cpu")
    prog.run(RecordBatch(dict(cols)))
    assert not prog.active and "int64" in prog.demoted_reason
    for c in range(4):
        _assert_batches_equal(router.channels[c].got, ref_router.channels[c].got)


# ---------------------------------------------------------------------
# window mode: pane starts, tumbling and sliding, negative timestamps


def _window_run(kind, fused, record_panes=None):
    from flink_tpu_torch.core.state import AggregatingStateDescriptor
    from flink_tpu_torch.ops.device_agg import SumAggregate
    from flink_tpu_torch.streaming.harness import OneInputStreamOperatorTestHarness
    from flink_tpu_torch.streaming.window_operator import WindowOperator
    from flink_tpu_torch.streaming.windowing import (SlidingEventTimeWindows,
                                                     TumblingEventTimeWindows)

    class _KVSum(SumAggregate):
        def __init__(self):
            super().__init__(np.float64)

        def extract_value(self, value):
            return value[1] if isinstance(value, tuple) else value

    def wfn(key, window, elements):
        for v in elements:
            yield (key, float(v), window.start)

    assigner = (TumblingEventTimeWindows.of(100, 30) if kind == "tumbling"
                else SlidingEventTimeWindows.of(200, 100, 30))
    wop = WindowOperator(assigner, AggregatingStateDescriptor("w-sum", _KVSum()),
                         window_function=wfn, allowed_lateness=0)
    h = OneInputStreamOperatorTestHarness(wop, key_selector=lambda x: x[0],
                                          state_backend="heap", device="cpu")
    h.open()
    m, f = _port_chain(_ChainOut(wop), map_fn=lambda t: (t[0], t[1] * 3.0))
    prog = None
    if fused:
        prog = cf.compile_chain([m, f, wop], device="cpu")
        assert prog is not None and prog.window_op is wop
        if record_panes is not None:
            inner = wop.process_batch_fused

            def spy(batch, last_start=None):
                record_panes.append((batch, last_start))
                inner(batch, last_start)
            wop.process_batch_fused = spy
    rng = np.random.default_rng(5)
    inputs = []
    for c in range(4):
        n = 800
        lo = c * 300 - 1500          # every chunk partly before t = 0
        batch_cols = {"f0": rng.integers(0, 7, n).astype(np.int64),
                      "f1": rng.integers(0, 50, n).astype(np.int64)}
        ts = rng.integers(lo, lo + 450, n).astype(np.int64)
        inputs.append((batch_cols, ts))
        batch = RecordBatch(dict(batch_cols), ts.copy())
        if fused and prog.wants(batch):
            prog.run(batch)
            assert prog.active, prog.demoted_reason
        else:
            m.process_batch(batch)
        h.process_watermark(lo - 200)
    h.process_watermark(10 ** 13)
    out = [(r.value, r.timestamp) for r in h.get_output()]
    return out, inputs, prog


@pytest.mark.parametrize("kind", ["tumbling", "sliding"])
def test_window_mode_pane_starts(kind):
    panes = []
    ref_out, _, _ = _window_run(kind, fused=False)
    got_out, inputs, prog = _window_run(kind, fused=True, record_panes=panes)
    assert ref_out
    assert got_out == ref_out
    assert len(panes) == len(inputs)
    assert cf.FUSION_STATS.fused_batches == len(inputs)

    # the reference's twin and program on the same batches
    from flink_tpu.streaming.window_operator import WindowOperator as JWindowOp
    from flink_tpu.streaming.windowing import (
        SlidingEventTimeWindows as JSliding, TumblingEventTimeWindows as JTumbling)
    from flink_tpu.core.state import AggregatingStateDescriptor as JDesc
    from flink_tpu.ops.device_agg import SumAggregate as JSum
    assigner = (JTumbling.of(100, 30) if kind == "tumbling"
                else JSliding.of(200, 100, 30))
    jwop = JWindowOp(assigner, JDesc("w-sum", JSum(np.float64)))
    jm, jf = _ref_chain(_ChainOut(jwop), map_fn=lambda t: (t[0], t[1] * 3.0))
    jprog = jcf.FusedChainProgram(
        operators=[jm, jf, jwop], start=0, kernel_ops=[jm, jf],
        stages=[jcf._kernel_stage(jm)[:2], jcf._kernel_stage(jf)[:2]],
        window_op=jwop, router=None, route_field=None, route_channels=None,
        route_part=None, tail_op=jwop)
    for (cols, ts), (batch, pane) in zip(inputs, panes):
        n = len(ts)
        twin = jprog._numpy_twin(JBatch(dict(cols), ts.copy()), n, "window")
        ref = _reference_program(jprog, tuple(cols.values()), ts, None, "window")
        assert (ts < 0).any() and _eq(pane, twin[6]) and _eq(pane, ref[5])
        assert _eq(batch.cols["f1"], twin[0][1]) and _eq(batch.cols["f1"], ref[0][1])
        assert _eq(batch.ts, twin[1]) and _eq(batch.ts, ref[1])


# ---------------------------------------------------------------------
# demotion: the whole chain, and the batch replayed per operator


def _demotion_case(map_fn, cols):
    per_op = _CapOut()
    m1, _ = _port_chain(per_op, map_fn=map_fn)
    m1.process_batch(RecordBatch(dict(cols)))
    out = _CapOut()
    m, f = _port_chain(out, map_fn=map_fn)
    prog = cf.compile_chain([m, f], device="cpu")
    assert prog is not None
    prog.run(RecordBatch(dict(cols)))
    assert not prog.active and prog.demoted_reason
    assert cf.FUSION_STATS.last_demotion == (prog.label, prog.demoted_reason)
    _assert_batches_equal(out.batches, per_op.batches)
    assert out.records == per_op.records
    assert out.batches or out.records
    assert m.fused_rows == 0 and m._fused_member is None
    assert m.columnar_decided_by != "fused"
    # the chain stays demoted; later batches go per operator
    assert not prog.wants(RecordBatch(dict(cols)))
    return prog


def test_probe_mismatch_demotes(monkeypatch):
    import importlib
    cr = importlib.import_module("flink_tpu_torch.kernels.chain_route")
    real = cr.chain_route

    def swapped(cols, *args, **kw):
        outs, pane, starts = real(cols, *args, **kw)
        return [o.flip(0) for o in outs], pane, starts
    monkeypatch.setattr(cr, "chain_route", swapped)
    cols = {"f0": np.arange(600, dtype=np.int64),
            "f1": np.arange(600, dtype=np.int64)}
    prog = _demotion_case(_MAP, cols)
    assert "probe mismatch" in prog.demoted_reason
    assert cf.FUSION_STATS.probes == 1


def test_numpy_ufunc_udf_demotes():
    """A LIFTABLE UDF that calls numpy gets host arrays (or, on the
    card, an error) from tensors: the program demotes, as the reference
    does on a tracer."""
    from flink_tpu_torch.analysis.liftability import LIFTABLE, analyze_udf
    fn = lambda t: (t[0], np.where(t[1] > 3, t[1], 0))   # noqa: E731
    assert analyze_udf(fn).verdict == LIFTABLE
    cols = {"f0": np.arange(600, dtype=np.int64),
            "f1": np.arange(600, dtype=np.int64) % 11}
    prog = _demotion_case(fn, cols)
    assert "device stage failed" in prog.demoted_reason


def test_object_column_demotes():
    cols = {"f0": np.array(["a", "b"] * 300, dtype=object),
            "f1": np.arange(600, dtype=np.int64)}
    prog = _demotion_case(_MAP, cols)
    assert "not device-representable" in prog.demoted_reason


@pytest.mark.parametrize("nch", [0, 4])
def test_kernel_failure_raises_out_of_run(monkeypatch, nch):
    """A failure of chain_route (a build or launch error on the card)
    is raised to the caller: the chain does not demote, nothing is
    emitted, and no host path runs the batch instead."""
    import importlib
    cr = importlib.import_module("flink_tpu_torch.kernels.chain_route")

    def broken(*args, **kw):
        raise RuntimeError("chain_route: launch failed")
    monkeypatch.setattr(cr, "chain_route", broken)
    out = _CapOut()
    m, f = _port_chain(out)
    router = _Router(KeyGroupStreamPartitioner(_FieldKeySelector(0), 128), nch)
    if nch:
        f.setup(router, operator_id="filter-2")
    prog = cf.compile_chain([m, f], router=router if nch else None,
                            device="cpu")
    assert prog is not None and (prog.route_field == 0) == bool(nch)
    cols = {"f0": np.arange(600, dtype=np.int64),
            "f1": np.arange(600, dtype=np.int64)}
    with pytest.raises(RuntimeError, match="launch failed"):
        prog.run(RecordBatch(dict(cols)))
    assert prog.active and prog.demoted_reason is None
    assert cf.FUSION_STATS.demotions == 0 and cf.FUSION_STATS.fused_batches == 0
    assert not out.batches and not out.records
    assert not any(ch.got for ch in router.channels)
    assert m.columnar_rows == 0 and m.fused_rows == 0


@pytest.mark.parametrize("nch", [2047, 2048])
def test_route_leg_within_the_kernels_channel_limit(nch):
    """The route leg is compiled only for a channel count the kernel
    takes (MAX_CLASSES - 1); beyond it the program runs plain mode and
    the router's split does the exchange, decided before any batch."""
    from flink_tpu_torch.kernels.chain_route import MAX_CLASSES
    assert MAX_CLASSES == 2048
    out = _CapOut()
    m, f = _port_chain(out)
    router = _Router(KeyGroupStreamPartitioner(_FieldKeySelector(0), 4096), nch)
    f.setup(router, operator_id="filter-2")
    prog = cf.compile_chain([m, f], router=router, device="cpu")
    assert prog is not None
    assert prog.route_field == (0 if nch < MAX_CLASSES else None)
    cols = {"f0": np.arange(3000, dtype=np.int64),
            "f1": np.arange(3000, dtype=np.int64)}
    prog.run(RecordBatch(dict(cols)))
    assert prog.active, prog.demoted_reason
    per_op = _Router(KeyGroupStreamPartitioner(_FieldKeySelector(0), 4096), nch)
    m1, f1 = _port_chain(out)
    f1.setup(per_op, operator_id="filter-2")
    m1.process_batch(RecordBatch(dict(cols)))
    for a, b in zip(router.channels, per_op.channels):
        _assert_batches_equal(a.got, b.got)


# ---------------------------------------------------------------------
# reports


def test_fusion_report_equals_the_reference():
    from flink_tpu.streaming.window_operator import WindowOperator as JWindowOp
    from flink_tpu.streaming.windowing import (EventTimeSessionWindows as JSession,
                                               TumblingEventTimeWindows as JTumbling)
    from flink_tpu.core.state import AggregatingStateDescriptor as JDesc
    from flink_tpu.ops.device_agg import SumAggregate as JSum
    from flink_tpu_torch.core.state import AggregatingStateDescriptor
    from flink_tpu_torch.ops.device_agg import SumAggregate
    from flink_tpu_torch.streaming.window_operator import WindowOperator
    from flink_tpu_torch.streaming.windowing import (EventTimeSessionWindows,
                                                     TumblingEventTimeWindows)

    class _Opaque:
        def map(self, value):
            return hash(repr(value))

    def port_ops():
        m, f = _port_chain(_CapOut())
        o = StreamMap(_Opaque())
        o.setup(_CapOut(), operator_id="opaque-3")
        w = WindowOperator(TumblingEventTimeWindows.of(100),
                           AggregatingStateDescriptor("s", SumAggregate(np.float64)))
        w.setup(_CapOut(), operator_id="window-4")
        s = WindowOperator(EventTimeSessionWindows.with_gap(10),
                           AggregatingStateDescriptor("s", SumAggregate(np.float64)))
        s.setup(_CapOut(), operator_id="session-5")
        return m, f, o, w, s

    def ref_ops():
        m, f = _ref_chain(_CapOut())
        o = JMap(_Opaque())
        o.setup(_CapOut(), operator_id="opaque-3")
        w = JWindowOp(JTumbling.of(100), JDesc("s", JSum(np.float64)))
        w.setup(_CapOut(), operator_id="window-4")
        s = JWindowOp(JSession.with_gap(10), JDesc("s", JSum(np.float64)))
        s.setup(_CapOut(), operator_id="session-5")
        return m, f, o, w, s

    shapes = [(0, 1), (0, 1, 2), (2, 0, 1), (0, 1, 3), (0, 1, 4), (2,), (4, 0),
              (0,), (1, 0, 2)]
    for shape in shapes:
        p, r = port_ops(), ref_ops()
        got = cf.fusion_report([p[i] for i in shape])
        want = jcf.fusion_report([r[i] for i in shape])
        assert got == want, shape
    assert cf.fusion_report(list(port_ops()[:2]))["fused_ops"] == ["map-1", "filter-2"]


# ---------------------------------------------------------------------
# the kernel's plain version


@pytest.mark.parametrize("mode", ["plain", "route4", "route128", "window"])
def test_chain_route_plain_is_a_stable_argsort(mode):
    rng = np.random.default_rng(21)
    n = 3000
    key = rng.integers(-2**62, 2**62, n)
    keep = rng.random(n) > 0.3
    ts = rng.integers(-5000, 5000, n)
    cols = [rng.integers(-100, 100, n).astype(np.int8),
            rng.integers(-1000, 1000, n).astype(np.int16),
            rng.random(n).astype(np.float32), rng.random(n),
            rng.random(n) > 0.5, key, ts]
    nch = {"route4": 4, "route128": 128}.get(mode, 0)
    if nch:
        idx = assign_operator_indexes_np(splitmix64_np(key), 128, nch)
        cls = np.where(keep, idx, nch)
    else:
        cls = np.where(keep, 0, 1)
    order = np.argsort(cls, kind="stable")
    count = int(keep.sum())
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))   # noqa: E731
    outs, pane, starts = chain_route_plain(
        [t(c) for c in cols], t(keep), t(key) if nch else None,
        num_channels=nch, max_parallelism=128 if nch else 0,
        ts=t(ts) if mode == "window" else None, pane_offset=37,
        slide=250 if mode == "window" else 0)
    assert np.array_equal(starts, np.searchsorted(cls[order],
                                                  np.arange((nch or 1) + 1)))
    assert starts[-1] == count
    for got, c in zip(outs, cols):
        assert _eq(got.numpy(), c[order[:count]])
    if mode == "window":
        kt = ts[order[:count]]
        assert (kt < 0).any()
        assert np.array_equal(pane.numpy(), kt - ((kt - 37) % 250))
    else:
        assert pane is None


# ---------------------------------------------------------------------
# the mesh leg: the program over row shards (chain_fusion.py:832-849)


@pytest.fixture
def mesh_leg(monkeypatch):
    """8 virtual shards and the per-shard row floor cut to 64 (as the
    reference's mesh cases cut it); records each chain_route call's
    row-shard arguments and class starts."""
    import importlib

    from flink_tpu_torch.parallel.mesh import virtual_devices
    monkeypatch.setattr(cf, "MESH_MIN_ROWS_PER_SHARD", 64)
    cr = importlib.import_module("flink_tpu_torch.kernels.chain_route")
    real = cr.chain_route
    calls = []

    def spy(*a, **kw):
        out = real(*a, **kw)
        calls.append((len(a[1]), kw.get("shard_rows", 0),
                      kw.get("n_shards", 0), out[2]))
        return out
    monkeypatch.setattr(cr, "chain_route", spy)
    with virtual_devices(8, "cpu"):
        yield calls


def _shard_view(call, nclass):
    """(per-shard counts, per-shard bounds) of a recorded call."""
    from torch_port_util import shard_bounds
    n, shard_rows, n_shards, starts = call
    assert shard_rows and n_shards == 8
    return shard_bounds(starts, n_shards, nclass)


def _reference_mesh_program(jprog, cols, ts, tsm, mode):
    """The reference's sharded program, run as its ``_execute`` would
    (padded to its bucket, 8 row shards): per-shard counts [S] and, in
    route mode, per-shard bounds [S, nch + 1]."""
    n = len(cols[0])
    bucket = max(jcf.MIN_FUSED_ROWS, 1 << (n - 1).bit_length())
    valid = np.zeros(bucket, bool)
    valid[:n] = True

    def pad(a, fill=0):
        if a is None:
            return None
        out = np.full(bucket, fill, a.dtype)
        out[:n] = a
        return out

    assert jprog.mesh_shards == 8
    with jax.enable_x64(True):
        fn = jcf.FusedChainProgram._device_fn(jprog, mode, False, True)
        outs = fn(tuple(pad(a) for a in cols), pad(ts), pad(tsm, False), valid)
        host = jax.tree_util.tree_map(np.asarray, outs)
    _c, _t, _m, _rows, counts, bounds, _h, _p = host
    return (np.asarray(counts).ravel(),
            None if bounds is None else np.asarray(bounds, np.int64))


@pytest.mark.parametrize("nch", [4, 128])
def test_mesh_leg_route_matches_split_batch_and_reference(mesh_leg, nch):
    rng = np.random.default_rng(17)
    n = 4096
    cols = {"f0": rng.integers(0, 100, n).astype(np.int64),
            "f1": rng.integers(-50, 50, n).astype(np.int64)}
    ts = rng.integers(0, 10_000, n).astype(np.int64)
    part = lambda: KeyGroupStreamPartitioner(_FieldKeySelector(0), 128)  # noqa: E731
    per_op = _Router(part(), nch)
    _port_chain(per_op)[0].process_batch(RecordBatch(dict(cols), ts.copy()))
    router = _Router(part(), nch)
    m, f = _port_chain(router)
    prog = cf.compile_chain([m, f], router=router, device="cpu")
    assert prog.route_field == 0 and prog.mesh_shards == 8
    prog.run(RecordBatch(dict(cols), ts.copy()))
    assert prog.active, prog.demoted_reason
    for c in range(nch):
        _assert_batches_equal(router.channels[c].got, per_op.channels[c].got)
    counts, bounds = _shard_view(mesh_leg[-1], nch + 1)

    jrouter = _Router(JKeyGroup(JField(0), 128), nch)
    jm, jf = _ref_chain(jrouter)
    jprog = jcf.compile_chain([jm, jf], router=jrouter)
    r_counts, r_bounds = _reference_mesh_program(
        jprog, tuple(cols.values()), ts, None, "route")
    assert np.array_equal(counts, r_counts)
    assert np.array_equal(bounds, r_bounds)


def test_mesh_leg_plain_matches_single_device_and_reference(mesh_leg):
    """5,000 rows: a bucket of 8,192, shards of 1,024 rows, the last
    three short or empty; validity masks travel with the rows."""
    rng = np.random.default_rng(11)
    n = 5000
    cols = {"f0": rng.integers(0, 100, n).astype(np.int64),
            "f1": rng.integers(-50, 50, n).astype(np.int64)}
    ts = rng.integers(0, 10_000, n).astype(np.int64)
    tsm = rng.random(n) > 0.1
    batch = lambda: RecordBatch(dict(cols), ts.copy(), tsm.copy())  # noqa: E731
    per_op = _CapOut()
    _port_chain(per_op)[0].process_batch(batch())
    fused = _CapOut()
    m, f = _port_chain(fused)
    prog = cf.compile_chain([m, f], device="cpu")
    prog.run(batch())
    assert prog.active, prog.demoted_reason
    _assert_batches_equal(fused.batches, per_op.batches)
    counts, _ = _shard_view(mesh_leg[-1], 2)
    assert mesh_leg[-1][1] == 1024

    single = _CapOut()
    cf.MESH_MIN_ROWS_PER_SHARD = 1 << 20      # the single-device program
    m2, f2 = _port_chain(single)
    prog2 = cf.compile_chain([m2, f2], device="cpu")
    prog2.run(batch())
    assert mesh_leg[-1][1] == 0
    _assert_batches_equal(fused.batches, single.batches)

    jm, jf = _ref_chain(_CapOut())
    jprog = jcf.compile_chain([jm, jf])
    r_counts, r_bounds = _reference_mesh_program(
        jprog, tuple(cols.values()), ts, tsm, "plain")
    assert r_bounds is None and np.array_equal(counts, r_counts)


@pytest.mark.parametrize("kind", ["tumbling", "sliding"])
def test_mesh_leg_window_mode(mesh_leg, kind):
    ref_out, _, _ = _window_run(kind, fused=False)
    got_out, inputs, prog = _window_run(kind, fused=True)
    assert got_out == ref_out and prog.mesh_shards == 8
    sharded = [c for c in mesh_leg if c[1]]
    assert len(sharded) == len(inputs)
    from flink_tpu.streaming.window_operator import WindowOperator as JWindowOp
    from flink_tpu.streaming.windowing import (
        SlidingEventTimeWindows as JSliding, TumblingEventTimeWindows as JTumbling)
    from flink_tpu.core.state import AggregatingStateDescriptor as JDesc
    from flink_tpu.ops.device_agg import SumAggregate as JSum
    assigner = (JTumbling.of(100, 30) if kind == "tumbling"
                else JSliding.of(200, 100, 30))
    jwop = JWindowOp(assigner, JDesc("w-sum", JSum(np.float64)))
    jm, jf = _ref_chain(_ChainOut(jwop), map_fn=lambda t: (t[0], t[1] * 3.0))
    jprog = jcf.FusedChainProgram(
        operators=[jm, jf, jwop], start=0, kernel_ops=[jm, jf],
        stages=[jcf._kernel_stage(jm)[:2], jcf._kernel_stage(jf)[:2]],
        window_op=jwop, router=None, route_field=None, route_channels=None,
        route_part=None, tail_op=jwop)
    for (cols, ts), call in zip(inputs, sharded):
        counts, _ = _shard_view(call, 2)
        r_counts, _ = _reference_mesh_program(
            jprog, tuple(cols.values()), ts, None, "window")
        assert np.array_equal(counts, r_counts)


def test_mesh_leg_beyond_the_class_limit_runs_one_block(mesh_leg):
    """8 shards x 301 classes exceed the kernel's 2048: the route takes
    the single-device program."""
    rng = np.random.default_rng(3)
    n = 4096
    cols = {"f0": rng.integers(0, 1000, n).astype(np.int64),
            "f1": rng.integers(-50, 50, n).astype(np.int64)}
    part = lambda: KeyGroupStreamPartitioner(_FieldKeySelector(0), 512)  # noqa: E731
    per_op = _Router(part(), 300)
    _port_chain(per_op)[0].process_batch(RecordBatch(dict(cols)))
    router = _Router(part(), 300)
    m, f = _port_chain(router)
    prog = cf.compile_chain([m, f], router=router, device="cpu")
    prog.run(RecordBatch(dict(cols)))
    assert prog.active and mesh_leg[-1][1] == 0
    for a, b in zip(router.channels, per_op.channels):
        _assert_batches_equal(a.got, b.got)


@pytest.mark.parametrize("mode", ["plain", "route4", "window"])
def test_chain_route_plain_row_shards_are_per_shard_argsorts(mode):
    """With row shards the plain version partitions each block on its
    own: shard s's kept rows of class c at starts[s * nclass + c]."""
    from torch_port_util import shard_bounds
    rng = np.random.default_rng(22)
    n, S, m = 3000, 8, 384
    key = rng.integers(-2**62, 2**62, n)
    keep = rng.random(n) > 0.3
    ts = rng.integers(-5000, 5000, n)
    nch = 4 if mode == "route4" else 0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))   # noqa: E731
    outs, pane, starts = chain_route_plain(
        [t(key), t(ts)], t(keep), t(key) if nch else None, num_channels=nch,
        max_parallelism=128 if nch else 0,
        ts=t(ts) if mode == "window" else None, pane_offset=37,
        slide=250 if mode == "window" else 0, shard_rows=m, n_shards=S)
    nclass = nch + 1 if nch else 2
    assert len(starts) == S * nclass
    counts, bounds = shard_bounds(starts, S, nclass)
    for s in range(S):
        sl = slice(s * m, min((s + 1) * m, n))
        k, kp = key[sl], keep[sl]
        cls = (np.where(kp, assign_operator_indexes_np(
            splitmix64_np(k), 128, nch), nch) if nch else np.where(kp, 0, 1))
        order = np.argsort(cls, kind="stable")
        assert np.array_equal(bounds[s], np.searchsorted(cls[order],
                                                         np.arange(nclass)))
        lo = int(starts[s * nclass])
        cnt = int(counts[s])
        assert cnt == kp.sum()
        assert np.array_equal(outs[0].numpy()[lo:lo + cnt], k[order[:cnt]])
        if mode == "window":
            kt = ts[sl][order[:cnt]]
            assert np.array_equal(pane.numpy()[lo:lo + cnt], kt - ((kt - 37) % 250))
