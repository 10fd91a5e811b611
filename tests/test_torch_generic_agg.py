"""The port's generic window tier (``flink_tpu_torch/streaming/
generic_agg.py``) against the JAX package's, case for case of
tests/test_generic_agg.py: the same numpy inputs from a seed go through
both engines, and the emitted ``(key, result, start, end)`` lists, the
lift decision (``mode`` / ``decided_by`` / ``fallback_reason``) and the
late drops must be equal, not close: both sides fold on numpy in the
same order.  Engine snapshots taken mid-window cross the packages both
ways; ``analyze_aggregate`` gives the reference's verdicts."""

import logging

import numpy as np
import pytest

from flink_tpu.analysis import liftability as jlift
from flink_tpu.core import keygroups as jkg
from flink_tpu.core.functions import AggregateFunction as JaxAgg
from flink_tpu.streaming import generic_agg as jga
from flink_tpu.streaming import windowing as jw
from flink_tpu_torch.analysis import liftability as tlift
from flink_tpu_torch.core import keygroups as tkg
from flink_tpu_torch.core.functions import AggregateFunction as TorchAgg
from flink_tpu_torch.streaming import generic_agg as tga
from flink_tpu_torch.streaming import windowing as tw
from flink_tpu_torch.streaming.elements import Watermark
from flink_tpu_torch.streaming.harness import OneInputStreamOperatorTestHarness


class _MeanMax:
    """Liftable: tuple accumulator, pure arithmetic add."""

    def create_accumulator(self):
        return (0.0, 0.0, -np.inf)

    def add(self, v, acc):
        s, c, m = acc
        return (s + v, c + 1.0, np.maximum(m, v))

    def get_result(self, acc):
        s, c, m = acc
        return (s / c, float(m))

    def merge(self, a, b):
        return (a[0] + b[0], a[1] + b[1], np.maximum(a[2], b[2]))


class _Branchy:
    """Branches on element values: fails the lift, scalar fold."""

    def create_accumulator(self):
        return (0.0, 0)

    def add(self, v, acc):
        s, c = acc
        if v > 0.5:
            return (s + v * 2, c + 1)
        return (s + v, c + 1)

    def get_result(self, acc):
        return acc[0] / max(acc[1], 1)

    def merge(self, a, b):
        return (a[0] + b[0], a[1] + b[1])


class _TupleValueAgg:
    """Sums the second field of a (key, x) element."""

    def create_accumulator(self):
        return 0.0

    def add(self, v, acc):
        return acc + v[1]

    def get_result(self, acc):
        return acc

    def merge(self, a, b):
        return a + b


class _WeirdResult:
    """The fold lifts; get_result branches and does not."""

    def create_accumulator(self):
        return 0.0

    def add(self, v, acc):
        return acc + v

    def get_result(self, acc):
        return float(acc) if acc > 1 else -1.0

    def merge(self, a, b):
        return a + b


class _Disagreeing:
    """max() collapses a column to one scalar: the probe's lifted fold
    disagrees with the scalar reference."""

    force_probe = True

    def create_accumulator(self):
        return 0.0

    def add(self, v, acc):
        return max(acc, v)

    def get_result(self, acc):
        return acc

    def merge(self, a, b):
        return max(a, b)


class _Impure:
    """Writes to the instance from add."""

    def create_accumulator(self):
        return 0.0

    def add(self, v, acc):
        self.seen = v
        return acc + v

    def get_result(self, acc):
        return acc

    def merge(self, a, b):
        return a + b


class _ListAcc:
    """A list accumulator that is not numeric: scalar only."""

    def create_accumulator(self):
        return []

    def add(self, v, acc):
        return acc + [v]

    def get_result(self, acc):
        return len(acc)

    def merge(self, a, b):
        return a + b


class _PinnedMeanMax(_MeanMax):
    force_scalar = True


class _ProbeMeanMax(_MeanMax):
    force_probe = True


MIXINS = {"MeanMax": _MeanMax, "Branchy": _Branchy,
          "TupleValueAgg": _TupleValueAgg, "WeirdResult": _WeirdResult,
          "Disagreeing": _Disagreeing, "Impure": _Impure,
          "ListAcc": _ListAcc, "PinnedMeanMax": _PinnedMeanMax,
          "ProbeMeanMax": _ProbeMeanMax}
CLASSES = {pkg: {name: type(name, (mixin, base), {})
                 for name, mixin in MIXINS.items()}
           for pkg, base in (("jax", JaxAgg), ("torch", TorchAgg))}
GA = {"jax": jga, "torch": tga}


def _stream(n=6000, keys=97, span=5000, seed=3):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, keys, n).astype(np.int64)
    t = np.sort(rng.integers(0, span, n).astype(np.int64))
    v = rng.random(n)
    return k, t, v


def _lift_of(eng):
    return (eng.lift.mode, eng.lift.decided_by, eng.lift.fallback_reason,
            eng.lift.result_lifted)


def _both(run):
    """run(package name) -> engine, for both packages; the engines'
    emissions, lift decisions and late drops must be equal."""
    j, t = run("jax"), run("torch")
    assert t.emitted == j.emitted
    assert _lift_of(t) == _lift_of(j)
    assert t.num_late_dropped == j.num_late_dropped
    return j, t


def _scalar_reference(keys, ts, vals, agg, size):
    st = {}
    for k, t, v in zip(keys.tolist(), ts.tolist(), vals.tolist()):
        w = t - t % size
        acc = st.get((w, k))
        if acc is None:
            acc = agg.create_accumulator()
        st[(w, k)] = agg.add(v, acc)
    return {(w, k): agg.get_result(a) for (w, k), a in st.items()}


def _assert_matches_scalar(emitted, want):
    got = {(s, k): r for k, r, s, e in emitted}
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(np.asarray(got[key], float),
                                   np.asarray(want[key], float), rtol=1e-9)


@pytest.mark.parametrize("agg,mode", [("MeanMax", "lifted"),
                                      ("Branchy", "scalar"),
                                      ("PinnedMeanMax", "scalar")])
def test_tumbling_equals_reference(agg, mode):
    keys, ts, vals = _stream()

    def run(pkg):
        eng = GA[pkg].GenericLogTumblingWindows(CLASSES[pkg][agg](), 1000,
                                                compact_threshold=2048)
        for i in range(0, len(keys), 1500):
            eng.process_batch(keys[i:i + 1500], ts[i:i + 1500],
                              vals[i:i + 1500])
        eng.advance_watermark(10_000)
        return eng

    _, t = _both(run)
    assert t.mode == mode
    if agg == "PinnedMeanMax":
        assert (t.lift.decided_by, t.lift.fallback_reason) == ("pin",
                                                               "force_scalar")
    _assert_matches_scalar(t.emitted, _scalar_reference(
        keys, ts, vals, CLASSES["torch"][agg](), 1000))


def test_operator_force_scalar_pins_the_engine():
    for pkg, w in (("jax", jw), ("torch", tw)):
        op = GA[pkg].GenericWindowOperator(w.TumblingEventTimeWindows.of(1000),
                                           CLASSES[pkg]["MeanMax"](),
                                           force_scalar=True)
        op._ensure_engine()
        assert _lift_of(op.engine) == ("scalar", "pin", "force_scalar", False)


@pytest.mark.parametrize("agg", ["MeanMax", "Branchy"])
def test_sliding_equals_reference(agg):
    keys, ts, vals = _stream()

    def run(pkg):
        eng = GA[pkg].GenericLogSlidingWindows(CLASSES[pkg][agg](), 2000, 1000)
        for i in range(0, len(keys), 1500):
            eng.process_batch(keys[i:i + 1500], ts[i:i + 1500],
                              vals[i:i + 1500])
            eng.advance_watermark(int(ts[min(i + 1499, len(ts) - 1)]) - 1)
        eng.advance_watermark(20_000)
        return eng

    _, t = _both(run)
    agg_t = CLASSES["torch"][agg]()
    st = {}
    for k, tt, v in zip(keys.tolist(), ts.tolist(), vals.tolist()):
        pane = tt - tt % 1000
        for w in (pane - 1000, pane):
            st[(w, k)] = agg_t.add(v, st.get((w, k)) or agg_t.create_accumulator())
    _assert_matches_scalar(t.emitted, {key: agg_t.get_result(a)
                                       for key, a in st.items()})


@pytest.mark.parametrize("agg", ["MeanMax", "Branchy"])
def test_session_equals_reference(agg):
    rng = np.random.default_rng(5)
    n, gap = 4000, 300
    keys = rng.integers(0, 37, n).astype(np.int64)
    ts = np.sort(rng.integers(0, 50_000, n).astype(np.int64))
    vals = rng.random(n)

    def run(pkg):
        eng = GA[pkg].GenericLogSessionWindows(CLASSES[pkg][agg](), gap)
        for i in range(0, n, 900):
            eng.process_batch(keys[i:i + 900], ts[i:i + 900], vals[i:i + 900])
            eng.advance_watermark(int(ts[min(i + 899, n - 1)]) - 1)
        eng.advance_watermark(100_000)
        return eng

    _, t = _both(run)
    assert len({(k, s) for k, _, s, _ in t.emitted}) > 1000


def test_string_keys():
    words = np.array(["ant", "bee", "cat", "ant", "bee", "ant"])
    ts = np.array([10, 20, 30, 40, 50, 60], np.int64)
    vals = np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])

    def run(pkg):
        eng = GA[pkg].GenericLogTumblingWindows(CLASSES[pkg]["MeanMax"](), 1000)
        eng.process_batch(words, ts, vals)
        eng.advance_watermark(2000)
        return eng

    _, t = _both(run)
    got = {k: r for k, r, s, e in t.emitted}
    assert set(got) == {"ant", "bee", "cat"}
    assert got["ant"][0] == (1 + 4 + 6) / 3 and got["bee"][1] == 5.0


def test_late_records_dropped():
    def run(pkg):
        eng = GA[pkg].GenericLogTumblingWindows(CLASSES[pkg]["MeanMax"](), 1000)
        eng.process_batch(np.array([1, 2]), np.array([100, 200], np.int64),
                          np.array([1.0, 2.0]))
        eng.advance_watermark(999)
        eng.process_batch(np.array([1]), np.array([500], np.int64),
                          np.array([9.0]))
        eng.advance_watermark(1999)
        return eng

    _, t = _both(run)
    assert t.num_late_dropped == 1 and len(t.emitted) == 2


# the three late-session cases: (batches, watermarks between them,
# expected (key, start, end) list, late drops)
LATE_SESSIONS = {
    "revives": ([([1, 1], [100, 108], [1.0, 2.0]), ([1], [95], [9.0])],
                [105], [(1, 95, 118)], 0),
    "transitive": ([([1], [110], [1.0]), ([1, 1], [92, 101], [2.0, 3.0])],
                   [112], [(1, 92, 120)], 0),
    "no_open_session": ([([1], [100], [1.0]), ([1], [80], [5.0]),
                         ([2], [95], [5.0])],
                        [105, 105], [(1, 100, 110)], 2),
}


@pytest.mark.parametrize("case", sorted(LATE_SESSIONS))
def test_session_late_records(case):
    batches, marks, want, dropped = LATE_SESSIONS[case]

    def run(pkg):
        eng = GA[pkg].GenericLogSessionWindows(CLASSES[pkg]["MeanMax"](), 10)
        for i, (k, t, v) in enumerate(batches):
            eng.process_batch(np.array(k), np.array(t, np.int64), np.array(v))
            if i < len(marks):
                eng.advance_watermark(marks[i])
        eng.advance_watermark(300)
        return eng

    _, t = _both(run)
    assert [(k, s, e) for k, _, s, e in t.emitted] == want
    assert t.num_late_dropped == dropped


@pytest.mark.parametrize("kind", ["tumbling", "sliding", "session"])
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_snapshot_mid_window_crosses_packages(kind, direction):
    """A mid-window engine snapshot of one package restores into the
    other's engine, and both keep folding to the output of the run
    that was never interrupted."""
    keys, ts, vals = _stream(n=3000)
    src, dst = direction.split("_to_")

    def make(pkg):
        agg = CLASSES[pkg]["MeanMax"]()
        if kind == "tumbling":
            return GA[pkg].GenericLogTumblingWindows(agg, 1000,
                                                     compact_threshold=512)
        if kind == "sliding":
            return GA[pkg].GenericLogSlidingWindows(agg, 2000, 1000,
                                                    compact_threshold=512)
        return GA[pkg].GenericLogSessionWindows(agg, 40, compact_threshold=512)

    whole = make(src)
    whole.process_batch(keys, ts, vals)
    whole.advance_watermark(20_000)

    first = make(src)
    first.process_batch(keys[:1500], ts[:1500], vals[:1500])
    first.advance_watermark(int(ts[1499]) - 1)
    head = list(first.emitted)
    restored = make(dst)
    restored.restore(first.snapshot())
    assert _lift_of(restored) == _lift_of(first)
    for eng in (first, restored):
        eng.process_batch(keys[1500:], ts[1500:], vals[1500:])
        eng.advance_watermark(20_000)
    assert restored.emitted == first.emitted[len(head):]
    got = {(k, s): r for k, r, s, _ in head + restored.emitted}
    want = {(k, s): r for k, r, s, _ in whole.emitted}
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-12)


@pytest.mark.parametrize("agg", ["MeanMax", "Branchy"])
def test_restore_many_rescale_filters_keys(agg):
    keys, ts, vals = _stream(n=2000)
    # the two packages' ownership filters agree key for key
    for idx in (0, 1):
        kj = jkg.make_key_group_keep_fn(128, 2, idx)(keys)
        kt = tkg.make_key_group_keep_fn(128, 2, idx)(keys)
        assert np.array_equal(kj, kt) and 0 < kt.sum() < len(keys)
    assert tkg.make_key_group_keep_fn(128, 1, 0) is None
    snap = {}
    for pkg in ("jax", "torch"):
        eng = GA[pkg].GenericLogTumblingWindows(CLASSES[pkg][agg](), 1000)
        eng.process_batch(keys, ts, vals)
        snap[pkg] = eng.snapshot()
    for idx in (0, 1):
        def run(pkg):
            part = GA[pkg].GenericLogTumblingWindows(CLASSES[pkg][agg](), 1000)
            # each package restores the OTHER package's snapshot
            other = "torch" if pkg == "jax" else "jax"
            keep = (jkg if pkg == "jax" else tkg).make_key_group_keep_fn(
                128, 2, idx)
            part.restore_many([snap[other]], keep)
            part.advance_watermark(10_000)
            return part
        _both(run)


def test_restore_many_mixed_modes_demote():
    """Subtasks that decided differently restore on the common
    denominator: object rows, scalar folds."""
    keys, ts, vals = _stream(n=1200)
    snaps = {}
    for pkg in ("jax", "torch"):
        lifted = GA[pkg].GenericLogTumblingWindows(CLASSES[pkg]["MeanMax"](), 1000)
        lifted.process_batch(keys[:600], ts[:600], vals[:600])
        pinned = GA[pkg].GenericLogTumblingWindows(
            CLASSES[pkg]["PinnedMeanMax"](), 1000)
        pinned.process_batch(keys[600:], ts[600:], vals[600:])
        snaps[pkg] = [lifted.snapshot(), pinned.snapshot()]

    def run(pkg):
        eng = GA[pkg].GenericLogTumblingWindows(CLASSES[pkg]["MeanMax"](), 1000)
        eng.restore_many(snaps[pkg])
        eng.advance_watermark(10_000)
        return eng

    _, t = _both(run)
    assert t.mode == "scalar" and t.lift.decided_by == "restore"


def test_columnify_shapes():
    for rows in ([1.0, 2.0, 3.0], [(1, "a"), (2, "b")], [[1, 2], [3, 4]],
                 [{"a": 1}, {"b": 2}], [(1, [2]), (3, [4])], ["x", "y"]):
        jc, js = jga.columnify(rows)
        tc, ts_ = tga.columnify(rows)
        assert js == ts_
        assert (jc is None) == (tc is None)
        if tc is not None:
            assert all(np.array_equal(a, b) and a.dtype == b.dtype
                       for a, b in zip(jc, tc))


def test_lift_probe_result_demotion():
    keys, ts, vals = _stream(n=800, keys=11)

    def run(pkg):
        eng = GA[pkg].GenericLogTumblingWindows(CLASSES[pkg]["WeirdResult"](), 1000)
        eng.process_batch(keys, ts, vals)
        eng.advance_watermark(10_000)
        return eng

    _, t = _both(run)
    assert t.mode == "lifted" and not t.lift.result_lifted


def test_sliding_idle_gap():
    week = 7 * 24 * 3600 * 1000

    def run(pkg):
        eng = GA[pkg].GenericLogSlidingWindows(CLASSES[pkg]["MeanMax"](), 30, 10)
        eng.process_batch(np.array([1, 2]), np.array([5, 15], np.int64),
                          np.array([1.0, 2.0]))
        eng.advance_watermark(week)
        eng.process_batch(np.array([3]), np.array([week + 25], np.int64),
                          np.array([9.0]))
        eng.advance_watermark(week + 100)
        return eng

    _, t = _both(run)
    assert {(s, k) for k, _, s, _ in t.emitted[:6]} == {
        (-20, 1), (-10, 1), (0, 1), (-10, 2), (0, 2), (10, 2)}
    assert len(t.emitted) == 9


def _report(r):
    return (r.verdict, r.result_liftable, r.reasons,
            [(u.verdict, u.reasons) for u in (r.add, r.merge, r.get_result)])


@pytest.mark.parametrize("agg", sorted(MIXINS))
def test_static_verdict_zoo(agg):
    t = tlift.analyze_aggregate(CLASSES["torch"][agg]())
    j = jlift.analyze_aggregate(CLASSES["jax"][agg]())
    assert _report(t) == _report(j)
    want = {"MeanMax": ("LIFTABLE", False), "Branchy": ("SCALAR_ONLY", False),
            "TupleValueAgg": ("LIFTABLE", True), "Impure": ("IMPURE", False),
            "ListAcc": ("SCALAR_ONLY", False)}.get(agg)
    if want is not None:
        assert (t.verdict, t.result_liftable) == want


def test_returns_unhashable_equals_reference():
    fns = [lambda x: [x], lambda x: (x, 1), lambda x: {x: 1}, lambda x: {x},
           lambda x: x + 1]
    assert [tlift.returns_unhashable(f) for f in fns] == \
        [jlift.returns_unhashable(f) for f in fns] == \
        ["list", None, "dict", "set", None]


def _probe_mode(pkg, agg):
    keys, ts, vals = _stream(n=400, keys=7)
    eng = GA[pkg].GenericLogTumblingWindows(CLASSES[pkg][agg](), 1000)
    eng.process_batch(keys, ts, vals)
    eng.advance_watermark(10_000)
    return eng.mode, eng.lift.result_lifted


@pytest.mark.parametrize("agg", ["MeanMax", "Branchy", "WeirdResult"])
def test_static_verdict_consistent_with_probe(agg):
    report = tlift.analyze_aggregate(CLASSES["torch"][agg]())
    mode, result_lifted = _probe_mode("torch", agg)
    assert (mode, result_lifted) == _probe_mode("jax", agg)
    if mode == "lifted":
        assert report.verdict in ("LIFTABLE", "INCONCLUSIVE")
        if report.verdict == "LIFTABLE":
            assert not (report.result_liftable and not result_lifted)
    else:
        assert report.verdict != "LIFTABLE"


def test_static_liftable_skips_probe():
    keys, ts, vals = _stream()
    calls = {}

    def run(pkg):
        agg = CLASSES[pkg]["MeanMax"]()
        lift = jlift if pkg == "jax" else tlift
        report = lift.analyze_aggregate(agg)
        seen = calls[pkg] = []
        orig = agg.create_accumulator
        agg.create_accumulator = lambda: (seen.append(1), orig())[1]
        eng = GA[pkg].GenericLogTumblingWindows(agg, 1000, compact_threshold=2048)
        eng.lift.apply_static(report)
        for i in range(0, len(keys), 1500):
            eng.process_batch(keys[i:i + 1500], ts[i:i + 1500],
                              vals[i:i + 1500])
        eng.advance_watermark(10_000)
        return eng

    _, t = _both(run)
    assert t.lift.decided_by == "static" and not t.lift.result_lifted
    # one accumulator, the engine's own for the structure: the probe's
    # scalar replay would have made one a group
    assert calls["torch"] == calls["jax"] == [1]


def test_static_scalar_verdict_locks_without_probe():
    keys, ts, vals = _stream(n=500, keys=7)

    def run(pkg):
        agg = CLASSES[pkg]["Branchy"]()
        eng = GA[pkg].GenericLogTumblingWindows(agg, 1000)
        eng.lift.apply_static((jlift if pkg == "jax" else tlift)
                              .analyze_aggregate(agg))
        assert eng.mode == "scalar"
        eng.process_batch(keys, ts, vals)
        eng.advance_watermark(10_000)
        return eng

    _, t = _both(run)
    assert t.lift.decided_by == "static" and "branch" in t.lift.fallback_reason


@pytest.mark.parametrize("agg,static", [("MeanMax", True),
                                        ("ProbeMeanMax", False)])
def test_operator_applies_static_verdict(agg, static):
    for pkg, w in (("jax", jw), ("torch", tw)):
        op = GA[pkg].GenericWindowOperator(w.TumblingEventTimeWindows.of(1000),
                                           CLASSES[pkg][agg]())
        op._ensure_engine()
        assert op.engine.lift._static_lift is static
        assert op.engine.lift.mode is None


def test_decided_by_survives_snapshot_restore():
    keys, ts, vals = _stream(n=800, keys=11)
    src = jga.GenericLogTumblingWindows(CLASSES["jax"]["MeanMax"](), 1000)
    src.process_batch(keys, ts, vals)
    snap = src.snapshot()
    eng = tga.GenericLogTumblingWindows(CLASSES["torch"]["MeanMax"](), 1000)
    eng.restore(snap)
    assert (eng.mode, eng.lift.decided_by) == ("lifted", "probe")
    snap.pop("decided_by")
    eng = tga.GenericLogTumblingWindows(CLASSES["torch"]["MeanMax"](), 1000)
    eng.restore(snap)
    assert eng.lift.decided_by == "restore"


def test_scalar_fallback_warns_once(caplog):
    keys, ts, vals = _stream(n=300, keys=5)
    tga._FALLBACK_WARNED.clear()
    with caplog.at_level(logging.WARNING, logger="flink_tpu_torch.generic_agg"):
        engines = []
        for _ in range(2):
            eng = tga.GenericLogTumblingWindows(CLASSES["torch"]["Disagreeing"](),
                                                1000)
            eng.process_batch(keys, ts, vals)
            engines.append(eng)
    msgs = [r.message for r in caplog.records
            if r.name == "flink_tpu_torch.generic_agg" and "falls back" in r.message]
    assert len(msgs) == 1 and "Disagreeing" in msgs[0]
    ref = jga.GenericLogTumblingWindows(CLASSES["jax"]["Disagreeing"](), 1000)
    ref.process_batch(keys, ts, vals)
    assert _lift_of(engines[0]) == _lift_of(ref)
    assert engines[0].mode == "scalar"


def test_value_shape_change_demotes_to_object_rows():
    def run(pkg):
        eng = GA[pkg].GenericLogTumblingWindows(CLASSES[pkg]["TupleValueAgg"](),
                                                1000)
        eng.process_batch(np.array([1, 2]), np.array([10, 20], np.int64),
                          [(1, 2.0), (2, 3.0)])
        assert eng.mode == "lifted"
        eng.process_batch(np.array([1, 2]), np.array([30, 40], np.int64),
                          [(1, 5.0, "x"), (2, 7.0, "y")])
        assert eng.vspec is None
        eng.advance_watermark(2000)
        return eng

    _, t = _both(run)
    assert t.mode == "scalar"
    assert {k: r for k, r, _, _ in t.emitted} == {1: 7.0, 2: 10.0}


def _operator_run(pkg, events, n_subtasks=1, snap_at=None, restore=None,
                  subtask_index=0):
    """GenericWindowOperator through the package's test harness: rows,
    a watermark per 500 events; optionally a snapshot after ``snap_at``
    events, or a restore of ``restore`` first."""
    ga, w = (jga, jw) if pkg == "jax" else (tga, tw)
    op = ga.GenericWindowOperator(
        w.TumblingEventTimeWindows.of(1000), CLASSES[pkg]["TupleValueAgg"](),
        window_function=lambda k, win, vals: [(k, win.start, vals[0])],
        flush_batch=64)
    if pkg == "jax":
        from flink_tpu.streaming.harness import \
            OneInputStreamOperatorTestHarness as H
        h = H(op, key_selector=lambda v: v[0])
    else:
        h = OneInputStreamOperatorTestHarness(op, key_selector=lambda v: v[0])
    op.num_subtasks, op.subtask_index = n_subtasks, subtask_index
    h.open()
    if restore is not None:
        h.initialize_state(restore)
    snap = None
    for i, (v, t) in enumerate(events):
        if i == snap_at:
            snap = h.snapshot()
        h.process_element(v, t)
        if i % 500 == 499:
            h.process_watermark(t - 200)
    h.process_watermark(2 ** 62)
    return [(r.value, r.timestamp) for r in h.get_output()], snap, op


def test_operator_snapshot_crosses_packages_and_rescales():
    rng = np.random.default_rng(17)
    n = 3000
    ts = np.sort(rng.integers(0, 6000, n))
    events = [((int(k), float(x)), int(t)) for k, x, t in
              zip(rng.integers(0, 40, n), rng.random(n), ts)]
    out_j, snap_j, _ = _operator_run("jax", events, snap_at=1700)
    out_t, snap_t, op = _operator_run("torch", events, snap_at=1700)
    assert out_t == out_j and op.engine.mode == "lifted"
    tail = events[1700:]
    # the JAX operator's snapshot restored into the port and back
    got_t, _, _ = _operator_run("torch", tail, restore=snap_j)
    got_j, _, _ = _operator_run("jax", tail, restore=snap_t)
    assert got_t == got_j
    before = {v[:2] for v, _ in out_t}
    assert {v[:2] for v, _ in got_t} <= before
    # rescaled to two subtasks: each keeps the restored state of its
    # key groups and gets their records; together they emit what one
    # emits
    tail_keys = np.array([v[0] for v, _ in tail])
    parts = []
    for i in (0, 1):
        mine = tkg.make_key_group_keep_fn(128, 2, i)(tail_keys)
        parts.append(_operator_run(
            "torch", [e for e, m in zip(tail, mine) if m], n_subtasks=2,
            subtask_index=i, restore=snap_j)[0])
    assert sorted(parts[0] + parts[1], key=repr) == sorted(got_t, key=repr)
    assert parts[0] and parts[1]


def test_operator_watermark_between_boundaries_does_not_fire():
    events = [((1, 1.0), 10), ((1, 2.0), 20)]
    for pkg in ("jax", "torch"):
        out, _, _ = _operator_run(pkg, events)
        assert out == [((1, 0, 3.0), 999)]
    op = tga.GenericWindowOperator(tw.TumblingEventTimeWindows.of(1000),
                                   CLASSES["torch"]["TupleValueAgg"]())
    h = OneInputStreamOperatorTestHarness(op, key_selector=lambda v: v[0])
    h.open()
    h.process_element((1, 1.0), 10)
    h.process_watermark(500)              # flushes into the engine
    h.process_element((1, 2.0), 20)
    h.process_watermark(700)              # same fireable boundary: no flush
    assert len(op._keys) == 1 and op._last_fireable == 0
    h.process_watermark(Watermark(999))
    assert h.extract_output_values() == [3.0] and not op._keys


def test_operator_columnar_ingest_equals_reference():
    """RecordBatches into GenericWindowOperator (the positional key
    column read directly) against the JAX package's operator, and
    against the same rows pushed one by one."""
    from flink_tpu.streaming import elements as jel
    from flink_tpu.streaming.harness import OneInputStreamOperatorTestHarness as JH
    from flink_tpu_torch.streaming import elements as tel
    rng = np.random.default_rng(19)
    n = 4000
    keys = rng.integers(0, 60, n)
    vals = rng.random(n)
    ts = np.sort(rng.integers(0, 5000, n))
    outs = {}
    for pkg, ga, w, el, harness in (("jax", jga, jw, jel, JH),
                                    ("torch", tga, tw, tel,
                                     OneInputStreamOperatorTestHarness)):
        for ingest in ("batch", "row"):
            op = ga.GenericWindowOperator(
                w.TumblingEventTimeWindows.of(1000), CLASSES[pkg]["TupleValueAgg"](),
                window_function=lambda k, win, r: [(k, win.start, r[0])])
            h = harness(op, key_selector=0)
            h.open()
            for i in range(0, n, 1000):
                batch = el.RecordBatch({"f0": keys[i:i + 1000],
                                        "f1": vals[i:i + 1000]}, ts=ts[i:i + 1000])
                if ingest == "batch":
                    h.process_batch(batch)
                else:
                    for r in batch.to_records():
                        h.process_element(r)
                h.process_watermark(int(ts[min(i + 999, n - 1)]) - 300)
            h.process_watermark(2 ** 62)
            outs[pkg, ingest] = [(r.value, r.timestamp) for r in h.get_output()]
            if ingest == "batch":
                assert op.columnar_rows == n
    assert outs["torch", "batch"] == outs["jax", "batch"] == outs["jax", "row"]
    assert sorted(outs["torch", "row"]) == sorted(outs["torch", "batch"])
    assert len(outs["torch", "batch"]) > 200
