"""The port's WindowOperator against the JAX package's, driven through
each package's OneInputStreamOperatorTestHarness on the same numpy
chunks: tumbling, sliding and session windows, allowed lateness 0 and
700, row and RecordBatch ingest, per-timer and batched fires, timers
and keyed state across a snapshot (within the port and across the two
packages), late data to a side output.

Backends: the port's ``"gpu"`` (``device="cpu"``: device states in CPU
tensors, the kernels' plain versions) against JAX's ``"tpu"``, and
``"heap"`` against ``"heap"``.  Output records (values and timestamps,
in emission order) are equal for Sum/Count/Min/Max/Avg on integer
data; HLL (precision 8) registers are bit-equal and estimates within
``torch_port_util.assert_hll_close``.
"""

import numpy as np
import pytest

from flink_tpu.core.state import AggregatingStateDescriptor as JaxAggDesc
from flink_tpu.ops import device_agg as jda
from flink_tpu.ops.sketches import HyperLogLogAggregate as JaxHll
from flink_tpu.state.backend import KeyedStateSnapshot as JaxSnapshot
from flink_tpu.streaming import elements as jel
from flink_tpu.streaming import harness as jh
from flink_tpu.streaming import window_operator as jwo
from flink_tpu.streaming import windowing as jw
from flink_tpu.streaming.operators import OutputTag as JaxTag
from flink_tpu_torch.core.state import AggregatingStateDescriptor as TorchAggDesc
from flink_tpu_torch.ops import device_agg as tda
from flink_tpu_torch.ops.sketches import HyperLogLogAggregate as TorchHll
from flink_tpu_torch.state import snapshot_from_chunks
from flink_tpu_torch.streaming import elements as tel
from flink_tpu_torch.streaming import harness as th
from flink_tpu_torch.streaming import window_operator as two
from flink_tpu_torch.streaming import windowing as tw
from flink_tpu_torch.streaming.operators import OutputTag as TorchTag
from torch_port_util import assert_hll_close

P = 8
PKG = {
    "torch": dict(h=th, wo=two, w=tw, el=tel, desc=TorchAggDesc, da=tda,
                  hll=TorchHll, tag=TorchTag),
    "jax": dict(h=jh, wo=jwo, w=jw, el=jel, desc=JaxAggDesc, da=jda,
                hll=JaxHll, tag=JaxTag),
}
PAIRS = [(("torch", "gpu"), ("jax", "tpu")), (("torch", "heap"), ("jax", "heap"))]


def _assigner(w, kind):
    if kind == "tumbling":
        return w.TumblingEventTimeWindows.of(1000)
    if kind == "sliding":
        return w.SlidingEventTimeWindows.of(1500, 500)
    return w.EventTimeSessionWindows.with_gap(300)


def _agg(p, name):
    if name == "hll":
        agg = p["hll"](P)
    else:
        cls = {"sum": "SumAggregate", "count": "CountAggregate",
               "min": "MinAggregate", "max": "MaxAggregate",
               "avg": "AvgAggregate"}[name]
        args = (np.float32,) if name in ("sum", "min", "max") else ()
        agg = getattr(p["da"], cls)(*args)
    agg.extract_value = lambda v: v[1]
    return agg


def _window_fn(key, window, elements):
    for v in elements:
        yield (key, float(v), window.start, window.end)


def _harness(pkg, backend, kind, lateness, agg_name, batch_fires=True,
             late_tag=None):
    p = PKG[pkg]
    op = p["wo"].WindowOperator(
        _assigner(p["w"], kind), p["desc"]("win", _agg(p, agg_name)),
        window_function=_window_fn, allowed_lateness=lateness,
        late_data_tag=None if late_tag is None else p["tag"](late_tag))
    op.batch_fires = batch_fires
    kw = {"device": "cpu"} if pkg == "torch" and backend == "gpu" else {}
    h = p["h"].OneInputStreamOperatorTestHarness(
        op, key_selector=lambda x: x[0], state_backend=backend, **kw)
    h.open()
    return h


def _chunks(seed=7, n_chunks=6, n=50):
    rng = np.random.default_rng(seed)
    for c in range(n_chunks):
        keys = rng.integers(0, 5, n)
        vals = rng.integers(0, 100, n).astype(np.int64)
        ts = np.abs(rng.integers(c * 1000 - 500, c * 1000 + 2500, n).astype(np.int64))
        ts[::17] = 5                       # late once the watermark moves
        yield keys, vals, ts, c * 1000 + 800


def _feed(h, pkg, ingest, keys, vals, ts):
    batch = PKG[pkg]["el"].RecordBatch({"f0": keys, "f1": vals}, ts=ts)
    if ingest == "batch":
        h.process_batch(batch)
    else:
        for r in batch.to_records():
            h.process_element(r)


def _cross(snap, to_pkg):
    keyed = snap["keyed"]
    blobs, meta = dict(keyed.blobs()), keyed.meta
    keyed = (snapshot_from_chunks(blobs, meta) if to_pkg == "torch"
             else JaxSnapshot(blobs, meta))
    return {"keyed": keyed, "timers": snap["timers"]}


def _run(pkg, backend, kind, lateness, ingest, agg_name="sum",
         batch_fires=True, restore_into=None, late_tag=None):
    """Output records (value, timestamp) in emission order.  With
    ``restore_into=(pkg, backend)`` the run snapshots after the third
    chunk and finishes in a fresh harness of that package."""
    h = _harness(pkg, backend, kind, lateness, agg_name, batch_fires, late_tag)
    out = []
    for i, (keys, vals, ts, wm) in enumerate(_chunks()):
        _feed(h, pkg, ingest, keys, vals, ts)
        h.process_watermark(wm)
        if restore_into is not None and i == 2:
            assert h.operator.timer_service.num_event_time_timers() > 0
            out.extend((r.value, r.timestamp) for r in h.get_output())
            snap = h.snapshot()
            pkg, backend = restore_into
            h = _harness(pkg, backend, kind, lateness, agg_name, batch_fires,
                         late_tag)
            h.initialize_state(_cross(snap, pkg))
    h.process_watermark(10 ** 13)
    out.extend((r.value, r.timestamp) for r in h.get_output())
    return out, h


@pytest.mark.parametrize("ingest", ["row", "batch"])
@pytest.mark.parametrize("lateness", [0, 700])
@pytest.mark.parametrize("kind", ["tumbling", "sliding", "session"])
def test_window_operator_matches_jax(kind, lateness, ingest):
    for (tp, tb), (jp, jb) in PAIRS:
        got, th_ = _run(tp, tb, kind, lateness, ingest)
        want, jh_ = _run(jp, jb, kind, lateness, ingest)
        assert got and got == want
        assert th_.operator.num_late_records_dropped == \
               jh_.operator.num_late_records_dropped > 0


@pytest.mark.parametrize("agg_name", ["count", "min", "max", "avg"])
def test_aggregates_exact(agg_name):
    got, _ = _run("torch", "gpu", "sliding", 700, "batch", agg_name)
    want, _ = _run("jax", "tpu", "sliding", 700, "batch", agg_name)
    assert got and got == want


def _split(out):
    return ([(v[0], v[2], v[3], t) for v, t in out], [v[1] for v, _ in out])


@pytest.mark.parametrize("kind", ["tumbling", "sliding", "session"])
def test_hll_matches_jax(kind):
    got, _ = _run("torch", "gpu", kind, 700, "batch", "hll")
    want, _ = _run("jax", "tpu", kind, 700, "batch", "hll")
    heap, _ = _run("torch", "heap", kind, 700, "batch", "hll")
    assert _split(got)[0] == _split(want)[0] == _split(heap)[0]
    assert_hll_close(_split(got)[1], _split(want)[1], 1 << P)
    assert_hll_close(_split(heap)[1], _split(want)[1], 1 << P)


@pytest.mark.parametrize("kind", ["tumbling", "sliding", "session"])
def test_hll_window_registers_bit_equal(kind):
    regs = {}
    for pkg, backend in (("torch", "gpu"), ("jax", "tpu")):
        h = _harness(pkg, backend, kind, 0, "hll")
        for keys, vals, ts, _ in _chunks(seed=9, n_chunks=3):
            _feed(h, pkg, "batch", keys, vals, ts)
        st = h.operator.window_state
        regs[pkg] = {(k, tuple(ns)): np.asarray(row)
                     for keys, nss, comps in st.snapshot_columns().values()
                     for k, ns, row in zip(keys, nss, comps["regs"])}
    assert regs["torch"].keys() == regs["jax"].keys() and regs["torch"]
    for e, row in regs["jax"].items():
        np.testing.assert_array_equal(regs["torch"][e], row)


@pytest.mark.parametrize("lateness", [0, 700])
@pytest.mark.parametrize("kind", ["tumbling", "sliding"])
def test_batched_fire_equals_per_timer_fire(kind, lateness):
    scalar, _ = _run("torch", "gpu", kind, lateness, "batch", batch_fires=False)
    batched, h = _run("torch", "gpu", kind, lateness, "batch", batch_fires=True)
    assert scalar and batched == scalar
    assert h.operator._batch_demote_reason is None
    assert h.operator.columnar_rows == 300 and h.operator.boxed_rows == 0


def test_session_batches_box_into_rows():
    _, h = _run("torch", "gpu", "session", 0, "batch")
    assert h.operator.boxed_rows == 300 and h.operator.columnar_rows == 0


@pytest.mark.parametrize("restore_into", [("torch", "gpu"), ("torch", "heap"),
                                          ("jax", "tpu")])
@pytest.mark.parametrize("kind", ["tumbling", "sliding"])
def test_timers_and_state_survive_a_snapshot(kind, restore_into):
    """Windows whose timers were registered before the snapshot fire
    after the restore, in the port and across to the JAX package.  The
    reference is the JAX run over the same restore schedule: a restore
    starts again from no watermark, so the restored run is not the
    uninterrupted one."""
    got, _ = _run("torch", "gpu", kind, 700, "batch", restore_into=restore_into)
    want, _ = _run("jax", "tpu", kind, 700, "batch", restore_into=("jax", "tpu"))
    assert got and got == want


@pytest.mark.parametrize("kind", ["tumbling", "session"])
def test_jax_snapshot_restores_into_the_port(kind):
    got, _ = _run("jax", "tpu", kind, 700, "row", restore_into=("torch", "gpu"))
    want, _ = _run("jax", "tpu", kind, 700, "row", restore_into=("jax", "tpu"))
    assert got and got == want


@pytest.mark.parametrize("kind", ["session"])
def test_port_snapshot_restores_into_jax(kind, monkeypatch):
    """A port session snapshot holds the port's own window objects in
    the merge mapping; the JAX operator restores it and merges restored
    sessions with new ones (counted here) to the JAX run's output."""
    merges = []
    add_window = jwo.MergingWindowSet.add_window

    def counting_add_window(self, new_window, merge_callback):
        restored = [w for w in self.mapping if isinstance(w, tw.TimeWindow)]
        result = add_window(self, new_window, merge_callback)
        merges.extend(w for w in restored if w not in self.mapping)
        return result

    monkeypatch.setattr(jwo.MergingWindowSet, "add_window", counting_add_window)
    got, _ = _run("torch", "gpu", kind, 700, "row", restore_into=("jax", "tpu"))
    assert merges, "no restored session merged after the restore"
    monkeypatch.setattr(jwo.MergingWindowSet, "add_window", add_window)
    want, _ = _run("jax", "tpu", kind, 700, "row", restore_into=("jax", "tpu"))
    assert got and got == want


def test_time_window_equality_across_packages_is_one_way():
    """A port TimeWindow equals a JAX TimeWindow of the same bounds (the
    reference's dict lookups find the port windows a snapshot stored),
    not the other way round: the reference's ``__eq__`` checks its own
    class.  Objects of another class with ``start`` and ``end`` are not
    windows to the port."""
    port, jax_w = tw.TimeWindow(0, 300), jw.TimeWindow(0, 300)
    assert port == jax_w and hash(port) == hash(jax_w)
    assert not jax_w.__eq__(port)
    assert port != jw.TimeWindow(0, 301)
    assert {jax_w: 1}.get(tw.TimeWindow(0, 300)) is None
    assert {port: 1}.get(jw.TimeWindow(0, 300)) == 1

    class Span:
        start, end = 0, 300

    assert port != Span() and port.__eq__(Span()) is NotImplemented


@pytest.mark.parametrize("ingest", ["row", "batch"])
def test_late_data_side_output(ingest):
    side = {}
    for pkg, backend in (("torch", "gpu"), ("jax", "tpu")):
        out, h = _run(pkg, backend, "tumbling", 700, ingest, late_tag="late")
        side[pkg] = (out, [(r.value, r.timestamp) for r in h.get_side_output("late")])
        assert h.operator.num_late_records_dropped == 0
    assert side["torch"] == side["jax"] and side["torch"][1]


# ---------------------------------------------------------------------
# Count-Min on the GPU backend: state rows of two dimensions ([d, w]
# tables beside a scalar total) through flush, fire, session merges,
# spill to host RAM and promotion, and a snapshot and restore
# ---------------------------------------------------------------------

def _cm_events(n=4000, n_keys=300, seed=29):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.integers(0, 10 * n_keys, n))
    t[1::9] -= rng.integers(0, 1200, len(t[1::9]))          # out of order
    return list(zip(rng.integers(0, n_keys, n).tolist(),
                    rng.integers(1, 30, n).tolist(), np.maximum(t, 0).tolist()))


def _cm_session(pkg, backend, events, restore_at=None, finish=True, **kw):
    """(value, timestamp) outputs of a session-window Count-Min job and
    the last harness; with ``restore_at`` the run snapshots there and
    finishes in a fresh harness of the same kind; ``finish`` fires every
    session at the end."""
    from flink_tpu.ops.sketches import CountMinSketchAggregate as JaxCM
    from flink_tpu_torch.ops.sketches import CountMinSketchAggregate as TorchCM
    p = PKG[pkg]
    if pkg == "torch" and backend == "gpu":
        kw = dict(kw, device="cpu")

    def harness():
        agg = (TorchCM if pkg == "torch" else JaxCM)(4, 64)
        agg.extract_value = lambda v: v[1]
        op = p["wo"].WindowOperator(p["w"].EventTimeSessionWindows.with_gap(300),
                                    p["desc"]("cm", agg), window_function=_window_fn)
        h = p["h"].OneInputStreamOperatorTestHarness(
            op, key_selector=lambda x: x[0], state_backend=backend, **kw)
        h.open()
        return h

    h, out = harness(), []
    for i, (k, v, t) in enumerate(events):
        h.process_element((k, v), t)
        if i % 500 == 499:
            h.process_watermark(t - 1500)
        if i == restore_at:
            out.extend((r.value, r.timestamp) for r in h.get_output())
            snap = h.snapshot()
            h = harness()
            h.initialize_state(snap)
    if finish:
        h.process_watermark(2**62)
    out.extend((r.value, r.timestamp) for r in h.get_output())
    return sorted(out), h


def test_countmin_rows_through_the_gpu_backend():
    events = _cm_events()
    cap = dict(max_device_slots=32, initial_capacity=8, microbatch=32)
    got, h = _cm_session("torch", "gpu", events, restore_at=2100, **cap)
    heap, _ = _cm_session("torch", "heap", events, restore_at=2100)
    want, _ = _cm_session("jax", "tpu", events, restore_at=2100)
    assert len(got) > 300 and got == heap == want
    # the capped backend spilled sessions to host RAM and brought them
    # back, before the restore and after it
    st = h.operator.window_state
    assert st.evictions > 0 and st.promotions > 0
    # mid-stream rows bit-equal to the JAX backend's, spilled rows too
    rows = {}
    for pkg, backend, kw in (("torch", "gpu", cap), ("jax", "tpu", {})):
        _, h = _cm_session(pkg, backend, events[:1500], finish=False, **kw)
        st = h.operator.window_state
        rows[pkg] = {(k, tuple(ns)): (np.asarray(a), int(np.asarray(b).reshape(-1)[0]))
                     for keys, nss, comps in st.snapshot_columns().values()
                     for k, ns, a, b in zip(keys, nss, comps["table"], comps["total"])}
        if pkg == "torch":
            assert len(st.host_tier) > 0
    assert rows["torch"].keys() == rows["jax"].keys() and rows["torch"]
    for e, (table, total) in rows["jax"].items():
        np.testing.assert_array_equal(rows["torch"][e][0], table)
        assert rows["torch"][e][1] == total == table[0].sum()
