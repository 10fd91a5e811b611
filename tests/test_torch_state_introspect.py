"""The keyed-state introspection plane (``flink_tpu_torch/state/introspect.py``)
against the reference's: the skew tracker on the same keys, the live
accounting of a window operator's backend after the same batch, and the
offline inspector over one checkpoint directory of each package, read
by both packages' inspectors.

Stated difference: on the heap backend a device aggregate's accumulator
is a boxed row, pickled for its bytes; the port holds a scalar
component as a one-element array where the reference holds a numpy
scalar, so each such row pickles 18 bytes longer in the port.  Rows and
namespace counts are equal, and on the device backend (columns) bytes
are equal too.

The port's backends account by decoding their own snapshot, which is
the reference's definition of the inspector's numbers, so live and
offline accounting agree by construction; the reference's heap and tpu
backends walk their tables with the same definitions."""

import gc

import numpy as np
import pytest

from flink_tpu.core.state import AggregatingStateDescriptor as JAggDesc
from flink_tpu.ops.device_agg import SumAggregate as JSum
from flink_tpu.runtime.checkpoints import FsCheckpointStorage as JFs
from flink_tpu.state import introspect as ji
from flink_tpu.streaming.elements import RecordBatch as JBatch
from flink_tpu.streaming.harness import OneInputStreamOperatorTestHarness as JH
from flink_tpu.streaming.window_operator import WindowOperator as JWin
from flink_tpu.streaming.windowing import TumblingEventTimeWindows as JTumble
from flink_tpu_torch.core.state import AggregatingStateDescriptor as TAggDesc
from flink_tpu_torch.ops.device_agg import SumAggregate as TSum
from flink_tpu_torch.runtime.checkpoints import FsCheckpointStorage as TFs
from flink_tpu_torch.state import introspect as ti
from flink_tpu_torch.streaming.elements import RecordBatch as TBatch
from flink_tpu_torch.streaming.harness import OneInputStreamOperatorTestHarness as TH
from flink_tpu_torch.streaming.window_operator import WindowOperator as TWin
from flink_tpu_torch.streaming.windowing import TumblingEventTimeWindows as TTumble


@pytest.fixture(autouse=True)
def _clean():
    for m in (ji, ti):
        m.INTROSPECTION.disable()
        m.INTROSPECTION.reset()
    yield
    for m in (ji, ti):
        m.INTROSPECTION.disable()
        m.INTROSPECTION.reset()


def _keys(seed=7):
    rng = np.random.default_rng(seed)
    return np.concatenate([np.zeros(500, np.int64),
                           rng.integers(1, 40, 500).astype(np.int64)])


@pytest.mark.parametrize("path", ["batch", "rows"])
def test_skew_tracker_equals_reference(path):
    keys = _keys()
    out = []
    for m in (ji, ti):
        t = m.StateIntrospection()
        t.enable()
        if path == "batch":
            t.note_ingest("s", keys, 128)
        else:
            for k in keys.tolist():
                t.note_row("s", k, 128)
        tr = t._trackers["s"]
        out.append((t.payload(), t.skew_summary(), tr.table.copy(),
                    dict(tr.kg_counts)))
    (pr, sr, tab_r, kg_r), (pp, sp, tab_p, kg_p) = out
    assert pp == pr and sp == sr and kg_p == kg_r
    assert np.array_equal(tab_p, tab_r)
    assert pp["skew"]["verdict"] == "skewed"


@pytest.mark.parametrize("port", [False, True], ids=["jax", "port"])
def test_disabled_plane_records_nothing_through_a_job(port):
    m = ti if port else ji
    _drive(port, "device")
    assert m.INTROSPECTION.payload()["enabled"] is False
    assert m.INTROSPECTION._trackers == {}
    assert m.INTROSPECTION.skew_summary()["ratio"] == 0.0


class _JKV(JSum):
    def __init__(self):
        super().__init__(np.float32)

    def extract_value(self, value):
        return value[1] if isinstance(value, tuple) else value


class _TKV(TSum):
    def __init__(self):
        super().__init__(np.float32)

    def extract_value(self, value):
        return value[1] if isinstance(value, tuple) else value


def _drive(port: bool, backend: str):
    rng = np.random.default_rng(17)
    keys = rng.integers(0, 23, 400)
    vals = rng.integers(0, 9, 400).astype(np.float64)
    ts = np.arange(400, dtype=np.int64)
    if port:
        op = TWin(TTumble.of(10_000), TAggDesc("w-sum", _TKV()),
                  window_function=lambda k, w, vs: [(k, w.start, float(v))
                                                    for v in vs])
        h = TH(op, key_selector=lambda x: x[0],
               state_backend="gpu" if backend == "device" else "heap",
               device="cpu")
        h.open()
        h.process_batch(TBatch({"f0": keys, "f1": vals}, ts=ts))
    else:
        op = JWin(JTumble.of(10_000), JAggDesc("w-sum", _JKV()),
                  window_function=lambda k, w, vs: [(k, w.start, float(v))
                                                    for v in vs])
        h = JH(op, key_selector=lambda x: x[0],
               state_backend="tpu" if backend == "device" else "heap")
        h.open()
        h.process_batch(JBatch({"f0": keys, "f1": vals}, ts=ts))
    return h


#: the port's extra pickled bytes per boxed row (see the docstring)
BOXED_EXTRA = {"heap": 18, "device": 0}


def _as_ref(acct, backend):
    return {name: {kg: {**e, "bytes": e["bytes"] - BOXED_EXTRA[backend]
                        * e["rows"]} for kg, e in per.items()}
            for name, per in acct.items()}


@pytest.mark.parametrize("backend", ["heap", "device"])
def test_live_accounting_equals_reference(backend):
    ref = _drive(False, backend).operator.keyed_backend.accounting_breakdown()
    port = _drive(True, backend).operator.keyed_backend.accounting_breakdown()
    assert _as_ref(port, backend) == ref
    assert sum(e["rows"] for e in port["w-sum"].values()) == 23


@pytest.mark.parametrize("backend", ["heap", "device"])
def test_plane_payload_after_a_window_job_equals_reference(backend):
    gc.collect()   # earlier tests' backends leave the registries
    payloads = []
    for port, m in ((False, ji), (True, ti)):
        m.INTROSPECTION.enable()
        h = _drive(port, backend)
        payloads.append(m.INTROSPECTION.payload())
        del h
        m.INTROSPECTION.disable()
        gc.collect()
    ref, port = payloads
    acct = port["accounting"]["w-sum"]
    extra = BOXED_EXTRA[backend] * acct["rows"]
    assert {**acct, "bytes": acct["bytes"] - extra,
            "key_groups": _as_ref({"w": {int(k): v for k, v in
                                         acct["key_groups"].items()}},
                                  backend)["w"]} == \
        {**ref["accounting"]["w-sum"],
         "key_groups": {int(k): v for k, v in
                        ref["accounting"]["w-sum"]["key_groups"].items()}}
    assert port["ingest"] == ref["ingest"] and port["ingest"]["w-sum"] == 400


@pytest.fixture(scope="module")
def checkpoint_dirs(tmp_path_factory):
    """One checkpoint directory from each package, of the same state on
    the device backend."""
    dirs = {}
    for port, fs, name in ((False, JFs, "jax"), (True, TFs, "port")):
        d = tmp_path_factory.mktemp(name)
        snap = _drive(port, "device").snapshot()
        fs(str(d), retain=2).persist(3, {"timestamp": 123}, {(0, 0): snap})
        dirs[name] = str(d)
    return dirs


@pytest.mark.parametrize("written_by", ["jax", "port"])
def test_inspector_reports_equal_reference_on_either_packages_directory(
        checkpoint_dirs, written_by):
    """Both inspectors read either package's directory and give the same
    report, but for the backend's name in the snapshot's metadata
    (``gpu`` in the port, ``tpu`` in the reference)."""
    d = checkpoint_dirs[written_by]
    ref = ji.inspect_checkpoint(d, top=5, parallelism=4)
    port = ti.inspect_checkpoint(d, top=5, parallelism=4)
    assert port["backends"] == ref["backends"] == \
        (["gpu"] if written_by == "port" else ["tpu"])
    assert port["checkpoint_id"] == 3 and port["max_parallelism"] == 128
    st = port["states"]["w-sum"]
    assert st["rows"] == 23 and st["bytes"] == 23 * 4
    assert port["rescale"]["subtasks"][-1]["key_group_range"][1] == 127

    def strip(r):
        return {k: v for k, v in r.items() if k not in ("directory",
                                                        "backends")}

    assert strip(port) == strip(ref)
    other = ti.inspect_checkpoint(
        checkpoint_dirs["jax" if written_by == "port" else "port"],
        top=5, parallelism=4)
    assert strip(port) == strip(other)


def test_live_accounting_equals_the_offline_report(tmp_path):
    h = _drive(True, "device")
    live = h.operator.keyed_backend.accounting_breakdown()
    TFs(str(tmp_path)).persist(1, {}, {(0, 0): h.snapshot()})
    report = ti.inspect_checkpoint(str(tmp_path))
    assert {kg: (e["rows"], e["bytes"]) for kg, e in live["w-sum"].items()} \
        == {kg: (e["rows"], e["bytes"])
            for kg, e in report["states"]["w-sum"]["key_groups"].items()}


def test_inspector_selection_errors_and_rescale_bounds(checkpoint_dirs,
                                                       tmp_path):
    with pytest.raises(FileNotFoundError):
        ti.inspect_checkpoint(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        ti.inspect_checkpoint(checkpoint_dirs["port"], checkpoint_id=9)
    with pytest.raises(ValueError):
        ti.inspect_checkpoint(checkpoint_dirs["port"], parallelism=500)
    rep = ti.inspect_checkpoint(checkpoint_dirs["port"])
    pre = ti.rescale_preview(rep, 3)
    assert sum(s["rows"] for s in pre["subtasks"]) == 23
    assert ti.top_keys({"_key_weights": {("s", 1): [2, 8], ("s", 2): [1, 9]}},
                       1) == [{"state": "s", "key": "2", "rows": 1, "bytes": 9}]


def test_dispose_freezes_the_accounting():
    gc.collect()
    ti.INTROSPECTION.enable()
    h = _drive(True, "heap")
    backend = h.operator.keyed_backend
    live = ti.INTROSPECTION.payload()["accounting"]["w-sum"]
    backend.dispose()
    assert ti.INTROSPECTION.payload()["accounting"]["w-sum"] == live
