"""The Table layer's columnar plan in the port against the JAX package,
on the CPU: tests/test_columnar.py's cases (plan choice, columnar
against rows, window properties, the fallback to rows, the session
fallback to VectorizedSessionWindows, exactly-once recovery, the string
key wordcount, the columnar interval join, parallelism 2, rescaling
through a savepoint to parallelism 4 and 1) through both packages on
the same seeded numpy columns (the port on ``device="cpu"``), the mesh
cases of tests/test_mesh_log.py (the SQL query on 8 virtual shards
equals the meshless run; the operator picks the mesh log tier), and
savepoints of a columnar SQL job and snapshots of the columnar
interval join that cross the packages both ways.

Results compare exactly: on the CPU both packages run the log tier's
host finish (HLL estimates bit-equal) and the same interval join core.
"""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import flink_tpu.table as jtable
from flink_tpu.core import functions as jfn
from flink_tpu.ops import device_agg as jda
from flink_tpu.streaming import columnar as jcol
from flink_tpu.streaming import datastream as jds
from flink_tpu.streaming import elements as jel
from flink_tpu.streaming import log_windows as jlw
from flink_tpu.streaming import operators as jops
from flink_tpu.streaming import sources as jsrc
from flink_tpu.streaming import vectorized_sessions as jvs
from flink_tpu.streaming import windowing as jw
from flink_tpu.table import api as japi
import flink_tpu_torch.table as ttable
from flink_tpu_torch.core import functions as tfn
from flink_tpu_torch.ops import device_agg as tda
from flink_tpu_torch.ops.sketches import HyperLogLogAggregate as TorchHll
from flink_tpu_torch.parallel.mesh import Mesh
from flink_tpu_torch.parallel.mesh_log import _MeshShardedLogEngine
from flink_tpu_torch.state import portable
from flink_tpu_torch.streaming import columnar as tcol
from flink_tpu_torch.streaming import datastream as tds
from flink_tpu_torch.streaming import elements as tel
from flink_tpu_torch.streaming import log_windows as tlw
from flink_tpu_torch.streaming import operators as tops
from flink_tpu_torch.streaming import sources as tsrc
from flink_tpu_torch.streaming import vectorized_sessions as tvs
from flink_tpu_torch.streaming import windowing as tw
from flink_tpu_torch.table import api as tapi

P = {"torch": SimpleNamespace(ds=tds, src=tsrc, table=ttable, api=tapi,
                              col=tcol, fn=tfn, da=tda, lw=tlw, vs=tvs, w=tw,
                              el=tel, ops=tops),
     "jax": SimpleNamespace(ds=jds, src=jsrc, table=jtable, api=japi,
                            col=jcol, fn=jfn, da=jda, lw=jlw, vs=jvs, w=jw,
                            el=jel, ops=jops)}
PKGS = ["torch", "jax"]

SQL = ("SELECT k, APPROX_COUNT_DISTINCT(u) AS d "
       "FROM ev GROUP BY TUMBLE(ts, INTERVAL '1' SECOND), k")


def _env(pkg, parallelism=1):
    env = (P[pkg].ds.StreamExecutionEnvironment(device="cpu")
           if pkg == "torch" else P[pkg].ds.StreamExecutionEnvironment())
    env.set_parallelism(parallelism)
    return env


def synth(n, n_keys, t_span, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n_keys, n).astype(np.uint64)
    ts = np.sort(rng.integers(0, t_span, n).astype(np.int64))
    users = rng.integers(0, 2 ** 40, n).astype(np.uint64)
    return keys, ts, users


def run_columnar(pkg, cols, sql=SQL, chunk=4096, parallelism=1, mesh=None):
    """(table, rows of the batched sink in emission order)."""
    p = P[pkg]
    env = _env(pkg, parallelism)
    if mesh is not None:
        env.set_mesh(mesh)
    t_env = p.table.StreamTableEnvironment.create(env)
    t_env.register_table("ev", t_env.from_columns(cols, rowtime="ts",
                                                  chunk=chunk))
    out = t_env.sql_query(sql)
    sink = p.col.ColumnarCollectSink()
    out.to_append_stream(batched=True).add_sink(sink)
    env.execute("columnar")
    return out, [tuple(x.item() if hasattr(x, "item") else x for x in r)
                 for r in sink.rows()]


def run_rowpath(pkg, cols, sql=SQL):
    p = P[pkg]
    env = _env(pkg)
    events = list(zip(*(np.asarray(c).tolist() for c in cols.values())))
    pos = list(cols).index("ts")
    stream = env.from_collection(events).assign_timestamps_and_watermarks(
        p.src.BoundedOutOfOrdernessTimestampExtractor(0, lambda e: e[pos]))
    t_env = p.table.StreamTableEnvironment.create(env)
    t_env.register_table("ev", t_env.from_data_stream(stream, list(cols),
                                                      rowtime="ts"))
    out = t_env.sql_query(sql)
    sink = p.src.CollectSink()
    out.to_append_stream().add_sink(sink)
    env.execute("rowpath")
    return sink.values


def _cols(keys, ts, users):
    return {"k": keys, "u": users, "ts": ts}


# ---------------------------------------------------------------------
# plan choice, columnar against rows, window properties, fallbacks
# ---------------------------------------------------------------------

def test_columnar_plan_is_chosen_in_both():
    keys, ts, users = synth(2000, 50, 3000, seed=1)
    for pkg in PKGS:
        env = _env(pkg)
        t_env = P[pkg].table.StreamTableEnvironment.create(env)
        t_env.register_table("ev", t_env.from_columns(
            _cols(keys, ts, users), rowtime="ts"))
        out = t_env.sql_query(SQL)
        assert getattr(out, "columnar", False)
        assert out.stream.node.name == "columnar_window_agg"
        assert isinstance(out.stream.node.operator_factory(),
                          P[pkg].col.ColumnarWindowOperator)


@pytest.mark.parametrize("sql", [
    SQL,
    "SELECT TUMBLE_END(ts, INTERVAL '1' SECOND) AS we, "
    "APPROX_COUNT_DISTINCT(u) AS d, k "
    "FROM ev GROUP BY TUMBLE(ts, INTERVAL '1' SECOND), k",
    "SELECT k, COUNT(*) AS c, TUMBLE_START(ts) AS ws FROM ev "
    "GROUP BY TUMBLE(ts, INTERVAL '500' MILLISECOND), k",
    "SELECT k, APPROX_COUNT_DISTINCT(u) AS d, HOP_START(ts) AS ws FROM ev "
    "GROUP BY HOP(ts, INTERVAL '500' MILLISECOND, INTERVAL '1' SECOND), k",
])
def test_columnar_matches_reference_and_row_path(sql):
    keys, ts, users = synth(6000, 80, 3000, seed=2)
    cols = _cols(keys, ts, users)
    t_out, t_rows = run_columnar("torch", cols, sql)
    j_out, j_rows = run_columnar("jax", cols, sql)
    assert getattr(t_out, "columnar", False) and getattr(j_out, "columnar", False)
    assert t_rows == j_rows and len(t_rows) > 0
    # the port's columnar plan equals the port's row plan
    assert sorted(t_rows) == sorted(run_rowpath("torch", cols, sql))


def test_config5_columnar_equals_datastream_job():
    """Config #5's SQL on the columnar plan gives, key for key, the port's
    DataStream job key_by().window(1 s).aggregate(HyperLogLogAggregate(12))
    on the same events."""
    keys, ts, users = synth(20_000, 300, 3000, seed=21)
    _, rows = run_columnar("torch", _cols(keys, ts, users), chunk=1 << 12)
    env = _env("torch")
    sink = tsrc.CollectSink()
    events = list(zip(keys.tolist(), users.tolist(), ts.tolist()))
    agg = TorchHll(12)
    agg.extract_value = lambda e: e[1]
    (env.from_collection(events)
        .assign_timestamps_and_watermarks(
            tsrc.BoundedOutOfOrdernessTimestampExtractor(0, lambda e: e[2]))
        .key_by(lambda e: e[0])
        .window(tw.TumblingEventTimeWindows.of(1000))
        .aggregate(agg, lambda k, w, r: [(k, r[0])])
        .add_sink(sink))
    env.execute("datastream")
    assert sorted(rows) == sorted(sink.values)


def test_non_eligible_plan_falls_back_to_rows():
    keys, ts, users = synth(1000, 20, 2000, seed=4)
    sql = ("SELECT k, COUNT(*) AS c, SUM(u) AS s "
           "FROM ev GROUP BY TUMBLE(ts, INTERVAL '1' SECOND), k")
    outs = {}
    for pkg in PKGS:
        env = _env(pkg)
        t_env = P[pkg].table.StreamTableEnvironment.create(env)
        t_env.register_table("ev", t_env.from_columns(
            _cols(keys, ts, users), rowtime="ts", chunk=256))
        out = t_env.sql_query(sql)
        assert not getattr(out, "columnar", False)
        sink = P[pkg].src.CollectSink()
        out.to_append_stream().add_sink(sink)
        env.execute("fallback")
        outs[pkg] = sink.values
    assert outs["torch"] == outs["jax"]
    assert sorted(outs["torch"]) == sorted(
        run_rowpath("torch", _cols(keys, ts, users), sql))


def test_columnar_projection_and_explode_match():
    """A pure column projection stays columnar; ``to_append_stream()``
    without ``batched`` explodes it to row tuples."""
    keys, ts, users = synth(500, 20, 2000, seed=5)
    outs = {}
    for pkg in PKGS:
        env = _env(pkg)
        t_env = P[pkg].table.StreamTableEnvironment.create(env)
        t = t_env.from_columns(_cols(keys, ts, users), rowtime="ts",
                               chunk=128)
        proj = t.select("ts", "k AS key")
        filt = t.filter("k < 5")
        assert proj.columnar and proj.rowtime == "ts"
        s1, s2 = P[pkg].src.CollectSink(), P[pkg].src.CollectSink()
        proj.to_append_stream().add_sink(s1)
        filt.to_append_stream().add_sink(s2)
        env.execute("project")
        outs[pkg] = (s1.values, s2.values, proj.schema.fields)
    assert outs["torch"] == outs["jax"]
    assert len(outs["torch"][0]) == 500


def test_columnar_source_rows_roundtrip():
    for pkg in PKGS:
        b = P[pkg].col.RecordBatch({"a": np.array([1, 2]),
                                    "b": np.array([3.0, 4.0])},
                                   np.array([10, 20]))
        assert len(b) == 2 and list(b.rows()) == [(1, 3.0), (2, 4.0)]


def test_columnar_session_with_hll_falls_back_to_vectorized_sessions():
    rng = np.random.default_rng(6)
    n = 3000
    keys = rng.integers(0, 30, n).astype(np.uint64)
    ts = np.sort(rng.integers(0, 5000, n).astype(np.int64))
    users = rng.integers(0, 2 ** 40, n).astype(np.uint64)
    sql = ("SELECT k, APPROX_COUNT_DISTINCT(u) AS d "
           "FROM ev GROUP BY SESSION(ts, INTERVAL '1' SECOND), k")
    cols = _cols(keys, ts, users)
    t_out, t_rows = run_columnar("torch", cols, sql, chunk=512)
    _, j_rows = run_columnar("jax", cols, sql, chunk=512)
    assert t_out.columnar
    assert t_rows == j_rows
    assert sorted(t_rows) == sorted(run_rowpath("torch", cols, sql))
    op = t_out.stream.node.operator_factory()
    assert isinstance(op._make_engine(np.dtype(np.uint64)),
                      tvs.VectorizedSessionWindows)


def test_columnar_engine_is_built_on_the_environment_device():
    keys, ts, users = synth(100, 5, 1000, seed=7)
    env = _env("torch")
    t_env = ttable.StreamTableEnvironment.create(env)
    t_env.register_table("ev", t_env.from_columns(
        _cols(keys, ts, users), rowtime="ts"))
    op = t_env.sql_query(SQL).stream.node.operator_factory()
    assert op.device.type == "cpu"
    eng = op._make_engine(np.dtype(np.uint64))
    assert isinstance(eng, tlw.LogStructuredTumblingWindows)
    assert eng.device.type == "cpu" and eng.mode.finish_tier == "host"


# ---------------------------------------------------------------------
# exactly-once recovery, string keys
# ---------------------------------------------------------------------

class _FailOnceMixin:
    def __init__(self):
        self.checkpoint_completed = False
        self.failed = False

    def notify_checkpoint_complete(self, checkpoint_id):
        self.checkpoint_completed = True

    def map(self, value):
        if self.checkpoint_completed and not self.failed:
            self.failed = True
            raise RuntimeError("induced failure after checkpoint")
        return value


def test_columnar_exactly_once_recovery():
    rng = np.random.default_rng(8)
    n, n_keys = 40_000, 50
    keys = rng.integers(0, n_keys, n).astype(np.uint64)
    ts = np.sort(rng.integers(0, 4000, n).astype(np.int64))
    outs = {}
    for pkg in PKGS:
        p = P[pkg]
        failer = type("FailOnce", (_FailOnceMixin, p.fn.MapFunction), {})()
        env = _env(pkg)
        env.enable_checkpointing(5)
        env.set_restart_strategy("fixed_delay", restart_attempts=3,
                                 delay_ms=0)
        t_env = p.table.StreamTableEnvironment.create(env)
        table = t_env.from_columns({"k": keys, "c": np.ones(n, np.float64),
                                    "ts": ts}, rowtime="ts", chunk=1024)
        table.stream = table.stream.map(failer, name="failer")
        t_env.register_table("ev", table)
        out = t_env.sql_query("SELECT k, SUM(c) AS c FROM ev "
                              "GROUP BY TUMBLE(ts, INTERVAL '1' SECOND), k")
        assert out.columnar
        sink = p.col.ColumnarCollectSink()
        out.to_append_stream(batched=True).add_sink(sink)
        result = env.execute("columnar-exactly-once")
        assert failer.failed and result.restarts == 1
        assert result.checkpoints_completed >= 1
        assert sum(float(c) for _, c in sink.rows()) == n
        outs[pkg] = sorted((int(k), float(c)) for k, c in sink.rows())
    assert outs["torch"] == outs["jax"]


def test_columnar_string_key_wordcount():
    rng = np.random.default_rng(8)
    n = 3000
    vocab = np.asarray([f"w{i}" for i in range(40)])
    words = vocab[rng.integers(0, 40, n)]
    ts = np.sort(rng.integers(0, 3000, n).astype(np.int64))
    ones = np.ones(n, np.float64)
    sql = ("SELECT k, SUM(u) AS c "
           "FROM ev GROUP BY TUMBLE(ts, INTERVAL '1' SECOND), k")
    cols = {"k": words, "u": ones, "ts": ts}
    t_out, t_rows = run_columnar("torch", cols, sql, chunk=512)
    _, j_rows = run_columnar("jax", cols, sql, chunk=512)
    assert t_out.columnar
    assert t_rows == j_rows
    row = run_rowpath("torch", {"k": words, "u": ones.astype(np.int64),
                                "ts": ts}, sql)
    assert sorted((str(k), float(v)) for k, v in t_rows) == \
        sorted((str(k), float(v)) for k, v in row)
    op = tcol.ColumnarWindowOperator(
        tw.TumblingEventTimeWindows.of(1000), tda.SumAggregate(np.float64),
        "k", "u", [("k", "key"), ("c", "agg")], device="cpu")
    assert isinstance(op._make_engine(words.dtype),
                      tlw.StringSumTumblingWindows)


# ---------------------------------------------------------------------
# the columnar interval join
# ---------------------------------------------------------------------

JOIN_SQL = ("SELECT a.lid, b.rid FROM l AS a JOIN r AS b ON a.k = b.rk "
            "AND a.ts BETWEEN b.rts - INTERVAL '300' MILLISECOND "
            "AND b.rts + INTERVAL '500' MILLISECOND")


def _join_inputs(n=600, n_keys=15, seed=12, str_keys=False):
    rng = np.random.default_rng(seed)
    lk = rng.integers(0, n_keys, n).astype(np.int64)
    rk = rng.integers(0, n_keys, n).astype(np.int64)
    if str_keys:
        lk, rk = lk.astype(str), rk.astype(str)
    left = {"lid": np.arange(n), "k": lk,
            "ts": np.sort(rng.integers(0, 4000, n).astype(np.int64))}
    right = {"rid": np.arange(1000, 1000 + n), "rk": rk,
             "rts": np.sort(rng.integers(0, 4000, n).astype(np.int64))}
    return left, right


def _run_join(pkg, left, right, columnar=True):
    p = P[pkg]
    env = _env(pkg)
    t_env = p.table.StreamTableEnvironment.create(env)
    if columnar:
        t_env.register_table("l", t_env.from_columns(left, rowtime="ts",
                                                     chunk=256))
        t_env.register_table("r", t_env.from_columns(right, rowtime="rts",
                                                     chunk=256))
    else:
        for name, cols, rt in (("l", left, "ts"), ("r", right, "rts")):
            rows = list(zip(*(np.asarray(c).tolist() for c in cols.values())))
            s = env.from_collection(rows).assign_timestamps_and_watermarks(
                p.src.BoundedOutOfOrdernessTimestampExtractor(
                    0, lambda e: e[2]))
            t_env.register_table(name, t_env.from_data_stream(
                s, list(cols), rowtime=rt))
    out = t_env.sql_query(JOIN_SQL)
    assert bool(getattr(out, "columnar", False)) == columnar
    if columnar:
        sink = p.col.ColumnarCollectSink()
        out.to_append_stream(batched=True).add_sink(sink)
        env.execute("cj")
        return sorted((int(a), int(b)) for a, b in sink.rows())
    sink = p.src.CollectSink()
    out.to_append_stream().add_sink(sink)
    env.execute("rj")
    return sorted((int(a), int(b)) for a, b in sink.values)


@pytest.mark.parametrize("str_keys", [False, True])
def test_columnar_interval_join_matches_reference_and_row_path(str_keys):
    left, right = _join_inputs(str_keys=str_keys)
    got = _run_join("torch", left, right)
    assert got == _run_join("jax", left, right) and len(got) > 0
    assert got == _run_join("torch", left, right, columnar=False)
    # an independent numpy join: sort by key and time, searchsorted
    want = []
    for i in range(len(left["lid"])):
        m = ((right["rk"] == left["k"][i])
             & (right["rts"] - left["ts"][i] >= -500)
             & (right["rts"] - left["ts"][i] <= 300))
        want += [(int(left["lid"][i]), int(r)) for r in right["rid"][m]]
    assert got == sorted(want)


def _iv_op(pkg):
    return P[pkg].col.ColumnarIntervalJoinOperator(
        "k", "rk", -500, 300, [("lid", "lid"), ("lts", "ts")],
        [("rid", "rid")])


def _iv_batches(left, right, chunk=200):
    """(tag, batch, watermark) steps of both sides, interleaved."""
    steps = []
    for lo in range(0, len(left["ts"]), chunk):
        for tag, cols, rt in ((0, left, "ts"), (1, right, "rts")):
            sl = slice(lo, lo + chunk)
            steps.append((tag, {k: v[sl] for k, v in cols.items()},
                          cols[rt][sl]))
    return steps


def _drive(op, pkg, steps, out):
    p = P[pkg]
    for tag, cols, ts in steps:
        op.process_element(p.el.StreamRecord(
            (tag, p.col.RecordBatch(cols, ts)), int(ts.max())))
        op.process_watermark(p.el.Watermark(int(ts.min()) - 600))
    for rec in out.records:
        if isinstance(rec.value, p.col.RecordBatch):
            yield from (tuple(int(x) for x in r) for r in rec.value.rows())
    out.records.clear()


@pytest.mark.parametrize("src,dst", [("torch", "jax"), ("jax", "torch"),
                                     ("torch", "torch")])
def test_columnar_interval_join_snapshot_crosses_packages(src, dst):
    left, right = _join_inputs(n=1200, seed=13)
    steps = _iv_batches(left, right)
    half = len(steps) // 2

    def fresh(pkg):
        op = _iv_op(pkg)
        out = P[pkg].ops.CollectorOutput()
        op.setup(out)
        op.open()
        return op, out

    whole, whole_out = fresh("torch")
    want = sorted(_drive(whole, "torch", steps, whole_out))
    a, a_out = fresh(src)
    first = list(_drive(a, src, steps[:half], a_out))
    snap = portable.loads(portable.dumps(a.snapshot_state(1)))
    b, b_out = fresh(dst)
    b.restore_state([snap])
    second = list(_drive(b, dst, steps[half:], b_out))
    assert sorted(first + second) == want and len(want) > 0


# ---------------------------------------------------------------------
# parallelism, rescaling, savepoints across the packages
# ---------------------------------------------------------------------

def test_columnar_parallelism_2_matches_parallelism_1():
    keys, ts, users = synth(8000, 60, 3000, seed=9)
    cols = _cols(keys, ts, users)
    one = sorted(run_columnar("torch", cols, chunk=512)[1])
    out, two = run_columnar("torch", cols, chunk=512, parallelism=2)
    names = [n.name for n in out.stream.env.graph.nodes.values()]
    assert "columnar_keyby_split" in names
    assert sorted(two) == one
    assert sorted(run_columnar("jax", cols, chunk=512, parallelism=2)[1]) == one


class _GatedMixin:
    """Emits the first FREE_ROWS, then idles until released (keeps the
    job alive while a savepoint is taken mid-stream)."""

    released = False
    FREE_ROWS = 0
    reached = None

    @classmethod
    def reset(cls, free_rows):
        cls.released = False
        cls.FREE_ROWS = free_rows
        cls.reached = threading.Event()

    def emit_step(self, ctx, max_records):
        cls = type(self)
        if not cls.released and self.offset >= cls.FREE_ROWS:
            cls.reached.set()
            time.sleep(0.001)
            return True
        return super().emit_step(ctx, max_records)


_GATED = {pkg: type("GatedColumnarSource", (_GatedMixin, P[pkg].col.ColumnarSource),
                    {}) for pkg in PKGS}


def _rescale_build(pkg, par, cols, savepoint=None):
    p = P[pkg]
    env = _env(pkg, par)
    env.enable_checkpointing(60_000)   # savepoints only
    if savepoint is not None:
        env.set_savepoint_restore(savepoint)
    t_env = p.table.StreamTableEnvironment.create(env)
    stream = env.add_source(_GATED[pkg](cols, "ts", chunk=1024),
                            name="columnar_source")
    t = p.api.Table(t_env, stream, p.api.Schema(list(cols)))
    t.rowtime = "ts"
    t.columnar = True
    t.col_dtypes = {k: np.asarray(v).dtype for k, v in cols.items()}
    t_env.register_table("ev", t)
    out = t_env.sql_query("SELECT k, SUM(u) AS s, TUMBLE_START(ts) AS ws "
                          "FROM ev GROUP BY TUMBLE(ts, INTERVAL '1' SECOND), k")
    assert out.columnar
    sink = p.col.ColumnarCollectSink()
    out.to_append_stream(batched=True).add_sink(sink)
    return env, sink


@pytest.mark.parametrize("src,par_from,dst,par_to", [
    ("torch", 2, "torch", 4),
    ("torch", 2, "torch", 1),
    ("torch", 2, "jax", 4),
    ("jax", 2, "torch", 1),
    ("jax", 2, "torch", 4),
    ("torch", 1, "jax", 2),
])
def test_columnar_sql_savepoint_rescale_and_cross(src, par_from, dst, par_to,
                                                  tmp_path):
    """Gate after one chunk (the watermark stays in the first window, so
    nothing fires before the savepoint), savepoint at ``par_from`` in
    ``src``, resume at ``par_to`` in ``dst``: every window's sum is
    exact.  The window operator's uid names the query, so its state
    finds it across the topology change of the split exchange."""
    keys, ts, users = synth(12_000, 50, 4000, seed=31)
    cols = {"k": keys, "u": users.astype(np.float64) % 1000, "ts": ts}
    truth = {}
    for k, u, t in zip(keys.tolist(), cols["u"].tolist(), ts.tolist()):
        kk = (int(k), t - t % 1000)
        truth[kk] = truth.get(kk, 0.0) + u
    _GATED[src].reset(free_rows=1024)
    env, _ = _rescale_build(src, par_from, cols)
    client = env.execute_async("origin")
    assert _GATED[src].reached.wait(60)
    path = client.stop_with_savepoint(str(tmp_path / "sp"))
    _GATED[dst].reset(free_rows=0)
    _GATED[dst].released = True
    env2, sink2 = _rescale_build(dst, par_to, cols, savepoint=path)
    env2.execute("resume")
    got = {}
    for k, s, ws in sink2.rows():
        got[(int(k), int(ws))] = got.get((int(k), int(ws)), 0.0) + float(s)
    assert got == truth


# ---------------------------------------------------------------------
# the mesh: 8 virtual shards (tests/test_mesh_log.py:289, :302)
# ---------------------------------------------------------------------

def _mesh_synth(n=6000, n_keys=40, horizon=3000, seed=7):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n_keys, n).astype(np.int64)
    ts = np.sort(rng.integers(0, horizon, n)).astype(np.int64)
    users = rng.integers(0, 400, n).astype(np.int64)
    return {"k": keys, "u": users, "ts": ts}


MESH_SQL = ("SELECT k, APPROX_COUNT_DISTINCT(u) AS d, TUMBLE_START(ts) AS ws "
            "FROM ev GROUP BY TUMBLE(ts, INTERVAL '1' SECOND), k")


def test_sql_tumble_rides_mesh_and_matches_host():
    cols = _mesh_synth()
    out, got = run_columnar("torch", cols, MESH_SQL, chunk=2048,
                            mesh=Mesh(["cpu"] * 8))
    _, want = run_columnar("torch", cols, MESH_SQL, chunk=2048)
    assert sorted(got) == sorted(want) and len(got) > 0
    _, ref = run_columnar("jax", cols, MESH_SQL, chunk=2048)
    assert sorted(want) == sorted(ref)


def test_columnar_operator_selects_mesh_tier():
    op = tcol.ColumnarWindowOperator(
        tw.TumblingEventTimeWindows.of(1000), TorchHll(10),
        "k", "u", [("k", "key"), ("d", "agg")], mesh=Mesh(["cpu"] * 8),
        device="cpu")
    assert isinstance(op._make_engine(np.dtype(np.int64)),
                      _MeshShardedLogEngine)
