"""The port's boundary: flink_tpu_torch (and chip_smoke.py) never load
jax, any module of flink_tpu or the JAX package's native library (a
subprocess job runs the log tier, the keyed backend, the sliding and
session log engines, the fused string sum, a DeviceTumblingWindows
batch, a fused map/filter chain ahead of a window at parallelism 4, a
Python aggregate on the generic tier, a count window over a device Sum,
graph algorithms, an ML fit, a job on an 8-shard mesh (the mesh log
tier), a checkpointed job that fails and restarts from its Fs
checkpoint, and jobs restored from the JAX package's savepoint and
checkpoint directory, and a columnar and a row-path SQL job, all with
the tracer, the device telemetry and the state introspection on and a
Chrome trace written at the end, then reads its own sys.modules and
/proc/self/maps), and its entry points never fall back to the CPU on
their own.  This test
process has jax loaded already (the test configuration imports it), so
the import check runs a job in a fresh interpreter."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_JOB = r"""
import json, sys
import numpy as np
from flink_tpu_torch.ops.sketches import HyperLogLogAggregate
from flink_tpu_torch.ops.device_agg import SumAggregate
from flink_tpu_torch.streaming.datastream import StreamExecutionEnvironment
from flink_tpu_torch.streaming.sources import (
    BoundedOutOfOrdernessTimestampExtractor, CollectSink)
from flink_tpu_torch.streaming.windowing import TumblingEventTimeWindows
import flink_tpu_torch.kernels, flink_tpu_torch.runtime.local
# the observability plane, on for every job below
import flink_tpu_torch.runtime.backpressure, flink_tpu_torch.runtime.profiler
import flink_tpu_torch.runtime.timeseries, flink_tpu_torch.runtime.metrics
from flink_tpu_torch.runtime.device_stats import TELEMETRY
from flink_tpu_torch.state.introspect import INTROSPECTION
TELEMETRY.enable()
INTROSPECTION.enable()
out = []
for agg in (HyperLogLogAggregate(8), SumAggregate(np.float64)):
    agg.extract_value = lambda e: e[1]
    env = StreamExecutionEnvironment.get_execution_environment(device="cpu")
    env.enable_tracing().set_latency_tracking_interval(1)
    (env.from_collection([(i % 7, i, 10 * i) for i in range(500)])
        .assign_timestamps_and_watermarks(
            BoundedOutOfOrdernessTimestampExtractor(0, lambda e: e[2]))
        .key_by(lambda e: e[0]).window(TumblingEventTimeWindows.of(1000))
        .aggregate(agg).add_sink(CollectSink(out)))
    env.execute()
# the keyed-state path: WindowOperator on the gpu backend (allowed
# lateness takes the job off the device window engine)
keyed = []
agg = HyperLogLogAggregate(8)
agg.extract_value = lambda e: e[1]
env = StreamExecutionEnvironment.get_execution_environment(device="cpu")
env.set_state_backend("gpu")
(env.from_collection([(i % 7, i, 10 * i) for i in range(500)])
    .assign_timestamps_and_watermarks(
        BoundedOutOfOrdernessTimestampExtractor(0, lambda e: e[2]))
    .key_by(lambda e: e[0]).window(TumblingEventTimeWindows.of(1000))
    .allowed_lateness(500).aggregate(agg).add_sink(CollectSink(keyed)))
env.execute()
# the sliding and session device engines, with the two sketches
from flink_tpu_torch.ops.sketches import (CountMinSketchAggregate,
                                          QuantileSketchAggregate)
from flink_tpu_torch.streaming.windowing import (EventTimeSessionWindows,
                                                 SlidingEventTimeWindows)
windowed = {}
for name, agg, assigner in (
        ("sliding", QuantileSketchAggregate(), SlidingEventTimeWindows.of(2000, 1000)),
        ("session", CountMinSketchAggregate(4, 64), EventTimeSessionWindows.with_gap(300))):
    windowed[name] = []
    agg.extract_value = lambda e: e[1]
    env = StreamExecutionEnvironment.get_execution_environment(device="cpu")
    (env.from_collection([(i % 7, 1 + i % 5, 10 * i) for i in range(500)])
        .assign_timestamps_and_watermarks(
            BoundedOutOfOrdernessTimestampExtractor(0, lambda e: e[2]))
        .key_by(lambda e: e[0]).window(assigner)
        .aggregate(agg).add_sink(CollectSink(windowed[name])))
    env.execute()
# string keys: the fused intern + sum engine
words = []
agg = SumAggregate(np.float64)
agg.extract_value = lambda e: e[1]
env = StreamExecutionEnvironment.get_execution_environment(device="cpu")
(env.from_collection([(f"w{i % 7}", 1.0, 10 * i) for i in range(500)])
    .assign_timestamps_and_watermarks(
        BoundedOutOfOrdernessTimestampExtractor(0, lambda e: e[2]))
    .key_by(lambda e: e[0]).window(TumblingEventTimeWindows.of(1000))
    .aggregate(agg).add_sink(CollectSink(words)))
env.execute()
# the device-indexed engine
from flink_tpu_torch.streaming.device_windows import (DeviceTumblingWindows,
                                                      lanes_from_int_keys)
dw = DeviceTumblingWindows(SumAggregate(np.float32), 1000, capacity=64,
                           device="cpu")
dw.process_batch(*lanes_from_int_keys(np.arange(40) % 9), np.arange(40),
                 values=np.ones(40, np.float32))
dw.advance_watermark(999)
import flink_tpu_torch.streaming.heavy_hitters
import flink_tpu_torch.state, flink_tpu_torch.streaming.harness
# a fused chain ahead of a window at parallelism 4 (route mode)
from flink_tpu_torch.streaming import chain_fusion
from flink_tpu_torch.streaming.columnar import VectorizedCollectionSource
from flink_tpu_torch.streaming.windowing import Time
chain_fusion.MIN_FUSED_ROWS = 256
fused = []
agg = HyperLogLogAggregate(8)
agg.extract_value = lambda e: e[1]
env = StreamExecutionEnvironment.get_execution_environment(device="cpu")
(env.add_source(VectorizedCollectionSource(
        [((i % 7, i), 10 * i) for i in range(2048)], timestamped=True, chunk=512))
    .map(lambda t: (t[0], t[1] * 3)).filter(lambda t: t[1] % 5 != 0)
    .key_by(0).time_window(Time.milliseconds_of(1000))
    .aggregate(agg).set_parallelism(4).add_sink(CollectSink(fused)))
env.execute()
# the graph and ML libraries: PageRank, components and triangles, an
# ALS fit and a KNN query
from flink_tpu_torch import graph as tg, ml as tm
g = tg.Graph.from_collection(None, [(i, (i * 7 + 1) % 50) for i in range(200)])
ranks = g.run(tg.PageRank(device="cpu"))
comps = g.run(tg.ConnectedComponents(device="cpu"))
triangles = g.run(tg.TriangleCount(device="cpu"))
als = tm.ALS(num_factors=3, iterations=2, device="cpu").fit(
    [(u, (u * 3) % 11, 1.0 + u % 5) for u in range(60)])
nearest = tm.KNN(k=2, device="cpu").fit(np.eye(6)).kneighbors(np.eye(6))
# a mesh job: integer keys on the mesh log tier over 8 shards
from flink_tpu_torch.parallel import Mesh
from flink_tpu_torch.parallel.mesh_log import MeshLogTumblingWindows
from flink_tpu_torch.streaming.device_window_operator import DeviceWindowOperator
meshed, mesh_engines = [], []
_ensure = DeviceWindowOperator._ensure_engine
def _note_engine(op, keys):
    _ensure(op, keys)
    mesh_engines.append(type(op.engine).__name__)
DeviceWindowOperator._ensure_engine = _note_engine
agg = HyperLogLogAggregate(8)
agg.extract_value = lambda e: e[1]
env = StreamExecutionEnvironment.get_execution_environment(device="cpu")
env.set_mesh(Mesh(["cpu"] * 8))
(env.from_collection([(i % 7, i, 10 * i) for i in range(500)])
    .assign_timestamps_and_watermarks(
        BoundedOutOfOrdernessTimestampExtractor(0, lambda e: e[2]))
    .key_by(lambda e: e[0]).window(TumblingEventTimeWindows.of(1000))
    .aggregate(agg).add_sink(CollectSink(meshed)))
env.execute()
# the generic tier (a Python aggregate) and a trigger job (a count
# window over the gpu backend's device Sum)
from flink_tpu_torch.core.functions import AggregateFunction
class MeanOf(AggregateFunction):
    def create_accumulator(self):
        return (0.0, 0.0)
    def add(self, v, acc):
        return (acc[0] + v[1], acc[1] + 1.0)
    def get_result(self, acc):
        return acc[0] / acc[1]
    def merge(self, a, b):
        return (a[0] + b[0], a[1] + b[1])
generic = []
env = StreamExecutionEnvironment.get_execution_environment(device="cpu")
(env.from_collection([(i % 7, i, 10 * i) for i in range(500)])
    .assign_timestamps_and_watermarks(
        BoundedOutOfOrdernessTimestampExtractor(0, lambda e: e[2]))
    .key_by(lambda e: e[0]).window(TumblingEventTimeWindows.of(1000))
    .aggregate(MeanOf()).add_sink(CollectSink(generic)))
env.execute()
counted = []
agg = SumAggregate(np.float64)
agg.extract_value = lambda e: e[1]
env = StreamExecutionEnvironment.get_execution_environment(device="cpu")
env.set_state_backend("gpu")
(env.from_collection([(i % 7, i, 10 * i) for i in range(500)])
    .key_by(lambda e: e[0]).count_window(10)
    .aggregate(agg).add_sink(CollectSink(counted)))
env.execute()
# checkpoints: a job that fails after a checkpoint and restarts from
# its Fs storage; then the JAX package's savepoint (argv[1]) and
# checkpoint directory (argv[2]) restore jobs of the port
import tempfile
from flink_tpu_torch.core.functions import MapFunction, RichFunction
from flink_tpu_torch.streaming.sources import FromCollectionSource
from flink_tpu_torch.streaming.windowing import EventTimeSessionWindows
class SumAgg(AggregateFunction):
    def create_accumulator(self):
        return 0
    def add(self, v, acc):
        return acc + v[1]
    def get_result(self, acc):
        return acc
    def merge(self, a, b):
        return a + b
class FailOnce(MapFunction):
    done = False
    failed = False
    def notify_checkpoint_complete(self, cid):
        type(self).done = True
    def map(self, v):
        if type(self).done and not type(self).failed:
            type(self).failed = True
            raise RuntimeError("induced")
        return v
class Gated(FromCollectionSource):
    ok = False
    def notify_checkpoint_complete(self, cid):
        type(self).ok = True
    def emit_step(self, ctx, n):
        if not type(self).ok and self.offset >= 300:
            return True
        return super().emit_step(ctx, min(n, max(1, 300 - self.offset)))
def job(env, items, sink, assigner, failer=None):
    stream = env.add_source(Gated(items, timestamped=True), name="src")
    if failer is not None:
        stream = stream.map(failer, name="failer")
    (stream.key_by(lambda e: e[0]).window(assigner)
        .aggregate(SumAgg(), lambda k, w, vals: [(k, w.start, v) for v in vals])
        .add_sink(sink))
items = [((f"k{i % 5}", 1), 10 * i) for i in range(600)]
restarted = CollectSink()
env = StreamExecutionEnvironment.get_execution_environment(device="cpu")
env.enable_checkpointing(1)
env.set_checkpoint_storage("filesystem", directory=tempfile.mkdtemp(), retain=2)
env.set_restart_strategy("fixed_delay", restart_attempts=2, delay_ms=0)
job(env, items, restarted, TumblingEventTimeWindows.of(1000), FailOnce())
cp_result = env.execute()
Gated.ok = True
from_savepoint = CollectSink()
env = StreamExecutionEnvironment.get_execution_environment(device="cpu")
env.set_savepoint_restore(sys.argv[1])
job(env, items, from_savepoint, EventTimeSessionWindows.with_gap(25))
env.execute()
class FailAtOpen(MapFunction, RichFunction):
    opened = 0
    def open(self, configuration=None):
        type(self).opened += 1
        if type(self).opened == 1:
            raise RuntimeError("fail at open, once")
    def map(self, v):
        return v
from_checkpoint = CollectSink()
env = StreamExecutionEnvironment.get_execution_environment(device="cpu")
env.enable_checkpointing(60_000)
env.set_checkpoint_storage("filesystem", directory=sys.argv[2], retain=2)
env.set_restart_strategy("fixed_delay", restart_attempts=2, delay_ms=0)
job(env, items, from_checkpoint, TumblingEventTimeWindows.of(1000), FailAtOpen())
env.execute()
# SQL: config #5 on the columnar plan, and a windowed and a continuous
# GROUP BY and an interval join on the row plan
from flink_tpu_torch.table import StreamTableEnvironment
rng = np.random.default_rng(0)
cols = {"k": rng.integers(0, 9, 2000), "u": rng.integers(0, 500, 2000),
        "ts": np.sort(rng.integers(0, 3000, 2000))}
env = StreamExecutionEnvironment.get_execution_environment(device="cpu")
t_env = StreamTableEnvironment.create(env)
t_env.register_table("ev", t_env.from_columns(cols, rowtime="ts", chunk=512))
sql_col = t_env.sql_query("SELECT k, APPROX_COUNT_DISTINCT(u) AS d FROM ev "
                          "GROUP BY TUMBLE(ts, INTERVAL '1' SECOND), k")
sql_col_rows = CollectSink()
sql_col.to_append_stream().add_sink(sql_col_rows)
env.execute()
env = StreamExecutionEnvironment.get_execution_environment(device="cpu")
t_env = StreamTableEnvironment.create(env)
rows = env.from_collection([(i % 7, i, 10 * i) for i in range(300)]) \
    .assign_timestamps_and_watermarks(
        BoundedOutOfOrdernessTimestampExtractor(0, lambda e: e[2]))
t_env.register_table("ev", t_env.from_data_stream(rows, ["k", "u", "ts"],
                                                  rowtime="ts"))
t_env.register_table("ev2", t_env.from_data_stream(rows, ["k2", "u2", "ts2"],
                                                   rowtime="ts2"))
sql_row_rows, sql_cont_rows, sql_join_rows = CollectSink(), CollectSink(), CollectSink()
t_env.sql_query("SELECT k, COUNT(*) AS c, SUM(u) AS s FROM ev "
                "GROUP BY TUMBLE(ts, INTERVAL '1' SECOND), k") \
    .to_append_stream().add_sink(sql_row_rows)
t_env.sql_query("SELECT k, SUM(u) AS s FROM ev GROUP BY k") \
    .to_retract_stream().add_sink(sql_cont_rows)
t_env.sql_query("SELECT u, u2 FROM ev JOIN ev2 ON k = k2 AND "
                "ts BETWEEN ts2 - INTERVAL '10' MILLISECOND AND ts2") \
    .to_append_stream().add_sink(sql_join_rows)
env.execute()
trace_path = tempfile.mktemp(suffix=".json")
n_written = env.get_tracer().write_chrome_trace(trace_path)
trace = json.load(open(trace_path))
payload = TELEMETRY.payload()
intro = INTROSPECTION.payload()
maps = open("/proc/self/maps").read()
print(json.dumps({"results": len(out), "keyed_results": len(keyed),
                  "trace_events": len(trace["traceEvents"]),
                  "trace_written": n_written,
                  "trace_names": sorted({e["name"] for e in trace["traceEvents"]
                                         if not e["name"].startswith("op.")}),
                  "transfer_tags": sorted(payload["transfers"]),
                  "ingested_states": sorted(intro["ingest"]),
                  "restarts": cp_result.restarts,
                  "restarted_sum": sum(v[2] for v in restarted.values),
                  "from_savepoint": sorted(from_savepoint.values),
                  "from_checkpoint": sorted(from_checkpoint.values),
                  "graph_ranks": len(ranks), "graph_components": len(set(comps.values())),
                  "als_users": len(als.user_factors), "knn_rows": len(nearest),
                  "sliding_results": len(windowed["sliding"]),
                  "session_results": len(windowed["session"]),
                  "word_results": len(words),
                  "device_windows_keys": len(dw.fired[0][0]),
                  "fused_results": len(fused),
                  "mesh_results": len(meshed),
                  "generic_results": len(generic),
                  "count_window_results": len(counted),
                  "mesh_engines": sorted(set(mesh_engines)),
                  "sql_columnar_plan": bool(sql_col.columnar),
                  "sql_columnar_rows": len(sql_col_rows.values),
                  "sql_row_rows": len(sql_row_rows.values),
                  "sql_retract_pairs": len(sql_cont_rows.values),
                  "sql_join_rows": len(sql_join_rows.values),
                  "fused_batches": chain_fusion.FUSION_STATS.fused_batches,
                  "demotions": chain_fusion.FUSION_STATS.demotions,
                  "port_runtime_loaded": "flink_tpu_torch/native/_build/" in maps,
                  "reference_runtime_loaded": "libhost_runtime" in maps,
                  "modules": sorted(m for m in sys.modules
                                    if m == "jax" or m.startswith("jax.")
                                    or m == "flink_tpu"
                                    or m.startswith("flink_tpu."))}))
"""


class _SumAgg:
    def create_accumulator(self):
        return 0

    def add(self, v, acc):
        return acc + v[1]

    def get_result(self, acc):
        return acc

    def merge(self, a, b):
        return a + b


def _reference_files(tmp_path):
    """The JAX package's savepoint of a session-window job holding at
    record 300, and its checkpoint directory of a tumbling-window job
    that failed after a checkpoint at record 300; the uninterrupted
    runs' windows and sums for both."""
    import threading

    from flink_tpu.core.functions import AggregateFunction, MapFunction
    from flink_tpu.streaming.datastream import StreamExecutionEnvironment
    from flink_tpu.streaming.sources import CollectSink, FromCollectionSource
    from flink_tpu.streaming.windowing import (EventTimeSessionWindows,
                                              TumblingEventTimeWindows)

    class Agg(_SumAgg, AggregateFunction):
        pass

    class Hold(FromCollectionSource):
        """Holds at record 300; a checkpoint taken there releases it."""
        stop_at = 300
        reached = threading.Event()
        held_cid = None
        released = False

        def emit_step(self, ctx, n):
            if Hold.released:
                return super().emit_step(ctx, n)
            if self.offset >= Hold.stop_at:
                Hold.reached.set()
                return True
            return super().emit_step(ctx, min(n, Hold.stop_at - self.offset))

        def snapshot_function_state(self, checkpoint_id=None):
            if self.offset >= Hold.stop_at:
                Hold.held_cid = checkpoint_id
            return super().snapshot_function_state(checkpoint_id)

        def notify_checkpoint_complete(self, cid):
            if Hold.release_on_checkpoint and cid == Hold.held_cid:
                Hold.released = True

    class Fail(MapFunction):
        def map(self, v):
            if Hold.released:
                raise RuntimeError("stop after a checkpoint")
            return v

    items = [((f"k{i % 5}", 1), 10 * i) for i in range(600)]

    def job(env, assigner, src, failer=None):
        sink = CollectSink()
        stream = env.add_source(src, name="src")
        if failer is not None:
            stream = stream.map(failer, name="failer")
        (stream.key_by(lambda e: e[0]).window(assigner)
            .aggregate(Agg(), lambda k, w, vals: [(k, w.start, v) for v in vals])
            .add_sink(sink))
        return sink

    sessions = EventTimeSessionWindows.with_gap(25)
    env = StreamExecutionEnvironment()
    clean_sessions = job(env, sessions, FromCollectionSource(items, True))
    env.execute()
    Hold.release_on_checkpoint = False
    env = StreamExecutionEnvironment()
    env.enable_checkpointing(60_000)
    before = job(env, sessions, Hold(items, timestamped=True))
    client = env.execute_async()
    assert Hold.reached.wait(60)
    savepoint = client.stop_with_savepoint(str(tmp_path / "sp"))
    client.wait(60)

    Hold.release_on_checkpoint = True
    tumbling = TumblingEventTimeWindows.of(1000)
    env = StreamExecutionEnvironment()
    clean_tumbling = job(env, tumbling, FromCollectionSource(items, True))
    env.execute()
    chk = str(tmp_path / "chk")
    env = StreamExecutionEnvironment()
    env.enable_checkpointing(1)
    env.set_checkpoint_storage("filesystem", directory=chk, retain=2)
    failed_before = job(env, tumbling, Hold(items, timestamped=True), Fail())
    with pytest.raises(RuntimeError, match="stop after a checkpoint"):
        env.execute()
    return (savepoint, chk, sorted(clean_sessions.values), list(before.values),
            sorted(clean_tumbling.values), list(failed_before.values))


def test_job_loads_neither_jax_nor_flink_tpu(tmp_path):
    (savepoint, chk, clean_sessions, before_sp, clean_tumbling,
     before_chk) = _reference_files(tmp_path)
    proc = subprocess.run([sys.executable, "-c", _JOB, savepoint, chk],
                          cwd=ROOT, capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    # the port's checkpointed job restarted once and counted each record
    # once; the JAX package's files restored jobs of the port, whose
    # output joins the JAX jobs' output before the cut to the
    # uninterrupted runs'
    assert report["restarts"] == 1 and report["restarted_sum"] == 600
    assert sorted(before_sp + [tuple(v) for v in report["from_savepoint"]]) \
        == clean_sessions
    assert sorted(before_chk + [tuple(v) for v in report["from_checkpoint"]]) \
        == clean_tumbling
    assert report["results"] == 2 * 7 * 5
    assert report["keyed_results"] == 7 * 5
    # 5 s of events in 2 s windows sliding by 1 s; one session a key
    assert report["sliding_results"] == 7 * 6
    assert report["session_results"] == 7
    assert report["word_results"] == 7 * 5
    assert report["device_windows_keys"] == 9
    # 20.48 s of events in 1 s windows, 7 keys; four batches fused
    assert report["fused_results"] == 7 * 21
    assert report["fused_batches"] == 4 and report["demotions"] == 0
    assert report["mesh_results"] == 7 * 5
    assert report["generic_results"] == 7 * 5
    # 500 records over 7 keys: 71 or 72 a key, 7 full windows of 10 each
    assert report["count_window_results"] == 7 * 7
    assert report["mesh_engines"] == ["MeshLogTumblingWindows"]
    # the SQL jobs: config #5 on the columnar plan (9 keys, 3 windows),
    # the row plan's windowed and continuous GROUP BY (2 x 300 - 7
    # retract pairs) and the interval join (a key recurs every 70 ms, so
    # within 10 ms each row pairs only with itself)
    assert report["sql_columnar_plan"]
    assert report["sql_columnar_rows"] == 9 * 3
    assert report["sql_row_rows"] == 7 * 3
    assert report["sql_retract_pairs"] == 2 * 300 - 7
    assert report["sql_join_rows"] == 300
    assert report["graph_ranks"] == 200 and report["graph_components"] >= 1
    assert report["als_users"] == 60 and report["knn_rows"] == 6
    # the log tier ran on the port's own host runtime, never the
    # reference's library; no flink_tpu module (flink_tpu.native
    # included) was imported
    assert report["port_runtime_loaded"]
    assert not report["reference_runtime_loaded"]
    assert report["modules"] == []
    # the plane was on throughout: the trace file parses and holds the
    # layers' spans, the ledger saw the device engines' copies
    assert report["trace_events"] == report["trace_written"] > 0
    for name in ("device_window.flush", "device_window.fire",
                 "device.transfer", "window.fire.batch", "checkpoint.trigger",
                 "checkpoint.barrier", "checkpoint.complete"):
        assert name in report["trace_names"], name
    assert any(n.startswith("native.") for n in report["trace_names"])
    assert {"h2d.chain.boundary", "d2h.chain.boundary",
            "h2d.state.flush"} <= set(report["transfer_tags"])
    assert report["ingested_states"]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_sources_import_neither_jax_nor_flink_tpu():
    files = sorted((ROOT / "flink_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    assert ROOT / "flink_tpu_torch" / "native" / "__init__.py" in files
    for module in ("analysis/liftability.py", "streaming/columnar.py",
                   "streaming/chain_fusion.py", "kernels/chain_route.py",
                   "graph/library.py", "ml/recommendation.py",
                   "kernels/knn_topk.py", "kernels/shard_pack.py",
                   "parallel/mesh.py", "parallel/mesh_log.py",
                   "streaming/generic_agg.py", "runtime/checkpoints.py",
                   "runtime/faults.py", "runtime/failover.py",
                   "runtime/chaos.py", "core/fs.py", "state/portable.py",
                   "state/shared_registry.py", "runtime/tracing.py",
                   "runtime/device_stats.py", "runtime/metrics.py",
                   "runtime/timeseries.py", "runtime/backpressure.py",
                   "runtime/profiler.py", "state/introspect.py",
                   "state/stats.py", "table/api.py", "table/sql_parser.py",
                   "table/expressions.py", "table/functions.py",
                   "table/__init__.py", "streaming/joining.py"):
        assert ROOT / "flink_tpu_torch" / module in files
    bad = [(f.name, mod) for f in files for mod in _imports(f)
           if mod.split(".")[0] in ("jax", "jaxlib", "flink_tpu")]
    assert bad == []
    # nothing in the port names the JAX package's native library; the
    # port's loader builds its own copy of the C++ beside itself
    native = ROOT / "flink_tpu_torch" / "native"
    assert (native / "host_runtime.cpp").is_file()
    for f in files + [native / "host_runtime.cpp"]:
        assert "libhost_runtime" not in f.read_text(), f


def test_gitignore_lists_the_host_runtime_build():
    lines = (ROOT / ".gitignore").read_text().split()
    assert "flink_tpu_torch/native/_build/" in lines
    assert "flink_tpu_torch/kernels/_build/" in lines


def test_entry_points_raise_without_a_card(monkeypatch):
    from flink_tpu_torch.ops.sketches import HyperLogLogAggregate
    from flink_tpu_torch.streaming.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.streaming.vectorized import VectorizedTumblingWindows
    from flink_tpu_torch.ops.device_table import make_table
    from flink_tpu_torch.parallel import Mesh
    from flink_tpu_torch.streaming.device_windows import DeviceTumblingWindows
    from flink_tpu_torch.streaming.log_windows import (
        LogStructuredTumblingWindows, StringSumTumblingWindows)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    agg = HyperLogLogAggregate(8)
    for call in (StreamExecutionEnvironment.get_execution_environment,
                 lambda: VectorizedTumblingWindows(agg, 1000, initial_capacity=8),
                 lambda: agg.init_state(8),
                 lambda: LogStructuredTumblingWindows(agg, 1000),
                 lambda: StringSumTumblingWindows(agg, 1000),
                 lambda: DeviceTumblingWindows(agg, 1000, capacity=8),
                 lambda: make_table(8), lambda: Mesh([None] * 2)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    # asked for explicitly, the CPU runs the plain versions
    assert agg.init_state(8, device="cpu")["regs"].device.type == "cpu"


def test_kernels_need_nothing_at_import(monkeypatch):
    from flink_tpu_torch.kernels import loader
    assert set(loader.LAUNCHES) == set(loader.KERNELS)
    monkeypatch.setattr(loader, "CUDA_ROOTS", ())
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    with pytest.raises(RuntimeError, match="nvcc"):
        loader.nvcc_path()


_C_TYPES = {"void*": "c_void_p", "long long": "c_longlong", "int": "c_int",
            "float": "c_float", "double": "c_double",
            "unsigned long long": "c_ulonglong"}


def test_ctypes_signatures_match_the_cuda_sources():
    """The loader's argtypes for each exported launcher are those of its
    extern "C" declaration (a mismatch shows only as a failed call on
    the card)."""
    import ctypes
    import re
    from flink_tpu_torch.kernels import loader
    csrc = ROOT / "flink_tpu_torch" / "kernels" / "csrc"
    for name, fns in loader._SIGNATURES.items():
        src = (csrc / f"{name}.cu").read_text()
        decls = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src))
        assert set(decls) == set(fns), name
        for fn, argtypes in fns.items():
            params = [re.sub(r"\s+", " ", p.replace("const ", "")).strip()
                      for p in decls[fn].split(",")]
            ctypes_of = [getattr(ctypes, _C_TYPES["void*" if "*" in p
                                                  else p.rsplit(" ", 1)[0]])
                         for p in params]
            assert ctypes_of == list(argtypes), fn
