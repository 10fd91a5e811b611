"""The port's boundary: flink_tpu_torch (and chip_smoke.py) never load
jax, any module of flink_tpu or the JAX package's native library (a
subprocess job runs the log tier, the keyed backend, the sliding and
session log engines, the fused string sum, a DeviceTumblingWindows
batch, a fused map/filter chain ahead of a window at parallelism 4,
graph algorithms and an ML fit, then reads its own sys.modules and
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
out = []
for agg in (HyperLogLogAggregate(8), SumAggregate(np.float64)):
    agg.extract_value = lambda e: e[1]
    env = StreamExecutionEnvironment.get_execution_environment(device="cpu")
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
maps = open("/proc/self/maps").read()
print(json.dumps({"results": len(out), "keyed_results": len(keyed),
                  "graph_ranks": len(ranks), "graph_components": len(set(comps.values())),
                  "als_users": len(als.user_factors), "knn_rows": len(nearest),
                  "sliding_results": len(windowed["sliding"]),
                  "session_results": len(windowed["session"]),
                  "word_results": len(words),
                  "device_windows_keys": len(dw.fired[0][0]),
                  "fused_results": len(fused),
                  "fused_batches": chain_fusion.FUSION_STATS.fused_batches,
                  "demotions": chain_fusion.FUSION_STATS.demotions,
                  "port_runtime_loaded": "flink_tpu_torch/native/_build/" in maps,
                  "reference_runtime_loaded": "libhost_runtime" in maps,
                  "modules": sorted(m for m in sys.modules
                                    if m == "jax" or m.startswith("jax.")
                                    or m == "flink_tpu"
                                    or m.startswith("flink_tpu."))}))
"""


def test_job_loads_neither_jax_nor_flink_tpu():
    proc = subprocess.run([sys.executable, "-c", _JOB], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
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
    assert report["graph_ranks"] == 200 and report["graph_components"] >= 1
    assert report["als_users"] == 60 and report["knn_rows"] == 6
    # the log tier ran on the port's own host runtime, never the
    # reference's library; no flink_tpu module (flink_tpu.native
    # included) was imported
    assert report["port_runtime_loaded"]
    assert not report["reference_runtime_loaded"]
    assert report["modules"] == []


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
                   "kernels/knn_topk.py"):
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
                 lambda: make_table(8)):
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
