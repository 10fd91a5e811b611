"""The port's boundary: flink_tpu_torch (and chip_smoke.py) never load
jax or any module of flink_tpu, and its entry points never fall back to
the CPU on their own.  This test process has jax loaded already (the
test configuration imports it), so the import check runs a job in a
fresh interpreter."""

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
import flink_tpu_torch.state, flink_tpu_torch.streaming.harness
print(json.dumps({"results": len(out), "keyed_results": len(keyed),
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
    bad = [(f.name, mod) for f in files for mod in _imports(f)
           if mod.split(".")[0] in ("jax", "jaxlib", "flink_tpu")]
    assert bad == []


def test_entry_points_raise_without_a_card(monkeypatch):
    from flink_tpu_torch.ops.sketches import HyperLogLogAggregate
    from flink_tpu_torch.streaming.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.streaming.vectorized import VectorizedTumblingWindows
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    agg = HyperLogLogAggregate(8)
    for call in (StreamExecutionEnvironment.get_execution_environment,
                 lambda: VectorizedTumblingWindows(agg, 1000, initial_capacity=8),
                 lambda: agg.init_state(8)):
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
            "float": "c_float", "unsigned long long": "c_ulonglong"}


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
