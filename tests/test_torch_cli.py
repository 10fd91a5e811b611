"""The port's command line (``python -m flink_tpu_torch``, ``cli.py``)
against the JAX package's (``flink_tpu/cli.py``): ``lint --json`` on the
same job script written once for each package (payloads equal with the
package name normalised), the exit codes of ``lint`` / ``--strict`` /
``--check-imports``, ``config-docs`` rows for every key the port reads,
``info``, ``run``, ``state inspect`` on a port checkpoint, ``profile``
writing a Chrome trace, and the verbs that wait for the port's cluster
runtime and benchmark (exit 2).  Most cases call each package's
``cli.main`` in this process; one runs ``python -m flink_tpu_torch`` as
a subprocess."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from test_torch_analysis import bad_script, good_script, write_scripts
from torch_analysis_util import norm_obj, pkgs

J, T = pkgs()
ROOT = Path(__file__).resolve().parents[1]


def _cli(P):
    import importlib
    return importlib.import_module(f"{P.name}.cli")


def _main(P, args, capsys):
    rc = _cli(P).main(list(args))
    out = capsys.readouterr()
    return rc, out.out, out.err


def seeded_script(pkg, device):
    """FT185 and FT187 seeds (warnings under --types)."""
    return textwrap.dedent(f"""
        import numpy as np
        from {pkg}.core.config import Configuration
        from {pkg}.ops.device_agg import SumAggregate
        from {pkg}.streaming.columnar import VectorizedCollectionSource
        from {pkg}.streaming.datastream import StreamExecutionEnvironment
        from {pkg}.streaming.sources import CollectSink
        from {pkg}.streaming.windowing import Time

        class TupleSum(SumAggregate):
            def __init__(self):
                super().__init__(np.float32)

            def extract_value(self, value):
                return value[1]

        conf = Configuration()
        conf.set("state.backend.tpu.max-device-slots", 16)
        env = StreamExecutionEnvironment(conf, {device})
        env.add_source(VectorizedCollectionSource([1, 2, 3, 4])) \\
           .map(lambda x: x > 2).rebalance().add_sink(CollectSink())
        recs = [((k, 1.0), k) for k in range(64)]
        (env.from_collection(recs, timestamped=True)
            .key_by(lambda t: t[0])
            .time_window(Time.seconds(1))
            .aggregate(TupleSum())
            .add_sink(CollectSink()))
        print("building done")
        env.execute("seeded-job")
    """)


def _payload(out):
    return json.loads(out[out.index("["):])


def _strip_paths(payload, base):
    for entry in payload:
        if "script" in entry:
            entry["script"] = os.path.relpath(entry["script"], base)
    return payload


@pytest.mark.parametrize("maker,flags", [
    (good_script, []), (bad_script, []),
    (seeded_script, ["--types"]), (seeded_script, ["--types", "--strict"])],
    ids=["good", "bad", "types", "types-strict"])
def test_lint_json_payload_equals_reference(tmp_path, capsys, maker, flags):
    paths = write_scripts(tmp_path, maker, maker.__name__)
    got = {}
    for P in (J, T):
        rc, out, err = _main(P, ["lint", "--json", *flags, paths[P.name]],
                             capsys)
        payload = _strip_paths(_payload(out), str(tmp_path / P.name))
        got[P.name] = (rc, norm_obj(payload))
        if maker is seeded_script:
            assert "building done" in err   # the script's print
    assert got["flink_tpu_torch"] == got["flink_tpu"]
    rc, payload = got["flink_tpu_torch"]
    codes = [d["code"] for e in payload for j in e["jobs"]
             for d in j["diagnostics"]]
    if maker is bad_script:
        assert rc == 1 and "FT101" in codes
    elif maker is seeded_script:
        assert "FT185" in codes and "FT187" in codes
        assert rc == (1 if "--strict" in flags else 0)
        tf = payload[0]["jobs"][0]["typeflow"]
        assert tf["summary"]["pickle_edges"] == 1
        assert any(e["codec_tier"] == "pickle" for e in tf["edges"])
    else:
        assert rc == 0 and payload[0]["script_error"] is None


def test_lint_text_and_exit_codes(tmp_path, capsys):
    paths = write_scripts(tmp_path, good_script, "good_job")
    rc, out, _ = _main(T, ["lint", paths["flink_tpu_torch"]], capsys)
    assert rc == 0 and "0 error(s)" in out and "good-job" in out
    rc, _, err = _main(T, ["lint"], capsys)
    assert rc == 2 and "usage" in err
    # a directory: every script in it
    d = tmp_path / "flink_tpu_torch"
    (d / "bad_job.py").write_text(bad_script("flink_tpu_torch",
                                             'device="cpu"'))
    rc, out, _ = _main(T, ["lint", str(d)], capsys)
    assert rc == 1 and out.count("== ") == 2
    rc, _, err = _main(T, ["lint", str(d), "extra"], capsys)
    assert rc == 2


def test_lint_check_imports_exit_codes(tmp_path, capsys):
    d = tmp_path / "pkg"
    d.mkdir()
    (d / "_mod.py").write_text("import os\nimport sys\nprint(sys.path)\n")
    (d / "clean.py").write_text("import sys\nprint(sys.argv)\n")
    for P in (J, T):
        rc, out, _ = _main(P, ["lint", "--check-imports", str(d)], capsys)
        assert rc == 0 and "unused import 'os'" in out
        rc, out, _ = _main(P, ["lint", "--check-imports", "--strict",
                               str(d)], capsys)
        assert rc == 1
        rc, out, _ = _main(P, ["lint", "--check-imports", "--strict",
                               str(d / "clean.py")], capsys)
        assert rc == 0
    rc, out, _ = _main(T, ["lint", "--check-imports", "--json",
                           str(d / "_mod.py")], capsys)
    assert _payload(out)[-1]["unused_imports"][0]["name"] == "os"


def test_config_docs_rows_equal_reference(capsys):
    _, jout, _ = _main(J, ["config-docs"], capsys)
    _, tout, _ = _main(T, ["config-docs"], capsys)

    def rows(md):
        return {line.split("|")[1].strip().strip("`"): line
                for line in md.splitlines() if line.startswith("| `")}
    jrows, trows = rows(jout), rows(tout)
    assert set(trows) == set(T.config.KNOWN_KEYS)
    assert {k: trows[k] for k in trows} == {k: jrows[k] for k in trows}


def test_info(capsys):
    rc, out, _ = _main(T, ["info"], capsys)
    assert rc == 0
    assert out.startswith("flink_tpu_torch ")
    assert "torch " in out and "host runtime:" in out


def test_run(tmp_path, capsys):
    script = tmp_path / "job.py"
    out_file = tmp_path / "out.json"
    script.write_text(textwrap.dedent(f"""
        import json, sys
        from flink_tpu_torch.streaming.datastream import \\
            StreamExecutionEnvironment
        from flink_tpu_torch.streaming.sources import CollectSink
        env = StreamExecutionEnvironment(device="cpu")
        sink = CollectSink()
        env.from_collection([1, 2, 3]).map(lambda x: x * 10).add_sink(sink)
        env.execute("run-job")
        json.dump([sys.argv[1:], sink.values], open({str(out_file)!r}, "w"))
    """))
    rc, _, _ = _main(T, ["run", str(script), "a", "b"], capsys)
    assert rc == 0
    assert json.loads(out_file.read_text()) == [["a", "b"], [10, 20, 30]]
    assert _main(T, ["run"], capsys)[0] == 2


def test_state_inspect_on_a_port_checkpoint(tmp_path, capsys):
    from flink_tpu_torch.core.state import AggregatingStateDescriptor
    from flink_tpu_torch.ops.device_agg import SumAggregate
    from flink_tpu_torch.runtime.checkpoints import FsCheckpointStorage
    from flink_tpu_torch.streaming.elements import RecordBatch
    from flink_tpu_torch.streaming.harness import \
        OneInputStreamOperatorTestHarness
    from flink_tpu_torch.streaming.window_operator import WindowOperator
    from flink_tpu_torch.streaming.windowing import TumblingEventTimeWindows

    class KV(SumAggregate):
        def extract_value(self, v):
            return v[1]

    rng = np.random.default_rng(17)
    keys = rng.integers(0, 23, 400)
    op = WindowOperator(TumblingEventTimeWindows.of(10_000),
                        AggregatingStateDescriptor("w-sum", KV(np.float64)))
    h = OneInputStreamOperatorTestHarness(op, key_selector=lambda x: x[0],
                                          state_backend="gpu", device="cpu")
    h.open()
    h.process_batch(RecordBatch({"f0": keys,
                                 "f1": np.ones(400, np.float64)},
                                ts=np.arange(400, dtype=np.int64)))
    d = str(tmp_path / "chk")
    FsCheckpointStorage(d, retain=2).persist(3, {"timestamp": 1},
                                             {(0, 0): h.snapshot()})
    reports = {}
    for P in (J, T):
        rc, out, _ = _main(P, ["state", "inspect", d, "--json",
                               "--parallelism", "4", "--top", "3"], capsys)
        assert rc == 0
        reports[P.name] = json.loads(out)
    t, j = reports["flink_tpu_torch"], reports["flink_tpu"]
    assert t["backends"] == j["backends"] == ["gpu"]
    assert t["states"] == j["states"] and t["rescale"] == j["rescale"]
    assert t["states"]["w-sum"]["rows"] == len(set(keys.tolist()))
    rc, out, _ = _main(T, ["state", "inspect", d], capsys)
    assert rc == 0 and "state 'w-sum'" in out and "rescale" not in out
    rc, _, err = _main(T, ["state", "inspect", str(tmp_path / "none")],
                       capsys)
    assert rc == 1 and "state inspect" in err
    assert _main(T, ["state"], capsys)[0] == 2


def test_profile_writes_a_chrome_trace(tmp_path, capsys):
    from flink_tpu_torch.runtime import tracing
    script = tmp_path / "job.py"
    script.write_text(textwrap.dedent("""
        from flink_tpu_torch.streaming.datastream import \\
            StreamExecutionEnvironment
        from flink_tpu_torch.streaming.sources import CollectSink
        env = StreamExecutionEnvironment(device="cpu")
        env.from_collection(list(range(200))).map(lambda x: x + 1) \\
            .key_by(lambda x: x % 3).reduce(lambda a, b: a + b) \\
            .add_sink(CollectSink())
        env.execute("profiled")
    """))
    trace = tmp_path / "t.json"
    folded = tmp_path / "p.folded"
    try:
        rc, _, err = _main(T, ["profile", "--trace-out", str(trace),
                               "--flame-out", str(folded), str(script)],
                           capsys)
    finally:
        tracing.get_tracer().enabled = False
    assert rc == 0
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("op.") for e in events)
    assert folded.exists() and "-- flame:" in err and "-- trace:" in err
    assert _main(T, ["profile"], capsys)[0] == 2
    assert _main(T, ["profile", "--flame-hz", "x", str(script)], capsys)[0] == 2


@pytest.mark.parametrize("verb", ["top", "list", "cancel", "savepoint",
                                  "stop", "jobmanager", "taskmanager",
                                  "bench"])
def test_verbs_not_in_the_port_exit_2(verb, capsys):
    rc, _, err = _main(T, [verb, "--master", "127.0.0.1:1"], capsys)
    assert rc == 2 and "not in the port yet" in err


def test_shell_master_exits_2_and_unknown_verb(capsys):
    rc, _, err = _main(T, ["shell", "--master", "127.0.0.1:1"], capsys)
    assert rc == 2 and "not in the port yet" in err
    rc, _, err = _main(T, ["frobnicate"], capsys)
    assert rc == 2 and "unknown command" in err
    rc, out, _ = _main(T, ["--help"], capsys)
    assert rc == 0 and "lint" in out


def test_module_entry_point(tmp_path):
    """``python -m flink_tpu_torch lint --json`` in a fresh interpreter:
    exit 1 on the bad script, and the port alone is imported."""
    paths = write_scripts(tmp_path, bad_script, "bad_job")
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys, runpy; sys.argv = ['flink_tpu_torch'] + sys.argv[1:];"
         "rc = 0\n"
         "try:\n    runpy.run_module('flink_tpu_torch', run_name='__main__')\n"
         "except SystemExit as e:\n    rc = e.code\n"
         "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
         " or m == 'flink_tpu' or m.startswith('flink_tpu.')]\n"
         "print('LOADED', bad, file=sys.stderr); sys.exit(rc)",
         "lint", "--json", paths["flink_tpu_torch"]],
        capture_output=True, text=True, timeout=240, cwd=str(ROOT),
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert r.returncode == 1, r.stderr[-2000:]
    assert "LOADED []" in r.stderr
    codes = [d["code"] for e in _payload(r.stdout) for j in e["jobs"]
             for d in j["diagnostics"]]
    assert "FT101" in codes
