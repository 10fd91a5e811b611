"""The port's pre-flight static analysis (``flink_tpu_torch/analysis``)
against the JAX package's (``flink_tpu/analysis``), case for case of
``tests/test_analysis.py``: the liftability verdicts, every FT code's
job, ``strict`` raising and ``warn`` executing, the lint gauges,
``lint_script``, the unused-import checker, the diagnostics' ordering
and counts, and the code catalog.  Each job is written once and built
in both packages; their reports compare as (code, severity, operator
id, operator name, message, hint, location) with the package name
normalised (``torch_analysis_util.norm``)."""

import textwrap

import numpy as np
import pytest

from torch_analysis_util import diag_rows, norm, pkgs

J, T = pkgs()


# ---------------------------------------------------------------------
# liftability verdicts (pass 2)
# ---------------------------------------------------------------------

_COUNTER = 0


def _global_write(x):
    global _COUNTER
    _COUNTER += 1
    return x


def _make_nonlocal():
    total = 0.0

    def f(x):
        nonlocal total
        total += x
        return total
    return f


def _local_capture(x):
    y = x + 1
    g = lambda: y   # noqa: E731 — forces y into a cell
    return g()


def _loop(xs):
    total = 0.0
    for x in xs:
        total += x
    return total


class _Opaque:
    def __call__(self, a):
        return a


_FLAG = True
_OPAQUE = _Opaque()


def _udfs():
    import random
    return [
        _global_write,
        _make_nonlocal(),
        lambda x: print(x),
        lambda x: x + random.random(),
        _local_capture,
        lambda x: 1.0 if x > 0 else -1.0,
        lambda x: x + 1 if _FLAG else x - 1,
        lambda x: _OPAQUE(x),
        lambda x: np.maximum(np.sqrt(x), 0.0) * 2 + 1,
        _loop,
        lambda t: (t[0], t[1] * 2.0),
        lambda x: np.where(x > 3, x, -x),
    ]


@pytest.mark.parametrize("idx", range(12))
def test_udf_verdicts_equal_reference(idx):
    fn = _udfs()[idx]
    jr = J.analysis.analyze_udf(fn)
    tr = T.analysis.analyze_udf(fn)
    assert tr.verdict == jr.verdict
    assert [norm(r) for r in tr.reasons] == [norm(r) for r in jr.reasons]
    assert tr.location == jr.location


def _aggregate_classes(P):
    AF = P.functions.AggregateFunction

    class Logging(AF):
        def create_accumulator(self):
            return 0.0

        def add(self, v, acc):
            print("v", v)
            return acc + v

        def get_result(self, acc):
            return acc

        def merge(self, a, b):
            return a + b

    class Stateful(AF):
        def __init__(self):
            self.seen = 0

        def create_accumulator(self):
            return 0.0

        def add(self, v, acc):
            self.seen += 1
            return acc + v

        def get_result(self, acc):
            return acc

        def merge(self, a, b):
            return a + b

    class Summing(AF):
        def create_accumulator(self):
            return 0.0

        def add(self, v, acc):
            return acc + v[1]

        def get_result(self, acc):
            return acc

        def merge(self, a, b):
            return a + b

    class Branchy(AF):
        def create_accumulator(self):
            return 0.0

        def add(self, v, acc):
            return acc + v[1] if v[1] > 0 else acc

        def get_result(self, acc):
            return acc

        def merge(self, a, b):
            return a + b

    class Timestamping(AF):
        def create_accumulator(self):
            return 0.0

        def add(self, v, acc):
            import time
            return acc + v + 0 * time.time()

        def get_result(self, acc):
            return acc

        def merge(self, a, b):
            return a + b

    return {"logging": Logging, "stateful": Stateful, "summing": Summing,
            "branchy": Branchy, "timestamping": Timestamping}


@pytest.mark.parametrize("name", ["logging", "stateful", "summing",
                                  "branchy", "timestamping"])
def test_aggregate_verdicts_equal_reference(name):
    jr = J.analysis.analyze_aggregate(_aggregate_classes(J)[name]())
    tr = T.analysis.analyze_aggregate(_aggregate_classes(T)[name]())
    assert tr.verdict == jr.verdict
    assert [norm(r) for r in tr.reasons] == [norm(r) for r in jr.reasons]
    assert tr.result_liftable == jr.result_liftable


# ---------------------------------------------------------------------
# the graph linter on deliberately broken jobs, in both packages
# ---------------------------------------------------------------------

def _sink(P):
    return P.sources.CollectSink()


def job_clean(P):
    env = P.env()
    env.from_collection([1, 2, 3]).map(lambda x: x + 1).add_sink(_sink(P))
    return env


def job_ft101(P):
    env = P.env()
    (env.from_collection([(1, 2.0)], timestamped=False)
        .key_by(lambda x: [x[0]])
        .reduce(lambda a, b: a)
        .add_sink(_sink(P)))
    return env


def job_ft110(P):
    W = P.windowing
    env = P.env()
    (env.from_collection([((1, 1.0), 10)], timestamped=True)
        .key_by(lambda x: x[0])
        .window(W.EventTimeSessionWindows.with_gap(100))
        .trigger(W.DeltaTrigger(1.0, lambda a, b: abs(a[1] - b[1])))
        .disable_device_operator()
        .reduce(lambda a, b: a)
        .add_sink(_sink(P)))
    return env


def job_ft111(P):
    W = P.windowing
    env = P.env()
    (env.from_collection([((1, 1.0), 10)], timestamped=True)
        .key_by(lambda x: x[0])
        .window(W.EventTimeSessionWindows.with_gap(0))
        .reduce(lambda a, b: a)
        .add_sink(_sink(P)))
    return env


def job_ft112(P):
    W = P.windowing
    env = P.env()
    (env.from_collection([((1, 1.0), 10)], timestamped=True)
        .key_by(lambda x: x[0])
        .window(W.TumblingEventTimeWindows.of(10))
        .allowed_lateness(50)
        .reduce(lambda a, b: a)
        .add_sink(_sink(P)))
    return env


def job_ft113(P):
    W = P.windowing
    env = P.env()
    (env.from_collection([((1, 1.0), 10)], timestamped=True)
        .key_by(lambda x: x[0])
        .window(W.SlidingEventTimeWindows.of(10, 3))
        .reduce(lambda a, b: a)
        .add_sink(_sink(P)))
    (env.from_collection([((1, 1.0), 10)], timestamped=True)
        .key_by(lambda x: x[0])
        .window(W.TumblingEventTimeWindows.of(10, 4))
        .reduce(lambda a, b: a)
        .add_sink(_sink(P)))
    return env


def job_ft115(P):
    W = P.windowing
    env = P.env()
    (env.from_collection([(1, 1.0)], timestamped=False)
        .key_by(lambda x: x[0])
        .window(W.TumblingEventTimeWindows.of(10))
        .reduce(lambda a, b: a)
        .add_sink(_sink(P)))
    return env


def job_ft150_ft151(P):
    env = P.env()
    env.from_collection([1, 2]).map(lambda x: x + 1)   # no sink
    g = env.graph
    nid = g.new_node_id()
    g.add_node(P.graph.StreamNode(
        nid, "island",
        lambda: P.operators.StreamMap(
            P.functions.as_map_function(lambda x: x))))
    return env


def job_ft160(P):
    env = P.env()
    ds = env.from_collection([1, 2]).map(lambda x: x + 1)
    tail = ds.map(lambda x: x * 2)
    tail.add_sink(_sink(P))
    env.graph.add_edge(P.graph.StreamEdge(
        tail.node.id, ds.node.id, P.partitioners.ForwardPartitioner()))
    return env


def job_declared_iteration(P):
    env = P.env()
    it = env.from_collection([1, 2, 3]).iterate()
    body = it.map(lambda x: x - 1)
    out = it.close_with(body.filter(lambda x: x > 0))
    out.add_sink(_sink(P))
    return env


def job_ft170_ft171(P):
    env = P.env()
    a = env.from_collection([1]).map(lambda x: x).uid("same")
    a.map(lambda x: x).uid("same").add_sink(_sink(P))
    return env


def job_ft130(P):
    env = P.env()
    ds = env.from_collection([1, 2]).map(lambda x: x + 1)
    ds.add_sink(_sink(P))
    ds.node.chaining_strategy = "never"
    return env


def job_ft131(P):
    env = P.env()
    d2 = env.from_collection([1, 2]).map(lambda x: x + 1)
    d2.node.parallelism = 4
    d2.add_sink(_sink(P))
    return env


def job_ft180_ft183(P):
    W = P.windowing
    env = P.env()
    (env.from_collection([((1, 1.0), 10)], timestamped=True)
        .key_by(lambda x: x[0])
        .window(W.TumblingEventTimeWindows.of(100))
        .aggregate(_aggregate_classes(P)["timestamping"]())
        .add_sink(_sink(P)))
    env.from_collection([1]).map(lambda x: print(x)).add_sink(_sink(P))
    return env


def job_ft181(P):
    W = P.windowing
    env = P.env()
    (env.from_collection([((1, 1.0), 10)], timestamped=True)
        .key_by(lambda x: x[0])
        .window(W.TumblingEventTimeWindows.of(100))
        .aggregate(_aggregate_classes(P)["branchy"]())
        .add_sink(_sink(P)))
    return env


def job_ft182(P):
    W = P.windowing
    env = P.env()
    (env.from_collection([((1, 1.0), 10)], timestamped=True)
        .key_by(lambda x: x[0])
        .window(W.TumblingEventTimeWindows.of(100))
        .aggregate(_aggregate_classes(P)["summing"]())
        .add_sink(_sink(P)))
    return env


def job_ft140(P):
    env = P.env()
    (env.from_collection([(1, 2.0)], timestamped=False)
        .key_by(lambda x: x[0])
        .reduce(lambda a, b: (a[0], a[1] + b[1]))
        .add_sink(_sink(P)))
    env.socket_text_stream("localhost", 9) \
        .key_by(lambda x: x).reduce(lambda a, b: a).add_sink(_sink(P))
    return env


def job_ft184(P):
    env = P.env()
    (env.add_source(P.columnar.VectorizedCollectionSource(list(range(10))))
        .map(lambda v: v + 1).filter(lambda v: v > 2)
        .map(lambda v: v * 2 if v else v)
        .add_sink(_sink(P)))
    (env.add_source(P.columnar.VectorizedCollectionSource(list(range(10))))
        .map(lambda v: v * 3).add_sink(_sink(P)))
    return env


def job_ft190(P):
    env = P.env()
    ds = env.from_collection([1, 2]).map(lambda x: x + 1)
    ds.add_sink(_sink(P))

    def boom():
        raise RuntimeError("factory exploded")
    ds.node.operator_factory = boom
    return env


def job_hll_window(P):
    """A device HLL window on timestamped pairs (the north-star shape)."""
    agg = P.sketches.HyperLogLogAggregate(8)
    agg.extract_value = lambda e: e[1]
    W = P.windowing
    env = P.env()
    (env.from_collection([((i % 7, i), 10 * i) for i in range(50)],
                         timestamped=True)
        .key_by(lambda e: e[0])
        .window(W.TumblingEventTimeWindows.of(1000))
        .aggregate(agg)
        .add_sink(_sink(P)))
    return env


JOBS = {f.__name__[4:]: f for f in (
    job_clean, job_ft101, job_ft110, job_ft111, job_ft112, job_ft113,
    job_ft115, job_ft150_ft151, job_ft160, job_declared_iteration,
    job_ft170_ft171, job_ft130, job_ft131, job_ft180_ft183, job_ft181,
    job_ft182, job_ft140, job_ft184, job_ft190, job_hll_window)}

#: the codes each job must raise in both packages (beyond equality)
EXPECTED = {
    "clean": set(), "ft101": {"FT101"}, "ft110": {"FT110"},
    "ft111": {"FT111"}, "ft112": {"FT112"}, "ft113": {"FT113"},
    "ft115": {"FT115"}, "ft150_ft151": {"FT150", "FT151"},
    "ft160": {"FT160"}, "declared_iteration": set(),
    "ft170_ft171": {"FT170", "FT171"}, "ft130": {"FT130"},
    "ft131": {"FT131"}, "ft180_ft183": {"FT180", "FT183"},
    "ft181": {"FT181"}, "ft182": {"FT182"}, "ft140": {"FT140"},
    "ft184": {"FT184"}, "ft190": {"FT190"}, "hll_window": set(),
}


@pytest.mark.parametrize("name", sorted(JOBS))
def test_lint_report_equals_reference(name):
    jrep = JOBS[name](J).validate()
    trep = JOBS[name](T).validate()
    assert diag_rows(trep) == diag_rows(jrep)
    assert trep.counts() == jrep.counts()
    assert EXPECTED[name] <= set(trep.codes())
    if name in ("clean", "declared_iteration"):
        assert "FT160" not in trep.codes() and not trep.has_errors()
    assert "FT199" not in trep.codes()


@pytest.mark.parametrize("name", ["ft101", "ft131", "ft184", "hll_window"])
def test_lint_graph_types_equals_reference(name):
    """lint_graph with the type-flow pass on (FT184 names the boxing
    edge's schema then)."""
    jenv, tenv = JOBS[name](J), JOBS[name](T)
    jrep = J.analysis.lint_graph(jenv.graph, config=jenv.config, types=True)
    trep = T.analysis.lint_graph(tenv.graph, config=tenv.config, types=True)
    assert diag_rows(trep) == diag_rows(jrep)
    assert trep.typeflow.summary() == jrep.typeflow.summary()


def test_every_emitted_code_is_catalogued():
    assert T.analysis.CODES == J.analysis.CODES
    for name in JOBS:
        for d in JOBS[name](T).validate():
            assert d.code in T.analysis.CODES


def test_chain_rejection_reasons_equal_reference():
    for name in ("ft130", "ft131", "ft140", "ft160", "declared_iteration"):
        jenv, tenv = JOBS[name](J), JOBS[name](T)
        jr = [J.graph.chain_rejection_reasons(e, jenv.graph)
              for e in jenv.graph.edges]
        tr = [T.graph.chain_rejection_reasons(e, tenv.graph)
              for e in tenv.graph.edges]
        assert tr == jr


# ---------------------------------------------------------------------
# validate()/execute() wiring
# ---------------------------------------------------------------------

def _broken(P, conf=None):
    env = P.env(conf)
    sink = P.sources.CollectSink()
    (env.from_collection([(1, 2.0)])
        .key_by(lambda x: [x[0]])
        .reduce(lambda a, b: a)
        .add_sink(sink))
    return env


@pytest.mark.parametrize("P", [J, T], ids=["jax", "port"])
def test_strict_mode_raises_before_any_executor(P):
    env = _broken(P, P.conf({"lint.mode": "strict"}))
    with pytest.raises(P.analysis.JobValidationError) as ei:
        env.execute("strict-job")
    assert any(d.code == "FT101" for d in ei.value.report.errors())
    assert env._last_executor is None    # refused before the executor
    assert "FT101" in env._last_validation.codes()


def test_strict_reports_equal_reference():
    reports = []
    for P in (J, T):
        env = _broken(P, P.conf({"lint.mode": "strict"}))
        with pytest.raises(P.analysis.JobValidationError) as ei:
            env.execute("strict-job")
        reports.append(ei.value.report)
    assert diag_rows(reports[1]) == diag_rows(reports[0])
    assert norm(str(reports[1].render())) == norm(str(reports[0].render()))


def test_warn_mode_executes_and_off_skips():
    out = {}
    for P in (J, T):
        env = _broken(P)
        try:
            env.execute("warn-job")
        except Exception:  # noqa: BLE001 — the list key fails at run time
            pass
        assert env._last_validation is not None
        assert "FT101" in env._last_validation.codes()
        conf = P.conf({"lint.mode": "off"})
        env3 = P.env(conf)
        sink3 = P.sources.CollectSink()
        env3.from_collection([1, 2]).map(lambda x: x + 1).add_sink(sink3)
        env3.execute("off-job")
        assert env3._last_validation is None
        out[P.name] = sorted(sink3.values)
    assert out["flink_tpu_torch"] == out["flink_tpu"] == [2, 3]


def test_lint_modes_and_unknown_mode():
    for P in (J, T):
        conf = P.conf()
        assert P.config.lint_mode_of(conf, P.config.LintOptions.MODE) == "warn"
        assert P.config.LINT_MODES == ("off", "warn", "strict")
    conf = T.conf({"lint.mode": "loud"})
    env = T.env(conf)
    env.from_collection([1]).add_sink(T.sources.CollectSink())
    with pytest.raises(ValueError) as ei:
        env.execute("bad")
    assert "lint.mode" in str(ei.value) and "strict" in str(ei.value)


def _lint_job(P):
    env = P.env()
    sink = P.sources.CollectSink()
    (env.from_collection([(1, 2.0)], timestamped=False)
        .key_by(lambda x: x[0])
        .reduce(lambda a, b: (a[0], a[1] + b[1]))
        .add_sink(sink))
    env.execute("lint-metrics-job")
    return {k: v for k, v in env.get_metric_registry().dump().items()
            if ".lint." in str(k)}, sink.values


def test_lint_gauges_equal_reference():
    jl, jout = _lint_job(J)
    tl, tout = _lint_job(T)
    assert tl == jl
    assert tl["lint-metrics-job.lint.errors"] == 0
    assert tl["lint-metrics-job.lint.infos"] >= 1
    assert "lint-metrics-job.lint.codes.FT140" in tl
    assert tout == jout


# ---------------------------------------------------------------------
# lint_script
# ---------------------------------------------------------------------

def good_script(pkg, device):
    return textwrap.dedent(f"""
        from {pkg}.streaming.datastream import StreamExecutionEnvironment
        from {pkg}.streaming.sources import CollectSink

        env = StreamExecutionEnvironment({device})
        sink = CollectSink()
        env.from_collection([1, 2, 3]).map(lambda x: x * 2).add_sink(sink)
        env.execute("good-job")
        assert sink.values == []   # lint mode: nothing actually ran
    """)


def bad_script(pkg, device):
    return textwrap.dedent(f"""
        from {pkg}.streaming.datastream import StreamExecutionEnvironment
        from {pkg}.streaming.sources import CollectSink

        env = StreamExecutionEnvironment({device})
        (env.from_collection([(1, 2.0)])
            .key_by(lambda x: [x[0]])
            .reduce(lambda a, b: a)
            .add_sink(CollectSink()))
        client = env.execute_async("bad-job")
        client.wait()
    """)


def write_scripts(tmp_path, maker, stem):
    """The same job script for each package: {package: path}."""
    out = {}
    for P, device in ((J, ""), (T, 'device="cpu"')):
        p = tmp_path / P.name / f"{stem}.py"
        p.parent.mkdir(exist_ok=True)
        p.write_text(maker(P.name, device))
        out[P.name] = str(p)
    return out


def test_lint_script_good_and_bad_equal_reference(tmp_path):
    for maker, stem in ((good_script, "good_job"), (bad_script, "bad_job")):
        paths = write_scripts(tmp_path, maker, stem)
        res = {P.name: P.script_lint.lint_script(paths[P.name])
               for P in (J, T)}
        j, t = res["flink_tpu"], res["flink_tpu_torch"]
        assert t.script_error is None and j.script_error is None
        assert [n for n, _ in t.reports] == [n for n, _ in j.reports]
        assert [diag_rows(r) for _, r in t.reports] == \
            [diag_rows(r) for _, r in j.reports]
        assert t.counts() == j.counts()
        assert t.has_errors() == (stem == "bad_job")


def test_lint_script_restores_the_environment(tmp_path):
    SEE = T.ds.StreamExecutionEnvironment
    before = (SEE.__init__, SEE.execute, SEE.execute_async)
    paths = write_scripts(tmp_path, good_script, "good_job")
    T.script_lint.lint_script(paths["flink_tpu_torch"])
    p = tmp_path / "raises.py"
    p.write_text("raise RuntimeError('script failed')\n")
    res = T.script_lint.lint_script(str(p))
    assert isinstance(res.script_error, RuntimeError)
    assert (SEE.__init__, SEE.execute, SEE.execute_async) == before
    # and a real job runs afterwards
    env = T.env()
    sink = T.sources.CollectSink()
    env.from_collection([1, 2]).map(lambda x: x + 1).add_sink(sink)
    env.execute("after-lint")
    assert sorted(sink.values) == [2, 3]


# ---------------------------------------------------------------------
# unused-import checker
# ---------------------------------------------------------------------

_SEEDED = {
    "mod.py": """
        import os
        import sys
        import json  # noqa
        from typing import List, Optional

        def f(paths: List[str]):
            return [sys.intern(p) for p in paths]
    """,
    "__init__.py": "from .mod import thing\n",
    "reexport/__init__.py": """
        from .a import used, unused
        __all__ = ["used"]
    """,
    "docstring.py": '''
        """np is named here: np."""
        import numpy as np
        import re as regex
        from . import helper as _
    ''',
}


@pytest.mark.parametrize("name", sorted(_SEEDED))
def test_imports_check_equals_reference(tmp_path, name):
    p = tmp_path / name
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(_SEEDED[name]))
    jf = J.imports_check.check_file(str(p))
    tf = T.imports_check.check_file(str(p))
    assert [f.__dict__ for f in tf] == [f.__dict__ for f in jf]
    assert [f.render() for f in tf] == [f.render() for f in jf]
    if name == "mod.py":
        assert {f.name for f in tf} == {"os", "Optional"}


def test_imports_check_tree_equals_reference(tmp_path):
    for name, src in _SEEDED.items():
        p = tmp_path / name
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    jf = J.imports_check.check_tree(str(tmp_path))
    tf = T.imports_check.check_tree(str(tmp_path))
    assert [f.__dict__ for f in tf] == [f.__dict__ for f in jf]
    assert tf


def test_port_has_no_unused_imports():
    findings = T.imports_check.check_tree("flink_tpu_torch")
    assert findings == [], "\n".join(f.render() for f in findings)


# ---------------------------------------------------------------------
# diagnostics plumbing
# ---------------------------------------------------------------------

def _plumbing(P):
    r = P.analysis.Diagnostics(job_name="j")
    r.add("FT130", "info thing")
    r.add("FT101", "error thing")
    r.add("FT112", "warning thing", operator_id=3, operator_name="w",
          location="f.py:1", hint="do this")
    r.add("FT140", "m", severity="info")
    return r


def test_diagnostics_ordering_and_counts_equal_reference():
    j, t = _plumbing(J), _plumbing(T)
    assert [d.code for d in t] == [d.code for d in j] == \
        ["FT101", "FT112", "FT130", "FT140"]
    assert t.counts() == j.counts() == {"error": 1, "warning": 1, "info": 2}
    assert t.render() == j.render()
    assert t.render("warning") == j.render("warning")
    assert t.to_dict() == j.to_dict()
    assert t.codes() == j.codes()
    assert [d.code for d in t.by_code("FT112")] == ["FT112"]
    assert t.has_errors() and len(t) == 4
    assert len(t.errors()) == len(t.warnings()) == 1 and len(t.infos()) == 2


def test_diagnostic_severity_defaults_from_catalog():
    for P in (J, T):
        r = P.analysis.Diagnostics()
        assert r.add("FT101", "m").severity == "error"
        assert r.add("FT112", "m").severity == "warning"
        assert r.add("FT130", "m").severity == "info"
        assert r.add("FT140", "m", severity="info").severity == "info"
        assert r.add("FT999", "m").severity == "warning"


def test_job_validation_error_message_equals_reference():
    j = J.analysis.JobValidationError(_plumbing(J))
    t = T.analysis.JobValidationError(_plumbing(T))
    assert str(t) == str(j)
    assert t.report.counts() == j.report.counts()
