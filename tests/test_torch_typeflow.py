"""The port's column type-flow prover (``flink_tpu_torch/analysis/
typeflow.py``) against the JAX package's, case for case of
``tests/test_typeflow.py``: node schemas and edge flows, kernel
verdicts and hazards, footprints, ``apply_static``'s counts (and its
idempotence), FT185-FT188, the ``lint.types.mode`` gate, the typeflow
gauges, ``predicted_codec_tier`` on the JobEdge and the pre-sized
``initial_capacity``; then what the verdicts do in the port's runtime:
probe-free kernels, job outputs under ``warn`` and ``off`` equal to the
reference's, a pre-sized scatter-tier snapshot crossing the packages,
and restarts that keep the stamps.

Probe accounting (``KERNEL_STATS``) counts the per-operator path only.
The port's fused chain program takes batches of ``MIN_FUSED_ROWS`` rows
and more, which the reference's fused chain never does on jax 0.9.0
(its ``_execute`` cannot import ``jax.experimental.enable_x64``:
ROADMAP queue 3), so the per-operator comparisons run with
``chain_fusion.FUSION_ENABLED`` off in the port, or at batches below
its row threshold; the fused case is its own test."""

import pickle

import numpy as np
import pytest

from torch_analysis_util import diag_rows, pkgs

J, T = pkgs()


def _node_id(env, name):
    ids = [nid for nid, n in env.graph.nodes.items() if n.name == name]
    assert ids, f"no node named {name}"
    return ids[0]


def _analyze(P, env):
    return P.typeflow.analyze_graph(env.graph, config=env.config)


def _tuple_sum(P):
    class TupleSum(P.device_agg.SumAggregate):
        def __init__(self):
            super().__init__(np.float32)

        def extract_value(self, value):
            return value[1]
    return TupleSum()


def _same_typeflow(jtf, ttf):
    """Two TypeflowReports agree: schemas, edges, kernels, footprints,
    summary and diagnostics."""
    assert {k: v.to_dict() for k, v in ttf.node_schemas.items()} == \
        {k: v.to_dict() for k, v in jtf.node_schemas.items()}
    assert [f.to_dict() for f in ttf.edges] == \
        [f.to_dict() for f in jtf.edges]
    assert {k: v.to_dict() for k, v in ttf.kernels.items()} == \
        {k: v.to_dict() for k, v in jtf.kernels.items()}
    assert {k: v.to_dict() for k, v in ttf.footprints.items()} == \
        {k: v.to_dict() for k, v in jtf.footprints.items()}
    assert ttf.summary() == jtf.summary()
    assert diag_rows(ttf.diagnostics) == diag_rows(jtf.diagnostics)


# ---------------------------------------------------------------------
# jobs, written once for both packages
# ---------------------------------------------------------------------

def g_vectorized(P):
    env = P.env()
    env.add_source(P.columnar.VectorizedCollectionSource([3, 1, 7])) \
        .add_sink(P.sources.CollectSink())
    return env


def g_collections(P):
    env = P.env()
    env.from_collection([0.5, 1.5]).add_sink(P.sources.CollectSink())
    env.from_collection(["a", "bb"]).add_sink(P.sources.CollectSink())
    env.from_collection([(1, 2.0), (3, 4.0)]).add_sink(P.sources.CollectSink())
    env.from_collection([((1, 2.0), 5), ((3, 4.0), 6)], timestamped=True) \
        .add_sink(P.sources.CollectSink())
    return env


def g_unbounded(P):
    env = P.env()
    env.socket_text_stream("localhost", 9999).map(lambda x: x) \
        .add_sink(P.sources.CollectSink())
    return env


def g_f4_map(P):
    env = P.env()
    env.add_source(P.columnar.VectorizedCollectionSource([1, 2])) \
        .map(lambda x: np.float32(x)).add_sink(P.sources.CollectSink())
    return env


def g_chain(P, types_mode=None, n=100, parallelism=1):
    conf = P.conf({"lint.types.mode": types_mode} if types_mode else {})
    env = P.env(conf)
    env.set_parallelism(parallelism)
    sink = P.sources.CollectSink()
    env.add_source(P.columnar.VectorizedCollectionSource(
        list(range(1, n + 1)))) \
        .map(lambda x: x * 2).filter(lambda x: x > 10) \
        .map(lambda x: (x, x + 0.5)).add_sink(sink)
    return env, sink


def g_ft185(P, conf=None):
    env = P.env(conf)
    env.add_source(P.columnar.VectorizedCollectionSource([1, 2, 3, 4])) \
        .map(lambda x: x > 2).rebalance().add_sink(P.sources.CollectSink())
    return env


def g_ft185_forward(P):
    env = P.env()
    env.add_source(P.columnar.VectorizedCollectionSource([1, 2, 3, 4])) \
        .map(lambda x: x > 2).add_sink(P.sources.CollectSink())
    return env


def g_ft186(P):
    env = P.env()
    vals = list(range(2 ** 29, 2 ** 30, 2 ** 20))
    env.add_source(P.columnar.VectorizedCollectionSource(vals)) \
        .map(lambda x: x << 40).add_sink(P.sources.CollectSink())
    return env


def g_ft186_clean(P):
    env = P.env()
    env.add_source(P.columnar.VectorizedCollectionSource([1, 2, 3])) \
        .map(lambda x: x << 40).add_sink(P.sources.CollectSink())
    return env


def g_ft187(P, budget=16, n_keys=64):
    conf = P.conf({"state.backend.tpu.max-device-slots": budget})
    env = P.env(conf)
    recs = [((k, 1.0), k) for k in range(n_keys)]
    (env.from_collection(recs, timestamped=True)
        .key_by(lambda t: t[0])
        .time_window(P.windowing.Time.seconds(1))
        .aggregate(_tuple_sum(P))
        .add_sink(P.sources.CollectSink()))
    return env


def g_ft188(P):
    env = P.env()
    a = env.add_source(P.columnar.VectorizedCollectionSource([1, 2, 3]))
    b = env.add_source(P.columnar.VectorizedCollectionSource(["a", "b"]))
    a.union(b).add_sink(P.sources.CollectSink())
    return env


def g_union_clean(P):
    env = P.env()
    a = env.add_source(P.columnar.VectorizedCollectionSource([1, 2]))
    b = env.add_source(P.columnar.VectorizedCollectionSource([10, 20]))
    a.union(b).add_sink(P.sources.CollectSink())
    return env


def g_boxing_edge(P):
    env = P.env()
    (env.add_source(P.columnar.VectorizedCollectionSource(list(range(10))))
        .map(lambda v: v + 1)
        .map(lambda v: v * 2 if v else v)   # first blocker
        .add_sink(P.sources.CollectSink()))
    return env


def g_tuple_fields(P):
    env = P.env()
    vals = [(i, float(i) * 0.5) for i in range(20)]
    env.add_source(P.columnar.VectorizedCollectionSource(vals)) \
        .map(lambda t: t[1] * 2).filter(lambda t: t > 3.0) \
        .add_sink(P.sources.CollectSink())
    return env


def _count_rows(n=300, n_keys=97, seed=5):
    rng = np.random.default_rng(seed)
    users = rng.integers(0, n_keys, n)
    ts = np.sort(rng.integers(0, 3000, n))
    return [((int(u), i), int(t)) for i, (u, t) in enumerate(zip(users, ts))]


def _count_wf(k, w, vals):
    return [(int(k), w.start, int(v)) for v in vals]


def g_count_window(P, n=300, n_keys=97, types_mode=None, seed=5):
    """A device Count over integer keys: the scatter tier in both
    packages."""
    conf = P.conf({"lint.types.mode": types_mode} if types_mode else {})
    env = P.env(conf)
    sink = P.sources.CollectSink()
    (env.from_collection(_count_rows(n, n_keys, seed), timestamped=True)
        .key_by(lambda e: e[0])
        .window(P.windowing.TumblingEventTimeWindows.of(1000))
        .aggregate(P.device_agg.CountAggregate(), _count_wf)
        .add_sink(sink))
    return env, sink


def g_columnar_window(P):
    env = P.env()
    (env.add_source(P.columnar.VectorizedCollectionSource(
        [(i % 5, float(i)) for i in range(40)]))
        .map(lambda t: (t[0], t[1] * 2.0))
        .key_by(lambda t: t[0])
        .time_window(P.windowing.Time.seconds(1))
        .aggregate(_tuple_sum(P))
        .add_sink(P.sources.CollectSink()))
    return env


GRAPHS = {f.__name__[2:]: f for f in (
    g_vectorized, g_collections, g_unbounded, g_f4_map, g_ft185,
    g_ft185_forward, g_ft186, g_ft186_clean, g_ft187, g_ft188,
    g_union_clean, g_boxing_edge, g_tuple_fields, g_columnar_window)}
GRAPHS["chain"] = lambda P: g_chain(P)[0]
GRAPHS["count_window"] = lambda P: g_count_window(P)[0]
GRAPHS["ft187_within"] = lambda P: g_ft187(P, budget=128)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_typeflow_report_equals_reference(name):
    _same_typeflow(_analyze(J, GRAPHS[name](J)), _analyze(T, GRAPHS[name](T)))


def test_seeded_codes_fire_as_in_the_reference():
    want = {"ft185": "FT185", "ft186": "FT186", "ft187": "FT187",
            "ft188": "FT188"}
    for name, code in want.items():
        tf = _analyze(T, GRAPHS[name](T))
        (d,) = tf.diagnostics.by_code(code)
        assert d.severity == "warning"
    for name in ("ft185_forward", "ft186_clean", "ft187_within",
                 "union_clean"):
        tf = _analyze(T, GRAPHS[name](T))
        assert not [d for d in tf.diagnostics
                    if d.code in ("FT185", "FT186", "FT187", "FT188")]
    assert T.analysis.CODES["FT186"][0] == "warning"


def test_codec_tier_vocabulary():
    env = g_f4_map(T)
    tf = _analyze(T, env)
    schema = tf.node_schemas[_node_id(env, "map")]
    assert T.typeflow.codec_tier(schema) == ("pickle", "f4")
    assert T.typeflow.codec_tier(
        tf.node_schemas[_node_id(env, "source")]) == ("col", "")
    assert T.typeflow.codec_tier(T.typeflow._unknown("x")) == (None, "")


# ---------------------------------------------------------------------
# kernel verdicts
# ---------------------------------------------------------------------

def _kernel_of(P, fn, values, op="map"):
    env = P.env()
    ds = env.add_source(P.columnar.VectorizedCollectionSource(list(values)))
    ds = ds.map(fn) if op == "map" else ds.filter(fn)
    ds.add_sink(P.sources.CollectSink())
    return _analyze(P, env).kernels[_node_id(env, op)]


_D = {"k": 1}
_KERNELS = [
    (lambda x: x * 2 + 1, range(100), "map"),
    (lambda x: x / 2, range(10), "map"),
    (lambda x: (x, x + 0.5), range(10), "map"),
    (lambda x: np.sqrt(np.float32(x)) * 2, range(10), "map"),
    (lambda x: x > 10, range(100), "filter"),
    (lambda x: x * 2 if x % 2 else x - 1, range(10), "map"),
    (lambda x: _D.get("k", x), range(10), "map"),
    (lambda x: -x // 3 % 7, range(-20, 20), "map"),
    (lambda x: x // (x - 5), range(10), "map"),
    (lambda x: np.where(x > 3, x, 0), range(10), "map"),
    (lambda x: np.clip(abs(x), 1, 5) ** 2, range(-9, 9), "map"),
    (lambda x: (x & 3) | 4, range(10), "map"),
    (lambda x: np.float32(x) / 2, range(10), "map"),
    (lambda x: np.maximum(x, 2.5), range(10), "map"),
    (lambda x: np.int32(x) * 3, range(10), "map"),
    (lambda x: x ** 3, range(10), "map"),
    (lambda x: "a", range(3), "map"),
    (lambda x: (x > 2) & (x < 8), range(10), "filter"),
    (lambda x: x + 1, range(10), "filter"),
]


@pytest.mark.parametrize("idx", range(len(_KERNELS)))
def test_kernel_verdict_equals_reference(idx):
    fn, values, op = _KERNELS[idx]
    jv = _kernel_of(J, fn, values, op)
    tv = _kernel_of(T, fn, values, op)
    assert tv.to_dict() == jv.to_dict()
    assert tv.describe() == jv.describe()


# ---------------------------------------------------------------------
# soundness: the prover never proves a kernel the probe demotes
# ---------------------------------------------------------------------

_ZOO = [
    (lambda v: v * 3 + 1, list(range(50))),
    (lambda v: v / 4, list(range(50))),
    (lambda v: (v, v * 2.0), list(range(30))),
    (lambda t: (t[0], t[1] * 2.0), [(i, float(i)) for i in range(30)]),
    (lambda v: v * 2 if v % 2 else v - 1, list(range(40))),
    (lambda v: v << 70, list(range(1, 20))),
    (lambda v: (10, 20, 30)[v], [i % 3 for i in range(30)]),
]


class _Cap:
    def __init__(self):
        self.rows = []

    def collect(self, r):
        self.rows.append((r.value, r.timestamp))

    def collect_batch(self, b):
        self.rows.extend(zip(b.row_values(), b.timestamps()))

    def emit_watermark(self, w):
        pass


def _run_map(P, fn, values, static=False):
    op = P.operators.StreamMap(P.functions._LambdaMap(fn))
    if static:
        op._static_kernel = True
    cap = _Cap()
    op.setup(cap)
    op.open()
    op.process_batch(P.columnar.batch_from_records(
        list(values), list(range(len(values)))))
    return op, cap.rows


@pytest.mark.parametrize("idx", range(len(_ZOO)))
def test_prover_never_proves_what_the_probe_demotes(idx):
    fn, values = _ZOO[idx]
    verdict = _kernel_of(T, fn, values)
    op, rows = _run_map(T, fn, values)
    if op._batch_kernel is False:
        assert not verdict.proven
    assert rows == [(fn(v), t) for t, v in enumerate(values)]
    assert verdict.proven == _kernel_of(J, fn, values).proven


def test_static_kernel_skips_the_probe_and_matches_boxed():
    T.operators.KERNEL_STATS.reset()
    for fn, values in _ZOO[:4]:
        assert _kernel_of(T, fn, values).proven
        op, rows = _run_map(T, fn, values, static=True)
        assert op.columnar_decided_by == "static"
        assert op.kernel_probes == 0
        boxed = T.operators.StreamMap(T.functions._LambdaMap(fn))
        cap = _Cap()
        boxed.setup(cap)
        boxed.open()
        for t, v in enumerate(values):
            boxed.process_element(T.elements.StreamRecord(v, t))
        assert rows == cap.rows
        _, jrows = _run_map(J, fn, values, static=True)
        assert rows == jrows
    assert T.operators.KERNEL_STATS.probes == 0
    assert T.operators.KERNEL_STATS.static_skips == 4


def test_static_stamp_still_demotes_on_runtime_mismatch():
    fn = lambda v: {"k": v}  # noqa: E731 — not a column shape
    values = list(range(5))
    op, rows = _run_map(T, fn, values, static=True)
    assert op._batch_kernel is False
    assert op.columnar_decided_by is None
    assert rows == [({"k": v}, t) for t, v in enumerate(values)]
    _, jrows = _run_map(J, fn, values, static=True)
    assert rows == jrows


def test_fallback_warning_names_the_verdict(caplog):
    T.operators._FALLBACK_WARNED.clear()
    op = T.operators.StreamMap(T.functions._LambdaMap(lambda v: {"k": v}))
    op._static_kernel = True
    op._typeflow_verdict = "map kernel proven -> i8 ts=all"
    op.setup(_Cap())
    op.open()
    with caplog.at_level("WARNING"):
        op.process_batch(T.columnar.batch_from_records([1, 2], [0, 1]))
    assert "typeflow verdict was: map kernel proven" in caplog.text


# ---------------------------------------------------------------------
# probe-free execution, fused and not
# ---------------------------------------------------------------------

@pytest.fixture
def no_fusion():
    cf = T.chain_fusion
    old = cf.FUSION_ENABLED
    cf.FUSION_ENABLED = False
    yield
    cf.FUSION_ENABLED = old


def _stats_of(P, types_mode, n=100):
    P.operators.KERNEL_STATS.reset()
    env, sink = g_chain(P, types_mode, n=n)
    env.execute("typeflow-chain")
    st = P.operators.KERNEL_STATS
    return (st.probes, st.static_skips), list(sink.values), env


def test_statically_proven_chain_runs_probe_free(no_fusion):
    for mode, want in (("warn", (0, 3)), (None, (3, 0))):
        (jst, jout, _), (tst, tout, tenv) = (_stats_of(J, mode),
                                             _stats_of(T, mode))
        assert tst == jst == want
        assert tout == jout
    decided = {k: v for k, v in tenv.get_metric_registry().dump().items()
               if str(k).endswith(".columnar.decided_by")}
    assert "probe" in decided.values()


def test_static_chain_below_the_fusion_threshold_is_probe_free():
    """Fusion on, batches under MIN_FUSED_ROWS: the per-operator path
    runs, as in the reference."""
    assert 100 < T.chain_fusion.MIN_FUSED_ROWS
    (tst, tout, _), (jst, jout, _) = _stats_of(T, "warn"), _stats_of(J, "warn")
    assert tst == jst == (0, 3)
    assert tout == jout


def test_static_chain_on_the_fused_program(monkeypatch):
    """Fusion on and one batch above the threshold: the port's fused
    program takes it (the reference's is dead on jax 0.9.0), so no
    per-operator probe and no static skip runs in either mode; the
    output equals the reference's per-operator run."""
    monkeypatch.setattr(T.chain_fusion, "MIN_FUSED_ROWS", 64)
    T.chain_fusion.FUSION_STATS.reset()
    outs = {}
    for mode in ("warn", None):
        (tst, tout, _) = _stats_of(T, mode, n=1000)
        assert tst == (0, 0)
        outs[mode] = tout
    assert T.chain_fusion.FUSION_STATS.fused_batches == 2
    (_, jout, _) = _stats_of(J, "warn", n=1000)
    assert outs["warn"] == outs[None] == jout


def test_fused_stage_selection_trusts_the_stamp(monkeypatch):
    """A stamped operator is a fusable stage without re-running the
    liftability analysis (the reference's _kernel_stage)."""
    env, _ = g_chain(T)
    tf = _analyze(T, env)
    T.typeflow.apply_static(env.graph, tf)
    ops = [n.operator_factory() for n in env.graph.nodes.values()]
    calls = []
    real = T.operators._udf_liftable
    monkeypatch.setattr(T.operators, "_udf_liftable",
                        lambda *a: calls.append(a) or real(*a))
    start, k, widx = T.chain_fusion.select_run(ops)
    assert (start, k, widx) == (1, 3, None)
    assert calls == []
    rep = T.chain_fusion.fusion_report(ops)
    assert rep["fusable"] and rep["fused_ops"] == ["StreamMap", "StreamFilter",
                                                   "StreamMap"]


def test_apply_static_counts_and_idempotence():
    counts = {}
    for P in (J, T):
        env, _ = g_chain(P)
        tf = _analyze(P, env)
        applied = P.typeflow.apply_static(env.graph, tf)
        assert P.typeflow.apply_static(env.graph, tf) == applied
        for node in env.graph.nodes.values():
            orig = getattr(node.operator_factory, "_typeflow_orig", None)
            if orig is not None:
                assert not hasattr(orig, "_typeflow_orig")
        counts[P.name] = applied
    assert counts["flink_tpu_torch"] == counts["flink_tpu"]
    assert counts["flink_tpu_torch"]["kernels_proven"] == 3


def test_decided_by_and_chain_report_equal_reference():
    reps = {}
    for P in (J, T):
        env, _ = g_chain(P)
        P.typeflow.apply_static(env.graph, _analyze(P, env))
        ops = [n.operator_factory() for n in env.graph.nodes.values()]
        decided = [P.eligibility.operator_decided_by(op) for op in ops]
        assert decided.count("static") == 3
        reps[P.name] = P.eligibility.chain_report(ops)
    t, j = reps["flink_tpu_torch"], reps["flink_tpu"]
    assert t["modes"] == j["modes"] and t["decided_by"] == j["decided_by"]
    from types import SimpleNamespace
    for P in (J, T):
        vec = g_chain(P)[0].graph.nodes[1].operator_factory()
        boxed = g_collections(P).graph.nodes[1].operator_factory()
        accepts = P.eligibility.subtask_accepts_batches
        assert accepts(SimpleNamespace(head=vec))
        assert not accepts(SimpleNamespace(head=boxed))
        assert not accepts(SimpleNamespace())
    assert t["prefix_len"] == j["prefix_len"] == 5
    assert t["fusion"] == j["fusion"]


# ---------------------------------------------------------------------
# the codec hint and pre-sizing
# ---------------------------------------------------------------------

def test_predicted_tier_lands_on_job_edge():
    tiers = {}
    for P in (J, T):
        env = g_ft185(P)
        applied = P.typeflow.apply_static(env.graph, _analyze(P, env))
        assert applied["edges_predicted"] == 1
        tiers[P.name] = [e.predicted_codec_tier
                         for e in env.get_job_graph().edges]
    assert tiers["flink_tpu_torch"] == tiers["flink_tpu"]
    assert "pickle" in tiers["flink_tpu_torch"]


@pytest.mark.parametrize("n_keys", [300, 5000])
def test_presized_initial_capacity_equals_reference(n_keys):
    caps = {}
    for P in (J, T):
        env = g_ft187(P, budget=1 << 20, n_keys=n_keys)
        P.typeflow.apply_static(env.graph, _analyze(P, env))
        op = env.graph.nodes[_node_id(env, "window_aggregate")] \
            .operator_factory()
        caps[P.name] = (op._predicted_slots, op.initial_capacity)
    assert caps["flink_tpu_torch"] == caps["flink_tpu"]
    assert caps["flink_tpu_torch"][0] == n_keys
    assert caps["flink_tpu_torch"][1] == max(1 << 14,
                                             1 << (n_keys - 1).bit_length())


def test_presize_is_capped(monkeypatch):
    monkeypatch.setattr(T.typeflow, "_MAX_PRESIZE_SLOTS", 256)
    env = g_ft187(T, budget=1 << 20, n_keys=5000)
    tf = _analyze(T, env)
    nid = _node_id(env, "window_aggregate")
    tf.footprints[nid].slots = 100_000
    T.typeflow.apply_static(env.graph, tf)
    op = env.graph.nodes[nid].operator_factory()
    assert op.initial_capacity == 1 << 14   # the default wins over 256
    assert T.typeflow._MAX_AOT_ROWS == 1 << 20


# ---------------------------------------------------------------------
# the gate and execute()
# ---------------------------------------------------------------------

def test_lint_types_mode_accepted_names():
    for P in (J, T):
        conf = P.conf()
        LO = P.config.LintOptions
        assert P.config.lint_mode_of(conf, LO.TYPES_MODE) == "off"
        assert P.config.lint_mode_of(conf, LO.MODE) == "warn"
        for mode in P.config.LINT_MODES:
            conf.set("lint.types.mode", mode)
            assert P.config.lint_mode_of(conf, LO.TYPES_MODE) == mode
        conf.set("lint.types.mode", "Bogus")
        with pytest.raises(ValueError) as ei:
            P.config.lint_mode_of(conf, LO.TYPES_MODE)
        assert "lint.types.mode" in str(ei.value)
        assert "off" in str(ei.value) and "strict" in str(ei.value)


def test_unknown_types_mode_fails_execute():
    conf = T.conf({"lint.types.mode": "aggressive"})
    env = T.env(conf)
    env.from_collection([1, 2]).map(lambda x: x) \
        .add_sink(T.sources.CollectSink())
    with pytest.raises(ValueError):
        env.execute("bad-mode")
    assert env._last_executor is None


def test_types_strict_raises_before_any_executor():
    reports = []
    for P in (J, T):
        env = g_ft185(P, P.conf({"lint.types.mode": "strict"}))
        with pytest.raises(P.analysis.JobValidationError) as ei:
            env.execute("strict-types")
        assert "FT185" in ei.value.report.codes()
        reports.append(ei.value.report)
        assert env._last_executor is None
    assert diag_rows(reports[1]) == diag_rows(reports[0])


def test_types_warn_executes_and_keeps_report():
    outs = {}
    for P in (J, T):
        env = g_ft185(P, P.conf({"lint.types.mode": "warn"}))
        sink = P.sources.CollectSink()
        env.graph.nodes[max(env.graph.nodes)].operator_factory = \
            (lambda P=P, sink=sink: P.operators.StreamSink(sink))
        env.execute("warn-types")
        assert env._last_typeflow is not None
        assert "FT185" in env._last_validation.codes()
        outs[P.name] = sorted(sink.values)
    assert outs["flink_tpu_torch"] == outs["flink_tpu"] == \
        [False, False, True, True]


def test_config_docs_rows_equal_reference():
    def rows(md):
        return {line.split("|")[1].strip().strip("`"): line
                for line in md.splitlines()
                if line.startswith("| `")}
    jrows = rows(J.config_docs.generate_config_docs())
    trows = rows(T.config_docs.generate_config_docs())
    assert set(trows) == set(T.config.KNOWN_KEYS)
    for key, line in trows.items():
        assert line == jrows[key]
    jgroups = {g: [o.key for _, o in opts]
               for g, opts in J.config_docs.collect_options()}
    jopts = {o.key: o for _, opts in J.config_docs.collect_options()
             for _, o in opts}
    for g, opts in T.config_docs.collect_options():
        assert [o.key for _, o in opts] == \
            [k for k in jgroups[g] if k in T.config.KNOWN_KEYS]
        for _, o in opts:
            assert (o.default, o.description) == (jopts[o.key].default,
                                                  jopts[o.key].description)


def test_typeflow_gauges_equal_reference():
    dumps = {}
    for P in (J, T):
        env = P.env(P.conf({"lint.types.mode": "warn"}))
        sink = P.sources.CollectSink()
        env.add_source(P.columnar.VectorizedCollectionSource(
            list(range(20)))).map(lambda x: x * 2).add_sink(sink)
        env.execute("tf-metrics")
        snap = env.get_metric_registry().dump()
        dumps[P.name] = {str(k): v for k, v in snap.items()
                         if ".typeflow." in str(k) or ".lint." in str(k)}
        decided = {str(k): v for k, v in snap.items()
                   if str(k).endswith(".columnar.decided_by")}
        assert "static" in decided.values()
    assert dumps["flink_tpu_torch"] == dumps["flink_tpu"]
    assert dumps["flink_tpu_torch"]["tf-metrics.typeflow.kernels_proven"] == 1
    assert dumps["flink_tpu_torch"]["tf-metrics.typeflow.edges_conclusive"] == 2


def test_script_lint_types(tmp_path):
    paths = {}
    for P, dev in ((J, ""), (T, 'device="cpu"')):
        p = tmp_path / P.name / "pickle_edge_job.py"
        p.parent.mkdir()
        p.write_text(
            f"from {P.name}.streaming.columnar import VectorizedCollectionSource\n"
            f"from {P.name}.streaming.datastream import StreamExecutionEnvironment\n"
            f"from {P.name}.streaming.sources import CollectSink\n"
            f"env = StreamExecutionEnvironment({dev})\n"
            "env.add_source(VectorizedCollectionSource([1, 2, 3, 4])) \\\n"
            "   .map(lambda x: x > 2).rebalance().add_sink(CollectSink())\n"
            'env.execute("pickle-edge-job")\n')
        paths[P.name] = str(p)
    res = {P.name: P.script_lint.lint_script(paths[P.name], types=True)
           for P in (J, T)}
    (tname, trep), = res["flink_tpu_torch"].reports
    (jname, jrep), = res["flink_tpu"].reports
    assert tname == jname == "pickle-edge-job"
    assert "FT185" in trep.codes()
    assert trep.typeflow.to_dict()["summary"] == \
        jrep.typeflow.to_dict()["summary"]
    plain = T.script_lint.lint_script(paths["flink_tpu_torch"])
    assert "FT185" not in plain.reports[0][1].codes()


# ---------------------------------------------------------------------
# the runtime under the verdicts: outputs, snapshots, restarts
# ---------------------------------------------------------------------

N_DISTINCT = len({k for (k, _), _ in _count_rows()})


@pytest.mark.parametrize("mode", ["warn", "off"])
def test_job_outputs_under_both_modes_equal_reference(mode, no_fusion):
    outs = {}
    for P in (J, T):
        env, sink = g_count_window(P, types_mode=mode)
        env.execute("count-window")
        outs[P.name] = sorted(sink.values)
        if mode == "warn":
            assert env._last_typeflow.summary()["predicted_state_bytes"] == \
                N_DISTINCT * 4
    assert outs["flink_tpu_torch"] == outs["flink_tpu"]
    for P in (J, T):
        env, sink = g_chain(P, mode)
        env.execute("chain")
        outs[P.name] = list(sink.values)
    assert outs["flink_tpu_torch"] == outs["flink_tpu"]


def _presized_op(P, n, n_keys, seed):
    env, _ = g_count_window(P, n=n, n_keys=n_keys, seed=seed)
    P.typeflow.apply_static(env.graph, _analyze(P, env))
    node = env.graph.nodes[_node_id(env, "window_aggregate")]
    return node.operator_factory(), node.key_selector


def _harness(P, op, key_selector):
    from importlib import import_module
    H = import_module(f"{P.name}.streaming.harness")
    kw = {"device": "cpu"} if P.is_torch else {}
    h = H.OneInputStreamOperatorTestHarness(op, key_selector=key_selector,
                                            **kw)
    h.open()
    return h


def _feed(h, rows):
    for v, t in rows:
        h.process_element(v, t)


@pytest.mark.parametrize("direction", ["torch_to_jax", "jax_to_torch"])
def test_presized_scatter_snapshot_crosses_packages(direction):
    """A scatter-tier snapshot taken by a pre-sized operator (20,000
    keys: capacity 2^15 where the default is 2^14) restores in the other
    package, records its capacity, and the restored run's output equals
    the uninterrupted one's."""
    from flink_tpu_torch.state import portable
    shape = dict(n=40_000, n_keys=20_000, seed=9)
    rows = _count_rows(**shape)
    src, dst = (T, J) if direction == "torch_to_jax" else (J, T)
    op, sel = _presized_op(src, **shape)
    assert op._predicted_slots == len({k for (k, _), _ in rows})
    assert op.initial_capacity == 1 << 15
    h = _harness(src, op, sel)
    _feed(h, rows[:len(rows) // 2])
    snap = op.snapshot_state(1)
    assert snap["device_tier"] == "vectorized"
    assert snap["device_engine"]["capacity"] == 1 << 15
    blob = portable.dumps(snap) if src is T else pickle.dumps(snap)
    back = pickle.loads(blob) if dst is J else portable.loads(blob)
    dop, dsel = _presized_op(dst, **shape)
    dh = _harness(dst, dop, dsel)
    dop.restore_state([back])
    assert dop.engine.capacity == 1 << 15
    _feed(dh, rows[len(rows) // 2:])
    dh.process_watermark(2 ** 62)
    rop, rsel = _presized_op(dst, **shape)
    rh = _harness(dst, rop, rsel)
    _feed(rh, rows)
    rh.process_watermark(2 ** 62)
    got = sorted(dh.extract_output_values())
    assert got == sorted(rh.extract_output_values()) and got


def test_restart_keeps_the_stamps(no_fusion, tmp_path):
    """A job that fails once restarts through the wrapped factories:
    the new attempt's kernels are stamped and still skip the probe."""

    class Boom(T.functions.MapFunction):
        failed = [False]

        def map(self, v):
            if v == 60 and not Boom.failed[0]:
                Boom.failed[0] = True
                raise RuntimeError("induced failure")
            return v

    conf = T.conf({"lint.types.mode": "warn"})
    env = T.env(conf)
    env.set_restart_strategy("fixed_delay", restart_attempts=2, delay_ms=0)
    sink = T.sources.CollectSink()
    (env.add_source(T.columnar.VectorizedCollectionSource(
        list(range(1, 101)), chunk=16))
        .map(lambda x: x * 2).filter(lambda x: x > 10)
        .map(Boom()).add_sink(sink))
    T.operators.KERNEL_STATS.reset()
    result = env.execute("restart")
    assert result.restarts == 1
    first = env.graph.nodes[2].operator_factory()
    assert first._static_kernel and first._typeflow_verdict
    assert T.operators.KERNEL_STATS.probes == 0
    assert T.operators.KERNEL_STATS.static_skips >= 4   # 2 kernels x 2 attempts
    assert sorted(set(sink.values)) == [x * 2 for x in range(6, 101)]
