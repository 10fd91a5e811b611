"""Two-input operators in the port against the JAX package, on the CPU:
``connect`` with co-map, co-flat-map and a keyed co-process function
with event-time timers; one watermark per input; the broadcast state
pattern at parallelism 3, keyed and not; broadcast state through a
restart and through a rescaled savepoint, both ways.

The two executors interleave two inputs in their own orders (the port's
is one cooperative thread of direct calls), so each comparison is of
something that order does not decide, as each test says: per-input
order, multisets, timer output on ascending timestamps, or a data side
that waits until the broadcast side is in.
"""

import os
import threading
import time

import numpy as np
import pytest

import flink_tpu.core.functions as jfn
import flink_tpu.core.state as jstate
import flink_tpu.streaming.operators as jops
import flink_tpu_torch.core.functions as tfn
import flink_tpu_torch.core.state as tstate
import flink_tpu_torch.streaming.operators as tops
from flink_tpu.streaming import datastream as jds
from flink_tpu.streaming import elements as jel
from flink_tpu.streaming import sources as jsrc
from flink_tpu_torch.streaming import datastream as tds
from flink_tpu_torch.streaming import elements as tel
from flink_tpu_torch.streaming import sources as tsrc

import test_torch_operator_state as opst

PKG = {"torch": dict(ds=tds, src=tsrc, fn=tfn, state=tstate, ops=tops, el=tel),
       "jax": dict(ds=jds, src=jsrc, fn=jfn, state=jstate, ops=jops, el=jel)}
PKGS = ["torch", "jax"]
_CLASSES = {}


def _cls(pkg, name, mixin, base_name, base_mod="ops"):
    key = (pkg, name)
    if key not in _CLASSES:
        base = getattr(PKG[pkg][base_mod], base_name)
        _CLASSES[key] = type(f"{name}_{pkg}", (mixin, base), {})
    return _CLASSES[key]


def _env(pkg, backend="heap", parallelism=None):
    env = opst._env(pkg, backend)
    if parallelism is not None:
        env.set_parallelism(parallelism)
    return env


def _ascending(pkg, stream, ts_of):
    return stream.assign_timestamps_and_watermarks(
        PKG[pkg]["src"].AscendingTimestampExtractor(ts_of))


# ---------------------------------------------------------------------
# co-map, co-flat-map: per-input order and the multiset
# ---------------------------------------------------------------------

class _CoMapMixin:
    def map1(self, v):
        return ("a", v * 2)

    def map2(self, v):
        return ("b", v + 0.5)


class _CoFlatMapMixin:
    def flat_map1(self, v):
        return [("a", v)] * (v % 3)

    def flat_map2(self, v):
        return [("b", len(v)), ("b", v)]


@pytest.mark.parametrize("kind", ["map", "flat_map"])
def test_co_map_and_flat_map_equal_the_reference(kind):
    rng = np.random.default_rng(1)
    ints = [int(v) for v in rng.integers(0, 100, 700)]
    strs = [f"s{int(v)}" for v in rng.integers(0, 50, 300)]
    outs = {}
    for pkg in PKGS:
        env = _env(pkg)
        sink = PKG[pkg]["src"].CollectSink()
        a = env.from_collection(ints if kind == "map" else ints)
        b = env.from_collection([float(v) for v in ints[:300]]
                                if kind == "map" else strs)
        fn = (_cls(pkg, "CoMap", _CoMapMixin, "CoMapFunction", "fn")()
              if kind == "map" else
              _cls(pkg, "CoFlatMap", _CoFlatMapMixin, "CoFlatMapFunction", "fn")())
        getattr(a.connect(b), kind)(fn).add_sink(sink)
        env.execute(f"co-{kind}")
        outs[pkg] = sink.values
    for pkg in PKGS:
        # per-input order is kept; the interleaving is the executor's
        for side in ("a", "b"):
            assert ([v for s, v in outs[pkg] if s == side]
                    == [v for s, v in outs["jax"] if s == side])
    assert sorted(outs["torch"], key=repr) == sorted(outs["jax"], key=repr)


# ---------------------------------------------------------------------
# keyed co-process with event-time timers; per-input watermarks
# ---------------------------------------------------------------------

class _CountBothMixin:
    """Counts each input's records per key and 1 s window in a map state
    and, at each window's end, emits (key, window end, count1, count2)
    and drops the window's entry."""

    def _counts(self, ctx):
        return ctx.get_state(self.STATE.MapStateDescriptor("counts"))

    def _bump(self, ctx, i):
        end = ctx.timestamp() // 1000 * 1000 + 999
        counts = self._counts(ctx)
        c = list(counts.get(end) or (0, 0))
        c[i] += 1
        counts.put(end, tuple(c))
        ctx.register_event_time_timer(end)

    def process_element1(self, value, ctx, out):
        self._bump(ctx, 0)

    def process_element2(self, value, ctx, out):
        self._bump(ctx, 1)

    def on_timer(self, timestamp, ctx, out):
        counts = self._counts(ctx)
        c1, c2 = counts.get(timestamp) or (0, 0)
        out.collect((ctx.get_current_key(), timestamp, c1, c2))
        counts.remove(timestamp)


def _count_both(pkg):
    cls = _CLASSES.get((pkg, "CountBoth"))
    if cls is None:
        cls = _CLASSES[(pkg, "CountBoth")] = type(
            f"CountBoth_{pkg}", (_CountBothMixin,),
            {"STATE": PKG[pkg]["state"]})
    return cls()


def _events(n, n_keys, seed, step=7):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n_keys, n)
    return [(f"k{int(k)}", i * step) for i, k in enumerate(keys)]


def _timer_expected(a, b):
    want = {}
    for i, side in ((0, a), (1, b)):
        for k, ts in side:
            e = want.setdefault((k, ts // 1000 * 1000 + 999), [0, 0])
            e[i] += 1
    return sorted((k, t, c[0], c[1]) for (k, t), c in want.items())


@pytest.mark.parametrize("backend", ["heap", "gpu"])
@pytest.mark.parametrize("parallelism", [1, 3])
def test_keyed_co_process_timers_equal_the_reference(backend, parallelism):
    """Ascending timestamps on both inputs: a timer fires once both
    inputs' watermarks passed it, after every record at or before it,
    so the output does not depend on the interleaving."""
    a = _events(1500, 40, seed=3, step=7)
    b = _events(900, 40, seed=4, step=11)
    outs = {}
    for pkg in PKGS:
        env = _env(pkg, backend, parallelism)
        sink = PKG[pkg]["src"].CollectSink()
        s1 = _ascending(pkg, env.from_collection(a), lambda v: v[1])
        s2 = _ascending(pkg, env.from_collection(b), lambda v: v[1])
        (s1.connect(s2).key_by(lambda v: v[0], lambda v: v[0])
            .process(_count_both(pkg)).add_sink(sink))
        env.execute("co-process")
        outs[pkg] = sorted(sink.values)
    assert outs["torch"] == outs["jax"] == _timer_expected(a, b)


class _CountSeenMixin(_CountBothMixin):
    """As ``_CountBothMixin``, and each timer also says how many records
    of input 2 the instance had taken when it fired."""

    seen2 = 0

    def process_element2(self, value, ctx, out):
        self.seen2 += 1
        self._bump(ctx, 1)

    def on_timer(self, timestamp, ctx, out):
        counts = self._counts(ctx)
        c1, c2 = counts.get(timestamp) or (0, 0)
        out.collect((ctx.get_current_key(), timestamp, c1, c2, self.seen2))
        counts.remove(timestamp)


def test_timers_wait_for_the_second_inputs_watermark():
    """Input 2 has timestamps but no watermark before its final one:
    the operator's watermark, the minimum of its inputs', stays back,
    so every timer fires after the last record of input 2, in both
    packages."""
    a = _events(400, 10, seed=5)
    b = _events(100, 10, seed=6, step=13)
    outs = {}
    for pkg in PKGS:
        env = _env(pkg)
        sink = PKG[pkg]["src"].CollectSink()
        s1 = _ascending(pkg, env.from_collection(a), lambda v: v[1])
        s2 = env.from_collection([(v, v[1]) for v in b], timestamped=True)
        fn = type(f"CountSeen_{pkg}", (_CountSeenMixin,),
                  {"STATE": PKG[pkg]["state"]})()
        (s1.connect(s2).key_by(lambda v: v[0], lambda v: v[0])
            .process(fn).add_sink(sink))
        env.execute("co-process-one-watermark")
        outs[pkg] = sorted(sink.values)
    want = [w + (len(b),) for w in _timer_expected(a, b)]
    assert outs["torch"] == outs["jax"] == want


@pytest.mark.parametrize("order", ["1-then-2", "2-then-1", "interleaved"])
def test_operator_watermark_is_the_minimum_of_its_inputs(order):
    steps = {"1-then-2": [(1, 10), (1, 30), (2, 5), (2, 20), (2, 40), (1, 50)],
             "2-then-1": [(2, 15), (2, 99), (1, 3), (1, 50), (1, 120)],
             "interleaved": [(1, 10), (2, 10), (1, 20), (2, 15), (2, 30),
                             (1, 25)]}[order]
    seen = {}
    for pkg in PKGS:
        fn = _cls(pkg, "CoMap", _CoMapMixin, "CoMapFunction", "fn")()
        op = PKG[pkg]["ops"].CoStreamMap(fn)
        out = PKG[pkg]["ops"].CollectorOutput()
        op.setup(out)
        op.open()
        for side, ts in steps:
            wm = PKG[pkg]["el"].Watermark(ts)
            (op.process_watermark1 if side == 1 else op.process_watermark2)(wm)
        seen[pkg] = [w.timestamp for w in out.watermarks]
    assert seen["torch"] == seen["jax"]
    assert seen["torch"] == sorted(set(seen["torch"]))


# ---------------------------------------------------------------------
# the broadcast state pattern
# ---------------------------------------------------------------------

class _RulesSourceMixin:
    """Emits its rules once (a flag kept in its function state, so a
    restore does not emit them again), then holds until ``released``.
    ``first_cid`` is the first checkpoint whose snapshot has them out."""

    released = True
    first_cid = None

    def __init__(self, rules):
        self.rules = list(rules)
        self.emitted = False

    def run(self, ctx):
        while self.emit_step(ctx, 1024):
            pass

    def emit_step(self, ctx, max_records):
        if not self.emitted:
            for r in self.rules:
                ctx.collect(r)
            self.emitted = True
        if not type(self).released:
            time.sleep(0.0005)
            return True
        return False

    def snapshot_function_state(self, checkpoint_id=None):
        cls = type(self)
        if self.emitted and cls.first_cid is None:
            cls.first_cid = checkpoint_id
        return {"emitted": self.emitted}

    def restore_function_state(self, state):
        self.emitted = state["emitted"]


class _GatedDataMixin(opst._ListOffsetSourceMixin):
    """The operator-state source of ``test_torch_operator_state``, held
    back until every broadcast instance has taken ``needed`` rules; with
    ``rules`` set, its gate opens on a checkpoint that holds them."""

    needed = 0
    rules = None

    def notify_checkpoint_complete(self, checkpoint_id):
        rules = type(self).rules
        if rules is None or (rules.first_cid is not None
                             and checkpoint_id >= rules.first_cid):
            type(self).completed = True

    def emit_step(self, ctx, max_records):
        if _Seen.count < type(self).needed:
            time.sleep(0.0005)
            return True
        return super().emit_step(ctx, max_records)


class _Seen:
    count = 0
    lock = threading.Lock()
    #: id of the operator instance -> its broadcast state after the
    #: latest rule
    states = {}

    @classmethod
    def reset(cls):
        cls.count = 0
        cls.states = {}


class _EnrichMixin:
    def process_element(self, value, ctx, out):
        out.collect((value[0], value[1],
                     ctx.get_broadcast_state(self.RULES).get(value[0])))

    def process_broadcast_element(self, value, ctx, out):
        st = ctx.get_broadcast_state(self.RULES)
        st.put(value[0], value[1])
        with _Seen.lock:
            _Seen.count += 1
            _Seen.states[id(ctx._op)] = dict(st.immutable_entries())


def _rules_desc(pkg):
    return PKG[pkg]["state"].MapStateDescriptor("rules")


def _enrich(pkg):
    cls = _CLASSES.get((pkg, "Enrich"))
    if cls is None:
        cls = _CLASSES[(pkg, "Enrich")] = type(
            f"Enrich_{pkg}", (_EnrichMixin, PKG[pkg]["ops"].BroadcastProcessFunction),
            {"RULES": _rules_desc(pkg)})
    return cls()


def _rules_source(pkg):
    return _cls(pkg, "Rules", _RulesSourceMixin, "SourceFunction", "src")


def _data_source(pkg):
    return _cls(pkg, "GatedData", _GatedDataMixin, "SourceFunction", "src")


def _data_items(n=900, n_keys=12, seed=6):
    rng = np.random.default_rng(seed)
    return [((f"c{int(k)}", i), i) for i, k in enumerate(rng.integers(0, n_keys, n))]


RULE_MAP = {f"c{i}": ("ADMIT" if i % 3 else "DENY") for i in range(10)}


def _broadcast_job(pkg, env, items, sink, keyed, p):
    data = env.add_source(_data_source(pkg)(items), name="data").uid("data")
    rules = env.add_source(_rules_source(pkg)(sorted(RULE_MAP.items())),
                           name="rules").uid("rules")
    spread = data.rebalance().map(lambda v: v, name="spread").set_parallelism(p)
    left = spread.key_by(lambda v: v[0]) if keyed else spread.rebalance()
    (left.connect(rules.broadcast(_rules_desc(pkg)))
        .process(_enrich(pkg)).uid("enrich").set_parallelism(p)
        .add_sink(sink))


def _want(items):
    return sorted((k, i, RULE_MAP.get(k)) for (k, i), _ in items)


@pytest.mark.parametrize("keyed", [True, False])
def test_broadcast_pattern_at_parallelism_3(keyed):
    """The data side waits until the rules are in on every instance:
    every record is enriched from the whole rule map, and every
    instance's broadcast state equals it."""
    items = _data_items()
    for pkg in PKGS:
        _Seen.reset()
        _rules_source(pkg).released = True
        _data_source(pkg).reset()
        _data_source(pkg).needed = 3 * len(RULE_MAP)
        _data_source(pkg).rules = None
        sink = PKG[pkg]["src"].CollectSink()
        env = _env(pkg)
        _broadcast_job(pkg, env, items, sink, keyed, 3)
        env.execute("broadcast-p3")
        assert sorted(sink.values) == _want(items), pkg
        assert len(_Seen.states) == 3
        assert all(s == RULE_MAP for s in _Seen.states.values())


class _FailAfterRulesMixin(opst._FailOnceMixin):
    """Fails once, after a checkpoint that holds the rules completed."""

    rules = None

    def notify_checkpoint_complete(self, checkpoint_id):
        first = type(self).rules.first_cid
        if first is not None and checkpoint_id >= first:
            type(self).completed = True


@pytest.mark.parametrize("backend", ["heap", "gpu"])
def test_broadcast_state_survives_a_restart(backend):
    """A failure after a completed checkpoint: the restart restores the
    broadcast state (the rules are not sent again) and every record
    after it is still enriched."""
    items = _data_items(1200)
    outs = {}
    for pkg in PKGS:
        _Seen.reset()
        rules = _rules_source(pkg)
        rules.released = False
        rules.first_cid = None
        data = _data_source(pkg)
        data.reset(gate=400)
        data.needed = 2 * len(RULE_MAP)
        data.rules = rules
        failer = _cls(pkg, "FailAfter", _FailAfterRulesMixin,
                      "MapFunction", "fn")
        failer.reset()
        failer.rules = rules
        sink = PKG[pkg]["src"].CollectSink()
        env = _env(pkg, backend)
        env.enable_checkpointing(5)
        env.set_restart_strategy("fixed_delay", restart_attempts=3, delay_ms=0)
        src = env.add_source(data(items), name="data").uid("data")
        rsrc = env.add_source(rules(sorted(RULE_MAP.items())),
                              name="rules").uid("rules")
        (src.map(failer(), name="failer").key_by(lambda v: v[0])
            .connect(rsrc.broadcast(_rules_desc(pkg)))
            .process(_enrich(pkg)).uid("enrich").set_parallelism(2)
            .add_sink(sink))
        client = env.execute_async("broadcast-restart")
        deadline = time.time() + 60
        while not failer.failed and time.time() < deadline:
            time.sleep(0.005)
        # the rules source ends once the failure is behind the job
        rules.released = True
        result = client.wait(60)
        assert failer.failed and result.restarts == 1
        seen_after = _Seen.count
        assert seen_after == 2 * len(RULE_MAP), "the rules were sent again"
        outs[pkg] = sorted(set(sink.values))
    assert outs["torch"] == outs["jax"] == _want(items)


@pytest.mark.parametrize("origin,target", [("jax", "torch"), ("torch", "jax")])
def test_broadcast_state_through_a_rescaled_savepoint(origin, target, tmp_path):
    """A savepoint at parallelism 2 while the data source holds resumes
    at parallelism 3 in the other package: each new instance gets the
    broadcast state, the rules are not sent again, and the records
    after the savepoint are enriched from it."""
    items = _data_items(1000, seed=11)
    hold = len(items) // 2
    _Seen.reset()
    _rules_source(origin).released = False
    _data_source(origin).reset(hold=hold)
    _data_source(origin).needed = 2 * len(RULE_MAP)
    _data_source(origin).rules = None
    before = PKG[origin]["src"].CollectSink()
    env = _env(origin)
    env.enable_checkpointing(60_000)   # savepoints only
    _broadcast_job(origin, env, items, before, True, 2)
    client = env.execute_async("broadcast-origin")
    assert _data_source(origin).reached.wait(60)
    path = client.trigger_savepoint(str(tmp_path / "sp"))
    client.cancel()
    assert client.wait(60).cancelled and os.path.exists(path)

    _Seen.reset()
    _rules_source(target).released = True
    _data_source(target).reset()
    _data_source(target).needed = 0
    _data_source(target).rules = None
    after = PKG[target]["src"].CollectSink()
    env = _env(target)
    env.set_savepoint_restore(path)
    _broadcast_job(target, env, items, after, True, 3)
    assert env.execute("broadcast-resume").restarts == 0
    assert _Seen.count == 0          # no rule was sent again
    assert sorted(before.values + after.values) == _want(items)
    assert len(after.values) == len(items) - hold
