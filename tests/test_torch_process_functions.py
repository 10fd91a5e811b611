"""Process functions, rolling reduces, joins, partitioners and chaining
in the port against the JAX package, on the CPU: the matching cases of
tests/test_datastream_api.py and tests/test_datastream_extensions.py
(rolling sum / min, a keyed process function with an event-time timer,
rebalance / broadcast / global, chaining in the job graph, keyBy
breaking the chain, a forward edge between parallel operators, the
windowed join and coGroup), and more of each: ``ProcessOperator`` with
side outputs, keyed process functions with event- and processing-time
timers and value, list, reducing and aggregating state on the heap and
GPU backends (the JAX heap and TPU backends; on ``gpu`` an
``AggregatingState`` of ``HyperLogLogAggregate`` is the backend's
device state, whose kernels run their plain versions on the CPU),
rolling ``reduce`` / ``sum`` / ``min`` / ``max`` / ``min_by`` /
``max_by``, the row interval join, and every partitioner's routing.

Each job runs through both packages' environments (the port on
``device="cpu"``) and the outputs compare exactly, in emission order
where one subtask writes the sink and sorted otherwise.
"""

from types import SimpleNamespace

import numpy as np
import pytest

from flink_tpu.core import state as jstate
from flink_tpu.ops.sketches import HyperLogLogAggregate as JaxHll
from flink_tpu.streaming import datastream as jds
from flink_tpu.streaming import graph as jgraph
from flink_tpu.streaming import operators as jops
from flink_tpu.streaming import partitioners as jpart
from flink_tpu.streaming import sources as jsrc
from flink_tpu.streaming import windowing as jw
from flink_tpu_torch.core import functions as tfn
from flink_tpu_torch.core import state as tstate
from flink_tpu_torch.ops.sketches import HyperLogLogAggregate as TorchHll
from flink_tpu_torch.state.gpu_backend import DeviceAggregatingState
from flink_tpu_torch.streaming import datastream as tds
from flink_tpu_torch.streaming import graph as tgraph
from flink_tpu_torch.streaming import operators as tops
from flink_tpu_torch.streaming import partitioners as tpart
from flink_tpu_torch.streaming import sources as tsrc
from flink_tpu_torch.streaming import windowing as tw
from flink_tpu.core import functions as jfn
from torch_port_util import hll_atol

P = {"torch": SimpleNamespace(ds=tds, src=tsrc, ops=tops, st=tstate, w=tw,
                              part=tpart, graph=tgraph, fn=tfn, hll=TorchHll),
     "jax": SimpleNamespace(ds=jds, src=jsrc, ops=jops, st=jstate, w=jw,
                            part=jpart, graph=jgraph, fn=jfn, hll=JaxHll)}
#: (port backend, JAX backend)
BACKENDS = {"heap": ("heap", "heap"), "gpu": ("gpu", "tpu")}


def _env(pkg, backend="heap", parallelism=1):
    p = P[pkg]
    env = (p.ds.StreamExecutionEnvironment(device="cpu") if pkg == "torch"
           else p.ds.StreamExecutionEnvironment())
    env.set_state_backend(BACKENDS[backend][0 if pkg == "torch" else 1])
    env.set_parallelism(parallelism)
    return env


def _run_both(job, backend="heap", parallelism=1, order=list):
    """job(pkg, env) -> list filled by the job; (port, JAX) outputs."""
    outs = []
    for pkg in ("torch", "jax"):
        env = _env(pkg, backend, parallelism)
        out = job(pkg, env)
        env.execute("job")
        outs.append(order(out))
    return outs


def _each_sorted(outs):
    return [sorted(o) for o in outs]


def _assert_same(job, **kw):
    got, want = _run_both(job, **kw)
    assert got == want
    return got


def _events(n=400, n_keys=6, span=5000, seed=1):
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.integers(0, span, n))
    return list(zip(rng.integers(0, n_keys, n).tolist(),
                    rng.integers(0, 100, n).tolist(), ts.tolist()))


def _timestamped(pkg, env, events, bound=0):
    return env.from_collection(events).assign_timestamps_and_watermarks(
        P[pkg].src.BoundedOutOfOrdernessTimestampExtractor(
            bound, lambda e: e[2]))


# ---------------------------------------------------------------------
# rolling reduces
# ---------------------------------------------------------------------

ROLLING = {
    "sum": lambda ks: ks.sum(1),
    "min": lambda ks: ks.min(1),
    "max": lambda ks: ks.max(1),
    "min_by": lambda ks: ks.min_by(1),
    "max_by": lambda ks: ks.max_by(1),
    "reduce": lambda ks: ks.reduce(lambda a, b: (a[0], a[1] * 2 + b[1], b[2])),
    "sum_whole": lambda ks: ks.map(lambda e: e[1]).key_by(lambda v: v % 3).sum(),
    "min_by_callable": lambda ks: ks.min_by(lambda e: -e[1]),
}


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("name", sorted(ROLLING))
def test_rolling_reduces_match(name, backend):
    events = _events()

    def job(pkg, env):
        out = []
        ROLLING[name](env.from_collection(events).key_by(lambda e: e[0])) \
            .collect_into(out)
        return out

    got = _assert_same(job, backend=backend)
    assert len(got) == len(events)


def test_rolling_sum_and_min_reference_cases():
    def job(pkg, env):
        a, b = [], []
        env.from_collection([("a", 1), ("a", 2), ("b", 5), ("a", 3)]) \
            .key_by(lambda t: t[0]).sum(1).collect_into(a)
        env.from_collection([("k", 5), ("k", 3), ("k", 7)]) \
            .key_by(lambda t: t[0]).min(1).collect_into(b)
        return [a, b]

    got = _assert_same(job)
    assert got == [[("a", 1), ("a", 3), ("b", 5), ("a", 6)],
                   [("k", 5), ("k", 3), ("k", 3)]]


def test_rolling_reduce_at_parallelism_3():
    events = _events(n=600, n_keys=20)

    def job(pkg, env):
        out = []
        env.from_collection(events).key_by(lambda e: e[0]).sum(1) \
            .collect_into(out)
        return out

    _assert_same(job, parallelism=3, order=sorted)


# ---------------------------------------------------------------------
# process functions
# ---------------------------------------------------------------------

def _classes(pkg):
    p = P[pkg]
    PF = p.ops.ProcessFunction
    tag = p.ops.OutputTag("odd")

    class Splitter(PF):
        def process_element(self, value, ctx, out):
            if value[1] % 2:
                ctx.output(tag, (value[0], ctx.timestamp()))
            else:
                out.collect((value, ctx.timestamp(), ctx.current_watermark()))

    class Waiter(PF):
        def process_element(self, value, ctx, out):
            ctx.register_event_time_timer(value[1] + 100)

        def on_timer(self, timestamp, ctx, out):
            out.collect((ctx.get_current_key(), timestamp, ctx.time_domain))

    count_desc = p.st.ValueStateDescriptor("count")
    list_desc = p.st.ListStateDescriptor("seen")
    red_desc = p.st.ReducingStateDescriptor("total", lambda a, b: a + b)

    class Counter(PF):
        """Value, list and reducing state; an event-time timer at the
        second's end emits them and clears; a second registration of
        the same timer is deleted and re-registered."""

        def process_element(self, value, ctx, out):
            st = ctx.get_state(count_desc)
            st.update((st.value() or 0) + 1)
            ctx.get_state(list_desc).add(value[1])
            ctx.get_state(red_desc).add(value[1])
            end = value[2] - value[2] % 1000 + 999
            ctx.delete_event_time_timer(end)
            ctx.register_event_time_timer(end)

        def on_timer(self, timestamp, ctx, out):
            seen = list(ctx.get_state(list_desc).get())
            out.collect((ctx.get_current_key(), timestamp,
                         ctx.get_state(count_desc).value(), sorted(seen),
                         ctx.get_state(red_desc).get()))
            for d in (count_desc, list_desc, red_desc):
                ctx.get_state(d).clear()

    class ProcTimer(PF):
        """Processing-time timers fire at the end of input (the test
        clock never moves)."""

        def process_element(self, value, ctx, out):
            ctx.register_processing_time_timer(
                ctx.current_processing_time() + 10 + value[0])
            if value[1] > 90:
                ctx.delete_processing_time_timer(
                    ctx.current_processing_time() + 10 + value[0])

        def on_timer(self, timestamp, ctx, out):
            out.collect((ctx.get_current_key(), timestamp, ctx.time_domain,
                         ctx.timestamp()))

    class RichCounter(p.fn.RichFunction, PF):
        """Keyed state through the runtime context."""

        def open(self, configuration):
            self.st = self.get_runtime_context().get_state(count_desc)

        def process_element(self, value, ctx, out):
            self.st.update((self.st.value() or 0) + value[1])
            out.collect((ctx.get_current_key(), self.st.value()))

    return SimpleNamespace(Splitter=Splitter, Waiter=Waiter, Counter=Counter,
                           ProcTimer=ProcTimer, RichCounter=RichCounter,
                           tag=tag)


def test_process_function_with_side_output():
    events = _events(n=200)

    def job(pkg, env):
        c = _classes(pkg)
        main, side = [], []
        s = _timestamped(pkg, env, events).process(c.Splitter())
        s.collect_into(main)
        s.get_side_output(c.tag).collect_into(side)
        return [main, side]

    got = _assert_same(job)
    assert got[0] and got[1]


def test_keyed_process_function_with_timers_reference_case():
    def job(pkg, env):
        out = []
        (env.from_collection([(("k", 500), 500)], timestamped=True)
            .key_by(lambda t: t[0])
            .process(_classes(pkg).Waiter())
            .collect_into(out))
        return out

    assert _assert_same(job) == [("k", 600, "event")]


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("fn", ["Counter", "ProcTimer", "RichCounter"])
def test_keyed_process_functions_match(fn, backend):
    events = _events(n=500, span=6000)

    def job(pkg, env):
        out = []
        (_timestamped(pkg, env, events, bound=50)
            .key_by(lambda e: e[0])
            .process(getattr(_classes(pkg), fn)())
            .collect_into(out))
        return out

    got = _assert_same(job, backend=backend)
    assert got


def test_keyed_process_function_at_parallelism_2():
    events = _events(n=500, n_keys=12, span=6000)

    def job(pkg, env):
        out = []
        (_timestamped(pkg, env, events).set_parallelism(1)
            .key_by(lambda e: e[0])
            .process(_classes(pkg).Counter())
            .collect_into(out))
        return out

    _assert_same(job, parallelism=2, order=sorted)


def _hll_fn(pkg):
    p = P[pkg]
    desc = p.st.AggregatingStateDescriptor("users", p.hll(12))

    class DistinctPerSecond(p.ops.ProcessFunction):
        """The distinct users of each key in each second, emitted at an
        event-time timer at the second's end; the state is cleared."""

        def process_element(self, value, ctx, out):
            ctx.get_state(desc).add(value[1])
            ctx.register_event_time_timer(value[2] - value[2] % 1000 + 999)

        def on_timer(self, timestamp, ctx, out):
            st = ctx.get_state(desc)
            out.collect((ctx.get_current_key(), timestamp, float(st.get())))
            st.clear()

    return DistinctPerSecond(), desc


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_hll_aggregating_state_in_process_function(backend):
    rng = np.random.default_rng(3)
    n = 3000
    events = list(zip(rng.integers(0, 20, n).tolist(),
                      rng.integers(0, 10_000, n).tolist(),
                      np.sort(rng.integers(0, 4000, n)).tolist()))
    states = []

    def job(pkg, env):
        out = []
        fn, desc = _hll_fn(pkg)
        stream = (_timestamped(pkg, env, events)
                  .key_by(lambda e: e[0]).process(fn))
        stream.collect_into(out)
        if pkg == "torch":
            states.append(desc)
        return out

    got, want = _run_both(job, backend=backend)
    assert [r[:2] for r in got] == [r[:2] for r in want]
    np.testing.assert_allclose([r[2] for r in got], [r[2] for r in want],
                               rtol=1e-5, atol=hll_atol(4096))
    # and the heap backend's answer in the port
    heap, _ = _run_both(job, backend="heap")
    np.testing.assert_allclose([r[2] for r in got], [r[2] for r in heap],
                               rtol=1e-5, atol=hll_atol(4096))


def test_gpu_backend_gives_a_process_function_the_device_state():
    env = _env("torch", "gpu")
    got = []

    class Probe(tops.ProcessFunction):
        def process_element(self, value, ctx, out):
            got.append(type(ctx.get_state(
                tstate.AggregatingStateDescriptor("u", TorchHll(12)))))

    env.from_collection([(1, 2, 3)]).key_by(lambda e: e[0]) \
        .process(Probe()).collect_into([])
    env.execute("probe")
    assert got == [DeviceAggregatingState]


def test_process_on_stream_without_keys_has_no_keyed_state():
    def job(pkg, env):
        p = P[pkg]
        desc = p.st.ValueStateDescriptor("x")
        out = []

        class Bad(p.fn.RichFunction, p.ops.ProcessFunction):
            def open(self, configuration):
                try:
                    self.get_runtime_context().get_state(desc)
                except RuntimeError as e:
                    out.append(str(e))

            def process_element(self, value, ctx, out_):
                pass

        env.from_collection([1]).process(Bad()).collect_into([])
        return out

    got = _assert_same(job)
    assert "key_by" in got[0]


# ---------------------------------------------------------------------
# windowed join and coGroup; the row interval join
# ---------------------------------------------------------------------

def _two_streams(env):
    orders = env.from_collection(
        [(("o1", "k1", 10), 100), (("o2", "k2", 20), 200),
         (("o3", "k1", 30), 1500)], timestamped=True)
    users = env.from_collection(
        [(("k1", "alice"), 150), (("k2", "bob"), 250)], timestamped=True)
    return orders, users


def test_windowed_join_and_cogroup_reference_cases():
    def job(pkg, env):
        w = P[pkg].w
        j, c = [], []
        orders, users = _two_streams(env)
        (orders.join(users).where(lambda o: o[1]).equal_to(lambda u: u[0])
            .window(w.TumblingEventTimeWindows.of(1000))
            .apply(lambda o, u: (o[0], u[1])).collect_into(j))
        orders, users = _two_streams(env)
        (orders.co_group(users).where(lambda o: o[1])
            .equal_to(lambda u: u[0])
            .window(w.TumblingEventTimeWindows.of(1000))
            .apply(lambda ls, rs: [(len(ls), len(rs))]).collect_into(c))
        return [j, c]

    assert _assert_same(job, order=_each_sorted) == [[("o1", "alice"), ("o2", "bob")],
                                 [(1, 0), (1, 1), (1, 1)]]


@pytest.mark.parametrize("kind", ["join", "co_group", "sliding_join",
                                  "interval", "interval_strict_left"])
def test_joins_match(kind):
    left = _events(n=300, n_keys=5, seed=4)
    right = _events(n=300, n_keys=5, seed=5)

    def job(pkg, env):
        w = P[pkg].w
        out = []
        a = _timestamped(pkg, env, left)
        b = _timestamped(pkg, env, right)
        if kind == "interval":
            s = (a.interval_join(b).where(lambda e: e[0])
                 .equal_to(lambda e: e[0]).between(-200, 100)
                 .apply(lambda l, r: (l[1], r[1], l[2], r[2])))
        elif kind == "interval_strict_left":
            s = (a.interval_join(b).where(lambda e: e[0])
                 .equal_to(lambda e: e[0]).between(0, 0)
                 .apply(lambda l, r: (l, r)))
        else:
            assigner = (w.SlidingEventTimeWindows.of(1000, 500)
                        if kind == "sliding_join"
                        else w.TumblingEventTimeWindows.of(1000))
            joined = a.co_group(b) if kind == "co_group" else a.join(b)
            fn = ((lambda ls, rs: [(len(ls), len(rs), sum(x[1] for x in ls))])
                  if kind == "co_group" else (lambda l, r: (l[1], r[1])))
            s = (joined.where(lambda e: e[0]).equal_to(lambda e: e[0])
                 .window(assigner).apply(fn))
        s.collect_into(out)
        return out

    got = _assert_same(job, order=sorted)
    if kind != "interval_strict_left":
        assert got


def test_interval_join_bounds_error_matches():
    outs = []
    for pkg in ("torch", "jax"):
        env = _env(pkg)
        a = env.from_collection([1])
        with pytest.raises(ValueError) as e:
            a.interval_join(a).where(lambda x: x).equal_to(lambda x: x) \
                .between(5, 1)
        outs.append(str(e.value))
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------
# partitioners and chaining
# ---------------------------------------------------------------------

def test_rebalance_broadcast_global_reference_cases():
    def job(pkg, env):
        out, out2 = [], []
        env.from_collection([1, 2, 3, 4]).rebalance().map(lambda x: x) \
            .set_parallelism(2).global_().map(lambda x: x).collect_into(out)
        env.from_collection([7]).broadcast().map(lambda x: x) \
            .set_parallelism(3).collect_into(out2)
        return [out, out2]

    assert _assert_same(job, order=_each_sorted) == [[1, 2, 3, 4], [7, 7, 7]]


class _TagMixin:
    """Each subtask stamps its index on what it sees."""

    def open(self, configuration):
        self.idx = self.get_runtime_context().index_of_this_subtask

    def map(self, value):
        return (self.idx, value)


def _tagger(pkg):
    p = P[pkg]
    return type("Tag", (_TagMixin, p.fn.RichFunction, p.fn.MapFunction), {})()


ROUTES = {
    "global": lambda s: s.global_(),
    "broadcast": lambda s: s.broadcast(),
    "custom": lambda s: s.partition_custom(lambda k, n: k % n),
    "custom_key": lambda s: s.partition_custom(lambda k, n: k % n,
                                               lambda v: v // 10),
    "forward": lambda s: s.forward(),
    "key_by": lambda s: s.key_by(lambda v: v % 7),
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_deterministic_partitioner_routing_matches(name):
    """Every record's subtask, for the partitioners whose choice is
    fixed by the record."""
    def job(pkg, env):
        out = []
        src = env.from_collection(list(range(60)))
        if name == "forward":
            src = src.map(lambda v: v).set_parallelism(3)
        ROUTES[name](src).map(_tagger(pkg)).set_parallelism(3) \
            .collect_into(out)
        return out

    got = _assert_same(job, order=sorted)
    if name == "custom":
        assert all(i == v % 3 for i, v in got)
    if name == "broadcast":
        assert len(got) == 180
    if name == "global":
        assert {i for i, _ in got} == {0}


@pytest.mark.parametrize("name", ["rebalance", "rescale", "shuffle"])
def test_spreading_partitioners_keep_every_record(name):
    """Rebalance and rescale start at a random channel, shuffle is
    random: each delivers every record once and uses several
    subtasks."""
    env = _env("torch")
    out = []
    src = env.from_collection(list(range(300)))
    if name == "rescale":
        src = src.map(lambda v: v).set_parallelism(2)
    getattr(src, name)().map(_tagger("torch")).set_parallelism(4) \
        .collect_into(out)
    env.execute("spread")
    assert sorted(v for _, v in out) == list(range(300))
    assert len({i for i, _ in out}) > 1
    if name == "rescale":
        # pointwise: each upstream subtask feeds its own two subtasks
        edge = [e for e in env.graph.edges
                if isinstance(e.partitioner, tpart.RescalePartitioner)]
        assert edge and edge[0].partitioner.is_pointwise


@pytest.mark.parametrize("cls", ["RescalePartitioner", "ShufflePartitioner",
                                 "BroadcastPartitioner", "GlobalPartitioner"])
def test_partitioner_channels_and_batches(cls):
    from flink_tpu_torch.streaming.elements import RecordBatch
    part = getattr(tpart, cls)()
    part.setup(4)
    chans = [c for _ in range(40) for c in part.select_channels(1, 4)]
    assert all(0 <= c < 4 for c in chans)
    batch = RecordBatch({"v": np.arange(10)})
    split = part.split_batch(batch, 4)
    assert sum(len(b) for _, b in split) == (40 if cls == "BroadcastPartitioner"
                                             else 10)
    assert repr(part) == repr(getattr(jpart, cls)())
    if cls == "RescalePartitioner":
        assert chans[:8] == [0, 1, 2, 3, 0, 1, 2, 3]


def test_custom_partitioner_wrapper_matches():
    for key_sel in (None, lambda v: v * 3):
        t = tpart.CustomPartitionerWrapper(
            lambda k, n: k + 1, tfn.as_key_selector(key_sel) if key_sel else None)
        j = jpart.CustomPartitionerWrapper(
            lambda k, n: k + 1, jfn.as_key_selector(key_sel) if key_sel else None)
        assert [t.select_channels(v, 5) for v in range(20)] == \
            [j.select_channels(v, 5) for v in range(20)]


CHAINS = {
    "all_forward": lambda s: s.map(lambda x: x).filter(lambda x: True),
    "key_by_breaks": lambda s: s.key_by(lambda x: x % 2).sum(),
    "disable_chaining": lambda s: s.map(lambda x: x).disable_chaining()
    .map(lambda x: x + 1),
    "start_new_chain": lambda s: s.map(lambda x: x).map(lambda x: x + 1)
    .start_new_chain().map(lambda x: x * 2),
    "rebalance_breaks": lambda s: s.rebalance().map(lambda x: x),
    "parallel_forward": lambda s: s.rebalance().map(lambda x: x)
    .set_parallelism(2).disable_chaining().map(lambda x: x)
    .set_parallelism(2).disable_chaining(),
}


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_chaining_controls_match(name):
    outs = []
    for pkg in ("torch", "jax"):
        env = _env(pkg)
        out = []
        CHAINS[name](env.from_collection(list(range(1, 7)))).collect_into(out)
        jg = P[pkg].graph.create_job_graph(env.get_stream_graph())
        shape = sorted(tuple(n.name for n in v.chain)
                       for v in jg.vertices.values())
        env.execute("chain")
        outs.append((shape, len(jg.edges), sorted(out)))
    assert outs[0] == outs[1]
    if name == "all_forward":
        assert len(outs[0][0]) == 1
