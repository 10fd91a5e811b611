"""Queryable state in the port against the JAX package, on the CPU: the
ten cases of ``tests/test_queryable_state.py``, each on the heap and on
the GPU backend (``device="cpu"``) against the reference's answer, and a
stress case: a query thread reading HLL estimates while the owner's
thread adds, flushes, spills and clears, with no exception and no
answer outside the estimates the key has held.

Every live job runs through ``execute_async`` and is cancelled and
waited on with a time limit; every thread is joined with one.
"""

import sys
import threading
import time

import numpy as np
import pytest

import flink_tpu.core.functions as jfn
import flink_tpu.core.keygroups as jkg
import flink_tpu.core.state as jstate
import flink_tpu.ops.device_agg as jda
import flink_tpu.runtime.queryable as jq
import flink_tpu.state.loader as jloader
import flink_tpu_torch.core.functions as tfn
import flink_tpu_torch.core.keygroups as tkg
import flink_tpu_torch.core.state as tstate
import flink_tpu_torch.ops.device_agg as tda
import flink_tpu_torch.runtime.queryable as tq
import flink_tpu_torch.state.loader as tloader
from flink_tpu.ops.sketches import HyperLogLogAggregate as JaxHll
from flink_tpu.streaming import datastream as jds
from flink_tpu.streaming import sources as jsrc
from flink_tpu.state.tpu_backend import TpuKeyedStateBackend
from flink_tpu_torch.ops.sketches import HyperLogLogAggregate as TorchHll
from flink_tpu_torch.state.gpu_backend import GpuKeyedStateBackend
from flink_tpu_torch.streaming import datastream as tds
from flink_tpu_torch.streaming import sources as tsrc
from torch_port_util import assert_hll_close

import test_torch_operator_state as opst

PKG = {"torch": dict(ds=tds, src=tsrc, q=tq, state=tstate, da=tda, fn=tfn,
                     kg=tkg, loader=tloader),
       "jax": dict(ds=jds, src=jsrc, q=jq, state=jstate, da=jda, fn=jfn,
                   kg=jkg, loader=jloader)}
PKGS = ["torch", "jax"]
BACKENDS = ["heap", "gpu"]
FULL = (0, 127)


@pytest.fixture(autouse=True)
def _clean_registries():
    for pkg in PKGS:
        PKG[pkg]["q"].DEFAULT_REGISTRY.unregister_all()
    yield
    for pkg in PKGS:
        PKG[pkg]["q"].DEFAULT_REGISTRY.unregister_all()


def _env(pkg, backend):
    return opst._env(pkg, backend)


def _client(pkg, registry=None):
    return PKG[pkg]["q"].QueryableStateClient(registry)


def _device_backend(pkg, **kw):
    rng = PKG[pkg]["kg"].KeyGroupRange(*FULL)
    if pkg == "torch":
        return GpuKeyedStateBackend(rng, 128, device="cpu", **kw)
    return TpuKeyedStateBackend(rng, 128, **kw)


# ---------------------------------------------------------------------
# the reference's ten cases, on both backends
# ---------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_query_after_finite_job(backend):
    got = {}
    for pkg in PKGS:
        env = _env(pkg, backend)
        (env.from_collection([("a", 1), ("b", 5), ("a", 3)])
            .key_by(lambda v: v[0])
            .as_queryable_state("latest"))
        env.execute("queryable-finite")
        c = _client(pkg)
        got[pkg] = (c.get_kv_state("latest", "a"), c.get_kv_state("latest", "b"))
    assert got["torch"] == got["jax"] == (("a", 3), ("b", 5))


@pytest.mark.parametrize("backend", BACKENDS)
def test_query_unknown_state_or_key(backend):
    for pkg in PKGS:
        client = _client(pkg)
        with pytest.raises(KeyError):
            client.get_kv_state("nope", "k")
        env = _env(pkg, backend)
        (env.from_collection([("a", 1)])
            .key_by(lambda v: v[0])
            .as_queryable_state("s1"))
        env.execute("queryable-2")
        assert client.get_kv_state("s1", "never-seen") is None


class _CounterMixin:
    def __init__(self):
        self._running = True

    def run(self, ctx):
        i = 0
        while self._running:
            ctx.collect(("k", i))
            i += 1
            time.sleep(0.001)

    def cancel(self):
        self._running = False


@pytest.mark.parametrize("backend", BACKENDS)
def test_query_live_unbounded_job(backend):
    """Query while the job runs (a thread-hosted source)."""
    for pkg in PKGS:
        cls = type(f"Counter_{pkg}", (_CounterMixin, PKG[pkg]["src"].SourceFunction), {})
        env = _env(pkg, backend)
        (env.add_source(cls())
            .key_by(lambda v: v[0])
            .as_queryable_state("live"))
        client = env.execute_async("queryable-live")
        q = _client(pkg)
        deadline = time.time() + 10
        seen = None
        while time.time() < deadline:
            try:
                seen = q.get_kv_state("live", "k")
                if seen is not None and seen[1] > 10:
                    break
            except KeyError:
                pass
            time.sleep(0.01)
        client.cancel()
        client.wait(timeout=10)
        assert seen is not None and seen[1] > 10, pkg


@pytest.mark.parametrize("backend", BACKENDS)
def test_parallel_instances_route_by_key_group(backend):
    for pkg in PKGS:
        env = _env(pkg, backend)
        (env.from_collection([(f"k{i}", i) for i in range(40)])
            .rebalance()
            .map(lambda v: v, name="spread")
            .set_parallelism(4)
            .key_by(lambda v: v[0])
            .as_queryable_state("sharded"))
        env.execute("queryable-sharded")
        client = _client(pkg)
        for i in range(40):
            assert client.get_kv_state("sharded", f"k{i}") == (f"k{i}", i)


def test_custom_registry_isolated():
    for pkg in PKGS:
        reg = PKG[pkg]["q"].KvStateRegistry()
        with pytest.raises(KeyError):
            _client(pkg, reg).get_kv_state("anything", 1)


def test_registry_newest_registration_wins():
    for pkg in PKGS:
        kg = PKG[pkg]["kg"]
        reg = PKG[pkg]["q"].KvStateRegistry()
        reg.register("s", kg.KeyGroupRange(0, 63), "old-a", None)
        reg.register("s", kg.KeyGroupRange(64, 127), "old-b", None)
        reg.register("s", kg.KeyGroupRange(32, 95), "new", None)
        assert [e[1] for e in reg._entries["s"]] == ["new"]


@pytest.mark.parametrize("pkg", PKGS)
def test_query_device_backed_state(pkg):
    be = _device_backend(pkg)
    desc = PKG[pkg]["state"].AggregatingStateDescriptor(
        "dev_sum", PKG[pkg]["da"].SumAggregate(np.float64))
    st = be.get_partitioned_state((), desc)
    for k, v in [("a", 2.0), ("b", 5.0), ("a", 3.0)]:
        be.set_current_key(k)
        st.add(v)
    PKG[pkg]["q"].DEFAULT_REGISTRY.register(
        "dev_sum", PKG[pkg]["kg"].KeyGroupRange(*FULL), be, desc)
    client = _client(pkg)
    st._flush()
    assert client.get_kv_state("dev_sum", "a", namespace=()) == 5.0
    assert client.get_kv_state("dev_sum", "b", namespace=()) == 5.0
    assert client.get_kv_state("dev_sum", "nope", namespace=()) is None
    be.set_current_key("a")
    st.add(10.0)
    assert client.get_kv_state("dev_sum", "a", namespace=()) == 5.0
    st._flush()
    assert client.get_kv_state("dev_sum", "a", namespace=()) == 15.0


@pytest.mark.parametrize("pkg", PKGS)
def test_query_device_state_spilled_to_host_tier(pkg):
    be = _device_backend(pkg, initial_capacity=8, microbatch=2,
                         max_device_slots=8)
    desc = PKG[pkg]["state"].AggregatingStateDescriptor(
        "spill_sum", PKG[pkg]["da"].SumAggregate(np.float64))
    st = be.get_partitioned_state((), desc)
    keys = [f"k{i}" for i in range(40)]
    st.add_batch(keys, (), np.arange(40, dtype=np.float64))
    st._flush()
    assert st.evictions > 0 and st.host_tier
    spilled = next(iter(st.host_tier))[0]
    PKG[pkg]["q"].DEFAULT_REGISTRY.register(
        "spill_sum", PKG[pkg]["kg"].KeyGroupRange(*FULL), be, desc)
    client = _client(pkg)
    promotions = st.promotions
    stamps = list(st._access_stamp)
    key_before = be.current_key
    assert client.get_kv_state("spill_sum", spilled, namespace=()) == float(spilled[1:])
    assert st.promotions == promotions
    assert list(st._access_stamp) == stamps and be.current_key == key_before
    resident = st.slot_meta[[s for s in range(st.capacity)
                             if st.slot_meta[s] is not None][0]][0]
    assert client.get_kv_state("spill_sum", resident,
                               namespace=()) == float(resident[1:])


class _TupleSumMixin:
    def extract_value(self, v):
        return v[1]


def test_query_device_state_through_job_api():
    got = {}
    for pkg in PKGS:
        agg_cls = type(f"TupleSum_{pkg}", (_TupleSumMixin, PKG[pkg]["da"].SumAggregate), {})
        env = _env(pkg, "gpu")
        (env.from_collection([("a", 1.0), ("b", 5.0), ("a", 3.0)])
            .key_by(lambda v: v[0])
            .as_queryable_state(
                "dev_totals",
                PKG[pkg]["state"].AggregatingStateDescriptor(
                    "dev_totals", agg_cls(np.float64))))
        env.execute("queryable-device")
        c = _client(pkg)
        got[pkg] = (c.get_kv_state("dev_totals", "a"), c.get_kv_state("dev_totals", "b"))
    assert got["torch"] == got["jax"] == (4.0, 5.0)


@pytest.mark.parametrize("pkg", PKGS)
def test_query_new_key_with_only_pending_adds_is_invisible(pkg):
    be = _device_backend(pkg)
    desc = PKG[pkg]["state"].AggregatingStateDescriptor(
        "pend_sum", PKG[pkg]["da"].SumAggregate(np.float64))
    st = be.get_partitioned_state((), desc)
    be.set_current_key("fresh")
    st.add(7.0)
    PKG[pkg]["q"].DEFAULT_REGISTRY.register(
        "pend_sum", PKG[pkg]["kg"].KeyGroupRange(*FULL), be, desc)
    client = _client(pkg)
    assert client.get_kv_state("pend_sum", "fresh", namespace=()) is None
    st._flush()
    assert client.get_kv_state("pend_sum", "fresh", namespace=()) == 7.0


class _PyAvgMixin:
    def create_accumulator(self):
        return (0.0, 0)

    def add(self, v, acc):
        return (acc[0] + v, acc[1] + 1)

    def get_result(self, acc):
        return acc[0] / acc[1]

    def merge(self, a, b):
        return (a[0] + b[0], a[1] + b[1])


@pytest.mark.parametrize("backend", BACKENDS)
def test_query_all_state_kinds_both_backends(backend):
    answers = {}
    for pkg in PKGS:
        name = {"heap": "heap", "gpu": "gpu" if pkg == "torch" else "tpu"}[backend]
        kw = {"device": "cpu"} if pkg == "torch" else {}
        b = PKG[pkg]["loader"].load_state_backend(
            name, PKG[pkg]["kg"].KeyGroupRange(*FULL), 128, **kw)
        b.set_current_key(5)
        st = PKG[pkg]["state"]
        avg = type(f"PyAvg_{pkg}", (_PyAvgMixin, PKG[pkg]["fn"].AggregateFunction), {})
        descs = {"qv": st.ValueStateDescriptor("qv"),
                 "ql": st.ListStateDescriptor("ql"),
                 "qm": st.MapStateDescriptor("qm"),
                 "qr": st.ReducingStateDescriptor("qr", lambda a, c: a + c),
                 "qa": st.AggregatingStateDescriptor("qa", avg())}
        states = {n: b.get_or_create_keyed_state(d) for n, d in descs.items()}
        states["qv"].update(7)
        states["ql"].add(1)
        states["ql"].add(2)
        states["qm"].put("k", 3)
        states["qr"].add(4)
        states["qr"].add(6)
        states["qa"].add(2.0)
        states["qa"].add(4.0)
        reg = PKG[pkg]["q"].KvStateRegistry()
        client = _client(pkg, reg)
        for n, d in descs.items():
            reg.register(n, PKG[pkg]["kg"].KeyGroupRange(*FULL), b, d)
        answers[pkg] = [client.get_kv_state(n, 5) for n in descs]
    assert answers["torch"] == answers["jax"] == [7, [1, 2], {"k": 3}, 10, 3.0]


# ---------------------------------------------------------------------
# HLL on the GPU backend through the job API; the stress case
# ---------------------------------------------------------------------

class _ItemHllMixin:
    def extract_value(self, v):
        return v[1]


def test_query_hll_through_job_api_equals_the_reference():
    rng = np.random.default_rng(7)
    events = [(f"u{int(k)}", int(v)) for k, v in
              zip(rng.integers(0, 60, 6000), rng.integers(0, 3000, 6000))]
    got = {}
    for pkg in PKGS:
        base = TorchHll if pkg == "torch" else JaxHll
        agg = type(f"ItemHll_{pkg}", (_ItemHllMixin, base), {})(10)
        env = _env(pkg, "gpu")
        (env.from_collection(events).key_by(lambda v: v[0])
            .as_queryable_state("uv", PKG[pkg]["state"].AggregatingStateDescriptor(
                "uv", agg)))
        env.execute("queryable-hll")
        c = _client(pkg)
        got[pkg] = np.array([c.get_kv_state("uv", f"u{i}") for i in range(60)],
                            np.float64)
    assert_hll_close(got["torch"], got["jax"], m=1 << 10)


def test_query_thread_against_a_flushing_loop():
    """One query thread reads while the owner adds in micro-batches of 7,
    spills past a 32-slot budget, fires and clears: no exception, and
    every answer is None or an estimate the key held after some flush
    (an answer from a row another key reused would not be)."""
    be = GpuKeyedStateBackend(tkg.KeyGroupRange(*FULL), 128, device="cpu",
                              initial_capacity=8, microbatch=7,
                              max_device_slots=32)
    desc = tstate.AggregatingStateDescriptor("uv", TorchHll(8))
    st = be.get_partitioned_state((), desc)
    reg = tq.KvStateRegistry()
    reg.register("uv", tkg.KeyGroupRange(*FULL), be, desc)
    client = tq.QueryableStateClient(reg)
    keys = [f"k{i}" for i in range(200)]
    held = {k: {None} for k in keys}
    stop = threading.Event()
    answers, errors = [], []

    def query():
        rng = np.random.default_rng(1)
        while not stop.is_set():
            k = keys[int(rng.integers(0, len(keys)))]
            try:
                answers.append((k, client.get_kv_state("uv", k)))
            except Exception as e:  # noqa: BLE001 - the test's finding
                errors.append(e)
                return

    flush_locked = st._flush_locked

    def flush_and_record(n):
        # every state a query can see follows a flush (spills and
        # promotions move rows, clears empty them): record each key's
        # estimate after every flush, inside the same lock
        flush_locked(n)
        live = [(k, st.slot_index[(k, ())]) for k in keys
                if (k, ()) in st.slot_index
                and st._slot_flushed[st.slot_index[(k, ())]]]
        if live:
            res = st._result(st.device_state, st._slots([s for _, s in live]))
            for (k, _), r in zip(live, res):
                held[k].add(float(r))

    st._flush_locked = flush_and_record
    t = threading.Thread(target=query, daemon=True)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    t.start()
    try:
        rng = np.random.default_rng(2)
        for step in range(300):
            batch = [keys[int(i)] for i in rng.integers(0, len(keys), 21)]
            be.add_batch(st, batch, (), [int(v) for v in rng.integers(0, 10 ** 6, 21)])
            st._flush()
            if step % 25 == 24:
                gone = [keys[int(i)] for i in rng.integers(0, len(keys), 5)]
                be.clear_batch(st, gone, ())
    finally:
        stop.set()
        t.join(10)
        sys.setswitchinterval(switch)
    assert not t.is_alive() and not errors, errors
    assert st.evictions > 0 and len(answers) > 100
    for k, a in answers:
        assert (None if a is None else float(a)) in held[k], (k, a)


class _HostEvent:
    """A CUDA timing event stand-in: each pair brackets one launch, so
    its elapsed time is 1 unless another launch's record fell between."""

    clock = [0]

    def record(self):
        _HostEvent.clock[0] += 1
        self.t = _HostEvent.clock[0]

    def query(self):
        return True

    def elapsed_time(self, other):
        return other.t - self.t


def test_launches_from_two_threads_lose_no_count_and_tear_no_pair(monkeypatch):
    """A query thread launches while the loop launches: with a 1 µs
    switch interval and the launch ledger on, eight threads' launches
    are every one counted in ``LAUNCHES`` and in the ledger, and every
    event pair brackets its own launch only."""
    from flink_tpu_torch.kernels import loader
    from flink_tpu_torch.runtime import tracing

    ledger = tracing.LaunchLedger(max_pending=1 << 20)
    ledger.event_factory = _HostEvent
    ledger.current_device = lambda: 0
    ledger.synchronize = lambda dev: None
    monkeypatch.setattr(tracing, "LAUNCH_LEDGER", ledger)
    monkeypatch.setattr(tracing._tracer, "enabled", True)
    monkeypatch.setattr(loader, "current_stream", lambda: 0)
    monkeypatch.setitem(loader._functions, "ft_test_launch",
                        lambda *args: _HostEvent().record() or 0)
    before = loader.LAUNCHES["hll_estimate"]
    n_threads, per_thread = 8, 2000
    done = []

    def worker():
        for _ in range(per_thread):
            loader.launch("hll_estimate", "ft_test_launch")
        done.append(True)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(n_threads)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads) and len(done) == n_threads
    n = n_threads * per_thread
    assert loader.LAUNCHES["hll_estimate"] - before == n
    st = ledger.stats()["cuda.hll_estimate"]
    assert st["launches"] == st["timed"] == n
    # start, the launch's own record, end: 2 units a pair, never more
    assert st["device_ms"] == 2 * n
