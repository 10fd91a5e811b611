"""The port's keyed-state backends against the JAX package's, on the
same numpy inputs: ``load_state_backend("gpu", device="cpu")`` (device
states in CPU tensors, the kernels' plain versions) against JAX's
``"tpu"`` on its CPU, and ``"heap"`` against ``"heap"``.

Sum/Count/Min/Max/Avg on integer-valued data are exact; HLL registers
are compared bit for bit through ``snapshot_columns`` and estimates
within ``torch_port_util.assert_hll_close``.  Snapshots cross between
the packages in both directions as plain chunk bytes and a meta dict.
"""

import pickle
import pickletools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_tpu.core import keygroups as jkg
from flink_tpu.core.config import Configuration as JaxConfiguration
from flink_tpu.core.serialization import SerializerConfigSnapshot
from flink_tpu.core.state import AggregatingStateDescriptor as JaxAggDesc
from flink_tpu.core.state import ReducingStateDescriptor as JaxRedDesc
from flink_tpu.ops import device_agg as jda
from flink_tpu.ops.sketches import HyperLogLogAggregate as JaxHll
from flink_tpu.state.backend import KeyedStateSnapshot as JaxSnapshot
from flink_tpu.state.loader import load_state_backend as jax_load
from flink_tpu_torch import kernels as K
from flink_tpu_torch.core import keygroups as tkg
from flink_tpu_torch.core.config import Configuration
from flink_tpu_torch.core.state import AggregatingStateDescriptor as TorchAggDesc
from flink_tpu_torch.core.state import ReducingStateDescriptor as TorchRedDesc
from flink_tpu_torch.ops import device_agg as tda
from flink_tpu_torch.ops.sketches import HyperLogLogAggregate as TorchHll
from flink_tpu_torch.state import (GpuKeyedStateBackend, HeapKeyedStateBackend,
                                   snapshot_from_chunks)
from flink_tpu_torch.state.loader import load_state_backend as torch_load
from torch_port_util import assert_hll_close

MAX_PAR = 128
P = 8
AGGS = {"sum": ("SumAggregate", (np.float32,)), "count": ("CountAggregate", ()),
        "min": ("MinAggregate", (np.float32,)), "max": ("MaxAggregate", (np.float32,)),
        "avg": ("AvgAggregate", ())}


def _agg(pkg, name):
    if name == "hll":
        return (TorchHll if pkg == "torch" else JaxHll)(P)
    cls, args = AGGS[name]
    return getattr(tda if pkg == "torch" else jda, cls)(*args)


def _backend(pkg, name, rng=None, **kw):
    rng = rng or tkg.KeyGroupRange(0, MAX_PAR - 1)
    if pkg == "torch":
        return torch_load(name, rng, MAX_PAR, device="cpu", **kw)
    return jax_load(name, jkg.KeyGroupRange(rng.start_key_group, rng.end_key_group),
                    MAX_PAR, **kw)


def _state(pkg, backend, agg_name, name="s"):
    desc = (TorchAggDesc if pkg == "torch" else JaxAggDesc)(name, _agg(pkg, agg_name))
    return backend.get_or_create_keyed_state(desc)


def _rows(seed=3, n=400, n_keys=23, n_ns=4):
    rng = np.random.default_rng(seed)
    keys = [int(k) for k in rng.integers(0, n_keys, n)]
    nss = [(int(w) * 100, int(w) * 100 + 100) for w in rng.integers(0, n_ns, n)]
    vals = rng.integers(-50, 100, n).astype(np.float64)
    return keys, nss, vals


def _read(backend, st, pairs):
    out = []
    for k, ns in pairs:
        backend.set_current_key(k)
        st.set_current_namespace(ns)
        v = st.get()
        out.append(None if v is None else float(v))
    return out


def _pairs(keys, nss):
    return sorted(set(zip(keys, nss)))


def _regs(st):
    """{(key, namespace): register row} of a device HLL state."""
    out = {}
    for keys, nss, comps in st.snapshot_columns().values():
        for k, ns, row in zip(keys, nss, comps["regs"]):
            out[(k, tuple(ns))] = np.asarray(row)
    return out


# ---------------------------------------------------------------------
# key groups
# ---------------------------------------------------------------------

def test_key_groups_bit_equal():
    keys = list(range(-300, 3000, 7)) + ["a", "b", ("x", 1), 2**40]
    for mp in (1, 7, 128, 4096):
        assert [tkg.assign_to_key_group(k, mp) for k in keys] == \
               [jkg.assign_to_key_group(k, mp) for k in keys]
        h = tkg.stable_hashes_np(keys)
        np.testing.assert_array_equal(tkg.assign_key_groups_np(h, mp),
                                      jkg.assign_key_groups_np(h, mp))
        for par in (1, 3, 5):
            for i in range(par):
                t = tkg.compute_key_group_range_for_operator_index(mp, par, i)
                j = jkg.compute_key_group_range_for_operator_index(mp, par, i)
                assert (t.start_key_group, t.end_key_group) == \
                       (j.start_key_group, j.end_key_group)
    for par in (1, 90, 200, 40_000):
        assert tkg.compute_default_max_parallelism(par) == \
               jkg.compute_default_max_parallelism(par)


# ---------------------------------------------------------------------
# add / add_batch / get_batch / clear_batch
# ---------------------------------------------------------------------

@pytest.mark.parametrize("agg_name", ["sum", "count", "min", "max", "avg"])
def test_add_batch_matches_jax_and_scalar_adds(agg_name):
    keys, nss, vals = _rows()
    pairs = _pairs(keys, nss)
    results = []
    for pkg, name in (("torch", "gpu"), ("jax", "tpu"), ("torch", "heap")):
        b = _backend(pkg, name)
        st = _state(pkg, b, agg_name)
        assert b.add_batch(st, keys[:250], None, vals[:250],
                           namespaces=nss[:250]) == "batch"
        for k, ns, v in zip(keys[250:], nss[250:], vals[250:]):
            b.set_current_key(k)
            st.set_current_namespace(ns)
            st.add(float(v))
        results.append(_read(b, st, pairs))
    assert results[0] == results[1] == results[2]


def test_get_batch_and_clear_batch():
    keys, nss, vals = _rows(seed=5)
    pairs = _pairs(keys, nss)
    got = {}
    for pkg, name in (("torch", "gpu"), ("jax", "tpu")):
        b = _backend(pkg, name, microbatch=64)
        st = _state(pkg, b, "sum")
        b.add_batch(st, keys, None, vals, namespaces=nss)
        probe = [k for k, _ in pairs] + [999]
        probe_ns = [ns for _, ns in pairs] + [(0, 100)]
        res, found, path = b.get_batch(st, probe, None, namespaces=probe_ns)
        assert path == "batch" and not found[-1] and found[:-1].all()
        half = pairs[::2]
        b.clear_batch(st, [k for k, _ in half], None,
                      namespaces=[ns for _, ns in half])
        got[pkg] = (np.asarray(res)[:-1].tolist(), _read(b, st, pairs))
    assert got["torch"] == got["jax"]
    assert got["torch"][1][::2] == [None] * len(pairs[::2])


def test_pending_rows_read_as_absent_until_flushed():
    b = _backend("torch", "gpu", microbatch=1000)
    st = _state("torch", b, "sum")
    b.add_batch(st, [1, 2], (0, 10), np.array([3.0, 4.0]))
    assert len(st._pending_slots) == 2
    assert not any(st._slot_flushed[s] for s in st.slot_index.values())
    b.set_current_key(1)
    st.set_current_namespace((0, 10))
    assert st.get() == 3.0   # get() flushes first
    assert all(st._slot_flushed[s] for s in st.slot_index.values())


def test_hll_registers_bit_equal_and_estimates_close():
    rng = np.random.default_rng(8)
    n = 3000
    keys = [int(k) for k in rng.integers(0, 40, n)]
    nss = [(0, 1000)] * n
    vals = [int(v) for v in rng.integers(0, 5000, n)]
    pairs = _pairs(keys, nss)
    out = {}
    for pkg, name in (("torch", "gpu"), ("jax", "tpu")):
        b = _backend(pkg, name, microbatch=512)
        st = _state(pkg, b, "hll")
        b.add_batch(st, keys, None, vals, namespaces=nss)
        est = _read(b, st, pairs)
        out[pkg] = (_regs(st), est)
    assert out["torch"][0].keys() == out["jax"][0].keys()
    for e, row in out["torch"][0].items():
        np.testing.assert_array_equal(row, out["jax"][0][e])
    assert_hll_close(out["torch"][1], out["jax"][1], 1 << P)


# ---------------------------------------------------------------------
# session merges
# ---------------------------------------------------------------------

def _merge_run(pkg, name, agg_name, batched):
    b = _backend(pkg, name)
    st = _state(pkg, b, agg_name)
    rng = np.random.default_rng(11)
    targets = [("a",), ("b",), ("c",), ("d",)]
    for k in range(6):
        n = 40
        ks = [k] * n
        nss = [targets[i] for i in rng.integers(0, 4, n)]
        vs = [int(v) for v in rng.integers(0, 300, n)]
        b.add_batch(st, ks, None, vs if agg_name == "hll" else np.array(vs, np.float64),
                    namespaces=nss)
    merges = [(k, ("a",), [("b",), ("c",), ("d",)]) for k in range(5)]
    merges.append((5, ("z",), [("b",), ("d",)]))   # fresh target
    if batched:
        st.merge_namespaces_batch(merges)
    else:
        for k, target, sources in merges:
            b.set_current_key(k)
            st.merge_namespaces(target, sources)
    pairs = [(k, ns) for k in range(6) for ns in targets + [("z",)]]
    return _read(b, st, pairs), (_regs(st) if agg_name == "hll" and name != "heap"
                                 else None)


@pytest.mark.parametrize("agg_name", ["sum", "max", "avg", "hll"])
def test_merge_namespaces_match_jax(agg_name):
    seq, regs_seq = _merge_run("torch", "gpu", agg_name, batched=False)
    bat, regs_bat = _merge_run("torch", "gpu", agg_name, batched=True)
    ref, regs_ref = _merge_run("jax", "tpu", agg_name, batched=False)
    heap, _ = _merge_run("torch", "heap", agg_name, batched=False)
    assert seq == bat
    if agg_name == "hll":
        for e, row in regs_ref.items():
            np.testing.assert_array_equal(regs_seq[e], row)
            np.testing.assert_array_equal(regs_bat[e], row)
        assert regs_seq.keys() == regs_ref.keys() == regs_bat.keys()
        ok = [i for i, v in enumerate(ref) if v is not None]
        assert [i for i, v in enumerate(seq) if v is not None] == ok
        assert_hll_close([seq[i] for i in ok], [ref[i] for i in ok], 1 << P)
        assert_hll_close([heap[i] for i in ok], [ref[i] for i in ok], 1 << P)
    else:
        assert seq == ref == heap


# ---------------------------------------------------------------------
# the capped device tier: eviction and promotion
# ---------------------------------------------------------------------

@pytest.mark.parametrize("agg_name", ["sum", "hll"])
def test_capped_backend_spills_and_promotes(agg_name):
    rng = np.random.default_rng(13)
    n = 600
    keys = [int(k) for k in rng.integers(0, 60, n)]
    nss = [(int(w) * 10, int(w) * 10 + 10) for w in rng.integers(0, 3, n)]
    vals = [int(v) for v in rng.integers(0, 50, n)]
    pairs = _pairs(keys, nss)
    kw = dict(initial_capacity=8, max_device_slots=16, microbatch=32)
    out = {}
    for pkg, name, extra in (("torch", "gpu", kw), ("jax", "tpu", kw),
                             ("torch", "heap", {})):
        b = _backend(pkg, name, **extra)
        st = _state(pkg, b, agg_name)
        for i in range(0, n, 100):
            v = vals[i:i + 100]
            b.add_batch(st, keys[i:i + 100], None,
                        v if agg_name == "hll" else np.array(v, np.float64),
                        namespaces=nss[i:i + 100])
        if name != "heap":
            assert st.evictions > 0 and len(st.host_tier) > 0
        first = _read(b, st, pairs)   # reads promote spilled rows
        if name != "heap":
            assert st.promotions > 0
        out[(pkg, name)] = (first, _regs(st) if name != "heap" and agg_name == "hll"
                            else None)
    got, want = out[("torch", "gpu")], out[("jax", "tpu")]
    heap = out[("torch", "heap")][0]
    if agg_name == "hll":
        assert got[1].keys() == want[1].keys()
        for e, row in want[1].items():
            np.testing.assert_array_equal(got[1][e], row)
        assert_hll_close(got[0], want[0], 1 << P)
        assert_hll_close(heap, want[0], 1 << P)
    else:
        assert got[0] == want[0] == heap


def test_spilled_rows_survive_a_snapshot_into_jax():
    keys, nss, vals = _rows(seed=17, n=500, n_keys=50)
    pairs = _pairs(keys, nss)
    b = _backend("torch", "gpu", initial_capacity=8, max_device_slots=16,
                 microbatch=32)
    st = _state("torch", b, "sum")
    b.add_batch(st, keys, None, vals, namespaces=nss)
    b.flush_all()
    assert len(st.host_tier) > 0
    b2 = _restored("jax", "tpu", b.snapshot())
    want = _read(b2, b2._states["s"], pairs)
    got = _read(b, st, pairs)
    assert got == want


# ---------------------------------------------------------------------
# snapshots across the packages
# ---------------------------------------------------------------------

def _populate(pkg, name, agg_name="sum", **kw):
    keys, nss, vals = _rows(seed=21, n=300)
    b = _backend(pkg, name, **kw)
    st = _state(pkg, b, agg_name)
    b.add_batch(st, keys, None, vals if agg_name != "hll" else [int(v) for v in vals],
                namespaces=nss)
    red = b.get_or_create_keyed_state(
        (TorchRedDesc if pkg == "torch" else JaxRedDesc)("r", lambda a, c: a + c))
    b.add_batch(red, keys, ("fixed",), [int(v) for v in vals])
    return b, keys, nss


def _cross(snap, to_pkg):
    blobs, meta = dict(snap.blobs()), snap.meta
    return snapshot_from_chunks(blobs, meta) if to_pkg == "torch" else JaxSnapshot(blobs, meta)


def _restored(pkg, name, snap, agg_name="sum", rng=None):
    b = _backend(pkg, name, rng=rng)
    _state(pkg, b, agg_name)
    b.get_or_create_keyed_state(
        (TorchRedDesc if pkg == "torch" else JaxRedDesc)("r", lambda a, c: a + c))
    b.restore([_cross(snap, pkg)])
    return b


def _read_back(b, keys, nss, only_owned=False):
    st = b._states["s"]
    red = b._states["r"]
    pairs = _pairs(keys, nss)
    if only_owned:
        pairs = [p for p in pairs
                 if b.key_group_range.contains(tkg.assign_to_key_group(p[0], MAX_PAR))]
    sums = _read(b, st, pairs)
    reds = []
    for k in sorted(set(k for k, _ in pairs)):
        b.set_current_key(k)
        red.set_current_namespace(("fixed",))
        reds.append(red.get())
    return sums, reds


@pytest.mark.parametrize("src,dst", [
    (("torch", "gpu"), ("jax", "tpu")), (("torch", "gpu"), ("jax", "heap")),
    (("jax", "tpu"), ("torch", "gpu")), (("jax", "heap"), ("torch", "gpu")),
    (("torch", "heap"), ("jax", "tpu")), (("jax", "tpu"), ("torch", "heap")),
    (("torch", "gpu"), ("torch", "heap"))])
def test_snapshot_crosses_packages(src, dst):
    b1, keys, nss = _populate(*src)
    want = _read_back(b1, keys, nss)
    b2 = _restored(*dst, b1.snapshot())
    assert _read_back(b2, keys, nss) == want


def test_rescaled_restore_splits_key_groups():
    b1, keys, nss = _populate("jax", "tpu")
    want = dict(zip(_pairs(keys, nss), _read_back(b1, keys, nss)[0]))
    seen = {}
    for i in range(3):
        rng = tkg.compute_key_group_range_for_operator_index(MAX_PAR, 3, i)
        b = _restored("torch", "gpu", b1.snapshot(), rng=rng)
        owned = [p for p in _pairs(keys, nss)
                 if rng.contains(tkg.assign_to_key_group(p[0], MAX_PAR))]
        for p, v in zip(owned, _read(b, b._states["s"], owned)):
            seen[p] = v
    assert seen == want


def test_hll_registers_cross_bit_equal():
    b1, keys, nss = _populate("jax", "tpu", agg_name="hll")
    b2 = _restored("torch", "gpu", b1.snapshot(), agg_name="hll")
    b3 = _restored("jax", "tpu", b2.snapshot(), agg_name="hll")
    r1, r2, r3 = (_regs(b._states["s"]) for b in (b1, b2, b3))
    assert r1.keys() == r2.keys() == r3.keys()
    for e in r1:
        np.testing.assert_array_equal(r2[e], r1[e])
        np.testing.assert_array_equal(r3[e], r1[e])


def _globals(blob: bytes):
    """Every string a pickle pushes (module and class names included)."""
    return {arg for _, arg, _ in pickletools.genops(blob) if isinstance(arg, str)}


def _names_package(strings, package):
    return [s for s in strings if s == package or s.startswith(package + ".")]


def test_chunks_name_no_class_of_the_other_package():
    port, _, _ = _populate("torch", "gpu", agg_name="hll")
    jaxb, _, _ = _populate("jax", "tpu", agg_name="hll")
    for _, blob in port.snapshot().blobs():
        assert _names_package(_globals(blob), "flink_tpu") == []
        assert _names_package(_globals(blob), "flink_tpu_torch") == []
        assert pickle.loads(blob)["v"] == 2
    for _, blob in jaxb.snapshot().blobs():
        assert _names_package(_globals(blob), "flink_tpu_torch") == []


def test_unhonoured_serializer_config_raises():
    """A recorded configuration the registered serializer cannot read
    fails the restore with StateMigrationException, in both packages."""
    from flink_tpu.core.serialization import StateMigrationException as JaxSME
    from flink_tpu_torch.core.serialization import StateMigrationException

    b, _, _ = _populate("torch", "gpu")
    snap = b.snapshot()
    ok = snapshot_from_chunks(dict(snap.blobs()),
                              {"serializers": {"s": SerializerConfigSnapshot("PickleSerializer")}})
    _restored("torch", "gpu", ok)  # the JAX default serializer restores
    bad_meta = {"serializers": {
        "s": SerializerConfigSnapshot("TupleSerializer", {"fields": ["LongSerializer"]})}}
    bad = snapshot_from_chunks(dict(snap.blobs()), bad_meta)
    with pytest.raises(StateMigrationException, match="'s'"):
        _restored("torch", "gpu", bad)
    with pytest.raises(JaxSME, match="'s'"):
        _restored("jax", "tpu", JaxSnapshot(dict(snap.blobs()), bad_meta))


# ---------------------------------------------------------------------
# the plain merge_rows / set_rows against JAX's programs
# ---------------------------------------------------------------------

def _jax_state(agg, state):
    return {k: jnp.asarray(v.numpy()) for k, v in state.items()}


@pytest.mark.parametrize("agg_name", ["hll", "sum", "count", "min", "max", "avg"])
def test_plain_merge_matches_jax_merge_slots_and_merge_rows(agg_name):
    rng = np.random.default_rng(31)
    c = 64
    tagg, jagg = _agg("torch", agg_name), _agg("jax", agg_name)
    state = tagg.init_state(c, device="cpu")
    for name, comp in state.items():
        if comp.dtype == torch.uint8:
            comp.copy_(torch.from_numpy(rng.integers(0, 30, comp.shape).astype(np.uint8)))
        else:
            comp.copy_(torch.from_numpy(rng.integers(-500, 500, comp.shape)).to(comp.dtype))
    perm = rng.permutation(c)
    dst_rep = np.repeat(perm[:5], 4).astype(np.int32)        # repeated dst
    src_rep = perm[5:25].astype(np.int32)
    dst_uni, src_uni = perm[30:45].astype(np.int32), perm[45:60].astype(np.int32)
    for dst, src, unique in ((dst_rep, src_rep, False), (dst_uni, src_uni, True)):
        got = {k: v.clone() for k, v in state.items()}
        fn = tagg.merge_rows if unique else tagg.merge_slots
        fn(got, torch.from_numpy(dst), torch.from_numpy(src))
        jfn = jagg.merge_rows if unique else jagg.merge_slots
        want = jfn(_jax_state(jagg, state), jnp.asarray(dst), jnp.asarray(src))
        for k in state:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_plain_merge_refuses_overlapping_src_and_dst():
    comp = torch.zeros((8, 16), dtype=torch.uint8)
    with pytest.raises(ValueError, match="src row is also a dst"):
        K.merge_rows_plain(comp, torch.tensor([1, 2], dtype=torch.int32),
                           torch.tensor([2, 3], dtype=torch.int32), "max")
    with pytest.raises(ValueError, match="repeated dst"):
        K.merge_rows_plain(comp, torch.tensor([1, 1], dtype=torch.int32),
                           torch.tensor([2, 3], dtype=torch.int32), "max",
                           unique_dst=True)


@pytest.mark.parametrize("shape,dtype", [((50, 256), np.uint8), ((50,), np.float32),
                                         ((50,), np.int32)])
def test_plain_set_rows_matches_jax_at_set(shape, dtype):
    rng = np.random.default_rng(41)
    base = rng.integers(0, 100, shape).astype(dtype)
    idx = rng.choice(shape[0], 17, replace=False).astype(np.int32)
    rows = rng.integers(100, 200, (17, *shape[1:])).astype(dtype)
    got = torch.from_numpy(base.copy())
    K.set_rows(got, torch.from_numpy(idx), torch.from_numpy(rows))
    want = jnp.asarray(base).at[jnp.asarray(idx)].set(jnp.asarray(rows))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------
# loader and configuration
# ---------------------------------------------------------------------

def test_loader_names_and_tuning_keys():
    rng = tkg.KeyGroupRange(0, MAX_PAR - 1)
    for name in ("gpu", "tpu", "rocksdb", "device", "hbm", "GPU"):
        assert isinstance(torch_load(name, rng, MAX_PAR, device="cpu"),
                          GpuKeyedStateBackend)
    for name in ("heap", "jobmanager", "filesystem", "memory", "hashmap", None):
        assert isinstance(torch_load(name, rng, MAX_PAR), HeapKeyedStateBackend)
    with pytest.raises(ValueError, match="unknown state backend"):
        torch_load("nope", rng, MAX_PAR)
    cfg = (Configuration().set("state.backend", "tpu")
           .set("state.backend.tpu.max-device-slots", 64)
           .set("state.backend.tpu.microbatch-size", 128))
    b = torch_load(cfg, rng, MAX_PAR, device="cpu")
    assert (b.max_device_slots, b.microbatch) == (64, 128)
    for key in ("state.backend.tpu.max-device-slots",
                "state.backend.tpu.microbatch-size"):
        for bad in (0, -3):
            cfg = Configuration().set("state.backend", "gpu").set(key, bad)
            with pytest.raises(ValueError, match="must be > 0"):
                torch_load(cfg, rng, MAX_PAR, device="cpu")
            jcfg = JaxConfiguration().set("state.backend", "tpu").set(key, bad)
            with pytest.raises(ValueError, match="must be > 0"):
                jax_load(jcfg, jkg.KeyGroupRange(0, MAX_PAR - 1), MAX_PAR)


def test_configuration_refuses_keys_the_port_does_not_read():
    with pytest.raises(KeyError, match="not read by the port"):
        Configuration().set("state.checkpoints.dir", "/tmp")
    with pytest.raises(KeyError):
        Configuration({"parallelism.default": 4})


def test_gpu_backend_needs_a_card_or_cpu(monkeypatch):
    from flink_tpu_torch.streaming.datastream import StreamExecutionEnvironment
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = tkg.KeyGroupRange(0, MAX_PAR - 1)
    for call in (lambda: torch_load("gpu", rng, MAX_PAR),
                 lambda: StreamExecutionEnvironment.get_execution_environment(
                     Configuration().set("state.backend", "gpu"))):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    assert torch_load("gpu", rng, MAX_PAR, device="cpu").device.type == "cpu"
