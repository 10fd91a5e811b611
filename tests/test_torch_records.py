"""Typed state in the port against the JAX package, on the CPU:
serializers, type extraction, schema'd records, the file formats and
the columnar file format, and serializer migration on the heap and GPU
backends.

Every serializer writes the reference's bytes, and each package reads
the other's; schema evolution accepts and refuses the same changes
with the same exception types (``tests/test_records_and_sharded.py``,
``tests/test_state_backends.py``); a keyed snapshot and a savepoint
with a typed ``ValueState`` cross the packages both ways, migrated to
an evolved schema on restore.
"""

import io
import os
import pickle

import numpy as np
import pytest

import flink_tpu.core.colformat as jcol
import flink_tpu.core.formats as jfmt
import flink_tpu.core.keygroups as jkg
import flink_tpu.core.records as jrec
import flink_tpu.core.serialization as jser
import flink_tpu.core.state as jstate
import flink_tpu.core.types as jtypes
import flink_tpu.state.backend as jbackend
import flink_tpu.state.loader as jloader
import flink_tpu_torch.core.colformat as tcol
import flink_tpu_torch.core.formats as tfmt
import flink_tpu_torch.core.keygroups as tkg
import flink_tpu_torch.core.records as trec
import flink_tpu_torch.core.serialization as tser
import flink_tpu_torch.core.state as tstate
import flink_tpu_torch.core.types as ttypes
import flink_tpu_torch.state.loader as tloader
from flink_tpu_torch.state import portable, snapshot_from_chunks

import test_torch_operator_state as opst

PKG = {"torch": dict(ser=tser, rec=trec, types=ttypes, fmt=tfmt, col=tcol,
                     state=tstate),
       "jax": dict(ser=jser, rec=jrec, types=jtypes, fmt=jfmt, col=jcol,
                   state=jstate)}
PKGS = ["torch", "jax"]
BACKENDS = {"heap": {"torch": "heap", "jax": "heap"},
            "gpu": {"torch": "gpu", "jax": "tpu"}}

V1 = [("user", "long"), ("name", "string"), ("score", "long")]
V2 = [("user", "long"), ("name", "string"), ("score", "double"),
      ("country", "string", "??")]
BAD = [("user", "long"), ("name", "string"), ("score", "long"),
       ("email", "string")]


def _schema(pkg, fields):
    return PKG[pkg]["rec"].RecordSchema(fields)


def _record_ser(pkg, fields):
    return PKG[pkg]["rec"].RecordSerializer(_schema(pkg, fields))


# ---------------------------------------------------------------------
# serializers: the same bytes, read across
# ---------------------------------------------------------------------

def _ser(pkg, spec):
    s = PKG[pkg]["ser"]
    if spec == "tuple":
        return s.TupleSerializer([s.LongSerializer(), s.StringSerializer(),
                                  s.DoubleSerializer()])
    if spec == "list":
        return s.ListSerializer(s.LongSerializer())
    if spec == "map":
        return s.MapSerializer(s.StringSerializer(), s.DoubleSerializer())
    return getattr(s, spec)()


SER_CASES = [
    ("LongSerializer", [0, 7, -1, 2 ** 62, -(2 ** 63)]),
    ("IntSerializer", [0, 5, -(2 ** 31), 2 ** 31 - 1]),
    ("DoubleSerializer", [0.0, -1.5, 1e300, float("inf")]),
    ("FloatSerializer", [0.0, 1.5, -2.25]),
    ("BooleanSerializer", [True, False]),
    ("StringSerializer", ["", "ada", "ünïcødé ✓"]),
    ("BytesSerializer", [b"", b"\x00\xff", bytes(range(50))]),
    ("PickleSerializer", [None, 3, "x", (1, "a", 2.5), {"k": [1, 2]}]),
    ("tuple", [(1, "a", 2.5), (-3, "", 0.0)]),
    ("list", [[], [1, 2, 3], list(range(-5, 5))]),
    ("map", [{}, {"a": 1.0, "b": -2.5}]),
]


@pytest.mark.parametrize("spec,values", SER_CASES,
                         ids=[c[0] for c in SER_CASES])
def test_serializer_bytes_equal_the_reference(spec, values):
    port, ref = _ser("torch", spec), _ser("jax", spec)
    for v in values:
        data = port.serialize_to_bytes(v)
        assert data == ref.serialize_to_bytes(v)
        assert port.deserialize_from_bytes(ref.serialize_to_bytes(v)) == v
        assert ref.deserialize_from_bytes(data) == v
        assert port.copy(v) == v
    assert port.snapshot_configuration() == ref.snapshot_configuration()
    assert port.create_instance() == ref.create_instance()
    assert port.numpy_dtype() == ref.numpy_dtype()


@pytest.mark.parametrize("dtype", ["<i8", ">f4", "|u1", "<c16"])
def test_numpy_serializer_bytes_equal_the_reference(dtype):
    rng = np.random.default_rng(3)
    arr = (rng.standard_normal((3, 4)) * 100).astype(dtype)
    port, ref = tser.NumpyArraySerializer(), jser.NumpyArraySerializer()
    data = port.serialize_to_bytes(arr)
    assert data == ref.serialize_to_bytes(arr)
    back = port.deserialize_from_bytes(data)
    assert back.dtype == arr.dtype and np.array_equal(back, arr)
    if "|" not in arr.dtype.str:
        # the reference splits its header at the first "|", so it cannot
        # read back a dtype written as "|u1" (ROADMAP queue 3)
        assert np.array_equal(ref.deserialize_from_bytes(data), arr)


@pytest.mark.parametrize("sample", [True, 7, np.int32(3), 1.5, np.float32(2),
                                    "s", b"b", np.zeros(2), (1, "a"),
                                    [1], {"k": 1}, object])
def test_serializer_for_picks_the_same_serializer(sample):
    port, ref = tser.serializer_for(sample), jser.serializer_for(sample)
    assert type(port).__name__ == type(ref).__name__
    assert port.snapshot_configuration() == ref.snapshot_configuration()


COMPAT = ["LongSerializer", "DoubleSerializer", "StringSerializer",
          "PickleSerializer", "tuple", "list", "map"]


@pytest.mark.parametrize("reader", COMPAT)
def test_compatibility_matrix_equals_the_reference(reader):
    """Which recorded configuration each serializer accepts, with the
    configuration written by either package."""
    for writer in COMPAT:
        want = _ser("jax", reader).ensure_compatibility(
            _ser("jax", writer).snapshot_configuration())
        for wpkg in PKGS:
            cfg = _ser(wpkg, writer).snapshot_configuration()
            assert _ser("torch", reader).ensure_compatibility(cfg) == want
            assert _ser("jax", reader).ensure_compatibility(cfg) == want


def test_config_snapshots_pickle_across_the_packages():
    cfg = _record_ser("torch", V1).snapshot_configuration()
    ref = pickle.loads(portable.dumps(cfg))
    assert type(ref) is jser.SerializerConfigSnapshot
    assert ref == _record_ser("jax", V1).snapshot_configuration()
    back = portable.loads(pickle.dumps(ref))
    assert type(back) is tser.SerializerConfigSnapshot and back == cfg


# ---------------------------------------------------------------------
# type extraction
# ---------------------------------------------------------------------

TYPE_SAMPLES = [7, 1.5, True, "x", b"b", (1, "a"), (1, (2.0, "b")),
                [1, 2, 3], [1, "a"], [], {"k": 2.0}, {}, np.zeros(3),
                np.int64(4), np.float32(1.0), None, object()]


@pytest.mark.parametrize("i", range(len(TYPE_SAMPLES)))
def test_type_info_of_equals_the_reference(i):
    sample = TYPE_SAMPLES[i]
    port, ref = ttypes.type_info_of(sample), jtypes.type_info_of(sample)
    assert port.name == ref.name
    assert (port.arity, port.is_basic_type) == (ref.arity, ref.is_basic_type)
    if port.name not in ("Pickled", "NumpyArray"):
        assert (port.create_serializer().serialize_to_bytes(sample)
                == ref.create_serializer().serialize_to_bytes(sample))


def test_types_constructors_and_widening_equal_the_reference():
    for pkg_t in (ttypes, jtypes):
        t = pkg_t.Types
        assert pkg_t.Types.TUPLE(t.LONG, t.STRING).name == "Tuple2<Long, String>"
    for samples in ([1, 2], [1, "a"], ["a", "b"], [(1, 2), (3, 4)]):
        assert (ttypes.extract_type_infos(samples).name
                == jtypes.extract_type_infos(samples).name)
    t, j = ttypes.Types, jtypes.Types
    for pt, jt in [(t.MAP(t.STRING, t.LIST(t.LONG)), j.MAP(j.STRING, j.LIST(j.LONG))),
                   (t.TUPLE(t.DOUBLE, t.BOOLEAN), j.TUPLE(j.DOUBLE, j.BOOLEAN))]:
        assert pt.name == jt.name
        assert (pt.serializer.snapshot_configuration()
                == jt.serializer.snapshot_configuration())


# ---------------------------------------------------------------------
# records: bytes, evolution and its refusals
# ---------------------------------------------------------------------

RECS_V1 = [{"user": 42, "name": "grace", "score": 100},
           {"user": -1, "name": "", "score": 0}]


def test_record_bytes_and_fingerprints_equal_the_reference():
    for fields in (V1, V2, BAD):
        assert _schema("torch", fields).fingerprint() == \
            _schema("jax", fields).fingerprint()
        assert _schema("torch", fields).to_dict() == _schema("jax", fields).to_dict()
    for rec in RECS_V1:
        data = _record_ser("torch", V1).serialize_to_bytes(rec)
        assert data == _record_ser("jax", V1).serialize_to_bytes(rec)
    rec = {"user": 1, "name": "x", "score": 0.5}     # country defaults
    assert (_record_ser("torch", V2).serialize_to_bytes(rec)
            == _record_ser("jax", V2).serialize_to_bytes(rec))
    for pkg in PKGS:
        with pytest.raises(KeyError):
            _record_ser(pkg, V2).serialize_to_bytes({"user": 1})


@pytest.mark.parametrize("writer_pkg,reader_pkg",
                         [("torch", "jax"), ("jax", "torch"), ("torch", "torch")])
def test_evolved_reader_resolves_old_bytes(writer_pkg, reader_pkg):
    writer = _record_ser(writer_pkg, V1)
    old = [writer.serialize_to_bytes(r) for r in RECS_V1]
    reader = _record_ser(reader_pkg, V2)
    assert reader.ensure_compatibility(writer.snapshot_configuration())
    out = [reader.deserialize_from_bytes(b) for b in old]
    ref = _record_ser("jax", V2)
    ref.ensure_compatibility(_record_ser("jax", V1).snapshot_configuration())
    assert out == [ref.deserialize_from_bytes(b) for b in old]
    assert out[0] == {"user": 42, "name": "grace", "score": 100.0,
                      "country": "??"}
    assert isinstance(out[0]["score"], float)
    new = reader.serialize_to_bytes({"user": 1, "name": "n", "score": 2.0,
                                     "country": "de"})
    assert reader.deserialize_from_bytes(new)["country"] == "de"


EVOLUTIONS = {
    "added_without_default": (BAD, False),
    "illegal_type_change": ([("user", "string"), ("name", "string"),
                             ("score", "long")], False),
    "double_to_long": ([("user", "long"), ("name", "string"),
                        ("score", "long")], True),
    "dropped_field": ([("user", "long")], True),
    "promoted_with_default": (V2, True),
}


@pytest.mark.parametrize("case", sorted(EVOLUTIONS))
def test_evolution_acceptance_equals_the_reference(case):
    fields, ok = EVOLUTIONS[case]
    for wpkg in PKGS:
        cfg = _record_ser(wpkg, V1).snapshot_configuration()
        for rpkg in PKGS:
            assert _record_ser(rpkg, fields).ensure_compatibility(cfg) is ok
        assert (trec._can_resolve(_schema("torch", fields), _schema("torch", V1))
                == jrec._can_resolve(_schema("jax", fields), _schema("jax", V1)))


def test_unknown_fingerprint_raises_state_migration():
    data = _record_ser("jax", V1).serialize_to_bytes(RECS_V1[0])
    for pkg in PKGS:
        exc = PKG[pkg]["ser"].StateMigrationException
        with pytest.raises(exc, match="unknown schema fingerprint"):
            _record_ser(pkg, V2).deserialize_from_bytes(data)
    with pytest.raises(ValueError):
        trec.RecordField("x", "decimal")
    with pytest.raises(ValueError):
        trec.RecordSchema([("a", "long"), ("a", "double")])


def test_value_migration_equals_the_reference():
    for rec in RECS_V1:
        port = _record_ser("torch", V2).migrate_value(
            dict(rec), _record_ser("torch", V1).snapshot_configuration())
        ref = _record_ser("jax", V2).migrate_value(
            dict(rec), _record_ser("jax", V1).snapshot_configuration())
        assert port == ref and type(port["score"]) is float


# ---------------------------------------------------------------------
# formats and the columnar file format
# ---------------------------------------------------------------------

ROWS = [(1, "a", 2.5), (2, "b,c", -1.0), (3, "", 0.0)]


@pytest.mark.parametrize("kind", ["text", "csv", "json"])
def test_formats_write_the_same_files(kind, tmp_path):
    def out(pkg, path):
        f = PKG[pkg]["fmt"]
        if kind == "text":
            return f.TextOutputFormat(path, formatter=repr).write(ROWS)
        if kind == "csv":
            return f.CsvOutputFormat(path).write(ROWS)
        return f.JsonRowOutputFormat(path).write(
            [{"k": k, "s": s, "v": v} for k, s, v in ROWS])

    def read(pkg, path):
        f = PKG[pkg]["fmt"]
        if kind == "text":
            return f.TextInputFormat(path).read()
        if kind == "csv":
            return f.CsvInputFormat(path, types=[int, str, float]).read()
        return f.JsonRowInputFormat(path).read()

    paths = {pkg: out(pkg, str(tmp_path / pkg / f"rows.{kind}")) for pkg in PKGS}
    data = {pkg: open(p, "rb").read() for pkg, p in paths.items()}
    assert data["torch"] == data["jax"]
    assert read("torch", paths["jax"]) == read("jax", paths["torch"])
    assert not os.path.exists(paths["torch"] + ".part")


def test_csv_header_and_delimiter(tmp_path):
    path = str(tmp_path / "h.csv")
    with open(path, "w") as f:
        f.write("k;v\n1;x\n2;y\n")
    for pkg in PKGS:
        rows = PKG[pkg]["fmt"].CsvInputFormat(path, types=[int, str],
                                              delimiter=";",
                                              skip_header=True).read()
        assert rows == [(1, "x"), (2, "y")]


def _cols(n, seed=4):
    rng = np.random.default_rng(seed)
    return {"user": rng.integers(-2 ** 40, 2 ** 40, n),
            "name": np.asarray([f"n{i}é" for i in rng.integers(0, 1000, n)]),
            "score": rng.integers(0, 100, n)}


@pytest.mark.parametrize("n", [0, 1, 257])
def test_columnar_files_are_the_same_bytes(n, tmp_path):
    paths = {}
    for pkg in PKGS:
        paths[pkg] = str(tmp_path / f"{pkg}.ftcf")
        PKG[pkg]["col"].write_columnar_file(paths[pkg], _schema(pkg, V1), _cols(n))
    assert open(paths["torch"], "rb").read() == open(paths["jax"], "rb").read()
    for rpkg, wpkg in [("torch", "jax"), ("jax", "torch")]:
        got = PKG[rpkg]["col"].read_columnar_file(paths[wpkg],
                                                 _schema(rpkg, V2))
        want = jcol.read_columnar_file(paths["jax"], _schema("jax", V2))
        assert list(got) == list(want) == ["user", "name", "score", "country"]
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])


def test_columnar_refusal_and_formats(tmp_path):
    path = str(tmp_path / "c.ftcf")
    tcol.write_columnar_file(path, _schema("torch", V1), _cols(5))
    for pkg in PKGS:
        with pytest.raises(ValueError, match="cannot read"):
            PKG[pkg]["col"].read_columnar_file(path, _schema(pkg, BAD))
        with pytest.raises(ValueError, match="missing"):
            PKG[pkg]["col"].write_columnar_file(
                str(tmp_path / f"{pkg}.x"), _schema(pkg, V1), {"user": [1]})
    bad = str(tmp_path / "not")
    with open(bad, "wb") as f:
        f.write(b"nope")
    with pytest.raises(ValueError, match="not a columnar file"):
        tcol.read_columnar_file(bad)
    rows = [{"user": 1, "name": "a", "score": 3}, {"user": 2, "name": "b", "score": 4}]
    out = {}
    for pkg in PKGS:
        p = str(tmp_path / f"{pkg}.rows")
        PKG[pkg]["col"].ColumnarFileOutputFormat(p, _schema(pkg, V1)).write(rows)
        out[pkg] = open(p, "rb").read()
        assert PKG[pkg]["col"].ColumnarFileInputFormat(
            p, _schema(pkg, V2)).read()[1] == {"user": 2, "name": "b",
                                              "score": 4.0, "country": "??"}
    assert out["torch"] == out["jax"]


# ---------------------------------------------------------------------
# migration on the keyed backends
# ---------------------------------------------------------------------

MAX_PAR = 128


def _backend(pkg, name):
    if pkg == "torch":
        return tloader.load_state_backend(BACKENDS[name][pkg],
                                          tkg.KeyGroupRange(0, MAX_PAR - 1),
                                          MAX_PAR, device="cpu")
    return jloader.load_state_backend(BACKENDS[name][pkg],
                                      jkg.KeyGroupRange(0, MAX_PAR - 1), MAX_PAR)


def _cross(snap, to_pkg):
    """A snapshot as the other package reads it from a file."""
    if to_pkg == "torch":
        return portable.loads(pickle.dumps(snap))
    return pickle.loads(portable.dumps(snap))


def _typed(pkg, backend, kind, fields):
    st = PKG[pkg]["state"]
    desc = (st.ValueStateDescriptor if kind == "value" else st.ListStateDescriptor)(
        "profile", serializer=_record_ser(pkg, fields))
    return backend.get_or_create_keyed_state(desc)


def _fill(pkg, backend, kind, n=40, seed=8):
    rng = np.random.default_rng(seed)
    st = _typed(pkg, backend, kind, V1)
    for i in range(n):
        backend.set_current_key(f"u{i}")
        rec = {"user": i, "name": f"n{int(rng.integers(0, 99))}",
               "score": int(rng.integers(0, 1000))}
        if kind == "value":
            st.update(rec)
        else:
            st.add(rec)
            st.add(dict(rec, score=rec["score"] + 1))
    return backend.snapshot()


def _read(pkg, backend, st, kind, n=40):
    out = []
    for i in range(n):
        backend.set_current_key(f"u{i}")
        out.append(st.value() if kind == "value" else st.get())
    return out


@pytest.mark.parametrize("backend", ["heap", "gpu"])
@pytest.mark.parametrize("kind", ["value", "list"])
@pytest.mark.parametrize("origin,target", [("jax", "torch"), ("torch", "jax"),
                                           ("torch", "torch")])
@pytest.mark.parametrize("bind_first", [True, False])
def test_backend_migrates_restored_values(backend, kind, origin, target,
                                          bind_first):
    """Values written under V1 restore under V2 (bound before or after
    the restore), equal to the reference's own migration."""
    snap = _fill(origin, _backend(origin, backend), kind)
    want_b = _backend("jax", backend)
    want_b.restore([_cross(snap, "jax") if origin == "torch" else snap])
    want = _read("jax", want_b, _typed("jax", want_b, kind, V2), kind)
    b = _backend(target, backend)
    restored = snap if origin == target else _cross(snap, target)
    if bind_first:
        st = _typed(target, b, kind, V2)
        b.restore([restored])
    else:
        b.restore([restored])
        st = _typed(target, b, kind, V2)
    got = _read(target, b, st, kind)
    assert got == want
    first = got[0] if kind == "value" else got[0][0]
    assert first["country"] == "??" and type(first["score"]) is float
    # a rebind never migrates twice; new writes coexist
    assert _read(target, b, _typed(target, b, kind, V2), kind) == want
    if kind == "value":
        b.set_current_key("new")
        st.update({"user": 9, "name": "z", "score": 1.5, "country": "fr"})
        assert st.value()["country"] == "fr"


@pytest.mark.parametrize("backend", ["heap", "gpu"])
@pytest.mark.parametrize("origin", PKGS)
def test_incompatible_restore_raises_state_migration(backend, origin):
    snap = _fill(origin, _backend(origin, backend), "value")
    for target in PKGS:
        b = _backend(target, backend)
        _typed(target, b, "value", BAD)
        exc = PKG[target]["ser"].StateMigrationException
        with pytest.raises(exc, match="'profile'"):
            b.restore([snap if origin == target else _cross(snap, target)])
        # restored first, bound after: the bind refuses
        b2 = _backend(target, backend)
        b2.restore([snap if origin == target else _cross(snap, target)])
        with pytest.raises(exc, match="'profile'"):
            _typed(target, b2, "value", BAD)


def test_primitive_serializer_change_raises_like_the_reference():
    for pkg in PKGS:
        st_mod, ser = PKG[pkg]["state"], PKG[pkg]["ser"]
        b1 = _backend(pkg, "heap")
        st = b1.get_or_create_keyed_state(
            st_mod.ValueStateDescriptor("v", serializer=ser.LongSerializer()))
        b1.set_current_key("k")
        st.update(7)
        snap = b1.snapshot()
        assert snap.meta["serializers"]["v"].serializer_name == "LongSerializer"
        b2 = _backend(pkg, "heap")
        st2 = b2.get_or_create_keyed_state(
            st_mod.ValueStateDescriptor("v", serializer=ser.LongSerializer()))
        b2.restore([snap])
        b2.set_current_key("k")
        assert st2.value() == 7
        b3 = _backend(pkg, "heap")
        b3.get_or_create_keyed_state(
            st_mod.ValueStateDescriptor("v", serializer=ser.DoubleSerializer()))
        with pytest.raises(ser.StateMigrationException, match="'v'"):
            b3.restore([snap])


def test_gpu_backend_device_rows_restore_bit_for_bit_beside_migration():
    """The device aggregate's HLL registers come back unchanged while the
    host table beside them migrates."""
    from flink_tpu_torch.ops.sketches import HyperLogLogAggregate

    b = _backend("torch", "gpu")
    hll = b.get_or_create_keyed_state(
        tstate.AggregatingStateDescriptor("uv", HyperLogLogAggregate(8)))
    prof = _typed("torch", b, "value", V1)
    rng = np.random.default_rng(2)
    keys = [f"u{int(k)}" for k in rng.integers(0, 50, 2000)]
    b.add_batch(hll, keys, (), [int(v) for v in rng.integers(0, 10 ** 6, 2000)])
    for k in sorted(set(keys)):
        b.set_current_key(k)
        prof.update({"user": int(k[1:]), "name": k, "score": 1})
    b.flush_all()
    before = hll.snapshot_columns()
    snap = b.snapshot()
    b2 = _backend("torch", "gpu")
    hll2 = b2.get_or_create_keyed_state(
        tstate.AggregatingStateDescriptor("uv", HyperLogLogAggregate(8)))
    prof2 = _typed("torch", b2, "value", V2)
    b2.restore([snapshot_from_chunks(dict(snap.blobs()), snap.meta)])
    after = hll2.snapshot_columns()
    for kg, (ks, _, comps) in before.items():
        order = {k: i for i, k in enumerate(after[kg][0])}
        idx = [order[k] for k in ks]
        assert np.array_equal(after[kg][2]["regs"][idx], comps["regs"])
    b2.set_current_key("u7")
    assert prof2.value() == {"user": 7, "name": "u7", "score": 1.0,
                             "country": "??"}


# ---------------------------------------------------------------------
# a typed savepoint across the packages
# ---------------------------------------------------------------------

class _ProfileMixin:
    """Keeps a record per key under ``fields``; emits, per element, the
    key and the record it held before the element."""

    fields = V1

    def process_element(self, value, ctx, out):
        st = ctx.get_state(self.desc())
        prev = st.value()
        out.collect((value[0], prev))
        n = (prev or {}).get("user", 0)
        st.update({"user": int(n) + 1, "name": value[0],
                   "score": value[1] if self.fields is V1 else float(value[1])})


def _profile_fn(pkg, fields):
    state_mod = PKG[pkg]["state"]
    base = (__import__("flink_tpu_torch.streaming.operators", fromlist=["x"])
            if pkg == "torch" else
            __import__("flink_tpu.streaming.operators", fromlist=["x"])).KeyedProcessFunction

    def desc(self):
        return state_mod.ValueStateDescriptor(
            "profile", serializer=_record_ser(pkg, fields))

    cls = type(f"Profile{pkg}{len(fields)}", (_ProfileMixin, base),
               {"fields": fields, "desc": desc})
    return cls()


def _profile_job(pkg, env, items, sink, fields):
    (env.add_source(opst.source_cls(pkg)(items), name="src").uid("src")
        .key_by(lambda v: v[0])
        .process(_profile_fn(pkg, fields), name="profile").uid("profile")
        .add_sink(sink))


@pytest.mark.parametrize("backend", ["heap", "gpu"])
@pytest.mark.parametrize("origin,target", [("jax", "torch"), ("torch", "jax")])
def test_typed_savepoint_crosses_the_packages(origin, target, backend, tmp_path):
    """A savepoint with a typed ValueState (schema V1), taken while the
    source holds, resumes in the other package under V2: every key's
    first record after the resume reads its migrated V1 record."""
    items = opst._items(1200, n_keys=30, seed=12)
    hold = len(items) // 2
    opst.source_cls(origin).reset(hold=hold)
    before = opst.PKG[origin]["src"].CollectSink()
    env = opst._env(origin, backend)
    env.enable_checkpointing(60_000)   # savepoints only
    _profile_job(origin, env, items, before, V1)
    client = env.execute_async("typed-origin")
    assert opst.source_cls(origin).reached.wait(60)
    path = client.trigger_savepoint(str(tmp_path / "sp"))
    client.cancel()
    assert client.wait(60).cancelled and os.path.exists(path)

    opst.source_cls(target).reset()
    after = opst.PKG[target]["src"].CollectSink()
    env = opst._env(target, backend)
    env.set_savepoint_restore(path)
    _profile_job(target, env, items, after, V2)
    assert env.execute("typed-resume").restarts == 0

    # what each key held at the hold, in V1, seen migrated after it
    held = {}
    for (k, _), _ts in items[:hold]:
        held[k] = held.get(k, 0) + 1
    last_v1 = {}
    for (k, v), _ts in items[:hold]:
        last_v1[k] = v
    first_after = {}
    for k, prev in after.values:
        first_after.setdefault(k, prev)
    assert set(first_after) == {k for (k, _), _ in items[hold:]}
    for k, prev in first_after.items():
        if k in held:
            assert prev == {"user": held[k], "name": k,
                            "score": float(last_v1[k]), "country": "??"}
        else:
            assert prev is None
    assert len(before.values) == hold and len(after.values) == len(items) - hold


def test_snapshot_meta_records_serializers_both_ways():
    b = _backend("torch", "heap")
    _typed("torch", b, "value", V1)
    b.get_or_create_keyed_state(tstate.ValueStateDescriptor("plain"))
    snap = b.snapshot()
    ref = _backend("jax", "heap")
    _typed("jax", ref, "value", V1)
    ref.get_or_create_keyed_state(jstate.ValueStateDescriptor("plain"))
    assert snap.meta["serializers"] == ref.snapshot().meta["serializers"]
    file_meta = pickle.loads(portable.dumps(snap)).meta
    assert type(file_meta["serializers"]["profile"]) is jser.SerializerConfigSnapshot
    assert isinstance(jbackend.KeyedStateSnapshot({}, file_meta).meta, dict)
    buf = io.BytesIO()
    portable.dump(snap, buf)
    assert portable.loads(buf.getvalue()).meta["serializers"] == snap.meta["serializers"]
