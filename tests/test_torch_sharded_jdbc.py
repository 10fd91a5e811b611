"""The sharded replayable stream and the JDBC-shaped connector in the
port against the JAX package, on the CPU: the sharded cases of
``tests/test_records_and_sharded.py`` (all shards read, shards
discovered while the job runs, offsets kept through a rescaled
savepoint) and the JDBC cases of ``tests/test_periphery.py`` (the
formats, the upsert sink through a failing job), each through both
packages; shard files and a sharded source's savepoint cross the
packages both ways.
"""

import os
import sqlite3
import time

import pytest

import flink_tpu.connectors as jconn
import flink_tpu.core.functions as jfn
import flink_tpu.core.serialization as jser
import flink_tpu_torch.connectors as tconn
import flink_tpu_torch.core.functions as tfn
import flink_tpu_torch.core.serialization as tser
from flink_tpu.streaming import datastream as jds
from flink_tpu.streaming import sources as jsrc
from flink_tpu_torch.streaming import datastream as tds
from flink_tpu_torch.streaming import sources as tsrc

PKG = {"torch": dict(conn=tconn, ds=tds, src=tsrc, fn=tfn, ser=tser),
       "jax": dict(conn=jconn, ds=jds, src=jsrc, fn=jfn, ser=jser)}
PKGS = ["torch", "jax"]
_CLASSES = {}


def _env(pkg):
    ds = PKG[pkg]["ds"]
    return (ds.StreamExecutionEnvironment(device="cpu") if pkg == "torch"
            else ds.StreamExecutionEnvironment())


def _fill_stream(pkg, path, n_shards=4, per_shard=200):
    stream = PKG[pkg]["conn"].FileShardedStream(str(path))
    expected = []
    for s in range(n_shards):
        stream.create_shard(f"s{s}")
    for i in range(per_shard):
        for s in range(n_shards):
            stream.put(f"s{s}", (s, i))
            expected.append((s, i))
    return stream, expected


# ---------------------------------------------------------------------
# the sharded stream
# ---------------------------------------------------------------------

@pytest.mark.parametrize("writer", PKGS)
def test_shard_files_are_the_same_bytes(writer, tmp_path):
    _fill_stream(writer, tmp_path / writer, n_shards=3, per_shard=50)
    other = "jax" if writer == "torch" else "torch"
    _fill_stream(other, tmp_path / other, n_shards=3, per_shard=50)
    for shard in ("s0", "s1", "s2"):
        assert (open(tmp_path / writer / f"shard-{shard}", "rb").read()
                == open(tmp_path / other / f"shard-{shard}", "rb").read())
    # each package reads the other's files, from a cursor too
    for pkg in PKGS:
        reader = PKG[pkg]["conn"].FileShardedStream(str(tmp_path / writer))
        assert reader.list_shards() == ["s0", "s1", "s2"]
        recs, pos, seq = reader.read_from("s1", 9, 5)
        assert recs == [(10 + i, (1, 10 + i)) for i in range(5)]
        more, _, _ = reader.read_from("s1", seq, 3, pos, seq)
        assert more == [(15 + i, (1, 15 + i)) for i in range(3)]


@pytest.mark.parametrize("serializer", ["LongSerializer", "StringSerializer"])
def test_typed_shards_cross_the_packages(serializer, tmp_path):
    vals = list(range(40)) if serializer == "LongSerializer" else [f"v{i}" for i in range(40)]
    w = tconn.FileShardedStream(str(tmp_path), getattr(tser, serializer)())
    w.create_shard("a")
    for v in vals:
        w.put("a", v)
    r = jconn.FileShardedStream(str(tmp_path), getattr(jser, serializer)())
    assert [v for _, v in r.read_from("a", -1, 100)[0]] == vals


def test_sharded_stream_reads_all_shards(tmp_path):
    for pkg in PKGS:
        _, expected = _fill_stream(pkg, tmp_path / pkg / "stream")
        env = _env(pkg)
        sink = PKG[pkg]["src"].CollectSink()
        env.add_source(PKG[pkg]["conn"].ShardedStreamSource(
            str(tmp_path / pkg / "stream")), name="sharded").add_sink(sink)
        env.execute("sharded-read")
        assert sorted(sink.values) == sorted(expected), pkg


class _DiscoveringMixin:
    DISCOVER_EVERY = 2
    injected = False

    def emit_step(self, ctx, max_records):
        cls = type(self)
        if not cls.injected and self._steps >= 1:
            cls.injected = True
            late = cls.STREAM_CLS(self.path)
            late.create_shard("late")
            for i in range(25):
                late.put("late", (99, i))
        return super().emit_step(ctx, max_records)


def test_sharded_stream_discovers_new_shards(tmp_path):
    for pkg in PKGS:
        conn = PKG[pkg]["conn"]
        path = tmp_path / pkg / "s2"
        _, expected = _fill_stream(pkg, path, n_shards=2, per_shard=50)
        cls = type(f"Discovering_{pkg}", (_DiscoveringMixin, conn.ShardedStreamSource),
                   {"STREAM_CLS": conn.FileShardedStream})
        env = _env(pkg)
        sink = PKG[pkg]["src"].CollectSink()
        env.add_source(cls(str(path)), name="sharded").add_sink(sink)
        env.execute("sharded-discover")
        assert sorted(sink.values) == sorted(expected + [(99, i) for i in range(25)])


class _GatedShardedMixin:
    released = False

    def emit_step(self, ctx, max_records):
        # one productive step, then hold: the savepoint lands during the
        # hold, so the two runs together are the stream
        if not type(self).released and self._steps >= 1:
            time.sleep(0.002)
            return True
        return super().emit_step(ctx, max_records)


def _gated(pkg):
    key = (pkg, "GatedSharded")
    if key not in _CLASSES:
        _CLASSES[key] = type(f"GatedSharded_{pkg}",
                             (_GatedShardedMixin, PKG[pkg]["conn"].ShardedStreamSource), {})
    return _CLASSES[key]


@pytest.mark.parametrize("origin,target", [("torch", "torch"), ("jax", "torch"),
                                           ("torch", "jax")])
def test_sharded_stream_rescale_keeps_offsets(origin, target, tmp_path):
    """Offsets ride union state: a savepoint at parallelism 1 restored at
    parallelism 2 (in the other package too) resumes every shard after
    its checkpointed sequence number, exactly once."""
    path = str(tmp_path / "s3")
    _, expected = _fill_stream(origin, path, n_shards=4, per_shard=300)
    _gated(origin).released = False
    env = _env(origin)
    env.enable_checkpointing(10)
    sink1 = PKG[origin]["src"].CollectSink()
    env.add_source(_gated(origin)(path), name="sharded").uid("sharded").add_sink(sink1)
    client = env.execute_async("sharded-origin")
    sp = client.stop_with_savepoint(str(tmp_path / "sp"))
    client.wait(60)
    assert os.path.exists(sp)

    _gated(target).released = True
    env2 = _env(target)
    env2.enable_checkpointing(10)
    env2.set_savepoint_restore(sp)
    env2.set_parallelism(2)
    sink2 = PKG[target]["src"].CollectSink()
    env2.add_source(_gated(target)(path), name="sharded",
                    parallelism=2).uid("sharded").add_sink(sink2)
    env2.execute("sharded-rescaled")
    assert sink1.values
    assert sorted(sink1.values + sink2.values) == sorted(expected)


def test_sharded_stream_timestamps_and_watermark(tmp_path):
    path = str(tmp_path / "ts")
    _fill_stream("torch", path, n_shards=2, per_shard=30)
    for pkg in PKGS:
        env = _env(pkg)
        sink = PKG[pkg]["src"].CollectSink()
        src = PKG[pkg]["conn"].ShardedStreamSource(path, timestamp_fn=lambda v: v[1] * 100)
        (env.add_source(src, name="sharded")
            .key_by(lambda v: v[0])
            .count_window(10)
            .reduce(lambda a, b: (a[0], a[1] + b[1]))
            .add_sink(sink))
        env.execute("sharded-ts")
        assert sorted(sink.values) == sorted(
            (s, sum(range(w, w + 10))) for s in (0, 1) for w in range(0, 30, 10))


# ---------------------------------------------------------------------
# JDBC
# ---------------------------------------------------------------------

def _db(path, ddl):
    conn = sqlite3.connect(path)
    conn.execute(ddl)
    conn.commit()
    conn.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_jdbc_formats_roundtrip(pkg, tmp_path):
    conn = PKG[pkg]["conn"]
    db = str(tmp_path / "t.db")
    _db(db, "CREATE TABLE kv (k INTEGER PRIMARY KEY, v TEXT)")
    rows = [(i, f"v{i}") for i in range(2500)]
    assert conn.JdbcOutputFormat("INSERT INTO kv VALUES (?, ?)", sqlite_path=db,
                                 batch_size=1000).write(rows) == 2500
    got = conn.JdbcInputFormat("SELECT k, v FROM kv WHERE k < ? ORDER BY k",
                               sqlite_path=db, parameters=(5,)).read()
    assert got == rows[:5]
    factory = lambda: sqlite3.connect(db)  # noqa: E731
    assert len(conn.JdbcInputFormat("SELECT k FROM kv",
                                    connection_factory=factory).read()) == 2500
    with pytest.raises(AssertionError):
        conn.JdbcInputFormat("SELECT 1")


class _FailOnceMixin:
    armed = True
    completed = False

    def notify_checkpoint_complete(self, cid):
        type(self).completed = True

    def map(self, value):
        cls = type(self)
        if cls.completed and cls.armed:
            cls.armed = False
            raise RuntimeError("induced")
        return value


class _HeldMixin:
    HOLD = 300

    def emit_step(self, ctx, max_records):
        """The last HOLD records one a step while the failure is armed."""
        boundary = len(self.items) - self.HOLD
        if self.FAIL.armed and self.offset >= boundary:
            if self.offset >= len(self.items):
                return False
            time.sleep(0.001)
            return super().emit_step(ctx, 1)
        if self.FAIL.armed:
            max_records = min(max_records, boundary - self.offset)
        return super().emit_step(ctx, max_records)


@pytest.mark.parametrize("pkg", PKGS)
def test_jdbc_sink_upsert_idempotent_through_job(pkg, tmp_path):
    """A replayable source and an upsert JdbcSink through a checkpointed
    job that fails once: the replay overwrites, the counts stay exact."""
    db = str(tmp_path / "s.db")
    _db(db, "CREATE TABLE out (k INTEGER PRIMARY KEY, v INTEGER)")
    fail = type(f"FailOnce_{pkg}", (_FailOnceMixin, PKG[pkg]["fn"].MapFunction), {})
    held = type(f"Held_{pkg}", (_HeldMixin, PKG[pkg]["src"].FromCollectionSource),
                {"FAIL": fail})
    records = [(k, k * 10) for k in range(800)]
    env = _env(pkg)
    env.enable_checkpointing(10)
    env.set_restart_strategy("fixed_delay", restart_attempts=3, delay_ms=0)
    (env.add_source(held(records), name="gated")
        .map(fail(), name="failer")
        .add_sink(PKG[pkg]["conn"].JdbcSink(
            "INSERT INTO out VALUES (?, ?) "
            "ON CONFLICT(k) DO UPDATE SET v=excluded.v",
            sqlite_path=db)))
    result = env.execute("jdbc-upsert")
    assert not fail.armed and result.restarts == 1
    conn = sqlite3.connect(db)
    rows = conn.execute("SELECT COUNT(*), SUM(v) FROM out").fetchone()
    conn.close()
    assert rows == (800, sum(v for _, v in records))


def test_jdbc_sink_flushes_at_the_batch_size(tmp_path):
    counts = {}
    for pkg in PKGS:
        db = str(tmp_path / f"{pkg}.db")
        _db(db, "CREATE TABLE t (k INTEGER)")
        sink = PKG[pkg]["conn"].JdbcSink("INSERT INTO t VALUES (?)", sqlite_path=db,
                                         extractor=lambda v: (v,), batch_size=64)
        sink.open()
        for v in range(200):
            sink.invoke(v)
        conn = sqlite3.connect(db)
        counts[pkg] = [conn.execute("SELECT COUNT(*) FROM t").fetchone()[0]]
        sink.finish()
        counts[pkg].append(conn.execute("SELECT COUNT(*) FROM t").fetchone()[0])
        conn.close()
        sink.close()
    assert counts["torch"] == counts["jax"] == [192, 200]
