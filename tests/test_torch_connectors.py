"""The port's connectors and two-phase commit sink against the JAX
package, on the CPU.

Ported cases: tests/test_connectors.py through its file-log
transactional sink (the log primitives, the bounded, parallel and
checkpointed replayable source, exactly once through a failure, the
two-phase sink's passthrough, log to log, sessions over the log) and
its upsert cases (a crash with transient store failures, retract
deletes, the retract wiring through the Table API); the bucketing sink
lifecycle of tests/test_periphery.py.  Each runs through both
packages on the same inputs with equal results.  Added: a
``FilePartitionedLog`` written by each package and read by the other,
and the two-phase passthrough on the GPU backend (``device="cpu"``)
as well as the heap backend.
"""

import os

import numpy as np
import pytest

import flink_tpu.connectors as jconn
import flink_tpu.connectors.bucketing_sink as jbucket
import flink_tpu.connectors.upsert_sink as jupsert
import flink_tpu.core.functions as jfn
from flink_tpu.streaming import datastream as jds
from flink_tpu.streaming import sources as jsrc
from flink_tpu.streaming import two_phase as jtp
from flink_tpu.streaming import windowing as jw
from flink_tpu.table.api import StreamTableEnvironment as JaxTableEnv
import flink_tpu_torch.connectors as tconn
import flink_tpu_torch.connectors.bucketing_sink as tbucket
import flink_tpu_torch.connectors.upsert_sink as tupsert
import flink_tpu_torch.core.functions as tfn
from flink_tpu_torch.streaming import datastream as tds
from flink_tpu_torch.streaming import sources as tsrc
from flink_tpu_torch.streaming import two_phase as ttp
from flink_tpu_torch.streaming import windowing as tw
from flink_tpu_torch.table.api import StreamTableEnvironment as TorchTableEnv

PKG = {"torch": dict(ds=tds, w=tw, src=tsrc, fn=tfn, conn=tconn, tp=ttp,
                     bucket=tbucket, upsert=tupsert, table=TorchTableEnv),
       "jax": dict(ds=jds, w=jw, src=jsrc, fn=jfn, conn=jconn, tp=jtp,
                   bucket=jbucket, upsert=jupsert, table=JaxTableEnv)}
PKGS = ["torch", "jax"]
BACKEND_NAMES = {"heap": {"torch": "heap", "jax": "heap"},
                 "gpu": {"torch": "gpu", "jax": "tpu"}}


def _env(pkg, backend="heap"):
    p = PKG[pkg]
    env = (p["ds"].StreamExecutionEnvironment(device="cpu") if pkg == "torch"
           else p["ds"].StreamExecutionEnvironment())
    env.set_state_backend(BACKEND_NAMES[backend][pkg])
    return env


_CLASSES = {}


def _cls(pkg, name, mixin, base):
    key = (pkg, name)
    if key not in _CLASSES:
        _CLASSES[key] = type(name, (mixin, base), {})
    return _CLASSES[key]


class _SumAggMixin:
    def create_accumulator(self):
        return 0

    def add(self, value, acc):
        return acc + value[1]

    def get_result(self, acc):
        return acc

    def merge(self, a, b):
        return a + b


class _FailNthRecordOnceMixin:
    """Throws on the nth processed record, first attempt only."""

    def __init__(self, n):
        self.n = n
        self.count = 0
        self.failed = False

    def map(self, value):
        self.count += 1
        if not self.failed and self.count == self.n:
            self.failed = True
            raise RuntimeError("induced")
        return value


def sum_agg(pkg):
    return _cls(pkg, "SumAgg", _SumAggMixin, PKG[pkg]["fn"].AggregateFunction)()


def failer(pkg, n):
    return _cls(pkg, "FailNth", _FailNthRecordOnceMixin,
                PKG[pkg]["fn"].MapFunction)(n)


def _fill_log(log, n=1000, keys=4):
    for i in range(n):
        log.append(i % log.num_partitions, (f"k{i % keys}", 1), i)


# ---------------------------------------------------------------------
# log primitives
# ---------------------------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_in_memory_log_append_read(pkg):
    log = PKG[pkg]["conn"].InMemoryPartitionedLog(2)
    assert log.append(0, "a", 10) == 0
    assert log.append(0, "b", 20) == 1
    assert log.append(1, "c") == 0
    assert log.read(0, 0, 10) == [(0, 10, "a"), (1, 20, "b")]
    assert log.read(0, 1, 10) == [(1, 20, "b")]
    assert log.end_offset(0) == 2 and log.end_offset(1) == 1
    log.commit_offsets({0: 2})
    assert log.committed_offsets == {0: 2}


@pytest.mark.parametrize("pkg", PKGS)
def test_in_memory_log_transactions_idempotent(pkg):
    log = PKG[pkg]["conn"].InMemoryPartitionedLog(1)
    assert log.append_transaction("t1", [(0, None, "x"), (0, None, "y")])
    assert not log.append_transaction("t1", [(0, None, "x"), (0, None, "y")])
    assert log.all_values() == ["x", "y"]


@pytest.mark.parametrize("pkg", PKGS)
def test_file_log_survives_reopen(pkg, tmp_path):
    conn = PKG[pkg]["conn"]
    d = str(tmp_path / "log")
    log = conn.FilePartitionedLog(d, 2)
    log.append(0, {"k": 1}, 5)
    log.append(1, "v", None)
    log.commit_offsets({0: 1})
    reopened = conn.FilePartitionedLog(d, 2)
    assert reopened.read(0, 0, 10) == [(0, 5, {"k": 1})]
    assert reopened.read(1, 0, 10) == [(0, None, "v")]
    assert reopened.committed_offsets == {0: 1}


@pytest.mark.parametrize("writer,reader", [("torch", "jax"), ("jax", "torch")])
def test_file_log_written_by_one_package_reads_in_the_other(writer, reader,
                                                            tmp_path):
    d = str(tmp_path / "log")
    w = PKG[writer]["conn"].FilePartitionedLog(d, 3)
    rng = np.random.default_rng(2)
    for i in range(200):
        w.append(int(rng.integers(0, 3)), [f"k{i % 9}", i, {"x": i / 7}],
                 None if i % 5 == 0 else i * 11)
    w.commit_offsets({0: 3, 2: 9})
    assert w.append_transaction("txn-a", [(1, 4, "t0"), (2, None, ["t", 1])])
    r = PKG[reader]["conn"].FilePartitionedLog(d, 3)
    for p in range(3):
        assert r.read(p, 0, 1000) == w.read(p, 0, 1000)
        assert r.end_offset(p) == w.end_offset(p)
    assert r.committed_offsets == w.committed_offsets == {0: 3, 2: 9}
    assert not r.append_transaction("txn-a", [(1, 4, "t0")])
    assert r.all_values() == w.all_values()
    names = sorted(os.listdir(d))
    assert names == ["committed-offsets.json", "committed-txns.jsonl",
                     "part-0.jsonl", "part-1.jsonl", "part-2.jsonl"]


# ---------------------------------------------------------------------
# the replayable source
# ---------------------------------------------------------------------

def test_bounded_source_reads_everything():
    outs = {}
    for pkg in PKGS:
        p = PKG[pkg]
        log = p["conn"].InMemoryPartitionedLog(4)
        _fill_log(log, 1000)
        sink = p["src"].CollectSink()
        env = _env(pkg)
        env.add_source(p["conn"].ReplayableLogSource(log, bounded=True)) \
            .add_sink(sink)
        env.execute("bounded-read")
        outs[pkg] = list(sink.values)
    # each executor steps its sources with its own budget, which sets
    # how the partitions interleave: compare as sets of records
    assert sorted(outs["torch"]) == sorted(outs["jax"])
    assert len(outs["torch"]) == 1000


def test_parallel_partition_assignment():
    """4 partitions over 2 subtasks: each record read exactly once."""
    outs = {}
    for pkg in PKGS:
        p = PKG[pkg]
        log = p["conn"].InMemoryPartitionedLog(4)
        _fill_log(log, 800)
        sink = p["src"].CollectSink()
        env = _env(pkg)
        (env.add_source(p["conn"].ReplayableLogSource(log, bounded=True),
                        parallelism=2)
            .add_sink(sink))
        env.execute("parallel-read")
        outs[pkg] = sorted(sink.values)
    assert outs["torch"] == outs["jax"] and len(outs["torch"]) == 800


def test_offsets_committed_on_checkpoint_complete():
    committed = {}
    for pkg in PKGS:
        p = PKG[pkg]
        log = p["conn"].InMemoryPartitionedLog(2)
        _fill_log(log, 4000)
        env = _env(pkg)
        env.enable_checkpointing(5)
        (env.add_source(p["conn"].ReplayableLogSource(log, bounded=True))
            .key_by(lambda v: v[0])
            .time_window(p["w"].Time.seconds(100))
            .aggregate(sum_agg(pkg))
            .add_sink(p["src"].CollectSink()))
        result = env.execute("offset-commit")
        assert result.checkpoints_completed >= 1
        committed[pkg] = log.committed_offsets
        assert committed[pkg], "no offsets were committed to the log"
        assert all(0 <= off <= log.end_offset(p_) for p_, off
                   in committed[pkg].items())
    # the end of input commits the final positions in both packages
    assert committed["torch"] == committed["jax"] == {0: 2000, 1: 2000}


def test_source_exactly_once_through_failure():
    """A failure mid-stream: offsets rewind to the checkpoint, window
    sums stay exactly once."""
    outs = {}
    for pkg in PKGS:
        p = PKG[pkg]
        log = p["conn"].InMemoryPartitionedLog(4)
        _fill_log(log, 3000)
        f = failer(pkg, 2000)
        sink = p["src"].CollectSink()
        env = _env(pkg)
        env.enable_checkpointing(10)
        env.set_restart_strategy("fixed_delay", restart_attempts=2, delay_ms=0)
        (env.add_source(p["conn"].ReplayableLogSource(log, bounded=True))
            .map(f)
            .key_by(lambda v: v[0])
            .time_window(p["w"].Time.seconds(100))
            .aggregate(sum_agg(pkg))
            .add_sink(sink))
        result = env.execute("source-recovery")
        assert f.failed and result.restarts == 1
        outs[pkg] = sorted(sink.values)
    assert outs["torch"] == outs["jax"] and sum(outs["torch"]) == 3000


# ---------------------------------------------------------------------
# the two-phase commit sink
# ---------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["heap", "gpu"])
def test_2pc_sink_exactly_once_passthrough(backend):
    """A passthrough job with a failure after records reached the sink:
    the plain sink shows the replay's duplicates, the two-phase sink
    commits each record once.  The failure comes after a keyed rolling
    reduce, so the job keeps keyed state on the backend too."""
    outs = {}
    for pkg in PKGS:
        p = PKG[pkg]
        log = p["conn"].InMemoryPartitionedLog(2)
        _fill_log(log, 3000)
        f = failer(pkg, 2000)
        plain = p["src"].CollectSink()
        txn_sink = p["tp"].TransactionalCollectSink()
        env = _env(pkg, backend)
        env.enable_checkpointing(10)
        env.set_restart_strategy("fixed_delay", restart_attempts=2, delay_ms=0)
        src = (env.add_source(p["conn"].ReplayableLogSource(log, bounded=True))
               .key_by(lambda v: v[0])
               .reduce(lambda a, b: (a[0], a[1] + b[1]))
               .map(f))
        src.add_sink(txn_sink)
        src.add_sink(plain)
        result = env.execute("2pc-exactly-once")
        assert f.failed and result.restarts == 1
        assert result.checkpoints_completed >= 1
        assert len(txn_sink.committed) == 3000
        assert len(plain.values) >= 3000
        outs[pkg] = sorted(txn_sink.committed)
    assert outs["torch"] == outs["jax"]
    # a running sum per key: the last of each key is its total
    assert max(v for k, v in outs["torch"] if k == "k0") == 750


@pytest.mark.parametrize("how", ["environment", "sink"])
def test_two_phase_sink_above_parallelism_one_is_refused(how):
    """A two-phase sink's subtasks would share its one function and open
    transaction, so one subtask's barrier would pre-commit records
    another took after its own barrier, and a failover would commit
    them and replay them.  The port refuses such a job before it runs
    (the JAX package runs it: a ROADMAP.md queue 3 condition); at
    parallelism 1 the same job runs."""
    log = tconn.InMemoryPartitionedLog(2)
    _fill_log(log, 200)
    for parallelism in (2, 1):
        env = _env("torch")
        sink = ttp.TransactionalCollectSink()
        if how == "environment":
            env.set_parallelism(parallelism)
            env.add_source(tconn.ReplayableLogSource(log, bounded=True)) \
                .add_sink(sink)
        else:
            env.add_source(tconn.ReplayableLogSource(log, bounded=True),
                           parallelism=2) \
                .add_sink(sink).set_parallelism(parallelism)
        if parallelism > 1:
            with pytest.raises(ValueError, match="two-phase commit sink"):
                env.execute("2pc-parallel")
            assert sink.committed == []
        else:
            env.execute("2pc-single")
            assert len(sink.committed) == 200


def test_transactional_log_sink_end_to_end():
    """Log -> job -> transactional log, a failure and a restore: the
    output log holds each result once."""
    outs = {}
    for pkg in PKGS:
        p = PKG[pkg]
        src_log = p["conn"].InMemoryPartitionedLog(2)
        out_log = p["conn"].InMemoryPartitionedLog(2)
        _fill_log(src_log, 2400, keys=6)
        f = failer(pkg, 1500)
        env = _env(pkg)
        env.enable_checkpointing(10)
        env.set_restart_strategy("fixed_delay", restart_attempts=2, delay_ms=0)
        (env.add_source(p["conn"].ReplayableLogSource(src_log, bounded=True))
            .map(f)
            .key_by(lambda v: v[0])
            .time_window(p["w"].Time.seconds(100))
            .aggregate(sum_agg(pkg))
            .add_sink(p["conn"].TransactionalLogSink(out_log)))
        result = env.execute("log-to-log")
        assert f.failed and result.restarts == 1
        outs[pkg] = sorted(out_log.all_values())
    assert outs["torch"] == outs["jax"] == [400] * 6


def test_session_windows_over_log_source():
    outs = {}
    for pkg in PKGS:
        p = PKG[pkg]
        log = p["conn"].InMemoryPartitionedLog(2)
        for i in range(100):          # session 1: ts 0..990
            log.append(i % 2, ("k", 1), i * 10)
        for i in range(50):           # session 2: ts 5000..5490
            log.append(i % 2, ("k", 1), 5000 + i * 10)
        sink = p["src"].CollectSink()
        env = _env(pkg)
        (env.add_source(p["conn"].ReplayableLogSource(log, bounded=True))
            .key_by(lambda v: v[0])
            .window(p["w"].EventTimeSessionWindows.with_gap(p["w"].Time.seconds(1)))
            .aggregate(sum_agg(pkg))
            .add_sink(sink))
        env.execute("sessions-over-log")
        outs[pkg] = sorted(sink.values)
    assert outs["torch"] == outs["jax"] == [50, 100]


@pytest.mark.parametrize("pkg", PKGS)
def test_transactional_sink_on_file_log(pkg, tmp_path):
    """The two-phase sink against the file log; transaction ids stay
    idempotent across a reopen."""
    p = PKG[pkg]
    d = str(tmp_path / "outlog")
    out = p["conn"].FilePartitionedLog(d, 2)
    assert out.append_transaction("t1", [(0, 5, "a"), (1, None, "b")])
    assert not out.append_transaction("t1", [(0, 5, "a"), (1, None, "b")])
    reopened = p["conn"].FilePartitionedLog(d, 2)
    assert not reopened.append_transaction("t1", [(0, 5, "a")])
    assert sorted(reopened.all_values()) == ["a", "b"]

    src = p["conn"].InMemoryPartitionedLog(1)
    for i in range(100):
        src.append(0, ("k", 1), i)
    env = _env(pkg)
    (env.add_source(p["conn"].ReplayableLogSource(src, bounded=True))
        .add_sink(p["conn"].TransactionalLogSink(reopened)))
    env.execute("2pc-to-file")
    assert len(reopened.all_values()) == 102


# ---------------------------------------------------------------------
# the upsert sink
# ---------------------------------------------------------------------

class _CrashOnceMixin:
    crashed = False
    rows = []

    def __init__(self):
        self.offset = 0

    def run(self, ctx):
        while self.emit_step(ctx, 64):
            pass

    def emit_step(self, ctx, max_records):
        rows = type(self).rows
        n = len(rows)
        end = min(self.offset + max_records, n)
        for i in range(self.offset, end):
            ctx.collect(rows[i])
        self.offset = end
        if self.offset >= n // 2 and not type(self).crashed:
            type(self).crashed = True
            raise RuntimeError("injected crash")
        return self.offset < n

    def snapshot_function_state(self, checkpoint_id=None):
        return {"offset": self.offset}

    def restore_function_state(self, state):
        self.offset = state["offset"]


def test_upsert_sink_exactly_once_through_crash(tmp_path):
    """A crash mid-stream and transient store failures: the store ends
    at the final per-key state in both packages."""
    rng = np.random.default_rng(3)
    n = 4000
    rows = [(int(k), int(v)) for k, v in zip(
        rng.integers(0, 37, n), rng.integers(0, 1000, n))]
    stores = {}
    for pkg in PKGS:
        p = PKG[pkg]
        store = p["upsert"].FileDocumentStore(str(tmp_path / f"docs-{pkg}"),
                                              fail_times=3, fail_after=5)
        crash = _cls(pkg, "CrashOnce", _CrashOnceMixin, p["src"].SourceFunction)
        crash.crashed, crash.rows = False, rows
        env = _env(pkg)
        env.enable_checkpointing(10)
        env.set_restart_strategy("fixed_delay", restart_attempts=3, delay_ms=5)
        sink = p["upsert"].UpsertSink(lambda: store,
                                      key_fn=lambda r: f"k{r[0]}",
                                      doc_fn=lambda r: {"key": r[0], "value": r[1]},
                                      buffer_size=100)
        env.add_source(crash()).add_sink(sink)
        result = env.execute("upsert-crash")
        assert result.restarts >= 1 and sink.num_retries >= 1
        stores[pkg] = store.read_all()
    want = {f"k{k}": {"key": k, "value": v} for k, v in rows}
    assert stores["torch"] == stores["jax"] == want


@pytest.mark.parametrize("pkg", PKGS)
def test_upsert_sink_retract_deletes(pkg, tmp_path):
    up = PKG[pkg]["upsert"]
    store = up.FileDocumentStore(str(tmp_path / "d"))
    sink = up.UpsertSink(lambda: store, key_fn=lambda r: r[0],
                         doc_fn=lambda r: {"v": r[1]}, buffer_size=10,
                         retract_stream=True)
    sink.open()
    sink.invoke((True, ("a", 1)))
    sink.invoke((True, ("b", 2)))
    sink.invoke((False, ("a", 1)))      # a retract before the flush
    sink.snapshot_function_state(1)     # the checkpoint's flush
    assert store.read_all() == {"b": {"v": 2}}
    sink.invoke((False, ("b", 2)))      # deletes a stored document
    sink.close()
    assert store.read_all() == {}
    # without the flag, pairs are plain rows, never retractions
    plain_store = up.FileDocumentStore(str(tmp_path / "p"))
    plain = up.UpsertSink(lambda: plain_store, key_fn=lambda r: r[0],
                          doc_fn=lambda r: {"v": r[1]}, buffer_size=10)
    plain.open()
    plain.invoke((False, "x"))
    plain.close()
    assert plain_store.read_all() == {"False": {"v": "x"}}


def test_upsert_sink_retract_wiring_via_table(tmp_path):
    """to_retract_stream().add_sink(UpsertSink) turns the sink's pair
    decoding on, in both packages."""
    stores = {}
    for pkg in PKGS:
        p = PKG[pkg]
        env = _env(pkg)
        t_env = p["table"].create(env)
        st = env.from_collection([("x", 1), ("x", 2), ("y", 5)])
        t_env.register_table("ev", t_env.from_data_stream(st, ["k", "v"]))
        out = t_env.sql_query("SELECT k, SUM(v) AS s FROM ev GROUP BY k")
        store = p["upsert"].FileDocumentStore(str(tmp_path / f"w-{pkg}"))
        sink = p["upsert"].UpsertSink(lambda: store, key_fn=lambda r: r[0],
                                      doc_fn=lambda r: {"s": r[1]},
                                      buffer_size=100)
        assert not sink.retract_stream
        out.to_retract_stream().add_sink(sink)
        env.execute("retract-upsert")
        assert sink.retract_stream
        stores[pkg] = store.read_all()
    assert stores["torch"] == stores["jax"] == {"x": {"s": 3}, "y": {"s": 5}}


# ---------------------------------------------------------------------
# the bucketing sink
# ---------------------------------------------------------------------

def _bucket_lines(base):
    lines, stray = [], []
    for root, _d, files in os.walk(base):
        for name in files:
            if name.endswith((".pending", ".in-progress")):
                stray.append(name)
                continue
            with open(os.path.join(root, name)) as f:
                lines.extend(f.read().split())
    return sorted(lines, key=int), sorted(stray)


def test_bucketing_sink_lifecycle(tmp_path):
    """Valid lengths truncate what followed the checkpoint; pending
    files commit on completion; the same files in both packages."""
    results = {}
    for pkg in PKGS:
        b = PKG[pkg]["bucket"]
        base = str(tmp_path / pkg)
        sink = b.BucketingFileSink(base, bucketer=lambda v: f"b{v % 2}")
        sink.open()
        for v in range(10):
            sink.invoke(v)
        snap = sink.snapshot_function_state(checkpoint_id=1)
        assert set(snap["in_progress"]) == {"b0", "b1"}
        sink.invoke(100)
        sink.invoke(101)
        sink.close()
        sink2 = b.BucketingFileSink(base, bucketer=lambda v: f"b{v % 2}")
        sink2.open()
        sink2.restore_function_state(snap)
        for _bid, (path, valid) in snap["in_progress"].items():
            assert os.path.getsize(path + b.IN_PROGRESS_SUFFIX) == valid
        sink2.invoke(100)
        sink2.invoke(101)
        for bid in list(sink2._open):
            sink2._roll(bid)
        sink2.snapshot_function_state(checkpoint_id=2)
        sink2.notify_checkpoint_complete(2)
        sink2.close()
        files = sorted(os.path.relpath(os.path.join(r, f), base)
                       for r, _d, fs in os.walk(base) for f in fs)
        results[pkg] = (_bucket_lines(base), files)
    assert results["torch"] == results["jax"]
    (lines, stray), _ = results["torch"]
    assert stray == []
    assert lines == [str(v) for v in sorted(list(range(10)) + [100, 101])]


def test_bucketing_sink_in_a_failing_job(tmp_path):
    """A job writing through the bucketing sink fails after a
    checkpoint and restarts: the committed files hold every record
    once, in both packages."""
    results = {}
    for pkg in PKGS:
        p = PKG[pkg]
        log = p["conn"].InMemoryPartitionedLog(2)
        _fill_log(log, 3000)
        f = failer(pkg, 2000)
        base = str(tmp_path / f"job-{pkg}")
        sink = p["bucket"].BucketingFileSink(
            base, bucketer=lambda v: v[0], batch_size=2048,
            formatter=lambda v: str(v[1]))
        env = _env(pkg)
        env.enable_checkpointing(10)
        env.set_restart_strategy("fixed_delay", restart_attempts=2, delay_ms=0)
        (env.add_source(p["conn"].ReplayableLogSource(log, bounded=True))
            .map(f)
            .map(lambda v: (v[0], 1))
            .add_sink(sink))
        result = env.execute("bucketing-job")
        assert f.failed and result.restarts == 1
        # finished, pending and in-progress files together: each record
        # once (restore truncated and deleted what followed the
        # checkpoint, the replay wrote it again)
        per_bucket = {}
        for bucket in sorted(os.listdir(base)):
            for name in os.listdir(os.path.join(base, bucket)):
                with open(os.path.join(base, bucket, name)) as fh:
                    per_bucket[bucket] = (per_bucket.get(bucket, 0)
                                          + len(fh.read().split()))
        results[pkg] = per_bucket
    assert results["torch"] == results["jax"] == {f"k{k}": 750
                                                  for k in range(4)}
