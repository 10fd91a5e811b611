"""Sources, sinks and timestamp assigners of the port against the JAX
package, on the CPU, and the port's thread-hosted sources.

Ported cases: tests/test_checkpointing.py's long-running socket word
count (``execute_async``, a checkpoint, cancel) and threaded-source
recovery; tests/test_connectors.py's per-subtask context of a parallel
rich function; the assigners of tests/test_datastream_api.py.  Added:
socket jobs fed by a local thread with ``"<ts> <word>"`` lines, in
event time under an ``AscendingTimestampExtractor`` and in processing
time on the test clock, with the same window rows in both packages;
``read_text_file`` / ``write_as_text``; a parallel rich source on
threads; a failing source thread, with and without restarts; the loop
thread doing every operator's work; backpressure from a full hand-off
queue; a source that ignores cancel; processing-time windows firing
while a socket is quiet.

Every socket test binds an ephemeral port on 127.0.0.1 and runs its
job with a time limit of its own (``_run``: ``execute_async`` and a
bounded wait); a feeder's accept has one too.
"""

import socket
import threading
import time

import numpy as np
import pytest

import flink_tpu.core.functions as jfn
import flink_tpu.streaming.operators as jops
from flink_tpu.streaming import datastream as jds
from flink_tpu.streaming import elements as jel
from flink_tpu.streaming import sources as jsrc
from flink_tpu.streaming import timers as jt
from flink_tpu.streaming import windowing as jw
import flink_tpu_torch.core.functions as tfn
import flink_tpu_torch.runtime.local as tlocal
import flink_tpu_torch.streaming.operators as tops
from flink_tpu_torch.streaming import datastream as tds
from flink_tpu_torch.streaming import elements as tel
from flink_tpu_torch.streaming import sources as tsrc
from flink_tpu_torch.streaming import timers as tt
from flink_tpu_torch.streaming import windowing as tw

PKG = {"torch": dict(ds=tds, w=tw, src=tsrc, fn=tfn, el=tel, t=tt, ops=tops),
       "jax": dict(ds=jds, w=jw, src=jsrc, fn=jfn, el=jel, t=jt, ops=jops)}
PKGS = ["torch", "jax"]
BACKEND_NAMES = {"heap": {"torch": "heap", "jax": "heap"},
                 "gpu": {"torch": "gpu", "jax": "tpu"}}
#: seconds any one job of this file may take
JOB_LIMIT_S = 30.0


def _env(pkg, backend="heap", parallelism=1):
    p = PKG[pkg]
    env = (p["ds"].StreamExecutionEnvironment(device="cpu") if pkg == "torch"
           else p["ds"].StreamExecutionEnvironment())
    env.set_state_backend(BACKEND_NAMES[backend][pkg])
    env.set_parallelism(parallelism)
    return env


def _run(env, name, limit=JOB_LIMIT_S):
    """The job under a time limit: a hang cancels it and fails."""
    client = env.execute_async(name)
    try:
        return client.wait(timeout=limit)
    except TimeoutError:
        client.cancel()
        raise


class _Feeder:
    """A TCP server on an ephemeral port of 127.0.0.1 that sends
    ``payload`` to the first client, then closes (or, with ``hold``,
    keeps the connection open until ``release()``)."""

    def __init__(self, payload: bytes, hold: bool = False,
                 chunk: int = 4096):
        self.server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.server.bind(("127.0.0.1", 0))
        self.server.listen(1)
        self.server.settimeout(JOB_LIMIT_S)
        self.port = self.server.getsockname()[1]
        self.payload = payload
        self.chunk = chunk
        self.sent = threading.Event()
        self._release = threading.Event()
        if not hold:
            self._release.set()
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        try:
            conn, _ = self.server.accept()
        except OSError:
            return
        with conn:
            for i in range(0, len(self.payload), self.chunk):
                conn.sendall(self.payload[i:i + self.chunk])
            self.sent.set()
            self._release.wait(JOB_LIMIT_S)
        self.server.close()

    def release(self):
        self._release.set()

    def close(self):
        self._release.set()
        self.thread.join(JOB_LIMIT_S)
        self.server.close()


def _lines(n=4000, n_words=40, seed=3):
    """``"<ts> <word>"`` lines with ascending timestamps."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, n_words, n)
    ts = np.cumsum(rng.integers(0, 7, n))
    return [f"{int(t)} w{int(w)}" for t, w in zip(ts, words)]


_CLASSES = {}


def _cls(pkg, name, mixin, base):
    key = (pkg, name)
    if key not in _CLASSES:
        _CLASSES[key] = type(name, (mixin, base), {})
    return _CLASSES[key]


class _CountAggMixin:
    def create_accumulator(self):
        return 0

    def add(self, value, acc):
        return acc + value[1]

    def get_result(self, acc):
        return acc

    def merge(self, a, b):
        return a + b


def count_agg(pkg):
    return _cls(pkg, "CountAgg", _CountAggMixin,
                PKG[pkg]["fn"].AggregateFunction)()


def _window_rows(key, window, vals):
    return [(key, window.start, v) for v in vals]


# ---------------------------------------------------------------------
# socket jobs against the JAX package
# ---------------------------------------------------------------------

def _socket_job(pkg, lines, characteristic, window_ms=500):
    p = PKG[pkg]
    feeder = _Feeder(("\n".join(lines) + "\n").encode())
    try:
        env = _env(pkg)
        env.set_stream_time_characteristic(characteristic)
        sink = p["src"].CollectSink()
        stream = env.socket_text_stream("127.0.0.1", feeder.port)
        if characteristic == "event":
            stream = stream.assign_timestamps_and_watermarks(
                p["src"].AscendingTimestampExtractor(
                    lambda line: int(line.split()[0])))
        (stream.map(lambda line: (line.split()[1], 1))
            .key_by(lambda v: v[0])
            .time_window(p["w"].Time.milliseconds_of(window_ms))
            .aggregate(count_agg(pkg), _window_rows)
            .add_sink(sink))
        _run(env, f"socket-{characteristic}")
    finally:
        feeder.close()
    return sorted(sink.values)


def test_socket_source_event_time_rows_equal_the_reference():
    lines = _lines()
    outs = {pkg: _socket_job(pkg, lines, "event") for pkg in PKGS}
    assert outs["torch"] == outs["jax"]
    want = {}
    for line in lines:
        ts, w = line.split()
        k = (w, int(ts) - int(ts) % 500)
        want[k] = want.get(k, 0) + 1
    assert outs["torch"] == sorted((w, s, c) for (w, s), c in want.items())


def test_socket_source_processing_time_on_the_test_clock():
    """Processing time on the executor's test clock (at 0): every word
    lands in window [0, 500), which the end-of-input drain fires."""
    lines = _lines(seed=4)
    outs = {pkg: _socket_job(pkg, lines, "processing") for pkg in PKGS}
    assert outs["torch"] == outs["jax"]
    words = [line.split()[1] for line in lines]
    assert outs["torch"] == sorted((w, 0, words.count(w)) for w in set(words))


def test_long_running_socket_wordcount_checkpoints_and_cancels():
    """BASELINE config #1 as a long-running job: the socket source on
    its own thread, processing-time windows on the polled wall clock,
    checkpoints, and a clean cancel that stops the source thread."""
    server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    server.bind(("127.0.0.1", 0))
    server.listen(1)
    server.settimeout(JOB_LIMIT_S)
    port = server.getsockname()[1]
    stop = threading.Event()

    def feeder():
        try:
            conn, _ = server.accept()
        except OSError:
            return
        with conn:
            while not stop.is_set():
                try:
                    conn.sendall(b"apple banana apple\n")
                except OSError:
                    return
                time.sleep(0.002)

    feed = threading.Thread(target=feeder, daemon=True)
    feed.start()
    sink = tsrc.CollectSink()
    env = _env("torch")
    env.set_stream_time_characteristic("processing")
    env.processing_time_service = tt.PolledProcessingTimeService()
    env.enable_checkpointing(50)
    (env.socket_text_stream("127.0.0.1", port)
        .flat_map(lambda line: [(w, 1) for w in line.split()])
        .key_by(lambda v: v[0])
        .time_window(tw.Time.milliseconds_of(200))
        .aggregate(count_agg("torch"))
        .add_sink(sink))
    client = env.execute_async("socket-wordcount")
    try:
        deadline = time.monotonic() + JOB_LIMIT_S
        while time.monotonic() < deadline:
            coord = (client.executor_state or {}).get("coordinator")
            if len(sink.values) >= 4 and coord and coord.completed_count >= 1:
                break
            time.sleep(0.02)
    finally:
        stop.set()
        client.cancel()
    result = client.wait(timeout=JOB_LIMIT_S)
    server.close()
    feed.join(JOB_LIMIT_S)
    assert result.cancelled
    assert len(sink.values) >= 4, f"only {len(sink.values)} window fires"
    assert result.checkpoints_completed >= 1
    assert not [t for t in threading.enumerate()
                if t.name.startswith("source-socket_source")]


def test_quiet_socket_fires_due_timers_without_spinning():
    """While the socket is quiet the loop waits on the hand-off queue
    up to the next due timer: the polled clock's windows fire with no
    further input, and the wait costs little CPU."""
    feeder = _Feeder(b"a\nb\na\n", hold=True)
    sink = tsrc.CollectSink()
    env = _env("torch")
    env.set_stream_time_characteristic("processing")
    env.processing_time_service = tt.PolledProcessingTimeService()
    (env.socket_text_stream("127.0.0.1", feeder.port)
        .map(lambda w: (w, 1))
        .key_by(lambda v: v[0])
        .time_window(tw.Time.milliseconds_of(100))
        .aggregate(count_agg("torch"))
        .add_sink(sink))
    client = env.execute_async("quiet-socket")
    try:
        assert feeder.sent.wait(JOB_LIMIT_S)
        deadline = time.monotonic() + JOB_LIMIT_S
        while sum(sink.values) < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert sorted(sink.values) == [1, 2], "the windows did not fire"
        cpu0, wall0 = time.process_time(), time.monotonic()
        time.sleep(0.5)
        cpu = time.process_time() - cpu0
        wall = time.monotonic() - wall0
        assert cpu < 0.5 * wall, f"{cpu:.3f} s of CPU in {wall:.3f} s quiet"
    finally:
        feeder.close()
    result = client.wait(timeout=JOB_LIMIT_S)
    assert not result.cancelled


def test_system_clock_timers_fire_on_the_loop_thread():
    """A system clock's due timers are handed to the executor's loop:
    the window fires while the source is quiet, and the window
    operator's fire and the sink run on the thread that called
    execute, never on a timer's thread."""
    fired = threading.Event()
    threads = set()

    class Quiet(tsrc.SourceFunction):
        def run(self, ctx):
            for w in ("a", "b", "a"):
                ctx.collect(w)
            fired.wait(JOB_LIMIT_S)      # quiet until the window fired

    class Sink(tsrc.SinkFunction):
        def __init__(self):
            self.values = []

        def invoke(self, value, context=None):
            threads.add(threading.current_thread().name)
            self.values.append(value)
            if sum(self.values) >= 3:
                fired.set()

    sink = Sink()
    env = _env("torch", "gpu")
    env.set_stream_time_characteristic("processing")
    env.processing_time_service = tt.SystemProcessingTimeService()
    (env.add_source(Quiet())
        .map(lambda w: (w, 1))
        .key_by(lambda v: v[0])
        .time_window(tw.Time.milliseconds_of(100))
        .aggregate(count_agg("torch"))
        .add_sink(sink))
    env.execute("system-clock")
    assert fired.is_set() and sorted(sink.values) == [1, 2]
    assert threads == {threading.current_thread().name}


@pytest.mark.parametrize("backend", ["heap", "gpu"])
@pytest.mark.parametrize("sliding", [False, True])
def test_processing_time_batch_fire_equals_per_timer_fire(backend, sliding,
                                                          monkeypatch):
    """Processing-time tumbling and sliding windows under the default
    trigger fire every due window in one batch (one get_batch and one
    clear_batch a round): the same rows, in the same order, as one fire
    a timer.  (The JAX package's queued channels see a moving clock
    later than the port's direct calls, a queue 3 condition, so the
    port is held to its own per-timer definition here.)"""
    import flink_tpu_torch.state as tstate
    from flink_tpu_torch.streaming import window_operator as two

    class Tick:
        now = 0

    rng = np.random.default_rng(12)
    events = [(f"k{int(k)}", int(v)) for k, v in
              zip(rng.integers(0, 40, 3000), rng.integers(0, 100, 3000))]

    def tick(v):
        Tick.now += 3
        return v

    def run(batch):
        Tick.now = 0
        svc = tt.PolledProcessingTimeService()
        svc.get_current_processing_time = lambda: Tick.now
        env = _env("torch", backend)
        env.set_stream_time_characteristic("processing")
        env.processing_time_service = svc
        assigner = (tw.SlidingProcessingTimeWindows.of(600, 200) if sliding
                    else tw.TumblingProcessingTimeWindows.of(500))
        out = []
        (env.from_collection(events).map(tick)
            .key_by(lambda e: e[0]).window(assigner)
            .aggregate(count_agg("torch"), _window_rows)
            .add_sink(tsrc.CollectSink(out)))
        monkeypatch.setattr(two.WindowOperator, "batch_fires", batch)
        _run(env, "proc-batch")
        return out

    calls = []
    for cls in (tstate.HeapKeyedStateBackend, tstate.GpuKeyedStateBackend):
        def counted(self, *a, _orig=cls.get_batch, **kw):
            calls.append(1)
            return _orig(self, *a, **kw)
        monkeypatch.setattr(cls, "get_batch", counted)
    per_timer = run(False)
    assert calls == []
    batched = run(True)
    assert 0 < len(calls) < len(batched)
    assert batched == per_timer          # same rows, same order
    # the windows still open at the end of input stay pending (a wall
    # clock is not drained)
    assert 0 < sum(r[2] for r in batched) < sum(v for _, v in events) * (
        3 if sliding else 1)


@pytest.mark.parametrize("backend", ["heap", "gpu"])
@pytest.mark.parametrize("op", ["apply", "aggregate"])
def test_processing_time_evictor_fires_through_its_evictor(backend, op,
                                                           monkeypatch):
    """An evictor on processing-time tumbling windows under the default
    trigger: every fire runs the evictor (and, for an aggregate, the
    pre-aggregator over the kept elements), whether or not the plain
    WindowOperator takes the batched fire.  Each row is held to the
    last two values its key put into that window."""
    from flink_tpu_torch.streaming import window_operator as two

    class Tick:
        now = 0

    rng = np.random.default_rng(13)
    events = [(f"k{int(k)}", int(v)) for k, v in
              zip(rng.integers(0, 20, 2000), rng.integers(0, 100, 2000))]
    size = 500
    last_two = {}
    for i, (k, v) in enumerate(events):
        # the map below moves the clock to 3 * (i + 1) before the
        # window operator assigns the element
        start = (3 * (i + 1)) // size * size
        last_two.setdefault((k, start), []).append(v)

    def tick(v):
        Tick.now += 3
        return v

    def run(batch):
        Tick.now = 0
        svc = tt.PolledProcessingTimeService()
        svc.get_current_processing_time = lambda: Tick.now
        env = _env("torch", backend)
        env.set_stream_time_characteristic("processing")
        env.processing_time_service = svc
        out = []
        ws = (env.from_collection(events).map(tick)
              .key_by(lambda e: e[0])
              .window(tw.TumblingProcessingTimeWindows.of(size))
              .evictor(tw.CountEvictor.of(2)))
        if op == "apply":
            stream = ws.apply(lambda k, w, vals: [
                (k, w.start, [v[1] for v in vals])])
        else:
            stream = ws.aggregate(count_agg("torch"), lambda k, w, vals: [
                (k, w.start, list(vals))])
        stream.add_sink(tsrc.CollectSink(out))
        monkeypatch.setattr(two.WindowOperator, "batch_fires", batch)
        _run(env, "proc-evictor")
        return out

    per_timer = run(False)
    batched = run(True)
    assert batched == per_timer and len(batched) > 20
    for k, start, vals in batched:
        kept = last_two[(k, start)][-2:]
        assert vals == (kept if op == "apply" else [sum(kept)])


# ---------------------------------------------------------------------
# thread-hosted sources
# ---------------------------------------------------------------------

class _ThreadedCountMixin:
    """run() only: emits n records, advancing its position inside the
    checkpoint lock with the emission."""

    def __init__(self, n):
        self.n = n
        self.next = 0
        self._cancelled = False

    def run(self, ctx):
        lock = ctx.get_checkpoint_lock()
        while self.next < self.n and not self._cancelled:
            with lock:
                ctx.collect_with_timestamp(self.next, self.next)
                self.next += 1

    def cancel(self):
        self._cancelled = True

    def snapshot_function_state(self, checkpoint_id=None):
        return {"next": self.next}

    def restore_function_state(self, state):
        self.next = state["next"]


class _FailOnceAfterCheckpointMixin:
    def __init__(self):
        self.checkpoint_completed = False
        self.failed = False

    def notify_checkpoint_complete(self, checkpoint_id):
        self.checkpoint_completed = True

    def map(self, value):
        if self.checkpoint_completed and not self.failed:
            self.failed = True
            raise RuntimeError("induced failure after checkpoint")
        return value


class _CountOneMixin(_CountAggMixin):
    def add(self, value, acc):
        return acc + 1


@pytest.mark.parametrize("backend", ["heap", "gpu"])
def test_threaded_source_recovery(backend):
    """A blocking source takes part in checkpoints: its barrier goes in
    under the emission lock, its position restores after a failure,
    and every record is counted once, as in the reference."""
    outs = {}
    for pkg in PKGS:
        p = PKG[pkg]
        failer = _cls(pkg, "FailAfterCp", _FailOnceAfterCheckpointMixin,
                      p["fn"].MapFunction)()
        sink = p["src"].CollectSink()
        env = _env(pkg, backend)
        env.enable_checkpointing(10)
        env.set_restart_strategy("fixed_delay", restart_attempts=3, delay_ms=0)
        (env.add_source(_cls(pkg, "ThreadedCount", _ThreadedCountMixin,
                             p["src"].SourceFunction)(5000))
            .map(failer)
            .key_by(lambda v: v % 7)
            .time_window(p["w"].Time.milliseconds_of(1000))
            .aggregate(_cls(pkg, "CountOne", _CountOneMixin,
                            p["fn"].AggregateFunction)(), _window_rows)
            .add_sink(sink))
        result = _run(env, "threaded-source-recovery")
        assert failer.failed and result.restarts == 1
        assert result.checkpoints_completed >= 1
        outs[pkg] = sorted(sink.values)
    assert outs["torch"] == outs["jax"]
    assert sum(v for _, _, v in outs["torch"]) == 5000


class _StridedCountMixin:
    """run() only, at any parallelism: subtask i of p emits i, i + p,
    ... below n, its position advanced inside the checkpoint lock."""

    def __init__(self, n):
        super().__init__()
        self.n = n
        self.next = None
        self._cancelled = False

    def run(self, ctx):
        rc = self.get_runtime_context()
        i, p = rc.index_of_this_subtask, rc.number_of_parallel_subtasks
        if self.next is None:
            self.next = i
        lock = ctx.get_checkpoint_lock()
        while self.next < self.n and not self._cancelled:
            with lock:
                ctx.collect_with_timestamp(self.next, self.next)
                self.next += p

    def cancel(self):
        self._cancelled = True

    def snapshot_function_state(self, checkpoint_id=None):
        return {"next": self.next}

    def restore_function_state(self, state):
        self.next = state["next"]


def test_threaded_sources_under_stress_stay_exactly_once(monkeypatch):
    """More source threads than cores, a tiny hand-off queue, a switch
    interval of 10 us and a checkpoint every millisecond, then a
    failure after a checkpoint: every record is counted once (a lost
    or doubled element, or a snapshot taken out of step with the
    queue, would break the count)."""
    import os
    import sys
    monkeypatch.setattr(tlocal.LocalExecutor, "HANDOFF_CAPACITY", 16)
    n_sources = max(8, 2 * (os.cpu_count() or 1))
    n = 40_000
    failer = _cls("torch", "FailAfterCp", _FailOnceAfterCheckpointMixin,
                  tfn.MapFunction)()
    source = _cls("torch", "StridedCount", _StridedCountMixin,
                  tsrc.RichParallelSourceFunction)(n)
    sink = tsrc.CollectSink()
    env = _env("torch", "gpu")
    env.enable_checkpointing(1)
    env.set_restart_strategy("fixed_delay", restart_attempts=3, delay_ms=0)
    (env.add_source(source, parallelism=n_sources)
        .map(failer).set_parallelism(1)
        .key_by(lambda v: v % 13)
        .time_window(tw.Time.milliseconds_of(5000))
        .aggregate(_cls("torch", "CountOne", _CountOneMixin,
                        tfn.AggregateFunction)(), _window_rows)
        .add_sink(sink))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        result = _run(env, "threaded-stress")
    finally:
        sys.setswitchinterval(old)
    assert failer.failed and result.restarts == 1
    assert result.checkpoints_completed >= 1
    got = {}
    for key, start, count in sink.values:
        got[(key, start)] = got.get((key, start), 0) + count
    want = {}
    for v in range(n):
        want[(v % 13, v - v % 5000)] = want.get((v % 13, v - v % 5000), 0) + 1
    assert got == want


class _RaisingSourceMixin:
    """Emits ``n`` records on its thread, then raises once (a class
    flag: the factory copies the function per attempt)."""

    raised = False
    always = False

    def __init__(self, n):
        self.n = n

    def run(self, ctx):
        for i in range(self.n):
            ctx.collect_with_timestamp((f"k{i % 5}", 1), i)
            if i == self.n // 2 and (self.always or not type(self).raised):
                type(self).raised = True
                raise ValueError("source thread failed")

    def cancel(self):
        pass


def test_source_thread_exception_fails_the_job():
    for pkg in PKGS:
        cls = _cls(pkg, "Raising", _RaisingSourceMixin,
                   PKG[pkg]["src"].SourceFunction)
        cls.raised, cls.always = False, True
        env = _env(pkg)
        (env.add_source(cls(400))
            .add_sink(PKG[pkg]["src"].CollectSink()))
        with pytest.raises(ValueError, match="source thread failed"):
            _run(env, "raising-source")


@pytest.mark.parametrize("backend", ["heap", "gpu"])
def test_source_thread_exception_restarts_under_a_strategy(backend):
    """The failed attempt's windows never fired; the restart reads the
    stream again and the windows count each record once."""
    outs = {}
    for pkg in PKGS:
        p = PKG[pkg]
        cls = _cls(pkg, "Raising", _RaisingSourceMixin, p["src"].SourceFunction)
        cls.raised, cls.always = False, False
        sink = p["src"].CollectSink()
        env = _env(pkg, backend)
        env.set_restart_strategy("fixed_delay", restart_attempts=3, delay_ms=0)
        (env.add_source(cls(600))
            .key_by(lambda v: v[0])
            .time_window(p["w"].Time.milliseconds_of(100))
            .aggregate(count_agg(pkg), _window_rows)
            .add_sink(sink))
        result = _run(env, "raising-restart")
        assert cls.raised and result.restarts == 1
        outs[pkg] = sorted(sink.values)
    assert outs["torch"] == outs["jax"]
    assert sum(v for _, _, v in outs["torch"]) == 600


def test_operators_run_on_the_loop_thread_only():
    """A thread-hosted source's records cross to the executor's loop:
    the chained map, the keyed window operator on the GPU backend and
    the sink all run on the thread that called execute."""
    seen = set()

    def where(v):
        seen.add(threading.current_thread().name)
        return v

    class Sink(tsrc.SinkFunction):
        def invoke(self, value, context=None):
            seen.add(threading.current_thread().name)

    env = _env("torch", "gpu")
    (env.add_source(_cls("torch", "ThreadedCount", _ThreadedCountMixin,
                         tsrc.SourceFunction)(3000))
        .map(where)
        .key_by(lambda v: v % 11)
        .time_window(tw.Time.milliseconds_of(200))
        .aggregate(_cls("torch", "CountOne", _CountOneMixin,
                        tfn.AggregateFunction)())
        .add_sink(Sink()))
    env.execute("loop-thread")
    assert seen == {threading.current_thread().name}


def test_full_handoff_queue_blocks_the_source(monkeypatch):
    """Backpressure: with a hand-off queue of 8 and a slow map, the
    source thread blocks on the full queue; every record arrives once
    and in order."""
    monkeypatch.setattr(tlocal.LocalExecutor, "HANDOFF_CAPACITY", 8)
    depth = []
    out = []

    def slow(v):
        time.sleep(0.0002)
        return v

    class Probe(tsrc.SinkFunction):
        def invoke(self, value, context=None):
            out.append(value)

    class Source(tsrc.SourceFunction):
        def __init__(self):
            self.queue = None

        def run(self, ctx):
            for i in range(500):
                ctx.collect(i)
                q = ctx._output._put.__self__.queue
                depth.append(len(q))

        def cancel(self):
            pass

    env = _env("torch")
    env.add_source(Source()).map(slow).add_sink(Probe())
    _run(env, "backpressure")
    assert out == list(range(500))
    assert max(depth) <= 8


def test_cancel_unblocks_a_source_blocked_on_a_full_queue(monkeypatch):
    monkeypatch.setattr(tlocal.LocalExecutor, "HANDOFF_CAPACITY", 4)
    gate = threading.Event()
    blocked = threading.Event()

    def wait_gate(v):
        blocked.set()
        gate.wait(JOB_LIMIT_S)
        return v

    class Endless(tsrc.SourceFunction):
        def run(self, ctx):
            i = 0
            while True:          # ignores cancel: only the queue stops it
                ctx.collect(i)
                i += 1

    env = _env("torch")
    env.add_source(Endless(), name="endless").map(wait_gate) \
        .add_sink(tsrc.CollectSink())
    client = env.execute_async("blocked-source")
    assert blocked.wait(JOB_LIMIT_S)
    client.cancel()
    gate.set()
    assert client.wait(timeout=JOB_LIMIT_S).cancelled
    assert not [t for t in threading.enumerate()
                if t.name.startswith("source-endless")]


def test_source_that_does_not_stop_is_named(monkeypatch):
    monkeypatch.setattr(tlocal.LocalExecutor, "SOURCE_JOIN_S", 0.2)
    release = threading.Event()

    class Stubborn(tsrc.SourceFunction):
        def run(self, ctx):
            ctx.collect(1)
            release.wait(JOB_LIMIT_S)   # deaf to cancel, emits nothing

    env = _env("torch")
    env.add_source(Stubborn(), name="stubborn").add_sink(tsrc.CollectSink())
    client = env.execute_async("stubborn-source")
    time.sleep(0.05)
    client.cancel()
    try:
        with pytest.raises(RuntimeError, match="stubborn"):
            client.wait(timeout=JOB_LIMIT_S)
    finally:
        release.set()


class _IdlerMixin:
    def run(self, ctx):
        ctx.collect(1)
        ctx.mark_as_temporarily_idle()
        ctx.collect(2)


def test_mark_as_temporarily_idle_is_accepted_as_in_the_reference():
    """A thread-hosted source that marks itself idle between records:
    the call is accepted and changes nothing, as in the JAX package."""
    outs = {}
    for pkg in PKGS:
        p = PKG[pkg]
        out = []
        env = _env(pkg)
        env.add_source(_cls(pkg, "Idler", _IdlerMixin,
                            p["src"].SourceFunction)()) \
            .add_sink(p["src"].CollectSink(out))
        _run(env, "idle")
        outs[pkg] = out
    assert outs["torch"] == outs["jax"] == [1, 2]
    assert tel.IDLE_STATUS.status == tel.StreamStatus.IDLE
    assert not tel.IDLE_STATUS.is_active and tel.ACTIVE_STATUS.is_active


# ---------------------------------------------------------------------
# file source and sink, parallel and rich sources
# ---------------------------------------------------------------------

def test_read_text_file_and_write_as_text(tmp_path):
    src = tmp_path / "in.txt"
    src.write_text("".join(f"line {i}\n" for i in range(300)))
    texts = {}
    for pkg in PKGS:
        out = tmp_path / f"out-{pkg}.txt"
        env = _env(pkg)
        (env.read_text_file(str(src))
            .map(lambda line: line.upper())
            .write_as_text(str(out)))
        _run(env, "file-io")
        texts[pkg] = out.read_text()
    assert texts["torch"] == texts["jax"]
    assert texts["torch"] == "".join(f"LINE {i}\n" for i in range(300))


class _StridedSourceMixin:
    """A rich parallel source on its thread: subtask i of p emits
    i, i + p, ... below n, read from its own runtime context."""

    def __init__(self, n):
        super().__init__()
        self.n = n

    def run(self, ctx):
        rc = self.get_runtime_context()
        i, p = rc.index_of_this_subtask, rc.number_of_parallel_subtasks
        for v in range(i, self.n, p):
            ctx.collect((i, v))


def _strided_cls(pkg):
    return _cls(pkg, "Strided", _StridedSourceMixin,
                PKG[pkg]["src"].RichParallelSourceFunction)


def test_parallel_rich_source_gets_own_subtask_context():
    outs = {}
    for pkg in PKGS:
        sink = PKG[pkg]["src"].CollectSink()
        env = _env(pkg, parallelism=3)
        (env.add_source(_strided_cls(pkg)(100), parallelism=3)
            .add_sink(sink))
        _run(env, "parallel-rich-source")
        outs[pkg] = sorted(sink.values)
    assert outs["torch"] == outs["jax"]
    assert outs["torch"] == sorted((v % 3, v) for v in range(100))


def test_parallel_rich_function_gets_own_subtask_context():
    """At parallelism > 1 each subtask's rich map is its own copy with
    its own RuntimeContext (tests/test_connectors.py)."""
    seen = {pkg: [] for pkg in PKGS}
    for pkg in PKGS:
        p = PKG[pkg]

        class IndexRecorder(p["fn"].MapFunction, p["fn"].RichFunction):
            def __init__(self):
                p["fn"].RichFunction.__init__(self)

            def open(self, configuration, _seen=seen[pkg]):
                _seen.append(self.get_runtime_context().index_of_this_subtask)

            def map(self, v):
                return v

        env = _env(pkg, parallelism=2)
        (env.add_source(_strided_cls(pkg)(50), parallelism=2)
            .map(IndexRecorder())
            .add_sink(p["src"].CollectSink()))
        _run(env, "parallel-context")
    assert sorted(seen["torch"]) == sorted(seen["jax"]) == [0, 1]


# ---------------------------------------------------------------------
# timestamp assigners
# ---------------------------------------------------------------------

class _EveryTenthMixin:
    """Punctuated: a watermark at every record whose value is a
    multiple of 10."""

    def extract_timestamp(self, element, previous_timestamp):
        return element[1]

    def check_and_get_next_watermark(self, element, extracted_timestamp):
        if element[0] % 10 == 0:
            return self._wm(extracted_timestamp - 1)
        return None


def _assigner_out(pkg, assigner, values, interval=1):
    p = PKG[pkg]
    out = p["ops"].CollectorOutput()
    op = p["src"].TimestampsAndWatermarksOperator(assigner, interval)
    op.setup(out)
    op.open()
    for v in values:
        op.process_element(p["el"].StreamRecord(v, None))
    op.process_watermark(p["el"].Watermark(5))            # swallowed
    op.process_watermark(p["el"].MAX_WATERMARK)           # passes
    return ([(r.value, r.timestamp) for r in out.records],
            [w.timestamp for w in out.watermarks])


def test_punctuated_and_ascending_watermarks_equal_the_reference():
    rng = np.random.default_rng(8)
    ts = np.cumsum(rng.integers(0, 5, 200))
    ts[50] = ts[49] - 3          # one record older than the last
    values = [(i, int(t)) for i, t in enumerate(ts)]
    for make, interval in (
            (lambda pkg: _cls(pkg, "EveryTenth", _EveryTenthMixin,
                              PKG[pkg]["src"].AssignerWithPunctuatedWatermarks)(),
             1),
            (lambda pkg: PKG[pkg]["src"].AscendingTimestampExtractor(
                lambda e: e[1]), 1),
            (lambda pkg: PKG[pkg]["src"].AscendingTimestampExtractor(
                lambda e: e[1]), 7)):
        outs = {}
        for pkg in PKGS:
            assigner = make(pkg)
            assigner._wm = PKG[pkg]["el"].Watermark
            outs[pkg] = _assigner_out(pkg, assigner, values, interval)
        assert outs["torch"] == outs["jax"]
        records, wms = outs["torch"]
        assert records == [(v, v[1]) for v in values]
        assert wms == sorted(set(wms)) and wms[-1] == tel.MAX_TIMESTAMP
