"""Checkpoint coordination, storage, and restart strategies (port of
``flink_tpu/runtime/checkpoints.py``).

Re-designs flink-runtime/.../checkpoint/ (CheckpointCoordinator.java:394
triggerCheckpoint, :665 receiveAcknowledgeMessage, :802
completePendingCheckpoint, :883 notifyCheckpointComplete), the
checkpoint-storage side of the state backends
(flink-runtime/.../state/memory/MemoryBackendCheckpointStorage,
.../state/filesystem/FsCheckpointStorage) and the restart strategies
(flink-runtime/.../executiongraph/restart/FixedDelayRestartStrategy.java,
FailureRateRestartStrategy.java, RestartStrategyFactory.java).

The coordinator here runs inside the single-process executor loop: it
trigger-marks source subtasks (which inject CheckpointBarriers in-band
at a record boundary), collects per-subtask snapshot acks, and on full
acknowledgement persists a completed checkpoint and notifies operators
(the commit signal for two-phase-commit sinks / source offset commits).

Snapshots persist to a checkpoint directory as one file per
checkpoint (`chk-N`), retained N deep — the FsStateBackend analogue;
MemoryCheckpointStorage keeps them in a dict (the `jobmanager` backend
analogue).  Files are written and read through ``state.portable``: a
checkpoint or savepoint of either package restores in the other.  The
async writer thread touches host bytes only (snapshots are host copies
taken at the barrier).  The stats payload of the REST layer and the
trace instants are later slices.
"""

from __future__ import annotations

import pickle
import shutil
import struct
import threading
import time as _time
import zlib
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from flink_tpu_torch.runtime import faults
from flink_tpu_torch.runtime.tracing import get_tracer, make_trace_context
from flink_tpu_torch.state import portable


class CorruptCheckpointError(Exception):
    """A checkpoint or chunk file failed its CRC32 verification (or is
    torn/truncated).  Deliberately NOT an OSError: retrying a read of a
    corrupt file cannot heal it, so the retry helper must not spin on
    it — `latest()` falls back to an older retained checkpoint
    instead."""


#: checksummed-file envelope: magic + CRC32(payload) + payload.  Files
#: without the magic are legacy (pre-checksum) and load unverified.
_CRC_MAGIC = b"FTCK"


def _crc_wrap(payload: bytes) -> bytes:
    return _CRC_MAGIC + struct.pack("<I", zlib.crc32(payload)) + payload


def _crc_unwrap(data: bytes, path: str) -> bytes:
    if not data.startswith(_CRC_MAGIC):
        return data  # legacy un-checksummed file
    if len(data) < 8:
        raise CorruptCheckpointError(f"torn checkpoint file {path}")
    (expect,) = struct.unpack("<I", data[4:8])
    payload = data[8:]
    if zlib.crc32(payload) != expect:
        raise CorruptCheckpointError(
            f"CRC mismatch in checkpoint file {path}")
    return payload


class CheckpointStorage:
    """Completed-checkpoint store contract (ref: CompletedCheckpointStore
    + CheckpointStorage).  Keys are (vertex_id, subtask_index)."""

    def persist(self, checkpoint_id: int, metadata: dict,
                task_snapshots: Dict[Tuple[int, int], dict]) -> Optional[int]:
        """Returns the persisted size in bytes when known."""
        raise NotImplementedError

    def latest(self) -> Optional[dict]:
        """Returns {"checkpoint_id", "metadata", "tasks"} or None."""
        raise NotImplementedError

    def load(self, checkpoint_id: int) -> Optional[dict]:
        raise NotImplementedError

    def checkpoint_ids(self) -> List[int]:
        raise NotImplementedError

    def materialize(self, task_snapshots):
        """Resolve every SharedChunk to its full payload (savepoints
        must be self-contained).  Chunks carrying payloads pass
        through; elided ones fetch from this storage's registry."""
        from flink_tpu_torch.state.shared_registry import (ChunkRef,
                                                     SharedChunk,
                                                     map_chunks)

        def fetch(c):
            if isinstance(c, SharedChunk) and c.payload is not None:
                return c.payload
            return self._fetch_shared(c.hash)

        return map_chunks(task_snapshots, fetch,
                          kinds=(SharedChunk, ChunkRef))

    def _fetch_shared(self, h: str):
        raise KeyError(f"no shared chunk store for {h}")


class MemoryCheckpointStorage(CheckpointStorage):
    """In-memory retained checkpoints (ref: MemoryStateBackend /
    `jobmanager` shortcut in StateBackendLoader.java:92-109).
    SharedChunk-wrapped state dedupes against retained checkpoints
    (incremental checkpoints, SharedStateRegistry.java role)."""

    def __init__(self, retain: int = 1):
        from flink_tpu_torch.state.shared_registry import SharedStateRegistry
        self.retain = retain
        self._store: Dict[int, dict] = {}
        self._chunks: Dict[str, Any] = {}
        self.registry = SharedStateRegistry(
            store=self._chunks.__setitem__,
            delete=lambda h: self._chunks.pop(h, None),
            exists=self._chunks.__contains__)

    def persist(self, checkpoint_id, metadata, task_snapshots):
        tasks = self.registry.register_checkpoint(checkpoint_id,
                                                  task_snapshots)
        self._store[checkpoint_id] = {
            "checkpoint_id": checkpoint_id,
            "metadata": metadata,
            "tasks": tasks,
        }
        for cid in sorted(self._store)[:-self.retain]:
            del self._store[cid]
            self.registry.release_checkpoint(cid)
        # the reference MemoryStateBackend also serializes (handles are
        # byte arrays), so measuring here is faithful, not extra cost.
        # Size = reference skeleton + chunks NEWLY stored by this
        # checkpoint: unchanged (deduped) state is ~0 bytes
        try:
            size = len(pickle.dumps(tasks,
                                    protocol=pickle.HIGHEST_PROTOCOL))
            for h in self.registry.last_new_hashes:
                size += len(pickle.dumps(self._chunks[h],
                                         protocol=pickle.HIGHEST_PROTOCOL))
            return size
        except Exception:  # noqa: BLE001 — unpicklable state: size unknown
            return None

    def _resolve(self, entry):
        if entry is None:
            return None
        from flink_tpu_torch.state.shared_registry import ChunkRef, map_chunks
        return {**entry,
                "tasks": map_chunks(entry["tasks"],
                                    lambda r: self._chunks[r.hash]
                                    if isinstance(r, ChunkRef) else r)}

    def latest(self):
        if not self._store:
            return None
        return self._resolve(self._store[max(self._store)])

    def load(self, checkpoint_id):
        return self._resolve(self._store.get(checkpoint_id))

    def checkpoint_ids(self):
        return sorted(self._store)

    def _fetch_shared(self, h):
        return self._chunks[h]


class FsCheckpointStorage(CheckpointStorage):
    """One pickle file per completed checkpoint under `dir/chk-N`
    (ref: FsStateBackend / FsCheckpointStorage — rename-free write then
    atomic rename, so a torn write never becomes `latest`).  The
    directory resolves through the FileSystem SPI (core/fs.py), so
    `mem://...` or any registered scheme works as checkpoint storage
    exactly like the reference's pluggable checkpoint filesystems."""

    def __init__(self, directory: str, retain: int = 1):
        from flink_tpu_torch.core.fs import get_file_system
        from flink_tpu_torch.state.shared_registry import SharedStateRegistry
        self.fs, self.directory = get_file_system(directory)
        self.retain = retain
        self.fs.makedirs(self.directory)
        self._shared_dir = f"{self.directory.rstrip('/')}/shared"
        self.fs.makedirs(self._shared_dir)
        self.registry = SharedStateRegistry(
            store=self._store_chunk,
            delete=self._delete_chunk,
            exists=lambda h: self.fs.exists(f"{self._shared_dir}/{h}"))
        self._adopted: Set[int] = set()
        self._chunk_sizes: Dict[str, int] = {}
        # sweep orphaned *.part files first: a crashed predecessor's
        # torn write must never be adopted, and a lingering chunk .part
        # would shadow the next write of the same hash
        for d in (self.directory, self._shared_dir):
            for name in self.fs.listdir(d):
                if name.endswith(".part"):
                    try:
                        self.fs.remove(f"{d.rstrip('/')}/{name}")
                    except OSError:
                        pass
        # fresh-process recovery: adopt EVERY retained checkpoint's
        # chunk refs up front, so rotation decrefs (and eventually
        # deletes) chunks of pre-restart checkpoints instead of
        # orphaning them on disk
        for cid in self.checkpoint_ids():
            try:
                entry = self._read_entry(self._path(cid))
                self.registry.adopt_checkpoint(cid, entry["tasks"])
                self._adopted.add(cid)
            except Exception:  # noqa: BLE001 — unreadable old file:
                pass           # rotation will still remove its chk-N

    #: bounded-backoff policy for storage I/O (transient faults heal;
    #: CorruptCheckpointError is not an OSError and never retries)
    RETRY_ATTEMPTS = 4
    RETRY_BASE_MS = 5.0
    RETRY_DEADLINE_MS = 5_000.0

    def _retry(self, fn):
        return faults.retry_with_backoff(
            fn, attempts=self.RETRY_ATTEMPTS,
            base_delay_ms=self.RETRY_BASE_MS,
            deadline_ms=self.RETRY_DEADLINE_MS,
            counter="storage_retries")

    def _path(self, checkpoint_id: int) -> str:
        return f"{self.directory.rstrip('/')}/chk-{checkpoint_id}"

    def _write_file(self, tmp: str, final: str, payload: bytes) -> None:
        """Checksummed write-then-rename, retried with backoff.  The
        `storage.persist` fault point fires inside fs.replace (the
        commit), so an injected failure leaves the .part behind —
        exactly the torn-write shape the orphan sweep cleans up."""

        def attempt():
            with self.fs.open(tmp, "wb") as f:
                f.write(_crc_wrap(payload))
            self.fs.replace(tmp, final)

        self._retry(attempt)

    def _read_entry(self, path: str):
        with self.fs.open(path, "rb") as f:
            data = f.read()
        return portable.loads(_crc_unwrap(data, path))

    def _store_chunk(self, h: str, payload) -> None:
        data = portable.dumps(payload)
        self._chunk_sizes[h] = len(data)
        self._write_file(f"{self._shared_dir}/{h}.part",
                         f"{self._shared_dir}/{h}", data)

    def _delete_chunk(self, h: str) -> None:
        try:
            self.fs.remove(f"{self._shared_dir}/{h}")
        except OSError:
            pass

    def _fetch_chunk(self, h: str):
        def attempt():
            faults.fire("storage.fetch_chunk")
            return self._read_entry(f"{self._shared_dir}/{h}")

        return self._retry(attempt)

    _fetch_shared = _fetch_chunk

    def persist(self, checkpoint_id, metadata, task_snapshots):
        tasks = self.registry.register_checkpoint(checkpoint_id,
                                                  task_snapshots)
        payload = {
            "checkpoint_id": checkpoint_id,
            "metadata": metadata,
            "tasks": tasks,
        }
        data = portable.dumps(payload)
        size = len(data)
        # count chunks NEWLY written by this checkpoint (incremental
        # bytes); deduped chunks cost nothing
        size += sum(self._chunk_sizes.get(h, 0)
                    for h in self.registry.last_new_hashes)
        self._write_file(self._path(checkpoint_id) + ".part",
                         self._path(checkpoint_id), data)
        for cid in self.checkpoint_ids()[:-self.retain]:
            try:
                self.fs.remove(self._path(cid))
            except OSError:
                pass
            self.registry.release_checkpoint(cid)
        return size

    def latest(self):
        """Newest LOADABLE retained checkpoint: when the newest file is
        corrupt or torn (CRC mismatch, truncated pickle, missing
        chunk), fall back to the next-older retained one instead of
        failing recovery (ref: the reference re-reads the completed-
        checkpoint store and skips unreadable entries)."""
        for cid in reversed(self.checkpoint_ids()):
            try:
                entry = self.load(cid)
            except Exception:  # noqa: BLE001 — corrupt/torn newest:
                # recovery prefers an older consistent snapshot over
                # failing the job
                faults.count("checkpoint_fallbacks")
                continue
            if entry is not None:
                return entry
        return None

    def load(self, checkpoint_id):
        from flink_tpu_torch.state.shared_registry import ChunkRef, map_chunks
        path = self._path(checkpoint_id)
        if not self.fs.exists(path):
            return None
        entry = self._read_entry(path)
        if checkpoint_id not in self.registry._by_checkpoint \
                and checkpoint_id not in self._adopted:
            # recovery in a fresh process: re-register the retained
            # checkpoint's chunk references so future retention
            # rotation refcounts them correctly
            self.registry.adopt_checkpoint(checkpoint_id,
                                           entry["tasks"])
            self._adopted.add(checkpoint_id)
        cache: Dict[str, Any] = {}

        def fetch(r):
            if not isinstance(r, ChunkRef):
                return r
            if r.hash not in cache:
                cache[r.hash] = self._fetch_chunk(r.hash)
            return cache[r.hash]

        return {**entry, "tasks": map_chunks(entry["tasks"], fetch)}

    def checkpoint_ids(self):
        ids = []
        for name in self.fs.listdir(self.directory):
            if name.startswith("chk-") and not name.endswith(".part"):
                try:
                    ids.append(int(name[4:]))
                except ValueError:
                    pass
        return sorted(ids)

    def dispose(self):
        shutil.rmtree(self.directory, ignore_errors=True)


def make_checkpoint_storage(config: Optional[dict]) -> CheckpointStorage:
    """`checkpoint.storage` switch: `memory` (default) | `filesystem`
    with `checkpoint.dir` (ref: StateBackendLoader name resolution)."""
    config = config or {}
    kind = config.get("storage", "memory")
    retain = config.get("retain", 1)
    if kind == "filesystem":
        return FsCheckpointStorage(config["dir"], retain=retain)
    if kind == "memory":
        return MemoryCheckpointStorage(retain=retain)
    raise ValueError(f"unknown checkpoint storage '{kind}'")


class PendingCheckpoint:
    """(ref: PendingCheckpoint.java) — in-flight checkpoint awaiting
    acknowledgements from every subtask."""

    def __init__(self, checkpoint_id: int, timestamp: int,
                 expected: Set[Tuple[int, int]]):
        self.checkpoint_id = checkpoint_id
        self.timestamp = timestamp
        self.expected = set(expected)
        self.acks: Dict[Tuple[int, int], dict] = {}
        self.discarded = False

    def acknowledge(self, task_key: Tuple[int, int], snapshot: dict) -> None:
        if task_key in self.expected:
            self.acks[task_key] = snapshot

    @property
    def fully_acknowledged(self) -> bool:
        return set(self.acks) == self.expected


class CheckpointStats:
    """Per-checkpoint stats the reference tracks in
    CheckpointStatsTracker.java: trigger→complete duration, byte size,
    per-subtask ack latency, and — for failed/aborted checkpoints —
    the failure cause (retained, like AbstractCheckpointStats +
    FailedCheckpointStats)."""

    def __init__(self, checkpoint_id: int, trigger_ms: float):
        self.checkpoint_id = checkpoint_id
        self.trigger_ms = trigger_ms
        #: all acks in — the processing-loop-blocking (sync) part ends
        self.sync_ms: Optional[float] = None
        #: durably persisted (includes the async write)
        self.complete_ms: Optional[float] = None
        self.state_bytes = 0
        #: "vertexId-subtaskIndex" -> ms from trigger to ack (ref:
        #: SubtaskStateStats ack timestamps)
        self.ack_latency_ms: Dict[str, float] = {}
        #: why the checkpoint failed/was aborted (None while pending
        #: or on success)
        self.failure_cause: Optional[str] = None
        self.failed_ms: Optional[float] = None

    def record_ack(self, task_key: Tuple[int, int],
                   latency_ms: float) -> None:
        self.ack_latency_ms[f"{task_key[0]}-{task_key[1]}"] = latency_ms

    def mark_failed(self, cause: str, now_ms: float) -> None:
        self.failure_cause = str(cause)
        self.failed_ms = now_ms

    @property
    def status(self) -> str:
        if self.failure_cause is not None:
            return "failed"
        if self.complete_ms is not None:
            return "completed"
        return "in_progress"

    @property
    def sync_duration_ms(self) -> Optional[float]:
        if self.sync_ms is None:
            return None
        return self.sync_ms - self.trigger_ms

    @property
    def async_duration_ms(self) -> Optional[float]:
        if self.complete_ms is None or self.sync_ms is None:
            return None
        return self.complete_ms - self.sync_ms

    @property
    def alignment_ms(self) -> Optional[float]:
        """Ack spread (slowest − fastest subtask ack): the
        coordinator-visible proxy for barrier-alignment time — the
        fastest subtask acks as soon as its barriers meet, the slowest
        one was still aligning for the difference."""
        if len(self.ack_latency_ms) < 2:
            return None
        lats = self.ack_latency_ms.values()
        return max(lats) - min(lats)

    @property
    def duration_ms(self) -> Optional[float]:
        if self.complete_ms is None:
            return None
        return self.complete_ms - self.trigger_ms

    def to_dict(self) -> dict:
        return {
            "id": self.checkpoint_id,
            "status": self.status,
            "trigger_ms": self.trigger_ms,
            "duration_ms": self.duration_ms,
            "sync_duration_ms": self.sync_duration_ms,
            "async_duration_ms": self.async_duration_ms,
            "alignment_ms": self.alignment_ms,
            "state_bytes": self.state_bytes,
            "ack_latency_ms": dict(self.ack_latency_ms),
            "failure_cause": self.failure_cause,
        }


def checkpoint_stats_payload(coordinator, completed_base: int = 0) -> dict:
    """The checkpoint history with a percentile summary over the
    completed ones: the REST layer's ``/jobs/<name>/checkpoints`` shape
    (ref ``flink_tpu/runtime/checkpoints.py:469``)."""
    from flink_tpu_torch.runtime.timeseries import rollup

    stats = getattr(coordinator, "stats", {}) or {}
    history = [stats[cid].to_dict() for cid in sorted(stats)]
    completed = [h for h in history if h["status"] == "completed"]
    ack_latencies = [lat for h in completed
                     for lat in h["ack_latency_ms"].values()]
    summary = {
        "count": len(completed),
        "duration_ms": rollup([h["duration_ms"] for h in completed]),
        "sync_duration_ms": rollup(
            [h["sync_duration_ms"] for h in completed
             if h["sync_duration_ms"] is not None]),
        "async_duration_ms": rollup(
            [h["async_duration_ms"] for h in completed
             if h["async_duration_ms"] is not None]),
        "state_bytes": rollup([h["state_bytes"] for h in completed]),
        "ack_latency_ms": rollup(ack_latencies),
    }
    return {
        "counts": {
            "completed": completed_base
            + getattr(coordinator, "completed_count", 0),
            "failed": getattr(coordinator, "failed_count", 0),
            "aborted": getattr(coordinator, "aborted_count", 0),
            "timeout_aborts": getattr(coordinator, "timeout_aborts", 0),
            "in_progress": len(getattr(coordinator, "pending", {}) or {}),
        },
        "latest_completed_id": getattr(coordinator,
                                       "latest_completed_id", None),
        "summary": summary,
        "history": history,
    }


class SavepointRequest:
    """A user-triggered savepoint (ref: savepoint/SavepointV2.java +
    the `flink savepoint [-d]` / `cancel -s` CLI verbs).  Completed
    savepoints are written OUTSIDE the retained-checkpoint rotation, to
    `directory/savepoint-<id>`; the caller blocks on `wait()`."""

    def __init__(self, directory: str):
        self.directory = directory
        self._event = threading.Event()
        self.path: Optional[str] = None
        self.error: Optional[BaseException] = None

    def complete(self, path: str) -> None:
        self.path = path
        self._event.set()

    def fail(self, error: BaseException) -> None:
        self.error = error
        self._event.set()

    def wait(self, timeout: Optional[float] = None) -> str:
        if not self._event.wait(timeout):
            raise TimeoutError("savepoint did not complete in time")
        if self.error is not None:
            raise self.error
        return self.path


def write_savepoint(directory: str, checkpoint_id: int, metadata: dict,
                    task_snapshots: Dict[Tuple[int, int], dict],
                    parallelisms: Dict[int, int]) -> str:
    """Atomic single-file savepoint: {checkpoint_id, metadata, tasks,
    parallelisms} — parallelisms (vertex_id -> subtask count at
    snapshot time) let restore detect rescale.  Resolves through the
    FileSystem SPI like checkpoint storage (mem:// etc. work)."""
    from flink_tpu_torch.core.fs import get_file_system
    fs, directory = get_file_system(directory)
    fs.makedirs(directory)
    path = f"{directory.rstrip('/')}/savepoint-{checkpoint_id}"
    payload = {"checkpoint_id": checkpoint_id, "metadata": metadata,
               "tasks": task_snapshots, "parallelisms": parallelisms}
    tmp = path + ".part"
    with fs.open(tmp, "wb") as f:
        portable.dump(payload, f)
    fs.replace(tmp, path)
    return path


def load_savepoint(path: str) -> dict:
    from flink_tpu_torch.core.fs import get_file_system
    fs, path = get_file_system(path)
    with fs.open(path, "rb") as f:
        return portable.load(f)


class CheckpointFailuresExceeded(RuntimeError):
    """More consecutive checkpoint failures than
    `tolerable_checkpoint_failures` allows — escalated to a task
    failure (ref: CheckpointFailureManager.java
    checkExceedTolerableFailures → FlinkRuntimeException)."""

    def __init__(self, n_failures: int, tolerable: int,
                 cause: Optional[BaseException]):
        super().__init__(
            f"{n_failures} consecutive checkpoint failures exceed "
            f"tolerable_checkpoint_failures={tolerable}"
            + (f"; last cause: {cause!r}" if cause is not None else ""))
        self.n_failures = n_failures
        self.cause = cause


class CheckpointCoordinator:
    """Periodic barrier-checkpoint driver (ref:
    CheckpointCoordinator.java).  `trigger_sources` is a callback that
    marks every source subtask with a pending (checkpoint_id, options)
    trigger; sources inject the barrier at their next record boundary
    and ack immediately after snapshotting themselves."""

    def __init__(self, interval_ms: int, mode: str,
                 storage: CheckpointStorage,
                 expected_tasks: Set[Tuple[int, int]],
                 trigger_sources: Callable[[int, int, dict], None],
                 notify_complete: Callable[[int], None],
                 min_pause_ms: int = 0,
                 max_concurrent: int = 1,
                 clock: Callable[[], float] = None,
                 metadata_extra: Optional[dict] = None,
                 async_persist: bool = False,
                 checkpoint_timeout_ms: Optional[int] = None,
                 tolerable_checkpoint_failures: Optional[int] = None):
        #: merged into every completed checkpoint's metadata (e.g. the
        #: JobMaster's master_epoch + attempt — the provenance local
        #: recovery needs, since bare checkpoint ids are reused across
        #: attempts)
        self.metadata_extra = metadata_extra or {}
        self.interval_ms = interval_ms
        self.mode = mode  # exactly_once | at_least_once
        self.storage = storage
        self.expected_tasks = set(expected_tasks)
        self._trigger_sources = trigger_sources
        self._notify_complete = notify_complete
        self.min_pause_ms = min_pause_ms
        self.max_concurrent = max_concurrent
        self._clock = clock or (lambda: _time.monotonic() * 1000.0)
        # a pending checkpoint older than this is aborted so the
        # coordinator can re-trigger — a lost ack must not stall
        # checkpointing forever (ref: CheckpointCoordinator's
        # checkpointTimeout / abortExpired)
        self.checkpoint_timeout_ms = checkpoint_timeout_ms
        # None = unlimited (legacy behavior: declines/aborts never
        # escalate, a failed persist raises immediately).  An int N
        # tolerates N CONSECUTIVE failed/aborted checkpoints; the
        # N+1-th escalates to a task failure (ref:
        # ExecutionCheckpointingOptions.TOLERABLE_FAILURE_NUMBER +
        # CheckpointFailureManager.java)
        self.tolerable_checkpoint_failures = tolerable_checkpoint_failures
        self.consecutive_failures = 0
        self.failed_count = 0       # lifetime failed/aborted/declined
        self.aborted_count = 0      # aborted (timeout) + declined
        self.timeout_aborts = 0     # aborted specifically by timeout
        self._id_counter = 0
        self.pending: Dict[int, PendingCheckpoint] = {}
        self.completed_count = 0
        self.latest_completed_id: Optional[int] = None
        self._last_completed_at: float = -1e18
        # first trigger fires immediately — fast finite jobs still get
        # a checkpoint in before their sources drain
        self._last_triggered_at: float = self._clock() - (interval_ms or 0)
        #: checkpoint_id -> CheckpointStats, pruned to STATS_RETAIN
        self.stats: Dict[int, CheckpointStats] = {}
        self.STATS_RETAIN = 128
        self.stopped = False
        #: excludes client savepoint triggers against teardown (a
        #: request must either land in a live queue or fail fast)
        self._sp_lock = threading.Lock()
        #: queued SavepointRequests (thread-safe append from clients)
        self._savepoint_queue: deque = deque()
        #: in-flight savepoint checkpoints: cid -> request
        self._savepoint_cids: Dict[int, SavepointRequest] = {}
        #: checkpoint id -> the trace context its barrier carries
        #: (only while the tracer is on)
        self._trace_ctxs: Dict[int, dict] = {}
        #: vertex_id -> parallelism, recorded into savepoints
        self.vertex_parallelisms: Dict[int, int] = {}
        # asynchronous snapshot materialization (ref: the async part
        # of the backends' snapshot strategies — CopyOnWriteStateTable
        # :41-84 lets processing continue while state materializes):
        # acks are collected on the processing loop, but the persist
        # (pickle + storage IO) runs on a single writer thread; the
        # checkpoint COMPLETES (counted, operators notified) only when
        # the write lands — drained back onto the loop thread, so the
        # durable-then-notify 2PC ordering holds.  One write in
        # flight; a second completion waits (maxConcurrent semantics).
        self.async_persist = async_persist
        self._writer: Optional[threading.Thread] = None
        self._write_queue: deque = deque()
        self._write_event = threading.Event()
        self._done_queue: deque = deque()
        self._inflight = 0
        self._inflight_lock = threading.Lock()

    # ---- trigger ----------------------------------------------------
    def maybe_trigger(self) -> Optional[int]:
        """Called from the executor loop; triggers when the interval has
        elapsed (ref: the coordinator's ScheduledTrigger)."""
        self._drain_completions()
        if self.stopped:
            return None
        now = self._clock()
        # expire stale pendings FIRST: a timed-out checkpoint must
        # release its max_concurrent slot on this very call, or a
        # single lost ack pins the slot forever
        self._abort_timed_out(now)
        if len(self.pending) >= self.max_concurrent:
            return None
        # user savepoint requests bypass the periodic gating (ref:
        # triggerSavepoint — props force a trigger regardless of timers)
        if self._savepoint_queue:
            request = self._savepoint_queue.popleft()
            cid = self.trigger(savepoint=request)
            if cid is None:
                request.fail(RuntimeError(
                    "savepoint declined: a source already finished"))
            return cid
        if self.interval_ms is None:
            return None
        if now - self._last_triggered_at < self.interval_ms:
            return None
        if now - self._last_completed_at < self.min_pause_ms:
            return None
        return self.trigger()

    def trigger(self, savepoint: Optional[SavepointRequest] = None
                ) -> Optional[int]:
        """(ref: triggerCheckpoint :394).  Returns None when sources
        refuse the trigger (e.g. a task already finished)."""
        self._id_counter += 1
        cid = self._id_counter
        now = self._clock()
        self._last_triggered_at = now
        self.pending[cid] = PendingCheckpoint(
            cid, int(now), self.expected_tasks)
        self.stats[cid] = CheckpointStats(cid, now)
        for old in sorted(self.stats)[:-self.STATS_RETAIN]:
            del self.stats[old]
        options = {"mode": self.mode}
        if savepoint is not None:
            # savepoints always use aligned exactly-once barriers
            options = {"mode": "exactly_once", "savepoint": True}
            self._savepoint_cids[cid] = savepoint
        tracer = get_tracer()
        if tracer.enabled:
            # the barrier's causal root: every barrier, alignment and
            # ack event links back to this context, which rides the
            # barrier's options through the graph
            ctx = make_trace_context()
            options["trace"] = ctx
            self._trace_ctxs[cid] = ctx
            tracer.record_instant("checkpoint.trigger", checkpoint_id=cid,
                                  trace_id=ctx["trace_id"],
                                  span_id=ctx["span_id"])
        ok = self._trigger_sources(cid, int(now), options)
        if ok is False:
            del self.pending[cid]
            self.stats.pop(cid, None)
            self._savepoint_cids.pop(cid, None)
            self._trace_ctxs.pop(cid, None)
            return None
        return cid

    def trigger_savepoint(self, directory: str) -> SavepointRequest:
        """Thread-safe entry for clients: the request is serviced on
        the executor loop's next maybe_trigger.  A request against a
        stopped coordinator fails immediately instead of queueing
        where no loop will ever service it (the teardown's
        fail_pending_savepoints and this check exclude each other via
        the savepoint lock, so no request can slip into a dead
        queue)."""
        request = SavepointRequest(directory)
        with self._sp_lock:
            if self.stopped:
                request.fail(RuntimeError(
                    "job attempt ended before the savepoint completed"))
                return request
            self._savepoint_queue.append(request)
        return request

    def fail_pending_savepoints(self, error: BaseException) -> None:
        with self._sp_lock:
            self.stopped = True
            while self._savepoint_queue:
                self._savepoint_queue.popleft().fail(error)
            for req in self._savepoint_cids.values():
                req.fail(error)
            self._savepoint_cids.clear()

    # ---- acks -------------------------------------------------------
    def acknowledge(self, task_key: Tuple[int, int], checkpoint_id: int,
                    snapshot: dict) -> None:
        """(ref: receiveAcknowledgeMessage :665)"""
        pc = self.pending.get(checkpoint_id)
        if pc is None:
            return  # late ack of an aborted checkpoint
        pc.acknowledge(task_key, snapshot)
        st = self.stats.get(checkpoint_id)
        if st is not None and task_key in pc.acks:
            st.record_ack(task_key, self._clock() - st.trigger_ms)
        ctx = self._trace_ctxs.get(checkpoint_id)
        if ctx is not None:
            get_tracer().record_instant(
                "checkpoint.ack", checkpoint_id=checkpoint_id,
                task=list(task_key) if task_key else None,
                trace_id=ctx["trace_id"], parent_span_id=ctx["span_id"])
        if pc.fully_acknowledged:
            self._complete(pc)

    def decline(self, checkpoint_id: int) -> None:
        """(ref: CheckpointDeclineReason / abortDeclined).  Releases
        the max_concurrent slot and counts toward the tolerable-
        failure budget (when one is configured)."""
        pc = self.pending.pop(checkpoint_id, None)
        self._trace_ctxs.pop(checkpoint_id, None)
        req = self._savepoint_cids.pop(checkpoint_id, None)
        if req is not None:
            req.fail(RuntimeError(
                "savepoint declined: a source already finished"))
        if pc is not None:
            self.aborted_count += 1
            st = self.stats.get(checkpoint_id)
            if st is not None:
                st.mark_failed("declined", self._clock())
            self._register_failure(RuntimeError(
                f"checkpoint {checkpoint_id} declined"))

    def abort_all_pending(self) -> None:
        self.pending.clear()

    def _abort_timed_out(self, now: float) -> None:
        """Abort pending checkpoints older than checkpoint_timeout_ms
        (ref: PendingCheckpoint abort(CHECKPOINT_EXPIRED)).  A later
        ack of an aborted id hits the pending-map miss in
        `acknowledge` and is ignored."""
        if self.checkpoint_timeout_ms is None:
            return
        for cid in [cid for cid, pc in self.pending.items()
                    if now - pc.timestamp >= self.checkpoint_timeout_ms]:
            pc = self.pending.pop(cid)
            self._trace_ctxs.pop(cid, None)
            pc.discarded = True
            self.aborted_count += 1
            self.timeout_aborts += 1
            faults.count("checkpoint_timeouts")
            req = self._savepoint_cids.pop(cid, None)
            err = TimeoutError(
                f"checkpoint {cid} expired after "
                f"{self.checkpoint_timeout_ms}ms "
                f"({len(pc.acks)}/{len(pc.expected)} acks)")
            st = self.stats.get(cid)
            if st is not None:
                st.mark_failed(str(err), now)
            if req is not None:
                req.fail(err)
            self._register_failure(err)

    def _register_failure(self, err: BaseException) -> None:
        """Consecutive-failure accounting; escalates past the
        tolerable budget."""
        self.failed_count += 1
        self.consecutive_failures += 1
        faults.count("checkpoint_failures")
        tolerable = self.tolerable_checkpoint_failures
        if tolerable is not None and self.consecutive_failures > tolerable:
            raise CheckpointFailuresExceeded(
                self.consecutive_failures, tolerable, err)

    def _complete(self, pc: PendingCheckpoint) -> None:
        """(ref: completePendingCheckpoint :802).  The sync part ends
        here — acks are in; stats record it as sync_ms.  Persistence
        runs on the writer thread (async_persist) and completion
        bookkeeping + notifications drain back onto the loop."""
        del self.pending[pc.checkpoint_id]
        now = self._clock()
        st = self.stats.get(pc.checkpoint_id)
        if st is not None:
            st.sync_ms = now
        req = self._savepoint_cids.pop(pc.checkpoint_id, None)
        if self.async_persist and req is None:
            self._submit_write(pc)
            return
        # savepoints stay synchronous: the requester blocks on the
        # result and expects a self-contained artifact.  Wait out any
        # in-flight async write first — the storage/registry are not
        # safe under concurrent persists, and completion order must
        # stay ascending by checkpoint id
        self._drain_completions(wait=True)
        self._finish(pc, *self._do_persist(pc), req)

    def _do_persist(self, pc: PendingCheckpoint):
        try:
            state_bytes = self.storage.persist(
                pc.checkpoint_id,
                {"timestamp": pc.timestamp, "mode": self.mode,
                 **self.metadata_extra},
                pc.acks)
            return state_bytes, None
        except Exception as e:  # noqa: BLE001 — a failed write aborts
            # this checkpoint, not the job (ref: abort on IO failure)
            return None, e

    def _submit_write(self, pc: PendingCheckpoint) -> None:
        if self._writer is None:
            self._writer = threading.Thread(
                target=self._writer_loop, name="checkpoint-writer",
                daemon=True)
            self._writer.start()
        with self._inflight_lock:
            self._inflight += 1
        self._write_queue.append(pc)
        self._write_event.set()

    def _writer_loop(self) -> None:
        while True:
            self._write_event.wait(0.5)
            while self._write_queue:
                pc = self._write_queue.popleft()
                result = self._do_persist(pc)
                self._done_queue.append((pc, result))
                with self._inflight_lock:
                    self._inflight -= 1
            self._write_event.clear()
            if self.stopped and not self._write_queue:
                return

    def _drain_completions(self, wait: bool = False) -> None:
        """Run completion bookkeeping for persisted checkpoints on the
        CALLER's thread (the processing loop) — notifications must not
        race operator state.  wait=True blocks until every in-flight
        write lands (recovery / job end)."""
        if wait:
            while True:
                with self._inflight_lock:
                    if self._inflight == 0 and not self._write_queue:
                        break
                _time.sleep(0.001)
        while self._done_queue:
            pc, (state_bytes, err) = self._done_queue.popleft()
            self._finish(pc, state_bytes, err, None)

    def drain(self) -> None:
        """Block until in-flight checkpoint writes complete and their
        notifications have run (call from the loop thread before
        recovery reads or job teardown)."""
        self._drain_completions(wait=True)

    def _finish(self, pc: PendingCheckpoint, state_bytes, err,
                req: Optional[SavepointRequest]) -> None:
        now = self._clock()
        if err is not None:
            # a failed persist aborts this CHECKPOINT and charges the
            # tolerable-failure budget; with no budget configured
            # (tolerable=None, the legacy default) it fails the JOB
            # outright: silent checkpoint stalls would let 2PC sinks
            # commit against an ever-staler recovery point.  _finish
            # always runs on the loop thread (sync path or drained),
            # so a raise surfaces as a task/job failure.  The stats
            # entry is RETAINED with its cause — failed checkpoints
            # are part of the history the REST layer serves
            st = self.stats.get(pc.checkpoint_id)
            if st is not None:
                st.mark_failed(f"{type(err).__name__}: {err}", now)
            self._trace_ctxs.pop(pc.checkpoint_id, None)
            if req is not None:
                req.fail(err)
            if self.tolerable_checkpoint_failures is None:
                raise err
            self.aborted_count += 1
            self._register_failure(err)  # raises past the budget
            return
        self.consecutive_failures = 0
        self.completed_count += 1
        self.latest_completed_id = pc.checkpoint_id
        self._last_completed_at = now
        st = self.stats.get(pc.checkpoint_id)
        if st is not None:
            st.complete_ms = now
            st.state_bytes = state_bytes if state_bytes is not None else -1
        ctx = self._trace_ctxs.pop(pc.checkpoint_id, None)
        if ctx is not None:
            get_tracer().record_instant(
                "checkpoint.complete", checkpoint_id=pc.checkpoint_id,
                trace_id=ctx["trace_id"], parent_span_id=ctx["span_id"])
        if req is not None:
            try:
                path = write_savepoint(
                    req.directory, pc.checkpoint_id,
                    {"timestamp": pc.timestamp, "savepoint": True},
                    self.storage.materialize(pc.acks),
                    dict(self.vertex_parallelisms))
                req.complete(path)
            except Exception as e:  # noqa: BLE001 — IO or pickling:
                # the waiting client must get the error, not a timeout,
                # and the job must not fail over a savepoint write
                req.fail(e)
        # commit signal (ref: notifyCheckpointComplete :883) — runs
        # strictly after the durable write (2PC ordering)
        self._notify_complete(pc.checkpoint_id)


# ---------------------------------------------------------------------
# Restart strategies (ref: flink-runtime/.../executiongraph/restart/)
# ---------------------------------------------------------------------

class RestartStrategy:
    def can_restart(self) -> bool:
        raise NotImplementedError

    def notify_failure(self, now_ms: float) -> None:
        pass

    @property
    def delay_ms(self) -> int:
        return 0


class NoRestartStrategy(RestartStrategy):
    """(ref: NoRestartStrategy.java)"""

    def can_restart(self) -> bool:
        return False


class FixedDelayRestartStrategy(RestartStrategy):
    """(ref: FixedDelayRestartStrategy.java) — at most
    `restart_attempts` restarts, `delay_ms` apart."""

    def __init__(self, restart_attempts: int, delay_ms: int = 0):
        self.restart_attempts = restart_attempts
        self._delay_ms = delay_ms
        self.attempts_used = 0

    def can_restart(self) -> bool:
        return self.attempts_used < self.restart_attempts

    def notify_failure(self, now_ms: float) -> None:
        self.attempts_used += 1

    @property
    def delay_ms(self) -> int:
        return self._delay_ms


class FailureRateRestartStrategy(RestartStrategy):
    """(ref: FailureRateRestartStrategy.java) — restart unless more
    than `max_failures` within `failure_interval_ms`."""

    def __init__(self, max_failures: int, failure_interval_ms: int,
                 delay_ms: int = 0):
        self.max_failures = max_failures
        self.failure_interval_ms = failure_interval_ms
        self._delay_ms = delay_ms
        self._failures: List[float] = []

    def can_restart(self) -> bool:
        return len(self._failures) < self.max_failures

    def notify_failure(self, now_ms: float) -> None:
        self._failures.append(now_ms)
        horizon = now_ms - self.failure_interval_ms
        self._failures = [t for t in self._failures if t >= horizon]

    @property
    def delay_ms(self) -> int:
        return self._delay_ms


def make_restart_strategy(config: Optional[dict]) -> RestartStrategy:
    """(ref: RestartStrategyFactory.createRestartStrategy)"""
    config = config or {"strategy": "none"}
    kind = config.get("strategy", "none")
    if kind == "none":
        return NoRestartStrategy()
    if kind == "fixed_delay":
        return FixedDelayRestartStrategy(
            config.get("restart_attempts", config.get("attempts", 1)),
            config.get("delay_ms", 0))
    if kind == "failure_rate":
        return FailureRateRestartStrategy(
            config.get("max_failures", 1),
            config.get("failure_interval_ms", 60_000),
            config.get("delay_ms", 0))
    raise ValueError(f"unknown restart strategy '{kind}'")
