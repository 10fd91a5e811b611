"""A partitioned, replayable log: the broker the connectors read and
write (port of ``flink_tpu/connectors/partitioned_log.py``).

Numbered partitions of append-only ``(offset, timestamp, value)``
records, re-readable from any offset, with committed consumer offsets
beside them and transactions appended exactly once by id.  Two kinds:
in memory, and files of JSON lines under a directory that survive the
process.  The file format is the JAX package's, byte for byte
(``part-<p>.jsonl`` of ``[timestamp, value]`` lines,
``committed-offsets.json``, ``committed-txns.jsonl``), so a log written
by one package reads in the other.  Both are thread-safe: feeders
append from their own threads while a job reads.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, List, Optional, Tuple


class PartitionedLog:
    """Log contract: (offset, timestamp, value) records per partition."""

    def __deepcopy__(self, memo):
        """A log is an external-system handle (the broker): deep-copying
        a source function per subtask must NOT clone the log, or
        subtasks would read private snapshots and never see appends."""
        return self

    @property
    def num_partitions(self) -> int:
        raise NotImplementedError

    def append(self, partition: int, value: Any,
               timestamp: Optional[int] = None) -> int:
        """Returns the record's offset."""
        raise NotImplementedError

    def append_keyed(self, key, value, timestamp: Optional[int] = None) -> int:
        """Route by key hash, like a keyed Kafka producer."""
        return self.append(hash(key) % self.num_partitions, value, timestamp)

    def read(self, partition: int, offset: int,
             max_records: int) -> List[Tuple[int, Optional[int], Any]]:
        """Records from `offset` (inclusive), at most `max_records`."""
        raise NotImplementedError

    def end_offset(self, partition: int) -> int:
        raise NotImplementedError

    def commit_offsets(self, offsets: Dict[int, int]) -> None:
        """Consumer-group offset commit (observable by tests)."""
        raise NotImplementedError

    @property
    def committed_offsets(self) -> Dict[int, int]:
        raise NotImplementedError

    def append_transaction(self, txn_id,
                           records: List[Tuple[int, Optional[int], Any]]) -> bool:
        """Atomically append `records` ([(partition, timestamp, value)])
        exactly once per txn_id: the idempotent commit a
        TwoPhaseCommitSinkFunction needs.  Returns False on a replay."""
        raise NotImplementedError

    def all_values(self, partition: Optional[int] = None) -> List[Any]:
        raise NotImplementedError


class InMemoryPartitionedLog(PartitionedLog):
    def __init__(self, num_partitions: int = 1):
        self._n = num_partitions
        self._parts: List[List[Tuple[Optional[int], Any]]] = [
            [] for _ in range(num_partitions)]
        self._committed: Dict[int, int] = {}
        self._committed_txns: set = set()
        self._lock = threading.Lock()

    @property
    def num_partitions(self) -> int:
        return self._n

    def append(self, partition, value, timestamp=None) -> int:
        with self._lock:
            part = self._parts[partition]
            part.append((timestamp, value))
            return len(part) - 1

    def read(self, partition, offset, max_records):
        with self._lock:
            part = self._parts[partition]
            return [(offset + i, ts, v)
                    for i, (ts, v) in enumerate(part[offset:offset + max_records])]

    def end_offset(self, partition) -> int:
        with self._lock:
            return len(self._parts[partition])

    def commit_offsets(self, offsets):
        with self._lock:
            self._committed.update(offsets)

    @property
    def committed_offsets(self):
        with self._lock:
            return dict(self._committed)

    # ---- transactional producer side (Kafka-0.11 analogue) ----------
    def append_transaction(self, txn_id, records) -> bool:
        with self._lock:
            if txn_id in self._committed_txns:
                return False
            self._committed_txns.add(txn_id)
            for partition, ts, v in records:
                self._parts[partition].append((ts, v))
            return True

    def all_values(self, partition: Optional[int] = None) -> List[Any]:
        with self._lock:
            parts = (self._parts if partition is None
                     else [self._parts[partition]])
            return [v for p in parts for (_ts, v) in p]


class FilePartitionedLog(PartitionedLog):
    """A JSON-lines file per partition under `directory`: records,
    committed offsets and committed transaction ids survive the
    process."""

    def __init__(self, directory: str, num_partitions: int = 1):
        self.directory = directory
        self._n = num_partitions
        self._lock = threading.Lock()
        self._txn_cache = None  # lazy: committed txn ids
        os.makedirs(directory, exist_ok=True)
        #: cached records per partition (files are append-only)
        self._cache: List[List[Tuple[Optional[int], Any]]] = [
            [] for _ in range(num_partitions)]
        for p in range(num_partitions):
            path = self._part_path(p)
            if os.path.exists(path):
                with open(path) as f:
                    for line in f:
                        ts, v = json.loads(line)
                        self._cache[p].append((ts, v))

    def _part_path(self, p: int) -> str:
        return os.path.join(self.directory, f"part-{p}.jsonl")

    def _offsets_path(self) -> str:
        return os.path.join(self.directory, "committed-offsets.json")

    @property
    def num_partitions(self) -> int:
        return self._n

    def append(self, partition, value, timestamp=None) -> int:
        with self._lock:
            with open(self._part_path(partition), "a") as f:
                f.write(json.dumps([timestamp, value]) + "\n")
            self._cache[partition].append((timestamp, value))
            return len(self._cache[partition]) - 1

    def read(self, partition, offset, max_records):
        with self._lock:
            part = self._cache[partition]
            return [(offset + i, ts, v)
                    for i, (ts, v) in enumerate(part[offset:offset + max_records])]

    def end_offset(self, partition) -> int:
        with self._lock:
            return len(self._cache[partition])

    def commit_offsets(self, offsets):
        with self._lock:
            current = self.committed_offsets_unlocked()
            current.update({str(k): v for k, v in offsets.items()})
            tmp = self._offsets_path() + ".part"
            with open(tmp, "w") as f:
                json.dump(current, f)
            os.replace(tmp, self._offsets_path())

    def committed_offsets_unlocked(self) -> dict:
        if not os.path.exists(self._offsets_path()):
            return {}
        with open(self._offsets_path()) as f:
            return json.load(f)

    @property
    def committed_offsets(self):
        with self._lock:
            return {int(k): v for k, v in self.committed_offsets_unlocked().items()}

    def _txns_path(self) -> str:
        return os.path.join(self.directory, "committed-txns.jsonl")

    def _seen_txns(self) -> set:
        """Cached committed-txn ids (append-only file, loaded once)."""
        if self._txn_cache is None:
            self._txn_cache = set()
            if os.path.exists(self._txns_path()):
                with open(self._txns_path()) as f:
                    self._txn_cache = {line.strip() for line in f}
        return self._txn_cache

    def append_transaction(self, txn_id, records) -> bool:
        with self._lock:
            seen = self._seen_txns()
            if str(txn_id) in seen:
                return False
            seen.add(str(txn_id))
            for partition, ts, v in records:
                with open(self._part_path(partition), "a") as f:
                    f.write(json.dumps([ts, v]) + "\n")
                self._cache[partition].append((ts, v))
            # record the txn id LAST: a crash mid-append re-appends on
            # replay (at-least-once within the commit itself, like a
            # file sink's truncate-on-recovery would be needed for
            # stronger guarantees)
            with open(self._txns_path(), "a") as f:
                f.write(f"{txn_id}\n")
            return True

    def all_values(self, partition: Optional[int] = None) -> List[Any]:
        with self._lock:
            parts = (self._cache if partition is None
                     else [self._cache[partition]])
            return [v for p in parts for (_ts, v) in p]
