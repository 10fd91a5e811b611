"""Exactly-once bucketing file sink (port of
``flink_tpu/connectors/bucketing_sink.py``).

Records append to per-bucket ``part-<subtask>-<n>`` files, each of
which goes through three states:

    in-progress  (being written)
 -> pending      (bucket rolled; waits for a checkpoint)
 -> finished     (checkpoint completed: renamed to its final name)

Exactly once across failures comes from the valid length: the snapshot
records each in-progress file's length, a restore truncates the file
back to it and deletes the pending files no checkpoint committed.
``bucketer(value) -> str`` picks the bucket; a bucket rolls at
``batch_size`` bytes.
"""

from __future__ import annotations

import os
from typing import Dict

from flink_tpu_torch.core.functions import RichFunction
from flink_tpu_torch.streaming.sources import RichSinkFunction

IN_PROGRESS_SUFFIX = ".in-progress"
PENDING_SUFFIX = ".pending"


class _Bucket:
    __slots__ = ("path", "handle", "counter")

    def __init__(self, path: str, handle, counter: int):
        self.path = path  # final path (no suffix)
        self.handle = handle
        self.counter = counter


class BucketingFileSink(RichSinkFunction):
    def __init__(self, base_path: str, bucketer=None,
                 batch_size: int = 64 * 1024 * 1024,
                 formatter=str):
        RichFunction.__init__(self)
        self.base_path = base_path
        self.bucketer = bucketer or (lambda value: "bucket")
        self.batch_size = batch_size
        self.formatter = formatter
        self._subtask = 0
        #: bucket_id -> _Bucket with an open in-progress file
        self._open: Dict[str, _Bucket] = {}
        #: files rolled since the last checkpoint, awaiting commit
        self._pending: list = []
        #: pending files per checkpoint id, committed on notification
        self._pending_per_checkpoint: Dict[int, list] = {}
        self._counter = 0

    # ---- lifecycle --------------------------------------------------
    def open(self, configuration=None):
        ctx = self._runtime_context  # None outside a task (direct use)
        self._subtask = ctx.index_of_this_subtask if ctx else 0
        os.makedirs(self.base_path, exist_ok=True)

    def close(self):
        for bucket in self._open.values():
            bucket.handle.close()
        self._open.clear()

    # ---- writing ----------------------------------------------------
    def _bucket_for(self, bucket_id: str) -> _Bucket:
        bucket = self._open.get(bucket_id)
        if bucket is None:
            directory = os.path.join(self.base_path, bucket_id)
            os.makedirs(directory, exist_ok=True)
            final = os.path.join(
                directory, f"part-{self._subtask}-{self._counter}")
            self._counter += 1
            handle = open(final + IN_PROGRESS_SUFFIX, "ab")
            bucket = _Bucket(final, handle, self._counter)
            self._open[bucket_id] = bucket
        return bucket

    def invoke(self, value, context=None):
        bucket_id = self.bucketer(value)
        bucket = self._bucket_for(bucket_id)
        bucket.handle.write((self.formatter(value) + "\n").encode())
        if bucket.handle.tell() >= self.batch_size:
            self._roll(bucket_id)

    def _roll(self, bucket_id: str) -> None:
        """in-progress -> pending (awaits the next checkpoint)."""
        bucket = self._open.pop(bucket_id)
        bucket.handle.close()
        os.replace(bucket.path + IN_PROGRESS_SUFFIX,
                   bucket.path + PENDING_SUFFIX)
        self._pending.append(bucket.path)

    # ---- checkpoint integration ------------------------------------
    def snapshot_function_state(self, checkpoint_id=None) -> dict:
        for bucket in self._open.values():
            bucket.handle.flush()
            os.fsync(bucket.handle.fileno())
        if checkpoint_id is not None:
            self._pending_per_checkpoint[checkpoint_id] = self._pending
            self._pending = []
        return {
            "in_progress": {bid: (b.path, b.handle.tell())
                            for bid, b in self._open.items()},
            "pending_per_checkpoint":
                {cid: list(paths) for cid, paths
                 in self._pending_per_checkpoint.items()},
            "counter": self._counter,
        }

    def notify_checkpoint_complete(self, checkpoint_id: int) -> None:
        """pending -> finished for every checkpoint <= this one."""
        for cid in sorted(self._pending_per_checkpoint):
            if cid > checkpoint_id:
                continue
            for path in self._pending_per_checkpoint.pop(cid):
                if os.path.exists(path + PENDING_SUFFIX):
                    os.replace(path + PENDING_SUFFIX, path)

    def restore_function_state(self, state: dict) -> None:
        self._counter = state["counter"]
        # truncate in-progress files to their checkpointed valid length
        for bid, (path, valid_length) in state["in_progress"].items():
            ip = path + IN_PROGRESS_SUFFIX
            if os.path.exists(ip):
                with open(ip, "ab") as f:
                    f.truncate(valid_length)
                handle = open(ip, "ab")
                self._open[bid] = _Bucket(path, handle, 0)
        # uncommitted pending files from the failed execution are
        # REPLAYED, so the files themselves commit now (their content
        # is pre-checkpoint by construction)
        self._pending_per_checkpoint = {
            int(cid): list(paths) for cid, paths
            in state["pending_per_checkpoint"].items()}
        for cid in list(self._pending_per_checkpoint):
            for path in self._pending_per_checkpoint.pop(cid):
                if os.path.exists(path + PENDING_SUFFIX):
                    os.replace(path + PENDING_SUFFIX, path)
        # stray in-progress/pending files not in the snapshot are
        # garbage from the failed attempt — remove them
        snapshot_ip = {p + IN_PROGRESS_SUFFIX
                       for _, (p, _) in state["in_progress"].items()}
        for root, _dirs, files in os.walk(self.base_path):
            for name in files:
                full = os.path.join(root, name)
                if full.endswith(IN_PROGRESS_SUFFIX) \
                        and full not in snapshot_ip:
                    os.remove(full)
                elif full.endswith(PENDING_SUFFIX):
                    os.remove(full)
