"""The replayable-log source and the transactional log sink (port of
``flink_tpu/connectors/log_connector.py``): the Kafka-shaped connector.

``ReplayableLogSource`` splits a ``PartitionedLog``'s partitions over
its subtasks (partition p to subtask p mod parallelism), keeps each
partition's next offset in its checkpoint, so a restore rewinds the
read position, and commits offsets back to the log only when their
checkpoint completes (and at the end of input).  It steps on the
executor's loop (``emit_step``), so its barriers come between steps.

``TransactionalLogSink`` is a ``TwoPhaseCommitSinkFunction`` whose
commit appends the transaction's records to a log atomically,
idempotent by transaction id.
"""

from __future__ import annotations

import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple

from flink_tpu_torch.connectors.partitioned_log import PartitionedLog
from flink_tpu_torch.streaming.elements import Watermark
from flink_tpu_torch.streaming.sources import (RichParallelSourceFunction,
                                               SourceContext)
from flink_tpu_torch.streaming.two_phase import TwoPhaseCommitSinkFunction


class ReplayableLogSource(RichParallelSourceFunction):
    """Exactly-once source over a PartitionedLog.

    `bounded=True` finishes when every assigned partition is exhausted
    (test jobs); otherwise the source idles at the head of the log
    until cancelled (the streaming default).  `watermark_lag_ms`
    emits periodic watermarks lagging the max emitted timestamp, for
    records carrying timestamps."""

    def __init__(self, log: PartitionedLog, bounded: bool = False,
                 watermark_lag_ms: Optional[int] = None,
                 batch_per_partition: int = 256):
        super().__init__()
        self.log = log
        self.bounded = bounded
        self.watermark_lag_ms = watermark_lag_ms
        self.batch_per_partition = batch_per_partition
        #: partition -> next offset to read
        self.offsets: Dict[int, int] = {}
        self._my_partitions: Optional[List[int]] = None
        self._cancelled = False
        self._max_ts: Optional[int] = None
        self._last_wm: Optional[int] = None
        #: offsets parked per in-flight checkpoint, committed to the
        #: log on checkpoint completion
        self._pending_offset_commits: List[Tuple[Optional[int], Dict[int, int]]] = []

    # ---- lifecycle --------------------------------------------------
    def open(self, configuration):
        ctx = self.get_runtime_context()
        n = self.log.num_partitions
        idx = ctx.index_of_this_subtask
        par = ctx.number_of_parallel_subtasks
        # partition p belongs to subtask p mod parallelism
        self._my_partitions = [p for p in range(n) if p % par == idx]
        for p in self._my_partitions:
            self.offsets.setdefault(p, 0)
        # restore may have run before open: keep restored offsets, but
        # drop partitions no longer assigned here
        self.offsets = {p: off for p, off in self.offsets.items()
                        if p in self._my_partitions}

    def run(self, ctx: SourceContext):
        while self.emit_step(ctx, self.batch_per_partition):
            time.sleep(0)  # a thread-hosted run stays preemptible

    def emit_step(self, ctx: SourceContext, max_records: int) -> bool:
        if self._cancelled:
            return False
        per_part = max(1, max_records // max(1, len(self._my_partitions or [1])))
        emitted = 0
        exhausted = True
        for p in self._my_partitions or []:
            records = self.log.read(p, self.offsets[p], per_part)
            for _off, ts, value in records:
                if ts is None:
                    ctx.collect(value)
                else:
                    ctx.collect_with_timestamp(value, ts)
                    if self._max_ts is None or ts > self._max_ts:
                        self._max_ts = ts
            if records:
                self.offsets[p] = records[-1][0] + 1
                emitted += len(records)
            if self.offsets[p] < self.log.end_offset(p):
                exhausted = False
        if emitted and self.watermark_lag_ms is not None and self._max_ts is not None:
            wm = self._max_ts - self.watermark_lag_ms
            if self._last_wm is None or wm > self._last_wm:
                self._last_wm = wm
                ctx.emit_watermark(Watermark(wm))
        if self.bounded and exhausted:
            return False
        return not self._cancelled

    def cancel(self):
        self._cancelled = True

    # ---- checkpoint integration -------------------------------------
    def snapshot_function_state(self, checkpoint_id: Optional[int]) -> dict:
        """The read positions; parked until the checkpoint completes."""
        offsets = dict(self.offsets)
        self._pending_offset_commits.append((checkpoint_id, offsets))
        return {"offsets": offsets}

    def restore_function_state(self, state: dict) -> None:
        for p, off in state["offsets"].items():
            if self._my_partitions is None or p in self._my_partitions:
                self.offsets[p] = off

    def notify_checkpoint_complete(self, checkpoint_id: int) -> None:
        """Commit offsets back to the log for completed checkpoints."""
        remaining = []
        for cid, offsets in self._pending_offset_commits:
            if cid is None or cid <= checkpoint_id:
                self.log.commit_offsets(offsets)
            else:
                remaining.append((cid, offsets))
        self._pending_offset_commits = remaining

    def finish(self) -> None:
        """End of input: commit the final read positions."""
        self._pending_offset_commits = []
        if self.offsets:
            self.log.commit_offsets(dict(self.offsets))


class _LogTransaction:
    """Globally-unique transaction id (uuid): a process-local counter
    would collide with ids already committed to a durable log by a
    previous run, and the idempotence dedupe would drop fresh data."""

    __slots__ = ("txn_id", "records")

    def __init__(self):
        self.txn_id = f"txn-{uuid.uuid4().hex}"
        self.records: List[Tuple[int, Optional[int], Any]] = []

    def __getstate__(self):
        return (self.txn_id, self.records)

    def __setstate__(self, state):
        self.txn_id, self.records = state


class TransactionalLogSink(TwoPhaseCommitSinkFunction):
    """Exactly-once producer into a PartitionedLog
    (a transaction's records appear once its checkpoint completes)."""

    def __init__(self, log: PartitionedLog,
                 partitioner: Optional[Callable[[Any], int]] = None):
        super().__init__()
        self.log = log
        self._partition_of = partitioner or (
            lambda v: hash(v if not isinstance(v, tuple) else v[0])
            % log.num_partitions)

    def begin_transaction(self):
        return _LogTransaction()

    def invoke_in_transaction(self, txn, value, context):
        ts = context.timestamp if context is not None else None
        txn.records.append((self._partition_of(value), ts, value))

    def pre_commit(self, txn):
        pass  # buffered; durability comes from the log's commit

    def commit(self, txn):
        # idempotent by txn id — replayed commits are no-ops
        self.log.append_transaction(txn.txn_id, txn.records)

    def abort(self, txn):
        txn.records.clear()
