"""Two-phase commit sink: output that becomes visible exactly once,
tied to checkpoints (port of ``flink_tpu/streaming/two_phase.py``).

- Every value is written into the current transaction.
- At the barrier (``snapshot_function_state``) the current transaction
  is pre-committed, parked under the checkpoint's id, and a new one
  begins, together with the operator's snapshot.
- When the checkpoint completes (``notify_checkpoint_complete``) the
  transactions parked under it and older ones commit.
- On restore the parked transactions of the restored checkpoint are
  recovered and committed (the checkpoint completed), and the one that
  was open at the snapshot is recovered and aborted (its values lie
  after the barrier and are replayed).
- At the end of input everything in flight commits.

A commit must be idempotent: a failure after a commit and before the
next checkpoint replays it on recovery.
"""

from __future__ import annotations

import abc
import copy
import uuid
from typing import Any, List, Optional, Tuple

from flink_tpu_torch.core.functions import RichFunction
from flink_tpu_torch.streaming.sources import SinkFunction


class TwoPhaseCommitSinkFunction(SinkFunction, RichFunction, abc.ABC):
    def __init__(self):
        RichFunction.__init__(self)
        self._current_txn: Any = None
        #: (checkpoint_id, transaction) waiting for its checkpoint
        self._pending_commit: List[Tuple[Optional[int], Any]] = []

    # ---- what a sink defines ----------------------------------------
    @abc.abstractmethod
    def begin_transaction(self) -> Any: ...

    @abc.abstractmethod
    def invoke_in_transaction(self, transaction, value, context) -> None: ...

    @abc.abstractmethod
    def pre_commit(self, transaction) -> None: ...

    @abc.abstractmethod
    def commit(self, transaction) -> None: ...

    @abc.abstractmethod
    def abort(self, transaction) -> None: ...

    def recover_and_commit(self, transaction) -> None:
        """Commit a pre-committed transaction found in restored state."""
        self.commit(transaction)

    def recover_and_abort(self, transaction) -> None:
        self.abort(transaction)

    # ---- lifecycle --------------------------------------------------
    def open(self, configuration):
        """Abort what a previous attempt left: the function instance is
        shared across restarts, and without a restore an attempt would
        otherwise replay into its predecessor's transactions."""
        if self._current_txn is not None:
            self.abort(self._current_txn)
        for _cid, txn in self._pending_commit:
            self.abort(txn)
        self._pending_commit = []
        self._current_txn = self.begin_transaction()

    def invoke(self, value, context=None):
        self.invoke_in_transaction(self._current_txn, value, context)

    # ---- checkpoints ------------------------------------------------
    def snapshot_function_state(self, checkpoint_id: Optional[int]) -> dict:
        """At the barrier: pre-commit, park, begin anew.  A deep copy:
        in-memory checkpoint storage would otherwise alias the live
        transactions, and a later abort would clear what the restored
        checkpoint commits."""
        self.pre_commit(self._current_txn)
        self._pending_commit.append((checkpoint_id, self._current_txn))
        self._current_txn = self.begin_transaction()
        return copy.deepcopy({"pending": list(self._pending_commit),
                              "current": self._current_txn})

    def restore_function_state(self, state: dict) -> None:
        for _cid, txn in state["pending"]:
            self.recover_and_commit(txn)
        self._pending_commit = []
        self.recover_and_abort(state["current"])
        self._current_txn = self.begin_transaction()

    def notify_checkpoint_complete(self, checkpoint_id: int) -> None:
        remaining = []
        for cid, txn in self._pending_commit:
            if cid is None or cid <= checkpoint_id:
                self.commit(txn)
            else:
                remaining.append((cid, txn))
        self._pending_commit = remaining

    def finish(self) -> None:
        """End of input: no barrier comes again, so the parked and the
        current transactions commit now."""
        for _cid, txn in self._pending_commit:
            self.commit(txn)
        self._pending_commit = []
        self.pre_commit(self._current_txn)
        self.commit(self._current_txn)
        self._current_txn = self.begin_transaction()


class _BufferingTransaction:
    """Values parked until commit, under an id unique across processes
    (a restarted process writing to a durable target must not reuse an
    id committed before it)."""

    __slots__ = ("txn_id", "values", "prepared")

    def __init__(self):
        self.txn_id = uuid.uuid4().hex
        self.values: List[Any] = []
        self.prepared = False

    def __getstate__(self):
        return (self.txn_id, self.values, self.prepared)

    def __setstate__(self, state):
        self.txn_id, self.values, self.prepared = state


class TransactionalCollectSink(TwoPhaseCommitSinkFunction):
    """Values reach ``committed`` only when their checkpoint completes;
    a commit is idempotent by transaction id."""

    def __init__(self, target: Optional[list] = None):
        super().__init__()
        self.committed: List[Any] = target if target is not None else []
        self._committed_txn_ids = set()

    def begin_transaction(self):
        return _BufferingTransaction()

    def invoke_in_transaction(self, txn, value, context):
        txn.values.append(value)

    def pre_commit(self, txn):
        txn.prepared = True

    def commit(self, txn):
        if txn.txn_id in self._committed_txn_ids:
            return  # a replayed commit
        self._committed_txn_ids.add(txn.txn_id)
        self.committed.extend(txn.values)

    def abort(self, txn):
        txn.values.clear()
