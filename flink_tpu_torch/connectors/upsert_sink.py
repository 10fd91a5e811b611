"""Idempotent upsert sink: the search-index / key-value store
connector (port of ``flink_tpu/connectors/upsert_sink.py``).

Deliveries are at least once, but every mutation carries a
deterministic document id, so a replay overwrites instead of
duplicating: on the store the effect is exactly once.

- Mutations buffer per document id, the last one wins (a replayed
  window fires the same (id, doc) again).
- The buffer flushes at every checkpoint barrier
  (``snapshot_function_state``: the checkpoint is acknowledged only
  once the store took everything before the barrier), when it holds
  ``buffer_size`` ids, and at close.
- A failed bulk write retries with exponential backoff; when the
  retries run out the job fails.

The store is a ``DocumentStore``: ``bulk(actions)`` with each action
``(doc_id, doc_or_None)`` (None deletes: the retract half of an upsert
stream).  ``FileDocumentStore`` keeps a JSON file per document under a
directory.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from flink_tpu_torch.streaming.sources import RichSinkFunction

__all__ = ["DocumentStore", "FileDocumentStore", "UpsertSink"]


class DocumentStore:
    """Minimal external-store client: apply a bulk of idempotent
    mutations.  May raise on transient failure — the sink retries."""

    def bulk(self, actions: List[Tuple[str, Optional[dict]]]) -> None:
        raise NotImplementedError

    def close(self) -> None:  # noqa: B027
        pass


class FileDocumentStore(DocumentStore):
    """Durable JSON-per-document store on a directory (one file per
    document id, atomic replace) — the test/exercise stand-in for an
    external search/KV cluster.  `fail_times` injects transient bulk
    failures (AFTER applying a prefix, so retries must be idempotent
    to pass the tests)."""

    def __init__(self, directory: str, fail_times: int = 0,
                 fail_after: int = 0):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.fail_times = fail_times
        self.fail_after = fail_after
        self.bulk_calls = 0

    def bulk(self, actions: List[Tuple[str, Optional[dict]]]) -> None:
        self.bulk_calls += 1
        for i, (doc_id, doc) in enumerate(actions):
            if self.fail_times > 0 and i >= self.fail_after:
                self.fail_times -= 1
                raise ConnectionError(
                    f"injected transient failure (remaining "
                    f"{self.fail_times})")
            path = os.path.join(self.directory, f"{doc_id}.json")
            if doc is None:
                try:
                    os.unlink(path)
                except FileNotFoundError:
                    pass
                continue
            fd, tmp = tempfile.mkstemp(dir=self.directory)
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, path)

    def read_all(self) -> Dict[str, dict]:
        out = {}
        for name in os.listdir(self.directory):
            if not name.endswith(".json"):
                continue
            with open(os.path.join(self.directory, name)) as f:
                out[name[:-5]] = json.load(f)
        return out


class UpsertSink(RichSinkFunction):
    """Checkpoint-aligned idempotent upsert sink.

    ``key_fn(value) -> doc_id`` and ``doc_fn(value) -> dict`` extract
    the mutation from each record.  With ``retract_stream=True``
    records are ``(is_add, row)`` pairs (a Table's
    to_retract_stream): a retract maps to a DELETE of the row's id.
    The flag is wired automatically when the sink is attached to a
    ``to_retract_stream()`` result — plain streams are NEVER sniffed
    for pair-shaped values, so a record that happens to be a
    ``(bool, x)`` tuple is upserted as-is.

    Buffered mutations flush when ``buffer_size`` is reached, at every
    checkpoint (flushOnCheckpoint), and at close; flushes retry
    ``max_retries`` times with exponential backoff starting at
    ``backoff_ms``."""

    def __init__(self, store_factory: Callable[[], DocumentStore],
                 key_fn: Callable[[Any], str],
                 doc_fn: Callable[[Any], dict],
                 buffer_size: int = 1000,
                 max_retries: int = 5,
                 backoff_ms: int = 10,
                 retract_stream: bool = False):
        super().__init__()
        self.store_factory = store_factory
        self.key_fn = key_fn
        self.doc_fn = doc_fn
        self.buffer_size = buffer_size
        self.max_retries = max_retries
        self.backoff_ms = backoff_ms
        self.retract_stream = retract_stream
        self._store: Optional[DocumentStore] = None
        #: doc_id -> doc | None (last wins; None = delete)
        self._buffer: Dict[str, Optional[dict]] = {}
        self.num_flushes = 0
        self.num_retries = 0

    def enable_retract_decoding(self) -> None:
        """Called by the retract-stream sink wiring
        (DataStream.add_sink on a to_retract_stream result)."""
        self.retract_stream = True

    # ---- lifecycle --------------------------------------------------
    def open(self, configuration=None):
        self._store = self.store_factory()

    def close(self):
        self._flush()
        if self._store is not None:
            self._store.close()

    # ---- writes -----------------------------------------------------
    def invoke(self, value, context=None):
        if self.retract_stream:
            if not (isinstance(value, tuple) and len(value) == 2
                    and isinstance(value[0], bool)):
                raise TypeError(
                    "retract_stream=True expects (is_add, row) pairs; "
                    f"got {value!r}")
            is_add, row = value
        else:
            is_add, row = True, value
        doc_id = str(self.key_fn(row))
        self._buffer[doc_id] = self.doc_fn(row) if is_add else None
        if len(self._buffer) >= self.buffer_size:
            self._flush()

    def _flush(self):
        if not self._buffer:
            return
        actions = list(self._buffer.items())
        delay = self.backoff_ms / 1000.0
        for attempt in range(self.max_retries + 1):
            try:
                self._store.bulk(actions)
                break
            except Exception:  # noqa: BLE001 — transient store failure
                if attempt == self.max_retries:
                    raise
                self.num_retries += 1
                time.sleep(delay)
                delay *= 2
        self._buffer.clear()
        self.num_flushes += 1

    # ---- checkpoint alignment ---------------------------------------
    def snapshot_function_state(self, checkpoint_id=None) -> dict:
        # flushOnCheckpoint: everything before the barrier must be in
        # the store before this subtask acknowledges the checkpoint —
        # a post-restore replay then re-upserts the same doc ids
        # (idempotent), never duplicates
        self._flush()
        return {}

    def restore_function_state(self, state) -> None:
        pass
