"""JDBC-shaped database connector on DB-API drivers (port of
``flink_tpu/connectors/jdbc.py``).

``JdbcInputFormat`` reads a parameterized query's rows,
``JdbcOutputFormat`` writes rows in batched transactions, and
``JdbcSink`` buffers a stream's rows and flushes them as one
transaction at every checkpoint, at the batch size and at the end of
input.  With an upsert statement and a replayable source a replay
overwrites the same keys: effectively once.  ``sqlite3`` from the
standard library is the default driver; any DB-API connection factory
plugs in.
"""


from __future__ import annotations

import sqlite3
from typing import Any, Callable, Iterable, List, Optional, Sequence

from flink_tpu_torch.core.formats import InputFormat, OutputFormat
from flink_tpu_torch.streaming.sources import RichSinkFunction


def _sqlite_factory(path: str) -> Callable[[], Any]:
    def connect():
        conn = sqlite3.connect(path)
        conn.isolation_level = None  # explicit transactions
        return conn
    return connect


class JdbcInputFormat(InputFormat):
    """(ref: JDBCInputFormat — row-at-a-time query results)."""

    def __init__(self, query: str,
                 connection_factory: Optional[Callable] = None,
                 sqlite_path: Optional[str] = None,
                 parameters: Sequence[Any] = ()):
        assert (connection_factory is None) != (sqlite_path is None), \
            "pass exactly one of connection_factory / sqlite_path"
        self._factory = connection_factory or _sqlite_factory(sqlite_path)
        self.query = query
        self.parameters = tuple(parameters)

    def read(self) -> List[tuple]:
        conn = self._factory()
        try:
            cur = conn.execute(self.query, self.parameters)
            return [tuple(row) for row in cur.fetchall()]
        finally:
            conn.close()


class JdbcOutputFormat(OutputFormat):
    """(ref: JDBCOutputFormat — batched inserts)."""

    def __init__(self, statement: str,
                 connection_factory: Optional[Callable] = None,
                 sqlite_path: Optional[str] = None,
                 batch_size: int = 1000):
        assert (connection_factory is None) != (sqlite_path is None)
        self._factory = connection_factory or _sqlite_factory(sqlite_path)
        self.statement = statement
        self.batch_size = batch_size

    def write(self, records: Iterable[Sequence[Any]]) -> int:
        conn = self._factory()
        n = 0
        try:
            conn.execute("BEGIN")
            batch: List[Sequence[Any]] = []
            for r in records:
                batch.append(tuple(r))
                if len(batch) >= self.batch_size:
                    conn.executemany(self.statement, batch)
                    n += len(batch)
                    batch = []
            if batch:
                conn.executemany(self.statement, batch)
                n += len(batch)
            conn.execute("COMMIT")
            return n
        finally:
            conn.close()


class JdbcSink(RichSinkFunction):
    """Streaming sink: records buffer in memory and flush as one
    batched transaction on every checkpoint (snapshot hook), plus at
    finish.  With an UPSERT statement (INSERT ... ON CONFLICT ...
    UPDATE / INSERT OR REPLACE) and a replayable source, a replay
    after failure overwrites the same keys — the idempotent
    effectively-once contract of the reference's JDBC sink."""

    def __init__(self, statement: str,
                 connection_factory: Optional[Callable] = None,
                 sqlite_path: Optional[str] = None,
                 extractor: Callable[[Any], Sequence[Any]] = None,
                 batch_size: int = 5000):
        from flink_tpu_torch.core.functions import RichFunction
        RichFunction.__init__(self)
        assert (connection_factory is None) != (sqlite_path is None)
        self._factory = connection_factory or _sqlite_factory(sqlite_path)
        self.statement = statement
        self.extractor = extractor or (lambda v: tuple(v))
        #: size-based flush bound (the reference flushes on batch size
        #: AND checkpoint) — without it a job that never checkpoints
        #: would buffer the whole stream in memory
        self.batch_size = batch_size
        self._buffer: List[Sequence[Any]] = []
        self._conn = None

    def open(self, configuration=None):
        self._conn = self._factory()

    def close(self):
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def invoke(self, value, context=None):
        self._buffer.append(tuple(self.extractor(value)))
        if len(self._buffer) >= self.batch_size:
            self._flush()

    def _flush(self):
        if not self._buffer or self._conn is None:
            return
        self._conn.execute("BEGIN")
        self._conn.executemany(self.statement, self._buffer)
        self._conn.execute("COMMIT")
        self._buffer = []

    def snapshot_function_state(self, checkpoint_id=None) -> dict:
        # flush-on-checkpoint: everything up to the barrier is durably
        # in the database before the checkpoint completes
        self._flush()
        return {}

    def restore_function_state(self, state) -> None:
        self._buffer = []

    def finish(self):
        self._flush()
