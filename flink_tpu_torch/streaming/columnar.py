"""Columnar flow: sources that emit RecordBatch elements, and the
conventions for building them (port of
``flink_tpu/streaming/columnar.py:54-210, 286-300``).

A stream element may be a :class:`RecordBatch` (numpy columns and a
timestamp column).  Column names follow one convention: ``"v"`` for
scalar rows, ``"f0".."fk"`` for tuple rows.  ``VectorizedCollectionSource``
builds its columns once and emits one batch per step; the column
kernels of ``StreamMap`` / ``StreamFilter``, the fused chain program
and the router's key-group split then carry the batch whole.
``FromCollectionSource`` gives the same rows as records.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from flink_tpu_torch.streaming.elements import RecordBatch
from flink_tpu_torch.streaming.sources import SinkFunction, SourceFunction

def columns_from_values(values: Sequence) -> Optional[Dict[str, np.ndarray]]:
    """Row values onto the column convention ("v" for scalar rows,
    "f0".."fk" for tuple rows), or None when they do not fit a column
    shape (mixed types, bools, ints beyond int64, nested tuples)."""
    if not values:
        return None
    v0 = values[0]
    if type(v0) is tuple:
        arity = len(v0)
        if arity == 0 or any(type(v) is not tuple or len(v) != arity
                             for v in values):
            return None
        cols = {}
        for i in range(arity):
            col = _column_from_cells([v[i] for v in values])
            if col is None:
                return None
            cols[f"f{i}"] = col
        return cols
    col = _column_from_cells(values)
    if col is None:
        return None
    return {"v": col}


def _column_from_cells(cells: list) -> Optional[np.ndarray]:
    """One homogeneous cell list as an ndarray, or None (exact ``type
    is`` checks: bool is an int, floats do not survive an int64 cast)."""
    t = type(cells[0])
    if any(type(c) is not t for c in cells):
        return None
    if t is int:
        try:
            return np.array(cells, np.int64)
        except OverflowError:
            return None
    if t is float:
        return np.array(cells, np.float64)
    if t is str:
        arr = np.empty(len(cells), object)
        arr[:] = cells
        return arr
    return None


def batch_from_records(values: Sequence, timestamps: Optional[Sequence]
                       ) -> Optional[RecordBatch]:
    """Values and per-row Optional[int] timestamps as a RecordBatch
    (with a validity mask when some timestamps are None), or None when
    the values do not fit columns."""
    cols = columns_from_values(values)
    if cols is None:
        return None
    if timestamps is None or all(t is None for t in timestamps):
        return RecordBatch(cols)
    if any(t is None for t in timestamps):
        mask = np.array([t is not None for t in timestamps], bool)
        stamps = np.array([t if t is not None else 0 for t in timestamps],
                          np.int64)
        return RecordBatch(cols, stamps, mask)
    return RecordBatch(cols, np.array(list(timestamps), np.int64))


def batch_from_arrays(arrays, ts=None, ts_mask=None) -> RecordBatch:
    """A batch from ready columns: one array gives scalar rows ("v"),
    a tuple or list of arrays tuple rows ("f0".."fk")."""
    if isinstance(arrays, (tuple, list)):
        return RecordBatch(
            {f"f{i}": np.asarray(a) for i, a in enumerate(arrays)},
            ts, ts_mask)
    return RecordBatch({"v": np.asarray(arrays)}, ts, ts_mask)


class VectorizedCollectionSource(SourceFunction):
    """Bounded source over a collection that emits RecordBatches of
    ``chunk`` rows, its columns built once at construction.  With
    ``timestamped=True`` the items are (value, ts) pairs.  Values that
    do not fit columns raise: use ``FromCollectionSource``.

    ``from_batch`` builds the same source from a ready batch (columns
    made in bulk, not from Python values)."""

    def __init__(self, values: Sequence, timestamped: bool = False,
                 chunk: int = 16384):
        values = list(values)
        self.timestamped = timestamped
        self.chunk = chunk
        if timestamped:
            raw = [v for v, _ in values]
            ts = [t for _, t in values]
        else:
            raw, ts = values, None
        batch = batch_from_records(raw, ts)
        if batch is None and values:
            raise TypeError("collection does not fit the columnar convention "
                            "(mixed or non-scalar rows): use "
                            "FromCollectionSource")
        #: the whole input as one batch; emit_step slices it
        self._batch = batch
        self._n = len(values)
        self._running = True
        #: resume offset in rows
        self.offset = 0

    @classmethod
    def from_batch(cls, batch: RecordBatch,
                   chunk: int = 16384) -> "VectorizedCollectionSource":
        src = cls([], chunk=chunk)
        src.timestamped = batch.ts is not None
        src._batch = batch
        src._n = len(batch)
        return src

    def run(self, ctx) -> None:
        while self.emit_step(ctx, self.chunk):
            pass

    def emit_step(self, ctx, max_records: int) -> bool:
        """One step emits one batch (a batch is one element: cutting it
        to ``max_records`` rows would undo the amortization)."""
        if self.offset < self._n and self._running:
            end = min(self.offset + self.chunk, self._n)
            sl = self._batch.take(slice(self.offset, end))
            self.offset = end
            ctx.collect_batch(sl)
        return self.offset < self._n and self._running

    def cancel(self) -> None:
        self._running = False

    def __deepcopy__(self, memo):
        # batches are immutable: a copy needs only a fresh cursor
        clone = type(self).__new__(type(self))
        clone.__dict__.update(self.__dict__)
        clone._running = True
        return clone

    # the read position is the source's checkpointed state
    def snapshot_function_state(self, checkpoint_id=None) -> dict:
        return {"offset": self.offset}

    def restore_function_state(self, state: dict) -> None:
        self.offset = state["offset"]


class ColumnarCollectSink(SinkFunction):
    """Collects the batches it is given; row-style access for checks."""

    def __init__(self):
        self.batches: List[RecordBatch] = []

    def invoke(self, value, context=None):
        self.batches.append(value)

    def total_rows(self) -> int:
        return sum(len(b) for b in self.batches)

    def rows(self):
        for b in self.batches:
            yield from b.rows()
