"""Columnar flow: sources that emit RecordBatch elements, the
conventions for building them, and the operators of the Table layer's
columnar plan (port of ``flink_tpu/streaming/columnar.py``).

A stream element may be a :class:`RecordBatch` (numpy columns and a
timestamp column).  Column names follow one convention: ``"v"`` for
scalar rows, ``"f0".."fk"`` for tuple rows.  ``VectorizedCollectionSource``
builds its columns once and emits one batch per step; the column
kernels of ``StreamMap`` / ``StreamFilter``, the fused chain program
and the router's key-group split then carry the batch whole.
``FromCollectionSource`` gives the same rows as records.

The columnar plan (``flink_tpu_torch/table/api.py``) carries batches
as record values instead: ``ColumnarSource`` emits one batch of named
columns per step and a watermark after it, ``ColumnarWindowOperator``
feeds whole batches to a window engine built on the environment's
device and fires batches, ``BatchKeyGroupSplitOperator`` is its keyBy
exchange at parallelism > 1 (a (target, sub-batch) carrier per
subtask, routed by ``partition_custom``), ``ColumnarIntervalJoinOperator``
joins two batch streams on the host runtime's interval join core, and
``explode_to_rows`` turns batches back into row records.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from flink_tpu_torch import native
from flink_tpu_torch.core.keygroups import make_key_group_keep_fn
from flink_tpu_torch.device import DeviceLike, resolve_device
from flink_tpu_torch.ops.device_agg import DeviceAggregateFunction
from flink_tpu_torch.streaming import log_windows as lw
from flink_tpu_torch.streaming.elements import (MAX_WATERMARK, MIN_TIMESTAMP,
                                                RecordBatch, StreamRecord,
                                                Watermark)
from flink_tpu_torch.streaming.operators import StreamOperator
from flink_tpu_torch.streaming.sources import SinkFunction, SourceFunction
from flink_tpu_torch.streaming.vectorized import hash_keys_np

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

    #: read by ``analysis.columnar_eligibility``: the source's elements
    #: are batches
    emits_batches = True

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


class ColumnarSource(SourceFunction):
    """Bounded source over named column arrays, sorted on the
    ``rowtime`` column: one RecordBatch of ``chunk`` rows per step, then
    a watermark of the batch's last time less ``ooo_slack_ms`` less 1,
    and the final watermark at the end.  Its read position is its
    checkpointed state, so recovery resumes exactly once."""

    def __init__(self, cols: Dict[str, np.ndarray], rowtime: str,
                 chunk: int = 1 << 19, ooo_slack_ms: int = 0):
        self.cols = {k: np.asarray(v) for k, v in cols.items()}
        self.cols[rowtime] = np.asarray(self.cols[rowtime], np.int64)
        self.rowtime = rowtime
        self.chunk = chunk
        self.ooo_slack_ms = ooo_slack_ms
        self._running = True
        #: resume offset in rows (a chunk boundary)
        self.offset = 0
        self._final_watermark = True

    def run(self, ctx) -> None:
        while self.emit_step(ctx, self.chunk):
            pass

    def emit_step(self, ctx, max_records: int) -> bool:
        """One step emits one batch (a batch is one element: cutting it
        to ``max_records`` rows would undo the amortization)."""
        ts_all = self.cols[self.rowtime]
        n = len(ts_all)
        if self.offset < n and self._running:
            sl = slice(self.offset, self.offset + self.chunk)
            ctx.collect(RecordBatch({k: v[sl] for k, v in self.cols.items()},
                                    ts_all[sl]))
            self.offset = min(self.offset + self.chunk, n)
            ctx.emit_watermark(Watermark(
                int(ts_all[self.offset - 1]) - self.ooo_slack_ms - 1))
        if self.offset < n and self._running:
            return True
        if self._final_watermark:
            ctx.emit_watermark(MAX_WATERMARK)
            self._final_watermark = False
        return False

    def cancel(self) -> None:
        self._running = False

    def __deepcopy__(self, memo):
        # the columns are only sliced: a copy needs a fresh cursor only
        clone = type(self).__new__(type(self))
        clone.__dict__.update(self.__dict__)
        clone._running = True
        return clone

    def snapshot_function_state(self, checkpoint_id=None) -> dict:
        return {"offset": self.offset,
                "final_watermark": self._final_watermark}

    def restore_function_state(self, state: dict) -> None:
        self.offset = state["offset"]
        self._final_watermark = state["final_watermark"]


class _ExplodeBatches(StreamOperator):
    """RecordBatch -> one record per row (a tuple in column order),
    each with its row's timestamp."""

    def process_element(self, record: StreamRecord):
        batch: RecordBatch = record.value
        lists = [c.tolist() for c in batch.cols.values()]
        ts_list = (batch.ts.tolist() if batch.ts is not None
                   else [record.timestamp] * len(batch))
        out = self.output
        for ts, row in zip(ts_list, zip(*lists)):
            out.collect(StreamRecord(row, ts))


def explode_to_rows(stream):
    """The stream of RecordBatch values as a stream of row tuples."""
    return stream._add_op("explode_batches", _ExplodeBatches)


class ColumnarWindowOperator(StreamOperator):
    """``keyBy(key_col).window(assigner).aggregate(agg)`` over batch
    values: whole batches feed the engine, fires leave as batches.

    The engine is built on ``device`` (the card unless "cpu") at the
    first batch, by the key column's dtype, as the JAX package chooses
    it: with a mesh and integer keys the mesh log tier; string keys
    with a tumbling float Sum the fused string-sum engine; integer keys
    the log tier; else (or where the tier's cell decomposition does not
    fit) the scatter tier, and on sessions ``VectorizedSessionWindows``.
    Only those semantic refusals move a job to the next tier: an engine
    that fails to build or launch raises.

    ``out_fields`` maps each output column to one of "key", "agg",
    "wstart", "wend"."""

    def __init__(self, assigner, agg: DeviceAggregateFunction,
                 key_col: str, input_col: Optional[str],
                 out_fields: Sequence[tuple],
                 initial_capacity: int = 1 << 14,
                 mesh=None, mesh_axis: str = "kg",
                 device: DeviceLike = None):
        super().__init__()
        self.assigner = assigner
        self.agg = agg
        self.key_col = key_col
        self.input_col = input_col
        self.out_fields = list(out_fields)
        self.initial_capacity = initial_capacity
        #: a Mesh or a mesh factory: the keyBy exchange is then the mesh
        #: log tier's pack and all_to_all, and the plan stays at
        #: parallelism 1
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        self.device = resolve_device(device)
        self.engine = None
        self.num_late_records_dropped = 0

    # ---- engine choice ------------------------------------------------
    def _make_engine(self, key_dtype, require_log: bool = False) -> Any:
        """``require_log``: a restore of a log-tier snapshot, which no
        other tier can read."""
        from flink_tpu_torch.streaming.device_window_operator import (
            engine_for_assigner, log_engine_for_assigner)
        if require_log:
            eng = log_engine_for_assigner(self.assigner, self.agg, self.device)
            if eng is None:
                raise RuntimeError(
                    "the checkpoint was taken on the log tier, which does "
                    "not take this assigner and aggregate")
            return eng
        eng = None
        if self.mesh is not None and np.issubdtype(key_dtype, np.integer):
            from flink_tpu_torch.parallel.mesh_log import \
                mesh_log_engine_for_assigner
            from flink_tpu_torch.streaming.device_window_operator import \
                resolve_mesh
            self.mesh = resolve_mesh(self.mesh)
            eng = mesh_log_engine_for_assigner(
                self.assigner, self.agg, self.mesh, axis=self.mesh_axis,
                max_parallelism=self.max_parallelism)
            if eng is not None:
                return eng
        if key_dtype.kind in "US":
            eng = self._string_engine()
            if eng is not None:
                return eng
        if np.issubdtype(key_dtype, np.integer):
            eng = log_engine_for_assigner(self.assigner, self.agg, self.device)
        if eng is None:
            eng = engine_for_assigner(self.assigner, self.agg,
                                      self.initial_capacity, self.device)
        if eng is None:
            raise ValueError(f"no engine for assigner {self.assigner!r}")
        return eng

    def _string_engine(self):
        """The fused intern + sum engine for a string key column (a
        tumbling float Sum), or None."""
        from flink_tpu_torch.streaming.device_window_operator import \
            string_sum_engine_for_assigner
        return string_sum_engine_for_assigner(self.assigner, self.agg,
                                              self.device)

    def open(self):
        pass  # the engine is built at the first batch (it needs the key dtype)

    def set_key_context(self, record):
        pass

    # ---- input --------------------------------------------------------
    def process_element(self, record: StreamRecord):
        batch = record.value
        if isinstance(batch, tuple):
            # a (target, sub-batch) carrier of the split exchange
            batch = batch[1]
        if len(batch) == 0:
            return
        keys = batch.cols[self.key_col]
        if self.engine is None:
            self.engine = self._make_engine(np.asarray(keys).dtype)
            if hasattr(self.engine, "fired"):
                self.engine.emit_arrays = True
            # rows behind the operator's watermark count as late
            if self.current_watermark > MIN_TIMESTAMP:
                self.engine.advance_watermark(self.current_watermark)
        values = None
        value_hashes = None
        if self.input_col is not None:
            col = batch.cols[self.input_col]
            if self.agg.needs_value_hash:
                value_hashes = hash_keys_np(np.asarray(col))
            if self.agg.needs_value:
                values = np.asarray(col)
        self.engine.process_batch(keys, batch.ts, values,
                                  value_hashes=value_hashes)

    def process_watermark(self, watermark: Watermark):
        if self.engine is not None:
            getattr(self.engine, "flush", lambda: None)()
            self.engine.advance_watermark(watermark.timestamp)
            if getattr(self.engine, "emit_arrays", False):
                self._emit_fired()
            else:
                self._emit_rows()
            self.num_late_records_dropped = self.engine.num_late_dropped
        self.current_watermark = watermark.timestamp
        self.output.emit_watermark(watermark)

    def _columns(self, keys, results, starts, ends) -> dict:
        by_kind = {"key": keys, "agg": results, "wstart": starts, "wend": ends}
        return {name: by_kind[kind] for name, kind in self.out_fields}

    def _emit_rows(self):
        """Engines that emit rows (``VectorizedSessionWindows``): their
        ``emitted`` tuples as one batch."""
        emitted = self.engine.emitted
        if not emitted:
            return
        keys_np = np.asarray([e[0] for e in emitted])
        results = np.asarray([e[1] for e in emitted])
        starts = np.asarray([e[2] for e in emitted], np.int64)
        ends = np.asarray([e[3] for e in emitted], np.int64)
        del emitted[:]
        out = RecordBatch(self._columns(keys_np, results, starts, ends),
                          ends - 1)
        self.output.collect(StreamRecord(out, timestamp=int(ends.max()) - 1))

    def _emit_fired(self):
        fired = self.engine.fired
        for keys_np, results, start, end in fired:
            if isinstance(start, np.ndarray):
                # session engines fire (keys, totals, starts, ends)
                starts, ends = start, end
                out_ts = int(ends.max()) - 1 if len(ends) else 0
            else:
                starts = np.full(len(keys_np), start, np.int64)
                ends = np.full(len(keys_np), end, np.int64)
                out_ts = end - 1
            out = RecordBatch(self._columns(keys_np, results, starts, ends),
                              ends - 1)
            self.output.collect(StreamRecord(out, timestamp=out_ts))
        del fired[:]

    # ---- checkpoint ---------------------------------------------------
    def _tier(self) -> str:
        from flink_tpu_torch.parallel.mesh_log import _MeshShardedLogEngine
        if isinstance(self.engine, lw.StringSumTumblingWindows):
            return "string_sum"
        if isinstance(self.engine, _MeshShardedLogEngine):
            return "mesh_log"
        if isinstance(self.engine, (lw.LogStructuredTumblingWindows,
                                    lw.LogStructuredSessionWindows)):
            return "log"
        return "vectorized"

    def snapshot_state(self, checkpoint_id: Optional[int] = None) -> dict:
        snap = super().snapshot_state(checkpoint_id)
        if self.engine is not None:
            snap["columnar_engine"] = self.engine.snapshot()
            snap["columnar_tier"] = self._tier()
        return snap

    def _build_engine_for_tier(self, tier):
        if tier == "string_sum":
            eng = self._string_engine()
            if eng is None:
                raise RuntimeError(
                    "the checkpoint was taken on the fused string-sum "
                    "tier, which does not take this assigner and aggregate")
            return eng
        if tier == "mesh_log":
            from flink_tpu_torch.parallel.mesh_log import \
                mesh_log_engine_for_assigner
            from flink_tpu_torch.streaming.device_window_operator import \
                resolve_mesh
            self.mesh = resolve_mesh(self.mesh)
            if self.mesh is None:
                raise RuntimeError(
                    "the checkpoint was taken on the mesh log tier; "
                    "restoring needs a mesh (env.set_mesh)")
            eng = mesh_log_engine_for_assigner(
                self.assigner, self.agg, self.mesh, axis=self.mesh_axis,
                max_parallelism=self.max_parallelism)
            if eng is None:
                raise RuntimeError(
                    "the checkpoint was taken on the mesh log tier, which "
                    "does not take this assigner and aggregate")
            return eng
        is_log = tier == "log"
        key_dtype = np.dtype(np.uint64) if is_log else np.dtype(object)
        return self._make_engine(key_dtype, require_log=is_log)

    def restore_state(self, snapshots) -> None:
        super().restore_state(snapshots)
        engine_snaps = [s for s in snapshots if "columnar_engine" in s]
        if not engine_snaps:
            return
        tiers = {s.get("columnar_tier") for s in engine_snaps}
        if len(tiers) > 1:
            raise ValueError(
                f"snapshots span engine tiers {sorted(tiers)}; cannot "
                "merge across tiers")
        tier = tiers.pop()
        rescaled = any(
            s.get("restore_old_parallelism", self.num_subtasks)
            != self.num_subtasks for s in engine_snaps)
        if self.engine is None:
            self.engine = self._build_engine_for_tier(tier)
            if hasattr(self.engine, "fired"):
                self.engine.emit_arrays = True
        if not rescaled and len(engine_snaps) == 1:
            self.engine.restore(engine_snaps[0]["columnar_engine"])
            return
        # another parallelism: merge the old subtasks' engines, keeping
        # the key groups this subtask owns
        if not hasattr(self.engine, "restore_many"):
            raise ValueError(
                f"the {tier!r} engine tier cannot re-split its state "
                "across a parallelism change; restore at the "
                "checkpointed parallelism")
        self.engine.restore_many(
            [s["columnar_engine"] for s in engine_snaps],
            keep_fn=make_key_group_keep_fn(self.max_parallelism,
                                           self.num_subtasks,
                                           self.subtask_index))


class BatchKeyGroupSplitOperator(StreamOperator):
    """The keyBy exchange of batch values at parallelism > 1: one hash
    pass over the key column, the key-group arithmetic of the keyBy edge
    (``native.key_groups``), and one (target, sub-batch) carrier per
    target subtask, which ``partition_custom`` routes by its tag."""

    def __init__(self, key_col: str, max_parallelism: int, n_out: int):
        super().__init__()
        if n_out < 2:
            raise ValueError("the split exchange exists only for "
                             "parallelism > 1")
        self.key_col = key_col
        self.max_parallelism = max_parallelism
        self.n_out = n_out

    def set_key_context(self, record):
        pass

    def process_element(self, record: StreamRecord):
        batch: RecordBatch = record.value
        if len(batch) == 0:
            return
        kh = hash_keys_np(np.asarray(batch.cols[self.key_col]))
        targets = native.key_groups(kh, self.max_parallelism, self.n_out)
        ts = (np.asarray(batch.ts, np.int64) if batch.ts is not None
              else None)
        for t in range(self.n_out):
            m = targets == t
            if not m.any():
                continue
            sub = RecordBatch({k: np.asarray(v)[m]
                               for k, v in batch.cols.items()},
                              None if ts is None else ts[m])
            self.output.collect(StreamRecord((int(t), sub), record.timestamp))


class ColumnarIntervalJoinOperator(StreamOperator):
    """Interval join of two batch streams: the values are (tag, batch)
    carriers of a tagged union (0 left, 1 right).  Pairs have equal keys
    and r.ts - l.ts in [lower, upper]; each leaves with the later of its
    two times, in one output batch per input batch.

    Each side's rows go to append-only column storage and into the host
    runtime's interval join core (``native.NativeIntervalJoin``), which
    returns the pairs as global row ids; the operator gathers the output
    columns by those ids.  Integer keys of one signedness hash
    bijectively (splitmix64), so their pairs need no check; other keys
    are compared for equality after the hash join.  Watermarks prune
    the core (left rows die once wm >= ts + upper, right rows once
    wm >= ts - lower).  Parallelism 1."""

    def __init__(self, key_l: str, key_r: str, lower_ms: int,
                 upper_ms: int, out_fields_l, out_fields_r):
        super().__init__()
        self.key_l = key_l
        self.key_r = key_r
        self.lower = lower_ms
        self.upper = upper_ms
        #: [(out_name, src_col)] per side
        self.out_l = list(out_fields_l)
        self.out_r = list(out_fields_r)
        self.current_watermark = MIN_TIMESTAMP
        self._native = native.NativeIntervalJoin(lower_ms, upper_ms)
        self._store = [self._new_store(), self._new_store()]

    @staticmethod
    def _new_store():
        return {"cols": {}, "ts": None, "kh": None, "n": 0, "cap": 0}

    def _store_append(self, side: int, batch: RecordBatch, kh: np.ndarray):
        st = self._store[side]
        n_new = len(batch)
        need = st["n"] + n_new
        if need > st["cap"]:
            cap = max(1 << 16, 1 << int(need - 1).bit_length())
            for name in batch.cols:
                old = st["cols"].get(name)
                arr = np.empty(cap, np.asarray(batch.cols[name]).dtype)
                if old is not None:
                    arr[:st["n"]] = old[:st["n"]]
                st["cols"][name] = arr
            for key in ("ts", "kh"):
                old = st[key]
                arr = np.empty(cap, np.int64 if key == "ts" else np.uint64)
                if old is not None:
                    arr[:st["n"]] = old[:st["n"]]
                st[key] = arr
            st["cap"] = cap
        for name, col in batch.cols.items():
            st["cols"][name][st["n"]:need] = np.asarray(col)
        st["ts"][st["n"]:need] = np.asarray(batch.ts, np.int64)
        st["kh"][st["n"]:need] = kh
        st["n"] = need

    def set_key_context(self, record):
        pass

    def process_element(self, record: StreamRecord):
        tag, batch = record.value
        if len(batch) == 0:
            return
        key_col = self.key_l if tag == 0 else self.key_r
        kh = hash_keys_np(np.asarray(batch.cols[key_col]))
        self._store_append(tag, batch, kh)
        lrows, rrows = self._native.push(tag, kh,
                                         np.asarray(batch.ts, np.int64))
        if not len(lrows):
            return
        sl, sr = self._store[0], self._store[1]
        lkd = sl["cols"][self.key_l].dtype
        rkd = sr["cols"][self.key_r].dtype
        if not (lkd.kind == rkd.kind and lkd.kind in "iu"):
            # strings and composites hash lossily: exact equality
            eq = (sl["cols"][self.key_l][lrows]
                  == sr["cols"][self.key_r][rrows])
            if not eq.all():
                lrows, rrows = lrows[eq], rrows[eq]
                if not len(lrows):
                    return
        l_cols = {n: sl["cols"][c][lrows] for n, c in self.out_l}
        r_cols = {n: sr["cols"][c][rrows] for n, c in self.out_r}
        out_ts = np.maximum(sl["ts"][lrows], sr["ts"][rrows])
        out = RecordBatch({**l_cols, **r_cols}, out_ts)
        self.output.collect(StreamRecord(out, timestamp=int(out_ts.max())))

    def process_watermark(self, watermark: Watermark):
        self.current_watermark = watermark.timestamp
        self._native.prune(watermark.timestamp)
        self.output.emit_watermark(watermark)

    # ---- checkpoint: the stored rows are the operator's state ---------
    def snapshot_state(self, checkpoint_id=None) -> dict:
        snap = super().snapshot_state(checkpoint_id)
        snap["iv_join_store"] = [
            {"cols": {k: v[:s["n"]].copy() for k, v in s["cols"].items()},
             "ts": (s["ts"][:s["n"]].copy() if s["ts"] is not None
                    else np.empty(0, np.int64)),
             "kh": (s["kh"][:s["n"]].copy() if s["kh"] is not None
                    else np.empty(0, np.uint64))}
            for s in self._store]
        snap["iv_join_watermark"] = self.current_watermark
        return snap

    def restore_state(self, snapshots) -> None:
        """Replays each side's stored rows into a fresh core, left
        first: the pairs the replay finds were all emitted before the
        checkpoint and are dropped.  A snapshot of the JAX package's
        numpy buffers (``iv_join_buffers``, taken where its native
        runtime was missing) replays the same way."""
        super().restore_state(snapshots)
        for s in snapshots:
            sides = s.get("iv_join_store")
            if sides is None:
                buffers = s.get("iv_join_buffers")
                if buffers is None:
                    continue
                sides = [b if b is not None else
                         {"cols": {}, "ts": np.empty(0, np.int64),
                          "kh": np.empty(0, np.uint64)} for b in buffers]
            self._native = native.NativeIntervalJoin(self.lower, self.upper)
            self._store = [self._new_store(), self._new_store()]
            for side, st in enumerate(sides):
                ts = np.asarray(st["ts"], np.int64)
                kh = np.asarray(st["kh"], np.uint64)
                if len(ts):
                    self._store_append(side, RecordBatch(dict(st["cols"]), ts),
                                       kh)
                    self._native.push(side, kh, ts)
            wm = s.get("iv_join_watermark")
            if wm is not None and wm > MIN_TIMESTAMP:
                self.current_watermark = wm
                self._native.prune(wm)
