"""DeviceWindowOperator: the device window engines inside the job graph
(port of ``flink_tpu/streaming/device_window_operator.py:46-417``).

Records buffer on the host; every ``flush_batch`` records (and every
watermark that crosses a window-end boundary) flushes one vectorized
``process_batch`` into the engine, and watermarks fire windows whose
results leave through the standard output with the scalar operator's
timestamp contract (window.max_timestamp).

The engine is chosen at the first flush, by key type, as the JAX
package chooses it (``_ensure_engine``):

- 1-D string keys with a float Sum over tumbling windows (offset 0) go
  to ``StringSumTumblingWindows`` (interning and summing in one C++
  pass);
- other 1-D string keys are interned to dense uint64 ids
  (``NativeStringInterner``) and take the integer route; emission maps
  the ids back to the strings;
- 1-D integer keys go to the log-structured tier
  (``log_engine_for_assigner``) when the aggregate has a cell
  decomposition and the assigner fits (``log_windows.py``).  Integer
  tuple keys (a 2-D key array) stay off it: the log tier takes one
  integer column.  (The JAX package sends them there, and merges keys
  that share their first column);
- everything else (object and composite keys, Count, Min, Max, Avg,
  Count-Min outside sessions, HLL above precision 16, and every
  aggregate but Count-Min on sessions) goes to the device-resident
  scatter tier (``engine_for_assigner``).

With a mesh (``mesh=``, or ``env.set_mesh``) the sharded twins take
over, as in the reference: 1-D integer keys (interned strings included)
go to the mesh log tier (``parallel/mesh_log.py``) where its cell
decomposition fits, everything else to the sharded scatter engines
(``MeshTumblingWindows`` / ``MeshSlidingWindows``; sessions stay on the
single-device engine).  The fused string sum is off on a mesh.

Only the reference's semantic refusals (``TypeError`` for an aggregate
without a cell decomposition, ``ValueError`` for its parameters) send a
job from the log tier to the scatter tier; a failed build of the host
runtime raises.

``snapshot_state`` flushes the buffer and copies the engine's state to
the host in the JAX engines' format, tagged with its tier
(``vectorized``, ``log``, ``string_sum``, ``mesh_log``), with the
string-key directory when keys are interned (ids are dense in
first-seen order, so re-interning the directory rebuilds them).
``restore_state`` builds the tier's engine and restores it; at another
parallelism the log, string-sum and generic engines re-split their
state through ``restore_many`` and the key-group filter the keyBy
routes by, and a string-keyed or a non-splittable tier raises, as the
JAX package does.
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np

from flink_tpu_torch.core.keygroups import make_key_group_keep_fn
from flink_tpu_torch.device import DeviceLike, resolve_device
from flink_tpu_torch.native import NativeStringInterner
from flink_tpu_torch.ops.device_agg import DeviceAggregateFunction, SumAggregate
from flink_tpu_torch.runtime.tracing import get_tracer
from flink_tpu_torch.streaming import log_windows as lw
from flink_tpu_torch.streaming.elements import MAX_TIMESTAMP, StreamRecord, Watermark
from flink_tpu_torch.streaming.operators import StreamOperator, TimestampedCollector
from flink_tpu_torch.streaming.vectorized import (VectorizedSlidingWindows,
                                                  VectorizedTumblingWindows)
from flink_tpu_torch.streaming.vectorized_sessions import \
    VectorizedSessionWindows
from flink_tpu_torch.streaming.windowing import (EventTimeSessionWindows,
                                                 SlidingEventTimeWindows,
                                                 TimeWindow,
                                                 TumblingEventTimeWindows)


def assigner_supported(assigner) -> bool:
    """The assigners the device engines cover: tumbling and sliding
    (size a multiple of the slide) at offset 0, and sessions."""
    if isinstance(assigner, TumblingEventTimeWindows):
        return assigner.offset == 0
    if isinstance(assigner, SlidingEventTimeWindows):
        return assigner.offset == 0 and assigner.size % assigner.slide == 0
    return isinstance(assigner, EventTimeSessionWindows)


def _string_sum_fits(assigner, agg: DeviceAggregateFunction) -> bool:
    """A float Sum over tumbling windows at offset 0: the fused C++
    intern + sum engine's shape (it sums in double, so integer value
    dtypes stay on the exact tiers)."""
    return (isinstance(agg, SumAggregate)
            and np.issubdtype(agg.value_dtype, np.floating)
            and isinstance(assigner, TumblingEventTimeWindows)
            and assigner.offset == 0)


def string_sum_engine_for_assigner(assigner, agg: DeviceAggregateFunction,
                                   device: DeviceLike = None):
    """The fused intern + sum engine for string-keyed tumbling float
    sums, or None when the shape does not fit."""
    if _string_sum_fits(assigner, agg):
        return lw.StringSumTumblingWindows(agg, assigner.size, device=device)
    return None


def log_engine_for_assigner(assigner, agg: DeviceAggregateFunction,
                            device: DeviceLike = None):
    """The log-structured combiner tier for this assigner and aggregate,
    or None when the cell decomposition or the assigner's parameters do
    not fit (integer keys; HLL <= p16, Sum and quantile cells on
    tumbling and sliding windows, Count-Min on sessions)."""
    try:
        if isinstance(assigner, TumblingEventTimeWindows) \
                and assigner.offset == 0:
            return lw.LogStructuredTumblingWindows(agg, assigner.size,
                                                   device=device)
        if (isinstance(assigner, SlidingEventTimeWindows)
                and assigner.offset == 0
                and assigner.size % assigner.slide == 0):
            return lw.LogStructuredSlidingWindows(agg, assigner.size,
                                                  assigner.slide,
                                                  device=device)
        if isinstance(assigner, EventTimeSessionWindows):
            return lw.LogStructuredSessionWindows(agg, assigner.gap,
                                                  device=device)
    except (TypeError, ValueError):
        pass  # no cell decomposition, or parameters the tier refuses
    return None


def engine_for_assigner(assigner, agg: DeviceAggregateFunction,
                        initial_capacity: int = 1 << 14,
                        device: DeviceLike = None, mesh=None,
                        mesh_axis: str = "kg", max_parallelism: int = 128):
    """Assigner → scatter-tier engine, or None when no engine applies.
    With a mesh, tumbling and sliding windows run on the sharded engines
    (``parallel/mesh_windows.py``); sessions stay on one device."""
    if not assigner_supported(assigner):
        return None
    if mesh is not None and not isinstance(assigner, EventTimeSessionWindows):
        from flink_tpu_torch.parallel.mesh_windows import (MeshSlidingWindows,
                                                           MeshTumblingWindows)
        per_shard = max(1 << 8, initial_capacity // mesh.shape[mesh_axis])
        if isinstance(assigner, TumblingEventTimeWindows):
            return MeshTumblingWindows(
                agg, assigner.size, mesh, axis=mesh_axis,
                max_parallelism=max_parallelism,
                capacity_per_window_shard=per_shard)
        return MeshSlidingWindows(
            agg, assigner.size, assigner.slide, mesh, axis=mesh_axis,
            max_parallelism=max_parallelism,
            capacity_per_window_shard=per_shard)
    if isinstance(assigner, TumblingEventTimeWindows):
        return VectorizedTumblingWindows(agg, assigner.size,
                                         initial_capacity=initial_capacity,
                                         device=device)
    if isinstance(assigner, SlidingEventTimeWindows):
        return VectorizedSlidingWindows(agg, assigner.size, assigner.slide,
                                        initial_capacity=initial_capacity,
                                        device=device)
    return VectorizedSessionWindows(agg, assigner.gap,
                                    initial_capacity=initial_capacity,
                                    device=device)


def is_mesh_factory(mesh) -> bool:
    """True for a callable that builds a mesh (one per subtask) rather
    than a Mesh: factories have no ``shape``."""
    return callable(mesh) and not hasattr(mesh, "shape")


def resolve_mesh(mesh):
    """Mesh | mesh factory | None -> Mesh | None (a factory resolves in
    the subtask that runs it)."""
    return mesh() if is_mesh_factory(mesh) else mesh


def batch_window_eligible(assigner, trigger, evictor, allowed_lateness,
                          late_tag, window_function) -> bool:
    """The window shapes both batch tiers take, the device engines and
    the generic tier: an assigner they cover (``assigner_supported``)
    with the default trigger, no evictor, lateness 0, no late-data tag
    and a callable window function (or none)."""
    if trigger is not None or evictor is not None:
        return False
    if allowed_lateness != 0 or late_tag is not None:
        return False
    if window_function is not None and not callable(window_function):
        return False
    return assigner_supported(assigner)


def is_device_eligible(assigner, aggregate_function, trigger, evictor,
                       allowed_lateness, late_tag, window_function) -> bool:
    """The graph builder's gate for the device engines: a
    DeviceAggregateFunction on a shape ``batch_window_eligible`` takes."""
    return (isinstance(aggregate_function, DeviceAggregateFunction)
            and batch_window_eligible(assigner, trigger, evictor,
                                      allowed_lateness, late_tag,
                                      window_function))


class DeviceWindowOperator(StreamOperator):
    """Batched, device-backed window operator for the eligible aggregate
    path.  The key selector is applied per record at buffer time (the
    operator is its own keyed state)."""

    def __init__(self, assigner, aggregate_function: DeviceAggregateFunction,
                 window_function=None, flush_batch: int = 8192,
                 initial_capacity: int = 1 << 14, device: DeviceLike = None,
                 mesh=None, mesh_axis: str = "kg"):
        super().__init__()
        self.assigner = assigner
        self.agg = aggregate_function
        self.window_function = window_function
        self.flush_batch = flush_batch
        self.initial_capacity = initial_capacity
        self.device = resolve_device(device)
        #: a Mesh, a mesh factory (resolved at the first flush) or None
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        self.engine = None
        self._keys: List[Any] = []
        self._ts: List[int] = []
        self._values: List[Any] = []
        self._last_fireable = None
        self.num_late_records_dropped = 0
        # 1-D string keys become dense uint64 ids in one C++ pass per
        # batch, so they ride the integer-keyed tiers; emission maps the
        # ids back through _id_to_key
        self._interner = None
        self._id_to_key: List[Any] = []

    # ---- lifecycle --------------------------------------------------
    def open(self):
        if not assigner_supported(self.assigner):
            raise ValueError(
                f"no device engine for assigner {self.assigner!r}")
        self.collector = TimestampedCollector(self.output)
        # the WindowOperator's late counter and fire histogram, reset
        # for this attempt
        self._emit_batch_hist = None
        if self.metrics is not None:
            self.metrics.counter("numLateRecordsDropped").count = 0
            self._emit_batch_hist = self.metrics.histogram("emitBatchSize")

    # ---- input ------------------------------------------------------
    def process_element(self, record: StreamRecord):
        if record.timestamp is None:
            raise ValueError(
                "device window operator requires event-time records "
                "(assign timestamps upstream)")
        self._keys.append(self.key_selector.get_key(record.value)
                          if self.key_selector is not None else record.value)
        self._ts.append(record.timestamp)
        self._values.append(record.value)
        if len(self._keys) >= self.flush_batch:
            self._flush_buffer()

    def _wants_fused_string_sum(self) -> bool:
        if self.engine is not None:
            # locked at the first flush: later batches keep feeding the
            # fused engine raw strings
            return isinstance(self.engine, lw.StringSumTumblingWindows)
        return self.mesh is None and _string_sum_fits(self.assigner, self.agg)

    def _ensure_engine(self, keys_arr: np.ndarray):
        """Tier choice at the first flush (see the module docstring)."""
        if self.engine is not None:
            return
        self.mesh = resolve_mesh(self.mesh)
        if self.mesh is not None:
            if keys_arr.ndim == 1 and np.issubdtype(keys_arr.dtype, np.integer):
                from flink_tpu_torch.parallel.mesh_log import \
                    mesh_log_engine_for_assigner
                self.engine = mesh_log_engine_for_assigner(
                    self.assigner, self.agg, self.mesh, axis=self.mesh_axis,
                    max_parallelism=self.max_parallelism)
            if self.engine is None:
                self.engine = engine_for_assigner(
                    self.assigner, self.agg, self.initial_capacity,
                    self.device, mesh=self.mesh, mesh_axis=self.mesh_axis,
                    max_parallelism=self.max_parallelism)
        if self.engine is None and keys_arr.dtype.kind in "US" \
                and keys_arr.ndim == 1 and self._wants_fused_string_sum():
            self.engine = string_sum_engine_for_assigner(
                self.assigner, self.agg, self.device)
        if self.engine is None and keys_arr.ndim == 1 \
                and np.issubdtype(keys_arr.dtype, np.integer):
            self.engine = log_engine_for_assigner(self.assigner, self.agg,
                                                  self.device)
        if self.engine is None:
            self.engine = engine_for_assigner(self.assigner, self.agg,
                                              self.initial_capacity,
                                              self.device)
        # fast-forward a lazily created engine to the operator's
        # watermark: records behind it count as late
        if self.current_watermark > -(2 ** 63):
            self.engine.advance_watermark(self.current_watermark)

    def _flush_buffer(self):
        if not self._keys:
            return
        tracer = get_tracer()
        if tracer.enabled:
            with tracer.span("device_window.flush", batch=len(self._keys)):
                self._flush_buffer_inner()
        else:
            self._flush_buffer_inner()

    def _flush_buffer_inner(self):
        agg = self.agg
        extract = agg.extract_value
        # overridden on the class or per instance (a plain function set
        # on the instance has no __func__)
        if getattr(extract, "__func__",
                   None) is not DeviceAggregateFunction.extract_value:
            values = [extract(v) for v in self._values]
        else:
            values = self._values
        vals = np.asarray(values) if (agg.needs_value
                                      or agg.needs_value_hash) else None
        keys_arr = self._maybe_intern(np.asarray(self._keys))
        self._ensure_engine(keys_arr)
        self.engine.process_batch(keys_arr, np.asarray(self._ts, np.int64),
                                  vals)
        self._keys.clear()
        self._ts.clear()
        self._values.clear()

    def _maybe_intern(self, keys_arr: np.ndarray) -> np.ndarray:
        """Dictionary-encode 1-D string keys to dense uint64 ids (the
        first batch decides; later batches coerce to the locked
        representation).  The fused string-sum engine takes the raw
        strings itself."""
        if self._interner is None:
            # 1-D only: composite keys coerce to 2-D string arrays whose
            # rows must stay tuples on emission
            if keys_arr.dtype.kind not in "US" or keys_arr.ndim != 1:
                return keys_arr
            if self._wants_fused_string_sum():
                return keys_arr
            self._interner = NativeStringInterner()
        elif keys_arr.dtype.kind not in "US":
            keys_arr = keys_arr.astype(np.str_)
        ids, first_idx = self._interner.intern(keys_arr)
        if len(first_idx):
            self._id_to_key.extend(keys_arr[first_idx].tolist())
        return ids

    def process_watermark(self, watermark: Watermark):
        # fires happen only when the watermark crosses a window-end
        # boundary (multiples of the size or slide; sessions may fire at
        # any time); between boundaries the watermark forwards without
        # touching the engine, so a per-element watermark costs no
        # device work
        wm = watermark.timestamp
        grid = self._fire_grid()
        if grid is not None and wm != MAX_TIMESTAMP:
            fireable = ((wm + 1) // grid) * grid if wm >= 0 else None
            if fireable is not None and fireable == self._last_fireable:
                self.current_watermark = wm
                self.output.emit_watermark(watermark)
                return
            self._last_fireable = fireable
        self._flush_buffer()
        if self.engine is not None:
            before = len(self.engine.emitted)
            tracer = get_tracer()
            if tracer.enabled:
                with tracer.span("device_window.fire", watermark=wm):
                    self.engine.advance_watermark(wm)
                    self._emit_from(before)
            else:
                self.engine.advance_watermark(wm)
                self._emit_from(before)
            self.num_late_records_dropped = self.engine.num_late_dropped
            if self.metrics is not None:
                self.metrics.counter("numLateRecordsDropped").count = \
                    self.engine.num_late_dropped
        self.current_watermark = wm
        self.output.emit_watermark(watermark)

    def _fire_grid(self):
        """Window-end alignment grid of the assigner, or None when fires
        can happen at any time (sessions)."""
        if isinstance(self.assigner, SlidingEventTimeWindows):
            return self.assigner.slide
        if isinstance(self.assigner, TumblingEventTimeWindows):
            return self.assigner.size
        return None

    def _emit_from(self, start_idx: int):
        emitted = self.engine.emitted
        if self._emit_batch_hist is not None and len(emitted) > start_idx:
            self._emit_batch_hist.update(len(emitted) - start_idx)
        fn = self.window_function
        id_to_key = self._id_to_key if self._interner is not None else None
        for key, result, w_start, w_end in emitted[start_idx:]:
            self.collector.set_absolute_timestamp(w_end - 1)
            if fn is None:
                self.collector.collect(result)
            else:
                if id_to_key is not None:
                    key = id_to_key[int(key)]
                out = fn(key, TimeWindow(w_start, w_end), [result])
                if out is not None:
                    for v in out:
                        self.collector.collect(v)
        # delivered results leave the buffer
        del emitted[start_idx:]

    # ---- checkpoint -------------------------------------------------
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
        self._flush_buffer()
        snap = super().snapshot_state(checkpoint_id)
        if self.engine is not None:
            snap["device_engine"] = self.engine.snapshot()
            snap["device_tier"] = self._tier()
        if self._interner is not None:
            snap["string_key_directory"] = list(self._id_to_key)
        return snap

    def restore_state(self, snapshots) -> None:
        super().restore_state(snapshots)
        engine_snaps = [s for s in snapshots if "device_engine" in s]
        rescaled = any(s.get("restore_old_parallelism", self.num_subtasks)
                       != self.num_subtasks for s in snapshots)
        if rescaled or len(engine_snaps) > 1:
            self._restore_resplit(snapshots, engine_snaps)
            return
        for s in snapshots:
            directory = s.get("string_key_directory")
            if directory is not None:
                self._interner = NativeStringInterner(max(16, 2 * len(directory)))
                self._id_to_key = list(directory)
                if directory:
                    ids, _ = self._interner.intern(np.asarray(directory))
                    if int(ids[-1]) != len(directory) - 1:
                        raise RuntimeError("string-key directory did not "
                                           "re-intern to its own ids")
            if "device_engine" in s:
                if self.engine is None:
                    self.engine = self._engine_for_tier(s.get("device_tier"))
                self.engine.restore(s["device_engine"])

    def _engine_for_tier(self, tier):
        """An empty engine of the tier a snapshot was taken on."""
        if tier == "string_sum":
            return lw.StringSumTumblingWindows(self.agg, self.assigner.size,
                                               device=self.device)
        if tier == "log":
            engine = log_engine_for_assigner(self.assigner, self.agg,
                                             self.device)
            if engine is None:
                raise RuntimeError("the checkpoint was taken on the log "
                                   "tier, which does not take this "
                                   "assigner and aggregate")
            return engine
        if tier == "mesh_log":
            from flink_tpu_torch.parallel.mesh_log import \
                mesh_log_engine_for_assigner
            self.mesh = resolve_mesh(self.mesh)
            if self.mesh is None:
                raise RuntimeError("the checkpoint was taken on the mesh "
                                   "log tier; restoring needs a mesh "
                                   "(env.set_mesh)")
            engine = mesh_log_engine_for_assigner(
                self.assigner, self.agg, self.mesh, axis=self.mesh_axis,
                max_parallelism=self.max_parallelism)
            if engine is None:
                raise RuntimeError("the checkpoint was taken on the mesh "
                                   "log tier, which does not take this "
                                   "assigner and aggregate")
            return engine
        self.mesh = resolve_mesh(self.mesh)
        return engine_for_assigner(self.assigner, self.agg,
                                   self.initial_capacity, self.device,
                                   mesh=self.mesh, mesh_axis=self.mesh_axis,
                                   max_parallelism=self.max_parallelism)

    def _restore_resplit(self, snapshots, engine_snaps) -> None:
        """A rescaled restore (or several snapshots into one subtask):
        the engine keeps the keys whose key group routes here."""
        if any(s.get("string_key_directory") is not None for s in snapshots):
            raise ValueError(
                "device window operator cannot re-split "
                "dictionary-encoded string-keyed engine state "
                "across a parallelism change; restore at the "
                "checkpointed parallelism")
        tiers = {s.get("device_tier") for s in engine_snaps}
        if len(tiers) > 1:
            raise ValueError(f"snapshots span engine tiers {sorted(tiers)}")
        if not engine_snaps:
            return
        tier = tiers.pop()
        if self.engine is None and tier in ("log", "string_sum"):
            self.engine = self._engine_for_tier(tier)
        if self.engine is None or not hasattr(self.engine, "restore_many"):
            raise ValueError(
                f"the {tier!r} engine tier cannot re-split "
                "its state across a parallelism change; "
                "restore at the checkpointed parallelism")
        self.engine.restore_many(
            [s["device_engine"] for s in engine_snaps],
            keep_fn=make_key_group_keep_fn(self.max_parallelism,
                                           self.num_subtasks,
                                           self.subtask_index))

