"""Operator lifecycle and the operators the port runs (port of
``flink_tpu/streaming/operators.py``).

setup → open → process* → finish → close.  ``setup`` takes the
operator's keyed backend and processing-time service and builds its
``InternalTimerService``; ``process_watermark`` advances the timers,
``set_key_context`` sets the backend's current key, and
``snapshot_state`` / ``restore_state`` carry keyed state, operator
state (``state/operator_state.py``: list and broadcast states; several
snapshots restore as one, merged by ``redistribute``) and timers, and,
for a user function that defines ``snapshot_function_state`` /
``restore_function_state``, its own state, such as a source's read
position.  ``notify_checkpoint_complete`` reaches user functions that
define it.  A user function with ``initialize_state(operator)`` gets
its hosting operator at open, and with it the operator state backend;
a rich function's ``RuntimeContext`` carries it as
``operator_state_store``.  The executor opens operators before it
restores them, so such a function reads its operator state lazily.

``ProcessOperator`` and ``KeyedProcessOperator`` host a
``ProcessFunction``: its context gives the record's timestamp, the
watermark, side outputs and, keyed, the current key, keyed state in
the void namespace (from the configured backend: on ``gpu`` an
``AggregatingState`` of a device aggregate is the backend's device
state) and event- and processing-time timers on the operator's timer
service.  ``StreamGroupedReduce`` is the rolling keyed reduce.  A rich
function's ``RuntimeContext`` reaches keyed state through a
``KeyedStateStore``.

Two-input operators (``TwoInputStreamOperator``) take
``process_element1`` / ``2`` and one watermark per input, their own the
minimum: ``CoStreamMap``, ``CoStreamFlatMap``, ``CoProcessOperator``
(keyed: the second input keys by ``key_selector2``) and
``CoBroadcastOperator``, whose broadcast state lives on the operator
state backend, read-only on the data side.  ``AsyncWaitOperator`` runs
an ``AsyncFunction`` on a thread pool with at most ``capacity``
requests in flight, ordered or unordered; a watermark, a snapshot and
the end of input wait until the requests ahead of them are out.

``StreamMap`` and ``StreamFilter`` run a UDF that the liftability
analyzer proves LIFTABLE on whole numpy columns of a RecordBatch; the
first batch is probed against the scalar UDF on its edge rows, and any
exception, wrong shape or probe mismatch locks the operator onto the
boxed per-record path.  When the type-flow prover proved the kernel's
whole dtype flow ahead of time (``analysis/typeflow.py``'s
``apply_static`` stamps ``_static_kernel``), the probe is skipped and
``columnar_decided_by`` records ``"static"``; the emit-side shape check
stays armed.  ``KERNEL_STATS`` counts probes and static skips.  The
device window operator is its own keyed state.
"""

from __future__ import annotations

import abc
import copy
import logging
import threading
import time as _time
from typing import List, Optional

import numpy as np

from flink_tpu_torch.core.functions import (KeySelector, ReduceFunction,
                                            RichFunction, RuntimeContext)
from flink_tpu_torch.core.state import ReducingStateDescriptor, StateDescriptor
from flink_tpu_torch.state.backend import VOID_NAMESPACE
from flink_tpu_torch.state.operator_state import (OperatorStateBackend,
                                                  OperatorStateSnapshot)
from flink_tpu_torch.streaming.elements import (MAX_TIMESTAMP, MIN_TIMESTAMP,
                                                RecordBatch, StreamRecord,
                                                Watermark)
from flink_tpu_torch.streaming.timers import (InternalTimerService,
                                              ProcessingTimeService)

log = logging.getLogger(__name__)


class _KernelStats:
    """Process-wide first-batch probe accounting of the map/filter
    column kernels (the per-operator path only: a fused chain program
    verifies with its numpy twin, ``chain_fusion.FUSION_STATS``)."""

    __slots__ = ("probes", "static_skips")

    def __init__(self):
        self.reset()

    def reset(self):
        self.probes = 0
        self.static_skips = 0


KERNEL_STATS = _KernelStats()

#: (operator class name, reason prefix) pairs already warned about
_FALLBACK_WARNED = set()


class OutputTag:
    """Names a side output."""

    __slots__ = ("tag_id",)

    def __init__(self, tag_id: str):
        self.tag_id = tag_id

    def __eq__(self, other):
        return isinstance(other, OutputTag) and self.tag_id == other.tag_id

    def __hash__(self):
        return hash(self.tag_id)

    def __repr__(self):
        return f"OutputTag({self.tag_id!r})"


class Output(abc.ABC):
    """Where an operator emits."""

    @abc.abstractmethod
    def collect(self, record: StreamRecord) -> None: ...

    @abc.abstractmethod
    def emit_watermark(self, watermark: Watermark) -> None: ...

    def collect_batch(self, batch) -> None:
        """Emit a whole RecordBatch.  Default: box into records;
        outputs that carry batches (chained operators, the router)
        override this."""
        for record in batch.to_records():
            self.collect(record)

    def collect_side(self, tag: OutputTag, record: StreamRecord) -> None:
        """Dropped unless a side output is wired."""

    def emit_latency_marker(self, marker) -> None:  # noqa: B027
        """Dropped unless the output forwards markers (the chain and
        the router do)."""

    def close(self) -> None:  # noqa: B027
        pass


class CollectorOutput(Output):
    """Keeps emissions in lists (the test harness's output)."""

    def __init__(self):
        self.records: List[StreamRecord] = []
        self.watermarks: List[Watermark] = []
        self.side: dict = {}

    def collect(self, record):
        self.records.append(record)

    def emit_watermark(self, watermark):
        self.watermarks.append(watermark)

    def collect_side(self, tag, record):
        self.side.setdefault(tag.tag_id, []).append(record)


class TimestampedCollector:
    """Collector bound to one timestamp."""

    __slots__ = ("_output", "timestamp")

    def __init__(self, output: Output, timestamp: Optional[int] = None):
        self._output = output
        self.timestamp = timestamp

    def collect(self, value) -> None:
        self._output.collect(StreamRecord(value, self.timestamp))

    def set_absolute_timestamp(self, ts: Optional[int]) -> None:
        self.timestamp = ts


class StreamOperator(abc.ABC):
    """Operator lifecycle: setup → open → process* → finish → close."""

    #: the FusedChainProgram anchored at this operator, or None (a class
    #: attribute: the task layer's check is one attribute load)
    _fused_chain = None
    #: the FusedChainProgram this operator is a member of; cleared on
    #: demotion
    _fused_member = None

    def __init__(self):
        self.output: Optional[Output] = None
        self.keyed_backend = None
        self.operator_state_backend: Optional[OperatorStateBackend] = None
        self.processing_time_service: Optional[ProcessingTimeService] = None
        self.timer_service: Optional[InternalTimerService] = None
        self.current_watermark: int = MIN_TIMESTAMP
        self.key_selector: Optional[KeySelector] = None
        self.operator_id: str = ""
        self.subtask_index: int = 0
        self.num_subtasks: int = 1
        self.max_parallelism: int = 128
        # columnar accounting over rows delivered as batches
        self.columnar_rows: int = 0
        self.boxed_rows: int = 0
        self.boxed_fallbacks: int = 0
        self.columnar_fallback_reason: Optional[str] = None
        #: who chose the column path: "probe" or "fused"
        self.columnar_decided_by: Optional[str] = None
        self.kernel_probes: int = 0
        #: rows handled inside a fused chain program (counted into
        #: columnar_rows too)
        self.fused_rows: int = 0
        #: the operator's MetricGroup once the task layer registered it
        self.metrics = None
        self._boxed_fallbacks_counter = None

    def setup(self, output: Output, keyed_backend=None,
              operator_state_backend: Optional[OperatorStateBackend] = None,
              processing_time_service: Optional[ProcessingTimeService] = None,
              key_selector: Optional[KeySelector] = None,
              operator_id: str = "", subtask_index: int = 0,
              num_subtasks: int = 1, max_parallelism: int = 128) -> None:
        self.output = output
        self.keyed_backend = keyed_backend
        self.operator_state_backend = (operator_state_backend
                                       or OperatorStateBackend())
        self.processing_time_service = processing_time_service
        self.key_selector = key_selector
        self.operator_id = operator_id or type(self).__name__
        self.subtask_index = subtask_index
        self.num_subtasks = num_subtasks
        self.max_parallelism = max_parallelism
        if keyed_backend is not None:
            self.timer_service = InternalTimerService(
                f"{self.operator_id}-timers", keyed_backend,
                processing_time_service, self)

    def register_standard_metrics(self, group) -> None:
        """Attach the operator's MetricGroup and publish the gauges
        every operator has: ``currentWatermark``, ``watermarkLag``
        (event time against the wall clock, ms) and the ``columnar``
        group (ref ``flink_tpu/streaming/operators.py:222-240``)."""
        self.metrics = group
        group.gauge("currentWatermark", lambda: self.current_watermark)
        group.gauge("watermarkLag", self._watermark_lag_ms)
        col = group.add_group("columnar")
        col.gauge("ratio", self._columnar_ratio)
        col.gauge("fused_ratio", self._fused_ratio)
        col.gauge("fallback_reason",
                  lambda: self.columnar_fallback_reason or "")
        col.gauge("decided_by",
                  lambda: self.columnar_decided_by or "")
        col.gauge("probes", lambda: self.kernel_probes)
        self._boxed_fallbacks_counter = col.counter("boxed_fallbacks")
        self._boxed_fallbacks_counter.count = self.boxed_fallbacks

    def _columnar_ratio(self):
        total = self.columnar_rows + self.boxed_rows
        if total == 0:
            return None  # never saw a batch: ratio undefined
        return self.columnar_rows / total

    def _fused_ratio(self):
        total = self.columnar_rows + self.boxed_rows
        if total == 0:
            return None
        return self.fused_rows / total

    def _watermark_lag_ms(self):
        wm = self.current_watermark
        if wm <= MIN_TIMESTAMP:
            return None  # no watermark seen yet: lag undefined
        if wm >= MAX_TIMESTAMP:
            return 0.0  # final watermark: stream drained, no lag
        return max(0.0, _time.time() * 1000.0 - wm)

    def process_latency_marker(self, marker) -> None:
        self.output.emit_latency_marker(marker)

    def open(self) -> None:  # noqa: B027
        pass

    def finish(self) -> None:  # noqa: B027
        """End of input reached (after the final watermark, before
        close): flush buffered output."""

    def close(self) -> None:  # noqa: B027
        pass

    @abc.abstractmethod
    def process_element(self, record: StreamRecord) -> None: ...

    def _note_columnar(self, n: int) -> None:
        self.columnar_rows += n

    def _note_fused(self, n: int) -> None:
        """Rows a fused chain program handled for this operator."""
        self.fused_rows += n
        self.columnar_rows += n
        self.columnar_decided_by = "fused"

    def _note_boxed(self, n: int, reason: str) -> None:
        self.boxed_rows += n
        self.boxed_fallbacks += 1
        if self.columnar_fallback_reason is None:
            self.columnar_fallback_reason = reason
        if self._boxed_fallbacks_counter is not None:
            self._boxed_fallbacks_counter.inc()

    def process_batch(self, batch) -> None:
        """Consume a RecordBatch: box it into records once, here, and
        run the per-record path (operators with a column path
        override)."""
        self._note_boxed(len(batch), f"no batch kernel on {type(self).__name__}")
        for record in batch.to_records():
            self.set_key_context(record)
            self.process_element(record)

    def process_watermark(self, watermark: Watermark) -> None:
        self.current_watermark = watermark.timestamp
        if self.timer_service is not None:
            self.timer_service.advance_watermark(watermark.timestamp)
        self.output.emit_watermark(watermark)

    def set_key_context(self, record: StreamRecord) -> None:
        """The record's key becomes the backend's current key."""
        if self.key_selector is not None and self.keyed_backend is not None:
            self.keyed_backend.set_current_key(
                self.key_selector.get_key(record.value))

    # ---- timers -----------------------------------------------------
    def on_event_time(self, timer) -> None:  # noqa: B027
        pass

    def on_processing_time(self, timer) -> None:  # noqa: B027
        pass

    # ---- snapshot ---------------------------------------------------
    def snapshot_state(self, checkpoint_id: Optional[int] = None) -> dict:
        """Keyed state (pending micro-batches flushed first), operator
        state and timers."""
        snap = {}
        if self.keyed_backend is not None:
            flush = getattr(self.keyed_backend, "flush_all", None)
            if flush is not None:
                flush()
            snap["keyed"] = self.keyed_backend.snapshot()
        if self.operator_state_backend is not None:
            snap["operator"] = self.operator_state_backend.snapshot()
        if self.timer_service is not None:
            snap["timers"] = self.timer_service.snapshot()
        return snap

    def restore_state(self, snapshots: List[dict]) -> None:
        keyed = [s["keyed"] for s in snapshots if "keyed" in s]
        if keyed and self.keyed_backend is not None:
            self.keyed_backend.restore(keyed)
        ops = [s["operator"] for s in snapshots if "operator" in s]
        if ops and self.operator_state_backend is not None:
            self.operator_state_backend.restore(
                ops[0] if len(ops) == 1
                else OperatorStateSnapshot.redistribute(ops, 1)[0])
        timers = [s["timers"] for s in snapshots if "timers" in s]
        if timers and self.timer_service is not None:
            self.timer_service.restore(timers)

    def notify_checkpoint_complete(self, checkpoint_id: int) -> None:  # noqa: B027
        pass


class KeyedStateStore:
    """Keyed state of a rich function, in the void namespace."""

    def __init__(self, backend):
        self._backend = backend

    def _bind(self, descriptor):
        return self._backend.get_partitioned_state(VOID_NAMESPACE, descriptor)

    get_value_state = _bind
    get_list_state = _bind
    get_reducing_state = _bind
    get_aggregating_state = _bind
    get_map_state = _bind


class AbstractUdfStreamOperator(StreamOperator):
    """Hosts a user function, forwarding open/close."""

    #: at parallelism > 1 each subtask gets its own copy of the function
    #: (sinks opt out: a CollectSink's list is read after the job)
    COPY_UDF_PER_SUBTASK = True

    def __init__(self, user_function):
        super().__init__()
        self.user_function = user_function

    def setup(self, *args, **kwargs):
        super().setup(*args, **kwargs)
        if self.COPY_UDF_PER_SUBTASK and self.num_subtasks > 1:
            self.user_function = copy.deepcopy(self.user_function)

    def open(self):
        if isinstance(self.user_function, RichFunction):
            store = (KeyedStateStore(self.keyed_backend)
                     if self.keyed_backend is not None else None)
            self.user_function.set_runtime_context(RuntimeContext(
                task_name=self.operator_id,
                index_of_subtask=self.subtask_index,
                parallelism=self.num_subtasks,
                max_parallelism=self.max_parallelism,
                keyed_state_store=store,
                operator_state_store=self.operator_state_backend))
            self.user_function.open(None)
        # operator state for any function (the seam a replayable source
        # keeps its positions through); restore runs after open
        fn = self.user_function
        if hasattr(fn, "initialize_state"):
            fn.initialize_state(self)

    def finish(self):
        fn = self.user_function
        if hasattr(fn, "finish"):
            fn.finish()

    def close(self):
        if isinstance(self.user_function, RichFunction):
            self.user_function.close()

    def notify_checkpoint_complete(self, checkpoint_id: int) -> None:
        fn = self.user_function
        if hasattr(fn, "notify_checkpoint_complete"):
            fn.notify_checkpoint_complete(checkpoint_id)

    def snapshot_state(self, checkpoint_id: Optional[int] = None) -> dict:
        """The function's own state rides along when it defines
        ``snapshot_function_state``."""
        snap = super().snapshot_state(checkpoint_id)
        fn = self.user_function
        if hasattr(fn, "snapshot_function_state"):
            snap["function"] = fn.snapshot_function_state(checkpoint_id)
        return snap

    def restore_state(self, snapshots) -> None:
        super().restore_state(snapshots)
        fn = self.user_function
        if hasattr(fn, "restore_function_state"):
            for s in snapshots:
                if "function" in s:
                    fn.restore_function_state(s["function"])


# ---------------------------------------------------------------------
# column kernels of the stateless UDF operators
# ---------------------------------------------------------------------

def _np_scalar(x):
    return x.item() if isinstance(x, np.generic) else x


def _batch_row_value(batch, i):
    arrays = tuple(batch.cols.values())
    if batch.is_scalar:
        return _np_scalar(arrays[0][i])
    return tuple(_np_scalar(a[i]) for a in arrays)


def _kernel_row_value(out, i):
    """Row i of a kernel result (an ndarray or a tuple of them)."""
    if type(out) is tuple:
        return tuple(_np_scalar(a[i]) for a in out)
    return _np_scalar(out[i])


def _same_scalar(a, b) -> bool:
    if type(a) is tuple or type(b) is tuple:
        return (type(a) is tuple and type(b) is tuple and len(a) == len(b)
                and all(_same_scalar(x, y) for x, y in zip(a, b)))
    if type(a) is not type(b):
        return False
    try:
        if a == b:
            return True
        return a != a and b != b  # NaN equals NaN for the probe
    except Exception:  # noqa: BLE001
        return False


def _normalize_kernel_output(out, n):
    """Kernel result -> ndarray (scalar rows) or tuple of ndarrays
    (tuple rows), constant fields broadcast; None = not columnar."""
    if isinstance(out, np.ndarray):
        return out if out.shape == (n,) else None
    if type(out) is tuple and out:
        cols = []
        for item in out:
            if isinstance(item, np.ndarray):
                if item.shape != (n,):
                    return None
                cols.append(item)
            elif isinstance(item, (int, float, str, np.generic)):
                cols.append(np.full(n, item))
            else:
                return None
        return tuple(cols)
    return None


def _kernel_output_batch(batch, arrays):
    """Normalized kernel output as a batch with the input's timestamps
    (machine-style names: ``v``, or ``f0..fk``)."""
    if type(arrays) is tuple:
        cols = {f"f{i}": a for i, a in enumerate(arrays)}
    else:
        cols = {"v": arrays}
    return RecordBatch(cols, batch.ts, batch.ts_mask)


def _kernel_fn(user_function, attr: str):
    """What the column path calls: the wrapped lambda when there is one
    (the adapters coerce their method's return), else the method."""
    fn = getattr(user_function, "_fn", None)
    if callable(fn):
        return fn
    return getattr(user_function, attr, user_function)


def _udf_liftable(user_function, attr: str):
    """(liftable, reason): only a LIFTABLE verdict rides columns."""
    fn = _kernel_fn(user_function, attr)
    try:
        from flink_tpu_torch.analysis.liftability import LIFTABLE, analyze_udf
        rep = analyze_udf(fn)
        if rep.verdict == LIFTABLE:
            return True, ""
        return False, (f"{attr} UDF not liftable ({rep.verdict}: "
                       + "; ".join(rep.reasons[:2]) + ")")
    except Exception as e:  # noqa: BLE001
        return False, f"liftability analysis failed: {e!r}"


class _ColumnKernelMixin:
    """Decide / probe / fall back, shared by StreamMap and StreamFilter.
    ``_batch_kernel`` is None (undecided), True (riding columns, probe
    passed or statically proven) or False (locked onto the boxed path).
    ``_static_kernel`` (stamped by ``typeflow.apply_static``) skips the
    liftability decision and the probe; ``_typeflow_verdict`` names the
    prover's verdict in the fallback warning."""

    _batch_kernel = None
    _KERNEL_ATTR = ""
    _static_kernel = False
    _typeflow_verdict = None

    def _decide_kernel(self) -> bool:
        if self._static_kernel:
            return True
        ok, reason = _udf_liftable(self.user_function, self._KERNEL_ATTR)
        if not ok:
            self._batch_kernel = False
            self.columnar_fallback_reason = reason
        return ok

    def _kernel_fallback(self, batch, reason: str):
        self._batch_kernel = False
        self.columnar_fallback_reason = reason
        self.columnar_decided_by = None
        key = (type(self).__name__, reason.split(":")[0])
        if key not in _FALLBACK_WARNED:
            _FALLBACK_WARNED.add(key)
            verdict = self._typeflow_verdict
            log.warning("%s '%s' falls back to the boxed path: %s%s",
                        type(self).__name__, self.operator_id, reason,
                        f" (typeflow verdict was: {verdict})" if verdict
                        else "")
        StreamOperator.process_batch(self, batch)

    def process_batch(self, batch):
        n = len(batch)
        if n == 0:
            return
        decided = self._batch_kernel
        if decided is False or (decided is None and not self._decide_kernel()):
            StreamOperator.process_batch(self, batch)
            return
        fn = _kernel_fn(self.user_function, self._KERNEL_ATTR)
        try:
            out = fn(batch.value_arrays())
        except Exception as e:  # noqa: BLE001
            self._kernel_fallback(batch, f"kernel raised {e!r}")
            return
        if decided is None:
            if self._static_kernel:
                # the prover certified the dtype flow ahead of time: no
                # probe (the emit-side shape check still demotes)
                self._batch_kernel = True
                self.columnar_decided_by = "static"
                KERNEL_STATS.static_skips += 1
            else:
                # first surviving batch: the vectorized result against
                # the scalar UDF on the edge rows (LIFTABLE UDFs are
                # pure, so replaying rows is safe)
                self.kernel_probes += 1
                KERNEL_STATS.probes += 1
                err = self._probe(batch, fn, out, n)
                if err is not None:
                    self._kernel_fallback(batch, err)
                    return
                self._batch_kernel = True
                self.columnar_decided_by = "probe"
        self._emit_kernel_result(batch, out, n)


class StreamMap(_ColumnKernelMixin, AbstractUdfStreamOperator):
    _KERNEL_ATTR = "map"

    def process_element(self, record):
        self.output.collect(StreamRecord(self.user_function.map(record.value),
                                         record.timestamp))

    def _probe(self, batch, fn, out, n):
        arrays = _normalize_kernel_output(out, n)
        if arrays is None:
            return "kernel output is not a column shape"
        for i in (0, n - 1):
            if not _same_scalar(fn(_batch_row_value(batch, i)),
                                _kernel_row_value(arrays, i)):
                return "probe mismatch (vectorized != scalar result)"
        return None

    def _emit_kernel_result(self, batch, out, n):
        arrays = _normalize_kernel_output(out, n)
        if arrays is None:
            self._kernel_fallback(batch, "kernel output is not a column shape")
            return
        self._note_columnar(n)
        self.output.collect_batch(_kernel_output_batch(batch, arrays))


class StreamFlatMap(AbstractUdfStreamOperator):
    """Per record: a flat map has no column kernel."""

    def process_element(self, record):
        out = self.user_function.flat_map(record.value)
        if out is not None:
            for value in out:
                self.output.collect(StreamRecord(value, record.timestamp))


class StreamFilter(_ColumnKernelMixin, AbstractUdfStreamOperator):
    _KERNEL_ATTR = "filter"

    def process_element(self, record):
        if self.user_function.filter(record.value):
            self.output.collect(record)

    def _probe(self, batch, fn, out, n):
        if not (isinstance(out, np.ndarray) and out.shape == (n,)
                and out.dtype == np.bool_):
            return "filter kernel did not produce a bool mask"
        for i in (0, n - 1):
            if bool(fn(_batch_row_value(batch, i))) != bool(out[i]):
                return "probe mismatch (vectorized != scalar result)"
        return None

    def _emit_kernel_result(self, batch, out, n):
        if not (isinstance(out, np.ndarray) and out.shape == (n,)
                and out.dtype == np.bool_):
            self._kernel_fallback(batch,
                                  "filter kernel did not produce a bool mask")
            return
        self._note_columnar(n)
        if out.all():
            self.output.collect_batch(batch)
        elif out.any():
            self.output.collect_batch(batch.take(out))


class StreamSink(AbstractUdfStreamOperator):
    """Operator hosting a SinkFunction."""

    COPY_UDF_PER_SUBTASK = False

    def process_element(self, record):
        self.user_function.invoke(record.value,
                                  SinkContext(record.timestamp, self))

    def process_batch(self, batch):
        """A sink function with ``invoke_batch`` takes the whole batch
        in one call; other sinks box per row."""
        fn = self.user_function
        if hasattr(fn, "invoke_batch"):
            self._note_columnar(len(batch))
            fn.invoke_batch(batch)
        else:
            StreamOperator.process_batch(self, batch)


class SinkContext:
    __slots__ = ("timestamp", "_op")

    def __init__(self, timestamp, op):
        self.timestamp = timestamp
        self._op = op


class StreamGroupedReduce(AbstractUdfStreamOperator):
    """Rolling keyed reduce: emits the running reduction of the key at
    every element."""

    STATE_NAME = "_reduce_state"

    def __init__(self, reduce_function: ReduceFunction):
        super().__init__(reduce_function)

    def open(self):
        super().open()
        self._state = self.keyed_backend.get_or_create_keyed_state(
            ReducingStateDescriptor(self.STATE_NAME, self.user_function))

    def process_element(self, record):
        self._state.set_current_namespace(VOID_NAMESPACE)
        self._state.add(record.value)
        self.output.collect(StreamRecord(self._state.get(), record.timestamp))


class ProcessOperator(AbstractUdfStreamOperator):
    """Hosts a ProcessFunction on a stream without keys."""

    def open(self):
        super().open()
        self._collector = TimestampedCollector(self.output)

    def process_element(self, record):
        self._collector.set_absolute_timestamp(record.timestamp)
        ctx = ProcessFunctionContext(record, self)
        self.user_function.process_element(record.value, ctx, self._collector)


class KeyedProcessOperator(AbstractUdfStreamOperator):
    """Hosts a ProcessFunction on a keyed stream, with keyed state and
    timers; ``on_timer`` runs with the timer's key current."""

    def open(self):
        super().open()
        self._collector = TimestampedCollector(self.output)

    def process_element(self, record):
        self._collector.set_absolute_timestamp(record.timestamp)
        ctx = KeyedProcessFunctionContext(record, self)
        self.user_function.process_element(record.value, ctx, self._collector)

    def on_event_time(self, timer):
        self._collector.set_absolute_timestamp(timer.timestamp)
        ctx = OnTimerContext(timer, self, "event")
        self.user_function.on_timer(timer.timestamp, ctx, self._collector)

    def on_processing_time(self, timer):
        self._collector.set_absolute_timestamp(None)
        ctx = OnTimerContext(timer, self, "processing")
        self.user_function.on_timer(timer.timestamp, ctx, self._collector)


class ProcessFunctionContext:
    """What ``process_element`` sees: the record's timestamp, the
    clocks and side outputs."""

    def __init__(self, record: StreamRecord, op: StreamOperator):
        self._record = record
        self._op = op

    def timestamp(self) -> Optional[int]:
        return self._record.timestamp

    def current_processing_time(self) -> int:
        pts = self._op.processing_time_service
        return pts.get_current_processing_time() if pts else 0

    def current_watermark(self) -> int:
        return self._op.current_watermark

    def output(self, tag: OutputTag, value) -> None:
        self._op.output.collect_side(tag, StreamRecord(value, self._record.timestamp))


class KeyedProcessFunctionContext(ProcessFunctionContext):
    """Adds the current key, timers and keyed state."""

    def get_current_key(self):
        return self._op.keyed_backend.current_key

    def register_event_time_timer(self, timestamp: int) -> None:
        self._op.timer_service.register_event_time_timer(VOID_NAMESPACE, timestamp)

    def register_processing_time_timer(self, timestamp: int) -> None:
        self._op.timer_service.register_processing_time_timer(VOID_NAMESPACE, timestamp)

    def delete_event_time_timer(self, timestamp: int) -> None:
        self._op.timer_service.delete_event_time_timer(VOID_NAMESPACE, timestamp)

    def delete_processing_time_timer(self, timestamp: int) -> None:
        self._op.timer_service.delete_processing_time_timer(VOID_NAMESPACE, timestamp)

    def get_state(self, descriptor: StateDescriptor):
        return self._op.keyed_backend.get_partitioned_state(VOID_NAMESPACE, descriptor)


class OnTimerContext(KeyedProcessFunctionContext):
    """What ``on_timer`` sees: the timer's time, key and domain
    (``event`` or ``processing``)."""

    def __init__(self, timer, op, time_domain: str):
        self._timer = timer
        self._op = op
        self._record = StreamRecord(None, timer.timestamp)
        self.time_domain = time_domain

    def timestamp(self):
        return self._timer.timestamp

    def get_current_key(self):
        return self._timer.key


class ProcessFunction(abc.ABC):
    """``process_element(value, ctx, out)`` per element and
    ``on_timer(timestamp, ctx, out)`` per timer that fires."""

    @abc.abstractmethod
    def process_element(self, value, ctx, out) -> None: ...

    def on_timer(self, timestamp: int, ctx, out) -> None:  # noqa: B027
        pass


#: the same shape; the keyed context comes at run time
KeyedProcessFunction = ProcessFunction


# ---------------------------------------------------------------------
# two-input operators
# ---------------------------------------------------------------------

class TwoInputStreamOperator(StreamOperator):
    """An operator of two inputs: ``process_element1`` / ``2`` per input,
    and one watermark per input, the operator's own being their
    minimum."""

    @abc.abstractmethod
    def process_element1(self, record: StreamRecord) -> None: ...

    @abc.abstractmethod
    def process_element2(self, record: StreamRecord) -> None: ...

    def process_element(self, record):
        raise RuntimeError("two-input operator: use process_element1/2")

    def process_watermark1(self, watermark: Watermark) -> None:
        self._wm1 = watermark.timestamp
        self._combine_watermarks()

    def process_watermark2(self, watermark: Watermark) -> None:
        self._wm2 = watermark.timestamp
        self._combine_watermarks()

    def _combine_watermarks(self):
        combined = min(getattr(self, "_wm1", MIN_TIMESTAMP),
                       getattr(self, "_wm2", MIN_TIMESTAMP))
        if combined > self.current_watermark:
            self.process_watermark(Watermark(combined))


class CoStreamMap(TwoInputStreamOperator, AbstractUdfStreamOperator):
    """Hosts a ``CoMapFunction``."""

    def __init__(self, fn):
        AbstractUdfStreamOperator.__init__(self, fn)

    def process_element1(self, record):
        self.output.collect(record.replace(self.user_function.map1(record.value)))

    def process_element2(self, record):
        self.output.collect(record.replace(self.user_function.map2(record.value)))


class CoStreamFlatMap(TwoInputStreamOperator, AbstractUdfStreamOperator):
    """Hosts a ``CoFlatMapFunction``."""

    def __init__(self, fn):
        AbstractUdfStreamOperator.__init__(self, fn)

    def process_element1(self, record):
        out = self.user_function.flat_map1(record.value)
        if out is not None:
            for v in out:
                self.output.collect(record.replace(v))

    def process_element2(self, record):
        out = self.user_function.flat_map2(record.value)
        if out is not None:
            for v in out:
                self.output.collect(record.replace(v))


class CoProcessOperator(TwoInputStreamOperator, AbstractUdfStreamOperator):
    """Hosts a (keyed) co-process function: ``process_element1`` /
    ``2`` with the keyed context, ``on_timer`` per timer.  Keyed, the
    second input's records take their key from ``key_selector2``."""

    def __init__(self, fn):
        AbstractUdfStreamOperator.__init__(self, fn)
        self.key_selector2: Optional[KeySelector] = None

    def open(self):
        AbstractUdfStreamOperator.open(self)
        self._collector = TimestampedCollector(self.output)

    def set_key_context2(self, record: StreamRecord) -> None:
        if self.key_selector2 is not None and self.keyed_backend is not None:
            self.keyed_backend.set_current_key(
                self.key_selector2.get_key(record.value))

    def process_element1(self, record):
        self._collector.set_absolute_timestamp(record.timestamp)
        ctx = KeyedProcessFunctionContext(record, self)
        self.user_function.process_element1(record.value, ctx, self._collector)

    def process_element2(self, record):
        self._collector.set_absolute_timestamp(record.timestamp)
        ctx = KeyedProcessFunctionContext(record, self)
        self.user_function.process_element2(record.value, ctx, self._collector)

    def on_event_time(self, timer):
        self._collector.set_absolute_timestamp(timer.timestamp)
        ctx = OnTimerContext(timer, self, "event")
        if hasattr(self.user_function, "on_timer"):
            self.user_function.on_timer(timer.timestamp, ctx, self._collector)

    def on_processing_time(self, timer):
        self._collector.set_absolute_timestamp(None)
        ctx = OnTimerContext(timer, self, "processing")
        if hasattr(self.user_function, "on_timer"):
            self.user_function.on_timer(timer.timestamp, ctx, self._collector)


# ---------------------------------------------------------------------
# the broadcast state pattern
# ---------------------------------------------------------------------

class BroadcastProcessFunction(abc.ABC):
    """``process_element`` per record of the data side (read-only
    broadcast state) and ``process_broadcast_element`` per record of
    the broadcast side (writable broadcast state); keyed, the data side
    also has keyed state and timers."""

    @abc.abstractmethod
    def process_element(self, value, ctx, out) -> None: ...

    @abc.abstractmethod
    def process_broadcast_element(self, value, ctx, out) -> None: ...

    def on_timer(self, timestamp: int, ctx, out) -> None:  # noqa: B027
        pass


KeyedBroadcastProcessFunction = BroadcastProcessFunction


class _ReadOnlyBroadcastState:
    """The data side's view of a broadcast state: reads only."""

    def __init__(self, state):
        self._s = state

    def get(self, key):
        return self._s.get(key)

    def contains(self, key):
        return self._s.contains(key)

    def immutable_entries(self):
        return self._s.immutable_entries()

    def keys(self):
        return self._s.keys()


class _BroadcastBaseContext(ProcessFunctionContext):
    def __init__(self, record, op, writable: bool):
        super().__init__(record, op)
        self._writable = writable

    def get_broadcast_state(self, descriptor_or_name):
        name = getattr(descriptor_or_name, "name", descriptor_or_name)
        state = self._op.operator_state_backend.get_broadcast_state(name)
        return state if self._writable else _ReadOnlyBroadcastState(state)


class _BroadcastReadOnlyContext(_BroadcastBaseContext):
    """The data side's context: read-only broadcast state, and on a
    keyed data side the current key, keyed state and timers."""

    def __init__(self, record, op):
        super().__init__(record, op, writable=False)

    def get_current_key(self):
        return self._op.keyed_backend.current_key

    def get_state(self, descriptor):
        return self._op.keyed_backend.get_partitioned_state(
            VOID_NAMESPACE, descriptor)

    def register_event_time_timer(self, timestamp):
        self._op.timer_service.register_event_time_timer(
            VOID_NAMESPACE, timestamp)

    def register_processing_time_timer(self, timestamp):
        self._op.timer_service.register_processing_time_timer(
            VOID_NAMESPACE, timestamp)


class CoBroadcastOperator(TwoInputStreamOperator, AbstractUdfStreamOperator):
    """Input 1 is the (possibly keyed) data stream, input 2 the
    broadcast stream: the broadcast partitioner delivers each of its
    records to every instance, so every instance's broadcast state (on
    its ``OperatorStateBackend``) sees the same updates."""

    def __init__(self, fn: BroadcastProcessFunction):
        AbstractUdfStreamOperator.__init__(self, fn)

    def open(self):
        super().open()
        self._collector = TimestampedCollector(self.output)

    def process_element1(self, record):
        self._collector.set_absolute_timestamp(record.timestamp)
        ctx = _BroadcastReadOnlyContext(record, self)
        self.user_function.process_element(record.value, ctx, self._collector)

    def process_element2(self, record):
        self._collector.set_absolute_timestamp(record.timestamp)
        ctx = _BroadcastBaseContext(record, self, writable=True)
        self.user_function.process_broadcast_element(record.value, ctx,
                                                     self._collector)

    def on_event_time(self, timer):
        self._collector.set_absolute_timestamp(timer.timestamp)
        ctx = OnTimerContext(timer, self, "event")
        self.user_function.on_timer(timer.timestamp, ctx, self._collector)

    def on_processing_time(self, timer):
        self._collector.set_absolute_timestamp(None)
        ctx = OnTimerContext(timer, self, "processing")
        self.user_function.on_timer(timer.timestamp, ctx, self._collector)


# ---------------------------------------------------------------------
# async I/O
# ---------------------------------------------------------------------

class AsyncFunction(abc.ABC):
    """``async_invoke(value, result_future)`` runs on a pool thread, so
    a blocking client call inside it overlaps with other records'
    calls; it completes the future with a list of results or an
    error."""

    @abc.abstractmethod
    def async_invoke(self, value, result_future: "ResultFuture") -> None:
        ...

    def timeout(self, value, result_future: "ResultFuture") -> None:
        result_future.complete_exceptionally(
            TimeoutError(f"async I/O timed out for {value!r}"))


class ResultFuture:
    """One request's results; completing it sets its own event and the
    operator's any-completion event."""

    __slots__ = ("_results", "_error", "_done", "_notify")

    def __init__(self, notify=None):
        self._results = None
        self._error = None
        self._done = threading.Event()
        self._notify = notify

    def complete(self, results) -> None:
        self._results = list(results)
        self._done.set()
        if self._notify is not None:
            self._notify.set()

    def complete_exceptionally(self, error: BaseException) -> None:
        self._error = error
        self._done.set()
        if self._notify is not None:
            self._notify.set()

    @property
    def done(self) -> bool:
        return self._done.is_set()


class AsyncWaitOperator(AbstractUdfStreamOperator):
    """At most ``capacity`` requests in flight, their results emitted
    in input order (``ordered``) or as they complete.  A watermark
    waits until every request ahead of it is out, in both modes; so do
    a snapshot (upstream replays nothing it consumed before the
    barrier, so no request may stay in flight across it) and the end of
    input.  Waits block on the futures' events, never spin."""

    def __init__(self, fn: AsyncFunction, capacity: int = 100,
                 timeout_ms: Optional[int] = None, ordered: bool = True):
        super().__init__(fn)
        self.capacity = capacity
        self.timeout_ms = timeout_ms
        self.ordered = ordered
        self._pending = None  # deque of (record, ResultFuture, deadline, value)
        self._pool = None

    def open(self):
        super().open()
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor
        self._pending = deque()
        self._any_done = threading.Event()
        self._pool = ThreadPoolExecutor(max_workers=min(self.capacity, 64),
                                        thread_name_prefix="async-io")

    def process_element(self, record):
        while len(self._pending) >= self.capacity:
            self._drain(block_one=True)
        rf = ResultFuture(notify=self._any_done)
        value = record.value
        deadline = (None if self.timeout_ms is None
                    else _time.monotonic() + self.timeout_ms / 1000.0)
        self._pool.submit(self._invoke, value, rf)
        self._pending.append((record, rf, deadline, value))
        self._drain()

    def _invoke(self, value, rf):
        try:
            self.user_function.async_invoke(value, rf)
        except BaseException as e:
            # the record's error, raised on the loop when it is emitted;
            # an interrupt or exit also goes on up in this pool thread
            rf.complete_exceptionally(e)
            if not isinstance(e, Exception):
                raise

    def _drain(self, block_one: bool = False, block_all: bool = False):
        """Emit what completed: in ordered mode from the head only, in
        unordered mode any completed entry.  ``block_one`` waits until
        at least one entry went out, ``block_all`` until none is left."""
        block = block_one or block_all
        while self._pending:
            if self.ordered:
                entry = self._pending[0]
                if not self._entry_ready(entry, block):
                    return
                self._pending.popleft()
                self._emit(entry)
            else:
                while True:
                    # cleared before the scan: a completion after it
                    # sets the event again, so the wait cannot miss it
                    self._any_done.clear()
                    ready = [e for e in self._pending
                             if e[1].done or self._expired(e)]
                    if ready or not block:
                        break
                    self._any_done.wait(self._wait_s())
                if not ready:
                    return
                for entry in ready:
                    self._pending.remove(entry)
                    self._emit(entry)
            if block_one and not block_all:
                return

    def _wait_s(self) -> Optional[float]:
        """How long a blocked drain may wait: until the earliest
        deadline, or without limit when no request has one."""
        deadlines = [e[2] for e in self._pending if e[2] is not None]
        if not deadlines:
            return None
        return max(0.0, min(deadlines) - _time.monotonic())

    def _entry_ready(self, entry, block: bool) -> bool:
        _, rf, deadline, _ = entry
        if rf.done or self._expired(entry):
            return True
        if not block:
            return False
        rf._done.wait(None if deadline is None
                      else max(0.0, deadline - _time.monotonic()))
        return True

    def _expired(self, entry) -> bool:
        _, rf, deadline, _ = entry
        return (deadline is not None and not rf.done
                and _time.monotonic() > deadline)

    def _emit(self, entry):
        record, rf, _, value = entry
        if not rf.done and self._expired(entry):
            self.user_function.timeout(value, rf)
            rf._done.wait(1.0)
        if rf._error is not None:
            raise rf._error
        for v in rf._results or []:
            self.output.collect(record.replace(v))

    def process_watermark(self, watermark):
        self._drain(block_all=True)
        super().process_watermark(watermark)

    def snapshot_state(self, checkpoint_id=None):
        self._drain(block_all=True)
        return super().snapshot_state(checkpoint_id)

    def finish(self):
        self._drain(block_all=True)
        super().finish()

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False)
        super().close()
