"""WindowOperator: keyed windowed aggregation with triggers, allowed
lateness, late-data side output and merging session windows, on a
keyed-state backend (port of ``flink_tpu/streaming/window_operator.py``).

Window state is keyed state under namespace = the window's
``(start, end)`` tuple, so both backends serve it unchanged: on the
GPU backend ``add`` is a micro-batched scatter, a fire a device gather
and a session merge a ``merge_rows`` launch.  ``process_batch`` ingests
a RecordBatch column-wise for tumbling and sliding event-time windows
with the default trigger, and a watermark fires every due window of
that shape through one timer sweep and one ``get_batch``
(``on_watermark_batch``); ``process_batch_fused`` takes pane starts
that a fused chain program computed on the card.  Merging assigners and per-row ingest take
``process_element`` and the per-timer ``on_event_time``.

The session mapping (window -> state window) is stored in keyed value
state as a dict of window objects, as the JAX package stores it; a
mapping of namespace tuples restores too.

``GlobalWindows`` (count windows) runs here too: its one window's
cleanup time is ``MAX_TIMESTAMP``, so it registers no cleanup timer
and fires only by its trigger; lateness does not apply to it.
``EvictingWindowOperator`` keeps the raw (timestamp, value) pairs in
list state and runs the evictor around the window function.
Processing-time assigners place a record by the operator's
processing-time clock; their triggers and cleanup timers are
processing-time timers.  Tumbling and sliding ones under the default
trigger fire every due window as one batch
(``on_processing_time_batch``: one ``get_batch``, one
``clear_batch``), the others one ``on_processing_time`` a timer.
"""

from __future__ import annotations

import abc
from typing import Any, Iterable, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.core.functions import _FieldKeySelector
from flink_tpu_torch.core.state import (AggregatingStateDescriptor,
                                        ListStateDescriptor,
                                        ReducingStateDescriptor,
                                        StateDescriptor,
                                        ValueStateDescriptor)
from flink_tpu_torch.runtime.device_stats import TELEMETRY
from flink_tpu_torch.runtime.tracing import get_tracer
from flink_tpu_torch.state.backend import VOID_NAMESPACE
from flink_tpu_torch.state.introspect import INTROSPECTION
from flink_tpu_torch.streaming.elements import MAX_TIMESTAMP, StreamRecord
from flink_tpu_torch.streaming.operators import (AbstractUdfStreamOperator,
                                                 OutputTag,
                                                 TimestampedCollector)
from flink_tpu_torch.streaming.windowing import (
    SlidingEventTimeWindows, SlidingProcessingTimeWindows, TimeWindow,
    Trigger, TriggerContext, TriggerResult, TumblingEventTimeWindows,
    TumblingProcessingTimeWindows, WindowAssigner)


# ---------------------------------------------------------------------
# Window functions
# ---------------------------------------------------------------------

class ProcessWindowFunction(abc.ABC):
    """process(key, context, elements, out), with window metadata."""

    @abc.abstractmethod
    def process(self, key, context: "WindowContext", elements: Iterable, out) -> None:
        ...

    def clear(self, context: "WindowContext") -> None:  # noqa: B027
        pass


class WindowFunction(abc.ABC):
    """apply(key, window, inputs, out)."""

    @abc.abstractmethod
    def apply(self, key, window, inputs: Iterable, out) -> None:
        ...


class PassThroughWindowFunction(WindowFunction):
    """Emit the window's contents as they are."""

    def apply(self, key, window, inputs, out):
        out.collect(inputs)


def _processing_time(op) -> int:
    return op.processing_time_service.get_current_processing_time()


class WindowContext:
    """What a ProcessWindowFunction sees of its window."""

    def __init__(self, window, op: "WindowOperator"):
        self.window = window
        self._op = op

    def current_processing_time(self) -> int:
        return _processing_time(self._op)

    def current_watermark(self) -> int:
        return self._op.timer_service.current_watermark

    def window_state(self, descriptor: StateDescriptor):
        """Per-(key, window) state."""
        return self._op.keyed_backend.get_partitioned_state(
            self.window.to_namespace(), descriptor)

    def global_state(self, descriptor: StateDescriptor):
        """Per-key state shared across windows."""
        return self._op.keyed_backend.get_partitioned_state(VOID_NAMESPACE,
                                                            descriptor)

    def output(self, tag: OutputTag, value) -> None:
        self._op.output.collect_side(
            tag, StreamRecord(value, self.window.max_timestamp()))


class _InternalWindowFunction:
    """The user function's three shapes behind one call."""

    def __init__(self, fn, single_value: bool):
        self.fn = fn
        #: window contents are one pre-aggregated value
        self.single_value = single_value

    def process(self, key, window, op, contents, collector) -> None:
        if self.fn is None:
            collector.collect(contents)
            return
        elements = [contents] if self.single_value else contents
        if isinstance(self.fn, ProcessWindowFunction):
            self.fn.process(key, WindowContext(window, op), elements, collector)
        elif isinstance(self.fn, WindowFunction):
            self.fn.apply(key, window, elements, collector)
        else:  # a callable(key, window, elements) -> iterable
            result = self.fn(key, window, elements)
            if result is not None:
                for v in result:
                    collector.collect(v)

    def clear(self, key, window, op) -> None:
        if isinstance(self.fn, ProcessWindowFunction):
            self.fn.clear(WindowContext(window, op))


# ---------------------------------------------------------------------
# MergingWindowSet
# ---------------------------------------------------------------------

def _window(w, window_type=TimeWindow):
    """A mapping entry: a namespace tuple, or a window object with start
    and end (of either package: session snapshots store those)."""
    if isinstance(w, tuple):
        return window_type.from_namespace(w)
    return window_type(w.start, w.end)


class MergingWindowSet:
    """Per-key mapping window -> state window for merging assigners.
    When windows merge, one existing state window stays the merge
    target and the others' state folds into it, so state is never
    re-namespaced."""

    def __init__(self, mapping_state, window_type=TimeWindow):
        #: value state holding {window: state window}
        self._mapping_state = mapping_state
        m = mapping_state.value()
        self.mapping: dict = {_window(w, window_type): _window(s, window_type)
                              for w, s in m.items()} if m else {}

    def persist(self) -> None:
        # window objects, as the JAX package stores them: its operator
        # calls intersects / cover on a restored mapping's keys
        if self.mapping:
            self._mapping_state.update(dict(self.mapping))
        else:
            self._mapping_state.clear()

    def get_state_window(self, window):
        return self.mapping.get(window)

    def retire_window(self, window) -> None:
        self.mapping.pop(window, None)

    def add_window(self, new_window, merge_callback):
        """Add ``new_window``, merging every window it transitively
        intersects.  ``merge_callback(merge_result, merged_windows,
        state_window_result, merged_state_windows)`` runs when windows
        merge.  Returns the window ``new_window`` ended up in."""
        windows = list(self.mapping.keys()) + [new_window]
        merge_result = new_window
        to_merge = []
        changed = True
        while changed:
            changed = False
            for w in windows:
                if w is merge_result or w in to_merge:
                    continue
                if w.intersects(merge_result):
                    merge_result = merge_result.cover(w)
                    to_merge.append(w)
                    changed = True
        to_merge_existing = [w for w in to_merge if w in self.mapping]
        if not to_merge_existing and new_window not in self.mapping:
            # a new window that overlaps none: its own state window
            self.mapping[new_window] = new_window
            return new_window
        if not to_merge_existing:
            return new_window  # the same window again
        # the first existing window's state window is the target
        state_window_result = self.mapping[to_merge_existing[0]]
        merged_state_windows = []
        for w in to_merge_existing:
            sw = self.mapping.pop(w)
            if sw != state_window_result:
                merged_state_windows.append(sw)
        self.mapping[merge_result] = state_window_result
        merged_windows = to_merge_existing + (
            [new_window] if new_window not in to_merge_existing else [])
        # no callback when the new window lies inside one existing
        # window and nothing else merged
        if len(to_merge_existing) > 1 or (
                merge_result != to_merge_existing[0]) or merged_state_windows:
            if merge_result not in to_merge_existing or merged_state_windows:
                merge_callback(merge_result, merged_windows,
                               state_window_result, merged_state_windows)
        return merge_result


# ---------------------------------------------------------------------
# WindowOperator
# ---------------------------------------------------------------------

class _WindowTriggerContext(TriggerContext):
    def __init__(self, op: "WindowOperator"):
        self._op = op
        self.window = None

    def register_event_time_timer(self, time):
        self._op.timer_service.register_event_time_timer(
            self.window.to_namespace(), time)

    def register_processing_time_timer(self, time):
        self._op.timer_service.register_processing_time_timer(
            self.window.to_namespace(), time)

    def delete_event_time_timer(self, time):
        self._op.timer_service.delete_event_time_timer(
            self.window.to_namespace(), time)

    def delete_processing_time_timer(self, time):
        self._op.timer_service.delete_processing_time_timer(
            self.window.to_namespace(), time)

    def get_current_watermark(self):
        return self._op.timer_service.current_watermark

    def get_current_processing_time(self):
        return _processing_time(self._op)

    def get_partitioned_state(self, descriptor):
        """Trigger state, scoped to (key, window)."""
        return self._op.keyed_backend.get_partitioned_state(
            self.window.to_namespace(), descriptor)

    #: the windows a merge folds into ``window``, set around on_merge
    merged_windows = ()

    def merge_partitioned_state(self, descriptor):
        """Fold the merged windows' trigger state into the merge
        result's namespace."""
        state = self._op.keyed_backend.get_or_create_keyed_state(descriptor)
        if hasattr(state, "merge_namespaces"):
            state.merge_namespaces(
                self.window.to_namespace(),
                [w.to_namespace() for w in self.merged_windows])


class _AssignerContext:
    def __init__(self, op: "WindowOperator"):
        self._op = op

    def get_current_processing_time(self):
        return _processing_time(self._op)


class WindowOperator(AbstractUdfStreamOperator):
    """One-input keyed window operator."""

    MAPPING_STATE_NAME = "window-merge-mapping"

    #: False pins the per-timer fire even where the batched sweep applies
    batch_fires = True

    def __init__(self, assigner: WindowAssigner,
                 state_descriptor: StateDescriptor, window_function=None,
                 trigger: Optional[Trigger] = None, allowed_lateness: int = 0,
                 late_data_tag: Optional[OutputTag] = None,
                 single_value_contents: Optional[bool] = None):
        super().__init__(window_function)
        self.assigner = assigner
        self.state_descriptor = state_descriptor
        self.trigger = trigger or assigner.get_default_trigger()
        if allowed_lateness < 0:
            raise ValueError("allowed lateness must be >= 0")
        if assigner.is_merging() and not self.trigger.can_merge():
            raise ValueError(f"trigger {self.trigger!r} cannot merge but "
                             f"assigner {assigner!r} is a merging assigner")
        self.allowed_lateness = allowed_lateness
        self.late_data_tag = late_data_tag
        if single_value_contents is None:
            single_value_contents = isinstance(
                state_descriptor,
                (ReducingStateDescriptor, AggregatingStateDescriptor))
        self._internal_fn = _InternalWindowFunction(window_function,
                                                    single_value_contents)
        self.num_late_records_dropped = 0

    # ---- lifecycle --------------------------------------------------
    def open(self):
        super().open()
        if self.keyed_backend is None:
            raise ValueError("WindowOperator needs a keyed state backend "
                             "(a key selector)")
        self._batch_demote_reason = self._batch_eligibility()
        # processing-time tumbling/sliding windows under the default
        # trigger: every timer is the window's fire and its cleanup
        self._proc_batch = (
            isinstance(self.assigner, (TumblingProcessingTimeWindows,
                                       SlidingProcessingTimeWindows))
            and type(self.trigger) is type(self.assigner.get_default_trigger()))
        self._emit_batch_hist = None
        if self.metrics is not None:
            # eager, so monitoring sees the zero; a fresh attempt starts
            # from zero (restart replays must not accumulate)
            self.metrics.counter("numLateRecordsDropped").count = 0
            self._emit_batch_hist = self.metrics.histogram("emitBatchSize")
        self.window_state = self.keyed_backend.get_or_create_keyed_state(
            self.state_descriptor)
        self.trigger_ctx = _WindowTriggerContext(self)
        self.assigner_ctx = _AssignerContext(self)
        self.collector = TimestampedCollector(self.output)
        if self.assigner.is_merging():
            self._mapping_desc = ValueStateDescriptor(self.MAPPING_STATE_NAME)

    # ---- element path -----------------------------------------------
    def process_element(self, record: StreamRecord):
        windows = self.assigner.assign_windows(
            record.value, record.timestamp, self.assigner_ctx)
        skipped = True
        if self.assigner.is_merging():
            skipped = self._process_merging(record, windows, skipped)
        else:
            for window in windows:
                if self._is_window_late(window):
                    continue
                skipped = False
                self._add_and_trigger(record, window)
        if skipped and self._is_element_late(record):
            self._late(record)

    def _state_value(self, record: StreamRecord):
        """What goes into window state for one record (the evicting
        operator stores (timestamp, value) pairs)."""
        return record.value

    def _add_and_trigger(self, record: StreamRecord, window) -> None:
        self.window_state.set_current_namespace(window.to_namespace())
        self.window_state.add(self._state_value(record))
        if INTROSPECTION.enabled:
            INTROSPECTION.note_row(self.state_descriptor.name,
                                   self.keyed_backend.current_key,
                                   self.keyed_backend.max_parallelism)
        self.trigger_ctx.window = window
        result = self.trigger.on_element(record.value, record.timestamp,
                                         window, self.trigger_ctx)
        self._react(result, window)
        self._register_cleanup_timer(window)

    def _late(self, record: StreamRecord) -> None:
        if self.late_data_tag is not None:
            self.output.collect_side(self.late_data_tag, record)
        else:
            self.num_late_records_dropped += 1
            if self.metrics is not None:
                self.metrics.counter("numLateRecordsDropped").inc()

    # ---- batch path -------------------------------------------------
    def _batch_eligibility(self) -> Optional[str]:
        """Why this operator ingests per row, or None when
        process_batch vectorizes (decided once, at open)."""
        if self.assigner.is_merging():
            return "merging window assigner is per-row"
        if not isinstance(self.assigner,
                          (TumblingEventTimeWindows, SlidingEventTimeWindows)):
            return f"no vectorized assignment for {type(self.assigner).__name__}"
        if type(self.trigger) is not type(self.assigner.get_default_trigger()):
            return f"custom trigger {type(self.trigger).__name__} is per-row"
        return None

    def _batch_keys(self, batch, values) -> list:
        """The batch's key column as a list, the keys set_key_context
        would extract per row."""
        sel = self.key_selector
        if isinstance(sel, _FieldKeySelector) \
                and type(sel._field) is int and not batch.is_scalar:
            col = batch.cols.get(f"f{sel._field}")
            if col is not None:
                return np.asarray(col).tolist()
        return [sel.get_key(v) for v in values]

    def process_batch(self, batch) -> None:
        """Columnar ingest: assign tumbling/sliding panes for the whole
        batch in numpy, group rows by window and add each group with
        one ``backend.add_batch``.

        The watermark is fixed for the whole batch, so a window fires
        at once for all its rows in the batch (max_timestamp <=
        watermark: the allowed-lateness path) or for none.  Fire-now
        rows replay through the per-element path in row order; the
        other windows only accumulate state and register deduplicated
        timers, which commutes with the replay."""
        n = len(batch)
        if n == 0:
            return
        reason = self._batch_demote_reason
        if reason is None and (
                batch.ts is None
                or (batch.ts_mask is not None and not batch.ts_mask.all())):
            reason = "rows without event timestamps"
        if reason is None and self.key_selector is None:
            reason = "no key selector bound"
        if reason is not None:
            self._note_boxed(n, reason)
            for record in batch.to_records():
                self.set_key_context(record)
                self.process_element(record)
            return
        self._process_batch_vectorized(batch, n)
        self._note_columnar(n)

    def process_batch_fused(self, batch, last_start=None) -> None:
        """Ingest a batch whose pane starts a fused chain program
        computed on the card: ``process_batch`` without the pane
        arithmetic.  Every guard of ``process_batch`` stays armed; when
        one trips, the column is dropped and the ordinary path runs."""
        n = len(batch)
        if n == 0:
            return
        if (last_start is None
                or self._batch_demote_reason is not None
                or batch.ts is None
                or (batch.ts_mask is not None and not batch.ts_mask.all())
                or self.key_selector is None):
            self.process_batch(batch)
            return
        self._process_batch_vectorized(batch, n, last_start=last_start)
        self._note_fused(n)

    def _process_batch_vectorized(self, batch, n: int,
                                  last_start=None) -> None:
        ts = np.asarray(batch.ts, np.int64)
        values = batch.row_values()
        keys = self._batch_keys(batch, values)
        wm = self.timer_service.current_watermark
        assigner = self.assigner
        size = assigner.size
        slide = getattr(assigner, "slide", size)
        lateness = self.allowed_lateness
        state = self.window_state
        backend = self.keyed_backend
        # device states take the raw value column when the aggregate's
        # extract is the identity
        vcol = None
        agg = getattr(state, "agg", None)
        if agg is not None:
            c = agg.extract_column(batch.value_arrays())
            if isinstance(c, np.ndarray) and c.ndim == 1 and len(c) == n:
                vcol = c
        if last_start is None:
            last_start = ts - ((ts - assigner.offset) % slide)
        else:
            last_start = np.asarray(last_start, np.int64)
        npanes = -(-size // slide)  # 1 for tumbling
        assigned = np.zeros(n, bool)
        immediate = np.zeros(n, bool)
        idx_parts = []
        start_parts = []
        for p in range(npanes):
            starts = last_start - p * slide
            maxts = starts + (size - 1)
            ok = (starts > (ts - size)) & ~((maxts + lateness) <= wm)
            if not ok.any():
                continue
            assigned |= ok
            fire_now = ok & (maxts <= wm)
            immediate |= fire_now
            vi = np.nonzero(ok & ~fire_now)[0]
            if vi.size:
                idx_parts.append(vi)
                start_parts.append(starts[vi])
        if idx_parts:
            all_idx = np.concatenate(idx_parts)
            all_starts = np.concatenate(start_parts)
            # group by window, row order within a window: the state fold
            # order and same-timestamp timer order of the per-row path
            order = np.lexsort((all_idx, all_starts))
            sidx = all_idx[order]
            sstarts = all_starts[order]
            bounds = np.nonzero(np.diff(sstarts))[0] + 1
            lo = 0
            for hi in [*bounds.tolist(), len(sidx)]:
                gidx = sidx[lo:hi]
                start = int(sstarts[lo])
                lo = hi
                ns = (start, start + size)
                gkeys = [keys[i] for i in gidx]
                if vcol is not None:
                    backend.add_batch(state, gkeys, ns, vcol[gidx],
                                      pre_extracted=True)
                else:
                    backend.add_batch(state, gkeys, ns,
                                      [values[i] for i in gidx])
                # first-occurrence order: same-timestamp timers fire in
                # registration order, row order on the per-row path
                dkeys = dict.fromkeys(gkeys)
                maxt = start + size - 1
                # the trigger timer EventTimeTrigger.on_element registers
                # on CONTINUE, and the cleanup timer
                self.timer_service.register_event_time_timers_bulk(ns, maxt, dkeys)
                if maxt + lateness < MAX_TIMESTAMP:
                    self.timer_service.register_event_time_timers_bulk(
                        ns, maxt + lateness, dkeys)
        if immediate.any():
            tlist = ts.tolist()
            for i in np.nonzero(immediate)[0]:
                backend.set_current_key(keys[i])
                self._replay_immediate(values[i], tlist[i], wm)
        dropped = ~assigned & ~immediate & ((ts + lateness) <= wm)
        if dropped.any():
            if self.late_data_tag is not None:
                tlist = ts.tolist()
                for i in np.nonzero(dropped)[0]:
                    self.output.collect_side(self.late_data_tag,
                                             StreamRecord(values[i], tlist[i]))
            else:
                cnt = int(dropped.sum())
                self.num_late_records_dropped += cnt
                if self.metrics is not None:
                    self.metrics.counter("numLateRecordsDropped").inc(cnt)

    def _replay_immediate(self, value, timestamp: int, wm: int) -> None:
        """Per-element body for a row's windows already past the
        watermark; its other windows were ingested column-wise."""
        record = StreamRecord(value, timestamp)
        for window in self.assigner.assign_windows(value, timestamp,
                                                   self.assigner_ctx):
            if window.max_timestamp() > wm or self._is_window_late(window):
                continue
            self._add_and_trigger(record, window)

    def _mapping(self) -> MergingWindowSet:
        return MergingWindowSet(self.keyed_backend.get_partitioned_state(
            VOID_NAMESPACE, self._mapping_desc), self.assigner.window_type())

    def _process_merging(self, record, windows, skipped):
        merging = self._mapping()

        def on_merge(merge_result, merged_windows, state_window,
                     merged_state_windows):
            # fold the merged state windows into the surviving one (a
            # folding state cannot merge, and keeps its target's value)
            if merged_state_windows and hasattr(self.window_state,
                                                "merge_namespaces"):
                self.window_state.merge_namespaces(
                    state_window.to_namespace(),
                    [w.to_namespace() for w in merged_state_windows])
            # the trigger merges first, then the merged windows' trigger
            # state and cleanup timers go
            self.trigger_ctx.window = merge_result
            self.trigger_ctx.merged_windows = [
                w for w in merged_windows if w != merge_result]
            self.trigger.on_merge(merge_result, self.trigger_ctx)
            self.trigger_ctx.merged_windows = ()
            for w in merged_windows:
                if w == merge_result:
                    continue
                self.trigger_ctx.window = w
                self.trigger.clear(w, self.trigger_ctx)
                self._delete_cleanup_timer(w)

        for window in windows:
            actual = merging.add_window(window, on_merge)
            if self._is_window_late(actual):
                merging.retire_window(actual)
                continue
            skipped = False
            state_window = merging.get_state_window(actual)
            self.window_state.set_current_namespace(state_window.to_namespace())
            self.window_state.add(self._state_value(record))
            self.trigger_ctx.window = actual
            result = self.trigger.on_element(
                record.value, record.timestamp, actual, self.trigger_ctx)
            if TriggerResult.is_fire(result):
                contents = self._contents_for(actual, merging)
                if contents is not None:
                    self._emit(actual, contents)
            if TriggerResult.is_purge(result):
                self.window_state.clear()
            self._register_cleanup_timer(actual)
        merging.persist()
        return skipped

    # ---- timers -----------------------------------------------------
    def on_event_time(self, timer):
        window = self.assigner.window_type().from_namespace(timer.namespace)
        self.trigger_ctx.window = window
        merging = None
        if self.assigner.is_merging():
            merging = self._mapping()
            state_window = merging.get_state_window(window)
            if state_window is None:
                return  # merged away: a stale timer
            self.window_state.set_current_namespace(state_window.to_namespace())
        else:
            self.window_state.set_current_namespace(window.to_namespace())
        result = self.trigger.on_event_time(timer.timestamp, window,
                                            self.trigger_ctx)
        if TriggerResult.is_fire(result):
            contents = self.window_state.get()
            if contents is not None:
                self._emit(window, contents)
        if TriggerResult.is_purge(result):
            self.window_state.clear()
        if self.assigner.is_event_time() \
                and timer.timestamp == self._cleanup_time(window):
            self._clear_all_state(window, merging)
        if merging is not None:
            merging.persist()

    def on_processing_time(self, timer):
        window = self.assigner.window_type().from_namespace(timer.namespace)
        self.trigger_ctx.window = window
        merging = None
        if self.assigner.is_merging():
            merging = self._mapping()
            state_window = merging.get_state_window(window)
            if state_window is None:
                return  # merged away: a stale timer
            self.window_state.set_current_namespace(state_window.to_namespace())
        else:
            self.window_state.set_current_namespace(window.to_namespace())
        result = self.trigger.on_processing_time(timer.timestamp, window,
                                                 self.trigger_ctx)
        if TriggerResult.is_fire(result):
            contents = self.window_state.get()
            if contents is not None:
                self._emit(window, contents)
        if TriggerResult.is_purge(result):
            self.window_state.clear()
        if not self.assigner.is_event_time() \
                and timer.timestamp == self._cleanup_time(window):
            self._clear_all_state(window, merging)
        if merging is not None:
            merging.persist()

    # ---- batched watermark fires ------------------------------------
    def process_watermark(self, watermark) -> None:
        """Tumbling/sliding event-time windows with the default trigger
        fire through ``on_watermark_batch``; everything else through
        the per-timer drain."""
        if not self.batch_fires or getattr(
                self, "_batch_demote_reason", "unopened") is not None:
            super().process_watermark(watermark)
            return
        self.current_watermark = watermark.timestamp
        self.on_watermark_batch(watermark.timestamp)
        self.output.emit_watermark(watermark)

    def on_watermark_batch(self, watermark: int) -> None:
        """One timer sweep, the EventTimeTrigger decision as numpy, one
        ``get_batch`` of every firing (key, window), emission in pop
        order, then one ``clear_batch`` and one bulk delete of the fire
        timers.

        Same output as the per-timer loop: the default trigger neither
        writes state nor registers timers from on_event_time, distinct
        (key, window) slots are independent, and within one slot the
        fire timer (max_timestamp) pops before the cleanup timer
        (max_timestamp + lateness); with lateness 0 the two are one
        timer.  So gathering every firing slot before the batch clear
        reads what the per-timer drain read, in the same order."""
        svc = self.timer_service
        ts_col, key_col, ns_col = svc.pop_due_event_time_timers(watermark)
        n = len(ts_col)
        if n == 0:
            return
        lateness = self.allowed_lateness
        tarr = np.fromiter(ts_col, np.int64, n)
        maxts = np.fromiter((ns[1] for ns in ns_col), np.int64, n) - 1
        fire = tarr == maxts
        if lateness == 0:
            cleanup = fire
        else:
            # a cleanup timer at or after MAX_TIMESTAMP is never
            # registered, so an int64 wraparound here reads as "none"
            with np.errstate(over="ignore"):
                cleanup = tarr == maxts + lateness
        backend = self.keyed_backend
        fired_idx = np.nonzero(fire)[0]
        if fired_idx.size:
            rows = fired_idx.tolist()
            contents_col, found_mask, _ = backend.get_batch(
                self.window_state, [key_col[i] for i in rows], None,
                namespaces=[ns_col[i] for i in rows])
            emitted = self._emit_fired(rows, key_col, ns_col, contents_col,
                                       found_mask)
            if TELEMETRY.enabled and emitted:
                TELEMETRY.note_windows_fired(emitted)
        cleanup_idx = np.nonzero(cleanup)[0]
        if cleanup_idx.size:
            rows = cleanup_idx.tolist()
            backend.clear_batch(self.window_state, [key_col[i] for i in rows],
                                None, namespaces=[ns_col[i] for i in rows])
            if lateness:
                # EventTimeTrigger.clear drops the max_timestamp timer
                svc.delete_event_time_timers_bulk(
                    (int(maxts[i]), key_col[i], ns_col[i]) for i in rows)
            if isinstance(self._internal_fn.fn, ProcessWindowFunction):
                wt = self.assigner.window_type()
                for i in rows:
                    backend.set_current_key(key_col[i])
                    self._internal_fn.clear(key_col[i],
                                            wt.from_namespace(ns_col[i]), self)

    def on_processing_time_batch(self, now: int) -> bool:
        """Fire every due processing-time timer as one batch: one
        ``get_batch`` of the (key, window) slots, emission in pop order,
        one ``clear_batch``.  Taken by tumbling and sliding
        processing-time windows under the default trigger (the timer
        service's per-timer drain otherwise: returns False).  Each such
        timer is a window's max timestamp, which is both its FIRE
        (``ProcessingTimeTrigger``) and its cleanup, and the trigger
        registers nothing when it fires, so the batch reads and clears
        what the per-timer drain would, in the same order."""
        if not self.batch_fires or not self._proc_batch:
            return False
        svc = self.timer_service
        ts_col, key_col, ns_col = svc.pop_due_processing_time_timers(now)
        n = len(ts_col)
        if n == 0:
            return True
        backend = self.keyed_backend
        contents_col, found_mask, _ = backend.get_batch(
            self.window_state, key_col, None, namespaces=ns_col)
        emitted = self._emit_fired(range(n), key_col, ns_col, contents_col,
                                   found_mask)
        if TELEMETRY.enabled and emitted:
            TELEMETRY.note_windows_fired(emitted)
        backend.clear_batch(self.window_state, key_col, None,
                            namespaces=ns_col)
        if isinstance(self._internal_fn.fn, ProcessWindowFunction):
            wt = self.assigner.window_type()
            for key, ns in zip(key_col, ns_col):
                backend.set_current_key(key)
                self._internal_fn.clear(key, wt.from_namespace(ns), self)
        return True

    def _emit_fired(self, rows, key_col, ns_col, contents_col,
                    found_mask) -> int:
        """The window function over the gathered contents, in pop
        order; returns the windows that emitted.  A device gather
        returns an ndarray whose 0-d rows unbox as the per-row ``get()``
        unboxes them."""
        wt = self.assigner.window_type()
        backend = self.keyed_backend
        unbox = isinstance(contents_col, np.ndarray)
        hist = self._emit_batch_hist
        tracer = get_tracer()
        span = tracer.span("window.fire.batch")
        fired = 0
        with span:
            for j, i in enumerate(rows):
                if not found_mask[j]:
                    continue
                contents = contents_col[j]
                if unbox:
                    if np.ndim(contents) == 0:
                        contents = contents.item()
                elif contents is None:
                    continue
                window = wt.from_namespace(ns_col[i])
                backend.set_current_key(key_col[i])
                if hist is not None:
                    hist.update(len(contents)
                                if hasattr(contents, "__len__") else 1)
                self.collector.set_absolute_timestamp(window.max_timestamp())
                self._internal_fn.process(key_col[i], window, self, contents,
                                          self.collector)
                fired += 1
        return fired

    # ---- helpers ----------------------------------------------------
    def _react(self, result: int, window) -> None:
        if TriggerResult.is_fire(result):
            contents = self.window_state.get()
            if contents is not None:
                self._emit(window, contents)
        if TriggerResult.is_purge(result):
            self.window_state.clear()

    def _contents_for(self, window, merging: MergingWindowSet):
        state_window = merging.get_state_window(window)
        if state_window is None:
            return None
        self.window_state.set_current_namespace(state_window.to_namespace())
        return self.window_state.get()

    def _emit(self, window, contents) -> None:
        """Output timestamp = window.max_timestamp()."""
        if self._emit_batch_hist is not None:
            self._emit_batch_hist.update(
                len(contents) if hasattr(contents, "__len__") else 1)
        if TELEMETRY.enabled:
            # one emitted (key, window): the denominator of the
            # transfer-tax ratio
            TELEMETRY.note_windows_fired(1)
        tracer = get_tracer()
        if tracer.enabled:
            with tracer.span("window.fire"):
                self.collector.set_absolute_timestamp(window.max_timestamp())
                self._internal_fn.process(self.keyed_backend.current_key,
                                          window, self, contents,
                                          self.collector)
            return
        self.collector.set_absolute_timestamp(window.max_timestamp())
        self._internal_fn.process(self.keyed_backend.current_key, window,
                                  self, contents, self.collector)

    def _cleanup_time(self, window) -> int:
        if self.assigner.is_event_time():
            # capped at MAX_TIMESTAMP (Python ints do not wrap)
            t = window.max_timestamp() + self.allowed_lateness
            return t if t < MAX_TIMESTAMP else MAX_TIMESTAMP
        return window.max_timestamp()

    def _register_cleanup_timer(self, window) -> None:
        cleanup = self._cleanup_time(window)
        if cleanup == MAX_TIMESTAMP:
            return  # end of time (a GlobalWindow): nothing to collect
        if self.assigner.is_event_time():
            self.timer_service.register_event_time_timer(
                window.to_namespace(), cleanup)
        else:
            self.timer_service.register_processing_time_timer(
                window.to_namespace(), cleanup)

    def _delete_cleanup_timer(self, window) -> None:
        cleanup = self._cleanup_time(window)
        if cleanup == MAX_TIMESTAMP:
            return
        if self.assigner.is_event_time():
            self.timer_service.delete_event_time_timer(
                window.to_namespace(), cleanup)
        else:
            self.timer_service.delete_processing_time_timer(
                window.to_namespace(), cleanup)

    def _is_window_late(self, window) -> bool:
        return (self.assigner.is_event_time()
                and self._cleanup_time(window)
                <= self.timer_service.current_watermark)

    def _is_element_late(self, record: StreamRecord) -> bool:
        return (self.assigner.is_event_time()
                and record.timestamp is not None
                and record.timestamp + self.allowed_lateness
                <= self.timer_service.current_watermark)

    def _clear_all_state(self, window, merging: Optional[MergingWindowSet]) -> None:
        self.window_state.clear()
        self.trigger_ctx.window = window
        self.trigger.clear(window, self.trigger_ctx)
        self._internal_fn.clear(self.keyed_backend.current_key, window, self)
        if merging is not None:
            merging.retire_window(window)


# ---------------------------------------------------------------------
# EvictingWindowOperator
# ---------------------------------------------------------------------

class EvictingWindowOperator(WindowOperator):
    """Keeps the raw (timestamp, value) pairs of a window in list state
    and runs the evictor before (and after) the window function."""

    #: every fire goes through ``_emit``, which runs the evictor and the
    #: pre-aggregator; the batched sweeps call the window function alone
    batch_fires = False

    def __init__(self, assigner, window_function, trigger=None,
                 evictor=None, allowed_lateness=0, late_data_tag=None,
                 pre_aggregator=None):
        if evictor is None:
            raise ValueError("EvictingWindowOperator requires an evictor")
        super().__init__(assigner,
                         ListStateDescriptor("window-contents-evicting"),
                         window_function, trigger, allowed_lateness,
                         late_data_tag, single_value_contents=False)
        self.evictor = evictor
        #: the raw elements must stay, so a reduce / aggregate / fold
        #: runs at fire time over the elements the evictor kept
        self.pre_aggregator = pre_aggregator
        if pre_aggregator is not None:
            self._internal_fn = _InternalWindowFunction(window_function,
                                                        single_value=True)

    def _batch_eligibility(self) -> Optional[str]:
        return "evictor retains raw per-row elements"

    def _state_value(self, record: StreamRecord):
        # the pair lets a time evictor see each element's timestamp; the
        # record itself still goes to the trigger and the late output
        return (record.timestamp, record.value)

    def _emit(self, window, contents) -> None:
        elements: List[Tuple[int, Any]] = list(contents)
        now = (self.timer_service.current_watermark
               if self.assigner.is_event_time() else _processing_time(self))
        kept = self.evictor.evict_before(elements, len(elements), window, now)
        self.collector.set_absolute_timestamp(window.max_timestamp())
        key = self.keyed_backend.current_key
        values = [v for _, v in kept]
        if self.pre_aggregator is not None:
            if values:
                self._internal_fn.process(key, window, self,
                                          self.pre_aggregator(values),
                                          self.collector)
        else:
            self._internal_fn.process(key, window, self, values,
                                      self.collector)
        after = self.evictor.evict_after(kept, len(kept), window, now)
        # the survivors are the window's contents from here on
        self.window_state.update([(ts, v) for ts, v in after])
