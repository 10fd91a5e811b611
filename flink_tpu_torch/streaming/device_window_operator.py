"""DeviceWindowOperator: the device window engine inside the job graph
(port of ``flink_tpu/streaming/device_window_operator.py:46-54, 148-417``).

Records buffer on the host; every ``flush_batch`` records (and every
watermark that crosses a window-end boundary) flushes one vectorized
``process_batch`` into the engine, and watermarks fire windows whose
results leave through the standard output with the scalar operator's
timestamp contract (window.max_timestamp).

Engine choice (``engine_for_assigner``) is the device-resident scatter
tier for every key type: ``VectorizedTumblingWindows``,
``VectorizedSlidingWindows`` (size a multiple of the slide, offset 0)
or ``VectorizedSessionWindows``.  The JAX package sends integer keys
(and interned string keys) to its log-structured tier and
string-keyed float sums to a fused C++ tier; those, and the mesh
engines, are later slices of the port.
"""

from __future__ import annotations

from typing import Any, List

import numpy as np

from flink_tpu_torch.device import DeviceLike, resolve_device
from flink_tpu_torch.ops.device_agg import DeviceAggregateFunction
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


def engine_for_assigner(assigner, agg: DeviceAggregateFunction,
                        initial_capacity: int = 1 << 14,
                        device: DeviceLike = None):
    """Assigner → device engine, or None when no engine applies."""
    if not assigner_supported(assigner):
        return None
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


def batch_window_eligible(assigner, allowed_lateness, late_tag,
                          window_function) -> bool:
    """The reference's gate, at graph construction, for its vectorized
    window tiers: the device engines for a DeviceAggregateFunction, the
    generic tier for any other aggregate (tumbling, sliding with size %
    slide == 0, session; default trigger, lateness 0, no late-data
    tag): the assigners the port's device engines cover
    (``assigner_supported``)."""
    if allowed_lateness != 0 or late_tag is not None:
        return False
    if window_function is not None and not callable(window_function):
        return False
    return assigner_supported(assigner)


class DeviceWindowOperator(StreamOperator):
    """Batched, device-backed window operator for the eligible aggregate
    path.  The key selector is applied per record at buffer time (the
    operator is its own keyed state)."""

    def __init__(self, assigner, aggregate_function: DeviceAggregateFunction,
                 window_function=None, flush_batch: int = 8192,
                 initial_capacity: int = 1 << 14, device: DeviceLike = None):
        super().__init__()
        self.assigner = assigner
        self.agg = aggregate_function
        self.window_function = window_function
        self.flush_batch = flush_batch
        self.initial_capacity = initial_capacity
        self.device = resolve_device(device)
        self.engine = None
        self._keys: List[Any] = []
        self._ts: List[int] = []
        self._values: List[Any] = []
        self._last_fireable = None
        self.num_late_records_dropped = 0

    # ---- lifecycle --------------------------------------------------
    def open(self):
        if not assigner_supported(self.assigner):
            raise ValueError(
                f"no device engine for assigner {self.assigner!r}")
        self.collector = TimestampedCollector(self.output)

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

    def _ensure_engine(self):
        if self.engine is not None:
            return
        self.engine = engine_for_assigner(self.assigner, self.agg,
                                          self.initial_capacity, self.device)
        # fast-forward a lazily created engine to the operator's
        # watermark: records behind it count as late
        if self.current_watermark > -(2 ** 63):
            self.engine.advance_watermark(self.current_watermark)

    def _flush_buffer(self):
        if not self._keys:
            return
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
        self._ensure_engine()
        self.engine.process_batch(np.asarray(self._keys),
                                  np.asarray(self._ts, np.int64), vals)
        self._keys.clear()
        self._ts.clear()
        self._values.clear()

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
            self.engine.advance_watermark(wm)
            self._emit_from(before)
            self.num_late_records_dropped = self.engine.num_late_dropped
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
        fn = self.window_function
        for key, result, w_start, w_end in emitted[start_idx:]:
            self.collector.set_absolute_timestamp(w_end - 1)
            if fn is None:
                self.collector.collect(result)
            else:
                out = fn(key, TimeWindow(w_start, w_end), [result])
                if out is not None:
                    for v in out:
                        self.collector.collect(v)
        # delivered results leave the buffer
        del emitted[start_idx:]
