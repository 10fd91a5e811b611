"""Operator test harness (port of ``flink_tpu/streaming/harness.py``,
the one-input harness).

Hosts one operator in a fake task: a ``CollectorOutput``, a keyed-state
backend from ``load_state_backend`` when a key selector is given, and a
``TestProcessingTimeService``.  Push records, batches and watermarks,
snapshot and restore, and read what the operator emitted.  The backend
runs on ``device`` (the card unless ``device="cpu"``).
"""

from __future__ import annotations

from typing import Any, List, Optional

from flink_tpu_torch.core.functions import as_key_selector
from flink_tpu_torch.core.keygroups import KeyGroupRange
from flink_tpu_torch.device import DeviceLike
from flink_tpu_torch.state.loader import load_state_backend
from flink_tpu_torch.streaming.elements import StreamRecord, Watermark
from flink_tpu_torch.streaming.operators import CollectorOutput, StreamOperator
from flink_tpu_torch.streaming.timers import TestProcessingTimeService


class OneInputStreamOperatorTestHarness:
    def __init__(self, operator: StreamOperator, key_selector=None,
                 state_backend="heap", max_parallelism: int = 128,
                 key_group_range: Optional[KeyGroupRange] = None,
                 device: DeviceLike = None, **backend_kwargs):
        self.operator = operator
        self.output = CollectorOutput()
        self.processing_time_service = TestProcessingTimeService()
        self.max_parallelism = max_parallelism
        if key_group_range is None:
            key_group_range = KeyGroupRange(0, max_parallelism - 1)
        self.keyed_backend = None
        if key_selector is not None:
            key_selector = as_key_selector(key_selector)
            self.keyed_backend = load_state_backend(
                state_backend, key_group_range, max_parallelism,
                device=device, **backend_kwargs)
        operator.setup(self.output, keyed_backend=self.keyed_backend,
                       processing_time_service=self.processing_time_service,
                       key_selector=key_selector,
                       max_parallelism=max_parallelism)
        self._open = False

    # ---- lifecycle --------------------------------------------------
    def open(self) -> None:
        self.operator.open()
        self._open = True

    def close(self) -> None:
        if self._open:
            self.operator.close()
            self._open = False

    # ---- drive ------------------------------------------------------
    def process_element(self, value, timestamp: Optional[int] = None) -> None:
        record = (value if isinstance(value, StreamRecord)
                  else StreamRecord(value, timestamp))
        self.operator.set_key_context(record)
        self.operator.process_element(record)

    def process_batch(self, batch) -> None:
        """Feed a RecordBatch to the operator's columnar path."""
        self.operator.process_batch(batch)

    def process_watermark(self, timestamp) -> None:
        wm = timestamp if isinstance(timestamp, Watermark) else Watermark(timestamp)
        self.operator.process_watermark(wm)

    def set_processing_time(self, now: int) -> None:
        self.processing_time_service.set_current_time(now)

    # ---- snapshot / restore -----------------------------------------
    def snapshot(self) -> dict:
        return self.operator.snapshot_state()

    def initialize_state(self, snapshots) -> None:
        if isinstance(snapshots, dict):
            snapshots = [snapshots]
        self.operator.restore_state(snapshots)

    # ---- inspect ----------------------------------------------------
    def get_output(self) -> List[StreamRecord]:
        return self.output.records

    def extract_output_values(self) -> List[Any]:
        return [r.value for r in self.output.records]

    def get_side_output(self, tag) -> List[StreamRecord]:
        return self.output.side.get(getattr(tag, "tag_id", tag), [])

