"""Keyed state backends behind the ``state.backend`` switch, and
operator state (port of ``flink_tpu/state``):

  heap  host dict tables, per-record semantics
  gpu   aggregation state as struct-of-arrays in device memory, updated
        by micro-batched kernel launches (``tpu`` and the reference's
        other device names select it too)
"""

from flink_tpu_torch.state.backend import (KeyedStateBackend,
                                           KeyedStateSnapshot,
                                           snapshot_from_chunks)
from flink_tpu_torch.state.gpu_backend import GpuKeyedStateBackend
from flink_tpu_torch.state.heap_backend import HeapKeyedStateBackend
from flink_tpu_torch.state.loader import load_state_backend
from flink_tpu_torch.state.operator_state import OperatorStateBackend

__all__ = [
    "KeyedStateBackend",
    "KeyedStateSnapshot",
    "GpuKeyedStateBackend",
    "HeapKeyedStateBackend",
    "OperatorStateBackend",
    "load_state_backend",
    "snapshot_from_chunks",
]
