"""State-backend selection from the ``state.backend`` name or a
``Configuration`` (port of ``flink_tpu/state/loader.py``): only this
switch changes between the heap and device deployments.

  heap | jobmanager | filesystem | memory | hashmap  -> HeapKeyedStateBackend
  gpu | tpu | rocksdb | device | hbm                 -> GpuKeyedStateBackend

The JAX package's device names select the GPU backend, so a job's
``state.backend`` value carries over unchanged.  From a Configuration
the loader also reads ``state.backend.tpu.max-device-slots`` and
``state.backend.tpu.microbatch-size`` (each must be > 0).  The GPU
backend takes ``device`` (the card unless ``device="cpu"``).
"""

from __future__ import annotations

from flink_tpu_torch.core.config import Configuration
from flink_tpu_torch.core.keygroups import KeyGroupRange
from flink_tpu_torch.device import DeviceLike
from flink_tpu_torch.state.backend import KeyedStateBackend
from flink_tpu_torch.state.gpu_backend import GpuKeyedStateBackend
from flink_tpu_torch.state.heap_backend import HeapKeyedStateBackend

STATE_BACKEND_KEY = "state.backend"

_HEAP_NAMES = {"heap", "jobmanager", "filesystem", "memory", "hashmap"}
_GPU_NAMES = {"gpu", "tpu", "rocksdb", "device", "hbm"}
_POSITIVE_KEYS = {"state.backend.tpu.max-device-slots": "max_device_slots",
                  "state.backend.tpu.microbatch-size": "microbatch"}


def load_state_backend(config_or_name, key_group_range: KeyGroupRange,
                       max_parallelism: int, device: DeviceLike = None,
                       **kwargs) -> KeyedStateBackend:
    if isinstance(config_or_name, Configuration):
        name = config_or_name.get_string(STATE_BACKEND_KEY, "heap")
        for key, kwarg in _POSITIVE_KEYS.items():
            if config_or_name.contains(key):
                value = config_or_name.get_integer(key)
                if value is None or value <= 0:
                    raise ValueError(f"{key} must be > 0 (got {value}); omit "
                                     "it for the built-in default")
                kwargs.setdefault(kwarg, value)
    elif config_or_name is None:
        name = "heap"
    else:
        name = str(config_or_name)
    name = name.lower()
    if name in _HEAP_NAMES:
        return HeapKeyedStateBackend(key_group_range, max_parallelism)
    if name in _GPU_NAMES:
        return GpuKeyedStateBackend(key_group_range, max_parallelism,
                                    device=device, **kwargs)
    raise ValueError(f"unknown state backend {name!r}; expected one of "
                     f"{sorted(_HEAP_NAMES | _GPU_NAMES)}")
