"""Host → device link probe for the log tier's finish choice (port of
``flink_tpu/ops/link_probe.py``).

The log engines' window fire can run its dense estimate phase in C++
on the host or as one kernel on the card (``finish_tier="auto"``,
``streaming/log_windows.py``).  Which one is faster depends on how the
card is attached: the device finish ships the compacted cells to the
card and the estimates back.  This module measures the host → device
copy rate once per device, with plain ``torch`` copies of staged sizes
(no kernel is built or launched), and recommends a tier by the JAX
package's rule: the device finish from ``DEVICE_FINISH_MIN_H2D_GBPS``
up, the host finish below it, and always the host finish when the
"device" is the CPU (the copies are memcpy on the same silicon).
"""

from __future__ import annotations

import time
from typing import Dict

import torch

from flink_tpu_torch.device import DeviceLike, resolve_device

#: host → device rate from which the device-side finish is recommended
#: (the JAX package's constant, kept so both packages decide alike)
DEVICE_FINISH_MIN_H2D_GBPS = 4.0

_PROBE_BYTES = 8 << 20

#: str(device) -> measurements, resolved once per process
_cache: Dict[str, Dict[str, float]] = {}


def _measure(dev: torch.device) -> Dict[str, float]:
    if dev.type == "cpu":
        return {"h2d_gbps": float("inf"), "cpu": 1.0}
    # warm the copy path (context creation, the allocator)
    torch.zeros(4096, dtype=torch.uint8).to(dev)
    torch.cuda.synchronize(dev)

    def best_of(nbytes: int, reps: int) -> float:
        buf = torch.zeros(nbytes, dtype=torch.uint8)
        best = 0.0
        for _ in range(reps):
            t0 = time.perf_counter()
            arr = buf.to(dev)
            torch.cuda.synchronize(dev)
            best = max(best, nbytes / (time.perf_counter() - t0) / 1e9)
            del arr
        return best

    # staged payloads, as the JAX package stages them: a slow link pays
    # little probing, a fast one escalates until the payload amortizes
    # the per-copy overhead; best of three per stage
    h2d = best_of(_PROBE_BYTES // 8, 3)
    if h2d > 0.2:
        h2d = max(h2d, best_of(_PROBE_BYTES, 3))
    if h2d > DEVICE_FINISH_MIN_H2D_GBPS / 4:
        h2d = max(h2d, best_of(8 * _PROBE_BYTES, 3))
    return {"h2d_gbps": h2d, "cpu": 0.0}


def measure(device: DeviceLike = None) -> Dict[str, float]:
    """Link measurements of ``device``, taken once per process:
    {h2d_gbps, cpu}."""
    dev = resolve_device(device)
    key = str(dev)
    if key not in _cache:
        _cache[key] = _measure(dev)
    return _cache[key]


def recommended_finish_tier(device: DeviceLike = None) -> str:
    """"host" or "device" for the log engines' fire finish on
    ``device``."""
    m = measure(device)
    if m["cpu"]:
        return "host"
    return "device" if m["h2d_gbps"] >= DEVICE_FINISH_MIN_H2D_GBPS else "host"
