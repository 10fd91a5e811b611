"""``quantile_update``: log-bucket histogram add (kernel
``csrc/quantile_update.cu``).

Replaces ``flink_tpu/ops/sketches.py``
``QuantileSketchAggregate._bucket_of`` and ``.update`` (through
``flink_tpu/streaming/vectorized.py`` ``make_masked_update`` and
``streaming/vectorized_sessions.py`` ``_jit_update``).
``quantile_update_plain`` is the same function in plain PyTorch, in
the same float32 steps; ``bucket_of`` is its bucket computation.
"""

from __future__ import annotations

import numpy as np
import torch

from flink_tpu_torch.kernels import loader


def bucket_of(values: torch.Tensor, min_value: float, log_gamma: float,
              offset: int, buckets: int) -> torch.Tensor:
    """int64 bucket per value: ``clamp(1 + floor(log(max(v, min)) /
    log_gamma) - offset, 1, B - 1)``, 0 where ``v <= min``; every step
    in float32 (the floor converts saturating, NaN to 0, as the
    kernel's ``__float2int_rz``)."""
    v = values.to(torch.float32)
    mn = torch.tensor(np.float32(min_value), device=v.device)
    lg = torch.tensor(np.float32(log_gamma), device=v.device)
    logs = torch.log(torch.maximum(v, mn)) / lg
    f = torch.nan_to_num(torch.floor(logs).to(torch.float64), nan=0.0)
    b = 1 + f.clamp(-2.0**31, 2.0**31 - 1).to(torch.int64) - int(offset)
    b = b.clamp(1, buckets - 1)
    return torch.where(v <= mn, torch.zeros_like(b), b)


def quantile_update(hist: torch.Tensor, slots: torch.Tensor,
                    values: torch.Tensor, n: int, min_value: float,
                    log_gamma: float, offset: int) -> None:
    """In place: ``hist[slots[i], bucket_of(values[i])] += 1`` for rows
    ``i < n``."""
    if hist.device.type == "cpu":
        quantile_update_plain(hist, slots, values, n, min_value, log_gamma,
                              offset)
        return
    dev = hist.device
    loader.check(hist, "hist", (torch.int32,), dev, ndim=2)
    loader.check(slots, "slots", (torch.int32,), dev, ndim=1)
    loader.check(values, "values", (torch.float32,), dev, ndim=1)
    if not (0 <= n <= min(len(slots), len(values))):
        raise ValueError(f"n={n} exceeds the {len(slots)} rows given")
    if n == 0:
        return
    c, b = hist.shape
    loader.launch("quantile_update", "ft_quantile_update", hist.data_ptr(),
                  slots.data_ptr(), values.data_ptr(), n, b, c,
                  float(np.float32(min_value)), float(np.float32(log_gamma)),
                  int(offset))


def quantile_update_plain(hist: torch.Tensor, slots: torch.Tensor,
                          values: torch.Tensor, n: int, min_value: float,
                          log_gamma: float, offset: int) -> None:
    c, nb = hist.shape
    s = slots[:n].to(torch.int64)
    b = bucket_of(values[:n], min_value, log_gamma, offset, nb)
    keep = (s >= 0) & (s < c)
    idx = s[keep] * nb + b[keep]
    hist.view(-1).index_add_(0, idx, torch.ones_like(idx, dtype=hist.dtype))
