"""``quantile_result``: per-slot quantiles of a histogram file (kernel
``csrc/quantile_result.cu``).

Replaces ``flink_tpu/ops/sketches.py`` ``QuantileSketchAggregate.result``
(gathered form) and the ``result_dense`` the reference defaults through
it (``flink_tpu/ops/device_agg.py:121-130``; dense form), reached
through the window engines' fires.  ``quantile_result_plain`` is the
same function in plain PyTorch (float32 cumsum, argmax of
``cum >= target``); it tiles the rows, because a float32 copy of a
large gathered block would double its bytes.
"""

from __future__ import annotations

from typing import Optional

import torch

from flink_tpu_torch.kernels import loader
from flink_tpu_torch.ops.slot_index import gather_rows

#: rows per tile of the plain version
PLAIN_TILE = 1 << 16
#: most quantiles one launch answers (the kernel's kMaxQ)
MAX_Q = 16


def quantile_result(hist: torch.Tensor, qs: torch.Tensor,
                    bucket_val: torch.Tensor,
                    slots: Optional[torch.Tensor] = None) -> torch.Tensor:
    """float32 ``[rows, Q]``: for each row (``slots``, read by
    ``ops.slot_index``'s rule, or every row of ``hist``) and quantile
    ``qs[k]``, ``bucket_val`` at the first bucket whose cumulative count
    reaches ``max(qs[k] * total, 1)``, or ``bucket_val[0]`` when none
    does (an empty row)."""
    if hist.device.type == "cpu":
        return quantile_result_plain(hist, qs, bucket_val, slots)
    dev = hist.device
    loader.check(hist, "hist", (torch.int32,), dev, ndim=2)
    loader.check(qs, "qs", (torch.float32,), dev, ndim=1)
    loader.check(bucket_val, "bucket_val", (torch.float32,), dev, ndim=1)
    c, b = hist.shape
    if len(bucket_val) != b:
        raise ValueError(f"{len(bucket_val)} bucket values for {b} buckets")
    nq = len(qs)
    if not 1 <= nq <= MAX_Q:
        raise ValueError(f"between 1 and {MAX_Q} quantiles, got {nq}")
    if slots is not None:
        loader.check(slots, "slots", (torch.int32,), dev, ndim=1)
    rows = c if slots is None else len(slots)
    if rows and c == 0:
        raise ValueError("slots into a file of no rows")
    out = torch.empty((rows, nq), dtype=torch.float32, device=dev)
    if rows:
        loader.launch("quantile_result", "ft_quantile_result", hist.data_ptr(),
                      loader.ptr(slots), rows, b, c, qs.data_ptr(), nq,
                      bucket_val.data_ptr(), out.data_ptr())
    return out


def quantile_result_plain(hist: torch.Tensor, qs: torch.Tensor,
                          bucket_val: torch.Tensor,
                          slots: Optional[torch.Tensor] = None,
                          tile: int = PLAIN_TILE) -> torch.Tensor:
    c = hist.shape[0]
    rows = c if slots is None else len(slots)
    out = torch.empty((rows, len(qs)), dtype=torch.float32, device=hist.device)
    for i in range(0, rows, tile):
        j = min(rows, i + tile)
        if slots is None:
            h = hist[i:j]
        else:
            h = hist[gather_rows(slots[i:j], c)]
        cum = torch.cumsum(h.to(torch.float32), dim=-1)
        total = cum[:, -1:]
        for k in range(len(qs)):
            target = torch.clamp_min(qs[k] * total, 1.0)
            sel = torch.argmax((cum >= target).to(torch.uint8), dim=-1)
            out[i:j, k] = bucket_val[sel]
    return out
