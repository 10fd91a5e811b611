"""``hll_estimate``: per-slot HLL estimate (kernel ``csrc/hll_estimate.cu``).

Replaces ``flink_tpu/streaming/vectorized.py`` ``_jit_result_all`` /
``_result_contig`` / ``_jit_result`` ->
``flink_tpu/ops/sketches.py`` ``HyperLogLogAggregate._estimate``.
One kernel serves the dense form (every row of ``regs``; a contiguous
range is a row slice) and the gathered form (``slots``).  ``hll_estimate_plain`` is the same function
in plain PyTorch; it tiles the rows, because an untiled float32
``[S, m]`` intermediate of a 5 GB register file would take 20 GB.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from flink_tpu_torch.kernels import loader
from flink_tpu_torch.ops.slot_index import gather_rows

#: rows per tile of the plain version (x m float32 + int32 intermediates)
PLAIN_TILE = 1 << 16


def alpha_m2(alpha: float, m: int) -> float:
    """(alpha * m) * m rounded to float32 at each step, as the
    reference's float32 expression ``alpha * m * m`` computes it."""
    mf = np.float32(m)
    return float(np.float32(np.float32(alpha) * mf) * mf)


def hll_estimate(regs: torch.Tensor, alpha: float,
                 slots: Optional[torch.Tensor] = None) -> torch.Tensor:
    """float32 estimate per row: rows ``slots`` (gathered form; a
    negative slot wraps once, then clamps, as ``ops.slot_index`` says)
    or every row of ``regs`` (dense form)."""
    if regs.device.type == "cpu":
        return hll_estimate_plain(regs, alpha, slots)
    dev = regs.device
    if slots is None:
        loader.check(regs, "regs", (torch.uint8,), dev, ndim=2)
    else:
        loader.check_all(regs, (regs, "regs", (torch.uint8,), 2),
                         (slots, "slots", (torch.int32,), 1))
    c, m = regs.shape
    if m < 16 or m & (m - 1):
        raise ValueError(f"register rows must be a power of two >= 16, got {m}")
    if regs.data_ptr() % 16:
        raise ValueError("regs must be 16-byte aligned")
    rows = c if slots is None else len(slots)
    if rows and c == 0:
        raise ValueError("slots into a file of no rows")
    out = torch.empty(rows, dtype=torch.float32, device=dev)
    if rows == 0:
        return out
    loader.launch("hll_estimate", "ft_hll_estimate", regs.data_ptr(),
                  loader.ptr(slots), rows, m, c, alpha_m2(alpha, m),
                  out.data_ptr())
    return out


def hll_estimate_plain(regs: torch.Tensor, alpha: float,
                       slots: Optional[torch.Tensor] = None,
                       tile: int = PLAIN_TILE) -> torch.Tensor:
    m = regs.shape[1]
    rows = regs.shape[0] if slots is None else len(slots)
    out = torch.empty(rows, dtype=torch.float32, device=regs.device)
    am2 = torch.tensor(alpha_m2(alpha, m), dtype=torch.float32)
    mf = torch.tensor(float(m), dtype=torch.float32)
    # correctly rounded float32 logs, as the kernel computes them
    log_m = torch.tensor(float(np.float32(np.log(float(m)))), dtype=torch.float32)
    for i in range(0, rows, tile):
        j = min(rows, i + tile)
        if slots is None:
            r = regs[i:j]
        else:
            r = regs[gather_rows(slots[i:j], regs.shape[0])]
        r = r.to(torch.int32)
        inv = ((127 - r) << 23).view(torch.float32)
        est = am2 / inv.sum(dim=-1)
        zeros = (r == 0).sum(dim=-1).to(torch.float32)
        log_z = torch.log(torch.clamp(zeros, min=1.0).to(torch.float64))
        linear = mf * (log_m - log_z.to(torch.float32))
        out[i:j] = torch.where((est <= 2.5 * mf) & (zeros > 0), linear, est)
    return out
