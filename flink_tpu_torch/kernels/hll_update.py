"""``hll_update``: HLL register scatter-max (kernel ``csrc/hll_update.cu``).

Replaces ``flink_tpu/streaming/vectorized.py`` ``make_masked_update``
-> ``flink_tpu/ops/sketches.py`` ``HyperLogLogAggregate.update``.  What
bounds it on the card and what the design does about it is in the
kernel source.  ``hll_update_plain`` is the same function in plain
PyTorch: the CPU path, and the version the kernel is held against.
"""

from __future__ import annotations

import torch

from flink_tpu_torch.kernels import loader
from flink_tpu_torch.ops.hashing import hll_register_and_rank

_LANE = (torch.int32, torch.uint32)
_REG = (torch.int16, torch.uint16, torch.int32, torch.uint32)


def _precision(regs: torch.Tensor) -> int:
    m = regs.shape[1]
    if m < 16 or m & (m - 1):
        raise ValueError(f"register rows must be a power of two >= 16, got {m}")
    return m.bit_length() - 1


def hll_update(regs: torch.Tensor, slots: torch.Tensor, hi: torch.Tensor,
               lo: torch.Tensor, n: int) -> None:
    """In place: ``regs[slots[i], reg_i] = max(regs[...], rank_i)`` for
    rows ``i < n``.  Raw form: ``hi``/``lo`` are the value hash's 32-bit
    lanes (``uint32`` or an ``int32`` view).  Compressed form: ``hi`` is
    the ``uint8`` rank and ``lo`` the register (16 or 32 bits)."""
    if regs.device.type == "cpu":
        hll_update_plain(regs, slots, hi, lo, n)
        return
    _precision(regs)
    dev = regs.device
    loader.check(regs, "regs", (torch.uint8,), dev, ndim=2)
    loader.check(slots, "slots", (torch.int32,), dev, ndim=1)
    compressed = hi.dtype == torch.uint8
    loader.check(hi, "hi", (torch.uint8,) if compressed else _LANE, dev, 1)
    loader.check(lo, "lo", _REG if compressed else _LANE, dev, 1)
    if not (0 <= n <= min(len(slots), len(hi), len(lo))):
        raise ValueError(f"n={n} exceeds the {len(slots)} rows given")
    if n == 0:
        return
    c, m = regs.shape
    if compressed:
        loader.launch("hll_update", "ft_hll_update_compressed",
                      regs.data_ptr(), slots.data_ptr(), hi.data_ptr(),
                      lo.data_ptr(), lo.element_size(), n, m, c)
    else:
        loader.launch("hll_update", "ft_hll_update_raw", regs.data_ptr(),
                      slots.data_ptr(), hi.data_ptr(), lo.data_ptr(), n, m, c)


def hll_update_plain(regs: torch.Tensor, slots: torch.Tensor,
                     hi: torch.Tensor, lo: torch.Tensor, n: int) -> None:
    c, m = regs.shape
    p = _precision(regs)
    slots = slots[:n].to(torch.int64)
    if hi.dtype == torch.uint8:
        rank = hi[:n].to(torch.int64)
        bits = lo.element_size() * 8
        reg = (lo[:n].to(torch.int64) & ((1 << bits) - 1)) & (m - 1)
    else:
        reg, rank = hll_register_and_rank(hi[:n], lo[:n], p)
        reg, rank = reg.to(torch.int64), rank.to(torch.int64)
    keep = (slots >= 0) & (slots < c) & (rank > 0)
    idx = slots[keep] * m + reg[keep]
    regs.view(-1).scatter_reduce_(0, idx, rank[keep].to(torch.uint8), "amax")
