"""``hll_log_finish``: the log tier's HLL fire finish over compacted
cells (kernel ``csrc/hll_log_finish.cu``).

Replaces ``flink_tpu/streaming/log_windows.py``
``_HllMode._device_finish.finish``.  Input: the compacted ranks of a
window (``native.hll_log_compact``, one cell per present register of
each key) and the exclusive end of each key's run.  Output: per key the
float64 estimate, equal to the C++ host fire's bit for bit (see the
kernel source for why).  Given an ``inv_sum`` array, the call also
writes ``(m - present) + sum 2^-rank`` per key there, for checks of the
exact sums; the fire passes none.  ``hll_log_finish_plain`` is the same
function in plain PyTorch.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from flink_tpu_torch.kernels import loader

_LOG_TABLES: Dict[Tuple[int, object], torch.Tensor] = {}
_U8, _I32, _F64 = (torch.uint8,), (torch.int32,), (torch.float64,)


def log_table(m: int, device) -> torch.Tensor:
    """float64 [m + 1]: ``log z`` for 1 <= z <= m from the C library's
    ``log`` (the function the C++ host fire calls); entry 0 is unused.
    Cached per (m, device)."""
    key = (m, device)
    tab = _LOG_TABLES.get(key)
    if tab is None:
        vals = [0.0] + [math.log(z) for z in range(1, m + 1)]
        tab = torch.tensor(vals, dtype=torch.float64).to(device)
        _LOG_TABLES[key] = tab
    return tab


#: rank bytes a call takes, at most (the kernel's positions are 32-bit)
MAX_CELLS = (1 << 31) - 64


def _check_m(m: int) -> None:
    if m < 16 or m & (m - 1) or m > 1 << 16:
        raise ValueError(f"m must be a power of two in [16, 65536], got {m}")


def hll_log_finish(ranks: torch.Tensor, ends: torch.Tensor, m: int,
                   alpha: float,
                   inv_sum: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The float64 estimate [n_keys] of key runs ``ranks[ends[k-1]:ends[k]]``
    (uint8 ranks in [0, 33], int32 exclusive ends); each key's inv_sum
    goes to ``inv_sum`` (float64 [n_keys]) when given.  On the card, one
    launch."""
    if ranks.device.type == "cpu":
        return hll_log_finish_plain(ranks, ends, m, alpha, inv_sum)
    _check_m(m)
    dev = ranks.device
    n_keys, n_cells = ends.numel(), ranks.numel()   # not len(): a Python-level call
    if inv_sum is None:
        loader.check_all(ranks, (ranks, "ranks", _U8, 1), (ends, "ends", _I32, 1))
    else:
        loader.check_all(ranks, (ranks, "ranks", _U8, 1), (ends, "ends", _I32, 1),
                         (inv_sum, "inv_sum", _F64, 1))
        if inv_sum.numel() != n_keys:
            raise ValueError(f"inv_sum holds {inv_sum.numel()} keys, expected {n_keys}")
    if n_cells > MAX_CELLS:
        raise ValueError(f"hll_log_finish takes at most {MAX_CELLS} rank bytes, "
                         f"got {n_cells}")
    est = torch.empty(n_keys, dtype=torch.float64, device=dev)
    if n_keys == 0:
        return est
    loader.launch("hll_log_finish", "ft_hll_log_finish", ranks.data_ptr(),
                  ends.data_ptr(), n_keys, n_cells, m, alpha * m * m,
                  log_table(m, dev).data_ptr(), est.data_ptr(), loader.ptr(inv_sum))
    return est


def hll_log_finish_plain(ranks: torch.Tensor, ends: torch.Tensor, m: int,
                         alpha: float,
                         inv_sum: Optional[torch.Tensor] = None) -> torch.Tensor:
    _check_m(m)
    dev = ranks.device
    e = ends.to(torch.int64)
    present = e - torch.cat([e.new_zeros(1), e[:-1]])
    key_of_cell = torch.repeat_interleave(
        torch.arange(len(e), device=dev), present)
    n_cells = len(key_of_cell)
    # 2^-rank from exponent bits: exact, as in the kernel
    terms = ((1023 - ranks[:n_cells].to(torch.int64)) << 52).view(torch.float64)
    seg = torch.zeros(len(e), dtype=torch.float64, device=dev)
    seg.index_add_(0, key_of_cell, terms)
    mf = float(m)
    zeros = mf - present.to(torch.float64)
    sums = zeros + seg
    if inv_sum is not None:
        inv_sum.copy_(sums)
    # a true division (a Python scalar over a tensor would multiply by
    # the reciprocal, one rounding more)
    est = torch.full_like(sums, alpha * m * m) / sums
    tab = log_table(m, dev)
    linear = mf * (tab[m] - tab[(m - present).clamp(1, m)])
    return torch.where((est <= 2.5 * mf) & (zeros > 0), linear, est)
