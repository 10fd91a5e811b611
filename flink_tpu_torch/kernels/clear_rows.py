"""``clear_rows``: fill rows of a state component with its fill value
(kernel ``csrc/clear_rows.cu``).

Replaces ``flink_tpu/streaming/vectorized.py`` ``_jit_clear`` /
``_clear_contig`` and the full re-init after a full-arena fire, and the
fills of ``flink_tpu/ops/device_agg.py`` ``init_state`` /
``grow_state`` / ``clear_slots``.  ``clear_rows_plain`` is the same
function in plain PyTorch.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from flink_tpu_torch.kernels import loader


def _pattern(comp: torch.Tensor, fill) -> bytes:
    np_dtype = torch.empty(0, dtype=comp.dtype).numpy().dtype
    return np.array([fill], dtype=np_dtype).tobytes()


def clear_rows(comp: torch.Tensor, fill, slots: Optional[torch.Tensor] = None,
               start: int = 0, count: Optional[int] = None) -> None:
    """In place: every row ``comp[s]`` for ``s`` in ``slots`` (list
    form), or rows ``start .. start + count`` (range form; default to
    the end), becomes ``fill``."""
    if comp.device.type == "cpu":
        clear_rows_plain(comp, fill, slots, start, count)
        return
    dev = comp.device
    if not comp.is_contiguous() or comp.dim() < 1:
        raise ValueError("state component must be contiguous with a row axis")
    c = comp.shape[0]
    if slots is not None:
        loader.check(slots, "slots", (torch.int32,), dev, ndim=1)
        rows = len(slots)
    else:
        rows = c - start if count is None else count
        if not (0 <= start and 0 <= rows and start + rows <= c):
            raise ValueError(f"rows [{start}, {start + rows}) outside [0, {c})")
    if rows == 0:
        return
    pat = _pattern(comp, fill)
    row_bytes = comp.element_size() * math.prod(comp.shape[1:])
    width = next(w for w in (16, 8, 4, 1)
                 if w % len(pat) == 0 and row_bytes % w == 0
                 and comp.data_ptr() % w == 0)
    word = (pat * (width // len(pat))).ljust(16, b"\0")
    lo = int.from_bytes(word[:8], "little")
    hi = int.from_bytes(word[8:], "little")
    loader.launch("clear_rows", "ft_clear_rows", comp.data_ptr(),
                  loader.ptr(slots), rows if slots is not None else 0,
                  start, rows, row_bytes // width, c, width, lo, hi)


def clear_rows_plain(comp: torch.Tensor, fill,
                     slots: Optional[torch.Tensor] = None, start: int = 0,
                     count: Optional[int] = None) -> None:
    if slots is not None:
        idx = slots.to(torch.int64)
        comp[idx[(idx >= 0) & (idx < comp.shape[0])]] = fill
    else:
        end = comp.shape[0] if count is None else start + count
        comp[start:end].fill_(fill)
