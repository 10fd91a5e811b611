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
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from flink_tpu_torch.kernels import loader

_WORDS: Dict[tuple, Tuple[int, int, int]] = {}


def fill_word(dtype: torch.dtype, fill, row_bytes: int,
              align: int) -> Tuple[int, int, int]:
    """``(width, lo, hi)`` for the kernel: the widest store ``width`` in
    (16, 8, 4, 2, 1) bytes that the element pattern, ``row_bytes`` and
    the base's alignment ``align`` (its address mod 16) allow, and the
    little-endian 16-byte word ``(lo, hi)`` holding ``fill`` as numpy
    casts it to ``dtype``, repeated to ``width`` bytes, zero above.
    Cached per argument tuple (a float fill keyed by its bits, so -0.0
    is not 0.0)."""
    key = (dtype, float(fill).hex() if isinstance(fill, (float, np.floating))
           else fill, row_bytes, align)
    word = _WORDS.get(key)
    if word is None:
        np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
        pat = np.array([fill], dtype=np_dtype).tobytes()
        width = next(w for w in (16, 8, 4, 2, 1)
                     if w % len(pat) == 0 and row_bytes % w == 0
                     and align % w == 0)
        b = (pat * (width // len(pat))).ljust(16, b"\0")
        word = (width, int.from_bytes(b[:8], "little"),
                int.from_bytes(b[8:], "little"))
        if len(_WORDS) >= 4096:
            _WORDS.clear()
        _WORDS[key] = word
    return word


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
    row_bytes = comp.element_size() * math.prod(comp.shape[1:])
    base = comp.data_ptr()
    width, lo, hi = fill_word(comp.dtype, fill, row_bytes, base % 16)
    loader.launch("clear_rows", "ft_clear_rows", base, loader.ptr(slots),
                  rows if slots is not None else 0, start, rows,
                  row_bytes // width, c, width, lo, hi)


def clear_rows_plain(comp: torch.Tensor, fill,
                     slots: Optional[torch.Tensor] = None, start: int = 0,
                     count: Optional[int] = None) -> None:
    if slots is not None:
        idx = slots.to(torch.int64)
        comp[idx[(idx >= 0) & (idx < comp.shape[0])]] = fill
    else:
        end = comp.shape[0] if count is None else start + count
        comp[start:end].fill_(fill)
