"""The reference's rule for a slot that reads a state row.

JAX indexes as numpy does: a negative slot ``s`` becomes ``s + C`` once,
and a gather then clamps the index into ``[0, C)``.  So of ``C`` rows,
slot -1 reads row ``C - 1``, and a slot below ``-C`` or at or beyond
``C`` reads row 0 or row ``C - 1``.  The port's reads follow that rule.

Its writes do not: a scatter of the reference wraps a slot in
``[-C, -1]`` the same way and drops only what still lies outside
``[0, C)``, but every reference caller masks negative slots before an
update, and the port's scatters (``update``, ``merge_slots``) skip every
slot outside ``[0, C)``, -1 being their skip mark.
"""

from __future__ import annotations

import torch


def gather_rows(slots: torch.Tensor, c: int) -> torch.Tensor:
    """int64 rows in ``[0, c)``: a negative slot wrapped once, then
    clamped (the gathering kernels' plain versions)."""
    s = slots.to(torch.int64)
    return torch.where(s < 0, s + c, s).clamp(0, c - 1)


def torch_index(slots: torch.Tensor, c: int) -> torch.Tensor:
    """int64 ``slots`` clamped into ``[-c, c - 1]``: torch's indexing
    wraps a slot in ``[-c, -1]`` itself, so indexing ``c`` rows with this
    reads the reference's row (one elementwise op beyond the int64 index
    that torch's indexing makes anyway)."""
    return slots.to(torch.int64).clamp(-c, c - 1)
