"""``gram_accumulate``: the per-row Gram matrices and right-hand sides
of one ALS half-step (kernel ``csrc/gram_accumulate.cu``).

Replaces the two segment sums of ``flink_tpu/ml/recommendation.py``
``ALS.fit.solve_side`` (:52-63).  The ratings come grouped by row
(``rating_csr``: a stable sort, set-up done once per fit and side).
``gram_accumulate_plain`` is the same function in plain PyTorch, which
materializes the outer products ``[chunk, f, f]`` a block of ratings
at a time (all at once they would be ``[nnz, f, f]``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from flink_tpu_torch.kernels import loader

#: the largest factor count the kernel takes
MAX_FACTORS = 64


def rating_csr(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
               n_rows: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ratings grouped by row, each row's in their given order:
    (indptr int64 [n_rows + 1], cols int32, vals float32)."""
    order = torch.sort(rows, stable=True).indices
    indptr = torch.zeros(n_rows + 1, dtype=torch.int64, device=rows.device)
    torch.cumsum(torch.bincount(rows, minlength=n_rows), 0, out=indptr[1:])
    return (indptr, cols.index_select(0, order).to(torch.int32).contiguous(),
            vals.index_select(0, order).to(torch.float32).contiguous())


def gram_accumulate(fixed: torch.Tensor, indptr: torch.Tensor,
                    cols: torch.Tensor,
                    vals: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(G float32 [rows, f, f], b float32 [rows, f]) with
    ``G[r] = sum_c fixed[c] fixed[c]^T`` and ``b[r] = sum_c v_c fixed[c]``
    over the ratings ``indptr[r] <= c < indptr[r + 1]`` of row r."""
    if fixed.device.type == "cpu":
        return gram_accumulate_plain(fixed, indptr, cols, vals)
    dev = fixed.device
    loader.check(fixed, "fixed", (torch.float32,), dev, ndim=2)
    loader.check(indptr, "indptr", (torch.int64,), dev, ndim=1)
    loader.check(cols, "cols", (torch.int32,), dev, ndim=1)
    loader.check(vals, "vals", (torch.float32,), dev, ndim=1)
    f = fixed.shape[1]
    if not 1 <= f <= MAX_FACTORS:
        raise ValueError(f"gram_accumulate takes 1 to {MAX_FACTORS} factors, "
                         f"got {f}")
    if len(cols) != len(vals):
        raise ValueError(f"cols has {len(cols)} ratings, vals {len(vals)}")
    n_rows = len(indptr) - 1
    grams = torch.empty((n_rows, f, f), dtype=torch.float32, device=dev)
    rhs = torch.empty((n_rows, f), dtype=torch.float32, device=dev)
    if n_rows > 0:
        loader.launch("gram_accumulate", "ft_gram_accumulate", fixed.data_ptr(),
                      indptr.data_ptr(), cols.data_ptr(), vals.data_ptr(),
                      n_rows, f, grams.data_ptr(), rhs.data_ptr())
    return grams, rhs


#: floats of outer products the plain version materializes at a time
_BLOCK_FLOATS = 1 << 26


def gram_accumulate_plain(fixed: torch.Tensor, indptr: torch.Tensor,
                          cols: torch.Tensor, vals: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    n_rows, f = len(indptr) - 1, fixed.shape[1]
    dev = fixed.device
    rows = torch.repeat_interleave(torch.arange(n_rows, device=dev),
                                   indptr[1:] - indptr[:-1])
    grams = torch.zeros((n_rows, f, f), dtype=fixed.dtype, device=dev)
    rhs = torch.zeros((n_rows, f), dtype=fixed.dtype, device=dev)
    step = max(1, _BLOCK_FLOATS // (f * f))
    for i in range(0, len(cols), step):
        vc = fixed.index_select(0, cols[i:i + step])
        grams.index_add_(0, rows[i:i + step], vc[:, :, None] * vc[:, None, :])
        rhs.index_add_(0, rows[i:i + step], vals[i:i + step, None] * vc)
    return grams, rhs
