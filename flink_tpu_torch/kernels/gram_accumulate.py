"""``gram_accumulate``: the per-row Gram matrices and right-hand sides
of one ALS half-step (kernel ``csrc/gram_accumulate.cu``).

Replaces the two segment sums of ``flink_tpu/ml/recommendation.py``
``ALS.fit.solve_side`` (:52-63).  The ratings come grouped by row
(``rating_csr``: a stable sort), and the kernel's work comes as a plan
(``gram_plan``: each row's ratings cut into chunks of at most
``CHUNK_RATINGS``); both are set-up done once per fit and side.
``gram_accumulate_plain`` is the same function in plain PyTorch, which
materializes the outer products ``[chunk, f, f]`` a block of ratings
at a time (all at once they would be ``[nnz, f, f]``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from flink_tpu_torch.kernels import loader

#: the largest factor count the kernel takes
MAX_FACTORS = 64
#: most ratings in one chunk of a plan (a warp's or a block's work)
CHUNK_RATINGS = 2048


class GramPlan(NamedTuple):
    """The kernel's work over one CSR rating matrix: every row's ratings
    cut into chunks of at most ``width``, in row order, a chunk never
    crossing a row, an empty row one empty chunk.

    ``row`` int32 [chunks]: each chunk's row; ``span`` int64 [chunks,
    2]: its ratings ``[lo, hi)``; ``part`` int32 [chunks]: its slot of
    partial sums when its row has several chunks, else -1; ``split_row``
    int32 [split]: the rows of several chunks; ``split_ptr`` int32
    [split + 1]: their partial slots ``split_ptr[s] .. split_ptr[s + 1]``
    (consecutive, in chunk order); ``n_rows``, ``nnz`` (ratings) and
    ``partials`` (slots) as ints; ``indptr``: the tensor it was built
    from (held, so that no other tensor takes its memory while the plan
    lives: the wrapper takes the plan only with that tensor)."""
    row: torch.Tensor
    span: torch.Tensor
    part: torch.Tensor
    split_row: torch.Tensor
    split_ptr: torch.Tensor
    n_rows: int
    nnz: int
    partials: int
    width: int
    indptr: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.span.device


def rating_csr(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
               n_rows: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ratings grouped by row, each row's in their given order:
    (indptr int64 [n_rows + 1], cols int32, vals float32)."""
    order = torch.sort(rows, stable=True).indices
    indptr = torch.zeros(n_rows + 1, dtype=torch.int64, device=rows.device)
    torch.cumsum(torch.bincount(rows, minlength=n_rows), 0, out=indptr[1:])
    return (indptr, cols.index_select(0, order).to(torch.int32).contiguous(),
            vals.index_select(0, order).to(torch.float32).contiguous())


def gram_plan(indptr: torch.Tensor, width: int = CHUNK_RATINGS) -> GramPlan:
    """The plan of ``gram_accumulate`` over the rows ``indptr`` (int64
    [rows + 1], as ``rating_csr`` gives it), built with tensor ops on
    its device."""
    if indptr.dim() != 1 or indptr.numel() < 1 or indptr.dtype != torch.int64:
        raise ValueError("indptr must be int64 [rows + 1]")
    if width < 1:
        raise ValueError(f"chunks of {width} ratings")
    dev = indptr.device
    n_rows = indptr.numel() - 1
    count = indptr[1:] - indptr[:-1]
    per_row = torch.clamp((count + width - 1) // width, min=1)
    first = torch.cumsum(per_row, 0) - per_row
    split = torch.nonzero(per_row > 1).flatten()
    n_chunks, partials, nnz = torch.stack(
        [per_row.sum(), per_row[split].sum(), indptr[-1]]).tolist()
    if n_chunks >= 2 ** 31:
        raise ValueError(f"{n_chunks} chunks: a plan holds fewer than 2^31")
    row = torch.repeat_interleave(torch.arange(n_rows, device=dev), per_row,
                                  output_size=n_chunks)
    k = torch.arange(n_chunks, device=dev) - first[row]
    lo = indptr[:-1][row] + k * width
    hi = torch.minimum(lo + width, indptr[1:][row])
    several = per_row[row] > 1
    part = torch.where(several, torch.cumsum(several, 0) - 1, -1)
    split_ptr = torch.zeros(len(split) + 1, dtype=torch.int32, device=dev)
    torch.cumsum(per_row[split], 0, out=split_ptr[1:])
    return GramPlan(row.to(torch.int32), torch.stack([lo, hi], 1).contiguous(),
                    part.to(torch.int32), split.to(torch.int32), split_ptr,
                    n_rows, nnz, partials, width, indptr)


def gram_accumulate(fixed: torch.Tensor, indptr: torch.Tensor,
                    cols: torch.Tensor, vals: torch.Tensor,
                    plan: Optional[GramPlan] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(G float32 [rows, f, f], b float32 [rows, f]) with
    ``G[r] = sum_c fixed[c] fixed[c]^T`` and ``b[r] = sum_c v_c fixed[c]``
    over the ratings ``indptr[r] <= c < indptr[r + 1]`` of row r.  On the
    card the kernel works on ``plan``, which must be ``gram_plan`` of this
    very ``indptr`` tensor (built here when None)."""
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
    if plan is None:
        plan = gram_plan(indptr)
    if plan.device != dev:
        raise ValueError(f"the plan is on {plan.device}, fixed on {dev}")
    if plan.n_rows != n_rows or plan.nnz != len(cols):
        raise ValueError(f"the plan covers {plan.n_rows} rows and {plan.nnz} "
                         f"ratings, the matrix {n_rows} and {len(cols)}")
    if plan.indptr.data_ptr() != indptr.data_ptr():
        raise ValueError("the plan was built from another indptr tensor")
    if fixed.data_ptr() % 16:
        fixed = fixed.clone()       # the kernel loads factor rows as vectors
    grams = torch.empty((n_rows, f, f), dtype=torch.float32, device=dev)
    rhs = torch.empty((n_rows, f), dtype=torch.float32, device=dev)
    partial = torch.empty(plan.partials * (f * (f + 1) // 2 + f),
                          dtype=torch.float32, device=dev)
    if n_rows > 0:
        loader.launch("gram_accumulate", "ft_gram_accumulate", fixed.data_ptr(),
                      cols.data_ptr(), vals.data_ptr(), plan.row.data_ptr(),
                      plan.span.data_ptr(), plan.part.data_ptr(), len(plan.row),
                      plan.split_row.data_ptr(), plan.split_ptr.data_ptr(),
                      len(plan.split_row), f, partial.data_ptr(),
                      grams.data_ptr(), rhs.data_ptr())
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
