"""float32 min / max in the reference's order, for the plain versions of
``scatter_combine`` and ``merge_rows`` (their kernels share
``csrc/float_order.cuh``).

The reference's ``.at[].min/max`` and ``jax.ops.segment_min/max`` (XLA
on the CPU) propagate NaN and order -0 below +0, whatever the row
order; ``torch.minimum`` and ``scatter_reduce_`` let the first of two
zeros win.  Here every float32 is mapped to an int32 key whose order is
that of the reference, the keys are reduced, and the winners mapped
back: a NaN keys to the op's extreme (back as 0xFFFFFFFF for min and
0x7FFFFFFF for max, the NaNs the kernels store), every other value
keeps its bits.  Only the places whose key changed are
written, so a state keeps its own bits, the payload of a NaN included,
where nothing beats it.
"""

from __future__ import annotations

import torch

#: the key of every NaN: the op's extreme (it maps back to the NaN the
#: kernels store, 0xFFFFFFFF for min and 0x7FFFFFFF for max)
_KEY = {"min": -(1 << 31), "max": (1 << 31) - 1}


def keys(x: torch.Tensor, op: str) -> torch.Tensor:
    """int32 keys of float32 ``x`` in the reference's order for ``op``."""
    b = x.contiguous().view(torch.int32)
    k = b ^ ((b >> 31) & 0x7FFFFFFF)
    return torch.where(torch.isnan(x), _KEY[op], k)


def from_keys(k: torch.Tensor) -> torch.Tensor:
    """float32 values of keys (a NaN key gives the op's stored NaN)."""
    return (k ^ ((k >> 31) & 0x7FFFFFFF)).view(torch.float32)


def write_changed(out: torch.Tensor, old: torch.Tensor,
                  new: torch.Tensor) -> None:
    """out[i] = from_keys(new[i]) where the key moved; out holds the
    values whose keys are ``old``."""
    moved = new != old
    out[moved] = from_keys(new[moved])
