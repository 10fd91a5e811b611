"""``table_insert``: batched insert-or-lookup into the device hash
table (kernel ``csrc/table_insert.cu``).

Replaces ``flink_tpu/ops/device_table.py`` ``insert_or_lookup_impl``
and ``insert_or_lookup_regions_impl``.  The table is three arrays:
``key_hi``, ``key_lo`` (uint32 lanes, or int32 views of their bits) and
``occupied`` (uint8, 0/1).  ``table_insert_plain`` is the same function
in plain PyTorch: it replays the JAX package's claim rounds (gather,
scatter-min of the record index into a claim array, winners write,
losers and duplicates re-check), so on the CPU its table equals the
JAX table position for position.  The kernel claims by compare-and-swap
and bounds probe positions where the plain version bounds rounds (see
the kernel source); on the card the two are compared as key -> slot
maps.
"""

from __future__ import annotations

from typing import Optional

import torch

from flink_tpu_torch.kernels import loader
from flink_tpu_torch.ops.hashing import fmix32

_LANE = (torch.int32, torch.uint32)
_M32 = 0xFFFFFFFF


def _check_occupied(occupied: torch.Tensor, capacity: int) -> None:
    """The kernel claims a position with a CAS of the 32-bit word that
    holds its byte: the array must start 4-byte aligned and its
    allocation must cover the last word."""
    if occupied.data_ptr() % 4:
        raise ValueError("occupied must be 4-byte aligned")
    room = occupied.untyped_storage().nbytes() - occupied.storage_offset()
    if room < (capacity + 3) // 4 * 4:
        raise ValueError("occupied's allocation must cover capacity rounded "
                         "up to a multiple of 4 bytes (see make_table)")


def table_insert(key_hi: torch.Tensor, key_lo: torch.Tensor,
                 occupied: torch.Tensor, h_hi: torch.Tensor,
                 h_lo: torch.Tensor, n: int, max_probes: int = 64,
                 mask: Optional[torch.Tensor] = None,
                 region: Optional[torch.Tensor] = None, region_size: int = 0,
                 overflow: Optional[torch.Tensor] = None) -> torch.Tensor:
    """In place on the table: resolve rows ``i < n`` (and ``mask[i]``)
    of the key lanes ``h_hi``/``h_lo`` to table positions, inserting
    new keys.  Returns int32 slots [len(h_hi)], -1 for padding and for
    rows that overflowed; the count of the latter is added to
    ``overflow`` (int64 [1]) when given.  With ``region``, row i probes
    only inside ``[region[i] * region_size, (region[i] + 1) *
    region_size)``."""
    if key_hi.device.type == "cpu":
        return table_insert_plain(key_hi, key_lo, occupied, h_hi, h_lo, n,
                                  max_probes, mask, region, region_size,
                                  overflow)
    dev = key_hi.device
    capacity = len(key_hi)
    loader.check(key_hi, "key_hi", _LANE, dev, ndim=1)
    loader.check(key_lo, "key_lo", _LANE, dev, ndim=1)
    loader.check(occupied, "occupied", (torch.uint8,), dev, ndim=1)
    if len(key_lo) != capacity or len(occupied) != capacity:
        raise ValueError("key_hi, key_lo and occupied must have one length")
    if not 0 < capacity < 1 << 31:
        raise ValueError(f"capacity {capacity} outside [1, 2^31)")
    _check_occupied(occupied, capacity)
    loader.check(h_hi, "h_hi", _LANE, dev, ndim=1)
    loader.check(h_lo, "h_lo", _LANE, dev, ndim=1)
    rows = len(h_hi)
    if len(h_lo) != rows or not 0 <= n <= rows:
        raise ValueError(f"n={n} outside the {rows} rows given")
    if mask is not None:
        loader.check(mask, "mask", (torch.bool, torch.uint8), dev, ndim=1)
        if len(mask) != rows:
            raise ValueError("mask must have one entry per row")
    if region is not None:
        loader.check(region, "region", (torch.int32,), dev, ndim=1)
        if len(region) != rows or not 0 < region_size <= capacity \
                or capacity % region_size:
            raise ValueError("region needs one entry per row and a "
                             "region_size that divides capacity")
    if overflow is not None:
        loader.check(overflow, "overflow", (torch.int64,), dev, ndim=1)
    if max_probes < 1:
        raise ValueError("max_probes must be >= 1")
    slots = torch.empty(rows, dtype=torch.int32, device=dev)
    if rows == 0:
        return slots
    loader.launch("table_insert", "ft_table_insert", key_hi.data_ptr(),
                  key_lo.data_ptr(), occupied.data_ptr(), capacity,
                  h_hi.data_ptr(), h_lo.data_ptr(), loader.ptr(mask),
                  loader.ptr(region), region_size if region is not None else 0,
                  n, rows, max_probes, slots.data_ptr(), loader.ptr(overflow))
    return slots


def table_insert_plain(key_hi: torch.Tensor, key_lo: torch.Tensor,
                       occupied: torch.Tensor, h_hi: torch.Tensor,
                       h_lo: torch.Tensor, n: int, max_probes: int = 64,
                       mask: Optional[torch.Tensor] = None,
                       region: Optional[torch.Tensor] = None,
                       region_size: int = 0,
                       overflow: Optional[torch.Tensor] = None) -> torch.Tensor:
    dev = key_hi.device
    capacity = len(key_hi)
    rows = len(h_hi)
    idx = torch.arange(rows, device=dev)
    live = idx < n
    if mask is not None:
        live &= mask.to(torch.bool)
    hi = h_hi.to(torch.int64) & _M32
    lo = h_lo.to(torch.int64) & _M32
    base = fmix32(lo ^ ((hi * 0x9E3779B9) & _M32))
    if region is not None:
        modulus, offset = region_size, region.to(torch.int64) * region_size
    else:
        modulus, offset = capacity, 0
    t_hi = key_hi.view(torch.int32) if key_hi.dtype == torch.uint32 else key_hi
    t_lo = key_lo.view(torch.int32) if key_lo.dtype == torch.uint32 else key_lo
    w_hi = h_hi.view(torch.int32) if h_hi.dtype == torch.uint32 else h_hi
    w_lo = h_lo.view(torch.int32) if h_lo.dtype == torch.uint32 else h_lo
    probe = torch.zeros(rows, dtype=torch.int64, device=dev)
    slots = torch.full((rows,), -1, dtype=torch.int64, device=dev)
    resolved = torch.zeros(rows, dtype=torch.bool, device=dev)
    for _ in range(max_probes):
        active = ~resolved & live
        if not bool(active.any()):
            break
        pos = offset + ((base + probe) & _M32) % modulus
        occ = occupied[pos] != 0
        match = active & occ & (t_hi[pos] == w_hi) & (t_lo[pos] == w_lo)
        # claim empty positions: the lowest record index wins
        want = active & ~occ
        claim = torch.full((capacity,), rows, dtype=torch.int64, device=dev)
        claim.scatter_reduce_(0, pos[want], idx[want], "amin")
        won = want & (claim[pos] == idx)
        wp = pos[won]
        t_hi[wp] = w_hi[won]
        t_lo[wp] = w_lo[won]
        occupied[wp] = 1
        now = match | won
        slots = torch.where(now, pos, slots)
        # advance only past a position held by a different key (losers
        # of the claim and duplicates re-check the same position)
        probe += (active & occ & ~match).to(torch.int64)
        resolved |= now
    if overflow is not None:
        overflow += (live & ~resolved).sum()
    return slots.to(torch.int32)
