"""Device-resident hash table: batched insert-or-lookup on the card
(port of ``flink_tpu/ops/device_table.py``).

A linear-probing open-addressing table whose keys are 64-bit values
stored as (hi, lo) uint32 lanes, with an occupancy byte per position
(key (0, 0) is a valid key).  Slot = table position, so the table is
the slot allocator of the state arrays beside it.  A batch resolves in
one ``table_insert`` launch (``kernels/table_insert.py``); on the CPU
the plain version replays the JAX package's claim rounds, so there the
table equals the JAX table position for position.

One difference from the JAX package: ``max_probes`` bounds probe
positions in the kernel and claim rounds in the JAX package, so near
overflow the two may disagree on which keys overflow (both report each
overflow and resolve at most ``capacity`` keys).

Lanes live in int32 tensors (views of the uint32 bits, as the port
keeps every unsigned 32-bit column); the table is updated in place
where the JAX package donates and returns a new one.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from flink_tpu_torch.device import DeviceLike, resolve_device
from flink_tpu_torch.kernels import clear_rows, table_insert
from flink_tpu_torch.ops.hashing import fmix32
from flink_tpu_torch.runtime.tracing import traced_call


class DeviceHashTable(NamedTuple):
    key_hi: torch.Tensor    # [C] int32 (uint32 bits)
    key_lo: torch.Tensor    # [C] int32 (uint32 bits)
    occupied: torch.Tensor  # [C] uint8, 0/1


def make_table(capacity: int, device: DeviceLike = None) -> DeviceHashTable:
    """An empty table of ``capacity`` positions on ``device`` (the card
    unless ``device="cpu"``).  The occupancy array's allocation is
    rounded up to whole 32-bit words, which the kernel's claim needs."""
    dev = resolve_device(device)
    occ = torch.zeros((capacity + 3) // 4 * 4, dtype=torch.uint8, device=dev)
    return DeviceHashTable(
        key_hi=torch.zeros(capacity, dtype=torch.int32, device=dev),
        key_lo=torch.zeros(capacity, dtype=torch.int32, device=dev),
        occupied=occ[:capacity])


def _lane(x, device: torch.device) -> torch.Tensor:
    """Key lanes as an int32 (or uint32) tensor on ``device``; numpy
    lanes travel as int32 views of their uint32 bits."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x, np.uint32).view(np.int32)).to(device)


def _mask(mask, n: int, device: torch.device) -> torch.Tensor:
    if mask is None:
        return torch.ones(n, dtype=torch.bool, device=device)
    if isinstance(mask, torch.Tensor):
        return mask.to(device=device, dtype=torch.bool)
    return torch.from_numpy(np.asarray(mask, bool)).to(device)


def insert_or_lookup_impl(table: DeviceHashTable, h_hi, h_lo, mask=None,
                          max_probes: int = 64
                          ) -> Tuple[DeviceHashTable, torch.Tensor, torch.Tensor]:
    """Resolve key lanes ``h_hi``/``h_lo`` [N] to table positions,
    inserting new keys (``mask`` False = padding).  Returns (table,
    slots[N] int32, ok[N] bool); ok is False where the probe limit was
    hit (the table is overfull), and slots is -1 there and on padding."""
    dev = table.key_hi.device
    hi, lo = _lane(h_hi, dev), _lane(h_lo, dev)
    m = _mask(mask, len(hi), dev)
    slots = table_insert(table.key_hi, table.key_lo, table.occupied, hi, lo,
                         len(hi), max_probes, mask=m)
    return table, slots, (slots >= 0) | ~m


#: eager PyTorch has no separate traced entry point
insert_or_lookup = traced_call(insert_or_lookup_impl,
                               "table.insert_or_lookup")


def insert_or_lookup_regions_impl(table: DeviceHashTable, h_hi, h_lo, region,
                                  mask, region_size: int, max_probes: int = 64
                                  ) -> Tuple[DeviceHashTable, torch.Tensor,
                                             torch.Tensor]:
    """Regional insert-or-lookup: record i probes only inside region
    ``region[i]`` (position = region * region_size + (base + probe) %
    region_size).  Same return contract as ``insert_or_lookup_impl``."""
    dev = table.key_hi.device
    hi, lo = _lane(h_hi, dev), _lane(h_lo, dev)
    m = _mask(mask, len(hi), dev)
    reg = (region.to(device=dev, dtype=torch.int32)
           if isinstance(region, torch.Tensor)
           else torch.from_numpy(np.asarray(region, np.int32)).to(dev))
    slots = table_insert(table.key_hi, table.key_lo, table.occupied, hi, lo,
                         len(hi), max_probes, mask=m, region=reg,
                         region_size=region_size)
    return table, slots, (slots >= 0) | ~m


insert_or_lookup_regions = insert_or_lookup_regions_impl


def _clear_entries_impl(table: DeviceHashTable, slots) -> DeviceHashTable:
    """Free table positions (``occupied[slots] = False``, one
    ``clear_rows`` launch over the 1-byte rows).  As in the JAX package
    a point delete leaves no tombstone: the probe chain re-inserts a key
    whose position was freed on its next touch."""
    dev = table.key_hi.device
    s = (slots.to(device=dev, dtype=torch.int32) if isinstance(slots, torch.Tensor)
         else torch.from_numpy(np.asarray(slots, np.int32)).to(dev))
    clear_rows(table.occupied, 0, slots=s)
    return table


clear_entries = traced_call(_clear_entries_impl, "table.clear")


def table_to_numpy(table: DeviceHashTable):
    """(key_hi uint32, key_lo uint32, occupied bool) on the host — the
    JAX table's layout, for snapshots and tests."""
    return (table.key_hi.cpu().numpy().view(np.uint32),
            table.key_lo.cpu().numpy().view(np.uint32),
            table.occupied.cpu().numpy().astype(bool))


def table_from_numpy(key_hi, key_lo, occupied,
                     device: DeviceLike = None) -> DeviceHashTable:
    """A table holding these host arrays (the inverse of
    ``table_to_numpy``; accepts the JAX table's arrays)."""
    table = make_table(len(key_hi), device)
    dev = table.key_hi.device
    table.key_hi.copy_(torch.from_numpy(
        np.array(key_hi, np.uint32).view(np.int32)).to(dev))
    table.key_lo.copy_(torch.from_numpy(
        np.array(key_lo, np.uint32).view(np.int32)).to(dev))
    table.occupied.copy_(torch.from_numpy(
        np.asarray(occupied, bool).astype(np.uint8)).to(dev))
    return table


def _chain_base(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """Each key's probe-chain start, before the modulus:
    ``fmix32(lo ^ hi * 0x9E3779B9)`` of int64 lanes."""
    return fmix32(torch.from_numpy(lo ^ ((hi * 0x9E3779B9) & 0xFFFFFFFF))).numpy()


def lookup_np(table: DeviceHashTable, h64: np.ndarray,
              max_probes: int = 64) -> np.ndarray:
    """Host-side lookup twin for tests: the position of each 64-bit key,
    -1 where it is absent."""
    h64 = np.asarray(h64, np.uint64)
    hi = h64 >> np.uint64(32)
    lo = h64 & np.uint64(0xFFFFFFFF)
    t_hi, t_lo, occ = table_to_numpy(table)
    capacity = len(t_hi)
    base = _chain_base(hi.astype(np.int64), lo.astype(np.int64))
    out = np.full(len(h64), -1, np.int64)
    for i in range(len(h64)):
        for p in range(max_probes):
            pos = int((int(base[i]) + p) & 0xFFFFFFFF) % capacity
            if not occ[pos]:
                break
            if t_hi[pos] == hi[i] and t_lo[pos] == lo[i]:
                out[i] = pos
                break
    return out


def _pairs(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The distinct rows of two int64 columns."""
    return np.unique(np.stack([a, b], axis=1), axis=0)


def key_map_faults(table: DeviceHashTable, h_hi, h_lo, slots,
                   max_probes: int = 64, live=None, region=None,
                   region_size: int = 0,
                   reference: Optional[DeviceHashTable] = None
                   ) -> Tuple[Dict[str, int], int]:
    """Host check of one batch's key -> slot map after an insert into
    ``table`` (the kernel's layout depends on thread timing, so it is
    checked as a map, not position for position).  ``h_hi``/``h_lo``
    are the batch's uint32 lanes, ``slots`` its returned slots and
    ``live`` the rows that were to be inserted (all when None).

    Returns ``(faults, probes)``.  ``faults`` counts: ``padding``, rows
    not live that got a slot; ``wrong_key``, resolved rows whose slot
    does not hold their key; ``off_chain``, resolved rows whose slot is
    not on their key's probe chain within ``max_probes``; ``split``,
    slots beyond the first that one key (in one region) was given; and,
    with ``reference``, ``key_set``, the keys (per region) that occupy
    only one of the two tables.  A live row left at -1 (overflow) is not
    a fault here.  ``probes`` is the probe positions the resolved rows
    walked (chain index + 1, summed)."""
    hi = np.asarray(h_hi).view(np.uint32).astype(np.int64)
    lo = np.asarray(h_lo).view(np.uint32).astype(np.int64)
    slots = np.asarray(slots).astype(np.int64)
    live = np.ones(len(slots), bool) if live is None else np.asarray(live, bool)
    t_hi, t_lo, occ = table_to_numpy(table)
    capacity = len(t_hi)
    faults = {"padding": int((slots[~live] != -1).sum())}
    ok = live & (slots >= 0)
    s, h, l_ = slots[ok], hi[ok], lo[ok]
    faults["wrong_key"] = int((~occ[s] | (t_hi[s] != h) | (t_lo[s] != l_)).sum())
    if region is None:
        modulus, offset, reg = capacity, 0, np.zeros(len(s), np.int64)
    else:
        reg = np.asarray(region).astype(np.int64)[ok]
        modulus, offset = region_size, reg * region_size
    base = _chain_base(h, l_)
    rel = s - offset
    idx = (rel - base % modulus) % modulus
    # a chain that wraps past 2^32 within max_probes: walk it
    wrap = np.nonzero(base > 2 ** 32 - max_probes)[0]
    idx[wrap] = max_probes
    for q in range(max_probes - 1, -1, -1):
        hit = ((base[wrap] + q) & 0xFFFFFFFF) % modulus == rel[wrap]
        idx[wrap[hit]] = q
    faults["off_chain"] = int((idx >= max_probes).sum())
    key = (h << 32) | l_
    faults["split"] = (len(np.unique(np.stack([reg, key, s], axis=1), axis=0))
                       - len(_pairs(reg, key)))
    if reference is not None:
        def key_rows(t):
            th, tl, o = table_to_numpy(t)
            pos = np.nonzero(o)[0]
            r = pos // region_size if region is not None else np.zeros(len(pos), np.int64)
            return _pairs(r, (th[o].astype(np.int64) << 32) | tl[o].astype(np.int64))
        both = np.concatenate([key_rows(table), key_rows(reference)])
        _, counts = np.unique(both, axis=0, return_counts=True)
        faults["key_set"] = int((counts == 1).sum())
    return faults, int((np.minimum(idx, max_probes - 1) + 1).sum())
