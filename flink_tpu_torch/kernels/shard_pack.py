"""``shard_pack``: the pack of the keyBy exchange into per-target buckets
(kernel ``csrc/shard_pack.cu``).

Replaces the device pack of the mesh engines: ``flink_tpu/parallel/
mesh_agg.py:50-84`` ``_target_shard`` + ``_bucketize`` (called by
``mesh_agg.py:112-135`` and ``mesh_windows.py:102-123``) and the pack of
``mesh_log.py:137-157`` ``_make_packed_exchange``.

n rows are ``sources`` blocks of ``m = n // sources`` rows (each source
shard's data-parallel slice).  Each row has a target shard in
``[0, n_shards]``: ``target`` (int32; values outside that range count
as ``n_shards``), or from ``hash_lo`` (the key hash's low lane) as
``fmix32(lo) % max_parallelism * n_shards // max_parallelism``; a row
whose ``mask`` is False targets ``n_shards``, which is never sent.
Within each (source, target) bucket rows keep their source order (a
stable argsort), and a row of rank ``r < cap`` lands at row ``r`` of its
bucket; every other bucket row is zero.

Two layouts of the lanes:

- a list of 1-D tensors of n rows (1, 2, 4 or 8-byte types), packed
  into one tensor ``[sources, n_shards, cap]`` each (K11a/K11b, where
  ``cap = m`` and a packed bool mask lane is the reference's bucket
  mask);
- one 2-D tensor ``[n, K]`` of 32-bit lanes, packed into
  ``[sources, n_shards, cap, K]`` (K11c); the kernel moves a row as one
  lane of 4 K bytes.

Returns ``(packed, counts)``, counts int32 ``[sources, n_shards]``, the
rows of each bucket clipped at ``cap``.  ``shard_pack_plain`` is the
same function in plain PyTorch (a stable argsort, the rank from the
class starts, an indexed write): the CPU path and what the kernel is
held against.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple, Union

import torch

from flink_tpu_torch.kernels import loader
from flink_tpu_torch.kernels.chain_route import MAX_CLASSES, TILE_ROWS
from flink_tpu_torch.ops.hashing import fmix32

#: lanes one launch moves
MAX_LANES = 16
_LANE32 = (torch.int32, torch.uint32, torch.float32)

Lanes = Union[Sequence[torch.Tensor], torch.Tensor]
Packed = Union[List[torch.Tensor], torch.Tensor]


def _geometry(lanes: Lanes, n_shards: int, cap: int,
              sources: Optional[int]) -> Tuple[bool, int, int, int]:
    """(rows layout?, n, sources, lanes) after the checks both versions
    share."""
    rows = isinstance(lanes, torch.Tensor)
    if rows:
        if lanes.dim() != 2:
            raise ValueError("the rows layout is one [n, K] tensor")
        n, k = lanes.shape
    else:
        lanes = list(lanes)
        if not lanes:
            raise ValueError("no lanes to pack")
        n, k = lanes[0].numel(), len(lanes)
    src = n_shards if sources is None else sources
    if n_shards < 1 or cap < 1 or src < 1 or n % src:
        raise ValueError(f"{n} rows do not split into {src} sources, or "
                         f"n_shards={n_shards} / cap={cap} < 1")
    if src * (n_shards + 1) > MAX_CLASSES:
        raise ValueError(f"{src} sources x {n_shards + 1} targets: at most "
                         f"{MAX_CLASSES} classes")
    if not 0 < k <= MAX_LANES:
        raise ValueError(f"{k} lanes: the kernel moves 1 to {MAX_LANES}")
    return rows, n, src, k


def shard_pack(lanes: Lanes, n_shards: int, cap: int,
               target: Optional[torch.Tensor] = None,
               hash_lo: Optional[torch.Tensor] = None,
               max_parallelism: int = 0,
               mask: Optional[torch.Tensor] = None,
               sources: Optional[int] = None) -> Tuple[Packed, torch.Tensor]:
    """Pack ``lanes`` into ``sources`` x ``n_shards`` buckets of ``cap``
    rows (``sources`` defaults to ``n_shards``); see the module
    docstring."""
    probe = lanes if isinstance(lanes, torch.Tensor) else list(lanes)[0]
    if probe.device.type == "cpu":
        return shard_pack_plain(lanes, n_shards, cap, target, hash_lo,
                                max_parallelism, mask, sources)
    dev = probe.device
    rows, n, src, k = _geometry(lanes, n_shards, cap, sources)
    if rows:
        loader.check(lanes, "lanes", _LANE32, dev, ndim=2)
        out = torch.empty((src, n_shards, cap, k), dtype=lanes.dtype,
                          device=dev)
        srcs, dsts, widths = [lanes], [out], [4 * k]    # a row is one lane
    else:
        srcs = list(lanes)
        for j, c in enumerate(srcs):
            loader.check(c, f"lane {j}", (c.dtype,), dev, ndim=1)
            if c.numel() != n or c.element_size() not in (1, 2, 4, 8):
                raise ValueError(f"lane {j}: {c.numel()} rows of "
                                 f"{c.element_size()} bytes, expected {n} "
                                 "rows of 1, 2, 4 or 8 bytes")
        dsts = [torch.empty((src, n_shards, cap), dtype=c.dtype, device=dev)
                for c in srcs]
        out = dsts
        widths = [c.element_size() for c in srcs]
    if target is not None:
        loader.check(target, "target", (torch.int32,), dev, ndim=1)
        if target.numel() != n:
            raise ValueError(f"target has {target.numel()} rows, expected {n}")
    elif hash_lo is None or max_parallelism < 1:
        raise ValueError("give target, or hash_lo with max_parallelism >= 1")
    else:
        loader.check(hash_lo, "hash_lo", (torch.int32, torch.uint32), dev,
                     ndim=1)
        if hash_lo.numel() != n:
            raise ValueError(f"hash_lo has {hash_lo.numel()} rows, expected {n}")
    if mask is not None:
        loader.check(mask, "mask", (torch.bool, torch.uint8), dev, ndim=1)
        if mask.numel() != n:
            raise ValueError(f"mask has {mask.numel()} rows, expected {n}")
    counts = torch.empty((src, n_shards), dtype=torch.int32, device=dev)
    if n == 0:
        for d in dsts:
            d.zero_()
        counts.zero_()
        return out, counts
    table = src * n_shards * -(-(n // src) // TILE_ROWS)
    scratch = torch.empty(2 * table, dtype=torch.int32, device=dev)
    tcls = torch.empty(n, dtype=torch.int16, device=dev)
    nl = len(srcs)
    arr = lambda ctype, xs: (ctype * nl)(*xs)           # noqa: E731
    sp = arr(ctypes.c_longlong, [c.data_ptr() for c in srcs])
    dp = arr(ctypes.c_longlong, [d.data_ptr() for d in dsts])
    wp = arr(ctypes.c_int, widths)
    loader.launch("shard_pack", "ft_shard_pack", loader.ptr(target),
                  None if target is not None else hash_lo.data_ptr(),
                  max_parallelism, loader.ptr(mask), n, src, n_shards, cap,
                  ctypes.addressof(sp), ctypes.addressof(dp),
                  ctypes.addressof(wp), nl, counts.data_ptr(),
                  tcls.data_ptr(), scratch.data_ptr(),
                  scratch[table:].data_ptr())
    return out, counts


def target_shards(hash_lo: torch.Tensor, max_parallelism: int,
                  n_shards: int) -> torch.Tensor:
    """Key hash low lane -> key group -> shard, int64 (the reference's
    ``_target_shard``)."""
    kg = fmix32(hash_lo) % max_parallelism
    return kg * n_shards // max_parallelism


def shard_pack_plain(lanes: Lanes, n_shards: int, cap: int,
                     target: Optional[torch.Tensor] = None,
                     hash_lo: Optional[torch.Tensor] = None,
                     max_parallelism: int = 0,
                     mask: Optional[torch.Tensor] = None,
                     sources: Optional[int] = None) -> Tuple[Packed, torch.Tensor]:
    rows, n, src, k = _geometry(lanes, n_shards, cap, sources)
    probe = lanes if rows else list(lanes)[0]
    dev = probe.device
    S = n_shards
    if target is not None:
        t = target.to(torch.int64)
        t = torch.where((t < 0) | (t > S), S, t)
    elif hash_lo is None or max_parallelism < 1:
        raise ValueError("give target, or hash_lo with max_parallelism >= 1")
    else:
        t = target_shards(hash_lo, max_parallelism, S)
    if mask is not None:
        t = torch.where(mask.to(torch.bool), t, S)
    m = n // src
    s = torch.arange(n, dtype=torch.int64, device=dev) // m
    cls = s * (S + 1) + t
    order = torch.argsort(cls, stable=True)
    sorted_cls = cls[order]
    starts = torch.searchsorted(sorted_cls, torch.arange(
        src * (S + 1), dtype=torch.int64, device=dev))
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    rank[order] = torch.arange(n, dtype=torch.int64, device=dev) - starts[sorted_cls]
    ok = (t < S) & (rank < cap)
    q = ((s * S + t) * cap + rank)[ok]
    sizes = torch.bincount(cls, minlength=src * (S + 1)).view(src, S + 1)
    counts = torch.clamp(sizes[:, :S], max=cap).to(torch.int32)
    if rows:
        out = torch.zeros((src * S * cap, k), dtype=lanes.dtype, device=dev)
        out[q] = lanes[ok]
        return out.view(src, S, cap, k), counts
    outs = []
    for c in lanes:
        o = torch.zeros(src * S * cap, dtype=c.dtype, device=dev)
        o[q] = c[ok]
        outs.append(o.view(src, S, cap))
    return outs, counts
