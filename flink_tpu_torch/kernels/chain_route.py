"""``chain_route``: the stable partition and column move of the fused
chain program (kernel ``csrc/chain_route.cu``).

Replaces the fixed part of ``flink_tpu/streaming/chain_fusion.py``
``_build_fn`` (``stable_order`` and the gather of ``body``, with
``_jnp_splitmix64`` and ``_jnp_operator_indexes``).  Given the columns
of n rows and a keep mask from the map/filter stages, every row gets a
class: in route mode (a key column given) the downstream channel of
its key, ``kg * nch // maxpar`` of the splitmix64 / fmix32 key group,
else 0; a dropped row gets the last class.  The rows are partitioned
stably by class (``np.argsort(cls, kind="stable")``), and every kept
row's columns move to its place; with ``slide`` > 0 each kept row's
pane start ``t - floor_mod(t - offset, slide)`` comes out too.

Returns the moved columns and pane (``count`` rows each: views of
buffers of n rows) and ``starts`` on the host, int64 [nclass]: the
first position of each class, so ``starts[:nch + 1]`` are a route's
channel bounds and ``starts[-1]`` the count of kept rows.  Reading
``starts`` synchronizes with the card.  ``chain_route_plain`` is the
same function in plain PyTorch (an argsort and indexing), on any device.

Row shards (``shard_rows`` > 0, the reference's mesh leg
``chain_fusion.py:832-849``): row i belongs to shard ``i // shard_rows``
of ``n_shards`` and its class becomes ``shard * nclass + class``, so one
launch partitions each shard's block on its own.  The buffers then come
back whole (n rows), ``starts`` has ``n_shards * nclass`` entries, and
shard s's kept rows of class c lie at ``starts[s * nclass + c] ..
starts[s * nclass + c + 1]``; the places of dropped rows hold nothing
defined.

The reference pads each batch to a power-of-two bucket to bound XLA
recompiles; nothing here compiles per shape, so nothing pads.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from flink_tpu_torch.kernels import loader
from flink_tpu_torch.ops.hashing import operator_indexes, splitmix64

#: classes the kernel's shared-memory counters hold (channels + 1, times
#: the shards with row shards)
MAX_CLASSES = 2048
#: rows a warp walks in the kernel (the scan covers nclass * tiles)
TILE_ROWS = 512

Result = Tuple[List[torch.Tensor], Optional[torch.Tensor], np.ndarray]


def _num_classes(key, num_channels: int, max_parallelism: int) -> int:
    if key is None:
        return 2
    if num_channels < 1 or max_parallelism < 1:
        raise ValueError("route mode needs num_channels >= 1 and "
                         "max_parallelism >= 1")
    return num_channels + 1


def _shards(n: int, shard_rows: int, n_shards: int) -> int:
    """The shard count of a call (1 without row shards)."""
    if shard_rows < 0:
        raise ValueError("shard_rows must be >= 0")
    if not shard_rows:
        return 1
    if n_shards < 1 or n > shard_rows * n_shards:
        raise ValueError(f"{n} rows do not fit {n_shards} shards of "
                         f"{shard_rows} rows")
    return n_shards


def chain_route(cols: Sequence[torch.Tensor], keep: torch.Tensor,
                key: Optional[torch.Tensor] = None, num_channels: int = 0,
                max_parallelism: int = 0, ts: Optional[torch.Tensor] = None,
                pane_offset: int = 0, slide: int = 0, shard_rows: int = 0,
                n_shards: int = 0) -> Result:
    """Partition ``cols`` (1-D, n rows each, 1/2/4/8-byte types) by the
    class of each row; ``keep`` bool [n]; ``key`` int64 [n] selects
    route mode; ``slide`` > 0 asks for pane starts of ``ts`` (int64);
    ``shard_rows`` > 0 partitions ``n_shards`` row blocks each on its
    own (see the module docstring)."""
    if keep.device.type == "cpu":
        return chain_route_plain(cols, keep, key, num_channels,
                                 max_parallelism, ts, pane_offset, slide,
                                 shard_rows, n_shards)
    dev = keep.device
    nclass = _num_classes(key, num_channels, max_parallelism)
    loader.check(keep, "keep", (torch.bool,), dev, ndim=1)
    n = keep.numel()
    shards = _shards(n, shard_rows, n_shards)
    if nclass * shards > MAX_CLASSES:
        raise ValueError(f"{shards} shards of {nclass - 1} channels: the "
                         f"kernel takes at most {MAX_CLASSES} classes")
    for j, c in enumerate(cols):
        loader.check(c, f"column {j}", (c.dtype,), dev, ndim=1)
        if c.numel() != n or c.element_size() not in (1, 2, 4, 8):
            raise ValueError(f"column {j}: {c.numel()} rows of "
                             f"{c.element_size()} bytes, expected {n} rows "
                             "of 1, 2, 4 or 8 bytes")
    if key is not None:
        loader.check(key, "key", (torch.int64,), dev, ndim=1)
        if key.numel() != n:
            raise ValueError(f"key has {key.numel()} rows, expected {n}")
    if slide < 0:
        raise ValueError("slide must be >= 0")
    if slide:
        if ts is None:
            raise ValueError("pane starts need ts")
        loader.check(ts, "ts", (torch.int64,), dev, ndim=1)
        if ts.numel() != n:
            raise ValueError(f"ts has {ts.numel()} rows, expected {n}")
    outs = [torch.empty_like(c) for c in cols]
    pane = torch.empty(n, dtype=torch.int64, device=dev) if slide else None
    if n == 0:
        starts = np.zeros(nclass * shards, np.int64)
        return outs, pane, starts
    tiles = -(-n // TILE_ROWS)
    counts = torch.empty(nclass * shards * tiles, dtype=torch.int32, device=dev)
    offsets = torch.empty_like(counts)
    starts_d = torch.empty(nclass * shards, dtype=torch.int64, device=dev)
    k = len(cols)
    src = (ctypes.c_longlong * max(k, 1))(*[c.data_ptr() for c in cols])
    dst = (ctypes.c_longlong * max(k, 1))(*[o.data_ptr() for o in outs])
    widths = (ctypes.c_int * max(k, 1))(*[c.element_size() for c in cols])
    loader.launch("chain_route", "ft_chain_route", loader.ptr(key),
                  keep.data_ptr(), n, nclass, max_parallelism, shard_rows,
                  shards, ctypes.addressof(src), ctypes.addressof(dst),
                  ctypes.addressof(widths), k,
                  loader.ptr(ts) if slide else None, pane_offset, slide,
                  loader.ptr(pane), counts.data_ptr(), offsets.data_ptr(),
                  starts_d.data_ptr())
    starts = starts_d.cpu().numpy()
    if shard_rows:
        return outs, pane, starts
    count = int(starts[-1])
    return ([o[:count] for o in outs],
            pane[:count] if pane is not None else None, starts)


def chain_route_plain(cols: Sequence[torch.Tensor], keep: torch.Tensor,
                      key: Optional[torch.Tensor] = None, num_channels: int = 0,
                      max_parallelism: int = 0,
                      ts: Optional[torch.Tensor] = None, pane_offset: int = 0,
                      slide: int = 0, shard_rows: int = 0,
                      n_shards: int = 0) -> Result:
    nclass = _num_classes(key, num_channels, max_parallelism)
    n = keep.numel()
    shards = _shards(n, shard_rows, n_shards)
    drop = nclass - 1
    if key is None:
        cls = (~keep).to(torch.int64)
    else:
        idx = operator_indexes(splitmix64(key), max_parallelism, num_channels)
        cls = torch.where(keep, idx, drop)
    if shard_rows:
        rows = torch.arange(n, dtype=torch.int64, device=keep.device)
        cls = cls + rows // shard_rows * nclass
    order = torch.argsort(cls, stable=True)
    classes = torch.arange(nclass * shards, dtype=torch.int64,
                           device=keep.device)
    starts = torch.searchsorted(cls[order], classes).cpu().numpy()
    if shard_rows:
        # whole buffers: every row at its place (the kernel leaves the
        # dropped rows' places unwritten)
        kord = order
    else:
        kord = order[:int(starts[-1])]
    pane = None
    if slide:
        t = ts[kord]
        pane = t - torch.remainder(t - pane_offset, slide)
    return [c[kord] for c in cols], pane, starts
