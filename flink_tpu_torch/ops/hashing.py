"""Hashing primitives (port of ``flink_tpu/ops/hashing.py``).

A key's or value's stable 64-bit hash travels as two 32-bit lanes
(``h_hi``, ``h_lo``); the HLL register and rank come from exact bit
arithmetic on those lanes.  PyTorch on the CPU has no ``>>``, ``%`` or
``+`` for ``uint32``, so these functions compute in ``int64`` with
explicit ``& 0xFFFFFFFF`` masks; lanes may arrive as ``uint32``, as an
``int32`` view of the same bits, or as ``int64``.  The CUDA kernels do
the same arithmetic on native ``uint32`` (``__clz``, and wrapping
multiplies for the Count-Min columns).
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF


def _u32(x: torch.Tensor) -> torch.Tensor:
    """Lane bits as non-negative int64 values in [0, 2^32)."""
    return x.to(torch.int64) & _M32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3 32-bit finalizer (tensor twin of
    ``core.keygroups.murmur_hash``).  int64 products wrap mod 2^64,
    which keeps the low 32 bits exact."""
    h = _u32(h)
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def split_hash64_np(h64: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host helper: split uint64 hashes into (hi, lo) uint32 lanes."""
    h64 = h64.astype(np.uint64)
    hi = (h64 >> np.uint64(32)).astype(np.uint32)
    lo = (h64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return hi, lo


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Branchless popcount over 32-bit lanes (SWAR), as int32."""
    x = _u32(x)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & _M32) >> 24).to(torch.int32)


def clz32(x: torch.Tensor) -> torch.Tensor:
    """Count leading zeros of a 32-bit lane, exact (no float log)."""
    x = _u32(x)
    x = x | (x >> 1)
    x = x | (x >> 2)
    x = x | (x >> 4)
    x = x | (x >> 8)
    x = x | (x >> 16)
    return 32 - popcount32(x)


def hll_register_and_rank(h_hi: torch.Tensor, h_lo: torch.Tensor,
                          precision: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Register index from the low ``precision`` bits of ``h_lo``; rank
    = leading zeros of ``h_hi`` + 1 (at most 33).  Returns
    (register[int32], rank[int32])."""
    reg = (_u32(h_lo) & ((1 << precision) - 1)).to(torch.int32)
    rank = (clz32(h_hi) + 1).to(torch.int32)
    return reg, rank


def countmin_rows(h_hi: torch.Tensor, h_lo: torch.Tensor, depth: int,
                  width: int) -> torch.Tensor:
    """Kirsch-Mitzenmacher double hashing: row r's column is
    ``(lo + r * hi) mod width`` in uint32 arithmetic, where ``r * hi``
    and the add wrap mod 2^32 before the mod (width need not be a power
    of two).  Returns int32 ``[depth, N]``."""
    r = torch.arange(depth, dtype=torch.int64, device=h_hi.device)[:, None]
    h = (_u32(h_lo)[None, :] + r * _u32(h_hi)[None, :]) & _M32
    return (h % width).to(torch.int32)


def _signed64(c: int) -> int:
    """A uint64 constant as the int64 of the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


def _shr64(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits (torch's ``>>`` is arithmetic)."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 of int64 keys as int64 bits (tensor twin of
    ``core.keygroups.splitmix64_np``): int64 adds and multiplies wrap
    mod 2^64 as uint64 ones do, and every right shift is masked."""
    z = x.to(torch.int64) + _signed64(0x9E3779B97F4A7C15)
    z = (z ^ _shr64(z, 30)) * _signed64(0xBF58476D1CE4E5B9)
    z = (z ^ _shr64(z, 27)) * _signed64(0x94D049BB133111EB)
    return z ^ _shr64(z, 31)


def operator_indexes(hashes: torch.Tensor, max_parallelism: int,
                     parallelism: int) -> torch.Tensor:
    """64-bit hash bits -> key group -> subtask index, int64 (tensor twin
    of ``core.keygroups.assign_operator_indexes_np``)."""
    kg = fmix32(hashes & _M32) % max_parallelism
    return kg * parallelism // max_parallelism
