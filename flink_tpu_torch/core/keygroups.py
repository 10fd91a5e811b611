"""Stable key hashing and key groups (port of
``flink_tpu/core/keygroups.py:24-240``).

The port keeps its own bit-identical copy of the hashes the reference
uses for keys and values: a key's 64-bit hash decides its slot in the
window engine and its key group, and an HLL value's hash decides its
register and rank, so both packages must agree bit for bit (held by
``tests/test_torch_hashing.py`` and ``tests/test_torch_state_backend.py``).
A key group is ``murmur_hash(low 32 bits of stable_hash64(key)) %
max_parallelism``; a subtask owns a contiguous ``KeyGroupRange``.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np

DEFAULT_LOWER_BOUND_MAX_PARALLELISM = 128
UPPER_BOUND_MAX_PARALLELISM = 1 << 15


def murmur_hash(code: int) -> int:
    """MurmurHash3 32-bit finalizer over an int."""
    h = code & 0xFFFFFFFF
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return h


def stable_hash64(key: Any) -> int:
    """Deterministic 64-bit hash of a hashable key: splitmix64 for
    ints, FNV-1a (then splitmix64) over UTF-8 for strings and bytes,
    an order-sensitive combine for tuples."""
    if isinstance(key, (int, np.integer)):
        return splitmix64(int(key))
    if isinstance(key, str):
        key = key.encode("utf-8")
    if isinstance(key, bytes):
        h = 0xCBF29CE484222325
        for b in key:
            h ^= b
            h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
        # finalize so short strings spread over high bits too
        return splitmix64(h)
    if isinstance(key, tuple):
        h = 0x345678
        for item in key:
            h = splitmix64(h ^ stable_hash64(item))
        return h
    if isinstance(key, float):
        # NaN/inf are valid keys; int(key) would raise on them
        if math.isfinite(key) and key == int(key):
            return splitmix64(int(key))
        return splitmix64(hash(key) & 0xFFFFFFFFFFFFFFFF)
    if key is None:
        return splitmix64(0x9E3779B97F4A7C15)
    if isinstance(key, bool):
        return splitmix64(int(key))
    return splitmix64(hash(key) & 0xFFFFFFFFFFFFFFFF)


def splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def splitmix64_np(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 over uint64 arrays."""
    x = x.astype(np.uint64)
    with np.errstate(over="ignore"):
        x = x + np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def stable_hashes_np(keys) -> np.ndarray:
    """64-bit stable hash per key, exactly ``stable_hash64`` per
    element: all-int key lists vectorize through splitmix64, anything
    else hashes per key in Python."""
    n = len(keys)
    for k in keys:
        if type(k) is not int:
            return np.fromiter((stable_hash64(k) for k in keys),
                               np.uint64, n)
    try:
        arr = np.array(keys, np.int64)
    except OverflowError:
        return np.fromiter((stable_hash64(k) for k in keys), np.uint64, n)
    return splitmix64_np(arr)


def assign_to_key_group(key: Any, max_parallelism: int) -> int:
    """key → key group: ``murmurHash(hash) % maxParallelism``."""
    return murmur_hash(stable_hash64(key) & 0xFFFFFFFF) % max_parallelism


def assign_key_groups_np(hashes64: np.ndarray, max_parallelism: int) -> np.ndarray:
    """Vectorized key-group assignment from precomputed 64-bit hashes."""
    h = (hashes64 & np.uint64(0xFFFFFFFF)).astype(np.uint64)
    h ^= h >> np.uint64(16)
    with np.errstate(over="ignore"):
        h = (h * np.uint64(0x85EBCA6B)) & np.uint64(0xFFFFFFFF)
        h ^= h >> np.uint64(13)
        h = (h * np.uint64(0xC2B2AE35)) & np.uint64(0xFFFFFFFF)
    h ^= h >> np.uint64(16)
    return (h % np.uint64(max_parallelism)).astype(np.int32)


def compute_key_group_range_for_operator_index(
        max_parallelism: int, parallelism: int,
        operator_index: int) -> "KeyGroupRange":
    """operator subtask → its contiguous range of key groups."""
    start = (operator_index * max_parallelism + parallelism - 1) // parallelism
    end = ((operator_index + 1) * max_parallelism - 1) // parallelism
    return KeyGroupRange(start, end)


def compute_default_max_parallelism(parallelism: int) -> int:
    """1.5 x parallelism rounded up to a power of two, clamped to
    [128, 32768]."""
    return min(max(round_up_to_power_of_two(parallelism + parallelism // 2),
                   DEFAULT_LOWER_BOUND_MAX_PARALLELISM),
               UPPER_BOUND_MAX_PARALLELISM)


def round_up_to_power_of_two(x: int) -> int:
    if x <= 1:
        return 1
    return 1 << (x - 1).bit_length()


class KeyGroupRange:
    """Inclusive range [start, end] of key groups (empty when start >
    end)."""

    __slots__ = ("start_key_group", "end_key_group")

    def __init__(self, start: int, end: int):
        if start > end:
            start, end = 0, -1
        self.start_key_group = start
        self.end_key_group = end

    @property
    def number_of_key_groups(self) -> int:
        return max(0, self.end_key_group - self.start_key_group + 1)

    def contains(self, key_group: int) -> bool:
        return self.start_key_group <= key_group <= self.end_key_group

    def __eq__(self, other):
        return (isinstance(other, KeyGroupRange)
                and self.start_key_group == other.start_key_group
                and self.end_key_group == other.end_key_group)

    def __hash__(self):
        return hash((self.start_key_group, self.end_key_group))

    def __repr__(self):
        return f"KeyGroupRange[{self.start_key_group}, {self.end_key_group}]"
