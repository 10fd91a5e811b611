"""Stable key hashing (port of ``flink_tpu/core/keygroups.py:24-112``).

The port keeps its own bit-identical copy of the hashes the reference
uses for keys and values: a key's 64-bit hash decides its slot in the
window engine and an HLL value's hash decides its register and rank,
so both packages must agree bit for bit (held by
``tests/test_torch_hashing.py``).  Key-group assignment and rescaling
come with the keyed-state slice.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np


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
