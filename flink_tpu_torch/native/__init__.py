"""ctypes bindings of the port's C++ host runtime (``host_runtime.cpp``
in this directory; port of ``flink_tpu/native/__init__.py``).

The log-structured window tier, the slot index, the string interner,
the generic aggregate tier's grouping (``fold_prep``, ``group_cols``,
``argsort_u64``) and the columnar interval join (``NativeIntervalJoin``)
run on it.  It is host code: the sort, the dedup and the estimate of the
log tier's host fire run on the CPU next to the card, as they do in the
JAX package, whose ``native/host_runtime.cpp`` this copy carries
unchanged (the port never loads that library).

The library builds at first use with

    g++ -O3 -march=native -shared -fPIC -o _build/host_runtime-<hash>.so host_runtime.cpp

into ``_build/`` beside this file, keyed by a hash of the source and
flags, so a changed source rebuilds and an unchanged one loads what is
there.  A failed build raises ``RuntimeError`` carrying the compiler's
output: nothing falls back to a numpy path on its own (the numpy slot
index, ``VectorizedSlotIndex``, stays as the plain twin the tests use).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

from flink_tpu_torch.runtime import tracing as _tracing
from flink_tpu_torch.runtime.device_stats import TELEMETRY

_SRC = Path(__file__).resolve().parent / "host_runtime.cpp"
_BUILD = Path(__file__).resolve().parent / "_build"
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return _BUILD / f"host_runtime-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the host runtime unless the built library is there;
    returns its path.  Raises with the compiler's output on failure."""
    out = library_path()
    if out.exists():
        return out
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(_SRC)],
                              capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"g++ could not run for the host runtime: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for the host runtime (exit "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    _tracing.record_compile_event("native.build.host_runtime",
                                  time.perf_counter() - t0)
    return out


_perf_ns = time.perf_counter_ns


def _kernel(name: str):
    """Dispatch count and wall time of one host-runtime entry, into
    ``runtime.tracing``'s kernel store under the reference's name
    (``native.<name>`` gauges and trace spans), while the tracer or the
    device telemetry is on; off, the wrapper costs two attribute checks
    and makes no timing call.  Errors pass straight through."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not (_tracing._tracer.enabled or TELEMETRY.enabled):
                return fn(*args, **kwargs)
            t0 = _perf_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                _tracing.record_kernel(name, t0, _perf_ns())
        return wrapper
    return deco


def _declare(lib: ctypes.CDLL) -> None:
    c = ctypes
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    sigs = {
        "ft_splitmix64": ([u64p, u64p, c.c_int64], None),
        "ft_key_groups": ([u64p, i32p, c.c_int64, c.c_int32, c.c_int32], None),
        "ft_index_new": ([c.c_int64], c.c_void_p),
        "ft_index_free": ([c.c_void_p], None),
        "ft_index_size": ([c.c_void_p], c.c_int64),
        "ft_index_probe": ([c.c_void_p, u64p, c.c_int64, i64p, i64p], c.c_int64),
        "ft_index_assign": ([c.c_void_p, i64p, c.c_int64, i64p], None),
        "ft_index_set": ([c.c_void_p, u64p, i64p, c.c_int64], None),
        "ft_index_export": ([c.c_void_p, u64p, i64p], c.c_int64),
        "ft_hll_make_cells": ([u64p, c.c_int64, c.c_int, u16p, u8p], None),
        "ft_hll_log_compact": ([u64p, u16p, u8p, c.c_int64, c.c_int, u64p,
                                u16p, u8p, i32p, c.POINTER(c.c_int64)],
                               c.c_int64),
        "ft_hll_log_fire": ([u64p, u16p, u8p, c.c_int64, c.c_int, u64p, f64p],
                            c.c_int64),
        "ft_sum_log_fire": ([u64p, f64p, c.c_int64, u64p, f64p], c.c_int64),
        "ft_sumtab_new": ([c.c_int64], c.c_void_p),
        "ft_sumtab_free": ([c.c_void_p], None),
        "ft_sumtab_size": ([c.c_void_p], c.c_int64),
        "ft_sumtab_ingest": ([c.c_void_p, u64p, f64p, c.c_int64, c.c_int64],
                             c.c_int64),
        "ft_sumtab_export": ([c.c_void_p, u64p, f64p], c.c_int64),
        "ft_qsketch_log_fire": ([u64p, u16p, c.c_int64, c.c_int, f64p, c.c_int,
                                 c.c_double, c.c_int64, c.c_double, u64p, f64p],
                                c.c_int64),
        "ft_qsketch_log_fire2": ([u64p, u16p, u32p, c.c_int64, c.c_int, f64p,
                                  c.c_int, c.c_double, c.c_int64, c.c_double,
                                  u64p, f64p], c.c_int64),
        "ft_qsketch_log_compact": ([u64p, u16p, u32p, c.c_int64, c.c_int, u64p,
                                    u16p, u32p], c.c_int64),
        "ft_session_log_fire2": ([u64p, i64p, f32p, u64p, c.c_int64,
                                  u64p, i64p, f32p, u64p, c.c_int64,
                                  c.c_int64, c.c_int64, c.c_int, c.c_int,
                                  u64p, i64p, i64p, f64p,
                                  u64p, i64p, f32p, u64p, c.POINTER(c.c_int64)],
                                 c.c_int64),
        "ft_intern_new": ([c.c_int64], c.c_void_p),
        "ft_intern_free": ([c.c_void_p], None),
        "ft_intern_size": ([c.c_void_p], c.c_int64),
        "ft_intern_rows": ([c.c_void_p, u8p, c.c_int64, c.c_int64, c.c_int64,
                            u64p, i64p], c.c_int64),
        "ft_wordsums_new": ([], c.c_void_p),
        "ft_wordsums_free": ([c.c_void_p], None),
        "ft_wordsums_count": ([c.c_void_p], c.c_int64),
        "ft_wordsums_fire": ([c.c_void_p, i64p, f64p], c.c_int64),
        "ft_wordsums_load": ([c.c_void_p, i64p, f64p, c.c_int64], None),
        "ft_intern_sum": ([c.c_void_p, c.c_void_p, u8p, c.c_int64, c.c_int64,
                           f64p, c.c_int64, c.c_int64, i64p], c.c_int64),
        "ft_fold_prep": ([u64p, c.c_int64, i64p, i64p, i64p, u64p], c.c_int64),
        "ft_group_cols": ([u64p, c.c_int64, c.c_int64, i64p,
                           c.POINTER(c.c_void_p), c.POINTER(c.c_void_p),
                           c.c_void_p, i64p, i64p, u64p], c.c_int64),
        "ft_argsort_u64": ([u64p, c.c_int64, i64p], None),
        "ft_ivjoin_new": ([c.c_int64, c.c_int64, c.c_int64], c.c_void_p),
        "ft_ivjoin_free": ([c.c_void_p], None),
        "ft_ivjoin_push": ([c.c_void_p, c.c_int64, u64p, i64p, c.c_int64],
                           c.c_int64),
        "ft_ivjoin_pairs": ([c.c_void_p, i64p, i64p], c.c_int64),
        "ft_ivjoin_prune": ([c.c_void_p, c.c_int64], None),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype


def lib() -> ctypes.CDLL:
    """The loaded host runtime, built at the first call."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                loaded = ctypes.CDLL(str(build()))
                _declare(loaded)
                _lib = loaded
    return _lib


# ---- hashing ----------------------------------------------------------------

@_kernel("splitmix64")
def splitmix64(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, np.uint64)
    out = np.empty_like(x)
    lib().ft_splitmix64(x, out, len(x))
    return out


@_kernel("key_groups")
def key_groups(kh: np.ndarray, max_parallelism: int,
               n_shards: int) -> np.ndarray:
    kh = np.ascontiguousarray(kh, np.uint64)
    out = np.empty(len(kh), np.int32)
    lib().ft_key_groups(kh, out, len(kh), max_parallelism, n_shards)
    return out


# ---- persistent slot index ---------------------------------------------------

class NativeSlotIndex:
    """hash64 → dense slot through the C++ open-addressing table, with
    the contract of ``VectorizedSlotIndex.lookup_or_insert``: new keys
    get slots from the caller's ``alloc`` (in first-seen order), so the
    engine's arena stays the one slot allocator."""

    __slots__ = ("_h", "_lib")

    def __init__(self, capacity: int = 1 << 12):
        self._lib = lib()
        cap = 1 << max(4, (capacity - 1).bit_length())
        self._h = self._lib.ft_index_new(cap)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ft_index_free(self._h)
            self._h = None

    @property
    def n(self) -> int:
        return self._lib.ft_index_size(self._h)

    @_kernel("index.lookup_or_insert")
    def lookup_or_insert(self, batch_hashes: np.ndarray, alloc):
        """Returns (slots[N] int64, first_idx): the batch row of each
        newly inserted hash, in slot-allocation order."""
        h = np.ascontiguousarray(batch_hashes, np.uint64)
        n = len(h)
        slots = np.empty(n, np.int64)
        first_idx = np.empty(n, np.int64)
        n_new = self._lib.ft_index_probe(self._h, h, n, slots, first_idx)
        first_idx = first_idx[:n_new]
        if n_new:
            new_slots = np.ascontiguousarray(alloc(n_new), np.int64)
            self._lib.ft_index_assign(self._h, new_slots, n_new, slots)
        return slots, first_idx

    def set_bulk(self, hashes: np.ndarray, slots: np.ndarray) -> None:
        hashes = np.ascontiguousarray(hashes, np.uint64)
        slots = np.ascontiguousarray(slots, np.int64)
        self._lib.ft_index_set(self._h, hashes, slots, len(hashes))

    def export(self):
        """Occupied (hash, slot) pairs — the snapshot format both
        packages' indexes restore from."""
        n = self.n
        hashes = np.empty(n, np.uint64)
        slots = np.empty(n, np.int64)
        k = self._lib.ft_index_export(self._h, hashes, slots)
        return hashes[:k], slots[:k]


# ---- log-structured window tier ---------------------------------------------

@_kernel("hll_log_compact")
def hll_log_compact(keys: np.ndarray, regs: np.ndarray, ranks: np.ndarray,
                    precision: int):
    """Sort a window's HLL cell log by key and dedup (reg) -> max(rank).
    Returns (cell keys, regs, ranks, per-key exclusive run ends)."""
    n = len(keys)
    keys = np.ascontiguousarray(keys, np.uint64)
    regs = np.ascontiguousarray(regs, np.uint16)
    ranks = np.ascontiguousarray(ranks, np.uint8)
    ok = np.empty(n, np.uint64)
    orr = np.empty(n, np.uint16)
    ork = np.empty(n, np.uint8)
    ends = np.empty(n, np.int32)
    n_cells = ctypes.c_int64(0)
    n_keys = lib().ft_hll_log_compact(keys, regs, ranks, n, precision, ok,
                                      orr, ork, ends, ctypes.byref(n_cells))
    c = n_cells.value
    return ok[:c], orr[:c], ork[:c], ends[:n_keys]


@_kernel("hll_log_fire")
def hll_log_fire(keys: np.ndarray, regs: np.ndarray, ranks: np.ndarray,
                 precision: int):
    """Host fire over a window's HLL cell log: (distinct keys, float64
    estimates), key-sorted."""
    n = len(keys)
    keys = np.ascontiguousarray(keys, np.uint64)
    regs = np.ascontiguousarray(regs, np.uint16)
    ranks = np.ascontiguousarray(ranks, np.uint8)
    ok = np.empty(n, np.uint64)
    est = np.empty(n, np.float64)
    n_keys = lib().ft_hll_log_fire(keys, regs, ranks, n, precision, ok, est)
    return ok[:n_keys], est[:n_keys]


@_kernel("sum_log_fire")
def sum_log_fire(keys: np.ndarray, values: np.ndarray):
    """Per distinct key, the sum of its logged values (key-sorted)."""
    n = len(keys)
    keys = np.ascontiguousarray(keys, np.uint64)
    values = np.ascontiguousarray(values, np.float64)
    ok = np.empty(n, np.uint64)
    s = np.empty(n, np.float64)
    n_keys = lib().ft_sum_log_fire(keys, values, n, ok, s)
    return ok[:n_keys], s[:n_keys]


class NativeSumTable:
    """Dense per-window key -> running sum (the hash-combiner tier of
    the Sum log): an open-addressing C++ table that starts at
    ``capacity`` and grows geometrically."""

    __slots__ = ("_h", "_lib", "capacity")

    def __init__(self, capacity: int = 1 << 12):
        self._lib = lib()
        self.capacity = 1 << max(4, (capacity - 1).bit_length())
        self._h = self._lib.ft_sumtab_new(self.capacity)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ft_sumtab_free(self._h)
            self._h = None

    @property
    def n(self) -> int:
        return self._lib.ft_sumtab_size(self._h)

    @_kernel("sum_table.ingest")
    def ingest(self, keys: np.ndarray, values: np.ndarray,
               max_distinct: int) -> int:
        """Accumulate; returns the records consumed (< len(keys) when
        the distinct cap was hit: the window switches to log form)."""
        keys = np.ascontiguousarray(keys, np.uint64)
        values = np.ascontiguousarray(values, np.float64)
        return self._lib.ft_sumtab_ingest(self._h, keys, values, len(keys),
                                          max_distinct)

    def export(self):
        n = self.n
        keys = np.empty(n, np.uint64)
        sums = np.empty(n, np.float64)
        k = self._lib.ft_sumtab_export(self._h, keys, sums)
        return keys[:k], sums[:k]


@_kernel("hll_make_cells")
def hll_make_cells(value_hashes: np.ndarray, precision: int):
    """(register u16, rank u8) cells from u64 value hashes in one pass
    (precision <= 16)."""
    if precision > 16:
        raise ValueError("hll_make_cells supports precision <= 16; "
                         "use compress_value_hash for wider registers")
    vh = np.ascontiguousarray(value_hashes, np.uint64)
    n = len(vh)
    regs = np.empty(n, np.uint16)
    ranks = np.empty(n, np.uint8)
    lib().ft_hll_make_cells(vh, n, precision, regs, ranks)
    return regs, ranks


@_kernel("qsketch_log_fire")
def qsketch_log_fire(keys: np.ndarray, buckets: np.ndarray, n_buckets: int,
                     quantiles, log_gamma: float, offset: int,
                     mid_corr: float, counts=None):
    """Per distinct key, the requested quantiles from its logged
    DDSketch buckets; ``counts`` weights each cell (None: weight 1).
    Returns (keys, q [n_keys, n_q])."""
    n = len(keys)
    keys = np.ascontiguousarray(keys, np.uint64)
    buckets = np.ascontiguousarray(buckets, np.uint16)
    q = np.ascontiguousarray(quantiles, np.float64)
    ok = np.empty(n, np.uint64)
    out = np.empty(n * len(q), np.float64)
    if counts is None:
        n_keys = lib().ft_qsketch_log_fire(keys, buckets, n, n_buckets, q,
                                           len(q), log_gamma, offset,
                                           mid_corr, ok, out)
    else:
        if n >= 1 << 32:
            # the weighted fire carries the cell index in 32 bits
            raise ValueError(
                "weighted quantile fire supports < 2^32 cells per "
                "window; lower compact_threshold so the log compacts")
        counts = np.ascontiguousarray(counts, np.uint32)
        n_keys = lib().ft_qsketch_log_fire2(keys, buckets, counts, n,
                                            n_buckets, q, len(q), log_gamma,
                                            offset, mid_corr, ok, out)
    return ok[:n_keys], out[:n_keys * len(q)].reshape(n_keys, len(q))


@_kernel("qsketch_log_compact")
def qsketch_log_compact(keys: np.ndarray, buckets: np.ndarray, counts,
                        n_buckets: int):
    """Collapse (key, bucket) duplicates into count cells.  ``counts``
    weights existing cells (None: 1).  Returns (keys, buckets, counts)."""
    n = len(keys)
    keys = np.ascontiguousarray(keys, np.uint64)
    buckets = np.ascontiguousarray(buckets, np.uint16)
    counts = (np.ones(n, np.uint32) if counts is None
              else np.ascontiguousarray(counts, np.uint32))
    ok = np.empty(n, np.uint64)
    ob = np.empty(n, np.uint16)
    oc = np.empty(n, np.uint32)
    n_out = lib().ft_qsketch_log_compact(keys, buckets, counts, n, n_buckets,
                                         ok, ob, oc)
    return ok[:n_out].copy(), ob[:n_out].copy(), oc[:n_out].copy()


@_kernel("session_log_fire")
def session_log_fire(keys: np.ndarray, ts: np.ndarray, weights: np.ndarray,
                     vhs: np.ndarray, gap_ms: int, watermark: int,
                     depth: int, width: int, retained=None):
    """Close every session whose end - 1 <= watermark: returns (closed
    keys, starts, ends, totals, retained (keys, ts, w, vh)).  Pass
    ``retained`` back exactly as the previous fire returned it: the
    kernel merges it as a key-major stream."""
    keys = np.ascontiguousarray(keys, np.uint64)
    ts = np.ascontiguousarray(ts, np.int64)
    weights = np.ascontiguousarray(weights, np.float32)
    vhs = np.ascontiguousarray(vhs, np.uint64)
    if retained is None:
        pk, pt = np.empty(0, np.uint64), np.empty(0, np.int64)
        pw, pv = np.empty(0, np.float32), np.empty(0, np.uint64)
    else:
        pk = np.ascontiguousarray(retained[0], np.uint64)
        pt = np.ascontiguousarray(retained[1], np.int64)
        pw = np.ascontiguousarray(retained[2], np.float32)
        pv = np.ascontiguousarray(retained[3], np.uint64)
    n = len(keys) + len(pk)
    ok, os_, oe = (np.empty(n, np.uint64), np.empty(n, np.int64),
                   np.empty(n, np.int64))
    ot = np.empty(n, np.float64)
    rk, rt = np.empty(n, np.uint64), np.empty(n, np.int64)
    rw, rv = np.empty(n, np.float32), np.empty(n, np.uint64)
    n_ret = ctypes.c_int64(0)
    n_closed = lib().ft_session_log_fire2(
        keys, ts, weights, vhs, len(keys), pk, pt, pw, pv, len(pk),
        gap_ms, watermark, depth, width, ok, os_, oe, ot, rk, rt, rw, rv,
        ctypes.byref(n_ret))
    r = n_ret.value
    return (ok[:n_closed], os_[:n_closed], oe[:n_closed], ot[:n_closed],
            (rk[:r].copy(), rt[:r].copy(), rw[:r].copy(), rv[:r].copy()))


# ---- string key interning ---------------------------------------------------

def _pow2_at_least(n: int) -> int:
    return 1 << max(4, (n - 1).bit_length())


def _string_rows(arr: np.ndarray):
    """(raw row buffer as uint8 [n, width * elem], width in elements,
    element size) of a fixed-width numpy string array ('<U' UCS4 or
    '|S' bytes)."""
    if arr.dtype.kind == "U":
        elem = 4
    elif arr.dtype.kind == "S":
        elem = 1
    else:
        raise TypeError(f"not a fixed-width string array: {arr.dtype}")
    arr = np.ascontiguousarray(arr)
    width = arr.dtype.itemsize // elem
    if width == 0:  # zero-width dtype (all-empty strings)
        arr = arr.astype(f"{arr.dtype.kind}1")
        width = 1
    rows = arr.view(np.uint8).reshape(len(arr), width * elem)
    return rows, width, elem


class NativeStringInterner:
    """String → dense uint64 id, content-exact, in first-seen order: one
    C++ pass over numpy's fixed-width row buffer per batch.  Re-interning
    the id → string directory in order reproduces every id."""

    __slots__ = ("_h", "_lib")

    def __init__(self, capacity: int = 1 << 12):
        self._lib = lib()
        self._h = self._lib.ft_intern_new(_pow2_at_least(capacity))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ft_intern_free(self._h)
            self._h = None

    @property
    def n(self) -> int:
        return self._lib.ft_intern_size(self._h)

    @_kernel("interner.intern")
    def intern(self, arr: np.ndarray):
        """→ (ids uint64 [n], first_idx int64 [n_new]): the batch row of
        each newly seen string, in id order."""
        rows, width, elem = _string_rows(arr)
        n = len(arr)
        ids = np.empty(n, np.uint64)
        first_idx = np.empty(max(n, 1), np.int64)
        n_new = self._lib.ft_intern_rows(self._h, rows, width, elem, n, ids,
                                         first_idx)
        return ids, first_idx[:n_new]


class NativeWordSums:
    """Dense per-window sums over interned word ids: ``add`` interns and
    accumulates in one C++ pass (``ft_intern_sum``); ``fire`` exports
    (id, sum) for every touched id and resets."""

    __slots__ = ("_h", "_lib")

    def __init__(self):
        self._lib = lib()
        self._h = self._lib.ft_wordsums_new()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ft_wordsums_free(self._h)
            self._h = None

    @_kernel("word_sums.add")
    def add(self, interner: NativeStringInterner, words: np.ndarray,
            weights=None):
        """→ first_idx of the newly interned words (append
        words[first_idx] to the shared id → word directory)."""
        rows, width, elem = _string_rows(words)
        n = len(words)
        first_idx = np.empty(max(n, 1), np.int64)
        if weights is None:
            w, has_w = np.zeros(1, np.float64), 0
        else:
            w, has_w = np.ascontiguousarray(weights, np.float64), 1
        n_new = self._lib.ft_intern_sum(interner._h, self._h, rows, width,
                                        elem, w, has_w, n, first_idx)
        return first_idx[:n_new]

    @property
    def touched(self) -> int:
        return self._lib.ft_wordsums_count(self._h)

    @_kernel("word_sums.fire")
    def fire(self):
        """→ (ids int64, sums float64) of the touched ids; resets."""
        k = self.touched
        ids = np.empty(k, np.int64)
        sums = np.empty(k, np.float64)
        self._lib.ft_wordsums_fire(self._h, ids, sums)
        return ids, sums

    def load(self, ids: np.ndarray, sums: np.ndarray) -> None:
        self._lib.ft_wordsums_load(
            self._h, np.ascontiguousarray(ids, np.int64),
            np.ascontiguousarray(sums, np.float64), len(ids))


# ---- interval join ----------------------------------------------------------

class NativeIntervalJoin:
    """Batched time-bounded join core: per-key time-sorted buffers in
    C++, probed one batch at a time (slot resolution for the whole batch
    first, then the range searches).  ``push`` returns the new pairs as
    global row ids per side, in push order; the caller owns the column
    storage and gathers vectorized."""

    __slots__ = ("_h", "_lib")

    def __init__(self, lower_ms: int, upper_ms: int,
                 capacity: int = 1 << 12):
        self._lib = lib()
        self._h = self._lib.ft_ivjoin_new(lower_ms, upper_ms,
                                          _pow2_at_least(capacity))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ft_ivjoin_free(self._h)
            self._h = None

    @_kernel("interval_join.push")
    def push(self, side: int, key_hashes: np.ndarray, ts: np.ndarray):
        """Probe the other side with a batch of ``side`` (0 left, 1
        right), then buffer it.  Returns (left_rows, right_rows), int64
        global row ids of the pairs with r.ts - l.ts in [lower, upper]
        and equal hashes."""
        n_pairs = self._lib.ft_ivjoin_push(
            self._h, side, np.ascontiguousarray(key_hashes, np.uint64),
            np.ascontiguousarray(ts, np.int64), len(key_hashes))
        left = np.empty(n_pairs, np.int64)
        right = np.empty(n_pairs, np.int64)
        self._lib.ft_ivjoin_pairs(self._h, left, right)
        return left, right

    def prune(self, watermark: int) -> None:
        """Drop rows no longer joinable at ``watermark`` (left rows once
        wm >= ts + upper, right rows once wm >= ts - lower)."""
        self._lib.ft_ivjoin_prune(self._h, watermark)


# ---- grouping of the generic aggregate tier ---------------------------------

@_kernel("fold_prep")
def fold_prep(keys: np.ndarray):
    """Stable radix argsort, segment detection and a length-descending
    segment layout in one C++ pass.  Returns (order, seg_starts,
    seg_lens, ukeys), segments in length-descending order (key order
    among equal lengths)."""
    keys = np.ascontiguousarray(keys, np.uint64)
    n = len(keys)
    order = np.empty(n, np.int64)
    seg_starts = np.empty(n, np.int64)
    seg_lens = np.empty(n, np.int64)
    ukeys = np.empty(n, np.uint64)
    n_seg = lib().ft_fold_prep(keys, n, order, seg_starts, seg_lens, ukeys)
    return order, seg_starts[:n_seg], seg_lens[:n_seg], ukeys[:n_seg]


@_kernel("group_cols")
def group_cols(keys: np.ndarray, cols=(), want_order: bool = True):
    """Grouping of keys below 2^22 with the payload columns
    co-scattered in the same counting-sort pass: (order, scols,
    seg_starts, seg_lens, ukeys) with segments length-descending, or
    None when a key is outside the histogram or a column is not a
    4- or 8-byte number.  ``order`` is None unless asked for."""
    keys = np.ascontiguousarray(keys, np.uint64)
    n = len(keys)
    for col in cols:
        if col.dtype.itemsize not in (4, 8) or col.dtype.kind not in "fiu":
            return None
    cols = [np.ascontiguousarray(col) for col in cols]
    scols = [np.empty(n, col.dtype) for col in cols]
    nc = len(cols)
    elem = (np.asarray([col.dtype.itemsize for col in cols], np.int64)
            if nc else np.zeros(1, np.int64))
    src = (ctypes.c_void_p * max(nc, 1))(
        *[col.ctypes.data for col in cols] or [None])
    dst = (ctypes.c_void_p * max(nc, 1))(
        *[s.ctypes.data for s in scols] or [None])
    order = np.empty(n, np.int64) if want_order else None
    seg_starts = np.empty(n, np.int64)
    seg_lens = np.empty(n, np.int64)
    ukeys = np.empty(n, np.uint64)
    n_seg = lib().ft_group_cols(
        keys, n, nc, elem, src, dst,
        order.ctypes.data if want_order else None,
        seg_starts, seg_lens, ukeys)
    if n_seg < 0:
        return None
    return (order, scols, seg_starts[:n_seg], seg_lens[:n_seg],
            ukeys[:n_seg])


@_kernel("argsort_u64")
def argsort_u64(keys: np.ndarray) -> np.ndarray:
    """Stable argsort of a uint64 column by the C++ radix sort."""
    keys = np.ascontiguousarray(keys, np.uint64)
    out = np.empty(len(keys), np.int64)
    lib().ft_argsort_u64(keys, len(keys), out)
    return out
