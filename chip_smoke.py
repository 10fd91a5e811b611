#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``flink_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught to keep the
exit code at 0):

1. ``env``      the card's name, the device count and power limit;
2. ``build``    builds the six CUDA kernels from ``flink_tpu_torch/kernels/csrc``;
3. ``kernels``  holds every kernel against its plain PyTorch version at
                the shapes the main path gives it, and times kernel,
                plain version and, where one exists, one PyTorch call
                computing the same function (CUDA events);
4. ``engine``   the window engine at BASELINE config #2: a 1M-key space,
                2^23 events in one 1 s window, HLL precision 12, 1.25M
                slots (5.12 GB of registers on the card), checked
                against an independent numpy HLL on 4,096 keys;
5. ``job``      three jobs through ``StreamExecutionEnvironment``: HLL
                unique visitors (2^21 events, 1M keys, tumbling 1 s), a
                word count (SumAggregate, 50k words, tumbling 5 s), both
                checked against numpy references, and HLL with allowed
                lateness on ``set_state_backend("gpu")`` (WindowOperator
                on the GPU keyed-state backend), checked against the
                same job on the heap backend;
6. ``keyed``    WindowOperator on the GPU keyed-state backend at config
                #2 through the test harness: 1M keys, 2^22 events in one
                1 s window, HLL p = 12 (2^20 slots, 4.29 GB of
                registers), a snapshot and restore mid-stream, one
                batched fire, checked against numpy HLL on 4,096 keys;
7. ``sessions`` session windows with HLL and Sum on the GPU backend
                capped below the live session count (spill to host RAM
                and promotion), checked against the heap backend;
8. the launch counts of phases 4-7, each path counted on its own: every
   kernel the path runs must have launched there.

Output: one JSON object per phase, then the ``kernels`` line of the
contract, then the card's name and power limit as nvidia-smi prints
them, then the last line ``{"ok": true, "device": {...}}``.  Without a
CUDA device, or without the rest of the repository beside this
script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# HBM bandwidth of the card, bytes/s (NVIDIA data sheets); the SXM
# part unless the name says otherwise.  Compute peak for the kernels'
# non-tensor-core int32/fp32 operations: 67 TFLOP/s fp32 (SXM).
_HBM = (("PCIe", 2.0e12), ("NVL", 3.9e12), ("H200", 4.8e12), ("", 3.35e12))
_OPS_PER_S = 67e12

CHECKS = []


def check(ok: bool, what: str) -> None:
    CHECKS.append(what)
    if not ok:
        raise AssertionError(what)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------

def cuda_ms(fn, reps: int = 10, setup=None) -> float:
    """Median device time of fn over reps (after one warm-up), each
    run bracketed by CUDA events; setup runs untimed before each."""
    import torch
    times = []
    for i in range(reps + 1):
        if setup is not None:
            setup()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        if i:
            times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def max_abs_err(a, b) -> float:
    """Largest |a - b| over two tensors of one shape, compared in
    float64 a block of rows at a time (the register file is 5 GB)."""
    rows = max(1, (1 << 26) // max(1, a[0].numel()))
    return max(float((a[i:i + rows].double() - b[i:i + rows].double())
                     .abs().max()) for i in range(0, a.shape[0], rows))


def bound(nbytes: float, ops: float, hbm: float):
    t_bytes, t_ops = nbytes / hbm * 1e3, ops / _OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def clz32_np(x: np.ndarray) -> np.ndarray:
    """Leading zeros by binary search (independent of the port's
    SWAR and log2 forms)."""
    x = x.astype(np.uint64)
    n = np.zeros(x.shape, np.int64)
    for s in (16, 8, 4, 2, 1):
        small = x < (np.uint64(1) << np.uint64(32 - s))
        n += np.where(small, s, 0)
        x = np.where(small, x << np.uint64(s), x)
    return np.where(x == 0, 32, n)


def splitmix64_np(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64)
    with np.errstate(over="ignore"):
        x = x + np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def hll_reference(group: np.ndarray, vh: np.ndarray, n_groups: int,
                  p: int) -> np.ndarray:
    """HLL estimate per group from value hashes: registers by
    np.maximum.at, then the estimator in float32 as the port computes
    it (alpha * m * m rounded at each step; correctly rounded float32
    logs in the linear-counting branch, whose cancellation would
    otherwise turn one ulp of log into ~4e-3 relative)."""
    m = 1 << p
    hi = (vh >> np.uint64(32)).astype(np.uint32)
    lo = (vh & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    regs = np.zeros((n_groups, m), np.uint8)
    np.maximum.at(regs, (group, (lo & np.uint32(m - 1)).astype(np.int64)),
                  (clz32_np(hi) + 1).astype(np.uint8))
    alpha = 0.7213 / (1.0 + 1.079 / m) if m >= 128 else \
        {16: 0.673, 32: 0.697, 64: 0.709}[m]
    mf = np.float32(m)
    am2 = np.float32(np.float32(alpha) * mf) * mf
    est = am2 / np.exp2(-regs.astype(np.float64)).sum(axis=1).astype(np.float32)
    zeros = (regs == 0).sum(axis=1)
    log32 = lambda x: np.log(np.float64(x)).astype(np.float32)   # noqa: E731
    linear = mf * (log32(m) - log32(np.maximum(zeros, 1)))
    return np.where((est <= 2.5 * mf) & (zeros > 0), linear, est)


# ---------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------

def kernel_phase(dev, hbm: float):
    import torch
    from flink_tpu_torch import kernels as K
    from flink_tpu_torch.ops.sketches import HyperLogLogAggregate

    rng = np.random.default_rng(11)
    C, P, N = 1_250_000, 12, 1 << 20
    m = 1 << P
    agg = HyperLogLogAggregate(P)
    entries, detail = {}, []

    # hll_update: 2^20 rows into [1.25M, 4096] (5.12 GB), the main
    # path's compressed form (rank uint8, register uint16) and raw lanes
    slots_np = rng.integers(0, 1_000_000, N).astype(np.int32)
    vh = splitmix64_np(rng.integers(0, 2**63, N, dtype=np.int64))
    hi_np = (vh >> np.uint64(32)).astype(np.uint32)
    lo_np = (vh & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    rank_np, reg_np = agg.compress_value_hash(hi_np, lo_np)
    slots = torch.from_numpy(slots_np).to(dev)
    rank = torch.from_numpy(rank_np).to(dev)
    reg = torch.from_numpy(reg_np.view(np.int16)).to(dev)
    hi = torch.from_numpy(hi_np.view(np.int32)).to(dev)
    lo = torch.from_numpy(lo_np.view(np.int32)).to(dev)
    regs = torch.zeros((C, m), dtype=torch.uint8, device=dev)
    ref = torch.zeros_like(regs)
    K.hll_update(regs, slots, rank, reg, N)
    K.hll_update_plain(ref, slots, rank, reg, N)
    torch.cuda.synchronize()
    check(torch.equal(regs, ref), "hll_update (compressed) registers bit-equal")
    regs_raw = torch.zeros_like(regs)
    K.hll_update(regs_raw, slots, hi, lo, N)
    torch.cuda.synchronize()
    check(torch.equal(regs_raw, ref), "hll_update (raw lanes) registers bit-equal")
    update_err = max(max_abs_err(regs, ref), max_abs_err(regs_raw, ref))
    del regs_raw
    words = np.unique((slots_np.astype(np.int64) * m + reg_np) // 4).size
    zero = lambda t: (lambda: K.clear_rows(t, 0))          # noqa: E731
    ms = cuda_ms(lambda: K.hll_update(regs, slots, rank, reg, N), 5, zero(regs))
    plain = cuda_ms(lambda: K.hll_update_plain(ref, slots, rank, reg, N), 5,
                    zero(ref))
    flat_idx = slots.to(torch.int64) * m + reg.to(torch.int64)
    lib = cuda_ms(lambda: ref.view(-1).scatter_reduce_(0, flat_idx, rank, "amax"),
                  5, zero(ref))
    b, by = bound(7 * N + 8 * words, 3 * N, hbm)
    entries["hll_update"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                 bound_ms=b, bound_by=by, max_abs_err=update_err)
    detail.append({"kernel": "hll_update", "rows": N, "slots": C,
                   "distinct_words": int(words), "library": "scatter_reduce_ amax"})
    # the keyed backend's flush: 16384 rows of raw hash lanes
    nf = 16384
    fwords = np.unique((slots_np[:nf].astype(np.int64) * m + reg_np[:nf]) // 4).size
    detail.append({"kernel": "hll_update", "form": "raw", "rows": nf, "ms": cuda_ms(
        lambda: K.hll_update(regs, slots[:nf], hi[:nf], lo[:nf], nf)),
        "bound_ms": bound(12 * nf + 8 * fwords, 3 * nf, hbm)[0]})

    # hll_estimate: dense over 1.25M slots, gathered over 2^18 slots,
    # on the registers hll_update left (the main path's fire input)
    K.hll_update(regs, slots, rank, reg, N)
    got = K.hll_estimate(regs, agg.alpha)
    want = K.hll_estimate_plain(regs, agg.alpha)
    err_dense = float((got - want).abs().max())
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5)
    gslots = torch.from_numpy(rng.integers(0, C, 1 << 18).astype(np.int32)).to(dev)
    got_g = K.hll_estimate(regs, agg.alpha, slots=gslots)
    want_g = K.hll_estimate_plain(regs, agg.alpha, slots=gslots)
    np.testing.assert_allclose(got_g.cpu().numpy(), want_g.cpu().numpy(), rtol=1e-5)
    check(True, "hll_estimate within rtol 1e-5 (dense and gathered)")
    ms = cuda_ms(lambda: K.hll_estimate(regs, agg.alpha))
    plain = cuda_ms(lambda: K.hll_estimate_plain(regs, agg.alpha), 3)
    b, by = bound(C * m + 4 * C, 5 * C * m, hbm)
    entries["hll_estimate"] = dict(
        ms=ms, plain_ms=plain, library_ms=None, bound_ms=b, bound_by=by,
        max_abs_err=max(err_dense, float((got_g - want_g).abs().max())))
    gms = cuda_ms(lambda: K.hll_estimate(regs, agg.alpha, slots=gslots))
    detail.append({"kernel": "hll_estimate", "dense_rows": C,
                   "gathered_rows": 1 << 18, "gathered_ms": gms,
                   "gathered_bound_ms": bound((1 << 18) * (m + 8), 0, hbm)[0]})

    # clear_rows: range form over the whole arena (the full-fire
    # re-init) and list form over 2^18 slots
    K.clear_rows(regs, 0, slots=gslots)
    ref.copy_(regs)
    K.clear_rows_plain(ref, 0, slots=gslots)
    check(torch.equal(regs, ref), "clear_rows list form equal")
    clear_err = max_abs_err(regs, ref)
    K.clear_rows(regs, 0)
    check(int(regs.max()) == 0, "clear_rows range form filled the arena")
    ms = cuda_ms(lambda: K.clear_rows(regs, 0))
    plain = cuda_ms(lambda: K.clear_rows_plain(regs, 0))
    lib = cuda_ms(lambda: regs.fill_(0))
    b, by = bound(C * m, 0, hbm)
    entries["clear_rows"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                 bound_ms=b, bound_by=by, max_abs_err=clear_err)
    lms = cuda_ms(lambda: K.clear_rows(regs, 0, slots=gslots))
    detail.append({"kernel": "clear_rows", "range_rows": C, "list_rows": 1 << 18,
                   "list_ms": lms,
                   "list_bound_ms": bound((1 << 18) * (m + 4), 0, hbm)[0],
                   "library": "fill_"})
    del regs, ref, flat_idx
    torch.cuda.empty_cache()

    # scatter_combine: add/min/max in f32 and i32, 2^20 rows into 50k
    # slots, integer-valued data (float atomics add it exactly)
    S = 50_000
    cslots_np = rng.integers(0, S, N).astype(np.int32)
    cslots = torch.from_numpy(cslots_np).to(dev)
    distinct = np.unique(cslots_np).size
    for dt in (torch.float32, torch.int32):
        vals = torch.from_numpy(rng.integers(-1000, 1000, N)).to(dt).to(dev)
        for op in ("add", "min", "max"):
            base = torch.from_numpy(rng.integers(-50, 50, S)).to(dt).to(dev)
            got, want = base.clone(), base.clone()
            K.scatter_combine(got, cslots, vals, N, op)
            K.scatter_combine_plain(want, cslots, vals, N, op)
            check(torch.equal(got, want), f"scatter_combine {op} {dt} exact")
            err = max_abs_err(got, want)
            ms = cuda_ms(lambda: K.scatter_combine(got, cslots, vals, N, op))
            if op == "add":
                lib = cuda_ms(lambda: want.index_add_(0, cslots, vals))
            else:
                lib = cuda_ms(lambda: want.scatter_reduce_(
                    0, cslots.to(torch.int64), vals, "amin" if op == "min" else "amax"))
            plain = cuda_ms(lambda: K.scatter_combine_plain(got, cslots, vals, N, op))
            b, by = bound(8 * N + 8 * distinct, N, hbm)
            row = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b,
                       bound_by=by, max_abs_err=err)
            detail.append({"kernel": "scatter_combine", "op": op,
                           "dtype": str(dt), **row})
            if op == "add" and dt == torch.float32:   # the word count's form
                entries["scatter_combine"] = row
    del cslots
    # Sum / Avg result: a tensor gather (no kernel of the port), 2^18
    # fired slots of a 1.25M-slot state, as the keyed backend's fire reads
    from flink_tpu_torch.ops.device_agg import AvgAggregate, SumAggregate
    fired = torch.from_numpy(rng.integers(0, C, 1 << 18).astype(np.int32)).to(dev)
    for agg_ in (SumAggregate(np.float32), AvgAggregate()):
        st = agg_.init_state(C, device=dev)
        detail.append({"kernel": "result gather", "aggregate": type(agg_).__name__,
                       "rows": 1 << 18, "ms": cuda_ms(lambda: agg_.result(st, fired)),
                       "bound_ms": bound((1 << 18) * (4 + 4 * len(st) + 4), 0, hbm)[0]})
    del st
    merge_set_entries(dev, hbm, rng, entries, detail)
    emit({"kernel_variants": detail})
    return entries


def merge_set_entries(dev, hbm, rng, entries, detail):
    """merge_rows in both modes (u8 max, f32 add, i32 add; repeated dst
    in the atomic mode) and set_rows, each against its plain version."""
    import torch
    from flink_tpu_torch import kernels as K

    def pairs(c, k, repeat):
        perm = rng.permutation(c).astype(np.int32)
        if repeat:                  # k sources folded into k // 4 targets
            dst = np.repeat(perm[: max(1, k // 4)], 4)[:k]
            src = perm[k // 4 + 1: k // 4 + 1 + k]
        else:
            dst, src = perm[:k], perm[k: 2 * k]
        return (torch.from_numpy(dst).to(dev), torch.from_numpy(src).to(dev))

    def library_merge(comp, dst, src, op):
        d = dst.to(torch.int64)
        rows = comp[src.to(torch.int64)]
        if op == "add":
            comp.index_add_(0, d, rows)
        else:
            comp.index_reduce_(0, d, rows, "amax")

    # shapes: the session phase's register file and sum column, and the
    # batched merge's shape (2^14 pairs over a 2^20-row file)
    cases = [("u8 max", (1 << 20, 4096), torch.uint8, "max", 1 << 14),
             ("u8 max session", (4096, 4096), torch.uint8, "max", 2),
             ("f32 add", (1 << 20,), torch.float32, "add", 1 << 16),
             ("i32 add", (1 << 20,), torch.int32, "add", 1 << 16)]
    for label, shape, dt, op, k in cases:
        hi = 30 if dt == torch.uint8 else 1000
        base = torch.randint(0, hi, shape, dtype=dt, device=dev)
        row_bytes = base[0].numel() * base.element_size()
        for unique in (False, True):
            dst, src = pairs(shape[0], k, repeat=not unique)
            got, want = base.clone(), base.clone()
            K.merge_rows(got, dst, src, op, unique_dst=unique)
            K.merge_rows_plain(want, dst, src, op, unique_dst=unique)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"merge_rows {label} unique={unique} bit-equal")
            err = max_abs_err(got, want)
            ms = cuda_ms(lambda: K.merge_rows(got, dst, src, op, unique_dst=unique))
            plain = cuda_ms(lambda: K.merge_rows_plain(want, dst, src, op,
                                                       unique_dst=unique), 3)
            lib = cuda_ms(lambda: library_merge(want, dst, src, op))
            # each src row read, each distinct dst row read and written
            targets = int(torch.unique(dst).numel())
            b, by = bound(k * (row_bytes + 8) + 2 * targets * row_bytes, 0, hbm)
            row = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b,
                       bound_by=by, max_abs_err=err)
            detail.append({"kernel": "merge_rows", "case": label, "rows": k,
                           "unique_dst": unique, "library": "gather + "
                           + ("index_add_" if op == "add" else "index_reduce_ amax"),
                           **row})
            if label == "u8 max session" and not unique:  # the main path's form
                entries["merge_rows"] = row
        del base, got, want
    torch.cuda.empty_cache()

    # set_rows: a restore's key-group block (8192 rows of 4096 B) into a
    # 2^20-row file, and the promotion's single row, from the host
    c, n, m = 1 << 20, 8192, 4096
    regs = torch.zeros((c, m), dtype=torch.uint8, device=dev)
    slots = torch.from_numpy(rng.choice(c, n, replace=False).astype(np.int32)).to(dev)
    rows_host = torch.from_numpy(rng.integers(0, 40, (n, m)).astype(np.uint8))
    rows = rows_host.to(dev)
    want = regs.clone()
    K.set_rows(regs, slots, rows_host)          # through pinned staging
    K.set_rows_plain(want, slots, rows)
    torch.cuda.synchronize()
    check(torch.equal(regs, want), "set_rows bit-equal (rows from the host)")
    err = max_abs_err(regs, want)
    ms = cuda_ms(lambda: K.set_rows(regs, slots, rows))
    plain = cuda_ms(lambda: K.set_rows_plain(want, slots, rows))
    s64 = slots.to(torch.int64)
    lib = cuda_ms(lambda: want.index_copy_(0, s64, rows))
    b, by = bound(n * (2 * m + 4), 0, hbm)
    entries["set_rows"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                               bound_ms=b, bound_by=by, max_abs_err=err)
    host_ms = cuda_ms(lambda: K.set_rows(regs, slots, rows_host), 5)
    one = slots[:1]
    one_ms = cuda_ms(lambda: K.set_rows(regs, one, rows_host[:1]), 5)
    detail.append({"kernel": "set_rows", "rows": n, "row_bytes": m,
                   "from_host_ms": host_ms, "one_row_from_host_ms": one_ms,
                   "library": "index_copy_"})
    del regs, want, rows, rows_host
    torch.cuda.empty_cache()



# ---------------------------------------------------------------------
# phase 4: the window engine at config #2
# ---------------------------------------------------------------------

def engine_phase(dev):
    import torch
    from flink_tpu_torch.ops.sketches import HyperLogLogAggregate
    from flink_tpu_torch.streaming.vectorized import VectorizedTumblingWindows

    n_events, n_keys, p = 1 << 23, 1_000_000, 12
    rng = np.random.default_rng(7)
    keys = rng.integers(0, n_keys, n_events).astype(np.uint64)
    ts = np.sort(rng.integers(0, 1000, n_events).astype(np.int64))
    users = rng.integers(0, 2**63, n_events).astype(np.uint64)
    kh, vh = splitmix64_np(keys), splitmix64_np(users)
    torch.cuda.reset_peak_memory_stats(dev)
    eng = VectorizedTumblingWindows(HyperLogLogAggregate(p), 1000,
                                    initial_capacity=n_keys + n_keys // 4,
                                    microbatch=1 << 20, device=dev)
    eng.emit_arrays = True
    chunk = 1 << 20
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(0, n_events, chunk):
        sl = slice(i, i + chunk)
        eng.process_batch(kh[sl], ts[sl], None, key_hashes=kh[sl],
                          value_hashes=vh[sl])
    eng.flush()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    eng.advance_watermark(999)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    fired_keys = np.concatenate([k for k, _, _, _ in eng.fired])
    fired_res = np.concatenate([r for _, r, _, _ in eng.fired])
    distinct = np.unique(keys).size
    check(len(fired_keys) > 0.9 * distinct, "engine fired > 0.9 x distinct keys")
    check(np.isfinite(fired_res).all(), "engine estimates finite")
    sample = rng.choice(fired_keys, 4096, replace=False)
    order = np.argsort(sample)
    sample = sample[order]
    sel = np.isin(kh, sample)
    want = hll_reference(np.searchsorted(sample, kh[sel]), vh[sel], len(sample), p)
    pos = {int(k): i for i, k in enumerate(fired_keys)}
    got = np.array([fired_res[pos[int(k)]] for k in sample])
    np.testing.assert_allclose(got, want, rtol=1e-5)
    check(True, "engine sample of 4096 keys within rtol 1e-5 of numpy HLL")
    out = {"engine": {
        "events": n_events, "keys": n_keys, "precision": p,
        "capacity": eng.capacity, "register_bytes": eng.capacity * (1 << p),
        "fired": int(len(fired_keys)), "distinct_keys": int(distinct),
        "events_per_s": n_events / (t2 - t0), "ingest_s": t1 - t0,
        "fire_s": t2 - t1,
        "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
        "max_rel_err_vs_numpy": float(np.max(np.abs(got - want) / want))}}
    del eng
    torch.cuda.empty_cache()
    emit(out)


# ---------------------------------------------------------------------
# phase 5: two jobs through the DataStream API
# ---------------------------------------------------------------------

def _run_job(agg, events, size_ms, dev):
    from flink_tpu_torch.streaming.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.streaming.sources import (
        BoundedOutOfOrdernessTimestampExtractor, CollectSink)
    from flink_tpu_torch.streaming.windowing import TumblingEventTimeWindows
    agg.extract_value = lambda e: e[1]
    out = []
    env = StreamExecutionEnvironment.get_execution_environment(device=dev)
    (env.from_collection(events)
        .assign_timestamps_and_watermarks(
            BoundedOutOfOrdernessTimestampExtractor(0, lambda e: e[2]))
        .key_by(lambda e: e[0])
        .window(TumblingEventTimeWindows.of(size_ms))
        .aggregate(agg, window_function=lambda k, w, vals: [(k, w.start, vals[0])])
        .add_sink(CollectSink(out)))
    t0 = time.perf_counter()
    env.execute("chip-smoke")
    return out, time.perf_counter() - t0


def job_phase(dev):
    import torch
    from flink_tpu_torch.ops.device_agg import SumAggregate
    from flink_tpu_torch.ops.sketches import HyperLogLogAggregate

    rng = np.random.default_rng(5)
    # HLL unique visitors: 2^21 events, 1M keys, tumbling 1 s over 4 s
    n, n_keys, p = 1 << 21, 1_000_000, 12
    keys = rng.integers(0, n_keys, n)
    users = rng.integers(0, 1 << 40, n)
    ts = np.sort(rng.integers(0, 4000, n))
    events = list(zip(keys.tolist(), users.tolist(), ts.tolist()))
    out, secs = _run_job(HyperLogLogAggregate(p), events, 1000, dev)
    torch.cuda.synchronize()
    pairs = keys * 4 + ts // 1000
    upairs = np.unique(pairs)
    got_pairs = np.array(sorted(k * 4 + s // 1000 for k, s, _ in out))
    check(np.array_equal(got_pairs, upairs), "HLL job (key, window) set exact")
    res = {k * 4 + s // 1000: v for k, s, v in out}
    sample = np.sort(rng.choice(upairs, 4096, replace=False))
    sel = np.isin(pairs, sample)
    want = hll_reference(np.searchsorted(sample, pairs[sel]),
                         splitmix64_np(users[sel]), len(sample), p)
    got = np.array([res[int(q)] for q in sample])
    np.testing.assert_allclose(got, want, rtol=1e-5)
    check(True, "HLL job sample of 4096 pairs within rtol 1e-5 of numpy HLL")
    hll = {"events": n, "pairs": int(len(upairs)), "seconds": secs,
           "events_per_s": n / secs}

    # word count: SumAggregate over 50k word ids, tumbling 5 s
    n, n_words = 1 << 20, 50_000
    words = rng.integers(0, n_words, n)
    ts = np.sort(rng.integers(0, 10_000, n))
    events = list(zip(words.tolist(), [1.0] * n, ts.tolist()))
    out, secs = _run_job(SumAggregate(np.float64), events, 5000, dev)
    pairs, counts = np.unique(words * 2 + ts // 5000, return_counts=True)
    got = dict(((k * 2 + s // 5000), v) for k, s, v in out)
    check(len(got) == len(pairs) and all(got[int(q)] == c for q, c in
                                        zip(pairs, counts)),
          "word count job exact")
    wordcount = {"events": n, "pairs": int(len(pairs)), "seconds": secs,
                 "events_per_s": n / secs}
    emit({"job": {"hll": hll, "wordcount": wordcount,
                  "keyed_backend": keyed_job(dev, rng)}})


def _run_keyed_job(agg, events, dev, backend):
    from flink_tpu_torch.streaming.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.streaming.sources import (
        BoundedOutOfOrdernessTimestampExtractor, CollectSink)
    from flink_tpu_torch.streaming.windowing import TumblingEventTimeWindows
    agg.extract_value = lambda e: e[1]
    out = []
    env = StreamExecutionEnvironment.get_execution_environment(device=dev)
    env.set_state_backend(backend)
    (env.from_collection(events)
        .assign_timestamps_and_watermarks(
            BoundedOutOfOrdernessTimestampExtractor(0, lambda e: e[2]))
        .key_by(lambda e: e[0])
        .window(TumblingEventTimeWindows.of(1000))
        .allowed_lateness(500)
        .aggregate(agg, window_function=lambda k, w, vals: [(k, w.start, vals[0])])
        .add_sink(CollectSink(out)))
    t0 = time.perf_counter()
    env.execute("chip-smoke-keyed")
    return out, time.perf_counter() - t0


def keyed_job(dev, rng):
    """HLL p = 12 with allowed lateness through set_state_backend("gpu")
    (WindowOperator on the GPU backend; late records within the
    lateness refire their window), against the same job on the heap
    backend."""
    import torch
    from flink_tpu_torch.ops.sketches import HyperLogLogAggregate
    n, n_keys = 1 << 13, 500
    ts = np.sort(rng.integers(0, 8000, n))
    late = rng.choice(n, 100, replace=False)
    ts[late] = np.maximum(ts[late] - rng.integers(0, 1500, 100), 0)
    events = list(zip(rng.integers(0, n_keys, n).tolist(),
                      rng.integers(0, 1 << 40, n).tolist(), ts.tolist()))
    got, secs = _run_keyed_job(HyperLogLogAggregate(12), events, dev, "gpu")
    torch.cuda.synchronize()
    want, heap_secs = _run_keyed_job(HyperLogLogAggregate(12), events, "cpu", "heap")
    check([r[:2] for r in got] == [r[:2] for r in want]
          and len(got) > len({r[:2] for r in got}),
          "keyed-backend job: the heap backend's windows, late refires included")
    np.testing.assert_allclose([r[2] for r in got], [r[2] for r in want],
                               rtol=1e-5, atol=hll_atol(4096))
    check(True, "keyed-backend job: estimates within rtol 1e-5 (+ log slack) of heap")
    return {"events": n, "results": len(got), "seconds": secs,
            "events_per_s": n / secs, "heap_seconds": heap_secs}


# ---------------------------------------------------------------------
# phase 6: the keyed-state backend at config #2
# ---------------------------------------------------------------------

def _uv_operator(p):
    """WindowOperator(tumbling 1 s, HLL p) over (user_id, visitor)
    rows: the value column is the batch's second column."""
    from flink_tpu_torch.core.state import AggregatingStateDescriptor
    from flink_tpu_torch.ops.sketches import HyperLogLogAggregate
    from flink_tpu_torch.streaming.window_operator import WindowOperator
    from flink_tpu_torch.streaming.windowing import TumblingEventTimeWindows

    class VisitorHll(HyperLogLogAggregate):
        def extract_value(self, value):
            return value[1]

        def extract_column(self, values):
            return values[1]

    return WindowOperator(TumblingEventTimeWindows.of(1000),
                          AggregatingStateDescriptor("uv", VisitorHll(p)),
                          window_function=lambda k, w, vals: [(k, vals[0])])


def _time_calls(obj, name, into) -> None:
    """Wrap obj.name so that its wall time adds up in into[name]."""
    fn = getattr(obj, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            into[name] = into.get(name, 0.0) + time.perf_counter() - t0
    setattr(obj, name, timed)


def keyed_phase(dev, n_events=1 << 22, n_keys=1_000_000, chunk=1 << 20):
    """OneInputStreamOperatorTestHarness(WindowOperator(tumbling 1 s,
    HLL p = 12), state_backend="gpu") fed RecordBatches of (key,
    visitor) rows: 1M keys, 2^22 events in one window, a snapshot and a
    restore into a fresh harness after half the events, one watermark
    firing the window through on_watermark_batch."""
    import torch
    from flink_tpu_torch.core.keygroups import stable_hash64
    from flink_tpu_torch.streaming.elements import RecordBatch
    from flink_tpu_torch.streaming.harness import OneInputStreamOperatorTestHarness

    p = 12
    rng = np.random.default_rng(17)
    keys = rng.integers(0, n_keys, n_events)
    visitors = rng.integers(0, 2**62, n_events)
    ts = np.sort(rng.integers(0, 1000, n_events))

    split = {}       # host seconds by call, across both harnesses

    def harness():
        h = OneInputStreamOperatorTestHarness(
            _uv_operator(p), key_selector=0, state_backend="gpu", device=dev)
        h.open()
        for obj, names in ((h.keyed_backend, ("add_batch", "get_batch", "clear_batch")),
                           (h.operator.timer_service, ("register_event_time_timers_bulk",
                                                       "pop_due_event_time_timers")),
                           (h.operator.window_state, ("_flush",))):
            for fn_name in names:
                _time_calls(obj, fn_name, split)
        return h

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    at_start = torch.cuda.memory_allocated(dev)
    h = harness()
    times = {"ingest_s": 0.0}
    for i in range(0, n_events, chunk):
        if i == n_events // 2:          # the round trip, mid-stream
            t0 = time.perf_counter()
            snap = h.snapshot()
            t1 = time.perf_counter()
            snap_bytes = snap["keyed"].total_bytes
            del h
            gc.collect()        # the operator and its timer service form a cycle
            torch.cuda.empty_cache()
            h = harness()
            h.initialize_state(snap)
            torch.cuda.synchronize()
            times["snapshot_s"], times["restore_s"] = t1 - t0, time.perf_counter() - t1
            del snap
        sl = slice(i, i + chunk)
        t0 = time.perf_counter()
        h.process_batch(RecordBatch({"f0": keys[sl], "f1": visitors[sl]}, ts=ts[sl]))
        torch.cuda.synchronize()
        times["ingest_s"] += time.perf_counter() - t0
    state = h.operator.window_state
    capacity = state.capacity
    t0 = time.perf_counter()
    h.process_watermark(999)
    torch.cuda.synchronize()
    times["fire_s"] = time.perf_counter() - t0
    out = h.extract_output_values()
    distinct = np.unique(keys)
    check(len(out) == len(distinct), "keyed phase fired every live key once")
    check(capacity * (1 << p) >= 4e9, "keyed phase holds >= 4 GB of registers")
    res = dict(out)
    sample = np.sort(rng.choice(distinct, 4096, replace=False))
    sel = np.isin(keys, sample)
    vh = np.fromiter((stable_hash64(int(v)) for v in visitors[sel]), np.uint64,
                     int(sel.sum()))
    want = hll_reference(np.searchsorted(sample, keys[sel]), vh, len(sample), p)
    got = np.array([res[int(k)] for k in sample])
    np.testing.assert_allclose(got, want, rtol=1e-5)
    check(True, "keyed phase sample of 4096 keys within rtol 1e-5 of numpy HLL")
    check(len(state.slot_index) == 0, "keyed phase freed every slot after the fire")
    out = {"keyed": {
        "events": n_events, "keys": n_keys, "live_keys": int(len(distinct)),
        "precision": p, "capacity": capacity,
        "register_bytes": capacity * (1 << p),
        "events_per_s": n_events / times["ingest_s"], **times,
        "snapshot_bytes": snap_bytes, "host_split_s": split,
        "memory_allocated_at_start": at_start,
        "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
        "max_rel_err_vs_numpy": float(np.max(np.abs(got - want) / want))}}
    del h, state
    torch.cuda.empty_cache()
    emit(out)


# ---------------------------------------------------------------------
# phase 7: session merges and the host-RAM spill tier
# ---------------------------------------------------------------------

def hll_atol(m: int) -> float:
    """One float32 ulp of log(m) for each of the linear-counting logs."""
    return float(2 * m * np.spacing(np.float32(np.log(m))))


def _session_run(agg, events, backend, dev, **kw):
    from flink_tpu_torch.core.state import AggregatingStateDescriptor
    from flink_tpu_torch.streaming.harness import OneInputStreamOperatorTestHarness
    from flink_tpu_torch.streaming.window_operator import WindowOperator
    from flink_tpu_torch.streaming.windowing import EventTimeSessionWindows
    agg.extract_value = lambda e: e[1]
    op = WindowOperator(EventTimeSessionWindows.with_gap(300),
                        AggregatingStateDescriptor("session", agg),
                        window_function=lambda k, w, vals: [(k, w.start, w.end, vals[0])])
    h = OneInputStreamOperatorTestHarness(op, key_selector=lambda e: e[0],
                                          state_backend=backend, device=dev, **kw)
    h.open()
    t0 = time.perf_counter()
    for i, e in enumerate(events):
        h.process_element(e, e[2])
        if i % 2000 == 1999:
            h.process_watermark(e[2] - 1500)
    h.process_watermark(2**62)
    return h.extract_output_values(), op.window_state, time.perf_counter() - t0


def session_phase(dev, n=20_000, n_keys=2_000):
    """EventTimeSessionWindows (gap 300 ms) with HLL p = 12 and with
    Sum, on the gpu backend capped at 1024 device slots (below the live
    session count, so cold sessions spill to host RAM and come back),
    against the same job on the heap backend."""
    import torch
    from flink_tpu_torch.ops.device_agg import SumAggregate
    from flink_tpu_torch.ops.sketches import HyperLogLogAggregate

    rng = np.random.default_rng(23)
    span = 10 * n_keys
    ts = np.sort(rng.integers(0, span, n))
    ts[1::9] -= rng.integers(0, 1200, len(ts[1::9]))    # out of order
    events = list(zip(rng.integers(0, n_keys, n).tolist(),
                      rng.integers(0, 1000, n).tolist(), np.maximum(ts, 0).tolist()))
    cap = dict(max_device_slots=1024, initial_capacity=256, microbatch=256)
    out = {}
    for name, make in (("hll", lambda: HyperLogLogAggregate(12)),
                       ("sum", lambda: SumAggregate(np.float64))):
        got, st, secs = _session_run(make(), events, "gpu", dev, **cap)
        torch.cuda.synchronize()
        want, _, heap_secs = _session_run(make(), events, "heap", "cpu")
        check(st.evictions > 0 and st.promotions > 0,
              f"session {name}: sessions spilled to host RAM and came back")
        check([r[:3] for r in got] == [r[:3] for r in want] and len(got) > n_keys,
              f"session {name}: the same sessions as the heap backend")
        vals = np.array([r[3] for r in got]), np.array([r[3] for r in want])
        if name == "sum":
            check(np.array_equal(*vals), "session sum: exact against heap")
        else:
            np.testing.assert_allclose(*vals, rtol=1e-5, atol=hll_atol(4096))
            check(True, "session hll: within rtol 1e-5 (+ log slack) of heap")
        out[name] = {"sessions": len(got), "seconds": secs, "heap_seconds": heap_secs,
                     "evictions": st.evictions, "promotions": st.promotions,
                     "capacity": st.capacity}
    emit({"sessions": {"events": n, "keys": n_keys, **out}})


# ---------------------------------------------------------------------

SOURCES = {
    "hll_update": ("flink_tpu_torch/kernels/csrc/hll_update.cu",
                   "flink_tpu/ops/sketches.py:79"),
    "hll_estimate": ("flink_tpu_torch/kernels/csrc/hll_estimate.cu",
                     "flink_tpu/ops/sketches.py:100"),
    "scatter_combine": ("flink_tpu_torch/kernels/csrc/scatter_combine.cu",
                        "flink_tpu/ops/device_agg.py:271"),
    "clear_rows": ("flink_tpu_torch/kernels/csrc/clear_rows.cu",
                   "flink_tpu/streaming/vectorized.py:413"),
    "merge_rows": ("flink_tpu_torch/kernels/csrc/merge_rows.cu",
                   "flink_tpu/state/tpu_backend.py:137"),
    "set_rows": ("flink_tpu_torch/kernels/csrc/set_rows.cu",
                 "flink_tpu/state/tpu_backend.py:133"),
}

#: main-path runs, each with the kernels it must launch
PATHS = (("engine", "engine_phase", ("hll_update", "hll_estimate", "clear_rows")),
         ("jobs", "job_phase", ("hll_update", "hll_estimate", "scatter_combine",
                                "clear_rows")),
         ("keyed", "keyed_phase", ("hll_update", "hll_estimate", "clear_rows",
                                   "set_rows")),
         ("sessions", "session_phase", ("hll_update", "hll_estimate",
                                        "scatter_combine", "clear_rows",
                                        "merge_rows", "set_rows")))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "flink_tpu_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(flink_tpu_torch/ is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from flink_tpu_torch import kernels as K

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    hbm = next(rate for tag, rate in _HBM if tag in name)
    emit({"env": {"device": name, "count": torch.cuda.device_count(),
                  "nvidia_smi": smi, "torch": torch.__version__,
                  "cuda": torch.version.cuda, "hbm_bytes_per_s": hbm}})
    emit({"build": {"seconds": K.build_all()}})

    entries = kernel_phase(dev, hbm)
    per_path = {}
    for path, phase, needs in PATHS:
        K.reset_launch_counts()             # each main-path run starts here
        globals()[phase](dev)
        per_path[path] = dict(K.LAUNCHES)
        for kname in needs:
            check(per_path[path][kname] > 0, f"{kname} launched on the {path} path")
    emit({"launches": per_path})
    launches = {k: sum(p[k] for p in per_path.values()) for k in K.KERNELS}
    for kname in K.KERNELS:
        check(launches[kname] > 0, f"{kname} launched on the main path")
    rows = [{"name": kname, "route": "cuda", "source": SOURCES[kname][0],
             "replaces": SOURCES[kname][1], "launches": launches[kname],
             **entries[kname]} for kname in K.KERNELS]
    emit({"checks": CHECKS})
    emit({"kernels": rows})
    print(smi)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
