#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``flink_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught to keep the
exit code at 0):

1. ``env``      the card's name, the device count and power limit;
2. ``build``    builds the eighteen CUDA kernels from
                ``flink_tpu_torch/kernels/csrc`` (one nvcc per source,
                started together) and, beside them, the port's C++ host
                runtime (``flink_tpu_torch/native``, g++);
3. ``kernels``  holds every kernel against its plain PyTorch version at
                the shapes the main path gives it, and times kernel,
                plain version and, where one exists, one PyTorch call
                computing the same function (CUDA events around a run of
                back-to-back calls, / the count; one call per event pair
                where a call needs an untimed setup or reads the host;
                each ``kernel_variants`` entry names its ``timer``);
                ``hll_log_finish`` on the compacted cells of 2^23
                config #2 events, ``table_insert`` with 2^20 records
                into 1.5M positions (empty, half full, all hits,
                regional), compared as key -> slot maps;
                ``scatter_combine`` at its entry (2^20 rows into 50k
                slots; float32 min / max with NaN, +-0 and +-inf against
                the plain version) and at the graph path's shape (the
                scale-22 graph's 67.1M float32 and 134.2M int32 min
                messages, beside ``scatter_reduce_``);
                ``chain_route`` on 2^20 rows of config #2 events (route
                mode to 4 and 128 channels, plain, window mode over
                negative timestamps, and the mesh leg's 8 row shards with
                40 composite classes), bit-equal to its plain version,
                its launch timed as a run without the host read of the
                class starts, beside the same function in PyTorch calls
                (classes included);
                ``shard_pack`` on the mesh path's two layouts (8
                sources of 2^17 rows: the scatter tier's lanes with
                hashed targets, the mesh log's 6-lane rows with a cap),
                bit-equal to its plain version;
                ``gather_segment_sum`` on the plan of a Graph500
                scale-22 graph's edges (the plan's build timed on its
                own; two launches bit-identical; beside a CSR SpMV and
                ``index_add_``), ``edge_popcount`` on a scale-18 bitset
                (8.6 GB),
                ``gram_accumulate`` on MovieLens-20M-shaped ratings,
                ``knn_topk`` on MNIST-shaped products;
4. ``engine``   the scatter-tier window engine at BASELINE config #2
                (slots from the C++ NativeSlotIndex): a 1M-key space,
                2^23 events in one 1 s window, HLL precision 12, 1.25M
                slots (5.12 GB of registers on the card), checked
                against an independent numpy HLL on 4,096 keys;
5. ``job``      eight jobs through ``StreamExecutionEnvironment``: HLL
                unique visitors (2^21 events, 1M keys, tumbling 1 s, on
                the log tier), a word count (SumAggregate, 50k string
                words, tumbling 5 s, on the fused string-sum engine),
                both checked against numpy references; HLL with allowed
                lateness on ``set_state_backend("gpu")`` (WindowOperator
                on the GPU keyed-state backend), a sliding-quantile and
                a session Count-Min job on the device operator (the log
                tier), and on its scatter tier an integer-keyed tumbling
                Avg and the same two sketch jobs on composite keys, each
                checked against the same job on the heap backend;
6. ``keyed``    WindowOperator on the GPU keyed-state backend at config
                #2 through the test harness: 1M keys, 2^22 events in one
                1 s window, HLL p = 12 (2^20 slots, 4.29 GB of
                registers), a snapshot and restore mid-stream, one
                batched fire, checked against numpy HLL on 4,096 keys;
7. ``sessions`` session windows with HLL and Sum on the GPU backend
                capped below the live session count (spill to host RAM
                and promotion), checked against the heap backend;
8. ``sliding``  BASELINE config #3: VectorizedSlidingWindows, 10 s / 1 s,
                p50/p99 quantile sketch (B = 210), a 10M-key space,
                2^22 events over 10 s with a watermark per 2^19 chunk
                (>= 3 GB of sketch state), checked against numpy on
                4,096 sampled (key, pane) histograms and (key, window)
                results;
9. ``session_cm`` BASELINE config #4: VectorizedSessionWindows, gap 1 s,
                Count-Min 4 x 2048, 100k keys, 2^21 events over 30 s;
                every session total exact and sampled tables bit-equal
                against numpy;
10. ``heavy_hitters`` WindowedHeavyHitters(1 s, phi 0.01), 100k keys, a
                skewed item mix, 2^21 events over 4 s: no false
                negatives, no estimate below the truth, every point
                query equal to the plain version's;
11. ``log_tier`` BASELINE config #2 through LogStructuredTumblingWindows
                on the card, fired with the device finish
                (``hll_log_finish``) and with the host finish: equal per
                key, each within the HLL tolerance of numpy HLL on 4,096
                keys; the link probe's reading and its "auto" pick;
12. ``device_windows`` config #2 through DeviceTumblingWindows (the key
                index on the card, 1.5M positions, 6.1 GB of registers):
                no overflow, every estimate bit-equal to the scatter
                engine's on the same events;
13. ``chain``  the fused chain program: 2^23 config #2 events (1M
                keys) through map -> filter -> a 4-channel key-group
                exchange in batches of 2^20, fused and per operator,
                per-channel batches bit-equal; window mode into
                WindowOperator on the GPU backend (2^20 events, 100k
                keys) equal to the unfused run; the job
                VectorizedCollectionSource -> map -> filter -> key_by(0)
                -> time_window(1 s) -> HLL 12 with the window at
                parallelism 4, fused and unfused, equal, with the
                (key, window) set exact;
14. ``graph``  the graph library on a Graph500 Kronecker graph (scale
                22: 4.19M vertices, 67.1M edges): PageRank, HITS (each
                with its plans' build seconds; PageRank's first superstep
                launched again, bit-identical, and within the reorder
                bound of the plain version),
                connected components, SSSP from the vertex of highest
                degree, a Pregel max-flood; triangles and clustering at
                scale 18; checked against scipy and numpy (components,
                Dijkstra, float64 power iterations, a fixed point, 4,096
                sampled edges' common neighbours);
15. ``ml``     ALS at MovieLens-20M's shape (20M ratings, f = 10, 10
                sweeps), KNN at MNIST's (60,000 x 784, 10,000 queries,
                k = 3), SVM at covtype's (581,012 x 54) and linear
                regression at YearPredictionMSD's (463,715 x 90), each
                checked against numpy float64;
16. ``mesh``   8 virtual shards of the card (``Mesh([cuda:0] * 8)``):
                (a) config #2 on MeshTumblingWindows (2 ring regions of
                2^18 slots a shard: 17.2 GB of registers), registers of
                sampled keys and every estimate equal to
                VectorizedTumblingWindows'; (b) the same events on
                MeshLogTumblingWindows, equal to the single log engine;
                (c) config #3 on MeshSlidingWindows (1M-key space, ring
                16 of 2^18 slots: 28.2 GB), every (key, window) result
                equal to VectorizedSlidingWindows'; (d) HLL jobs with
                ``env.set_mesh``: integer keys (2^21 events, the mesh
                log tier) and composite keys (2^19, the sharded scatter
                tier), each equal to the job without a mesh; (e) the
                chain's map -> filter -> 4-channel route (2^22 events)
                with ``devices()`` widened to 8: 40 composite classes,
                bit-equal to the single-device program and the
                per-operator path;
17. the launch counts of phases 4-16, each path counted on its own:
   every kernel the path runs must have launched there.

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
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# HBM bandwidth of the card, bytes/s (NVIDIA data sheets); the SXM
# part unless the name says otherwise.  Compute peak for the kernels'
# non-tensor-core int32/fp32 operations: 67 TFLOP/s fp32 (SXM).
_HBM = (("PCIe", 2.0e12), ("NVL", 3.9e12), ("H200", 4.8e12), ("", 3.35e12))
_OPS_PER_S = 67e12
EPS32 = float(np.finfo(np.float32).eps)

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

#: how a detail entry's times were taken (its "timer" key)
RUN = "run: one warm-up call, then reps calls back to back between one pair of CUDA events, / reps"
SINGLE = "single: each call between its own pair of CUDA events (untimed setup before it), median"
CHAIN_TIMER = ("ms, library_ms, sort_only_ms: " + RUN + "; with_host_read_ms "
               "and plain_ms: " + SINGLE + " (each call reads the class starts "
               "on the host)")


def cuda_ms(fn, reps: int = 10, setup=None, single: bool = False) -> float:
    """Device ms of one call of fn.  Without setup, one warm-up call, then
    reps calls back to back between one pair of CUDA events, divided by
    reps, so a call's host work (the wrapper's checks, ctypes, stream
    lookup) overlaps the card's work instead of sitting in the window.
    With setup (run untimed before each call), or single for a call that
    reads the host (chain_route's class starts), each call between its
    own pair of events: the median of reps."""
    import torch
    if setup is None and not single:
        fn()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / reps
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


def same_float_bits(a, b) -> bool:
    """Bit for bit, except that a NaN equals any NaN (float32)."""
    import torch
    an, bn = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(an, bn) and torch.equal(
        a[~an].view(torch.int32), b[~bn].view(torch.int32)))


def _kernel_clock(module, names, marks):
    """Wrap module.<name> for each name so that CUDA events bracket each
    call; marks[name] collects the event pairs.  Returns the restorer."""
    import torch
    saved = {name: getattr(module, name) for name in names}

    def timed(name, fn):
        def call(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            r = fn(*a, **kw)
            e1.record()
            marks.setdefault(name, []).append((e0, e1))
            return r
        return call

    for name, fn in saved.items():
        setattr(module, name, timed(name, fn))
    return lambda: [setattr(module, n, f) for n, f in saved.items()]


def _recording(module, name, seen):
    """Wrap module.<name> so that seen(args, result) runs after each
    call: a check reads the path's own kernel inputs and outputs and
    launches nothing itself.  Returns the restorer."""
    fn = getattr(module, name)

    def call(*a, **kw):
        r = fn(*a, **kw)
        seen(a, r)
        return r

    setattr(module, name, call)
    return lambda: setattr(module, name, fn)


def _device_seconds(marks):
    return {name: sum(a.elapsed_time(b) for a, b in pairs) / 1e3
            for name, pairs in marks.items()}


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
                   "distinct_words": int(words), "library": "scatter_reduce_ amax",
                   "timer": SINGLE})
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
    # slots, integer-valued data (float atomics add it exactly); the state
    # carries over from call to call, as a window's aggregate does
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
    # float32 min / max in the reference's order: NaN, +-0 and +-inf in
    # the values and in the state, against the plain version (a NaN
    # equals any NaN, every other value bit for bit)
    special = torch.tensor([0.0, -0.0, float("nan"), float("inf"), float("-inf"), 1.5],
                           device=dev)
    fvals = special[torch.from_numpy(rng.integers(0, 6, N)).to(dev)]
    fbase = special[torch.from_numpy(rng.integers(0, 6, S)).to(dev)]
    for op in ("min", "max"):
        got, want = fbase.clone(), fbase.clone()
        K.scatter_combine(got, cslots, fvals, N, op)
        K.scatter_combine_plain(want, cslots, fvals, N, op)
        check(same_float_bits(got, want),
              f"scatter_combine f32 {op} with NaN / +-0 / +-inf equal to plain")
    del cslots, fvals, fbase
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
    sketch_kernel_entries(dev, hbm, rng, entries, detail)
    log_finish_entry(dev, hbm, rng, entries, detail)
    table_insert_entry(dev, hbm, rng, entries, detail)
    chain_route_entry(dev, hbm, rng, entries, detail)
    shard_pack_entry(dev, hbm, rng, entries, detail)
    graph_kernel_entries(dev, hbm, entries, detail)
    ml_kernel_entries(dev, hbm, entries, detail)
    for d in detail:
        d.setdefault("timer", RUN)
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
# phase 3, sketches: the Count-Min and quantile kernels
# ---------------------------------------------------------------------

#: BASELINE config #3's sketch geometry (bench.py bench_sliding_quantile)
Q3 = dict(quantiles=(0.5, 0.99), relative_accuracy=0.05, min_value=1e-3,
          max_value=1e6)


def lanes_np(vh: np.ndarray):
    """uint64 hashes → (hi, lo) as int32 views of the 32-bit lanes."""
    return ((vh >> np.uint64(32)).astype(np.uint32).view(np.int32),
            (vh & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32))


def sketch_kernel_entries(dev, hbm, rng, entries, detail, shift=0):
    """countmin_update, countmin_query, quantile_update and
    quantile_result at the main paths' shapes, each against its plain
    version on the card, with merge_rows at the sketch row widths
    (``shift`` > 0 divides every count by 2^shift, for a rehearsal on
    the CPU)."""
    import torch
    from flink_tpu_torch import kernels as K
    from flink_tpu_torch.ops.hashing import countmin_rows
    from flink_tpu_torch.ops.sketches import QuantileSketchAggregate

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # countmin_update: 2^19 records into [2^14, 4, 2048] int32 (512 MiB)
    S, D, W, N = 1 << (14 - shift), 4, 2048, 1 << (19 - shift)
    slots = t(rng.integers(0, S, N).astype(np.int32))
    vals = t(rng.integers(1, 4, N).astype(np.float32))
    vh = splitmix64_np(rng.integers(0, 2**63, N, dtype=np.int64))
    hi, lo = (t(a) for a in lanes_np(vh))
    table = torch.zeros((S, D, W), dtype=torch.int32, device=dev)
    total = torch.zeros(S, dtype=torch.int32, device=dev)
    rt, rtot = table.clone(), total.clone()
    K.countmin_update(table, total, slots, vals, hi, lo, N)
    K.countmin_update_plain(rt, rtot, slots, vals, hi, lo, N)
    torch.cuda.synchronize()
    check(torch.equal(table, rt) and torch.equal(total, rtot),
          "countmin_update tables and totals bit-equal")
    err = max(max_abs_err(table, rt), max_abs_err(total, rtot))
    s64 = slots.to(torch.int64)
    r = torch.arange(D, device=dev)[:, None]
    flat = ((s64[None, :] * D + r) * W
            + countmin_rows(hi, lo, D, W).to(torch.int64)).reshape(-1)
    cells = int(torch.unique(flat).numel())
    targets = int(torch.unique(s64).numel())
    w_rep = vals.to(torch.int32).expand(D, -1).reshape(-1)
    w32 = vals.to(torch.int32)

    def cm_library():
        table.view(-1).index_put_((flat,), w_rep, accumulate=True)
        total.index_put_((s64,), w32, accumulate=True)

    ms = cuda_ms(lambda: K.countmin_update(table, total, slots, vals, hi, lo, N))
    plain = cuda_ms(lambda: K.countmin_update_plain(rt, rtot, slots, vals, hi,
                                                    lo, N), 5)
    lib = cuda_ms(cm_library)
    b, by = bound(16 * N + 8 * cells + 8 * targets, 3 * D * N, hbm)
    entries["countmin_update"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                      bound_ms=b, bound_by=by, max_abs_err=err)
    detail.append({"kernel": "countmin_update", "rows": N, "slots": S,
                   "depth": D, "width": W, "distinct_cells": cells,
                   "library": "index_put_ accumulate (indices precomputed)"})

    # countmin_query: 2^20 queries, half of them items the table holds
    Q = 1 << (20 - shift)
    qslots = t(np.concatenate([slots.cpu().numpy(), rng.integers(0, S, Q - N)
                               .astype(np.int32)]))
    qvh = np.concatenate([vh, splitmix64_np(rng.integers(0, 2**63, Q - N,
                                                         dtype=np.int64))])
    qhi, qlo = (t(a) for a in lanes_np(qvh))
    got = K.countmin_query(table, qslots, qhi, qlo)
    want = K.countmin_query_plain(table, qslots, qhi, qlo)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "countmin_query estimates bit-equal")
    qs64 = qslots.to(torch.int64)
    qcols = countmin_rows(qhi, qlo, D, W).to(torch.int64)
    qcells = int(torch.unique(((qs64[None, :] * D + r) * W + qcols)
                              .reshape(-1)).numel())
    ms = cuda_ms(lambda: K.countmin_query(table, qslots, qhi, qlo))
    plain = cuda_ms(lambda: K.countmin_query_plain(table, qslots, qhi, qlo))
    lib = cuda_ms(lambda: table[qs64[None, :].expand(D, -1), r, qcols].amin(0))
    b, by = bound(16 * Q + 4 * qcells, 3 * D * Q, hbm)
    entries["countmin_query"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                     bound_ms=b, bound_by=by,
                                     max_abs_err=max_abs_err(got, want))
    detail.append({"kernel": "countmin_query", "queries": Q,
                   "distinct_cells": qcells,
                   "library": "advanced indexing + amin (columns precomputed)"})

    # merge_rows, int32 add at the session Count-Min row (32 KiB): 2^12
    # sources folded four to a target, against the plain version
    perm = rng.permutation(S).astype(np.int32)
    m = 1024 >> shift
    dst, src = t(np.repeat(perm[:m], 4)), t(perm[m:5 * m])
    rt.copy_(table)
    K.merge_rows(table, dst, src, "add")
    K.merge_rows_plain(rt, dst, src, "add")
    torch.cuda.synchronize()
    check(torch.equal(table, rt), "merge_rows i32 add at 32 KiB rows bit-equal")
    err = max_abs_err(table, rt)
    row = D * W * 4
    detail.append({"kernel": "merge_rows", "case": "i32 add 32 KiB rows "
                   "(session Count-Min merge)", "rows": 4 * m, "unique_dst": False,
                   "ms": cuda_ms(lambda: K.merge_rows(table, dst, src, "add")),
                   "plain_ms": cuda_ms(lambda: K.merge_rows_plain(
                       rt, dst, src, "add"), 3),
                   "bound_ms": bound(4 * m * (row + 8) + 2 * m * row, 0, hbm)[0],
                   "max_abs_err": err})
    del table, total, rt, rtot, flat, w_rep, qcols
    torch.cuda.empty_cache()

    # quantile_update: 2^19 lognormal values into [2^22, B] int32 (3.5 GB)
    agg = QuantileSketchAggregate(**Q3)
    B, C = agg.buckets, 1 << (22 - shift)
    hslots = t(rng.integers(0, C, N).astype(np.int32))
    v = t(rng.lognormal(3.0, 1.0, N).astype(np.float32))
    hist = torch.zeros((C, B), dtype=torch.int32, device=dev)
    ref = torch.zeros_like(hist)
    args = (agg.min_value, agg.log_gamma, agg.offset)
    K.quantile_update(hist, hslots, v, N, *args)
    K.quantile_update_plain(ref, hslots, v, N, *args)
    torch.cuda.synchronize()
    check(torch.equal(hist, ref), "quantile_update histograms bit-equal")
    err = max_abs_err(hist, ref)
    from flink_tpu_torch.kernels.quantile_update import bucket_of
    hflat = hslots.to(torch.int64) * B + bucket_of(v, *args, B)
    hcells = int(torch.unique(hflat).numel())
    # bucket edges for the library's bucketize: edge j = gamma^(j + offset)
    edges = t(np.exp((np.arange(B - 1) + agg.offset) * agg.log_gamma)
              .astype(np.float32))
    ones = torch.ones(N, dtype=torch.int32, device=dev)
    mn = torch.tensor(np.float32(agg.min_value), device=dev)

    def q_library():
        bk = torch.bucketize(v, edges, right=True).clamp(1, B - 1)
        bk = torch.where(v <= mn, 0, bk)
        hist.view(-1).index_put_((hslots.to(torch.int64) * B + bk,), ones,
                                 accumulate=True)

    ms = cuda_ms(lambda: K.quantile_update(hist, hslots, v, N, *args))
    plain = cuda_ms(lambda: K.quantile_update_plain(ref, hslots, v, N, *args), 5)
    lib = cuda_ms(q_library)
    b, by = bound(8 * N + 8 * hcells, 30 * N, hbm)
    entries["quantile_update"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                      bound_ms=b, bound_by=by, max_abs_err=err)
    detail.append({"kernel": "quantile_update", "rows": N, "slots": C,
                   "buckets": B, "distinct_cells": hcells,
                   "library": "bucketize + index_put_ accumulate"})

    # quantile_result: dense over 2^20 rows (a row slice), gathered over
    # 2^18 rows, Q = 2, on the histograms quantile_update left
    qs, bv = agg._tables(dev)
    R, G = 1 << (20 - shift), 1 << (18 - shift)
    dense = hist[:R]
    gslots = t(rng.integers(0, C, G).astype(np.int32))
    got_d, want_d = K.quantile_result(dense, qs, bv), K.quantile_result_plain(dense, qs, bv)
    got_g = K.quantile_result(hist, qs, bv, slots=gslots)
    want_g = K.quantile_result_plain(hist, qs, bv, slots=gslots)
    torch.cuda.synchronize()
    check(torch.equal(got_d, want_d) and torch.equal(got_g, want_g),
          "quantile_result values bit-equal (dense and gathered)")
    err = max(max_abs_err(got_d, want_d), max_abs_err(got_g, want_g))

    def q_result_library():
        cum = torch.cumsum(dense.to(torch.float32), dim=-1)
        target = torch.clamp_min(qs[None, :] * cum[:, -1:], 1.0)
        idx = torch.searchsorted(cum, target)
        return bv[torch.where(idx >= B, 0, idx)]

    check(torch.equal(q_result_library(), got_d),
          "cumsum + searchsorted agrees with quantile_result")
    ms = cuda_ms(lambda: K.quantile_result(dense, qs, bv))
    plain = cuda_ms(lambda: K.quantile_result_plain(dense, qs, bv), 3)
    lib = cuda_ms(q_result_library, 5)
    b, by = bound(R * B * 4 + R * 8, 2 * R * B, hbm)
    entries["quantile_result"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                      bound_ms=b, bound_by=by, max_abs_err=err)
    detail.append({"kernel": "quantile_result", "dense_rows": R,
                   "gathered_rows": G, "buckets": B, "quantiles": 2,
                   "gathered_ms": cuda_ms(lambda: K.quantile_result(
                       hist, qs, bv, slots=gslots)),
                   "gathered_bound_ms": bound(G * (4 + B * 4 + 8), 0, hbm)[0],
                   "library": "cumsum + searchsorted"})

    # merge_rows, int32 add at the sliding union row (B * 4 bytes): 2^18
    # pane rows into as many fresh union rows, unique dst
    k = 1 << (18 - shift)
    perm = torch.randperm(C, device=dev, dtype=torch.int64)[:2 * k].to(torch.int32)
    dst, src = perm[:k].contiguous(), perm[k:].contiguous()
    ref.copy_(hist)
    K.merge_rows(hist, dst, src, "add", unique_dst=True)
    K.merge_rows_plain(ref, dst, src, "add", unique_dst=True)
    torch.cuda.synchronize()
    check(torch.equal(hist, ref), "merge_rows i32 add at sliding rows bit-equal")
    err = max_abs_err(hist, ref)
    row = B * 4
    detail.append({"kernel": "merge_rows", "case": f"i32 add {row} B rows "
                   "(sliding union merge)", "rows": k, "unique_dst": True,
                   "ms": cuda_ms(lambda: K.merge_rows(hist, dst, src, "add",
                                                      unique_dst=True)),
                   "plain_ms": cuda_ms(lambda: K.merge_rows_plain(
                       ref, dst, src, "add", unique_dst=True), 3),
                   "bound_ms": bound(k * (row + 8) + 2 * k * row, 0, hbm)[0],
                   "max_abs_err": err})
    del hist, ref, dense, hflat
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
# the log tier's finish and the device hash table (kernels phase)
# ---------------------------------------------------------------------

def config2_events(rng, n_events=1 << 23, n_keys=1_000_000):
    """BASELINE config #2's events: keys uniform over a 1M-key space,
    one 1 s window, 64-bit user ids (value hashes by splitmix64)."""
    keys = rng.integers(0, n_keys, n_events).astype(np.uint64)
    ts = np.sort(rng.integers(0, 1000, n_events).astype(np.int64))
    users = rng.integers(0, 2**63, n_events).astype(np.uint64)
    return keys, ts, splitmix64_np(users)


def within_one_ulp(got, want) -> bool:
    import torch
    ulp = (torch.nextafter(want, torch.full_like(want, float("inf"))) - want).abs()
    return bool(((got - want).abs() <= ulp).all())


def log_finish_entry(dev, hbm, rng, entries, detail):
    """hll_log_finish at config #2: the compacted cells of a real
    hll_log_compact of 2^23 events over a 1M-key space, p = 12."""
    import torch
    from flink_tpu_torch import kernels as K
    from flink_tpu_torch import native as nat
    from flink_tpu_torch.ops.sketches import HyperLogLogAggregate
    p = 12
    m, agg = 1 << p, HyperLogLogAggregate(p)
    keys, _, vh = config2_events(rng)
    regs, ranks = nat.hll_make_cells(vh, p)
    _, _, crk, ends = nat.hll_log_compact(keys, regs, ranks, p)
    n_cells, n_keys = len(crk), len(ends)
    r = torch.from_numpy(crk).to(dev)
    e = torch.from_numpy(ends).to(dev)
    sums = torch.empty(n_keys, dtype=torch.float64, device=dev)
    want_sums = torch.empty_like(sums)
    est = K.hll_log_finish(r, e, m, agg.alpha, inv_sum=sums)
    want_est = K.hll_log_finish_plain(r, e, m, agg.alpha, inv_sum=want_sums)
    check(torch.equal(K.hll_log_finish(r, e, m, agg.alpha), est),
          "hll_log_finish estimates the same without the sums")
    torch.cuda.synchronize()
    check(torch.equal(sums, want_sums), "hll_log_finish sums bit-equal to plain")
    check(within_one_ulp(est, want_est), "hll_log_finish estimates within 1 ulp of plain")
    _, host = nat.hll_log_fire(keys, regs, ranks, p)
    host_t = torch.from_numpy(host).to(dev)
    check(within_one_ulp(est, host_t), "hll_log_finish within 1 ulp of the C++ host fire")
    ms = cuda_ms(lambda: K.hll_log_finish(r, e, m, agg.alpha))
    plain = cuda_ms(lambda: K.hll_log_finish_plain(r, e, m, agg.alpha), 5)
    # one torch pipeline for the same function: exp2, index_add_, elementwise
    lengths = torch.diff(e.to(torch.int64), prepend=e.new_zeros(1, dtype=torch.int64))
    key_of = torch.repeat_interleave(torch.arange(n_keys, device=dev), lengths)
    mf, am2 = float(m), agg.alpha * m * m

    def library():
        s = torch.zeros(n_keys, dtype=torch.float64, device=dev).index_add_(
            0, key_of, torch.exp2(-r.to(torch.float64)))
        zeros = mf - lengths.to(torch.float64)
        raw = am2 / (zeros + s)
        lin = mf * (np.log(mf) - torch.log(zeros.clamp(min=1.0)))
        return torch.where((raw <= 2.5 * mf) & (zeros > 0), lin, raw)

    lib = cuda_ms(library)
    # the timed call, as the fire makes it, writes the estimates only
    b, by = bound(n_cells + 4 * n_keys + 8 * n_keys, n_cells + 8 * n_keys, hbm)
    entries["hll_log_finish"] = dict(
        ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b, bound_by=by,
        max_abs_err=float((est - want_est).abs().max()))
    detail.append({"kernel": "hll_log_finish", "cells": n_cells, "keys": n_keys,
                   "equal_to_host_fire": int((est == host_t).sum()),
                   "library": "exp2 + index_add_ + elementwise"})


def key_map_check(what, table, plain, hi, lo, slots, ref, n, max_probes,
                  region=None, region_size=0):
    """The kernel's table against the plain version's as key -> slot
    maps (``device_table.key_map_faults``): every row resolved, its slot
    holds its key on its probe chain within max_probes, duplicates share
    it, padding is -1, and both tables hold the same key set.  Returns
    (faults found, probes the batch took: the work its bound counts)."""
    from flink_tpu_torch.ops.device_table import key_map_faults
    live = np.arange(len(slots)) < n
    check((ref[live] >= 0).all(), f"{what}: the plain version resolved every record")
    faults, probes = key_map_faults(table, hi, lo, slots, max_probes, live,
                                    region, region_size, reference=plain)
    faults["unresolved"] = int((slots[live] < 0).sum())
    check(not any(faults.values()), f"{what}: key -> slot map {faults}")
    return sum(faults.values()), probes


def table_insert_entry(dev, hbm, rng, entries, detail):
    """table_insert: 2^20 records (keys of config #2's 1M-key space) into
    a 1.5M-position table, empty, half full, and an all-hits batch; one
    regional call.  Held against the plain version (which replays the
    JAX claim rounds) as key -> slot maps."""
    import torch
    from flink_tpu_torch import kernels as K
    from flink_tpu_torch.ops.device_table import make_table
    C, N, P = 1_500_000, 1 << 20, 128
    n = N - 1000                                     # a padded tail

    def lanes(keys):
        hi = (keys >> np.uint64(32)).astype(np.uint32)
        lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        return hi, lo, torch.from_numpy(hi.view(np.int32)).to(dev), \
            torch.from_numpy(lo.view(np.int32)).to(dev)

    def snapshot(t):
        return [a.clone() for a in t]

    def restore(t, saved):
        return lambda: [a.copy_(b) for a, b in zip(t, saved)]

    batch_a = rng.integers(0, 1_000_000, N).astype(np.uint64)
    batch_a[:64] = 0                                  # key (0, 0), repeated
    batch_b = rng.integers(0, 1_000_000, N).astype(np.uint64)
    prefill = rng.permutation(1_000_000)[:C // 2].astype(np.uint64)
    rows = []
    for state, keys, pre in (("empty", batch_a, None),
                             ("half_full", batch_b, prefill),
                             ("all_hits", batch_a, batch_a)):
        card, plain = make_table(C, dev), make_table(C, dev)
        if pre is not None:
            _, _, ph, pl = lanes(pre)
            for t in (card, plain):
                K.table_insert_plain(*t, ph, pl, len(pre), P)
        hi, lo, h_d, l_d = lanes(keys)
        saved = snapshot(card)
        ov = torch.zeros(1, dtype=torch.int64, device=dev)
        got = K.table_insert(*card, h_d, l_d, n, P, overflow=ov)
        ref = K.table_insert_plain(*plain, h_d, l_d, n, P)
        torch.cuda.synchronize()
        check(int(ov) == 0, f"table_insert {state}: no overflow")
        faults, probes = key_map_check(f"table_insert {state}", card, plain, hi,
                                       lo, got.cpu().numpy(), ref.cpu().numpy(), n, P)
        new_keys = int(card.occupied.sum() - saved[2].sum())
        ms = cuda_ms(lambda: K.table_insert(*card, h_d, l_d, n, P),
                     setup=None if state == "all_hits" else restore(card, saved))
        plain_ms = cuda_ms(lambda: K.table_insert_plain(*plain, h_d, l_d, n, P), 3,
                           setup=None if state == "all_hits" else restore(plain, saved))
        b, by = bound(12 * n + 9 * probes + 9 * new_keys, probes, hbm)
        rows.append(dict(state=state, ms=ms, plain_ms=plain_ms, bound_ms=b,
                         bound_by=by, probes=probes, faults=faults, new_keys=new_keys,
                         load_after=float(card.occupied.sum()) / C,
                         timer=RUN if state == "all_hits" else SINGLE))
    # one regional call: 4 regions of 375,000 positions
    R = 4
    region = rng.integers(0, R, N).astype(np.int32)
    reg_d = torch.from_numpy(region).to(dev)
    card, plain = make_table(C, dev), make_table(C, dev)
    hi, lo, h_d, l_d = lanes(batch_a)
    got = K.table_insert(*card, h_d, l_d, n, P, region=reg_d, region_size=C // R)
    ref = K.table_insert_plain(*plain, h_d, l_d, n, P, region=reg_d,
                               region_size=C // R)
    faults, probes = key_map_check("table_insert regional", card, plain, hi, lo,
                                   got.cpu().numpy(), ref.cpu().numpy(), n, P,
                                   region, C // R)
    saved = [torch.zeros_like(a) for a in card]
    rows.append(dict(state="regional", probes=probes, faults=faults, ms=cuda_ms(
        lambda: K.table_insert(*card, h_d, l_d, n, P, region=reg_d,
                               region_size=C // R), setup=restore(card, saved)),
        timer=SINGLE))
    head = next(r for r in rows if r["state"] == "half_full")
    # the error figure: key -> slot faults found, summed over the four
    # states (a slot is an index, so there is no numeric difference)
    entries["table_insert"] = dict(ms=head["ms"], plain_ms=head["plain_ms"],
                                   library_ms=None, bound_ms=head["bound_ms"],
                                   bound_by=head["bound_by"],
                                   max_abs_err=float(sum(r["faults"] for r in rows)))
    detail.append({"kernel": "table_insert", "records": N, "positions": C,
                   "max_probes": P, "states": rows, "timer": "per state"})


# ---------------------------------------------------------------------
# the log tier and the device-indexed engine at config #2
# ---------------------------------------------------------------------

def log_tier_phase(dev, n_events=1 << 23, n_keys=1_000_000, chunk=1 << 20,
                   n_sample=4096):
    """BASELINE config #2 through LogStructuredTumblingWindows on the
    card: HLL p = 12, one 1 s window, batches of 2^20, fired once with
    the device finish (hll_log_finish) and once with the host finish."""
    import resource

    import torch
    from flink_tpu_torch import kernels as K
    from flink_tpu_torch import native as nat
    from flink_tpu_torch.ops import link_probe
    from flink_tpu_torch.ops.sketches import HyperLogLogAggregate
    from flink_tpu_torch.streaming.log_windows import LogStructuredTumblingWindows
    p = 12
    m = 1 << p
    keys, ts, vh = config2_events(np.random.default_rng(7), n_events, n_keys)
    out = {"events": n_events, "keys": n_keys, "precision": p,
           "link": link_probe.measure(dev),
           "auto_picks": link_probe.recommended_finish_tier(dev)}
    fired = {}
    for tier in ("device", "host"):
        torch.cuda.reset_peak_memory_stats(dev)
        eng = LogStructuredTumblingWindows(HyperLogLogAggregate(p), 1000,
                                           finish_tier=tier, device=dev)
        eng.emit_arrays = True
        t0 = time.perf_counter()
        for i in range(0, n_events, chunk):
            sl = slice(i, i + chunk)
            eng.process_batch(keys[sl], ts[sl], None, value_hashes=vh[sl])
        log_keys, (log_regs, log_ranks) = eng.windows[0].concat()
        t1 = time.perf_counter()
        eng.advance_watermark(999)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        fk = np.concatenate([k for k, _, _, _ in eng.fired])
        fr = np.concatenate([r for _, r, _, _ in eng.fired])
        fired[tier] = (fk, fr)
        row = {"ingest_s": t1 - t0, "fire_s": t2 - t1,
               "events_per_s": n_events / (t2 - t0), "fired": int(len(fk)),
               "log_bytes": int(log_keys.nbytes + log_regs.nbytes + log_ranks.nbytes),
               "host_maxrss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
               "max_memory_allocated": torch.cuda.max_memory_allocated(dev)}
        if tier == "device":
            # the fire's four steps, repeated on the same log and timed
            # one by one: C++ sort and compaction, H2D, kernel, D2H
            saved = dict(K.LAUNCHES)
            c0 = time.perf_counter()
            _, _, crk, ends = nat.hll_log_compact(log_keys, log_regs, log_ranks, p)
            c1 = time.perf_counter()
            r_d = torch.from_numpy(crk).to(dev)
            e_d = torch.from_numpy(ends).to(dev)
            torch.cuda.synchronize()
            c2 = time.perf_counter()
            agg = HyperLogLogAggregate(p)
            kms = cuda_ms(lambda: K.hll_log_finish(r_d, e_d, m, agg.alpha), 3)
            est = K.hll_log_finish(r_d, e_d, m, agg.alpha)
            torch.cuda.synchronize()
            c3 = time.perf_counter()
            est.cpu().numpy()
            c4 = time.perf_counter()
            K.LAUNCHES.update(saved)               # timing launches do not count
            row["fire_split_s"] = {"compact": c1 - c0, "h2d": c2 - c1,
                                   "kernel": kms / 1e3, "d2h": c4 - c3}
            row["compacted_cells"] = int(len(crk))
        out[tier] = row
        del eng
    (dk, dr), (hk, hr) = fired["device"], fired["host"]
    check(np.array_equal(dk, hk), "log tier: device and host finish fire the same keys")
    slack = np.maximum(1e-12 * np.abs(hr), 2 * m * np.spacing(np.log(float(m))))
    check(bool((np.abs(dr - hr) <= slack).all()),
          "log tier: device finish equals host finish (rel 1e-12, or an ulp of log)")
    out["finish_bit_equal_keys"] = int((dr == hr).sum())
    rng = np.random.default_rng(8)
    sample = np.sort(rng.choice(dk, n_sample, replace=False))
    sel = np.isin(keys, sample)
    want = hll_reference(np.searchsorted(sample, keys[sel]), vh[sel], len(sample), p)
    for tier, (fk, fr) in fired.items():
        got = fr[np.searchsorted(fk, sample)]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=hll_atol(m))
        check(True, f"log tier ({tier} finish): {n_sample} keys within rtol 1e-5 "
              "(+ log slack) of numpy HLL")
    out["distinct_keys"] = int(len(dk))
    emit({"log_tier": out})


def device_windows_phase(dev, n_events=1 << 23, n_keys=1_000_000,
                         capacity=1_500_000, chunk=1 << 20):
    """BASELINE config #2 through DeviceTumblingWindows (the key index
    on the card): HLL p = 12, 1.5M table positions (6.1 GB of
    registers).  No overflow, and each key's estimate bit-equal to the
    scatter engine's on the same events."""
    import torch
    from flink_tpu_torch import kernels as K
    from flink_tpu_torch.ops.sketches import HyperLogLogAggregate
    from flink_tpu_torch.streaming import device_windows as dw
    from flink_tpu_torch.streaming.vectorized import VectorizedTumblingWindows
    p = 12
    keys, ts, vh = config2_events(np.random.default_rng(7), n_events, n_keys)
    k_hi, k_lo = dw.lanes_from_int_keys(keys)
    v_hi = (vh >> np.uint64(32)).astype(np.uint32)
    v_lo = (vh & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    torch.cuda.reset_peak_memory_stats(dev)
    agg = HyperLogLogAggregate(p)
    eng = dw.DeviceTumblingWindows(agg, 1000, capacity=capacity, device=dev)
    # CUDA events around each launch split the ingest's device time
    marks = {}
    restore = _kernel_clock(dw, ("table_insert",), marks)
    _kernel_clock(agg, ("update",), marks)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(0, n_events, chunk):
            sl = slice(i, i + chunk)
            eng.process_batch(k_hi[sl], k_lo[sl], ts[sl], vh_hi=v_hi[sl],
                              vh_lo=v_lo[sl])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    finally:
        restore()
    eng.advance_watermark(999)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    split = _device_seconds(marks)
    split["hll_update"] = split.pop("update")
    check(eng.overflowed == 0, "device_windows: overflowed == 0")
    (fk, fr, _, _), = eng.fired
    out = {"events": n_events, "keys": n_keys, "precision": p,
           "capacity": capacity, "register_bytes": capacity * (1 << p),
           "fired": int(len(fk)), "overflowed": eng.overflowed,
           "ingest_s": t1 - t0, "ingest_device_s": split, "fire_s": t2 - t1,
           "events_per_s": n_events / (t2 - t0),
           "max_memory_allocated": torch.cuda.max_memory_allocated(dev)}
    del eng
    torch.cuda.empty_cache()
    # the scatter engine on the same events: a comparison, not the path
    saved = dict(K.LAUNCHES)
    vec = VectorizedTumblingWindows(HyperLogLogAggregate(p), 1000,
                                    initial_capacity=n_keys + n_keys // 4,
                                    microbatch=chunk, device=dev)
    vec.emit_arrays = True
    kh = splitmix64_np(keys)
    for i in range(0, n_events, chunk):
        sl = slice(i, i + chunk)
        vec.process_batch(keys[sl], ts[sl], None, key_hashes=kh[sl],
                          value_hashes=vh[sl])
    vec.flush()
    vec.advance_watermark(999)
    vk = np.concatenate([k for k, _, _, _ in vec.fired]).astype(np.uint64)
    vr = np.concatenate([r for _, r, _, _ in vec.fired])
    K.LAUNCHES.update(saved)
    del vec
    torch.cuda.empty_cache()
    o1, o2 = np.argsort(fk), np.argsort(vk)
    check(np.array_equal(fk[o1], vk[o2]), "device_windows: the scatter engine's keys")
    check(np.array_equal(fr[o1], vr[o2]),
          "device_windows: estimates bit-equal to the scatter engine's")
    emit({"device_windows": out})


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
    # the job runs the log tier (float64 estimates): the float32
    # reference's linear-counting logs take the HLL log slack
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=hll_atol(1 << p))
    check(True, "HLL job sample of 4096 pairs within rtol 1e-5 (+ log slack) "
          "of numpy HLL")
    hll = {"events": n, "pairs": int(len(upairs)), "seconds": secs,
           "events_per_s": n / secs}

    # word count: SumAggregate over 50k words (strings: the fused intern
    # + sum engine), tumbling 5 s
    n, n_words = 1 << 20, 50_000
    words = rng.integers(0, n_words, n)
    ts = np.sort(rng.integers(0, 10_000, n))
    events = list(zip([f"w{w}" for w in words.tolist()], [1.0] * n, ts.tolist()))
    out, secs = _run_job(SumAggregate(np.float64), events, 5000, dev)
    pairs, counts = np.unique(words * 2 + ts // 5000, return_counts=True)
    got = dict(((int(k[1:]) * 2 + s // 5000), v) for k, s, v in out)
    check(len(got) == len(pairs) and all(got[int(q)] == c for q, c in
                                        zip(pairs, counts)),
          "word count job (string keys) exact")
    wordcount = {"events": n, "pairs": int(len(pairs)), "seconds": secs,
                 "events_per_s": n / secs}
    emit({"job": {"hll": hll, "wordcount": wordcount,
                  "keyed_backend": keyed_job(dev, rng), **sketch_jobs(dev, rng),
                  **scatter_jobs(dev, rng)}})


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


def _key_id(k):
    """A key as both backends can compare it: the device operator emits
    a composite key as a numpy row of strings, the heap backend as the
    tuple itself."""
    return tuple(str(x) for x in k) if isinstance(k, (tuple, np.ndarray)) else k


def _run_window_job(agg, events, assigner, dev, heap=False):
    """from_collection → key_by → window(assigner) → aggregate on the
    device window operator, or with ``heap`` on WindowOperator over the
    heap backend (``disable_device_operator``, on the CPU)."""
    from flink_tpu_torch.streaming.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.streaming.sources import (
        BoundedOutOfOrdernessTimestampExtractor, CollectSink)
    agg.extract_value = lambda e: e[1]
    out = []
    env = StreamExecutionEnvironment.get_execution_environment(
        device="cpu" if heap else dev)
    if heap:
        env.set_state_backend("heap")
    windowed = (env.from_collection(events)
                .assign_timestamps_and_watermarks(
                    BoundedOutOfOrdernessTimestampExtractor(50, lambda e: e[2]))
                .key_by(lambda e: e[0]).window(assigner))
    if heap:
        windowed = windowed.disable_device_operator()
    (windowed.aggregate(agg, window_function=lambda k, w, vals: [
        (_key_id(k), w.start, w.end, np.asarray(vals[0], np.float64).tolist())])
        .add_sink(CollectSink(out)))
    t0 = time.perf_counter()
    env.execute("chip-smoke-window")
    return sorted(out), time.perf_counter() - t0


def sketch_jobs(dev, rng, n=1 << 14, key_of=int, tag=""):
    """A sliding-quantile job (3 s / 1 s, 2,000 keys) and a session
    Count-Min job (gap 300 ms, 1,000 keys) on the device window
    operator, each against the same job on the heap backend: integer
    keys take the log tier, keys made composite by ``key_of`` the
    scatter tier (results named with ``tag``).  Count-Min totals are
    exact; quantile values agree
    within rtol 1e-6 (the log tier computes bucket values in float64,
    the heap backend's sketch in float32), except for a (key, window)
    holding a value at a bucket boundary (the two take different float32
    logs), and then by one bucket."""
    import torch
    from flink_tpu_torch.ops.sketches import (CountMinSketchAggregate,
                                              QuantileSketchAggregate)
    from flink_tpu_torch.streaming.windowing import (EventTimeSessionWindows,
                                                     SlidingEventTimeWindows)
    out = {}
    ts = np.sort(rng.integers(0, 10_000, n))
    ts[n // 2: n // 2 + 20] -= 2500                 # late stragglers
    ts = np.maximum(ts, 0)
    qv = rng.lognormal(3.0, 1.0, n).astype(np.float32)
    cases = (
        ("sliding_quantile", lambda: QuantileSketchAggregate(**Q3),
         SlidingEventTimeWindows.of(3000, 1000), rng.integers(0, 2000, n), qv.tolist()),
        ("session_countmin", lambda: CountMinSketchAggregate(),
         EventTimeSessionWindows.with_gap(300), rng.integers(0, 1000, n),
         rng.integers(1, 50, n).tolist()))
    for name, make, assigner, keys, vals in cases:
        name += tag
        events = list(zip([key_of(k) for k in keys.tolist()], vals, ts.tolist()))
        got, secs = _run_window_job(make(), events, assigner, dev)
        torch.cuda.synchronize()
        want, heap_secs = _run_window_job(make(), events, assigner, dev, heap=True)
        check([r[:3] for r in got] == [r[:3] for r in want] and len(got) > 1000,
              f"{name} job: the heap backend's windows")
        g = np.array([r[3] for r in got])
        w = np.array([r[3] for r in want])
        unequal = 0
        if name.startswith("session_countmin"):
            check(np.array_equal(g, w), f"{name} job: totals exact against heap")
        else:
            agg = make()
            _, near, _ = quantile_buckets_np(qv, agg)
            near_pairs = {(_key_id(key_of(int(k))), int(t_))
                          for k, t_, z in zip(keys, ts, near) if z}
            differ = np.nonzero(~np.isclose(g, w, rtol=1e-6, atol=0).all(axis=1))[0]
            for i in differ.tolist():
                k, s, e = got[i][:3]
                check(any(kk == k and s <= tt < e for kk, tt in near_pairs)
                      and np.allclose(g[i], w[i], rtol=agg.gamma - 1),
                      f"{name} job: key {k} window {s} equals heap")
            unequal = len(differ)
        out[name] = {"events": n, "results": len(got), "seconds": secs,
                     "events_per_s": n / secs, "heap_seconds": heap_secs,
                     "boundary_unequal": unequal}
    return out


def scatter_jobs(dev, rng, n=1 << 13):
    """The device window operator's scatter tier, against the heap
    backend: an integer-keyed tumbling Avg (it has no cell
    decomposition, so the operator leaves the log tier for
    VectorizedTumblingWindows and scatter_combine), and the sliding
    quantile and session Count-Min jobs on composite (int, str) keys
    (VectorizedSlidingWindows, VectorizedSessionWindows)."""
    import torch
    from flink_tpu_torch.ops.device_agg import AvgAggregate
    from flink_tpu_torch.streaming.windowing import TumblingEventTimeWindows
    ts = np.sort(rng.integers(0, 5000, n))
    events = list(zip(rng.integers(0, 2000, n).tolist(),
                      rng.integers(0, 100, n).astype(float).tolist(), ts.tolist()))
    assigner = TumblingEventTimeWindows.of(1000)
    got, secs = _run_window_job(AvgAggregate(), events, assigner, dev)
    torch.cuda.synchronize()
    want, heap_secs = _run_window_job(AvgAggregate(), events, assigner, dev, heap=True)
    check([r[:3] for r in got] == [r[:3] for r in want] and len(got) > 1000,
          "tumbling_avg job: the heap backend's windows")
    # integer values: float32 sums are exact, the mean is one rounding
    np.testing.assert_allclose([r[3] for r in got], [r[3] for r in want], rtol=1e-6)
    check(True, "tumbling_avg job: means within rtol 1e-6 of heap")
    out = {"tumbling_avg": {"events": n, "results": len(got), "seconds": secs,
                            "events_per_s": n / secs, "heap_seconds": heap_secs}}
    out.update(sketch_jobs(dev, rng, n, key_of=lambda k: (k, "x"), tag="_composite"))
    return out


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
# phase 8: sliding windows at BASELINE config #3
# ---------------------------------------------------------------------

def quantile_buckets_np(v: np.ndarray, agg):
    """Independent numpy bucketing in float64: (bucket, near) where near
    flags values whose log(v) / log(gamma) lies within 4 float32 ulps of
    an integer (a float32 log one ulp off may put them one bucket
    over)."""
    v32 = np.asarray(v, np.float32)
    x = np.log(np.maximum(v32.astype(np.float64), agg.min_value)) / agg.log_gamma
    b = np.clip(1 + np.floor(x).astype(np.int64) - agg.offset, 1, agg.buckets - 1)
    low = v32 <= np.float32(agg.min_value)
    b = np.where(low, 0, b)
    near = (np.abs(x - np.round(x))
            <= 4 * np.abs(np.spacing(np.float32(x)).astype(np.float64))) & ~low
    # the bucket on the other side of the integer a near value sits at
    alt = np.clip(np.where(x - np.round(x) >= 0, b - 1, b + 1), 1, agg.buckets - 1)
    return b, near, alt


def quantiles_of(hist: np.ndarray, agg, values: np.ndarray) -> np.ndarray:
    """The sketch's answers for one histogram, from an exact integer
    scan (the reference's rule: first bucket with cum >= max(q*total, 1),
    bucket 0 when none)."""
    cum = np.cumsum(hist)
    out = []
    for q in agg.quantiles:
        target = max(np.float32(q) * np.float32(cum[-1]), np.float32(1.0))
        hit = np.nonzero(cum >= target)[0]
        out.append(values[hit[0] if len(hit) else 0])
    return np.array(out, np.float32)


def sliding_phase(dev, n_events=1 << 22, n_keys=10_000_000, chunk=1 << 19,
                  n_sample=4096):
    """VectorizedSlidingWindows(QuantileSketchAggregate p50/p99, 10 s /
    1 s) over a 10M-key space: 2^22 time-sorted events over 10 s of
    event time, a watermark after each chunk, then the fire of every
    remaining window.  Live pane histograms and fired results of
    sampled (key, pane) and (key, window) pairs against numpy."""
    import torch
    from flink_tpu_torch.ops.sketches import QuantileSketchAggregate
    from flink_tpu_torch.streaming.vectorized import VectorizedSlidingWindows

    size, slide, span = 10_000, 1_000, 10_000
    rng = np.random.default_rng(31)
    keys = rng.integers(0, n_keys, n_events).astype(np.uint64)
    ts = np.sort(rng.integers(0, span, n_events).astype(np.int64))
    vals = rng.lognormal(3.0, 1.0, n_events).astype(np.float32)
    kh = splitmix64_np(keys)
    agg = QuantileSketchAggregate(**Q3)
    bvals = agg.bucket_values()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    eng = VectorizedSlidingWindows(agg, size, slide, initial_capacity=1 << 20,
                                   microbatch=chunk, device=dev)
    eng.emit_arrays = True
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(0, n_events, chunk):
        sl = slice(i, i + chunk)
        eng.process_batch(keys[sl], ts[sl], vals[sl], key_hashes=kh[sl])
        eng.flush()
        eng.advance_watermark(int(ts[sl][-1]) - 1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pane_slots = sum(len(sh.all_slots()) for sh in eng.windows.values())

    # live panes: sampled (key, pane) histograms against numpy
    b_np, near, alt = quantile_buckets_np(vals, agg)
    pane = 5 * slide
    shard = eng.windows[pane]
    sample = rng.choice(shard.all_keys(), n_sample, replace=False)
    sample.sort()

    def no_alloc(n):
        raise AssertionError("a sampled key is missing from its pane")
    slots, _ = shard.index.lookup_or_insert(splitmix64_np(sample), no_alloc)
    rows = eng.state["hist"][torch.from_numpy(slots).to(dev)].cpu().numpy()
    sel = np.isin(keys, sample) & (ts >= pane) & (ts < pane + slide)
    g = np.searchsorted(sample, keys[sel])
    want = np.zeros_like(rows)
    np.add.at(want, (g[~near[sel]], b_np[sel][~near[sel]]), 1)
    n_near = np.bincount(g[near[sel]], minlength=n_sample)
    diff = rows - want
    exact_rows = n_near == 0
    check(np.array_equal(rows[exact_rows], want[exact_rows])
          and (diff[~exact_rows] >= 0).all()
          and np.array_equal(diff.sum(axis=1), n_near),
          "sliding: sampled pane histograms equal numpy apart from boundary values")

    t2 = time.perf_counter()
    eng.advance_watermark(2 * span - 1)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    fired_keys = np.concatenate([k for k, _, _, _ in eng.fired])
    fired_res = np.concatenate([r for _, r, _, _ in eng.fired])
    fired_start = np.concatenate([np.full(len(k), s) for k, _, s, _ in eng.fired])
    n_windows = len(eng.fired)
    check(np.isfinite(fired_res).all() and fired_res.shape == (len(fired_keys), 2),
          "sliding: results finite, [pairs, 2]")
    # every (key, window) pair with an event fired once
    expect = sum(np.unique(keys[(ts >= W) & (ts < W + size)]).size
                 for W in np.unique(fired_start))
    check(len(fired_keys) == expect and n_windows == 19,
          "sliding: every (key, window) pair fired once, 19 windows")

    # fired results of sampled (key, window) pairs against numpy
    pick = rng.choice(len(fired_keys), n_sample, replace=False)
    order = np.lexsort((ts, keys))
    sk, st = keys[order], ts[order]
    explained = 0
    for p in pick.tolist():
        k, W = fired_keys[p], int(fired_start[p])
        lo_, hi_ = np.searchsorted(sk, k, "left"), np.searchsorted(sk, k, "right")
        idx = order[lo_:hi_][(st[lo_:hi_] >= W) & (st[lo_:hi_] < W + size)]
        hist = np.bincount(b_np[idx], minlength=agg.buckets)
        want_q = quantiles_of(hist, agg, bvals)
        if np.array_equal(fired_res[p], want_q):
            continue
        # a boundary value on its other bucket explains the difference
        ok = False
        for j in idx[near[idx]].tolist():
            h2 = hist.copy()
            h2[b_np[j]] -= 1
            h2[alt[j]] += 1
            ok = ok or np.array_equal(fired_res[p], quantiles_of(h2, agg, bvals))
        check(ok, f"sliding: result of key {k} window {W} equals numpy")
        explained += 1
    out = {"sliding": {
        "events": n_events, "key_space": n_keys, "window_ms": size,
        "slide_ms": slide, "buckets": agg.buckets, "quantiles": list(agg.quantiles),
        "live_pane_slots_before_final_fire": int(pane_slots),
        "capacity": eng.capacity, "state_bytes": eng.capacity * agg.buckets * 4,
        "fired_pairs": int(len(fired_keys)), "windows": n_windows,
        "events_per_s": n_events / (t1 - t0 + t3 - t2),
        "ingest_with_chunk_fires_s": t1 - t0, "final_fire_s": t3 - t2,
        "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
        "sampled_pairs": n_sample, "boundary_explained": explained,
        "pane_rows_with_boundary_values": int((~exact_rows).sum()),
        "reduced": "depth only: an unbounded stream cut to 2^22 events over "
                   "10 s of event time; key space, window geometry and "
                   "sketch widths unchanged"}}
    check(out["sliding"]["max_memory_allocated"] >= 3e9,
          "sliding: >= 3 GB of device memory at peak")
    del eng
    torch.cuda.empty_cache()
    emit(out)


# ---------------------------------------------------------------------
# phase 9: session windows with Count-Min, and heavy hitters (config #4)
# ---------------------------------------------------------------------

def countmin_np(vh: np.ndarray, depth: int, width: int) -> np.ndarray:
    """An independent numpy Count-Min table of unit-weight items."""
    hi = (vh >> np.uint64(32)).astype(np.uint64)
    lo = (vh & np.uint64(0xFFFFFFFF)).astype(np.uint64)
    table = np.zeros((depth, width), np.int32)
    for r in range(depth):
        col = ((lo + np.uint64(r) * hi) & np.uint64(0xFFFFFFFF)) % np.uint64(width)
        np.add.at(table[r], col.astype(np.int64), 1)
    return table


def session_cm_phase(dev, n_events=1 << 21, n_keys=100_000, span=30_000,
                     chunk=1 << 19, n_sample=4096):
    """VectorizedSessionWindows(CountMinSketchAggregate(), gap 1 s) at
    its default widths (d = 4, w = 2048): 100k keys, uniform user ids,
    2^21 time-sorted events over 30 s, a watermark after each chunk.
    Session totals exact against numpy sessions; sampled sessions'
    tables bit-equal to a numpy Count-Min."""
    import torch
    from flink_tpu_torch.ops.sketches import CountMinSketchAggregate
    from flink_tpu_torch.streaming.vectorized_sessions import VectorizedSessionWindows

    gap = 1000
    rng = np.random.default_rng(11)
    keys = rng.integers(0, n_keys, n_events).astype(np.uint64)
    ts = np.sort(rng.integers(0, span, n_events).astype(np.int64))
    users = rng.integers(0, 2**63, n_events).astype(np.uint64)
    kh, vh = splitmix64_np(keys), splitmix64_np(users)
    ones = np.ones(n_events, np.float32)
    agg = CountMinSketchAggregate()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    eng = VectorizedSessionWindows(agg, gap, initial_capacity=1 << 17, device=dev)
    captured = []                         # (emitted index, table row)
    result = agg.result

    def capturing_result(state, slots):
        out = result(state, slots)
        pos = np.arange(0, len(slots), max(1, len(slots) // 1024))
        rows = state["table"][slots[torch.from_numpy(pos).to(dev)].to(torch.int64)]
        captured.extend(zip((len(eng.emitted) + pos).tolist(), rows.cpu().numpy()))
        return out
    agg.result = capturing_result
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wms = []
    for i in range(0, n_events, chunk):
        sl = slice(i, i + chunk)
        eng.process_batch(keys[sl], ts[sl], ones[sl], key_hashes=kh[sl],
                          value_hashes=vh[sl])
        wms.append(int(ts[sl][-1]) - 1)
        eng.advance_watermark(wms[-1])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    eng.advance_watermark(2 * span)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    check(eng.num_late_dropped == 0, "sessions: no record late")

    # numpy sessions: a break where the key changes, the gap is exceeded,
    # or the watermark in force when the record arrived had already
    # closed the previous record's session
    order = np.lexsort((ts, keys))
    sk, st = keys[order], ts[order]
    wm_before = np.concatenate([[-(2**62)], wms])[order // chunk]
    brk = np.ones(n_events, bool)
    brk[1:] = ((sk[1:] != sk[:-1]) | (st[1:] - st[:-1] > gap)
               | (st[:-1] + gap - 1 <= wm_before[1:]))
    first = np.nonzero(brk)[0]
    last = np.append(first[1:] - 1, n_events - 1)
    want = np.stack([sk[first].astype(np.int64), st[first], st[last] + gap,
                     last - first + 1], axis=1)
    got = np.array([(int(k), s, e, int(r)) for k, r, s, e in eng.emitted], np.int64)
    want = want[np.lexsort(want.T[::-1])]
    got = got[np.lexsort(got.T[::-1])]
    check(np.array_equal(got, want), "sessions: every session and its total "
          "exact against numpy")
    # sampled sessions' tables against a numpy Count-Min
    start_of = {(int(k), int(s)): (a, b) for k, s, a, b in
                zip(sk[first], st[first], first, last)}
    sample = captured[:: max(1, len(captured) // n_sample)]
    for e, row in sample:
        k, _, s, _ = eng.emitted[e]
        a, b = start_of[(int(k), int(s))]
        check(np.array_equal(row, countmin_np(vh[order[a:b + 1]], agg.depth,
                                              agg.width)),
              f"sessions: table of key {k} session {s} equals numpy Count-Min")
    out = {"session_cm": {
        "events": n_events, "keys": n_keys, "gap_ms": gap, "depth": agg.depth,
        "width": agg.width, "sessions": int(len(got)),
        "capacity": eng.capacity,
        "table_bytes": eng.capacity * agg.depth * agg.width * 4,
        "events_per_s": n_events / (t2 - t0), "ingest_with_chunk_fires_s": t1 - t0,
        "final_fire_s": t2 - t1, "sampled_tables": len(sample),
        "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
        "reduced": "depth only: an unbounded stream cut to 2^21 events over "
                   "30 s; keys, gap and sketch widths unchanged"}}
    del eng
    torch.cuda.empty_cache()
    emit(out)


def heavy_hitter_phase(dev, n_events=1 << 21, n_keys=100_000, span=4_000,
                       chunk=1 << 19, phi=0.01):
    """WindowedHeavyHitters(1000 ms, phi = 0.01) over 100k keys, 60% of
    records from 8 heavy items and the rest from 10^5 tail items: no
    false negatives against exact counts, no estimate below the truth,
    every point query equal to the plain countmin_query."""
    import torch
    from flink_tpu_torch import kernels as K
    from flink_tpu_torch.streaming.heavy_hitters import WindowedHeavyHitters

    rng = np.random.default_rng(13)
    keys = rng.integers(0, n_keys, n_events)
    items = np.where(rng.random(n_events) < 0.6, rng.integers(0, 8, n_events),
                     rng.integers(8, 8 + 100_000, n_events))
    ts = np.sort(rng.integers(0, span, n_events).astype(np.int64))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    hh = WindowedHeavyHitters(1000, phi=phi, initial_capacity=1 << 17,
                              microbatch=chunk, device=dev)
    queries = {"calls": 0, "rows": 0, "unequal": 0}
    point_query = hh.agg.point_query

    def checked_point_query(state, slots, qh_hi, qh_lo):
        out = point_query(state, slots, qh_hi, qh_lo)
        plain = K.countmin_query_plain(state["table"], slots, qh_hi, qh_lo)
        queries["calls"] += 1
        queries["rows"] += len(slots)
        queries["unequal"] += int((out != plain).sum())
        return out
    hh.agg.point_query = checked_point_query
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(0, n_events, chunk):
        sl = slice(i, i + chunk)
        hh.process_items(keys[sl], ts[sl], items[sl])
        hh.advance_watermark(int(ts[sl][-1]) - 1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    hh.advance_watermark(2 * span)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    check(queries["calls"] == 4 and queries["unequal"] == 0,
          "heavy hitters: every point query equals the plain countmin_query")
    # exact counts per (key, window, item) and per (key, window)
    n_items = 8 + 100_000
    kw = keys * 4 + ts // 1000
    cell, counts = np.unique(kw * n_items + items, return_counts=True)
    totals = np.bincount(kw, minlength=4 * n_keys)
    heavy = cell[counts >= phi * totals[cell // n_items]]
    emitted = np.array([(int(k) * 4 + s // 1000) * n_items + int(i)
                        for k, hitters, s, _ in hh.hh_emitted for i, _ in hitters],
                       np.int64)
    ests = np.array([est for _, hitters, _, _ in hh.hh_emitted for _, est in hitters])
    check(np.isin(heavy, emitted).all(), "heavy hitters: no false negatives")
    check(np.isin(emitted, cell).all(), "heavy hitters: only items seen")
    truth = counts[np.searchsorted(cell, emitted)]
    check((ests >= truth).all(), "heavy hitters: no estimate below the exact count")
    out = {"heavy_hitters": {
        "events": n_events, "keys": n_keys, "phi": phi, "windows": 4,
        "candidates_queried": queries["rows"], "hitters": int(len(emitted)),
        "true_heavy": int(len(heavy)),
        "overestimated": int((ests > truth).sum()), "capacity": hh.capacity,
        "events_per_s": n_events / (t2 - t0), "ingest_with_chunk_fires_s": t1 - t0,
        "final_fire_s": t2 - t1,
        "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
        "reduced": "depth only: an unbounded stream cut to 2^21 events over "
                   "4 s; keys, item mix and sketch widths unchanged"}}
    del hh
    torch.cuda.empty_cache()
    emit(out)


# ---------------------------------------------------------------------
# chain_route (kernels phase) and the chain phase
# ---------------------------------------------------------------------

_CHAIN_MAP = lambda t: (t[0], t[1] * 3)              # noqa: E731
_CHAIN_FILTER = lambda t: t[1] % 7 != 0               # noqa: E731


def chain_route_classes(key, keep, kw):
    """The classes chain_route gives each row, in plain torch ops: the
    route's channel or the keep flag, plus the row shard's offset."""
    import torch
    from flink_tpu_torch.ops.hashing import operator_indexes, splitmix64
    if "key" in kw:
        nch = kw["num_channels"]
        cls = torch.where(keep, operator_indexes(splitmix64(key),
                                                 kw["max_parallelism"], nch), nch)
        nclass = nch + 1
    else:
        cls, nclass = (~keep).to(torch.int64), 2
    if kw.get("shard_rows"):
        rows = torch.arange(len(keep), device=keep.device)
        cls = cls + rows // kw["shard_rows"] * nclass
    return cls, nclass * max(1, kw.get("n_shards", 0))


def chain_route_library(cols, keep, key, kw, kept):
    """The yardstick: the same function in PyTorch calls, classes
    included (splitmix64, operator_indexes, where), a stable sort, the
    class starts (searchsorted), one index per column and the panes."""
    import torch
    cls, total = chain_route_classes(key, keep, kw)
    srt = torch.sort(cls, stable=True)
    starts = torch.searchsorted(srt.values, torch.arange(
        total, dtype=torch.int64, device=keep.device))
    order = srt.indices if kw.get("shard_rows") else srt.indices[:kept]
    out = [c[order] for c in cols]
    if kw.get("slide"):
        t = kw["ts"][order]
        out.append(t - torch.remainder(t - kw["pane_offset"], kw["slide"]))
    return out, starts


def chain_route_entry(dev, hbm, rng, entries, detail, n=1 << 20):
    """chain_route on 2^20 rows of config #2 events (int64 key, value
    and ts; 1M keys), the keep mask of the filter t[1] % 7 != 0: route
    mode at 4 and 128 channels, plain mode, window mode (1 s panes) on
    timestamps shifted to hold negative ones, and the mesh leg's 8 row
    shards with 40 composite classes.  Each against the plain version
    bit for bit (moved columns, bounds, count, panes; with row shards
    every shard's kept rows), and the launch's device starts against the
    host ones.  Times: the device-only launch as a run (``ms``); the call
    that reads the starts on the host, one call per event pair
    (``with_host_read_ms``); the yardstick computing the same function
    with the classes inside its run (``library_ms``) and the
    sort-and-index of precomputed classes alone (``sort_only_ms``)."""
    import torch
    from flink_tpu_torch import kernels as K
    keys, ts, vh = config2_events(rng, n_events=n)
    key = torch.from_numpy(keys.astype(np.int64)).to(dev)
    val = torch.from_numpy(vh.view(np.int64)).to(dev)
    t = torch.from_numpy(ts).to(dev)
    t_neg = t - 500
    keep = torch.from_numpy(vh.view(np.int64) % 7 != 0).to(dev)
    kept = int(keep.sum())
    S = 8
    route4 = dict(key=key, num_channels=4, max_parallelism=128)
    modes = (("route4", route4, t),
             ("route128", dict(key=key, num_channels=128, max_parallelism=128), t),
             ("plain", {}, t),
             ("window", dict(ts=t_neg, pane_offset=0, slide=1000), t_neg),
             ("mesh40", dict(route4, shard_rows=n // S, n_shards=S), t))
    for mode, kw, tcol in modes:
        cols = [key, val, tcol]
        got = K.chain_route(cols, keep, **kw)
        want = K.chain_route_plain(cols, keep, **kw)
        dev_starts = K.chain_route_launch(cols, keep, **kw)[2]
        torch.cuda.synchronize()
        st = got[2]
        check(np.array_equal(dev_starts.cpu().numpy(), st),
              f"chain_route {mode}: the launch's device starts equal the host ones")
        if mode == "mesh40":
            nclass = 5
            check(np.array_equal(st, want[2]) and len(st) == S * nclass
                  and int(sum(st[s * nclass + 4] - st[s * nclass] for s in range(S))) == kept,
                  "chain_route mesh40: class starts equal to plain")
            idx = torch.from_numpy(np.concatenate([
                np.arange(st[s * nclass], st[s * nclass + 4]) for s in range(S)])).to(dev)
            pairs = [(g[idx], w[idx]) for g, w in zip(got[0], want[0])]
            check(all(torch.equal(g, w) for g, w in pairs),
                  "chain_route mesh40: every shard's kept rows bit-equal to plain")
        else:
            check(np.array_equal(st, want[2]) and int(st[-1]) == kept,
                  f"chain_route {mode}: bounds and count equal to plain")
            pairs = list(zip(got[0], want[0]))
            check(all(torch.equal(g, w) for g, w in pairs),
                  f"chain_route {mode}: moved columns bit-equal to plain")
        if mode == "window":
            check(torch.equal(got[1], want[1]), "chain_route window: pane starts bit-equal")
            check(bool((got[1] < 0).any()), "chain_route window: negative panes in the sample")
        lib_out = chain_route_library(cols, keep, key, kw, kept)
        same = torch.equal(lib_out[1].cpu(), torch.from_numpy(st))
        if mode != "mesh40":
            same = same and all(torch.equal(a, b) for a, b in zip(lib_out[0], want[0]))
        if mode == "window":
            same = same and torch.equal(lib_out[0][-1], want[1])
        check(same, f"chain_route {mode}: the yardstick computes the same function")
        err = max(float((g - w).abs().max()) if len(g) else 0.0 for g, w in pairs)
        ms = cuda_ms(lambda: K.chain_route_launch(cols, keep, **kw))
        host_ms = cuda_ms(lambda: K.chain_route(cols, keep, **kw), single=True)
        plain = cuda_ms(lambda: K.chain_route_plain(cols, keep, **kw), 5,
                        single=True)
        lib = cuda_ms(lambda: chain_route_library(cols, keep, key, kw, kept))
        cls, _ = chain_route_classes(key, keep, kw)
        keep_rows = None if mode == "mesh40" else kept

        def sort_only():
            order = torch.sort(cls, stable=True).indices[:keep_rows]
            return [c[order] for c in cols]

        sort_ms = cuda_ms(sort_only)
        nbytes = n * (8 * len(cols) + 1) + kept * 8 * (len(cols) + (mode == "window"))
        b, by = bound(nbytes, 0, hbm)
        row = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b,
                   bound_by=by, max_abs_err=err)
        extra = {"shards": S, "classes": S * 5} if mode == "mesh40" else {}
        detail.append({"kernel": "chain_route", "mode": mode, "rows": n,
                       "kept": kept, **extra, "with_host_read_ms": host_ms,
                       "sort_only_ms": sort_ms,
                       "library": "classes + torch.sort(stable) + searchsorted "
                                  "+ indexing (+ panes)",
                       "sort_only": "torch.sort(stable) of precomputed classes "
                                    "+ indexing",
                       "timer": CHAIN_TIMER, **row})
        if mode == "route4":    # the job's route: four window subtasks
            entries["chain_route"] = row


def _chain_ops(out):
    """StreamMap -> StreamFilter of the chain phase, wired to out."""
    from flink_tpu_torch.core.functions import as_filter_function, as_map_function
    from flink_tpu_torch.streaming.operators import StreamFilter, StreamMap

    class _Next:
        def __init__(self, op):
            self.op = op

        def collect_batch(self, batch):
            self.op.process_batch(batch)

        def collect(self, record):
            self.op.process_element(record)

    m = StreamMap(as_map_function(_CHAIN_MAP))
    f = StreamFilter(as_filter_function(_CHAIN_FILTER))
    m.setup(_Next(f), operator_id="map")
    f.setup(out, operator_id="filter")
    return m, f


class _Channel:
    def __init__(self):
        self.got = []

    def push(self, element):
        self.got.append(element)


class _KeyRouter:
    """A chain tail with one key-group route to nch channels."""

    def __init__(self, nch):
        from flink_tpu_torch.core.functions import as_key_selector
        from flink_tpu_torch.streaming.partitioners import KeyGroupStreamPartitioner
        self.part = KeyGroupStreamPartitioner(as_key_selector(0), 128)
        self.channels = [_Channel() for _ in range(nch)]
        self.routes = [(self.part, self.channels, None)]

    def collect_batch(self, batch):
        for idx, sub in self.part.split_batch(batch, len(self.channels)):
            self.channels[idx].push(sub)


def _same_channels(a, b) -> bool:
    for ca, cb in zip(a.channels, b.channels):
        if len(ca.got) != len(cb.got):
            return False
        for x, y in zip(ca.got, cb.got):
            if list(x.cols) != list(y.cols) or not np.array_equal(x.ts, y.ts):
                return False
            if not all(x.cols[k].dtype == y.cols[k].dtype
                       and np.array_equal(x.cols[k], y.cols[k]) for k in y.cols):
                return False
    return True


def chain_phase(dev, n_events=1 << 23, n_keys=1_000_000, batch=1 << 20,
                n_window=1 << 20, window_keys=100_000, job_events=1 << 20,
                job_keys=100_000):
    """The fused chain program (route, window and the job) against the
    per-operator path: (b) config #2's events through map -> filter ->
    a 4-channel key-group exchange, fused and per operator; (c) window
    mode into WindowOperator on the GPU backend; (d) the job
    source -> map -> filter -> key_by(0) -> time_window(1 s) ->
    aggregate(HLL 12) with the window at parallelism 4."""
    import torch
    from flink_tpu_torch.streaming import chain_fusion as cf
    from flink_tpu_torch.streaming.elements import RecordBatch

    rng = np.random.default_rng(23)
    out = {}
    # (b) the fused prefix at config #2's width
    keys, ts, vh = config2_events(rng, n_events, n_keys)
    # visitor ids below 2^61: t[1] * 3 stays in int64, so the map's
    # column kernel passes its probe (an overflow would box it)
    f0, f1 = keys.astype(np.int64), (vh >> np.uint64(3)).astype(np.int64)
    batches = [RecordBatch({"f0": f0[i:i + batch], "f1": f1[i:i + batch]},
                           ts[i:i + batch]) for i in range(0, n_events, batch)]
    per_op = _KeyRouter(4)
    m, _ = _chain_ops(per_op)
    t0 = time.perf_counter()
    for b in batches:
        m.process_batch(b)
    per_op_s = time.perf_counter() - t0
    fused = _KeyRouter(4)
    m2, f2 = _chain_ops(fused)
    prog = cf.compile_chain([m2, f2], router=fused, device=dev)
    check(prog is not None and prog.route_field == 0, "chain: route mode compiled")
    cf.FUSION_STATS.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        check(prog.wants(b), "chain: the program wants every batch")
        prog.run(b)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    check(prog.active and cf.FUSION_STATS.probes == 1,
          f"chain: fused without demotion ({prog.demoted_reason})")
    check(_same_channels(fused, per_op),
          "chain: fused per-channel batches bit-equal to the per-operator path")
    # steady state (the signature is verified), then the split
    for ch in fused.channels:
        ch.got.clear()
    t0 = time.perf_counter()
    for b in batches:
        prog.run(b)
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0
    check(_same_channels(fused, per_op), "chain: second pass bit-equal too")

    def third_pass():
        for b in batches:
            prog.run(b)
    split = _device_split(third_pass)
    out["prefix"] = {
        "events": n_events, "keys": n_keys, "batch": batch, "channels": 4,
        "kept": int(sum(len(x) for ch in per_op.channels for x in ch.got)),
        "per_operator_events_per_s": n_events / per_op_s,
        "fused_events_per_s_first_pass": n_events / first_s,
        "fused_events_per_s": n_events / steady_s,
        "fused_split": split}
    del batches, per_op, fused, prog
    gc.collect()

    # (c) window mode: WindowOperator on the GPU backend
    out["window"] = _chain_window(dev, rng, n_window, window_keys)
    # (d) the job
    out["job"] = _chain_job(dev, rng, job_events, job_keys)
    torch.cuda.empty_cache()
    emit({"chain": out})


def _device_split(fn) -> dict:
    """Runs fn once under torch.profiler and splits the card's time by
    what it ran: host-to-device and device-to-host copies, the
    chain_route kernels (chain_count / chain_scan / chain_scatter) and
    the rest (the UDF stages' torch kernels, fills, memsets).  Also the
    host wall time of the run and the card's idle share in it; all
    None when the trace holds no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ms = {"h2d": 0.0, "udf": 0.0, "kernel": 0.0, "d2h": 0.0}
    n_events = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        n_events += 1
        dur = e.time_range.elapsed_us() / 1e3
        if "HtoD" in e.name:
            ms["h2d"] += dur
        elif "DtoH" in e.name:
            ms["d2h"] += dur
        elif "chain_" in e.name:
            ms["kernel"] += dur
        else:
            ms["udf"] += dur
    busy = sum(ms.values())
    if not n_events:
        return {"device_events": 0, "device_ms": None, "wall_ms": wall_ms,
                "idle_share": None}
    return {"device_events": n_events, "device_ms": ms, "wall_ms": wall_ms,
            "idle_share": 1.0 - busy / wall_ms}


def _chain_window(dev, rng, n, n_keys, chunk=1 << 18):
    import torch
    from flink_tpu_torch.streaming import chain_fusion as cf
    from flink_tpu_torch.streaming.elements import RecordBatch
    from flink_tpu_torch.streaming.harness import OneInputStreamOperatorTestHarness
    keys = rng.integers(0, n_keys, n)
    vals = rng.integers(0, 2**61, n)       # t[1] * 3 stays in int64
    ts = np.sort(rng.integers(0, 4000, n))

    def run(fused):
        h = OneInputStreamOperatorTestHarness(
            _uv_operator(12), key_selector=0, state_backend="gpu", device=dev)
        h.open()
        wop = h.operator
        m, f = _chain_ops(_NextOp(wop))
        prog = cf.compile_chain([m, f, wop], device=dev) if fused else None
        if fused:
            check(prog is not None and prog.window_op is wop,
                  "chain window: window mode compiled")
        cf.FUSION_STATS.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(0, n, chunk):
            sl = slice(i, i + chunk)
            b = RecordBatch({"f0": keys[sl], "f1": vals[sl]}, ts[sl])
            if fused:
                check(prog.wants(b), "chain window: the program wants every batch")
                prog.run(b)
            else:
                m.process_batch(b)
            h.process_watermark(int(ts[sl][-1]) - 1)
        h.process_watermark(2**62)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if fused:
            check(prog.active and cf.FUSION_STATS.fused_batches == -(-n // chunk),
                  f"chain window: every batch fused ({prog.demoted_reason})")
            check(wop.fused_rows > 0, "chain window: the operator took fused panes")
        return sorted(h.extract_output_values()), secs

    unfused, unfused_s = run(False)
    fused, fused_s = run(True)
    check(len(fused) > 0 and fused == unfused,
          "chain window: fused results equal to the unfused run")
    return {"events": n, "keys": n_keys, "results": len(fused),
            "unfused_events_per_s": n / unfused_s, "fused_events_per_s": n / fused_s}


class _NextOp:
    def __init__(self, op):
        self.op = op

    def collect_batch(self, batch):
        self.op.process_batch(batch)

    def collect(self, record):
        self.op.set_key_context(record)
        self.op.process_element(record)


def _chain_job(dev, rng, n, n_keys):
    import torch
    from flink_tpu_torch import kernels as K
    from flink_tpu_torch.ops.sketches import HyperLogLogAggregate
    from flink_tpu_torch.streaming import chain_fusion as cf
    from flink_tpu_torch.streaming.columnar import VectorizedCollectionSource
    from flink_tpu_torch.streaming.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.streaming.elements import RecordBatch
    from flink_tpu_torch.streaming.sources import CollectSink
    from flink_tpu_torch.streaming.windowing import Time
    keys = rng.integers(0, n_keys, n)
    vals = rng.integers(0, 1 << 40, n)
    ts = np.sort(rng.integers(0, 4000, n))
    data = RecordBatch({"f0": keys, "f1": vals}, ts)

    def run(fused):
        agg = HyperLogLogAggregate(12)
        agg.extract_value = lambda e: e[1]
        sink = []
        env = StreamExecutionEnvironment.get_execution_environment(device=dev)
        (env.add_source(VectorizedCollectionSource.from_batch(data, chunk=1 << 16))
            .map(_CHAIN_MAP).filter(_CHAIN_FILTER)
            .key_by(0).time_window(Time.milliseconds_of(1000))
            .aggregate(agg, window_function=lambda k, w, v: [(int(k), w.start, float(v[0]))])
            .set_parallelism(4)
            .add_sink(CollectSink(sink)))
        saved = cf.FUSION_ENABLED
        cf.FUSION_ENABLED = fused
        cf.FUSION_STATS.reset()
        before = dict(K.LAUNCHES)
        try:
            t0 = time.perf_counter()
            env.execute("chain-job")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            cf.FUSION_ENABLED = saved
        launched = {k: K.LAUNCHES[k] - before[k] for k in before}
        return (sorted(sink), secs, cf.FUSION_STATS.fused_batches,
                cf.FUSION_STATS.demotions, launched)

    unfused, unfused_s, _, _, _ = run(False)
    fused, fused_s, fused_batches, demotions, launched = run(True)
    check(fused_batches > 0 and demotions == 0,
          f"chain job: {fused_batches} batches fused, {demotions} demotions")
    # the job's own launches: the fused prefix and the window's log-tier
    # finish on the card
    check(launched["chain_route"] > 0 and launched["hll_log_finish"] > 0,
          f"chain job: chain_route and hll_log_finish launched ({launched})")
    check(fused == unfused, "chain job: sorted results equal fused and unfused")
    v3 = vals * 3
    kept = v3 % 7 != 0
    pairs = np.unique(keys[kept] * 4 + ts[kept] // 1000)
    check(np.array_equal(np.array(sorted(k * 4 + s // 1000 for k, s, _ in fused)),
                         pairs), "chain job: (key, window) set exact")
    check(all(np.isfinite(e) and e >= 1 for _, _, e in fused),
          "chain job: estimates finite")
    return {"events": n, "keys": n_keys, "parallelism": 4, "results": len(fused),
            "fused_batches": fused_batches, "launches": launched,
            "unfused_events_per_s": n / unfused_s,
            "fused_events_per_s": n / fused_s}


# ---------------------------------------------------------------------
# the mesh path: the sharded engines and the chain's mesh leg on 8
# virtual shards of one card
# ---------------------------------------------------------------------

def shard_pack_entry(dev, hbm, rng, entries, detail, shift=0):
    """shard_pack on both layouts of the mesh path, bit-equal to its
    plain version: K11a (the scatter tier's step: S = 8 sources of
    M = 2^17 rows, h_hi / h_lo / vh_hi / vh_lo / f32 value lanes and the
    bool mask lane, targets from the key hash, cap = M) and K11c (the
    mesh log's step: m = 2^17 rows a source, K = 6 uint32 lanes, given
    targets, cap = 4 m / S).  The PyTorch yardstick: a stable torch.sort
    of the rows' classes (computed beforehand) and one indexed write per
    lane."""
    import torch
    from flink_tpu_torch import kernels as K
    from flink_tpu_torch.kernels.shard_pack import target_shards
    S, m = 8, (1 << 17) >> shift
    n = S * m
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)   # noqa: E731
    kh = splitmix64_np(rng.integers(0, 1_000_000, n).astype(np.uint64))
    vh = splitmix64_np(rng.integers(0, 2**63, n).astype(np.uint64))
    mask = np.ones(n, bool)
    mask[rng.random(n) < 0.01] = False
    lanes = [t((kh >> np.uint64(32)).astype(np.uint32).view(np.int32)),
             t((kh & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)),
             t(rng.random(n).astype(np.float32)),
             t((vh >> np.uint64(32)).astype(np.uint32).view(np.int32)),
             t((vh & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)),
             t(mask)]
    tgt_np = rng.integers(0, S, n).astype(np.int32)
    tgt_np[~mask] = S
    rows = t(rng.integers(0, 2**31, (n, 6)).astype(np.int32))
    cases = (("K11a", lanes, m, dict(hash_lo=lanes[1], max_parallelism=128,
                                     mask=lanes[5])),
             ("K11c", rows, 4 * m // S, dict(target=t(tgt_np))))
    for name, data, cap, kw in cases:
        got = K.shard_pack(data, S, cap, **kw)
        want = K.shard_pack_plain(data, S, cap, **kw)
        torch.cuda.synchronize()
        outs = list(zip(got[0], want[0])) if isinstance(data, list) \
            else [(got[0], want[0])]
        check(torch.equal(got[1], want[1])
              and all(g.dtype == w.dtype and torch.equal(g, w) for g, w in outs),
              f"shard_pack {name}: buckets and counts bit-equal to plain")
        err = max(max_abs_err(g.reshape(-1, 1), w.reshape(-1, 1))
                  for g, w in outs)
        ms = cuda_ms(lambda: K.shard_pack(data, S, cap, **kw))
        plain = cuda_ms(lambda: K.shard_pack_plain(data, S, cap, **kw), 3)
        # the yardstick: classes and destinations computed beforehand
        if "target" in kw:
            tg = kw["target"].to(torch.int64)
        else:
            tg = torch.where(kw["mask"], target_shards(kw["hash_lo"], 128, S), S)
        src = torch.arange(n, device=dev) // m
        cls = src * (S + 1) + tg
        order0 = torch.sort(cls, stable=True).indices
        starts = torch.searchsorted(cls[order0], torch.arange(
            S * (S + 1), device=dev))
        rank = torch.arange(n, device=dev) - starts[cls[order0]]
        t_s, s_s = tg[order0], src[order0]
        ok = (t_s < S) & (rank < cap)
        q = ((s_s * S + t_s) * cap + rank)[ok]
        srcs = data if isinstance(data, list) else [data]
        dsts = [torch.zeros((S * S * cap, *x.shape[1:]), dtype=x.dtype, device=dev)
                for x in srcs]

        def library():
            order = torch.sort(cls, stable=True).indices[ok]
            for x, d in zip(srcs, dsts):
                d[q] = x[order]
        lib = cuda_ms(library)
        in_bytes = sum(x.numel() * x.element_size() for x in srcs)
        out_bytes = sum(S * S * cap * (x.numel() // n) * x.element_size()
                        for x in srcs)
        in_bytes += 4 * n if "target" in kw else 0
        b, by = bound(in_bytes + out_bytes + 4 * S * S, 0, hbm)
        row = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b,
                   bound_by=by, max_abs_err=float(err))
        detail.append({"kernel": "shard_pack", "layout": name, "sources": S,
                       "rows_per_source": m, "cap": cap,
                       "library": "torch.sort(stable) + indexed writes", **row})
        if name == "K11a":     # the scatter tier's step at config #2
            entries["shard_pack"] = row


def _launch_free(fn, *args, **kw):
    """Runs a comparison (a reference engine or job): its launches do not
    count toward the path's."""
    from flink_tpu_torch import kernels as K
    saved = dict(K.LAUNCHES)
    try:
        return fn(*args, **kw)
    finally:
        K.LAUNCHES.update(saved)


def _feed(eng, keys, ts, chunk, key_hashes=None, value_hashes=None):
    """process_batch in chunks of rows."""
    for i in range(0, len(keys), chunk):
        sl = slice(i, i + chunk)
        eng.process_batch(keys[sl], ts[sl], None,
                          key_hashes=None if key_hashes is None else key_hashes[sl],
                          value_hashes=None if value_hashes is None
                          else value_hashes[sl])


def _fired_arrays(eng):
    keys = np.concatenate([np.asarray(k) for k, _, _, _ in eng.fired])
    res = np.concatenate([r for _, r, _, _ in eng.fired])
    start = np.concatenate([np.full(len(k), s) for k, _, s, _ in eng.fired])
    order = np.lexsort((keys, start))
    return keys[order], res[order], start[order]


def _mesh_scatter(dev, mesh, rng, n_events, n_keys, region, step, chunk,
                  n_sample):
    """(a) config #2 through MeshTumblingWindows: HLL 12, one 1 s window,
    8 shards x 2 ring regions x region slots; each sampled key's
    registers and every key's estimate equal VectorizedTumblingWindows'
    on the same events."""
    import torch
    from flink_tpu_torch.core.keygroups import assign_operator_indexes_np
    from flink_tpu_torch.ops.sketches import HyperLogLogAggregate
    from flink_tpu_torch.parallel import MeshTumblingWindows
    from flink_tpu_torch.streaming.vectorized import VectorizedTumblingWindows
    keys, ts, vh = config2_events(rng, n_events, n_keys)
    kh = splitmix64_np(keys)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    eng = MeshTumblingWindows(HyperLogLogAggregate(12), 1000, mesh,
                              capacity_per_window_shard=region, ring=2,
                              step_batch=step)
    eng.emit_arrays = True
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _feed(eng, keys, ts, chunk, key_hashes=kh, value_hashes=vh)
    eng.flush()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sample = np.sort(rng.choice(np.unique(keys), n_sample, replace=False))
    s_kh = splitmix64_np(sample)
    shard_of = assign_operator_indexes_np(s_kh, 128, 8)
    mesh_regs = np.zeros((n_sample, 4096), np.uint8)
    for j in range(8):
        tb, sel = eng.table[j], np.nonzero(shard_of == j)[0]
        occ = tb.occupied[:region].cpu().numpy().astype(bool)
        pos = np.nonzero(occ)[0]
        h = ((tb.key_hi[:region].cpu().numpy().view(np.uint32)[pos].astype(np.uint64)
              << np.uint64(32))
             | tb.key_lo[:region].cpu().numpy().view(np.uint32)[pos])
        o = np.argsort(h)
        at = np.searchsorted(h[o], s_kh[sel])
        check(np.array_equal(h[o][np.minimum(at, len(h) - 1)], s_kh[sel]),
              "mesh scatter: every sampled key in its owner shard's table")
        mesh_regs[sel] = eng.state[j]["regs"][torch.from_numpy(
            pos[o][at]).to(dev)].cpu().numpy()
    state_bytes = 8 * eng.ring * region * 4096
    t2 = time.perf_counter()
    eng.advance_watermark(999)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    fk, fr, _ = _fired_arrays(eng)
    peak = torch.cuda.max_memory_allocated(dev)
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    def single():
        vec = VectorizedTumblingWindows(HyperLogLogAggregate(12), 1000,
                                        initial_capacity=n_keys + n_keys // 4,
                                        microbatch=chunk, device=dev)
        vec.emit_arrays = True
        _feed(vec, keys, ts, chunk, key_hashes=kh, value_hashes=vh)
        vec.flush()
        w = vec.windows[0]
        by_hash = np.argsort(w.all_hashes())
        slots = w.all_slots()[by_hash][np.searchsorted(
            w.all_hashes()[by_hash], s_kh)]
        regs = vec.state["regs"][torch.from_numpy(slots).to(dev)].cpu().numpy()
        vec.advance_watermark(999)
        out = _fired_arrays(vec)
        del vec
        gc.collect()
        torch.cuda.empty_cache()
        return regs, out
    vec_regs, (vk, vr, _) = _launch_free(single)
    check(np.array_equal(mesh_regs, vec_regs),
          f"mesh scatter: {n_sample} sampled keys' registers equal the "
          "single-device engine's")
    check(np.array_equal(fk.astype(np.uint64), vk.astype(np.uint64))
          and np.array_equal(fr, vr),
          "mesh scatter: every key's estimate bit-equal to the single-device "
          "engine's")
    check(state_bytes >= 17.1e9 or n_events < (1 << 23),
          "mesh scatter: 17.2 GB of registers on the card")
    return {"events": n_events, "keys": n_keys, "shards": 8,
            "region_slots": region, "ring": 2, "register_bytes": state_bytes,
            "fired": int(len(fk)), "ingest_s": t1 - t0, "fire_s": t3 - t2,
            "events_per_s": n_events / (t1 - t0 + t3 - t2),
            "max_memory_allocated": peak}


def _mesh_log(dev, mesh, rng, n_events, n_keys, step, chunk):
    """(b) the same config #2 events through MeshLogTumblingWindows
    (host finish) against LogStructuredTumblingWindows."""
    import torch
    from flink_tpu_torch.ops.sketches import HyperLogLogAggregate
    from flink_tpu_torch.parallel import MeshLogTumblingWindows
    from flink_tpu_torch.streaming.log_windows import LogStructuredTumblingWindows
    keys, ts, vh = config2_events(rng, n_events, n_keys)
    eng = MeshLogTumblingWindows(HyperLogLogAggregate(12), 1000, mesh,
                                 step_batch=step, finish_tier="host")
    eng.emit_arrays = True
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _feed(eng, keys, ts, chunk, value_hashes=vh)
    eng.flush()
    t1 = time.perf_counter()
    eng.advance_watermark(999)
    t2 = time.perf_counter()
    got = _fired_arrays(eng)

    def single():
        ref = LogStructuredTumblingWindows(HyperLogLogAggregate(12), 1000,
                                           finish_tier="host", device=dev)
        ref.emit_arrays = True
        _feed(ref, keys, ts, chunk, value_hashes=vh)
        ref.advance_watermark(999)
        return _fired_arrays(ref)
    want = _launch_free(single)
    check(all(np.array_equal(a, b) for a, b in zip(got, want)),
          "mesh log: every key's estimate equal to the single log engine's")
    return {"events": n_events, "keys": n_keys, "step_batch": step,
            "bucket_cap": eng.bucket_cap, "packed_steps": eng.num_packed_steps,
            "hostpack_steps": eng.num_hostpack_steps,
            "num_overflow_routed": eng.num_overflow_routed,
            "fired": int(len(got[0])), "ingest_s": t1 - t0, "fire_s": t2 - t1,
            "events_per_s": n_events / (t2 - t0)}


def _mesh_sliding(dev, mesh, rng, n_events, n_keys, region, step, chunk):
    """(c) config #3 (10 s / 1 s quantiles, B = 210) through
    MeshSlidingWindows (ring 16) against VectorizedSlidingWindows on the
    same events and watermarks: every (key, window) result equal."""
    import torch
    from flink_tpu_torch.ops.sketches import QuantileSketchAggregate
    from flink_tpu_torch.parallel import MeshSlidingWindows
    from flink_tpu_torch.streaming.vectorized import VectorizedSlidingWindows
    size, slide, span = 10_000, 1_000, 10_000
    keys = rng.integers(0, n_keys, n_events).astype(np.uint64)
    ts = np.sort(rng.integers(0, span, n_events).astype(np.int64))
    vals = rng.lognormal(3.0, 1.0, n_events).astype(np.float32)
    kh = splitmix64_np(keys)

    def drive(eng):
        eng.emit_arrays = True
        for i in range(0, n_events, chunk):
            sl = slice(i, i + chunk)
            eng.process_batch(keys[sl], ts[sl], vals[sl], key_hashes=kh[sl])
            eng.flush()
            eng.advance_watermark(int(ts[sl][-1]) - 1)
        eng.advance_watermark(2 * span - 1)
        torch.cuda.synchronize()
        return _fired_arrays(eng)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    agg = QuantileSketchAggregate(**Q3)
    eng = MeshSlidingWindows(agg, size, slide, mesh,
                             capacity_per_window_shard=region, extra_ring=4,
                             step_batch=step)
    state_bytes = 8 * eng.ring * region * agg.buckets * 4
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = drive(eng)
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    def single():
        vec = VectorizedSlidingWindows(QuantileSketchAggregate(**Q3), size, slide,
                                       initial_capacity=1 << 20,
                                       microbatch=chunk, device=dev)
        out = drive(vec)
        del vec
        gc.collect()
        torch.cuda.empty_cache()
        return out
    want = _launch_free(single)
    check(all(np.array_equal(a, b) for a, b in zip(got, want)),
          "mesh sliding: every (key, window) result equal to the single-device "
          "engine's")
    check(np.isfinite(got[1]).all() and len(np.unique(got[2])) == 19,
          "mesh sliding: finite results over 19 windows")
    check(state_bytes >= 28.1e9 or n_events < (1 << 22),
          "mesh sliding: 28.2 GB of sketch state on the card")
    return {"events": n_events, "key_space": n_keys, "window_ms": size,
            "slide_ms": slide, "region_slots": region, "ring": 16,
            "state_bytes": state_bytes, "fired_pairs": int(len(got[0])),
            "seconds": secs, "events_per_s": n_events / secs,
            "max_memory_allocated": peak,
            "reduced": "key space 10M -> 1M (a 10 s window's ~985k keys fit "
                       "a 2^18 region per shard at under half load; 10M would "
                       "need 2^20 regions: 113 GB); depth: 2^22 events"}


def _mesh_jobs(dev, mesh, rng, n, n_keys, n_composite):
    """(d) DataStream jobs with env.set_mesh(mesh): HLL 12, tumbling 1 s,
    integer keys (the mesh log tier, n events) and composite keys (the
    sharded scatter tier, the first n_composite events: each composite
    key is hashed row by row on the host, in both runs), each equal to
    the same job without a mesh."""
    from flink_tpu_torch.ops.sketches import HyperLogLogAggregate
    from flink_tpu_torch.streaming.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.streaming.device_window_operator import DeviceWindowOperator
    from flink_tpu_torch.streaming.sources import (
        BoundedOutOfOrdernessTimestampExtractor, CollectSink)
    from flink_tpu_torch.streaming.windowing import TumblingEventTimeWindows
    keys = rng.integers(0, n_keys, n)
    users = rng.integers(0, 2**62, n)
    ts = np.sort(rng.integers(0, 4000, n))
    events = list(zip(keys.tolist(), users.tolist(), ts.tolist()))
    engines = []
    ensure = DeviceWindowOperator._ensure_engine

    def noting(op, keys_arr):
        ensure(op, keys_arr)
        engines.append(type(op.engine).__name__)

    def run(with_mesh, key_of, events):
        agg = HyperLogLogAggregate(12)
        agg.extract_value = lambda e: e[1]
        sink = []
        env = StreamExecutionEnvironment.get_execution_environment(device=dev)
        if with_mesh:
            env.set_mesh(mesh)
        (env.from_collection(events)
            .assign_timestamps_and_watermarks(
                BoundedOutOfOrdernessTimestampExtractor(0, lambda e: e[2]))
            .key_by(key_of).window(TumblingEventTimeWindows.of(1000))
            .aggregate(agg, window_function=lambda k, w, v: [
                (str(k), w.start, float(v[0]))])
            .add_sink(CollectSink(sink)))
        t0 = time.perf_counter()
        env.execute("mesh-job")
        return sorted(sink), time.perf_counter() - t0
    out = {}
    DeviceWindowOperator._ensure_engine = noting
    try:
        for name, key_of, evs in (
                ("int_keys", lambda e: e[0], events),
                ("composite_keys", lambda e: (f"k{e[0] % 7}", e[0]),
                 events[:n_composite])):
            engines.clear()
            got, secs = run(True, key_of, evs)
            tier = sorted(set(engines))
            want, plain_s = _launch_free(run, False, key_of, evs)
            check(got == want and len(got) > 0,
                  f"mesh job ({name}): results equal the job without a mesh")
            out[name] = {"tier": tier, "events": len(evs), "results": len(got),
                         "events_per_s": len(evs) / secs,
                         "meshless_events_per_s": len(evs) / plain_s}
    finally:
        DeviceWindowOperator._ensure_engine = ensure
    check(out["int_keys"]["tier"] == ["MeshLogTumblingWindows"]
          and out["composite_keys"]["tier"] == ["MeshTumblingWindows"],
          "mesh jobs: integer keys on the mesh log tier, composite keys on "
          "the sharded scatter tier")
    out["keys"] = n_keys
    return out


def _mesh_chain(dev, rng, n_events, n_keys, batch):
    """(e) the chain phase's map -> filter -> 4-channel key-group route
    with devices() widened to 8 virtual shards: the program's
    chain_route launches take composite classes (8 x 5); the channels'
    batches are bit-equal to the single-device program's and the
    per-operator path's."""
    import importlib

    import torch
    from flink_tpu_torch.parallel.mesh import virtual_devices
    from flink_tpu_torch.streaming import chain_fusion as cf
    from flink_tpu_torch.streaming.elements import RecordBatch
    keys, ts, vh = config2_events(rng, n_events, n_keys)
    f0, f1 = keys.astype(np.int64), (vh >> np.uint64(3)).astype(np.int64)
    batches = [RecordBatch({"f0": f0[i:i + batch], "f1": f1[i:i + batch]},
                           ts[i:i + batch]) for i in range(0, n_events, batch)]

    def reference():
        per_op = _KeyRouter(4)
        m, _ = _chain_ops(per_op)
        for b in batches:
            m.process_batch(b)
        single = _KeyRouter(4)
        m1, f1_ = _chain_ops(single)
        prog1 = cf.compile_chain([m1, f1_], router=single, device=dev)
        for b in batches:
            prog1.run(b)
        return per_op, single
    per_op, single = _launch_free(reference)
    cr = importlib.import_module("flink_tpu_torch.kernels.chain_route")
    classes = []
    restore = _recording(cr, "chain_route", lambda a, r: classes.append(len(r[2])))
    try:
        with virtual_devices(8, dev):
            fused = _KeyRouter(4)
            m2, f2 = _chain_ops(fused)
            prog = cf.compile_chain([m2, f2], router=fused, device=dev)
        check(prog.mesh_shards == 8, "mesh chain: the program shards over 8")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            prog.run(b)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        restore()
    check(prog.active and set(classes) == {40},
          f"mesh chain: every launch on 40 composite classes ({set(classes)}, "
          f"{prog.demoted_reason})")
    check(_same_channels(fused, per_op) and _same_channels(fused, single),
          "mesh chain: channels bit-equal to the single-device program and the "
          "per-operator path")
    return {"events": n_events, "batch": batch, "shards": 8, "classes": 40,
            "fused_events_per_s": n_events / secs}


def mesh_phase(dev, n_events=1 << 23, n_keys=1_000_000, region=1 << 18,
               step=1 << 20, chunk=1 << 20, n_sample=256,
               sliding_events=1 << 22, sliding_region=1 << 18,
               sliding_chunk=1 << 19, job_events=1 << 21, job_keys=8000,
               composite_events=1 << 19, chain_events=1 << 22,
               chain_batch=1 << 20):
    """The mesh path on 8 virtual shards of the card: (a) config #2 on
    the sharded scatter tier, (b) on the mesh log tier, (c) config #3 on
    the sharded sliding engine, (d) DataStream jobs with set_mesh, (e)
    the fused chain's mesh leg.  Each against its single-device twin."""
    from flink_tpu_torch.parallel import Mesh
    mesh = Mesh([dev] * 8)
    rng = np.random.default_rng(41)
    out = {"scatter": _mesh_scatter(dev, mesh, rng, n_events, n_keys, region,
                                    step, chunk, n_sample),
           "log": _mesh_log(dev, mesh, rng, n_events, n_keys, step, chunk),
           "sliding": _mesh_sliding(dev, mesh, rng, sliding_events, n_keys,
                                    sliding_region, step, sliding_chunk),
           "jobs": _mesh_jobs(dev, mesh, rng, job_events, job_keys,
                              composite_events),
           "chain": _mesh_chain(dev, rng, chain_events, n_keys, chain_batch),
           "exchange": "Mesh.all_to_all on one card: a device transpose; no "
                       "NCCL collective is measured"}
    emit({"mesh": out})


# ---------------------------------------------------------------------
# the graph and ML paths: data at public datasets' shapes, from a seed
# ---------------------------------------------------------------------

def kronecker_edges(dev, scale, seed, edge_factor=16):
    """Graph500's Kronecker generator (initiator A, B, C = 0.57, 0.19,
    0.19; LDBC Graphalytics' graph500-* datasets): edge_factor * 2^scale
    directed edges over 2^scale vertices with permuted labels, drawn on
    the card from a seed, and edge weights uniform in [0, 1) as float32
    (Graph500's SSSP kernel).  Self-loops and repeated edges stay, as the
    generator makes them.  Returns numpy (src, dst int32; weight f32)."""
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n, m = 1 << scale, edge_factor << scale
    a, b, c = 0.57, 0.19, 0.19
    ab, c_norm, a_norm = a + b, c / (1.0 - (a + b)), a / (a + b)
    src = torch.zeros(m, dtype=torch.int64, device=dev)
    dst = torch.zeros(m, dtype=torch.int64, device=dev)
    for bit in range(scale):
        ii = torch.rand(m, generator=gen, device=dev) > ab
        jj = torch.rand(m, generator=gen, device=dev) > torch.where(
            ii, torch.tensor(c_norm, device=dev), torch.tensor(a_norm, device=dev))
        src |= ii.to(torch.int64) << bit
        dst |= jj.to(torch.int64) << bit
    perm = torch.randperm(n, generator=gen, device=dev)
    order = torch.randperm(m, generator=gen, device=dev)
    src, dst = perm[src][order], perm[dst][order]
    w = torch.rand(m, generator=gen, device=dev)
    out = (src.to(torch.int32).cpu().numpy(), dst.to(torch.int32).cpu().numpy(),
           w.cpu().numpy())
    del src, dst, w, perm, order
    torch.cuda.empty_cache()
    return out


# independent references: numpy and scipy only, run in worker processes
# beside the card's work

def _timed(fn, *args):
    """(seconds, fn(*args)), timed in the worker process."""
    t0 = time.perf_counter()
    res = fn(*args)
    return time.perf_counter() - t0, res


def _csr(rows, cols, vals, n):
    from scipy.sparse import csr_matrix
    return csr_matrix((vals, (rows, cols)), shape=(n, n))


def ref_pagerank64(src, dst, n, steps, d=0.85):
    """Float64 power iteration of the reference's PageRank step, and the
    L1 bound of one float32 step's summation: 2 eps sum_v deg_in(v)
    summed_v (two orders of deg_in(v) terms) + 8 eps for the elementwise
    ops."""
    out_deg = np.bincount(src, minlength=n).astype(np.float64)
    M = _csr(dst, src, 1.0 / np.maximum(out_deg, 1.0)[src], n)
    sinks = out_deg == 0
    r = np.full(n, 1.0 / n)
    for _ in range(steps):
        summed = M @ r
        r = (1.0 - d) / n + d * (summed + r[sinks].sum() / n)
    deg_in = np.bincount(dst, minlength=n)
    step_l1 = 2 * EPS32 * float((deg_in * summed).sum()) + 8 * EPS32
    return r, step_l1


def ref_hits64(src, dst, n, steps):
    """Float64 HITS with the reference's step, and the L1 bound of one
    float32 step for authorities and hubs (as for PageRank, on each of
    the two sums; no contraction assumed)."""
    A = _csr(dst, src, np.ones(len(src)), n)
    At = A.T.tocsr()
    hubs, auths = np.ones(n), np.ones(n)
    for _ in range(steps):
        auths = A @ hubs
        auths /= max(np.linalg.norm(auths), 1e-12)
        hubs = At @ auths
        hubs /= max(np.linalg.norm(hubs), 1e-12)
    deg_in, deg_out = np.bincount(dst, minlength=n), np.bincount(src, minlength=n)
    l1 = lambda deg, x: 2 * EPS32 * float((deg * x).sum()) + 8 * EPS32 * float(x.sum())  # noqa: E731
    return hubs, auths, l1(deg_out, hubs), l1(deg_in, auths)


def ref_components(src, dst, n):
    """Min-id component labels by scipy's connected_components."""
    from scipy.sparse.csgraph import connected_components
    _, lab = connected_components(_csr(src, dst, np.ones(len(src), np.float32), n),
                                  directed=False)
    first = np.full(lab.max() + 1, n, np.int64)
    np.minimum.at(first, lab, np.arange(n))
    return first[lab]


def ref_dijkstra(src, dst, w, n, source):
    """Shortest distances from source by scipy's Dijkstra; repeated
    edges stay (the shortest counts), zero weights are edges."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra
    order = np.argsort(src, kind="stable")
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=indptr[1:])
    g = csr_matrix((w[order].astype(np.float64), dst[order], indptr), shape=(n, n))
    return dijkstra(g, directed=True, indices=source)


def ref_max_flood(src, dst, vals):
    """Each vertex's largest value over itself and every vertex that
    reaches it: np.maximum.at over the edges to a fixed point."""
    cur = vals.astype(np.int64)
    while True:
        new = cur.copy()
        np.maximum.at(new, dst, cur[src])
        if np.array_equal(new, cur):
            return cur
        cur = new


def graph_kernel_entries(dev, hbm, entries, detail, scale=22, tri_scale=18):
    """gather_segment_sum on the scale-22 graph's edges (PageRank's
    contributions, through the plan by target) and edge_popcount on the
    scale-18 graph's bitset and canonical pairs, each against its plain
    version; gather_segment_sum also against a second launch (bit for
    bit) and beside two PyTorch yardsticks: a CSR sparse tensor of the
    plan times x (cuSPARSE), and index_add_ of x[src] gathered
    beforehand."""
    import torch
    from flink_tpu_torch import kernels as K
    from flink_tpu_torch.graph import library as tlib
    src_np, dst_np, _ = kronecker_edges(dev, scale, seed=61)
    n, e = 1 << scale, len(src_np)
    src, dst = (torch.from_numpy(a).to(dev) for a in (src_np, dst_np))
    plan_ms = cuda_ms(lambda: K.segment_plan(src, dst, n), 3, single=True)
    plan = K.segment_plan(src, dst, n)
    deg = torch.clamp(torch.bincount(src, minlength=n), min=1).to(torch.float32)
    x = torch.full((n,), 1.0 / n, device=dev) / deg
    got = K.gather_segment_sum(x, plan)
    again = K.gather_segment_sum(x, plan)
    want = K.gather_segment_sum_plain(x, plan)
    mag = K.gather_segment_sum_plain(x.abs(), plan).double()
    deg_in = torch.bincount(dst, minlength=n).double()
    err = (got.double() - want.double()).abs()
    check(bool((err <= 2 * deg_in * EPS32 * mag).all()),
          "gather_segment_sum within 2 deg_in eps sum|x| of plain")
    check(torch.equal(got, again), "gather_segment_sum: two launches bit-identical")
    ms = cuda_ms(lambda: K.gather_segment_sum(x, plan))
    plain = cuda_ms(lambda: K.gather_segment_sum_plain(x, plan), 5)
    csr = torch.sparse_csr_tensor(plan.indptr, plan.cols,
                                  torch.ones(e, device=dev), (n, n))
    try:
        csr @ x
        spmv = lambda: csr @ x                              # noqa: E731
        spmv_form = "sparse_csr_tensor(indptr, cols, ones) @ x"
    except RuntimeError:
        spmv = lambda: (csr @ x[:, None])[:, 0]             # noqa: E731
        spmv_form = "sparse_csr_tensor(indptr, cols, ones) @ x[:, None]"
    check(bool(((spmv() - want).abs().double() <= 2 * deg_in * EPS32 * mag).all()),
          "the CSR SpMV yardstick within the reorder bound of plain")
    lib = cuda_ms(spmv)
    xs = x[src]
    out = torch.zeros(n, device=dev)
    index_add_ms = cuda_ms(lambda: out.index_add_(0, dst, xs))
    # each input byte once: cols, indptr, x; out written once; an add an edge
    b, by = bound(4 * e + 4 * (n + 1) + 4 * n + 4 * n, e, hbm)
    entries["gather_segment_sum"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                         bound_ms=b, bound_by=by,
                                         max_abs_err=float(err.max()))
    detail.append({"kernel": "gather_segment_sum", "vertices": n, "edges": e,
                   "tiles": len(plan.coords) - 1, "ms": ms, "plan_ms": plan_ms,
                   "library": spmv_form, "library_ms": lib,
                   "index_add_ms": index_add_ms,
                   "index_add": "index_add_ of x[src] gathered beforehand",
                   "old_bound_ms": bound(16 * e, e, hbm)[0],
                   "timer": "plan: " + SINGLE + "; the rest: " + RUN})
    del deg, x, got, again, want, mag, deg_in, err, xs, out, csr, plan
    torch.cuda.empty_cache()
    scatter_combine_graph_entry(dev, hbm, src, dst, n, detail)
    del src, dst
    torch.cuda.empty_cache()

    src_np, dst_np, _ = kronecker_edges(dev, tri_scale, seed=62)
    n = 1 << tri_scale
    pairs = tlib._NeighborPairs(_graph(src_np, dst_np, np.ones(len(src_np), np.float32), n)).pairs
    u, v = (torch.from_numpy(np.ascontiguousarray(pairs[:, i], np.int32)).to(dev)
            for i in (0, 1))
    adj = tlib.adjacency_bitset(n, u, v)
    words, p = adj.shape[1], len(u)
    got = K.edge_popcount(adj, u, v)
    want = K.edge_popcount_plain(adj, u, v)
    check(torch.equal(got, want), "edge_popcount bit-equal to plain")
    ms = cuda_ms(lambda: K.edge_popcount(adj, u, v), 5)
    plain = cuda_ms(lambda: K.edge_popcount_plain(adj, u, v), 1)
    b, by = bound(4 * n * words + 12 * p, 2 * p * words, hbm)
    entries["edge_popcount"] = dict(ms=ms, plain_ms=plain, library_ms=None,
                                    bound_ms=b, bound_by=by,
                                    max_abs_err=float((got - want).abs().max()))
    detail.append({"kernel": "edge_popcount", "vertices": n, "pairs": p,
                   "words": words, "bitset_bytes": 4 * n * words,
                   "per_pair_bound_ms": bound(8 * words * p + 12 * p, 0, hbm)[0],
                   "library": None})
    del adj, u, v, got, want
    torch.cuda.empty_cache()


def scatter_combine_graph_entry(dev, hbm, src, dst, n, detail):
    """scatter_combine at the graph path's shape (K12a, the iteration
    models' combine on the scale-22 graph): Bellman-Ford's float32 min
    over the 67.1M directed edges (messages dist[src] + w: uniform floats
    here) and the components' int32 min over the 134.2M undirected edges
    (messages the source's label, its id at the first superstep), into
    4,194,304 slots filled with the identity before each call, as every
    superstep fills them.  Each exact against the plain version; the
    kernel, the plain version and
    ``scatter_reduce_`` amin (its int64 index made beforehand), each one
    call per event pair after the fill.  Bound: 8 B a message, the state
    written once."""
    import torch
    from flink_tpu_torch import kernels as K
    gen = torch.Generator(device=dev)
    gen.manual_seed(63)
    cases = (("f32 min, directed", dst, torch.rand(len(dst), generator=gen, device=dev),
              float("inf")),
             ("i32 min, undirected", torch.cat([dst, src]), torch.cat([src, dst]),
              int(np.iinfo(np.int32).max)))
    for label, slots, msgs, ident in cases:
        e = len(slots)
        state = torch.full((n,), ident, dtype=msgs.dtype, device=dev)
        ref = state.clone()
        fill = lambda: state.fill_(ident)                   # noqa: E731
        K.scatter_combine(state, slots, msgs, e, "min")
        K.scatter_combine_plain(ref, slots, msgs, e, "min")
        check(torch.equal(state, ref), f"scatter_combine graph {label}: exact")
        ms = cuda_ms(lambda: K.scatter_combine(state, slots, msgs, e, "min"), 10, fill)
        plain = cuda_ms(lambda: K.scatter_combine_plain(state, slots, msgs, e, "min"),
                        3, fill)
        idx = slots.to(torch.int64)
        lib = cuda_ms(lambda: state.scatter_reduce_(0, idx, msgs, "amin"), 10, fill)
        del idx
        b, by = bound(8 * e + 4 * n, e, hbm)
        detail.append({"kernel": "scatter_combine", "shape": "graph500 scale 22",
                       "case": label, "messages": e, "slots": n, "ms": ms,
                       "plain_ms": plain, "library_ms": lib,
                       "library": "scatter_reduce_ amin", "bound_ms": b,
                       "bound_by": by, "max_abs_err": 0.0,   # checked equal
                       "timer": SINGLE + "; the setup fills the state"})
        del state, ref, msgs, slots
        torch.cuda.empty_cache()


def _graph(src, dst, w, n, values=None):
    """A port Graph straight from its columns (vertex i has id i)."""
    from flink_tpu_torch.graph import Graph
    return Graph(range(n), np.zeros(n, np.float32) if values is None else values,
                 src, dst, w)


def graph_phase(dev, scale=22, tri_scale=18, n_sample=4096):
    """The graph library on a Graph500 Kronecker graph (scale 22: 4.19M
    vertices, 67.1M directed edges, weights uniform in [0, 1)):
    PageRank (0.85, default iterations), HITS, ConnectedComponents,
    SingleSourceShortestPaths from the vertex of highest degree and a
    PregelIteration max-flood; TriangleCount and ClusteringCoefficient
    at scale 18 (their dense bitset is n^2 / 8 bytes: 8.6 GB there,
    2 TB at scale 22).  Checked against numpy and scipy, computed in
    worker processes beside the card's work."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch
    from flink_tpu_torch import graph as tg
    from flink_tpu_torch.graph import iterations as titer
    from flink_tpu_torch.graph import library as tlib
    t_gen = time.perf_counter()
    src, dst, w = kronecker_edges(dev, scale, seed=21)
    n, e = 1 << scale, len(src)
    g = _graph(src, dst, w, n)
    deg = np.bincount(src, minlength=n) + np.bincount(dst, minlength=n)
    source = int(np.argmax(deg))
    flood_vals = np.random.default_rng(22).integers(0, 1 << 30, n).astype(np.int32)
    out = {"vertices": n, "edges": e, "setup_s": time.perf_counter() - t_gen,
           "sssp_source_degree": int(deg[source]),
           "cut": f"triangles and clustering at scale {tri_scale} "
                  f"(bitset {(1 << tri_scale) ** 2 // 8} bytes), not {scale}"}
    marks = {}
    first_step = []      # PageRank's first superstep: (x, plan, result)

    def note_step(args, result):
        if not first_step:
            first_step.append((args[0].clone(), args[1], result.clone()))
    restore = [_kernel_clock(tlib, ("gather_segment_sum", "edge_popcount",
                                    "segment_plan"), marks),
               _kernel_clock(titer, ("scatter_combine",), marks),
               _recording(tlib, "gather_segment_sum", note_step)]
    ctx = multiprocessing.get_context("spawn")
    try:
        with ProcessPoolExecutor(5, mp_context=ctx) as pool:
            # the power iterations start with the defaults' step counts,
            # which float32 runs at this scale reach (a tolerance of 1e-9
            # is below their rounding); resubmitted if a run stops sooner
            steps = {"pagerank": 100, "hits": 50}
            refs = {"pagerank": pool.submit(_timed, ref_pagerank64, src, dst, n,
                                            steps["pagerank"]),
                    "hits": pool.submit(_timed, ref_hits64, src, dst, n, steps["hits"]),
                    "components": pool.submit(_timed, ref_components, src, dst, n),
                    "sssp": pool.submit(_timed, ref_dijkstra, src, dst, w, n, source),
                    "flood": pool.submit(_timed, ref_max_flood, src, dst, flood_vals)}
            runs = {}

            def run(name, fn, kernel):
                """Run fn; count the calls of ``kernel`` it made (a
                superstep each for the iterations)."""
                before = len(marks.get(kernel, ()))
                plans = len(marks.get("segment_plan", ()))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = fn()
                runs[name] = {"s": time.perf_counter() - t0,
                              "calls": len(marks.get(kernel, ())) - before}
                built = marks.get("segment_plan", [])[plans:]
                if built:    # the plans' build, inside "s"
                    torch.cuda.synchronize()
                    runs[name]["plans"] = len(built)
                    runs[name]["plan_s"] = sum(a.elapsed_time(b) for a, b in built) / 1e3
                return res

            pr = run("pagerank", lambda: g.run(tg.PageRank(0.85, device=dev)),
                     "gather_segment_sum")
            if runs["pagerank"]["calls"] != steps["pagerank"]:
                refs["pagerank"] = pool.submit(_timed, ref_pagerank64, src, dst, n,
                                               runs["pagerank"]["calls"])
            hubs, auths = run("hits", lambda: g.run(tg.HITS(device=dev)),
                              "gather_segment_sum")
            hits_steps = runs["hits"]["calls"] // 2
            if hits_steps != steps["hits"]:
                refs["hits"] = pool.submit(_timed, ref_hits64, src, dst, n, hits_steps)
            cc = run("components", lambda: g.run(tg.ConnectedComponents(device=dev)),
                     "scatter_combine")
            sssp = run("sssp", lambda: g.run(tg.SingleSourceShortestPaths(
                source, max_iterations=1000, device=dev)), "scatter_combine")
            flood = run("pregel_max_flood", lambda: _graph(src, dst, w, n, flood_vals).run(
                tg.PregelIteration(lambda s, ev: s, "max",
                                   lambda v, c, step: torch.maximum(v, c), device=dev)),
                "scatter_combine")
            tri = _triangle_part(dev, tri_scale, n_sample, run, out)
            t_wait = time.perf_counter()
            timed = {k: f.result() for k, f in refs.items()}
            out["reference_wait_s"] = time.perf_counter() - t_wait
    finally:
        for r in reversed(restore):
            r()
    out["reference_s"] = {k: t for k, (t, _) in timed.items()}
    ref = {k: r for k, (_, r) in timed.items()}
    out["runs"] = runs
    out["kernel_device_s"] = _device_seconds(
        {k: v for k, v in marks.items() if k != "segment_plan"})
    x1, plan1, step1 = first_step[0]

    def relaunch():
        from flink_tpu_torch import kernels as K
        return K.gather_segment_sum(x1, plan1), K.gather_segment_sum_plain(x1, plan1), \
            K.gather_segment_sum_plain(x1.abs(), plan1)
    again, plain1, mag1 = _launch_free(relaunch)
    deg_in = (plan1.indptr[1:] - plan1.indptr[:-1]).double()
    check(torch.equal(again, step1),
          "graph: PageRank's first superstep bit-identical on a second launch")
    check(bool(((step1.double() - plain1.double()).abs()
                <= 2 * deg_in * EPS32 * mag1.double()).all()),
          "graph: PageRank's first superstep within the reorder bound of plain")
    del x1, plan1, step1, again, plain1, mag1, deg_in
    vec = lambda d: np.fromiter(d.values(), np.float64, count=n)  # noqa: E731
    r64, step_l1 = ref["pagerank"]
    l1 = float(np.abs(vec(pr) - r64).sum())
    check(l1 <= step_l1 / (1.0 - 0.85),
          "pagerank: L1 to the float64 run within one step's bound / (1 - d)")
    h64, a64, h_l1, a_l1 = ref["hits"]
    dh, da = float(np.abs(vec(hubs) - h64).sum()), float(np.abs(vec(auths) - a64).sum())
    check(dh <= hits_steps * h_l1 and da <= hits_steps * a_l1,
          "hits: L1 to the float64 run within steps x one step's bound")
    check(np.array_equal(np.fromiter(cc.values(), np.int64, count=n), ref["components"]),
          "components: min-id labels equal scipy's")
    d32, d64 = vec(sssp), ref["sssp"]
    reach = np.isfinite(d64)
    hops = runs["sssp"]["calls"]
    check(np.array_equal(np.isfinite(d32), reach), "sssp: the same vertices reached")
    sssp_err = float(np.abs(d32[reach] - d64[reach]).max())
    check(bool(np.all(np.abs(d32[reach] - d64[reach]) <= hops * EPS32 * d64[reach])),
          "sssp: within supersteps x eps x distance of Dijkstra")
    check(np.array_equal(np.asarray(flood.vertex_values, np.int64), ref["flood"]),
          "pregel max-flood equals numpy's fixed point")
    out["checks"] = {"pagerank_l1": l1, "pagerank_l1_bound": step_l1 / 0.15,
                     "hits_l1": [dh, da],
                     "hits_l1_bound": [hits_steps * h_l1, hits_steps * a_l1],
                     "components": int(len(np.unique(ref["components"]))),
                     "reached": int(reach.sum()), "sssp_max_abs_err": sssp_err,
                     "triangles": tri}
    # edges visited per second: a superstep visits every edge once (the
    # undirected graph's two directions for the components)
    out["edges_per_s"] = {k: e * (1 + (k == "components")) * runs[k]["calls"] / runs[k]["s"]
                          for k in ("pagerank", "hits", "components", "sssp",
                                    "pregel_max_flood")}
    emit({"graph": out})


def _triangle_part(dev, scale, n_sample, run, out):
    """TriangleCount and ClusteringCoefficient on a scale-18 Kronecker
    graph; the per-edge common-neighbour counts both runs computed are
    equal, and 4,096 sampled canonical edges' counts equal a
    sorted-adjacency intersection in numpy."""
    from flink_tpu_torch import graph as tg
    from flink_tpu_torch.graph import library as tlib
    src, dst, w = kronecker_edges(dev, scale, seed=23)
    g = _graph(src, dst, w, 1 << scale)
    commons = []
    restore = _recording(tlib, "edge_popcount",
                         lambda a, r: commons.append(r.cpu().numpy()))
    try:
        count = run("triangles", lambda: g.run(tg.TriangleCount(device=dev)),
                    "edge_popcount")
        local, avg, global_cc = run("clustering", lambda: g.run(
            tg.ClusteringCoefficient(device=dev)), "edge_popcount")
    finally:
        restore()
    check(len(commons) == 2 and np.array_equal(commons[0], commons[1]),
          "triangles and clustering: the same per-edge counts")
    common = commons[0]
    np_ = tlib._NeighborPairs(g)
    pairs = np_.pairs
    nbrs_of = lambda x: np.sort(np_.adj_flat[np_.indptr[x]:np_.indptr[x + 1]])  # noqa: E731
    sample = np.random.default_rng(24).choice(len(pairs), n_sample, replace=False)
    want = [np.intersect1d(nbrs_of(a), nbrs_of(b), assume_unique=True).size
            for a, b in pairs[sample]]
    check(np.array_equal(common[sample], want),
          f"triangles: {n_sample} sampled edges' common neighbours exact")
    check(count == int(common.sum()) // 3, "triangles: count = sum / 3")
    wedges = (np_.deg * (np_.deg - 1.0) / 2.0).sum()
    check(abs(global_cc - 3.0 * (common.sum() / 3.0) / wedges) <= 1e-12,
          "clustering: global coefficient from the counts")
    check(np.isfinite(avg) and 0.0 <= avg <= 1.0, "clustering: average in [0, 1]")
    return {"scale": scale, "pairs": int(len(pairs)), "triangles": int(count),
            "average_clustering": float(avg), "global_clustering": float(global_cc)}


def movielens_shape(rng, n_ratings=20_000_263, n_users=138_493, n_items=26_744):
    """Ratings at MovieLens-20M's shape: 138,493 users who each rate at
    least 20 times (as in ML-20M), 26,744 items each rated at least once,
    the rest by a Zipf-like popularity, stars 0.5 to 5 in half steps.
    Returns (user int32, item int32, stars float32)."""
    u = np.concatenate([np.repeat(np.arange(n_users), 20),
                        rng.integers(0, n_users, n_ratings - 20 * n_users)])
    pop = 1.0 / (np.arange(n_items) + 10.0)
    i = rng.choice(n_items, n_ratings, p=pop / pop.sum())
    i[:n_items] = np.arange(n_items)
    r = rng.integers(1, 11, n_ratings) / 2.0
    return u.astype(np.int32), i.astype(np.int32), r.astype(np.float32)


def mnist_shape(rng, n):
    """n rows of 784 integer pixels in [0, 255], about 19% nonzero (as in
    MNIST)."""
    vals = rng.integers(1, 256, (n, 784)).astype(np.float32)
    return np.where(rng.random((n, 784)) < 0.19, vals, np.float32(0.0))


def ref_svm64(X, y, iterations, step, lam):
    """The reference's Pegasos loop in numpy float64."""
    X, y = X.astype(np.float64), y.astype(np.float64)
    n, d = X.shape
    w, b = np.zeros(d), 0.0
    for i in range(iterations):
        active_y = ((y * (X @ w + b)) < 1.0) * y
        eta = step / (lam * (i + 1.0))
        w = w - eta * (lam * w - X.T @ active_y / n)
        b = b + eta * active_y.mean()
    return w, b


def ref_mlr64(X, y, iterations, step):
    """The reference's standardized gradient descent in numpy float64."""
    X, y = X.astype(np.float64), y.astype(np.float64)
    n = X.shape[0]
    mu, sigma = X.mean(0), np.maximum(X.std(0), 1e-8)
    Xs, yc = (X - mu) / sigma, y - y.mean()
    w, b = np.zeros(X.shape[1]), 0.0
    for i in range(iterations):
        err = Xs @ w + b - yc
        eta = step / np.sqrt(i + 1.0)
        w, b = w - eta * (Xs.T @ err / n), b - eta * err.mean()
    w_orig = w / sigma
    return w_orig, b + y.mean() - mu @ w_orig


def ml_kernel_entries(dev, hbm, entries, detail, shrink=1):
    """gram_accumulate on both sides of ML-20M-shaped ratings (f = 10):
    the user side (138,493 rows of about 144 ratings) and the item side
    (26,744 rows with a Zipf tail, the heaviest about 250k ratings), and
    knn_topk on MNIST-shaped data (60,000 x 784, 10,000 queries, k = 3),
    each against its plain version."""
    import torch
    from flink_tpu_torch import kernels as K
    from flink_tpu_torch.kernels.gram_accumulate import rating_csr
    from flink_tpu_torch.kernels.knn_topk import squared_distances
    rng = np.random.default_rng(31)
    u, i, r = movielens_shape(rng, 20_000_263 // shrink, 138_493 // shrink,
                              26_744 // shrink)
    n_users, n_items, f = int(u.max()) + 1, int(i.max()) + 1, 10
    vals_all = torch.from_numpy(r).to(dev)

    def side(name, row_ids, col_ids, n_rows, fixed):
        """One half-step's Gram sums against the plain version: a sum of
        t float32 terms in another order is within 2 t eps sum|terms|."""
        indptr, cols, vals = rating_csr(torch.from_numpy(row_ids).to(dev),
                                        torch.from_numpy(col_ids).to(dev), vals_all, n_rows)
        g, b = K.gram_accumulate(fixed, indptr, cols, vals)
        gw, bw = K.gram_accumulate_plain(fixed, indptr, cols, vals)
        gm, bm = K.gram_accumulate_plain(fixed.abs(), indptr, cols, vals.abs())
        terms = (indptr[1:] - indptr[:-1]).double()
        err = max(float((g - gw).abs().max()), float((b - bw).abs().max()))
        check(bool(((g.double() - gw.double()).abs() <= 2 * terms[:, None, None] * EPS32
                    * gm.double()).all()) and
              bool(((b.double() - bw.double()).abs() <= 2 * terms[:, None] * EPS32
                    * bm.double()).all()),
              f"gram_accumulate ({name} side) within 2 t eps sum|terms| of plain")
        del g, b, bw, gm, bm
        nnz = len(cols)
        b_, by = bound(nnz * (8 + 4 * f) + n_rows * (f * f + f) * 4 + 8 * (n_rows + 1),
                       2 * nnz * f * (f + 1), hbm)
        res = dict(ms=cuda_ms(lambda: K.gram_accumulate(fixed, indptr, cols, vals)),
                   plain_ms=cuda_ms(lambda: K.gram_accumulate_plain(
                       fixed, indptr, cols, vals), 3),
                   bound_ms=b_, bound_by=by, max_abs_err=err)
        info = {"kernel": "gram_accumulate", "side": name, "rows": n_rows,
                "ratings": nnz, "max_row_ratings": int(terms.max()), "factors": f}
        return res, info, (indptr, cols, gw)

    # the user side, from item-shaped factors, with the library call
    V = torch.from_numpy(rng.normal(0, 0.1, (n_items, f)).astype(np.float32)).to(dev)
    res, info, (indptr, cols, gw) = side("users", u, i, n_users, V)
    rows_sorted = torch.repeat_interleave(torch.arange(n_users, device=dev),
                                          indptr[1:] - indptr[:-1])
    vc = V.index_select(0, cols)
    outer = vc[:, :, None] * vc[:, None, :]               # [nnz, f, f], 8 GB
    lib = cuda_ms(lambda: gw.index_add_(0, rows_sorted, outer), 3)
    entries["gram_accumulate"] = dict(res, library_ms=lib)
    detail.append(dict(info, library="index_add_ of the materialized "
                       "[nnz, f, f] outer products (G only)"))
    del gw, vc, outer, rows_sorted, indptr, cols
    torch.cuda.empty_cache()
    # the item side, from user-shaped factors drawn from a seed of their
    # own (the KNN data below stays as it was)
    U = torch.from_numpy(np.random.default_rng(32).normal(0, 0.1, (n_users, f))
                         .astype(np.float32)).to(dev)
    res, info, _ = side("items", i, u, n_items, U)
    detail.append(dict(info, **res))
    del U, V, vals_all, _
    torch.cuda.empty_cache()

    X = torch.from_numpy(mnist_shape(rng, 60_000 // shrink)).to(dev)
    Q = torch.from_numpy(mnist_shape(rng, 10_000 // shrink)).to(dev)
    k = 3
    qx = torch.matmul(Q, X.t())
    qn, xn = (Q * Q).sum(1), (X * X).sum(1)
    got = K.knn_topk(qx, qn, xn, k)
    want = K.knn_topk_plain(qx, qn, xn, k)
    check(torch.equal(got, want), "knn_topk bit-equal to plain (stable sort)")
    ms = cuda_ms(lambda: K.knn_topk(qx, qn, xn, k))
    plain = cuda_ms(lambda: K.knn_topk_plain(qx, qn, xn, k), 3)
    d2 = squared_distances(qx, qn, xn)
    lib = cuda_ms(lambda: torch.topk(d2, k, largest=False))
    gemm = cuda_ms(lambda: torch.matmul(Q, X.t()), 5)
    m, n = qx.shape
    b_, by = bound(4 * m * n + 4 * (m + n) + 4 * m * k, 3 * m * n, hbm)
    entries["knn_topk"] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_,
                               bound_by=by, max_abs_err=float((got - want).abs().max()))
    detail.append({"kernel": "knn_topk", "queries": m, "points": n, "k": k,
                   "library": "torch.topk of d2", "gemm_ms": gemm,
                   "gemm_bound_ms": bound(0, 2 * m * n * 784, hbm)[0]})
    del X, Q, qx, qn, xn, got, want, d2
    torch.cuda.empty_cache()


def ml_phase(dev, shrink=1, n_sample_rows=4096, n_sample_queries=1024):
    """The ML library at public datasets' shapes, on synthetic data from a
    seed: ALS at MovieLens-20M's (f = 10, lambda = 0.1, 10 iterations),
    KNN at MNIST's (60,000 x 784, 10,000 queries, k = 3), SVM at
    covtype-binary's (581,012 x 54, 300 iterations) and
    MultipleLinearRegression at YearPredictionMSD's training shape
    (463,715 x 90, 200 iterations).  Checked against numpy float64 (the
    loops in worker processes beside the card's work).  ``shrink`` divides
    every row count (a rehearsal off the card)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch
    from flink_tpu_torch import ml as tm
    from flink_tpu_torch.ml import classification as tcls
    from flink_tpu_torch.ml import recommendation as trec
    rng = np.random.default_rng(41)
    # covtype-binary: 10 continuous features and 44 binary ones
    nc, nm = 581_012 // shrink, 463_715 // shrink
    n_users, n_items = 138_493 // shrink, 26_744 // shrink
    Xc = np.concatenate([rng.normal(0, 1, (nc, 10)),
                         rng.random((nc, 44)) < 0.1], 1).astype(np.float32)
    yc = np.where(Xc @ rng.normal(size=54) + rng.normal(0, 0.5, nc) > 0, 1.0, -1.0)
    # YearPredictionMSD: 90 timbre features of mixed scales, a year target
    Xm = (rng.normal(0, 1, (nm, 90)) * rng.uniform(1, 50, 90)).astype(np.float32)
    ym = (Xm @ rng.normal(0, 0.01, 90) + 1998.0 + rng.normal(0, 5, nm)).astype(np.float32)
    out, runs, marks = {}, {}, {}

    def run(name, fn, kernel=None):
        """Run fn; count the calls of ``kernel`` it made."""
        before = len(marks.get(kernel, ()))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        runs[name] = {"s": time.perf_counter() - t0}
        if kernel is not None:
            runs[name]["calls"] = len(marks.get(kernel, ())) - before
        return res

    restore = [_kernel_clock(trec, ("gram_accumulate",), marks),
               _kernel_clock(tcls, ("knn_topk",), marks)]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(2, mp_context=ctx) as pool:
        svm_ref = pool.submit(ref_svm64, Xc, yc, 300, 0.5, 0.01)
        mlr_ref = pool.submit(ref_mlr64, Xm, ym, 200, 0.1)
        # ALS at MovieLens-20M's shape
        t0 = time.perf_counter()
        u, i, r = movielens_shape(rng, 20_000_263 // shrink, n_users, n_items)
        ratings = list(zip(u.tolist(), i.tolist(), r.tolist()))
        out["als_setup_s"] = time.perf_counter() - t0
        fixed = []              # the other side's factors of each half-step
        undo = _recording(trec, "gram_accumulate", lambda a, _: fixed.append(a[0]))
        als = run("als", lambda: tm.ALS(10, 0.1, 10, seed=0, device=dev).fit(ratings),
                  "gram_accumulate")
        undo()
        fixed = [t.cpu().numpy() for t in fixed[-2:]]
        del ratings
        check(runs["als"]["calls"] == 20, "als: gram_accumulate twice a sweep")
        check(np.isfinite(als.user_factors).all() and np.isfinite(als.item_factors).all()
              and als.user_factors.shape == (n_users, 10)
              and als.item_factors.shape == (n_items, 10), "als: factors finite, shaped")
        # the last sweep: users from the sweep before's items, then items
        # from these users
        check(np.array_equal(fixed[-1], als.user_factors),
              "als: the last half-step solved the items from the fitted users")
        out["als"] = {"users": _als_check(als, fixed[-2], als.user_factors, u, i, r,
                                          n_sample_rows, []),
                      "items": _als_check(als, als.user_factors, als.item_factors,
                                          i, u, r, n_sample_rows,
                                          [int(np.bincount(i).argmax())])}
        del fixed
        # KNN at MNIST's shape
        X, Q = mnist_shape(rng, 60_000 // shrink), mnist_shape(rng, 10_000 // shrink)
        knn = tm.KNN(k=3, device=dev).fit(X)
        idx = run("knn", lambda: knn.kneighbors(Q), "knn_topk")
        out["knn"] = _knn_check(X, Q, idx, 3, rng, n_sample_queries)
        # SVM and regression
        svm = run("svm", lambda: tm.SVM(300, 0.5, 0.01, device=dev).fit(Xc, yc))
        mlr = run("regression", lambda: tm.MultipleLinearRegression(
            200, 0.1, device=dev).fit(Xm, ym))
        t_wait = time.perf_counter()
        w64, b64 = svm_ref.result()
        mw64, mb64 = mlr_ref.result()
        out["reference_wait_s"] = time.perf_counter() - t_wait
    for r in restore:
        r()
    out["kernel_device_s"] = _device_seconds(marks)
    svm_rel = float(np.linalg.norm(svm.weights - w64) / np.linalg.norm(w64))
    agree = float((np.sign(Xc @ svm.weights + svm.intercept)
                   == np.sign(Xc @ w64 + b64)).mean())
    # float32 rounding (~1e-6 relative), and points whose margin lies
    # within that of 1 may switch the hinge on or off: each such switch
    # moves the weights by about 1 / n relative
    svm_tol = 1e-4 + 1.0 / len(Xc)
    check(svm_rel <= svm_tol and agree >= 0.999,
          f"svm: weights within {svm_tol:.3g} relative of the float64 loop, "
          "99.9% same sign")
    mlr_rel = float(np.linalg.norm((mlr.weights - mw64) * Xm.std(0))
                    / np.linalg.norm(mw64 * Xm.std(0)))
    pred_rel = float(np.abs(mlr.predict(Xm) - (Xm @ mw64 + mb64)).max()
                     / np.abs(ym).max())
    check(mlr_rel <= 1e-4 and pred_rel <= 1e-5,
          "regression: within 1e-4 (weights) and 1e-5 (predictions) of float64")
    out["svm"] = {"rows": len(Xc), "features": 54, "weights_rel_err": svm_rel,
                  "sign_agreement": agree}
    out["regression"] = {"rows": len(Xm), "features": 90, "weights_rel_err": mlr_rel,
                         "prediction_rel_err": pred_rel}
    out["runs"] = runs
    emit({"ml": out})


def _als_check(als, fixed, solved, rows, cols, r, n_sample, must):
    """The path's own last half-step on one side, from the factors it was
    given, against numpy float64 on sampled rows (and the rows in
    ``must``): the Gram sums of t float32 terms are within t eps
    sum|terms| of exact, and a solve moves by cond(A) times the relative
    change of A and b, plus f eps cond for the solver."""
    n_rows = len(solved)
    order = np.argsort(rows, kind="stable")
    starts = np.searchsorted(rows[order], np.arange(n_rows + 1))
    F64, f, lam = fixed.astype(np.float64), als.num_factors, als.lambda_
    sample = np.random.default_rng(42).choice(n_rows, n_sample, replace=False)
    errs, bounds = [], []
    for e in np.unique(np.concatenate([sample, must]).astype(np.int64)):
        sel = order[starts[e]:starts[e + 1]]
        vc, rr = F64[cols[sel]], r[sel].astype(np.float64)
        A, b = vc.T @ vc + lam * np.eye(f), vc.T @ rr
        t = len(sel)
        rel = (t * EPS32 * np.linalg.norm(np.abs(vc).T @ np.abs(vc)) / np.linalg.norm(A)
               + t * EPS32 * np.linalg.norm(np.abs(vc).T @ np.abs(rr)) / np.linalg.norm(b)
               + f * EPS32)
        x = np.linalg.solve(A, b)
        errs.append(np.abs(solved[e] - x).max())
        bounds.append(2 * np.linalg.cond(A) * rel * np.linalg.norm(x)
                      + 4 * EPS32 * np.abs(x).max())
    check(bool(np.all(np.array(errs) <= np.array(bounds))),
          f"als: {len(errs)} sampled rows of {n_rows} within their float32 bounds")
    return {"rows": n_rows, "ratings": len(rows), "sampled_rows": len(errs),
            "most_ratings": int((starts[1:] - starts[:-1]).max()),
            "max_abs_err": float(max(errs)), "min_bound": float(min(bounds))}


def _knn_check(X, Q, idx, k, rng, n_sample):
    """Sampled queries against float64 brute force, where the gap between
    the k-th and (k+1)-th distances exceeds twice the float32 error of a
    distance, (d + 3) eps (|q|^2 + |x|^2 + 2 sum|q x|) <= 2 (d + 3) eps
    (|q|^2 + |x|^2)."""
    d = X.shape[1]
    X64 = X.astype(np.float64)
    xn = (X64 * X64).sum(1)
    ok = same = 0
    sample = rng.choice(len(Q), n_sample, replace=False)
    for block in np.array_split(sample, max(1, n_sample // 256)):
        q64 = Q[block].astype(np.float64)
        qn = (q64 * q64).sum(1)
        d2 = (qn[:, None] + xn[None, :]) - 2.0 * (q64 @ X64.T)
        for row, q in enumerate(block):
            part = np.argsort(d2[row], kind="stable")[:k + 1]
            err = 2 * (d + 3) * EPS32 * (qn[row] + xn[part].max())
            if d2[row, part[k]] - d2[row, part[k - 1]] > 2 * err:
                ok += 1
                same += set(idx[q].tolist()) == set(part[:k].tolist())
    check(same == ok >= n_sample // 2, f"knn: {same} of the {ok} separable sampled "
          f"queries (of {n_sample}) equal float64 brute force")
    return {"queries": len(Q), "points": len(X), "k": k, "sampled": n_sample,
            "separable": ok}


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
    "countmin_update": ("flink_tpu_torch/kernels/csrc/countmin_update.cu",
                        "flink_tpu/ops/sketches.py:141"),
    "countmin_query": ("flink_tpu_torch/kernels/csrc/countmin_query.cu",
                       "flink_tpu/ops/sketches.py:155"),
    "quantile_update": ("flink_tpu_torch/kernels/csrc/quantile_update.cu",
                        "flink_tpu/ops/sketches.py:197"),
    "quantile_result": ("flink_tpu_torch/kernels/csrc/quantile_result.cu",
                        "flink_tpu/ops/sketches.py:212"),
    "hll_log_finish": ("flink_tpu_torch/kernels/csrc/hll_log_finish.cu",
                       "flink_tpu/streaming/log_windows.py:244"),
    "table_insert": ("flink_tpu_torch/kernels/csrc/table_insert.cu",
                     "flink_tpu/ops/device_table.py:65"),
    "chain_route": ("flink_tpu_torch/kernels/csrc/chain_route.cu",
                    "flink_tpu/streaming/chain_fusion.py:716"),
    "gather_segment_sum": ("flink_tpu_torch/kernels/csrc/gather_segment_sum.cu",
                           "flink_tpu/graph/library.py:40"),
    "edge_popcount": ("flink_tpu_torch/kernels/csrc/edge_popcount.cu",
                      "flink_tpu/graph/library.py:398"),
    "gram_accumulate": ("flink_tpu_torch/kernels/csrc/gram_accumulate.cu",
                        "flink_tpu/ml/recommendation.py:52"),
    "knn_topk": ("flink_tpu_torch/kernels/csrc/knn_topk.cu",
                 "flink_tpu/ml/classification.py:96"),
    "shard_pack": ("flink_tpu_torch/kernels/csrc/shard_pack.cu",
                   "flink_tpu/parallel/mesh_agg.py:57"),
}

#: main-path runs, each with the kernels it must launch
PATHS = (("engine", "engine_phase", ("hll_update", "hll_estimate", "clear_rows")),
         ("jobs", "job_phase", ("hll_update", "hll_estimate", "scatter_combine",
                                "clear_rows", "merge_rows", "quantile_update",
                                "quantile_result", "countmin_update")),
         ("keyed", "keyed_phase", ("hll_update", "hll_estimate", "clear_rows",
                                   "set_rows")),
         ("sessions", "session_phase", ("hll_update", "hll_estimate",
                                        "scatter_combine", "clear_rows",
                                        "merge_rows", "set_rows")),
         ("sliding", "sliding_phase", ("quantile_update", "quantile_result",
                                       "merge_rows", "clear_rows")),
         ("session_cm", "session_cm_phase", ("countmin_update", "merge_rows",
                                             "clear_rows")),
         ("heavy_hitters", "heavy_hitter_phase", ("countmin_update",
                                                  "countmin_query", "clear_rows")),
         ("log_tier", "log_tier_phase", ("hll_log_finish",)),
         ("device_windows", "device_windows_phase", ("table_insert", "hll_update",
                                                     "hll_estimate", "clear_rows")),
         ("chain", "chain_phase", ("chain_route", "hll_update", "hll_estimate",
                                   "clear_rows", "hll_log_finish")),
         ("graph", "graph_phase", ("gather_segment_sum", "scatter_combine",
                                   "edge_popcount")),
         ("ml", "ml_phase", ("gram_accumulate", "knn_topk")),
         ("mesh", "mesh_phase", ("shard_pack", "table_insert", "hll_update",
                                 "hll_estimate", "clear_rows", "merge_rows",
                                 "quantile_update", "quantile_result",
                                 "chain_route")))


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
    # the host runtime's g++ runs beside the kernels' nvcc processes
    from flink_tpu_torch import native
    host_build = {}

    def build_host():
        t0 = time.perf_counter()
        native.lib()
        host_build["seconds"] = time.perf_counter() - t0

    compile_thread = threading.Thread(target=build_host)
    compile_thread.start()
    kernel_s = K.build_all()
    compile_thread.join()
    check("seconds" in host_build, "the host runtime built")
    emit({"build": {"seconds": kernel_s,
                    "host_runtime_seconds": host_build["seconds"]}})

    t_kernels = time.perf_counter()
    entries = kernel_phase(dev, hbm)
    per_path, seconds = {}, {"kernels": time.perf_counter() - t_kernels}
    for path, phase, needs in PATHS:
        t0 = time.perf_counter()
        K.reset_launch_counts()             # each main-path run starts here
        globals()[phase](dev)
        per_path[path] = dict(K.LAUNCHES)
        seconds[path] = time.perf_counter() - t0
        for kname in needs:
            check(per_path[path][kname] > 0, f"{kname} launched on the {path} path")
    emit({"launches": per_path})
    emit({"seconds": seconds})
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
