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
                regional), compared as key -> slot maps; the scattered
                kernels (``hll_update``, ``countmin_update``,
                ``table_insert``) also get a sector floor, 32 bytes for
                each distinct 32-byte sector they touch each way;
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
                (8.6 GB; its plan's scan, fill and glue and its pair
                pass timed apart, the pair pass's global form forced
                and checked, the plan's list statistics and a sector
                floor) and on 64 rows of 65,536 words (the global form);
                ``merge_rows`` also as the session Count-Min
                ``merge_slots`` (table and total, one launch);
                ``gram_accumulate`` on MovieLens-20M-shaped ratings
                (both sides on their plans, each plan's build timed; two
                calls and the wrapper's own plan bit-equal; f = 64 on a
                2M-rating user side), ``knn_topk`` on MNIST-shaped
                products; ``quantile_result`` also from an odd row, with
                Q = 16 and at the default geometry (2,075 buckets);
4. ``engine``   the scatter-tier window engine at BASELINE config #2
                (slots from the C++ NativeSlotIndex): a 1M-key space,
                2^23 events in one 1 s window, HLL precision 12, 1.25M
                slots (5.12 GB of registers on the card), checked
                against an independent numpy HLL on 4,096 keys;
5. ``job``      eight jobs through ``StreamExecutionEnvironment`` (the
                merges they make counted by aggregate and pairs a call,
                ``job_merges``): HLL
                unique visitors (2^19 events, 1M keys, tumbling 1 s, on
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
                #2 through the test harness: 1M keys, 2^20 events in one
                1 s window, HLL p = 12 (2^20 slots, 4.29 GB of
                registers), a snapshot and restore mid-stream, one
                batched fire, checked against numpy HLL on 4,096 keys;
7. ``sessions`` session windows with HLL and Sum on the GPU backend
                capped below the live session count (spill to host RAM
                and promotion), checked against the heap backend;
8. ``sliding``  BASELINE config #3: VectorizedSlidingWindows, 10 s / 1 s,
                p50/p99 quantile sketch (B = 210), a 10M-key space,
                2^21 events over 10 s with a watermark per 2^19 chunk
                (>= 3 GB of sketch state), checked against numpy on
                4,096 sampled (key, pane) histograms and (key, window)
                results;
9. ``session_cm`` BASELINE config #4: VectorizedSessionWindows, gap 1 s,
                Count-Min 4 x 2048, 100k keys, 2^20 events over 30 s;
                every session total exact and sampled tables bit-equal
                against numpy;
10. ``heavy_hitters`` WindowedHeavyHitters(1 s, phi 0.01), 100k keys, a
                skewed item mix, 2^20 events over 4 s: no false
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
                per-channel batches bit-equal; the same events' fused
                pass under ``torch.profiler`` in a fresh worker process
                (the H2D / kernel / D2H split and the idle share), its
                DtoH bytes equal to the transfer ledger's; window mode into
                WindowOperator on the GPU backend (2^18 events, 100k
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
15. ``ml``     ALS at MovieLens-20M's shape (20M ratings, f = 10, 3
                sweeps: cut from 10 to 5 and to 3 to make room for later
                paths), KNN at MNIST's (60,000 x 784, 10,000 queries,
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
                ``env.set_mesh``: integer keys (2^18 events, the mesh
                log tier) and composite keys (2^17, the sharded scatter
                tier), each equal to the job without a mesh; (e) the
                chain's map -> filter -> 4-channel route (2^21 events)
                with ``devices()`` widened to 8: 40 composite classes,
                bit-equal to the single-device program and the
                per-operator path; (f) a Count on MeshTumblingWindows
                over 2^21 config #2 events, snapshot after half of them
                (mid-window) and restored into a fresh engine, firing
                what the uninterrupted run fires;
17. ``window_api`` the window API through ``StreamExecutionEnvironment``:
                (1) a Python aggregate (mean, count, max) on the generic
                tier at config #2's key space (2^18 events, 1M keys,
                tumbling 1 s), lifted, exact against a numpy fold in
                arrival order (mean within 1e-12), and on a 2^16-event
                prefix equal to WindowOperator
                (``disable_device_operator``); (2) an aggregate that
                branches on values (the scalar fold) on sliding 3 s /
                1 s and session (500 ms) windows, 2^16 events, equal to
                WindowOperator; (3) ``reduce`` / ``fold`` / ``apply`` /
                ``process`` / ``sum`` / ``min`` / ``max`` on 2^15
                events; (4) ``count_window`` with and without a slide,
                ``PurgingTrigger(CountTrigger)``, ``DeltaTrigger``,
                ``TimeEvictor``, dynamic sessions, ``window_all``,
                ``count_window_all`` on 2^14 events, each exact against
                numpy; (5) HLL p = 12 under
                ``ContinuousEventTimeTrigger.of(250)`` on the GPU
                backend (2^15 events, 10,000 keys) against the heap
                backend on 500 sampled keys, and a ``count_window``
                device Sum on the GPU backend (events of (1) and (5)
                halved to make room for later paths);
18. ``recovery`` checkpoints, restarts, savepoints and processing time
                through ``StreamExecutionEnvironment`` with
                ``FsCheckpointStorage`` in a temporary directory: (1) HLL
                p = 12 at config #2's key space (2^17 events over 1M
                users, tumbling 1 s over 2 s of timestamps) on the
                device window operator's scatter tier (integer pair
                keys), failing once after a checkpoint taken at half the
                input and restarting under ``fixed_delay``: one restart,
                the source resumed at the checkpointed offset, the output
                equal to the uninterrupted run's exactly, the snapshot's
                bytes and seconds, the write's and the restore's
                seconds; (2) ``"u%d"`` string keys (2^17 events,
                interned onto the log tier, device finish); (3) HLL with
                allowed lateness 1 s on the GPU keyed backend (2^15
                events, 100k keys; the restore uploads through
                ``set_rows``); (4) ``execute_async`` on (1)'s job,
                ``stop_with_savepoint`` at the half, restored into a
                fresh environment, the joined output equal to (1)'s
                uninterrupted run; (5) processing time on the GPU
                backend: four tumbling windows through the test
                harness's clock (2^15 events, 100k keys) against numpy
                HLL, a ``processing`` job flushed at the end of input
                and processing-time sessions, both against the heap
                backend;
19. ``telemetry`` the observability plane (tracer, device telemetry,
                CUDA launch ledger): (a) 2^17 config #2 events (HLL
                p = 12, tumbling 1 s, (key, key >> 10) pair keys on the
                scatter tier) through the environment with the plane
                off, then on: windows bit-equal, the off run leaves
                every store empty, the events/s of both; (b) 2^17
                integer-key events on the log tier with the device
                finish; (c) the fused chain's route mode on 2^21 events,
                and the same pass under ``torch.profiler`` in a fresh
                worker process (late in a long process the profiler
                lost memcpy records): the ledger's
                ``d2h.chain.boundary`` bytes equal the profiler's DtoH
                bytes, its D2H ms and the idle share beside them.  On
                each on run the ledger's launches per kernel equal the
                ``LAUNCHES`` delta (device ms > 0 and within the leg's
                wall time), the Chrome trace written to a temporary
                directory parses and holds the kernels' device-lane
                events, the device window spans and the transfers;
                (a) also reads the HBM from ``memory_stats`` (at least
                the framework's own bytes) and the window operator's
                ``numRecordsIn`` (the events fed) and
                ``numLateRecordsDropped`` (0);
20. ``sql``   the Table API and SQL: (a) BASELINE config #5 (``SELECT k,
                APPROX_COUNT_DISTINCT(u) AS d FROM ev GROUP BY TUMBLE(ts,
                INTERVAL '1' SECOND), k``) at the reference's size (2^22
                events, 500,000 keys, one second, ``from_columns`` in
                chunks of 2^19) on the columnar plan, its engine the log
                tier with the device finish; every estimate within 4 HLL
                standard errors (+ 3) of the exact distinct count, 4,096
                sampled keys equal to numpy HLL and to the DataStream
                job ``key_by().window(1 s).aggregate(HLL 12)`` on their
                events, the events/s of the timed ``env.execute``; (b)
                SESSION (gap 1 s) with APPROX_COUNT_DISTINCT on the
                columnar plan (``VectorizedSessionWindows``), config
                #4's 100,000 keys, 2^19 events over 30 s: the sessions
                equal numpy's exactly, the estimates within the HLL
                bound and, on 4,096 sessions, equal to numpy HLL; (c)
                config #5 on 2^20 events with ``env.set_mesh`` on 8
                virtual shards (the mesh log tier) and (d) at
                parallelism 2 (the split exchange and
                ``partition_custom``), each equal to the meshless run;
                (e) the columnar interval join at ``bench_sql_join``'s
                size (2^21 rows a side, 100,000 keys, +-500 ms over
                60 s): the pair count and 1,024 sampled left rows' pairs
                equal a numpy sort-and-searchsorted join; (f) a keyed
                process function on the GPU backend (2^16 events over
                4 s, 10,000 keys) keeping an AggregatingState of HLL 12
                and emitting it at an event-time timer each second,
                equal to the heap backend's on 500 sampled keys (through
                a filter after the timestamps);
21. ``sources`` sources with their guarantees: (a) BASELINE config #1
                as the example writes it and users run it: a feeder
                thread listens on 127.0.0.1 and writes 2^18 words of a
                seeded uniform 50,000-word vocabulary in lines of 16;
                ``socket_text_stream`` on its own thread -> ``flat_map``
                -> ``key_by(word)`` -> processing-time ``time_window(5
                s)`` on the system clock -> ``aggregate(SumAggregate)``
                on the GPU backend, checkpoints every 1 s; the feeder
                keeps the socket open, quiet, until every word was
                counted (a wall clock is not drained at the end of
                input), then closes it and the source ends; per word the
                sum over every fired window equals numpy's count
                exactly; the example's ``reduce`` form on the heap
                backend over 2^16 words likewise; (b) a blocking source
                (``run()`` only) of 2^17 config #2 events (1M keys, 4 s)
                in RecordBatches, keeping its offset in operator list
                state through ``initialize_state``, 1 s HLL p = 12 on
                WindowOperator over the GPU backend into a
                ``TransactionalCollectSink`` that fails once after a
                checkpoint taken at half the input completed:
                the committed rows equal the uninterrupted run's bit for
                bit, none twice, the source restored its offset; (c) an
                ``InMemoryPartitionedLog`` of 4 partitions holding 2^17
                config #2 events, ``ReplayableLogSource`` at
                parallelism 4 -> 1 s HLL p = 12 on the device window
                operator's log tier (device finish) -> a
                ``TransactionalLogSink``, failing once after a checkpoint
                past half the input: the committed output equals the
                uninterrupted run's, and the source committed offsets
                only on checkpoint completion and at the end of input
                (events cut to fit the path into ~60 s and again to
                make room for later paths; key spaces and p kept);
22. ``datastream_api`` the rest of the DataStream API and typed state
                through ``StreamExecutionEnvironment`` on the GPU
                backend: (a) the broadcast state pattern: 2^18 config #2
                events (1M users, 64 categories) keyed by user and
                connected to 1,024 rule updates (category -> admitted)
                that arrive first, a ``KeyedBroadcastProcessFunction``
                at parallelism 4 adding each admitted event's item into
                an HLL p = 12 per user and updating the user's profile
                (a ``ValueState`` of a v1 ``RecordSchema`` record): every
                instance's broadcast state equals the rule map, the
                users holding state equal numpy's admitted users, 4,096
                sampled users within the HLL tolerance of numpy HLL; (e)
                that job's savepoint restored under the v2 schema (a
                field added with a default): every user's HLL rows bit
                for bit (``set_rows``), every profile migrated; (b)
                ``as_queryable_state`` of HLL 12 fed by a thread-hosted
                source, 4,096 sampled users queried from a client
                thread while the loop ingests and then while it idles
                (queries/s, p50 / p99 of each window), each answer one
                gathered ``hll_estimate``, the answers after
                the cancel bit-equal to ``get_batch`` and within the HLL
                tolerance of numpy; (c) ``connect(...).key_by(ad, ad)``
                of 2^16 impressions and 2^13 clicks over 100,000 ads
                into a keyed co-process function with two device Count
                states and a timer per ad at the window end: every ad's
                counts equal numpy exactly; (d) ``ordered_wait`` and
                ``unordered_wait`` of a 1 ms lookup over 2^14 events,
                capacity 100, into a tumbling HLL window: the ordered
                output in input order, the unordered one complete, the
                windows equal and within the HLL tolerance of numpy, the
                rate against the serial one; a checkpoint with requests
                in flight, then a failure: every window's count exact;
                (f) a Collatz loop (``iterate`` / ``close_with``) over
                2^12 seeds split by parity (``split`` / ``select``) into
                Sum windows, equal to numpy (events cut to fit the path
                into ~60 s; key spaces kept);
23. ``analysis`` the pre-flight analysis: (a) config #2 (HLL p = 12,
                2^20 events over 1M users in one 1 s window, pair keys
                so the scatter tier takes them) from a bounded
                ``from_collection`` under ``lint.types.mode`` warn and
                off: pre-sized to 2^20 slots with no grow under warn,
                grow-doubling from 2^14 under off, estimates bit-equal
                and within the HLL tolerance of numpy, the lint and
                typeflow gauges, events/s, peak device bytes and the
                pre-flight's seconds of each; (b) the chain job's shape
                (2^18 rows, map -> filter -> map -> key_by to 4 HLL
                window subtasks, fused) under warn and off: 3 kernels
                proven, equal results, ``chain_route`` launched; (c) a
                ``lint.mode`` strict job refused before any launch or
                allocation;
24. the launch counts of phases 4-23, each path counted on its own:
   every kernel the path runs must have launched there; the seconds
   of every path and, summed per path, of its jobs' pre-flight.

Output: one JSON object per phase, then the ``kernels`` line of the
contract, then the card's name and power limit as nvidia-smi prints
them, then the last line ``{"ok": true, "device": {...}}``.  Without a
CUDA device, or without the rest of the repository beside this
script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import gc
import json
import multiprocessing
import os
import shutil
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


def kernel_device_ms(fn, reps: int = 10) -> dict:
    """Device ms per call of each kernel that fn launches, from a
    torch.profiler trace (CUDA activity) of reps calls after one warm-up:
    kernel name (up to its argument list) -> ms.  A trace slows the
    launches after it: take it after the timed runs."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0)
        if us:
            name = ev.key.split("(")[0]
            out[name] = out.get(name, 0.0) + us / 1e3 / reps
    return out


def allclose(got, want, rtol: float, atol: float = 0.0) -> bool:
    """``np.testing.assert_allclose``'s test as a boolean: equal shapes,
    |got - want| <= atol + rtol * |want| everywhere, NaN equal to NaN."""
    got, want = np.asarray(got), np.asarray(want)
    return got.shape == want.shape and bool(
        np.allclose(got, want, rtol=rtol, atol=atol, equal_nan=True))


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


def gram_bound(nnz: int, n_rows: int, n_cols: int, f: int, hbm: float):
    """gram_accumulate's bound: the bytes it must move (each rating's
    column and value, 8 B; the fixed table, indptr, G and b once: factor
    rows gathered again come from the L2) and f(f+1)/2 + f FMAs a rating
    (G is symmetric)."""
    return bound(8 * nnz + 4 * n_cols * f + 8 * (n_rows + 1)
                 + 4 * n_rows * (f * f + f), 2 * nnz * (f * (f + 1) // 2 + f), hbm)


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
    addr = slots_np.astype(np.int64) * m + reg_np
    words = np.unique(addr // 4).size
    sectors = np.unique(addr // 32).size
    zero = lambda t: (lambda: K.clear_rows(t, 0))          # noqa: E731
    update = lambda: K.hll_update(regs, slots, rank, reg, N)   # noqa: E731
    ms = cuda_ms(update, 10, zero(regs))
    # the same batch onto the registers it left: every row loses
    onto = cuda_ms(update, 10)
    plain = cuda_ms(lambda: K.hll_update_plain(ref, slots, rank, reg, N), 5,
                    zero(ref))
    check(torch.equal(regs, ref), "hll_update bit-equal after the batch onto itself")
    flat_idx = slots.to(torch.int64) * m + reg.to(torch.int64)
    lib_call = lambda: ref.view(-1).scatter_reduce_(0, flat_idx, rank, "amax")  # noqa: E731
    lib = cuda_ms(lib_call, 10, zero(ref))
    lib_onto = cuda_ms(lib_call, 10)            # onto the registers it left
    b, by = bound(7 * N + 8 * words, 3 * N, hbm)
    # the memory moves a random word as a 32-byte sector each way
    floor = bound(7 * N + 64 * sectors, 3 * N, hbm)[0]
    entries["hll_update"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                 bound_ms=b, bound_by=by, max_abs_err=update_err,
                                 sector_floor_ms=floor)
    detail.append({"kernel": "hll_update", "rows": N, "slots": C,
                   "distinct_words": int(words), "distinct_sectors": int(sectors),
                   "library": "scatter_reduce_ amax", "timer": SINGLE,
                   "sector_floor_ms": floor, "onto_itself_ms": onto,
                   "onto_itself_library_ms": lib_onto, "onto_itself_timer": RUN})
    # probe: the same rows with slots confined to 16,384 slots (64 MiB)
    confined = slots % (1 << 14)
    K.clear_rows(regs, 0)
    K.clear_rows(ref, 0)
    K.hll_update(regs, confined, rank, reg, N)
    K.hll_update_plain(ref, confined, rank, reg, N)
    check(torch.equal(regs, ref), "hll_update bit-equal with slots confined to 64 MiB")
    detail.append({"kernel": "hll_update", "probe": "slots confined to 16,384 slots "
                   "(64 MiB), after a clear", "rows": N, "timer": SINGLE,
                   "ms": cuda_ms(lambda: K.hll_update(regs, confined, rank, reg, N),
                                 10, zero(regs))})
    K.clear_rows(regs, 0)
    K.hll_update(regs, slots, rank, reg, N)
    del confined
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
    dense_ok = allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5)
    gslots = torch.from_numpy(rng.integers(0, C, 1 << 18).astype(np.int32)).to(dev)
    got_g = K.hll_estimate(regs, agg.alpha, slots=gslots)
    want_g = K.hll_estimate_plain(regs, agg.alpha, slots=gslots)
    check(dense_ok and allclose(got_g.cpu().numpy(), want_g.cpu().numpy(), rtol=1e-5),
          "hll_estimate within rtol 1e-5 (dense and gathered)")
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
    ref.copy_(regs)
    K.clear_rows(regs, 0, slots=gslots)
    K.clear_rows_plain(ref, 0, slots=gslots)
    check(torch.equal(regs, ref), "clear_rows list form equal")
    clear_err = max_abs_err(regs, ref)
    K.clear_rows(regs, 0)
    check(int(regs.max()) == 0, "clear_rows range form filled the arena")
    ms = cuda_ms(lambda: K.clear_rows(regs, 0))
    plain = cuda_ms(lambda: K.clear_rows_plain(regs, 0))
    lib = cuda_ms(lambda: regs.fill_(0))
    check(int(regs.max()) == 0, "clear_rows range form filled the arena (timed)")
    b, by = bound(C * m, 0, hbm)
    entries["clear_rows"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                 bound_ms=b, bound_by=by, max_abs_err=clear_err)
    gidx = gslots.to(torch.int64)
    lms = cuda_ms(lambda: K.clear_rows(regs, 0, slots=gslots))
    list_lib = cuda_ms(lambda: regs.index_fill_(0, gidx, 0))
    detail.append({"kernel": "clear_rows", "range_rows": C, "list_rows": 1 << 18,
                   "list_ms": lms, "list_library_ms": list_lib,
                   "list_bound_ms": bound((1 << 18) * (m + 4), 0, hbm)[0],
                   "library": "fill_", "list_library": "index_fill_"})
    # the sessions path's small list clears: 48 slots of a [1024, 4096]
    # uint8 and of a [1024] float32 component (Min's fill), as a run here
    # and as the kernel's device time after every other entry's timing
    small = torch.from_numpy(np.random.default_rng(13).choice(1024, 48, replace=False)
                             .astype(np.int32)).to(dev)
    fmax = float(np.finfo(np.float32).max)
    small_clears = []
    for comp, fill in ((torch.ones((1024, m), dtype=torch.uint8, device=dev), 0),
                       (torch.ones(1024, dtype=torch.float32, device=dev), fmax)):
        want = comp.clone()
        K.clear_rows_plain(want, fill, slots=small)
        K.clear_rows(comp, fill, slots=small)
        check(torch.equal(comp, want), f"clear_rows small list {comp.dtype} equal")
        call = (lambda c=comp, f=fill: K.clear_rows(c, f, slots=small))
        row = {"kernel": "clear_rows", "small_list": list(comp.shape),
               "dtype": str(comp.dtype), "slots": 48, "run_ms": cuda_ms(call, 20),
               "bound_ms": bound(48 * (comp[0].numel() * comp.element_size() + 4),
                                 0, hbm)[0]}
        detail.append(row)
        small_clears.append((row, call))
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
    for row, call in small_clears:     # a trace slows the launches after it
        row["device_ms"] = sum(kernel_device_ms(call).values())
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
            # a merge of a few pairs is host time: a long run steadies it
            ms = cuda_ms(lambda: K.merge_rows(got, dst, src, op, unique_dst=unique),
                         200 if k <= 16 else 10)
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
    countmin_merge_entry(dev, hbm, pairs, detail)

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


def countmin_merge_entry(dev, hbm, pairs, detail):
    """The session Count-Min merge through ``agg.merge_slots`` (4 x 2048
    int32 counters and the total, 4,096 slots), 2 and 16 pairs folded
    four to a target: one launch for both components, bit-equal to the
    plain merges, timed beside the two launches one component at a time
    that it replaces."""
    import torch
    from flink_tpu_torch import kernels as K
    from flink_tpu_torch.ops.sketches import CountMinSketchAggregate
    agg = CountMinSketchAggregate(4, 2048)
    c = 4096
    base = {"table": torch.randint(0, 1000, (c, 4, 2048), dtype=torch.int32, device=dev),
            "total": torch.randint(0, 1000, (c,), dtype=torch.int32, device=dev)}
    row_bytes = 4 * 4 * 2048 + 4
    for k in (2, 16):
        dst, src = pairs(c, k, repeat=True)
        got = {name: t.clone() for name, t in base.items()}
        want = {name: t.clone() for name, t in base.items()}
        before = K.LAUNCHES["merge_rows"]
        agg.merge_slots(got, dst, src)
        launches = K.LAUNCHES["merge_rows"] - before
        K.merge_rows_many_plain([want["table"], want["total"]], dst, src,
                                ["add", "add"])
        torch.cuda.synchronize()
        check(launches == 1 and all(torch.equal(got[n], want[n]) for n in got),
              f"Count-Min merge_slots of {k} pairs: one launch, bit-equal")
        ms = cuda_ms(lambda: agg.merge_slots(got, dst, src), 200)
        two = cuda_ms(lambda: (K.merge_rows(got["table"], dst, src, "add"),
                               K.merge_rows(got["total"], dst, src, "add")), 200)
        targets = int(torch.unique(dst).numel())
        detail.append({"kernel": "merge_rows", "case": "Count-Min merge_slots, "
                       "table and total in one launch", "rows": k,
                       "unique_dst": False, "launches": launches, "ms": ms,
                       "two_launches_ms": two,
                       "bound_ms": bound(k * (row_bytes + 8) + 2 * targets * row_bytes,
                                         0, hbm)[0]})
    del base, got, want
    torch.cuda.empty_cache()


def lanes_np(vh: np.ndarray):
    """uint64 hashes → (hi, lo) as int32 views of the 32-bit lanes."""
    return ((vh >> np.uint64(32)).astype(np.uint32).view(np.int32),
            (vh & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32))


#: countmin_query at the heavy_hitters phase's layout: 2^19 queries into
#: 100,000 live slots of a [2^18, 4, 2048] int32 table (8 GiB)
CM_PATH = (1 << 18, 100_000, 1 << 19)


def countmin_query_inputs(dev, rng, shape="entry", shift=0):
    """countmin_query's inputs at a main-path shape, (table, slots, hi,
    lo), the table filled by countmin_update.  ``entry``: 2^19 records
    (weights 1-3) into [2^14, 4, 2048] int32 (512 MiB), and 2^20
    queries, the records' own (slot, item) pairs and as many new ones.
    ``path`` (``CM_PATH``): the heavy_hitters phase's layout, 2^19
    records (60% from 8 heavy items, the rest from 10^5 tail items) into
    100,000 live slots of [2^18, 4, 2048] (8 GiB), queried at the
    records' pairs.  ``shift`` divides the counts by 2^shift (a rehearsal
    on the CPU)."""
    import torch
    from flink_tpu_torch import kernels as K

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    D, W = 4, 2048
    if shape == "entry":
        S, N, Q = 1 << (14 - shift), 1 << (19 - shift), 1 << (20 - shift)
        slots = rng.integers(0, S, Q).astype(np.int32)
        items = rng.integers(0, 2**63, Q, dtype=np.int64)
        weights = rng.integers(1, 4, N).astype(np.float32)
    else:
        S, live, N = (x >> shift for x in CM_PATH)
        Q = N
        slots = rng.choice(S, live, replace=False).astype(np.int32)[
            rng.integers(0, live, N)]
        items = np.where(rng.random(N) < 0.6, rng.integers(0, 8, N),
                         rng.integers(8, 8 + 100_000, N))
        weights = np.ones(N, np.float32)
    hi, lo = (t(a) for a in lanes_np(splitmix64_np(items)))
    qslots = t(slots)
    table = torch.zeros((S, D, W), dtype=torch.int32, device=dev)
    total = torch.zeros(S, dtype=torch.int32, device=dev)
    K.countmin_update(table, total, qslots, t(weights), hi, lo, N)
    return table, qslots, hi, lo


def countmin_query_entry(dev, hbm, rng, shape, shift=0):
    """countmin_query at a main-path shape (``countmin_query_inputs``)
    held bit-equal to its plain version: (its entry of the kernels'
    line, its detail), with the bound (4 B a distinct cell) and the
    sector floor (32 B a distinct sector)."""
    import torch
    from flink_tpu_torch import kernels as K
    from flink_tpu_torch.ops.hashing import countmin_rows
    table, qslots, qhi, qlo = countmin_query_inputs(dev, rng, shape, shift)
    Q, (S, D, W) = len(qslots), table.shape
    got = K.countmin_query(table, qslots, qhi, qlo)
    want = K.countmin_query_plain(table, qslots, qhi, qlo)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"countmin_query at the {shape} shape bit-equal")
    qs64 = qslots.to(torch.int64)
    r = torch.arange(D, device=dev)[:, None]
    qcols = countmin_rows(qhi, qlo, D, W).to(torch.int64)
    flat = ((qs64[None, :] * D + r) * W + qcols).reshape(-1)
    cells = int(torch.unique(flat).numel())
    sectors = int(torch.unique(flat // 8).numel())
    del flat
    ms = cuda_ms(lambda: K.countmin_query(table, qslots, qhi, qlo))
    plain = cuda_ms(lambda: K.countmin_query_plain(table, qslots, qhi, qlo))
    lib = cuda_ms(lambda: table[qs64[None, :].expand(D, -1), r, qcols].amin(0))
    b, by = bound(16 * Q + 4 * cells, 3 * D * Q, hbm)
    entry = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b, bound_by=by,
                 max_abs_err=max_abs_err(got, want),
                 sector_floor_ms=bound(16 * Q + 32 * sectors, 3 * D * Q, hbm)[0])
    detail = {"kernel": "countmin_query", "shape": shape, "queries": Q,
              "table": [S, D, W], "distinct_cells": cells,
              "distinct_sectors": sectors, **entry,
              "library": "advanced indexing + amin (columns precomputed)"}
    del table, got, want
    torch.cuda.empty_cache()
    return entry, detail


def sketch_kernel_entries(dev, hbm, rng, entries, detail, shift=0):
    """countmin_update, countmin_query (also at the heavy_hitters
    phase's layout), quantile_update and quantile_result at the main
    paths' shapes, each against its plain version on the card, with
    merge_rows at the sketch row widths
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
    # the memory moves a random word as a 32-byte sector each way
    sectors = int(torch.unique(flat // 8).numel()) + int(
        torch.unique(s64 // 8).numel())
    floor = bound(16 * N + 64 * sectors, 3 * D * N, hbm)[0]
    entries["countmin_update"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                      bound_ms=b, bound_by=by, max_abs_err=err,
                                      sector_floor_ms=floor)
    detail.append({"kernel": "countmin_update", "rows": N, "slots": S,
                   "depth": D, "width": W, "distinct_cells": cells,
                   "distinct_sectors": sectors, "sector_floor_ms": floor,
                   "library": "index_put_ accumulate (indices precomputed)"})

    # countmin_query at its entry and at the heavy_hitters layout
    for shape in ("entry", "path"):
        entry, info = countmin_query_entry(dev, hbm, rng, shape, shift)
        if shape == "entry":
            entries["countmin_query"] = entry
        detail.append(info)

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
    d64, s64_ = dst.to(torch.int64), src.to(torch.int64)
    detail.append({"kernel": "merge_rows", "case": "i32 add 32 KiB rows "
                   "(session Count-Min merge)", "rows": 4 * m, "unique_dst": False,
                   "ms": cuda_ms(lambda: K.merge_rows(table, dst, src, "add")),
                   "plain_ms": cuda_ms(lambda: K.merge_rows_plain(
                       rt, dst, src, "add"), 3),
                   "library_ms": cuda_ms(lambda: rt.index_add_(0, d64, rt[s64_])),
                   "library": "index_add_ of the gathered source rows",
                   "bound_ms": bound(4 * m * (row + 8) + 2 * m * row, 0, hbm)[0],
                   "max_abs_err": err})
    del table, total, rt, rtot, flat, w_rep
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
    # the sector floor: a 32-byte sector read and written per distinct
    # cell (each RED misses the L2), and the 8 B a record of input
    detail.append({"kernel": "quantile_update", "rows": N, "slots": C,
                   "buckets": B, "distinct_cells": hcells,
                   "sector_floor_ms": bound(8 * N + 64 * hcells, 0, hbm)[0],
                   "library": "bucketize + index_put_ accumulate"})

    # quantile_result: dense over 2^20 rows (a row slice), gathered over
    # 2^18 rows, Q = 2, on the histograms quantile_update left; the same
    # dense rows from an odd row (8-byte aligned), and with Q = 16
    qs, bv = agg._tables(dev)
    R, G = 1 << (20 - shift), 1 << (18 - shift)
    dense = hist[:R]
    odd = hist[1:R + 1]
    gslots = t(rng.integers(0, C, G).astype(np.int32))
    got_d, want_d = K.quantile_result(dense, qs, bv), K.quantile_result_plain(dense, qs, bv)
    got_g = K.quantile_result(hist, qs, bv, slots=gslots)
    want_g = K.quantile_result_plain(hist, qs, bv, slots=gslots)
    got_o, want_o = K.quantile_result(odd, qs, bv), K.quantile_result_plain(odd, qs, bv)
    q16 = t(np.float32(np.linspace(0.0, 1.0, 16)))
    got_16, want_16 = (K.quantile_result(dense, q16, bv),
                       K.quantile_result_plain(dense, q16, bv))
    torch.cuda.synchronize()
    check(torch.equal(got_d, want_d) and torch.equal(got_g, want_g)
          and torch.equal(got_o, want_o) and torch.equal(got_16, want_16),
          "quantile_result values bit-equal (dense, gathered, from an odd row, Q = 16)")
    err = max(max_abs_err(got_d, want_d), max_abs_err(got_g, want_g))
    g64 = gslots.to(torch.int64)

    def q_result_library(slots=None):
        h = dense if slots is None else hist[slots]
        cum = torch.cumsum(h.to(torch.float32), dim=-1)
        target = torch.clamp_min(qs[None, :] * cum[:, -1:], 1.0)
        idx = torch.searchsorted(cum, target)
        return bv[torch.where(idx >= B, 0, idx)]

    check(torch.equal(q_result_library(), got_d)
          and torch.equal(q_result_library(g64), got_g),
          "cumsum + searchsorted agrees with quantile_result (dense and gathered)")
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
                   "gathered_library_ms": cuda_ms(lambda: q_result_library(g64), 5),
                   "odd_row_ms": cuda_ms(lambda: K.quantile_result(odd, qs, bv)),
                   "q16_ms": cuda_ms(lambda: K.quantile_result(dense, q16, bv)),
                   "q16_bound_ms": bound(R * B * 4 + R * 64, 2 * R * B, hbm)[0],
                   "library": "cumsum + searchsorted (gathered: hist[slots] first)"})
    del got_d, want_d, got_g, want_g, got_o, want_o, got_16, want_16, odd
    quantile_result_default_entry(dev, hbm, detail, shift)
    quantile_result_wide_checks(dev, detail, shift)

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
    d64, s64_ = dst.to(torch.int64), src.to(torch.int64)
    detail.append({"kernel": "merge_rows", "case": f"i32 add {row} B rows "
                   "(sliding union merge)", "rows": k, "unique_dst": True,
                   "ms": cuda_ms(lambda: K.merge_rows(hist, dst, src, "add",
                                                      unique_dst=True)),
                   "plain_ms": cuda_ms(lambda: K.merge_rows_plain(
                       ref, dst, src, "add", unique_dst=True), 3),
                   "library_ms": cuda_ms(lambda: ref.index_add_(0, d64, ref[s64_])),
                   "library": "index_add_ of the gathered source rows",
                   "bound_ms": bound(k * (row + 8) + 2 * k * row, 0, hbm)[0],
                   "max_abs_err": err})
    del hist, ref, dense, hflat
    torch.cuda.empty_cache()


def quantile_result_default_entry(dev, hbm, detail, shift=0):
    """quantile_result at the aggregate's default geometry (relative
    accuracy 0.01 over 1e-9 .. 1e9: 2,075 buckets, 8.3 KB a row), dense
    over 2^17 rows from an odd row, Q = 2, on 2^19 lognormal values."""
    import torch
    from flink_tpu_torch import kernels as K
    from flink_tpu_torch.ops.sketches import QuantileSketchAggregate
    agg = QuantileSketchAggregate()
    rng = np.random.default_rng(43)
    B, R, N = agg.buckets, 1 << (17 - shift), 1 << (19 - shift)
    hist = torch.zeros((R + 1, B), dtype=torch.int32, device=dev)
    slots = torch.from_numpy(rng.integers(0, R + 1, N).astype(np.int32)).to(dev)
    v = torch.from_numpy(rng.lognormal(3.0, 1.0, N).astype(np.float32)).to(dev)
    K.quantile_update(hist, slots, v, N, agg.min_value, agg.log_gamma, agg.offset)
    qs, bv = agg._tables(dev)
    rows = hist[1:]
    got, want = K.quantile_result(rows, qs, bv), K.quantile_result_plain(rows, qs, bv)
    torch.cuda.synchronize()
    check(torch.equal(got, want),
          f"quantile_result bit-equal at the default geometry ({B} buckets)")
    detail.append({"kernel": "quantile_result", "case": "default geometry",
                   "dense_rows": R, "buckets": B, "quantiles": 2,
                   "ms": cuda_ms(lambda: K.quantile_result(rows, qs, bv)),
                   "plain_ms": cuda_ms(lambda: K.quantile_result_plain(rows, qs, bv), 3),
                   "bound_ms": bound(R * B * 4 + R * 8, 2 * R * B, hbm)[0],
                   "max_abs_err": max_abs_err(got, want)})
    del hist, rows, got, want
    torch.cuda.empty_cache()


def quantile_result_wide_checks(dev, detail, shift=0):
    """quantile_result where its two forms meet: relative accuracy 0.0047
    over 1e-9 .. 1e9 (4,412 buckets, the widest row of the staged form:
    four rings a block), 0.004 (5,183) and 0.001 (20,726), both in the
    global-memory form; 4,096 rows of lognormal values, Q = 5; dense
    from an odd row and gathered over 8,192 slots with some past both
    ends, each bit-equal to the plain version."""
    import torch
    from flink_tpu_torch import kernels as K
    from flink_tpu_torch.ops.sketches import QuantileSketchAggregate
    rng = np.random.default_rng(47)
    R, N = 1 << (12 - shift), 1 << (22 - shift)
    for acc in (0.0047, 0.004, 0.001):
        agg = QuantileSketchAggregate(quantiles=(0.0, 0.25, 0.5, 0.99, 1.0),
                                      relative_accuracy=acc)
        B = agg.buckets
        hist = torch.zeros((R + 1, B), dtype=torch.int32, device=dev)
        slots = torch.from_numpy(rng.integers(0, R + 1, N).astype(np.int32)).to(dev)
        v = torch.from_numpy(rng.lognormal(3.0, 1.0, N).astype(np.float32)).to(dev)
        K.quantile_update(hist, slots, v, N, agg.min_value, agg.log_gamma, agg.offset)
        hist[1:17] = 0                                   # empty rows
        qs, bv = agg._tables(dev)
        rows = hist[1:]
        gslots = torch.from_numpy(rng.integers(-3, R + 4, 2 * R).astype(np.int32)).to(dev)
        got_d, want_d = K.quantile_result(rows, qs, bv), K.quantile_result_plain(rows, qs, bv)
        got_g = K.quantile_result(hist, qs, bv, slots=gslots)
        want_g = K.quantile_result_plain(hist, qs, bv, gslots)
        torch.cuda.synchronize()
        check(torch.equal(got_d, want_d) and torch.equal(got_g, want_g),
              f"quantile_result bit-equal on rows of {B} buckets, dense from an odd "
              "row and gathered")
        detail.append({"kernel": "quantile_result", "case": "wide rows",
                       "relative_accuracy": acc, "buckets": B, "dense_rows": R,
                       "gathered_rows": 2 * R, "quantiles": 5,
                       "ms": cuda_ms(lambda: K.quantile_result(rows, qs, bv)),
                       "plain_ms": cuda_ms(lambda: K.quantile_result_plain(rows, qs, bv), 3)})
        del hist, rows, got_d, want_d, got_g, want_g, slots, v
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
    check(allclose(got, want, rtol=1e-5),
          "engine sample of 4096 keys within rtol 1e-5 of numpy HLL")
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


#: one hll_log_finish launch of the mesh path's set_mesh HLL job at 2^21
#: events over 8,000 keys in four 1 s windows on 8 shards: a shard's
#: window, 2^16 events over 1,000 keys (the path now runs 2^19 events;
#: the mesh phase records its own launch shapes beside this entry)
MESH_LOG_FINISH = (1 << 16, 1000)


def log_finish_inputs(dev, rng, n_events=1 << 23, n_keys=1_000_000, p=12):
    """hll_log_finish's inputs from a real hll_log_compact of config #2's
    events (keys uniform over n_keys, one window): (ranks, ends) on dev,
    m, alpha, and the host cells (keys, regs, ranks) for the C++ fire."""
    import torch
    from flink_tpu_torch import native as nat
    from flink_tpu_torch.ops.sketches import HyperLogLogAggregate
    keys, _, vh = config2_events(rng, n_events, n_keys)
    regs, ranks = nat.hll_make_cells(vh, p)
    _, _, crk, ends = nat.hll_log_compact(keys, regs, ranks, p)
    return (torch.from_numpy(crk).to(dev), torch.from_numpy(ends).to(dev),
            1 << p, HyperLogLogAggregate(p).alpha, (keys, regs, ranks))


def log_finish_entry(dev, hbm, rng, entries, detail):
    """hll_log_finish at config #2 (the compacted cells of a real
    hll_log_compact of 2^23 events over a 1M-key space, p = 12), and at
    the shape of one of the mesh path's launches."""
    import torch
    from flink_tpu_torch import kernels as K
    from flink_tpu_torch import native as nat
    r, e, m, alpha, (keys, regs, ranks) = log_finish_inputs(dev, rng)
    p = m.bit_length() - 1
    n_cells, n_keys = len(r), len(e)
    sums = torch.empty(n_keys, dtype=torch.float64, device=dev)
    want_sums = torch.empty_like(sums)
    est = K.hll_log_finish(r, e, m, alpha, inv_sum=sums)
    want_est = K.hll_log_finish_plain(r, e, m, alpha, inv_sum=want_sums)
    check(torch.equal(K.hll_log_finish(r, e, m, alpha), est),
          "hll_log_finish estimates the same without the sums")
    torch.cuda.synchronize()
    check(torch.equal(sums, want_sums), "hll_log_finish sums bit-equal to plain")
    check(torch.equal(est, want_est), "hll_log_finish estimates bit-equal to plain")
    _, host = nat.hll_log_fire(keys, regs, ranks, p)
    host_t = torch.from_numpy(host).to(dev)
    check(torch.equal(est, host_t), "hll_log_finish estimates bit-equal to the C++ host fire")
    ms = cuda_ms(lambda: K.hll_log_finish(r, e, m, alpha))
    plain = cuda_ms(lambda: K.hll_log_finish_plain(r, e, m, alpha), 5)
    # one torch pipeline for the same function: exp2, index_add_, elementwise
    lengths = torch.diff(e.to(torch.int64), prepend=e.new_zeros(1, dtype=torch.int64))
    key_of = torch.repeat_interleave(torch.arange(n_keys, device=dev), lengths)
    mf, am2 = float(m), alpha * m * m

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
    # one launch of the mesh path's shape (its set_mesh job's shard windows)
    r, e, m, alpha, (keys, regs, ranks) = log_finish_inputs(dev, rng, *MESH_LOG_FINISH)
    n_cells, n_keys = len(r), len(e)
    est = K.hll_log_finish(r, e, m, alpha)
    _, host = nat.hll_log_fire(keys, regs, ranks, p)
    check(torch.equal(est, K.hll_log_finish_plain(r, e, m, alpha))
          and torch.equal(est.cpu(), torch.from_numpy(host)),
          "hll_log_finish at the mesh launch shape bit-equal to plain and the host fire")
    fn = lambda: K.hll_log_finish(r, e, m, alpha)    # noqa: E731
    detail.append({"kernel": "hll_log_finish", "case": "one launch of the mesh path",
                   "cells": n_cells, "keys": n_keys,
                   "ms": cuda_ms(fn, 50), "device_ms": kernel_device_ms(fn),
                   "plain_ms": cuda_ms(lambda: K.hll_log_finish_plain(r, e, m, alpha), 5),
                   "bound_ms": bound(n_cells + 12 * n_keys, n_cells + 8 * n_keys, hbm)[0]})


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
    C, N, P = TI_POSITIONS, TI_RECORDS, TI_MAX_PROBES
    n = N - 1000                                     # a padded tail
    rows = []
    for case in table_insert_cases(dev, rng):
        state = case["state"]
        card, plain = make_table(C, dev), make_table(C, dev)
        for t in (card, plain):
            case["fill"](t)
        h_d, l_d = case["lanes"]
        kw = case["kw"]
        saved = [a.clone() for a in card]
        ov = torch.zeros(1, dtype=torch.int64, device=dev)
        got = K.table_insert(*card, h_d, l_d, n, P, overflow=ov, **kw)
        ref = K.table_insert_plain(*plain, h_d, l_d, n, P, **kw)
        torch.cuda.synchronize()
        check(int(ov) == 0, f"table_insert {state}: no overflow")
        got = got.cpu().numpy()
        faults, probes = key_map_check(
            f"table_insert {state}", card, plain, case["hi"], case["lo"], got,
            ref.cpu().numpy(), n, P, case["region"], kw.get("region_size", 0))
        new_keys = int(card.occupied.sum() - saved[2].sum())
        read, written = chain_sectors(case, got, n, saved[2], card.occupied)
        restore = None if state == "all_hits" else (
            lambda t=card, s=saved: [a.copy_(b) for a, b in zip(t, s)])
        ms = cuda_ms(lambda: K.table_insert(*card, h_d, l_d, n, P, **kw),
                     setup=restore)
        b, by = bound(12 * n + 9 * probes + 9 * new_keys, probes, hbm)
        row = dict(state=state, ms=ms, bound_ms=b, bound_by=by,
                   sector_floor_ms=bound(12 * n + 32 * (read + written), probes,
                                         hbm)[0],
                   sectors_read=read, sectors_written=written, probes=probes,
                   faults=faults, new_keys=new_keys,
                   load_after=float(card.occupied.sum()) / C,
                   timer=RUN if restore is None else SINGLE)
        if state != "regional":
            prestore = None if restore is None else (
                lambda t=plain, s=saved: [a.copy_(b) for a, b in zip(t, s)])
            row["plain_ms"] = cuda_ms(
                lambda: K.table_insert_plain(*plain, h_d, l_d, n, P), 3,
                setup=prestore)
        rows.append(row)
        del card, plain, saved
    head = next(r for r in rows if r["state"] == "half_full")
    # the error figure: key -> slot faults found, summed over the four
    # states (a slot is an index, so there is no numeric difference)
    entries["table_insert"] = dict(ms=head["ms"], plain_ms=head["plain_ms"],
                                   library_ms=None, bound_ms=head["bound_ms"],
                                   bound_by=head["bound_by"],
                                   max_abs_err=float(sum(r["faults"] for r in rows)),
                                   sector_floor_ms=head["sector_floor_ms"])
    detail.append({"kernel": "table_insert", "records": N, "positions": C,
                   "max_probes": P, "states": rows, "timer": "per state",
                   "sector_floor": "12 B a record, and a 32-byte sector for "
                   "each distinct sector of occupied, key_hi and key_lo that "
                   "the probe chains read, and again for each one a claim "
                   "wrote"})


#: table_insert's entry: config #2's 1M-key space into 1.5M positions
TI_POSITIONS, TI_RECORDS, TI_MAX_PROBES = 1_500_000, 1 << 20, 128


def table_insert_cases(dev, rng):
    """table_insert's entry batches (``chip_smoke`` and
    ``scripts/kernel_ab.py``): a dict per state with its host lanes
    (``hi``, ``lo``, uint32), their card copies (``lanes``), the call's
    keywords (``kw``: the regional call's region and size), ``region``
    (numpy or None) and ``fill(table)``, which puts the state's prefill
    into an empty table.  States: empty, half_full (half the positions
    prefilled), all_hits (the batch onto itself) and regional (4 regions
    of 375,000 positions, empty)."""
    import torch
    from flink_tpu_torch import kernels as K
    C, N, P = TI_POSITIONS, TI_RECORDS, TI_MAX_PROBES

    def lanes(keys):
        hi = (keys >> np.uint64(32)).astype(np.uint32)
        lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        return hi, lo, (torch.from_numpy(hi.view(np.int32)).to(dev),
                        torch.from_numpy(lo.view(np.int32)).to(dev))

    def filler(pre):
        if pre is None:
            return lambda t: None
        _, _, (ph, pl) = lanes(pre)
        return lambda t: K.table_insert_plain(*t, ph, pl, len(pre), P)

    batch_a = rng.integers(0, 1_000_000, N).astype(np.uint64)
    batch_a[:64] = 0                                  # key (0, 0), repeated
    batch_b = rng.integers(0, 1_000_000, N).astype(np.uint64)
    prefill = rng.permutation(1_000_000)[:C // 2].astype(np.uint64)
    region = rng.integers(0, 4, N).astype(np.int32)
    cases = []
    for state, keys, pre, reg in (("empty", batch_a, None, None),
                                  ("half_full", batch_b, prefill, None),
                                  ("all_hits", batch_a, batch_a, None),
                                  ("regional", batch_a, None, region)):
        hi, lo, dl = lanes(keys)
        kw = {} if reg is None else dict(region=torch.from_numpy(reg).to(dev),
                                         region_size=C // 4)
        cases.append(dict(state=state, hi=hi, lo=lo, lanes=dl, kw=kw,
                          region=reg, fill=filler(pre)))
    return cases


def chain_sectors(case, slots, n, occ_before, occ_after):
    """Distinct 32-byte sectors of the table's three arrays (occupied: 1
    B a position; key_hi, key_lo: 4 B) on the probe chains that the
    batch's first n rows walked (chain start to their slot), and those
    of the positions that the batch claimed: (read, written)."""
    from flink_tpu_torch.ops.device_table import _chain_base
    hi = case["hi"][:n].astype(np.int64)
    lo = case["lo"][:n].astype(np.int64)
    s = slots[:n].astype(np.int64)
    ok = s >= 0
    hi, lo, s = hi[ok], lo[ok], s[ok]
    base = _chain_base(hi, lo)
    if case["region"] is None:
        modulus, offset = TI_POSITIONS, np.zeros(len(s), np.int64)
    else:
        modulus = case["kw"]["region_size"]
        offset = case["region"][:n][ok].astype(np.int64) * modulus
    walked, at = [], np.arange(len(s))
    for p in range(TI_MAX_PROBES):
        pos = offset[at] + ((base[at] + p) & 0xFFFFFFFF) % modulus
        walked.append(pos)
        at = at[pos != s[at]]
        if not len(at):
            break

    def sectors(pos):
        return np.unique(pos // 32).size + 2 * np.unique(pos // 8).size
    claimed = np.nonzero((occ_after != 0).cpu().numpy()
                         & (occ_before == 0).cpu().numpy())[0]
    return sectors(np.unique(np.concatenate(walked))), sectors(claimed)


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
        check(allclose(got, want, rtol=1e-5, atol=hll_atol(m)),
              f"log tier ({tier} finish): {n_sample} keys within rtol 1e-5 "
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
    from flink_tpu_torch.ops.device_agg import DeviceAggregateFunction
    merges = {}

    def note_merge(args, _):
        key = f"{type(args[0]).__name__} k={len(args[2])}"
        merges[key] = merges.get(key, 0) + 1

    restore = _recording(DeviceAggregateFunction, "_merge", note_merge)
    try:
        _job_phase(dev)
    finally:
        restore()
    # the merges the jobs made (aggregate, pairs a call): each is one
    # merge_rows launch
    emit({"job_merges": dict(sorted(merges.items()))})


def _job_phase(dev):
    import torch
    from flink_tpu_torch.ops.device_agg import SumAggregate
    from flink_tpu_torch.ops.sketches import HyperLogLogAggregate

    rng = np.random.default_rng(5)
    # HLL unique visitors: 2^19 events, 1M keys, tumbling 1 s over 4 s
    n, n_keys, p = 1 << 19, 1_000_000, 12
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
    check(allclose(got, want, rtol=1e-5, atol=hll_atol(1 << p)),
          "HLL job sample of 4096 pairs within rtol 1e-5 (+ log slack) "
          "of numpy HLL")
    hll = {"events": n, "pairs": int(len(upairs)), "seconds": secs,
           "events_per_s": n / secs}

    # word count: SumAggregate over 50k words (strings: the fused intern
    # + sum engine), tumbling 5 s
    n, n_words = 1 << 18, 50_000
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
    n, n_keys = 1 << 11, 500
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
    check(allclose([r[2] for r in got], [r[2] for r in want],
                   rtol=1e-5, atol=hll_atol(4096)),
          "keyed-backend job: estimates within rtol 1e-5 (+ log slack) of heap")
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


def sketch_jobs(dev, rng, n=1 << 12, key_of=int, tag=""):
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


def scatter_jobs(dev, rng, n=1 << 11):
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
    check(allclose([r[3] for r in got], [r[3] for r in want], rtol=1e-6),
          "tumbling_avg job: means within rtol 1e-6 of heap")
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


def keyed_phase(dev, n_events=1 << 20, n_keys=1_000_000, chunk=1 << 19):
    """OneInputStreamOperatorTestHarness(WindowOperator(tumbling 1 s,
    HLL p = 12), state_backend="gpu") fed RecordBatches of (key,
    visitor) rows: 1M keys, 2^20 events in one window, a snapshot and a
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
    check(allclose(got, want, rtol=1e-5),
          "keyed phase sample of 4096 keys within rtol 1e-5 of numpy HLL")
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


def session_phase(dev, n=10_000, n_keys=2_000):
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
            check(allclose(*vals, rtol=1e-5, atol=hll_atol(4096)),
                  "session hll: within rtol 1e-5 (+ log slack) of heap")
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


def sliding_phase(dev, n_events=1 << 21, n_keys=10_000_000, chunk=1 << 19,
                  n_sample=4096):
    """VectorizedSlidingWindows(QuantileSketchAggregate p50/p99, 10 s /
    1 s) over a 10M-key space: 2^21 time-sorted events over 10 s of
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
        "reduced": f"depth only: an unbounded stream cut to "
                   f"2^{n_events.bit_length() - 1} events over 10 s of event "
                   "time; key space, window geometry and sketch widths "
                   "unchanged"}}
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


def session_cm_phase(dev, n_events=1 << 20, n_keys=100_000, span=30_000,
                     chunk=1 << 19, n_sample=4096):
    """VectorizedSessionWindows(CountMinSketchAggregate(), gap 1 s) at
    its default widths (d = 4, w = 2048): 100k keys, uniform user ids,
    2^20 time-sorted events over 30 s, a watermark after each chunk.
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
        "reduced": f"depth only: an unbounded stream cut to "
                   f"2^{n_events.bit_length() - 1} events over 30 s; keys, "
                   "gap and sketch widths unchanged"}}
    del eng
    torch.cuda.empty_cache()
    emit(out)


def heavy_hitter_phase(dev, n_events=1 << 20, n_keys=100_000, span=4_000,
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
        "reduced": f"depth only: an unbounded stream cut to "
                   f"2^{n_events.bit_length() - 1} events over 4 s; keys, "
                   "item mix and sketch widths unchanged"}}
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
                n_window=1 << 18, window_keys=100_000, job_events=1 << 18,
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
    # the split: the same events' pass under torch.profiler in a fresh
    # process (late in a long process the profiler lost memcpy
    # records), its DtoH bytes held to the transfer ledger's
    split = _fresh_chain_split("chain", n_events, n_keys, batch, seed=23)
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
    host wall time of the run, the card's idle share in it and the bytes
    of its device-to-host copies; all None when the trace holds no
    device event.  Everything is read from the profile's exported
    trace, exported before anything else reads the profile."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    ms = {"h2d": 0.0, "udf": 0.0, "kernel": 0.0, "d2h": 0.0}
    n_events = d2h_bytes = 0
    for e in events:
        if e.get("ph") != "X" or e.get("cat", "").lower() not in (
                "kernel", "gpu_memcpy", "gpu_memset"):
            continue
        n_events += 1
        dur = float(e.get("dur", 0.0)) / 1e3
        name = e.get("name", "")
        if "HtoD" in name:
            ms["h2d"] += dur
        elif "DtoH" in name:
            ms["d2h"] += dur
            d2h_bytes += int((e.get("args") or {}).get("bytes", 0))
        elif "chain_" in name:
            ms["kernel"] += dur
        else:
            ms["udf"] += dur
    if not n_events:
        return {"device_events": 0, "device_ms": None, "wall_ms": wall_ms,
                "idle_share": None, "d2h_bytes": None}
    return {"device_events": n_events, "device_ms": ms, "wall_ms": wall_ms,
            "idle_share": 1.0 - sum(ms.values()) / wall_ms,
            "d2h_bytes": d2h_bytes}


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
    # the regions' geometry sets the state, not the events (a rehearsal
    # off the card passes smaller regions)
    check(state_bytes >= 17.1e9 or region < (1 << 18),
          "mesh scatter: 17.2 GB of registers on the card")
    return {"events": n_events, "keys": n_keys, "shards": 8,
            "region_slots": region, "ring": 2, "register_bytes": state_bytes,
            "fired": int(len(fk)), "ingest_s": t1 - t0, "fire_s": t3 - t2,
            "events_per_s": n_events / (t1 - t0 + t3 - t2),
            "max_memory_allocated": peak}


def _mesh_snapshot(dev, mesh, rng, n_events, n_keys, region, step, chunk):
    """(f) config #2's events through MeshTumblingWindows with a Count: a
    snapshot after half the events (mid-window), restored into a fresh
    engine that takes the other half; its fire equals an uninterrupted
    run's."""
    import torch
    from flink_tpu_torch.ops.device_agg import CountAggregate
    from flink_tpu_torch.parallel import MeshTumblingWindows
    keys, ts, _ = config2_events(rng, n_events, n_keys)
    half = n_events // 2

    def engine():
        eng = MeshTumblingWindows(CountAggregate(), 1000, mesh,
                                  capacity_per_window_shard=region, ring=2,
                                  step_batch=step)
        eng.emit_arrays = True
        return eng

    def feed(eng, sl):
        for i in range(sl.start, sl.stop, chunk):
            part = slice(i, min(i + chunk, sl.stop))
            eng.process_batch(keys[part], ts[part])

    first = engine()
    feed(first, slice(0, half))
    t0 = time.perf_counter()
    snap = first.snapshot()
    t1 = time.perf_counter()
    del first
    restored = engine()
    restored.restore(snap)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del snap
    feed(restored, slice(half, n_events))
    restored.advance_watermark(999)
    got = _fired_arrays(restored)
    del restored
    gc.collect()
    torch.cuda.empty_cache()

    def whole():
        eng = engine()
        feed(eng, slice(0, n_events))
        eng.advance_watermark(999)
        return _fired_arrays(eng)
    want = _launch_free(whole)
    check(all(np.array_equal(np.asarray(a), np.asarray(b))
              for a, b in zip(got, want)) and len(got[0]) > 0,
          "mesh snapshot: a run restored mid-window fires what the "
          "uninterrupted run fires")
    return {"events": n_events, "snapshot_after": half, "fired": int(len(got[0])),
            "snapshot_s": t1 - t0, "restore_s": t2 - t1}


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
    check(state_bytes >= 28.1e9 or region < (1 << 18),
          "mesh sliding: 28.2 GB of sketch state on the card")
    return {"events": n_events, "key_space": n_keys, "window_ms": size,
            "slide_ms": slide, "region_slots": region, "ring": 16,
            "state_bytes": state_bytes, "fired_pairs": int(len(got[0])),
            "seconds": secs, "events_per_s": n_events / secs,
            "max_memory_allocated": peak,
            "reduced": "key space 10M -> 1M (a 10 s window's ~985k keys fit "
                       "a 2^18 region per shard at under half load; 10M would "
                       "need 2^20 regions: 113 GB); depth: "
                       f"2^{n_events.bit_length() - 1} events"}


def _mesh_jobs(dev, mesh, rng, n, n_keys, n_composite):
    """(d) DataStream jobs with env.set_mesh(mesh): HLL 12, tumbling 1 s,
    integer keys (the mesh log tier, n events) and composite keys (the
    sharded scatter tier, the first n_composite events: each composite
    key is hashed row by row on the host, in both runs), each equal to
    the same job without a mesh."""
    from flink_tpu_torch.ops.sketches import HyperLogLogAggregate
    from flink_tpu_torch.streaming.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.streaming import log_windows
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
    # the (keys, cells) of each hll_log_finish launch of the mesh runs
    finishes = []
    DeviceWindowOperator._ensure_engine = noting
    unrecord = _recording(log_windows, "hll_log_finish",
                          lambda a, r: finishes.append((len(a[1]), len(a[0]))))
    try:
        for name, key_of, evs in (
                ("int_keys", lambda e: e[0], events),
                ("composite_keys", lambda e: (f"k{e[0] % 7}", e[0]),
                 events[:n_composite])):
            engines.clear()
            got, secs = run(True, key_of, evs)
            unrecord()
            tier = sorted(set(engines))
            want, plain_s = _launch_free(run, False, key_of, evs)
            check(got == want and len(got) > 0,
                  f"mesh job ({name}): results equal the job without a mesh")
            out[name] = {"tier": tier, "events": len(evs), "results": len(got),
                         "events_per_s": len(evs) / secs,
                         "meshless_events_per_s": len(evs) / plain_s}
    finally:
        DeviceWindowOperator._ensure_engine = ensure
        unrecord()
    out["int_keys"]["hll_log_finish_launches"] = finishes
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


def mesh_phase(dev, n_events=1 << 22, n_keys=1_000_000, region=1 << 18,
               step=1 << 20, chunk=1 << 20, n_sample=256,
               sliding_events=1 << 21, sliding_region=1 << 18,
               sliding_chunk=1 << 19, job_events=1 << 18, job_keys=8000,
               composite_events=1 << 17, chain_events=1 << 21,
               chain_batch=1 << 20, snapshot_events=1 << 21):
    """The mesh path on 8 virtual shards of the card: (a) config #2 on
    the sharded scatter tier, (b) on the mesh log tier, (c) config #3 on
    the sharded sliding engine, (d) DataStream jobs with set_mesh, (e)
    the fused chain's mesh leg, each against its single-device twin;
    (f) a mesh snapshot restored mid-window against the uninterrupted
    run."""
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
           "snapshot": _mesh_snapshot(dev, mesh, rng, snapshot_events, n_keys,
                                      region, step, chunk),
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
                   **edge_popcount_split(dev, hbm, adj, u, v, got),
                   "library": None,
                   "timer": "ms, pairs_ms, global_form_ms, scan_ms, fill_ms: " + RUN
                   + "; plan_ms: " + SINGLE})
    del adj, u, v, got, want
    torch.cuda.empty_cache()
    edge_popcount_wide_check(dev, detail)


def edge_popcount_split(dev, hbm, adj, u, v, want):
    """edge_popcount's parts at one input: the plan (its scan, its fill,
    the glue between as the rest), the pair pass on it, and the pair pass
    in its global form forced (checked bit-equal); the plan's statistics
    (rows listed and dense, entries, the pairs' small-row entries), and a
    sector floor: the bitset read once, the lists written once, and each
    pair's small list read in 32-byte sectors, with 12 B of indices and
    count a pair."""
    import torch
    from flink_tpu_torch import kernels as K
    from flink_tpu_torch.kernels import loader
    from flink_tpu_torch.kernels.edge_popcount import _vec
    n, words = adj.shape
    p = len(u)
    plan = K.popcount_plan(adj, u, v)
    vec = _vec(adj)
    mask_words = -(-(words // vec) // 32)
    counts = torch.empty(n, dtype=torch.int32, device=dev)
    masks = torch.empty(n * mask_words, dtype=torch.int32, device=dev)
    entries = torch.empty_like(plan.entries)
    scan = lambda: loader.launch(                                  # noqa: E731
        "edge_popcount", "ft_edge_scan", adj.data_ptr(), n, words, vec,
        counts.data_ptr(), masks.data_ptr(), mask_words)
    fill = lambda: loader.launch(                                  # noqa: E731
        "edge_popcount", "ft_edge_fill", adj.data_ptr(), n, words, vec,
        counts.data_ptr(), plan.dense_above, plan.offsets.data_ptr(),
        masks.data_ptr(), mask_words, entries.data_ptr())
    scan_ms, fill_ms = cuda_ms(scan, 5), cuda_ms(fill, 5)
    check(torch.equal(counts, plan.counts) and torch.equal(entries, plan.entries),
          "edge_popcount: the scan and fill timed give the plan's lists")
    plan_ms = cuda_ms(lambda: K.popcount_plan(adj, u, v), 5, single=True)
    pairs_ms = cuda_ms(lambda: K.edge_pairs(adj, plan), 5)
    forced = torch.empty_like(want)
    glob = lambda: loader.launch(                                  # noqa: E731
        "edge_popcount", "ft_edge_popcount", adj.data_ptr(), words, vec,
        plan.counts.data_ptr(), plan.dense_above, plan.offsets.data_ptr(),
        plan.entries.data_ptr(), plan.big.data_ptr(), plan.small.data_ptr(),
        plan.order.data_ptr(), p, forced.data_ptr(), 1)
    glob()
    check(torch.equal(forced, want), "edge_popcount global form bit-equal")
    global_ms = cuda_ms(glob, 5)
    scnt = plan.counts.index_select(0, plan.small).to(torch.int64)
    dense = plan.counts > plan.dense_above
    small_dense = scnt > plan.dense_above
    listed_len = torch.where(small_dense, 0, scnt)
    sectors = int(((8 * listed_len + 31) // 32).sum())
    n_entries = len(plan.entries)
    floor_bytes = 4 * n * words + 8 * n_entries + 32 * sectors + 12 * p
    return {"plan_ms": plan_ms, "scan_ms": scan_ms, "fill_ms": fill_ms,
            "glue_ms": plan_ms - scan_ms - fill_ms, "pairs_ms": pairs_ms,
            "global_form_ms": global_ms, "dense_above": plan.dense_above,
            "rows_dense": int(dense.sum()),
            "rows_listed_nonempty": int(((plan.counts > 0) & ~dense).sum()),
            "entries": n_entries, "entries_bytes": 8 * n_entries,
            "sum_small_list_entries": int(listed_len.sum()),
            "pairs_small_dense": int(small_dense.sum()),
            "sector_floor_ms": bound(floor_bytes, 0, hbm)[0],
            "sector_floor": "bitset once + lists written once + each pair's "
                            "small list in 32-byte sectors + 12 B a pair"}


def edge_popcount_wide_check(dev, detail):
    """edge_popcount on rows too wide for a block's shared memory (64 rows
    of 65,536 words: the global form), random rows of 0 to 40,000 bits,
    one dense and one empty, 3,000 random pairs: bit-equal to plain."""
    import torch
    from flink_tpu_torch import kernels as K
    rng = np.random.default_rng(64)
    n, words = 64, 65_536
    sizes = rng.integers(0, 40_000, n)
    sizes[3], sizes[5] = 1_500_000, 0
    rows = torch.from_numpy(np.repeat(np.arange(n), sizes)).to(dev)
    cols = torch.from_numpy(rng.integers(0, 32 * words, len(rows))).to(dev)
    flat = torch.zeros(n * words, dtype=torch.int64, device=dev)
    bits = torch.unique(rows * (32 * words) + cols)
    word = bits // 32
    flat.index_add_(0, word, torch.bitwise_left_shift(torch.ones_like(bits), bits % 32))
    adj = torch.where(flat >= 2 ** 31, flat - 2 ** 32, flat).to(torch.int32).view(n, words)
    u = torch.from_numpy(rng.integers(0, n, 3000).astype(np.int32)).to(dev)
    v = torch.from_numpy(rng.integers(0, n, 3000).astype(np.int32)).to(dev)
    got = K.edge_popcount(adj, u, v)
    check(torch.equal(got, K.edge_popcount_plain(adj, u, v)),
          "edge_popcount wide rows (global form) bit-equal to plain")
    detail.append({"kernel": "edge_popcount", "case": "wide rows: the global form",
                   "rows": n, "words": words, "pairs": 3000,
                   "ms": cuda_ms(lambda: K.edge_popcount(adj, u, v), 3)})
    del flat, adj, rows, cols, bits, word
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


#: the graph path's edges and its host references, started by main()
#: ahead of the paths (graph_references_start)
_GRAPH_REFS = {}


def graph_references_start(dev, scale=22):
    """Draw the graph path's Graph500 edges (seed 21) and start its host
    references -- HITS at the default step count, the components,
    Dijkstra and the max-flood -- in worker processes, which then run
    beside the paths ahead of the graph path.  PageRank's reference is
    started by the graph path, once the port's run has given its step
    count.  The workers are daemons: graph_references_stop() or the
    interpreter's exit ends them."""
    import multiprocessing
    t_gen = time.perf_counter()
    src, dst, w = kronecker_edges(dev, scale, seed=21)
    n = 1 << scale
    deg = np.bincount(src, minlength=n) + np.bincount(dst, minlength=n)
    source = int(np.argmax(deg))
    flood_vals = np.random.default_rng(22).integers(0, 1 << 30, n).astype(np.int32)
    setup_s = time.perf_counter() - t_gen
    pool = multiprocessing.get_context("spawn").Pool(5)
    hits_steps = 50
    _GRAPH_REFS.update(
        scale=scale, src=src, dst=dst, w=w, source=source,
        source_degree=int(deg[source]), flood_vals=flood_vals, setup_s=setup_s,
        pool=pool, t_start=time.perf_counter(), hits_steps=hits_steps,
        refs={"hits": pool.apply_async(_timed, (ref_hits64, src, dst, n, hits_steps)),
              "components": pool.apply_async(_timed, (ref_components, src, dst, n)),
              "sssp": pool.apply_async(_timed, (ref_dijkstra, src, dst, w, n, source)),
              "flood": pool.apply_async(_timed, (ref_max_flood, src, dst, flood_vals))})


def graph_references_stop():
    """End the reference workers, finished or not."""
    pool = _GRAPH_REFS.pop("pool", None)
    _GRAPH_REFS.clear()
    if pool is not None:
        pool.terminate()
        pool.join()


def graph_phase(dev, scale=22, tri_scale=18, n_sample=4096):
    """The graph library on a Graph500 Kronecker graph (scale 22: 4.19M
    vertices, 67.1M directed edges, weights uniform in [0, 1)):
    PageRank (0.85, default iterations), HITS, ConnectedComponents,
    SingleSourceShortestPaths from the vertex of highest degree and a
    PregelIteration max-flood; TriangleCount and ClusteringCoefficient
    at scale 18 (their dense bitset is n^2 / 8 bytes: 8.6 GB there,
    2 TB at scale 22).  Checked against numpy and scipy, computed in
    worker processes that graph_references_start() started ahead of
    the paths (here, if it did not)."""
    import torch
    from flink_tpu_torch import graph as tg
    from flink_tpu_torch.graph import iterations as titer
    from flink_tpu_torch.graph import library as tlib
    if _GRAPH_REFS.get("scale") != scale:
        graph_references_stop()
        graph_references_start(dev, scale)
    pre = _GRAPH_REFS
    src, dst, w, source = pre["src"], pre["dst"], pre["w"], pre["source"]
    flood_vals, pool, refs = pre["flood_vals"], pre["pool"], dict(pre["refs"])
    n, e = 1 << scale, len(src)
    g = _graph(src, dst, w, n)
    out = {"vertices": n, "edges": e, "setup_s": pre["setup_s"],
           "sssp_source_degree": pre["source_degree"],
           "references_started_s_before": time.perf_counter() - pre["t_start"],
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
    try:
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

        # the float64 power iterations take the port's step counts (HITS
        # started at the default's, which float32 runs at this scale
        # reach; a tolerance of 1e-9 is below their rounding)
        pr = run("pagerank", lambda: g.run(tg.PageRank(0.85, device=dev)),
                 "gather_segment_sum")
        refs["pagerank"] = pool.apply_async(
            _timed, (ref_pagerank64, src, dst, n, runs["pagerank"]["calls"]))
        hubs, auths = run("hits", lambda: g.run(tg.HITS(device=dev)),
                          "gather_segment_sum")
        hits_steps = runs["hits"]["calls"] // 2
        if hits_steps != pre["hits_steps"]:
            refs["hits"] = pool.apply_async(
                _timed, (ref_hits64, src, dst, n, hits_steps))
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
        timed = {k: f.get() for k, f in refs.items()}
        out["reference_wait_s"] = time.perf_counter() - t_wait
    finally:
        for r in reversed(restore):
            r()
        graph_references_stop()
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

    def side(name, row_ids, col_ids, n_rows, fixed, vals_all=vals_all):
        """One half-step's Gram sums on its plan against the plain
        version: a sum of t float32 terms in another order is within
        2 t eps sum|terms|; two calls, and the wrapper's own plan, give
        the same bits, and G is symmetric bit for bit."""
        indptr, cols, vals = rating_csr(torch.from_numpy(row_ids).to(dev),
                                        torch.from_numpy(col_ids).to(dev), vals_all, n_rows)
        plan_ms = cuda_ms(lambda: K.gram_plan(indptr), 3, single=True)
        plan = K.gram_plan(indptr)
        g, b = K.gram_accumulate(fixed, indptr, cols, vals, plan=plan)
        again = K.gram_accumulate(fixed, indptr, cols, vals, plan=plan)
        own = K.gram_accumulate(fixed, indptr, cols, vals)
        check(all(torch.equal(x, y) for o in (again, own) for x, y in zip((g, b), o))
              and torch.equal(g, g.transpose(1, 2)),
              f"gram_accumulate ({name} side): two calls and the wrapper's own plan "
              "bit-equal, G symmetric bit for bit")
        del again, own
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
        nnz, f_ = len(cols), fixed.shape[1]
        b_, by = gram_bound(nnz, n_rows, len(fixed), f_, hbm)
        res = dict(ms=cuda_ms(lambda: K.gram_accumulate(fixed, indptr, cols, vals,
                                                        plan=plan)),
                   plain_ms=cuda_ms(lambda: K.gram_accumulate_plain(
                       fixed, indptr, cols, vals), 3),
                   bound_ms=b_, bound_by=by, max_abs_err=err)
        info = {"kernel": "gram_accumulate", "side": name, "rows": n_rows,
                "ratings": nnz, "max_row_ratings": int(terms.max()), "factors": f_,
                "plan_ms": plan_ms, "plan_chunks": len(plan.row),
                "plan_split_rows": len(plan.split_row), "chunk_ratings": plan.width,
                "plan_timer": SINGLE}
        return res, info, (indptr, cols, gw)

    def library(fixed, n_rows, indptr, cols, gw):
        """index_add_ of the materialized [nnz, f, f] outer products."""
        rows_sorted = torch.repeat_interleave(torch.arange(n_rows, device=dev),
                                              indptr[1:] - indptr[:-1])
        vc = fixed.index_select(0, cols)
        outer = vc[:, :, None] * vc[:, None, :]           # [nnz, f, f], 8 GB
        ms = cuda_ms(lambda: gw.index_add_(0, rows_sorted, outer), 3)
        del rows_sorted, vc, outer
        torch.cuda.empty_cache()
        return ms

    lib_name = "index_add_ of the materialized [nnz, f, f] outer products (G only)"
    # the user side, from item-shaped factors, with the library call
    V = torch.from_numpy(rng.normal(0, 0.1, (n_items, f)).astype(np.float32)).to(dev)
    res, info, (indptr, cols, gw) = side("users", u, i, n_users, V)
    entries["gram_accumulate"] = dict(res, library_ms=library(V, n_users, indptr,
                                                              cols, gw))
    detail.append(dict(info, library=lib_name))
    del gw, indptr, cols
    torch.cuda.empty_cache()
    # the item side, from user-shaped factors drawn from a seed of their
    # own (the KNN data below stays as it was)
    U = torch.from_numpy(np.random.default_rng(32).normal(0, 0.1, (n_users, f))
                         .astype(np.float32)).to(dev)
    res, info, (indptr, cols, gw) = side("items", i, u, n_items, U)
    detail.append(dict(info, **res, library=lib_name,
                       library_ms=library(U, n_items, indptr, cols, gw)))
    del U, V, vals_all, indptr, cols, gw
    torch.cuda.empty_cache()
    # f = 64 (the kernel's largest) on a user side cut to about 2M
    # ratings, from a seed of its own
    r64 = np.random.default_rng(33)
    u6, i6, s6 = movielens_shape(r64, 20_000_263 // (10 * shrink),
                                 138_493 // (10 * shrink), 26_744 // (10 * shrink))
    V64 = torch.from_numpy(r64.normal(0, 0.1, (int(i6.max()) + 1, 64))
                           .astype(np.float32)).to(dev)
    res, info, _ = side("users, f = 64", u6, i6, int(u6.max()) + 1, V64,
                        torch.from_numpy(s6).to(dev))
    detail.append(dict(info, **res))
    del V64, _
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
    seed: ALS at MovieLens-20M's (f = 10, lambda = 0.1; 3 iterations,
    cut from 10 to 5 and to 3 to make room for later paths),
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
        als = run("als", lambda: tm.ALS(10, 0.1, 3, seed=0, device=dev).fit(ratings),
                  "gram_accumulate")
        undo()
        fixed = [t.cpu().numpy() for t in fixed[-2:]]
        del ratings
        check(runs["als"]["calls"] == 6, "als: gram_accumulate twice a sweep")
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
# phase 17: the rest of the window API
# ---------------------------------------------------------------------

def _mean_max():
    """A Python aggregate the lift probe accepts: (sum, count, max) of
    the element's field 1 -> (mean, count, max)."""
    from flink_tpu_torch.core.functions import AggregateFunction

    class MeanMax(AggregateFunction):
        def create_accumulator(self):
            return (0.0, 0.0, -np.inf)

        def add(self, v, acc):
            return (acc[0] + v[1], acc[1] + 1.0, np.maximum(acc[2], v[1]))

        def get_result(self, acc):
            return (acc[0] / acc[1], acc[1], acc[2])

        def merge(self, a, b):
            return (a[0] + b[0], a[1] + b[1], np.maximum(a[2], b[2]))

    return MeanMax()


def _branchy():
    """A Python aggregate that branches on element values: the probe
    demotes it to the scalar fold."""
    from flink_tpu_torch.core.functions import AggregateFunction

    class Branchy(AggregateFunction):
        def create_accumulator(self):
            return (0.0, 0)

        def add(self, v, acc):
            if v[1] > 0.5:
                return (acc[0] + 2.0 * v[1], acc[1] + 1)
            return (acc[0] + v[1], acc[1] + 1)

        def get_result(self, acc):
            return (acc[0], acc[1])

        def merge(self, a, b):
            return (a[0] + b[0], a[1] + b[1])

    return Branchy()


def _api_job(dev, events, build, backend=None):
    """from_collection -> timestamps (in order, bound 0; a watermark
    every 1024 records) -> build(stream) -> CollectSink; (output,
    seconds)."""
    from flink_tpu_torch.streaming.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.streaming.sources import (
        BoundedOutOfOrdernessTimestampExtractor, CollectSink)
    env = StreamExecutionEnvironment.get_execution_environment(device=dev)
    if backend is not None:
        env.set_state_backend(backend)
    out = []
    build(env.from_collection(events).assign_timestamps_and_watermarks(
        BoundedOutOfOrdernessTimestampExtractor(0, lambda e: e[2]),
        watermark_interval=1024)).add_sink(CollectSink(out))
    t0 = time.perf_counter()
    env.execute("chip-smoke-window-api")
    return out, time.perf_counter() - t0


def _rate(n, secs, **extra):
    return {"events": n, "seconds": secs, "events_per_s": n / secs, **extra}


def _groups(*cols):
    """Group ids of the rows by the given integer columns, in sorted
    order of the tuples: (ids, unique rows)."""
    rows = np.stack(cols, 1)
    uniq, inv = np.unique(rows, axis=0, return_inverse=True)
    return inv.reshape(-1), uniq


def window_api_phase(dev, n_generic=1 << 18, n_keys=1_000_000,
                     n_prefix=1 << 16, n_scalar=1 << 16, n_fns=1 << 15,
                     n_triggers=1 << 14, n_hll=1 << 15, hll_keys=10_000):
    """The window API of slice 16 on the card: (1) a lifted Python
    aggregate on the generic tier at config #2's key space, against a
    numpy fold and, on a prefix, WindowOperator; (2) a scalar-mode
    aggregate on sliding and session windows against WindowOperator;
    (3) reduce / fold / apply / process / sum / min / max; (4) count
    windows, triggers, evictors, window_all, count_window_all, dynamic
    sessions, each against numpy; (5) HLL under a continuous trigger on
    the GPU backend against the heap backend, and a count window over a
    device Sum.  Each sub-part prints its events/s and seconds."""
    import torch
    from flink_tpu_torch.streaming import generic_agg
    from flink_tpu_torch.streaming import windowing as w
    from flink_tpu_torch.streaming.window_operator import ProcessWindowFunction

    rng = np.random.default_rng(16)
    engines = []
    restore = _recording(generic_agg.GenericWindowOperator, "_ensure_engine",
                         lambda args, _: engines.append(args[0].engine))
    try:
        # (1) the generic tier at config #2's key space
        keys = rng.integers(0, n_keys, n_generic)
        vals = rng.random(n_generic)
        ts = np.sort(rng.integers(0, 4000, n_generic))
        events = list(zip(keys.tolist(), vals.tolist(), ts.tolist()))
        tumbling = w.TumblingEventTimeWindows.of(1000)

        def generic(stream, agg=None):
            return (stream.key_by(lambda e: e[0]).window(tumbling)
                    .aggregate(agg or _mean_max(), window_function=lambda k, win, r: [
                        (k, win.start, r[0])]))

        out, secs = _api_job(dev, events, generic)
        check(engines and engines[-1].lift.mode == "lifted",
              "window_api: the generic tier lifted MeanMax")
        # (key, window) as one id: key * 4 + window (4 s of events)
        upairs, gid = np.unique(keys * 4 + ts // 1000, return_inverse=True)
        count = np.bincount(gid)
        total = np.zeros(len(upairs))
        np.add.at(total, gid, vals)              # arrival order
        mx = np.full(len(upairs), -np.inf)
        np.maximum.at(mx, gid, vals)
        res = {k * 4 + s // 1000: r for k, s, r in out}
        check(len(res) == len(out) == len(upairs)
              and np.array_equal(np.fromiter(sorted(res), np.int64, len(res)),
                                 upairs),
              "window_api: generic (key, window) set exact")
        got = np.array([res[q] for q in upairs.tolist()])
        check(np.array_equal(got[:, 1], count) and np.array_equal(got[:, 2], mx),
              "window_api: generic count and max exact against numpy")
        check(np.all(np.abs(got[:, 0] - total / count) <= 1e-12 * np.abs(total / count)),
              "window_api: generic mean within 1e-12 relative of numpy")
        part = {"generic": _rate(n_generic, secs, pairs=len(upairs),
                                 lift=engines[-1].lift.mode,
                                 decided_by=engines[-1].lift.decided_by)}
        emit({"window_api": part})
        prefix = events[:n_prefix]
        g, g_secs = _api_job(dev, prefix, generic)
        s_out, s_secs = _api_job(dev, prefix, lambda st: (
            st.key_by(lambda e: e[0]).window(tumbling).disable_device_operator()
            .aggregate(_mean_max(), window_function=lambda k, win, r: [
                (k, win.start, r[0])])))
        check(sorted(g) == sorted(s_out) and len(g) > 0,
              "window_api: generic prefix equals WindowOperator exactly")
        emit({"window_api": {"generic_prefix": _rate(n_prefix, g_secs),
                             "window_operator_prefix": _rate(n_prefix, s_secs)}})

        # (2) a scalar-mode aggregate on sliding and session windows
        skeys = rng.integers(0, 10_000, n_scalar)
        sts = np.sort(rng.integers(0, 20_000, n_scalar))
        # values on a 2^-10 grid: every sum is exact in float64, so the
        # sliding tier's pane merges and WindowOperator's per-window
        # adds give the same bits in any order
        sevents = list(zip(skeys.tolist(),
                           (rng.integers(0, 1 << 10, n_scalar) / 1024).tolist(),
                           sts.tolist()))
        scalar = {}
        for name, assigner in (
                ("sliding", w.SlidingEventTimeWindows.of(3000, 1000)),
                ("session", w.EventTimeSessionWindows.with_gap(500))):
            def branchy(stream, off=False, assigner=assigner):
                ws = stream.key_by(lambda e: e[0]).window(assigner)
                if off:
                    ws = ws.disable_device_operator()
                return ws.aggregate(_branchy(), window_function=lambda k, win, r: [
                    (k, win.start, win.end, r[0])])
            n_before = len(engines)
            b_out, b_secs = _api_job(dev, sevents, branchy)
            check(len(engines) > n_before and engines[-1].lift.mode == "scalar",
                  f"window_api: Branchy on {name} runs the scalar fold")
            o_out, o_secs = _api_job(dev, sevents, lambda st: branchy(st, True))
            check(sorted(b_out) == sorted(o_out) and len(b_out) > 1000,
                  f"window_api: Branchy {name} equals WindowOperator exactly")
            scalar[name] = _rate(n_scalar, b_secs, results=len(b_out),
                                 window_operator_seconds=o_secs)
        emit({"window_api": {"scalar": scalar}})
    finally:
        restore()

    # (3) the window functions on tumbling windows, against numpy
    fkeys = rng.integers(0, 2000, n_fns)
    fvals = rng.integers(0, 1000, n_fns)
    fts = np.sort(rng.integers(0, 8000, n_fns))
    fevents = list(zip(fkeys.tolist(), fvals.tolist(), fts.tolist()))
    gid, uniq = _groups(fkeys, fts // 1000)
    fsum = np.bincount(gid, weights=fvals).astype(np.int64)
    fcnt = np.bincount(gid)
    fmin = np.full(len(uniq), np.iinfo(np.int64).max)
    np.minimum.at(fmin, gid, fvals)
    fmax = np.full(len(uniq), -1)
    np.maximum.at(fmax, gid, fvals)
    want = {(int(k), int(b) * 1000): i for i, (k, b) in enumerate(uniq)}

    class Describe(ProcessWindowFunction):
        def process(self, key, context, elements, out):
            vs = [e[1] for e in elements]
            out.collect((key, context.window.start, (sum(vs), len(vs), max(vs))))

    def keyed(stream):
        return stream.key_by(lambda e: e[0]).window(tumbling)

    fns = {
        "reduce": (lambda st: keyed(st).reduce(
            lambda a, b: (a[0], a[1] + b[1], a[2]),
            window_function=lambda k, win, r: [(k, win.start, r[0][1])]),
            lambda i, r: r == fsum[i]),
        "fold": (lambda st: keyed(st).fold(
            (0, 0), lambda acc, e: (acc[0] + e[1], acc[1] + 1),
            window_function=lambda k, win, r: [(k, win.start, r[0])]),
            lambda i, r: r == (fsum[i], fcnt[i])),
        "apply": (lambda st: keyed(st).apply(lambda k, win, es: [
            (k, win.start, (sum(e[1] for e in es), len(es)))]),
            lambda i, r: r == (fsum[i], fcnt[i])),
        "process": (lambda st: keyed(st).process(Describe()),
                    lambda i, r: r == (fsum[i], fcnt[i], fmax[i])),
        "sum": (lambda st: keyed(st).sum(1), lambda i, r: r[1] == fsum[i]),
        "min": (lambda st: keyed(st).min(1), lambda i, r: r[1] == fmin[i]),
        "max": (lambda st: keyed(st).max(1), lambda i, r: r[1] == fmax[i]),
    }
    part = {}
    for name, (build, ok) in fns.items():
        out, secs = _api_job(dev, fevents, build)
        if name in ("sum", "min", "max"):
            # the reduced element keeps the first element's key and ts
            got = {(r[0], r[2] - r[2] % 1000): r for r in out}
        else:
            got = {(r[0], r[1]): r[2] for r in out}
        check(len(got) == len(out) == len(uniq)
              and all(ok(i, got[kb]) for kb, i in want.items()),
              f"window_api: {name} exact against numpy")
        part[name] = _rate(n_fns, secs)
    emit({"window_api": {"functions": part}})

    # (4) triggers, evictors and the other windows, against numpy
    n = n_triggers
    tkeys = rng.integers(0, 50, n)
    tvals = rng.integers(0, 1000, n)
    # even timestamps and odd session gaps: no two rows of a key lie
    # exactly a gap apart, where a session's end would depend on when
    # the watermark passed it
    tts = 2 * np.sort(rng.integers(0, 4000, n))
    tevents = list(zip(tkeys.tolist(), tvals.tolist(), tts.tolist()))
    per_key = {}
    for i, k in enumerate(tkeys.tolist()):
        per_key.setdefault(k, []).append(i)
    win = tts // 1000
    add = lambda a, b: (a[0], a[1] + b[1], b[2])          # noqa: E731

    def chunks_of(rows, size):
        return [int(tvals[rows[j:j + size]].sum())
                for j in range(0, len(rows) - size + 1, size)]

    def want_count(size, slide=None):
        out = {}
        for k, rows in per_key.items():
            rows = np.asarray(rows)
            if slide is None:
                out[k] = chunks_of(rows, size)
            else:
                out[k] = [int(tvals[rows[max(0, j - size):j]].sum())
                          for j in range(slide, len(rows) + 1, slide)]
        return out

    def by_key(out):
        d = {}
        for r in out:
            d.setdefault(r[0], []).append(r[1])
        return d

    def want_purging(every):
        out = {}
        for (k, b), rows in _rows_by(tkeys, win).items():
            for c in chunks_of(rows, every):
                out.setdefault(k, []).append(c)
        return out

    def want_delta(thr):
        out = {}
        for (k, b), rows in _rows_by(tkeys, win).items():
            last, run = None, 0
            for i in rows:
                run += int(tvals[i])
                if last is None:
                    last = int(tvals[i])
                elif abs(int(tvals[i]) - last) > thr:
                    last = int(tvals[i])
                    out.setdefault(k, []).append(run)
        return out

    def want_time_evictor(keep_ms):
        out = {}
        for (k, b), rows in _rows_by(tkeys, win).items():
            t = tts[rows]
            out.setdefault(k, []).append(
                int(tvals[rows][t > t.max() - keep_ms].sum()))
        return out

    def want_dynamic():
        out = {}
        for k, rows in per_key.items():
            gap = 101 + 50 * (k % 4)
            t = tts[rows]
            starts = np.flatnonzero(np.concatenate([[True], np.diff(t) > gap]))
            out[k] = [int(c) for c in np.add.reduceat(tvals[rows], starts)]
        return out

    tumbling = w.TumblingEventTimeWindows.of(1000)
    triggers = {
        "count_window": (lambda st: st.key_by(lambda e: e[0]).count_window(100)
                         .reduce(add), want_count(100), "gpu"),
        "count_window_slide": (lambda st: st.key_by(lambda e: e[0])
                               .count_window(100, 10).reduce(add),
                               want_count(100, 10), None),
        "purging_count": (lambda st: st.key_by(lambda e: e[0]).window(tumbling)
                          .trigger(w.PurgingTrigger.of(w.CountTrigger(25)))
                          .reduce(add), want_purging(25), None),
        "delta": (lambda st: st.key_by(lambda e: e[0]).window(tumbling)
                  .trigger(w.DeltaTrigger(700, lambda a, b: abs(b[1] - a[1])))
                  .reduce(add), want_delta(700), None),
        "time_evictor": (lambda st: st.key_by(lambda e: e[0]).window(tumbling)
                         .evictor(w.TimeEvictor.of(300)).reduce(add),
                         want_time_evictor(300), None),
        "dynamic_session": (lambda st: st.key_by(lambda e: e[0]).window(
            w.DynamicEventTimeSessionWindows.with_dynamic_gap(
                lambda e: 101 + 50 * (e[0] % 4))).reduce(add),
            want_dynamic(), None),
    }
    part = {}
    for name, (build, want_k, backend) in triggers.items():
        out, secs = _api_job(dev, tevents, build, backend)
        got = by_key(out)
        check(len(out) > 0 and got == {k: v for k, v in want_k.items() if v},
              f"window_api: {name} exact against numpy")
        part[name] = _rate(n, secs, results=len(out))
    out, secs = _api_job(dev, tevents, lambda st: st.window_all(tumbling).reduce(add))
    check([r[1] for r in out] == [int(tvals[win == b].sum()) for b in np.unique(win)],
          "window_api: window_all exact against numpy")
    part["window_all"] = _rate(n, secs)
    out, secs = _api_job(dev, tevents, lambda st: st.count_window_all(1000).reduce(add))
    check([r[1] for r in out] == chunks_of(np.arange(n), 1000),
          "window_api: count_window_all exact against numpy")
    part["count_window_all"] = _rate(n, secs)
    emit({"window_api": {"triggers": part}})

    # (5) device aggregates under a trigger on the GPU backend
    from flink_tpu_torch.ops.device_agg import SumAggregate
    from flink_tpu_torch.ops.sketches import HyperLogLogAggregate
    hkeys = rng.integers(0, hll_keys, n_hll)
    hts = np.sort(rng.integers(0, 4000, n_hll))
    hevents = list(zip(hkeys.tolist(), rng.integers(0, 1 << 40, n_hll).tolist(),
                       hts.tolist()))

    def hll_job(stream):
        agg = HyperLogLogAggregate(12)
        agg.extract_value = lambda e: e[1]
        return (stream.key_by(lambda e: e[0]).window(tumbling)
                .trigger(w.ContinuousEventTimeTrigger.of(250))
                .aggregate(agg, window_function=lambda k, win, r: [
                    (k, win.start, r[0])]))

    got, secs = _api_job(dev, hevents, hll_job, "gpu")
    torch.cuda.synchronize()
    # the heap backend on a sample of the keys: the filter sits after
    # the timestamp assigner, so the sampled keys' records meet the same
    # watermarks as in the full job, and fire with the same contents
    sample = set(rng.choice(hll_keys, min(hll_keys, 500), replace=False).tolist())
    want, heap_secs = _api_job("cpu", hevents, lambda st: hll_job(
        st.filter(lambda e: e[0] in sample)), "heap")
    mine = [r for r in got if r[0] in sample]
    check([r[:2] for r in mine] == [r[:2] for r in want]
          and len(got) > 2 * len({r[:2] for r in got}),
          "window_api: HLL under ContinuousEventTimeTrigger fires as on the "
          "heap backend (sampled keys)")
    check(len(mine) == len(want)
          and np.allclose([r[2] for r in mine], [r[2] for r in want],
                          rtol=1e-5, atol=hll_atol(4096)),
          "window_api: HLL estimates within rtol 1e-5 (+ log slack) of heap")
    part = {"hll_continuous": _rate(n_hll, secs, fires=len(got),
                                    heap_sample_keys=len(sample),
                                    heap_sample_fires=len(want),
                                    heap_seconds=heap_secs)}

    def sum_job(stream):
        agg = SumAggregate(np.float64)
        agg.extract_value = lambda e: e[1]
        return (stream.key_by(lambda e: e[0]).count_window(100)
                .aggregate(agg, window_function=lambda k, win, r: [(k, r[0])]))

    out, secs = _api_job(dev, tevents, sum_job, "gpu")
    check(len(out) > 0 and by_key(out) == {k: [float(c) for c in v]
                          for k, v in want_count(100).items() if v},
          "window_api: count_window device Sum exact against numpy")
    part["count_window_device_sum"] = _rate(n, secs, results=len(out))
    emit({"window_api": {"device": part}})


def _rows_by(keys, win):
    """{(key, window): row indices in arrival order}."""
    out = {}
    for i, kb in enumerate(zip(keys.tolist(), win.tolist())):
        out.setdefault(kb, []).append(i)
    return {kb: np.asarray(rows) for kb, rows in out.items()}


# ---------------------------------------------------------------------
# phase 18: recovery -- checkpoints, restarts, savepoints, processing time
# ---------------------------------------------------------------------

class _Gate:
    """Shared by a recovery job's source and its failing map (class
    attributes: the operator factories deep-copy the functions).  The
    source emits up to ``hold`` records in one step and then holds the
    stream; a checkpoint whose barrier it took while holding opens the
    gate when it completes (``fail``), and the map then fails on the
    next record, once.  A savepoint's job (``fail`` False) holds until
    it is stopped."""

    hold = 0
    released = False
    held_cid = None
    reached = None
    fail = False
    failed = False
    seen = 0
    restored_offsets = []

    @classmethod
    def reset(cls, hold, fail):
        cls.hold, cls.released, cls.held_cid = hold, hold == 0, None
        cls.reached = threading.Event()
        cls.fail, cls.failed, cls.seen = fail, False, 0
        cls.restored_offsets = []


_RECOVERY_CLASSES = {}


def _recovery_classes():
    """(holding source class, failing map class), built once."""
    if not _RECOVERY_CLASSES:
        from flink_tpu_torch.core.functions import MapFunction
        from flink_tpu_torch.streaming.sources import FromCollectionSource

        class HoldingSource(FromCollectionSource):
            def emit_step(self, ctx, max_records):
                if _Gate.released or self.offset < _Gate.hold:
                    end = len(self.items) if _Gate.released else _Gate.hold
                    return super().emit_step(ctx, max(end - self.offset, 1))
                _Gate.reached.set()
                time.sleep(0.0005)
                return True

            def snapshot_function_state(self, checkpoint_id=None):
                if self.offset >= _Gate.hold and not _Gate.released \
                        and checkpoint_id is not None:
                    _Gate.held_cid = checkpoint_id
                return super().snapshot_function_state(checkpoint_id)

            def restore_function_state(self, state):
                _Gate.restored_offsets.append(state["offset"])
                super().restore_function_state(state)

            def notify_checkpoint_complete(self, checkpoint_id):
                if _Gate.fail and checkpoint_id == _Gate.held_cid:
                    _Gate.released = True

        class FailOnce(MapFunction):
            def map(self, value):
                _Gate.seen += 1
                if _Gate.fail and _Gate.released and not _Gate.failed:
                    _Gate.failed = True
                    raise RuntimeError("induced failure after a mid-stream "
                                       "checkpoint")
                return value

        _RECOVERY_CLASSES.update(source=HoldingSource, failer=FailOnce)
    return _RECOVERY_CLASSES["source"], _RECOVERY_CLASSES["failer"]


def _call_log(obj, names, log):
    """Wrap obj.<name> for each name: each call appends (seconds,
    result) to log[name].  Returns the restorer."""
    saved = {n: obj.__dict__.get(n) for n in names}

    def wrap(name, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            r = fn(*a, **kw)
            log.setdefault(name, []).append((time.perf_counter() - t0, r))
            return r
        return call

    for n in names:
        setattr(obj, n, wrap(n, getattr(obj, n)))

    def restore():
        for n, fn in saved.items():
            if fn is None:
                delattr(obj, n)
            else:
                setattr(obj, n, fn)
    return restore


def _host_bytes(obj) -> int:
    """Host bytes of a snapshot structure: numpy arrays, bytes and keyed
    snapshots' chunks."""
    if isinstance(obj, np.ndarray):
        return obj.nbytes
    if isinstance(obj, (bytes, bytearray)):
        return len(obj)
    if hasattr(obj, "total_bytes"):
        return obj.total_bytes
    if isinstance(obj, dict):
        return sum(_host_bytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_host_bytes(v) for v in obj)
    payload = getattr(obj, "payload", None)
    return _host_bytes(payload) if payload is not None else 0


def _plain_key(k):
    """A key as Python values (a composite key's row as a tuple)."""
    if isinstance(k, (np.ndarray, tuple)):
        return tuple(x.item() if hasattr(x, "item") else x for x in k)
    return k.item() if hasattr(k, "item") else k


def _recovery_job(dev, items, key_of, agg, *, fail=False, backend=None,
                  lateness=0, storage=None, savepoint_restore=None,
                  run_async=False):
    """HoldingSource -> (FailOnce) -> keyBy -> tumbling 1 s -> agg ->
    (key, window start, result) rows; (rows, result or client,
    seconds)."""
    from flink_tpu_torch.streaming.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.streaming.sources import CollectSink
    from flink_tpu_torch.streaming.windowing import TumblingEventTimeWindows
    source_cls, failer_cls = _recovery_classes()
    env = StreamExecutionEnvironment.get_execution_environment(device=dev)
    if backend is not None:
        env.set_state_backend(backend)
    if fail:
        # the first checkpoint comes at once, the next one after 1 s: at
        # the hold, since the first half of the input goes in one step
        env.enable_checkpointing(1000)
        env.set_restart_strategy("fixed_delay", restart_attempts=2, delay_ms=0)
    elif run_async:
        env.enable_checkpointing(3_600_000)     # savepoints only
    if storage is not None:
        env.set_checkpoint_storage("filesystem", directory=storage, retain=1)
    if savepoint_restore is not None:
        env.set_savepoint_restore(savepoint_restore)
    out = []
    stream = env.add_source(source_cls(items, timestamped=True), name="src")
    if fail:
        stream = stream.map(failer_cls(), name="failer")
    ws = stream.key_by(key_of).window(TumblingEventTimeWindows.of(1000))
    if lateness:
        ws = ws.allowed_lateness(lateness)
    ws.aggregate(agg, window_function=lambda k, w, vals: [
        (_plain_key(k), w.start, float(vals[0]))]).add_sink(CollectSink(out))
    t0 = time.perf_counter()
    if run_async:
        return out, env.execute_async("chip-smoke-recovery"), t0
    result = env.execute("chip-smoke-recovery")
    return out, result, time.perf_counter() - t0


def _recovery_leg(dev, name, items, key_of, make_agg, storage, log,
                  backend=None, lateness=0):
    """The job uninterrupted, then failing once after a checkpoint taken
    at half the input and restarting from it: the same rows exactly."""
    import torch
    n = len(items)
    _Gate.reset(0, False)
    clean, _, clean_s = _recovery_job(dev, items, key_of, make_agg(),
                                      backend=backend, lateness=lateness)
    torch.cuda.synchronize()
    log.clear()
    _Gate.reset(n // 2, True)
    got, result, secs = _recovery_job(dev, items, key_of, make_agg(),
                                      fail=True, backend=backend,
                                      lateness=lateness, storage=storage)
    torch.cuda.synchronize()
    check(_Gate.failed and result.restarts == 1,
          f"recovery {name}: the job failed once and restarted once")
    check(result.checkpoints_completed >= 1,
          f"recovery {name}: a checkpoint completed before the failure")
    check(_Gate.restored_offsets == [n // 2],
          f"recovery {name}: the source resumed at the checkpointed offset "
          f"{n // 2}, not at 0")
    check(sorted(got) == sorted(clean) and len(clean) > 0,
          f"recovery {name}: the output equals the uninterrupted run's exactly")
    row = {"events": n, "results": len(clean), "seconds": secs,
           "events_per_s": n / secs, "uninterrupted_seconds": clean_s,
           "uninterrupted_events_per_s": n / clean_s,
           "checkpoints_completed": result.checkpoints_completed,
           "restarts": result.restarts}
    for key, entries in log.items():
        row[f"{key}_calls"] = len(entries)
        row[f"{key}_s"] = [s for s, _ in entries]
    snaps = [r for _, r in log.get("snapshot_state", [])]
    row["snapshot_host_bytes"] = [_host_bytes(s) for s in snaps]
    device = [s for s in snaps if "device_tier" in s]
    row["device_snapshots"] = len(device)
    row["device_tiers"] = sorted({s["device_tier"] for s in device})
    row["string_key_directory_sizes"] = [len(s["string_key_directory"])
                                         for s in device
                                         if "string_key_directory" in s]
    row["checkpoint_file_bytes"] = [r for _, r in log.get("persist", [])]
    return clean, row


def recovery_phase(dev, n_events=1 << 17, n_keys=1_000_000, n_log=1 << 17,
                   n_keyed=1 << 15, keyed_keys=100_000, n_proc=1 << 15,
                   proc_keys=100_000, n_proc_job=1 << 16,
                   proc_job_keys=10_000, n_sessions=1 << 14,
                   session_keys=400, n_sample=4096):
    """Checkpoints, restarts, savepoints and processing time on the card
    through StreamExecutionEnvironment, with FsCheckpointStorage in a
    temporary directory: (1) HLL p = 12 at config #2's key space (2^17
    events over 1M users, tumbling 1 s over 2 s of timestamps) on the
    device window operator's scatter tier (integer pair keys), failing
    once after a checkpoint taken at half the input, against the
    uninterrupted run; (2) a job with string keys ("u%d", 2^17 events
    over the same users), which the operator interns onto the log tier
    (device finish); (3) HLL with allowed lateness 1 s on the GPU keyed
    backend (2^15 events, 100k keys); (4) a savepoint of (1)'s job
    through execute_async and stop_with_savepoint, restored into a fresh
    environment; (5) processing time on the GPU backend: tumbling
    windows through the test harness's clock (2^15 events, 100k keys)
    against numpy HLL, a ``processing`` job (2^16 events, 10k keys)
    flushed at the end of input against the heap backend, and
    processing-time sessions (2^14 events, 400 keys, gap 1 s) against
    the heap backend.  Each sub-part prints its events/s and seconds.
    The event counts are cut from 2^21, 2^19, 2^20, 2^18 and 2^16, and
    again to 2^17, 2^17, 2^15, 2^15 and 2^16, to keep the whole script
    well inside its time limit; the key spaces and the precision stay."""
    import shutil
    import tempfile

    import torch
    from flink_tpu_torch.ops.sketches import HyperLogLogAggregate
    from flink_tpu_torch.runtime import checkpoints as cps
    from flink_tpu_torch.streaming.device_window_operator import \
        DeviceWindowOperator
    from flink_tpu_torch.streaming.window_operator import WindowOperator

    p = 12
    rng = np.random.default_rng(18)
    users = rng.integers(0, n_keys, n_events)
    visitors = rng.integers(0, 2 ** 62, n_events)
    ts = np.sort(rng.integers(0, 2000, n_events))

    def hll():
        agg = HyperLogLogAggregate(p)
        agg.extract_value = lambda e: e[-1]
        return agg

    tmp = tempfile.mkdtemp(prefix="chip_smoke_recovery_")
    disk = shutil.disk_usage(tmp)
    emit({"recovery": {"storage": {"free_bytes": disk.free}}})
    log = {}
    restores = [_call_log(DeviceWindowOperator, ("snapshot_state",
                                                 "restore_state"), log),
                _call_log(WindowOperator, ("snapshot_state", "restore_state"),
                          log),
                _call_log(cps.FsCheckpointStorage, ("persist", "latest"), log)]
    try:
        # (1) the scatter tier at config #2's key space
        items = [((int(u) >> 10, int(u) & 1023, int(v)), int(t))
                 for u, v, t in zip(users, visitors, ts)]
        t0 = time.perf_counter()
        clean1, row = _recovery_leg(dev, "scatter", items,
                                    lambda e: (e[0], e[1]), hll,
                                    f"{tmp}/scatter", log)
        check(row["device_tiers"] == ["vectorized"]
              and not row["string_key_directory_sizes"],
              "recovery scatter: every device snapshot taken was of the "
              "scatter tier (device_tier 'vectorized')")
        row["wall_s"] = time.perf_counter() - t0
        emit({"recovery": {"scatter": row}})
        shutil.rmtree(f"{tmp}/scatter", ignore_errors=True)

        # (4) a savepoint of (1)'s job, restored in a fresh environment
        t0 = time.perf_counter()
        log.clear()
        _Gate.reset(n_events // 2, False)
        before, client, _ = _recovery_job(dev, items, lambda e: (e[0], e[1]),
                                          hll(), run_async=True)
        check(_Gate.reached.wait(600), "recovery savepoint: the job held")
        t_sp = time.perf_counter()
        path = client.stop_with_savepoint(f"{tmp}/sp", timeout=600)
        sp_s = time.perf_counter() - t_sp
        res = client.wait(600)
        check(res.cancelled and Path(path).is_file(),
              "recovery savepoint: stopped with a savepoint file")
        sp_bytes = Path(path).stat().st_size
        _Gate.reset(0, False)
        after, _, after_s = _recovery_job(dev, items, lambda e: (e[0], e[1]),
                                          hll(), savepoint_restore=path)
        torch.cuda.synchronize()
        check(sorted(before + after) == sorted(clean1),
              "recovery savepoint: the output before and after the "
              "savepoint equals the uninterrupted run's exactly")
        emit({"recovery": {"savepoint": {
            "events": n_events, "stop_with_savepoint_s": sp_s,
            "savepoint_file_bytes": sp_bytes, "resume_s": after_s,
            "restore_state_s": [s for s, _ in log.get("restore_state", [])],
            "wall_s": time.perf_counter() - t0}}})
        del items, clean1, before, after
        shutil.rmtree(f"{tmp}/sp", ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()

        # (2) string keys: interned onto the log tier
        lsel = np.sort(rng.choice(n_events, n_log, replace=False))
        items = [((f"u{u}", int(v)), int(t))
                 for u, v, t in zip(users[lsel], visitors[lsel], ts[lsel])]
        t0 = time.perf_counter()
        _, row = _recovery_leg(dev, "log", items, lambda e: e[0], hll,
                               f"{tmp}/log", log)
        check(row["device_tiers"] == ["log"]
              and len(row["string_key_directory_sizes"]) == row["device_snapshots"]
              and min(row["string_key_directory_sizes"], default=0) > 0,
              "recovery log: every device snapshot taken was of the log tier "
              "(device_tier 'log') and carried its string-key directory")
        row["wall_s"] = time.perf_counter() - t0
        emit({"recovery": {"log": row}})
        del items
        shutil.rmtree(f"{tmp}/log", ignore_errors=True)

        # (3) the GPU keyed backend (allowed lateness: WindowOperator)
        kusers = rng.integers(0, keyed_keys, n_keyed)
        kvis = rng.integers(0, 2 ** 62, n_keyed)
        kts = np.sort(rng.integers(0, 2000, n_keyed))
        items = [((int(u), int(v)), int(t)) for u, v, t in zip(kusers, kvis, kts)]
        t0 = time.perf_counter()
        _, row = _recovery_leg(dev, "gpu_backend", items, lambda e: e[0], hll,
                               f"{tmp}/keyed", log, backend="gpu",
                               lateness=1000)
        row["wall_s"] = time.perf_counter() - t0
        emit({"recovery": {"gpu_backend": row}})
        del items
    finally:
        for r in restores:
            r()
        shutil.rmtree(tmp, ignore_errors=True)

    # (5) processing time on the GPU backend
    _processing_time_parts(dev, rng, p, n_proc, proc_keys, n_proc_job,
                           proc_job_keys, n_sessions, session_keys, n_sample)


def _processing_time_parts(dev, rng, p, n_proc, proc_keys, n_proc_job,
                           proc_job_keys, n_sessions, session_keys, n_sample):
    import torch
    from flink_tpu_torch.core.keygroups import stable_hash64
    from flink_tpu_torch.core.state import AggregatingStateDescriptor
    from flink_tpu_torch.ops.sketches import HyperLogLogAggregate
    from flink_tpu_torch.streaming.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.streaming.harness import OneInputStreamOperatorTestHarness
    from flink_tpu_torch.streaming.sources import CollectSink
    from flink_tpu_torch.streaming.window_operator import WindowOperator
    from flink_tpu_torch.streaming.windowing import (
        ProcessingTimeSessionWindows, Time, TumblingProcessingTimeWindows)

    def hll():
        agg = HyperLogLogAggregate(p)
        agg.extract_value = lambda e: e[1]
        return agg

    def harness(assigner, backend):
        op = WindowOperator(assigner, AggregatingStateDescriptor("uv", hll()),
                            window_function=lambda k, w, vals: [
                                (k, w.start, float(vals[0]))])
        h = OneInputStreamOperatorTestHarness(
            op, key_selector=lambda e: e[0], state_backend=backend, device=dev)
        h.open()
        return h

    # (a) tumbling processing-time windows on the harness clock
    keys = rng.integers(0, proc_keys, n_proc)
    vis = rng.integers(0, 2 ** 62, n_proc)
    chunk = n_proc // 4
    h = harness(TumblingProcessingTimeWindows.of(1000), "gpu")
    t0 = time.perf_counter()
    for i in range(4):
        # the clock moves into window i, which fires window i - 1
        h.set_processing_time(1000 * i)
        for k, v in zip(keys[i * chunk:(i + 1) * chunk].tolist(),
                        vis[i * chunk:(i + 1) * chunk].tolist()):
            h.process_element((k, v), None)
    h.set_processing_time(4000)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    out = h.extract_output_values()
    by_window = {}
    for k, start, est in out:
        by_window.setdefault(start, {})[k] = est
    ok, worst = sorted(by_window) == [0, 1000, 2000, 3000], 0.0
    for i in range(4):
        wk = keys[i * chunk:(i + 1) * chunk]
        distinct = np.unique(wk)
        ok = ok and len(by_window.get(1000 * i, {})) == len(distinct)
        sample = np.sort(rng.choice(distinct, min(n_sample, len(distinct)),
                                    replace=False))
        sel = np.isin(wk, sample)
        vh = np.fromiter((stable_hash64(int(v)) for v in
                          vis[i * chunk:(i + 1) * chunk][sel]),
                         np.uint64, int(sel.sum()))
        want = hll_reference(np.searchsorted(sample, wk[sel]), vh, len(sample), p)
        got = np.array([by_window.get(1000 * i, {}).get(int(k), np.nan)
                        for k in sample])
        ok = ok and allclose(got, want, rtol=1e-5, atol=hll_atol(1 << p))
        worst = max(worst, float(np.nanmax(np.abs(got - want) / want)))
    check(ok, f"processing time: four tumbling windows on the harness clock, "
          f"every key once, {n_sample} sampled keys a window within rtol "
          "1e-5 (+ log slack) of numpy HLL")
    emit({"recovery": {"processing_tumbling": _rate(
        n_proc, secs, windows=len(by_window), results=len(out),
        max_rel_err_vs_numpy=worst)}})
    del h

    # (b) a "processing" job flushed at the end of input on the GPU
    # backend; the heap backend runs the same job on a sample of the
    # keys (a filter ahead of the window: the same clock, the same
    # windows), its per-record sketch updates being slow on the host
    jkeys = rng.integers(0, proc_job_keys, n_proc_job)
    jvis = rng.integers(0, 2 ** 62, n_proc_job)
    rows = list(zip(jkeys.tolist(), jvis.tolist()))
    picked = set(rng.choice(np.unique(jkeys), min(500, proc_job_keys),
                            replace=False).tolist())
    outs, secs = {}, {}
    for backend in ("gpu", "heap"):
        env = StreamExecutionEnvironment.get_execution_environment(
            device=dev if backend == "gpu" else "cpu")
        env.set_state_backend(backend)
        env.set_stream_time_characteristic("processing")
        outs[backend] = []
        stream = env.from_collection(rows)
        if backend == "heap":
            stream = stream.filter(lambda e: e[0] in picked)
        (stream.key_by(lambda e: e[0])
            .time_window(Time.seconds(1))
            .aggregate(hll(), window_function=lambda k, w, vals: [
                (k, w.start, float(vals[0]))])
            .add_sink(CollectSink(outs[backend])))
        t0 = time.perf_counter()
        env.execute("chip-smoke-processing")
        torch.cuda.synchronize()
        secs[backend] = time.perf_counter() - t0
    got = sorted(outs["gpu"])
    want = sorted(outs["heap"])
    got_picked = [r for r in got if r[0] in picked]
    check(len(got) == len(np.unique(jkeys))
          and [r[:2] for r in got_picked] == [r[:2] for r in want]
          and allclose([r[2] for r in got_picked], [r[2] for r in want],
                       rtol=1e-5, atol=hll_atol(1 << p)),
          "processing job: the end-of-input flush on the GPU backend fires "
          "every key once, equal to the heap backend on 500 sampled keys "
          "(rtol 1e-5 + log slack)")
    emit({"recovery": {"processing_job": _rate(
        n_proc_job, secs["gpu"], results=len(got), heap_seconds=secs["heap"],
        heap_keys=len(picked))}})

    # (c) processing-time sessions on the harness clock: the clock never
    # goes back, so a record extends its key's latest session and never
    # bridges two (no state merge: merge_rows has nothing to do).  The
    # heap backend takes the records of a sample of the keys at the same
    # clock
    skeys = rng.integers(0, session_keys, n_sessions)
    svis = rng.integers(0, 2 ** 62, n_sessions)
    clock = np.cumsum(rng.integers(0, 3, n_sessions))   # ms a record
    sampled = set(rng.choice(session_keys, session_keys // 10,
                             replace=False).tolist())
    souts, ssecs = {}, {}
    for backend in ("gpu", "heap"):
        h = harness(ProcessingTimeSessionWindows.with_gap(1000), backend)
        t0 = time.perf_counter()
        for k, v, now in zip(skeys.tolist(), svis.tolist(), clock.tolist()):
            h.set_processing_time(now)
            if backend == "gpu" or k in sampled:
                h.process_element((k, v), None)
        h.set_processing_time(int(clock[-1]) + 10_000)
        if backend == "gpu":
            torch.cuda.synchronize()
        ssecs[backend] = time.perf_counter() - t0
        souts[backend] = sorted(h.extract_output_values())
        del h
    got, want = souts["gpu"], souts["heap"]
    got_sampled = [r for r in got if r[0] in sampled]
    check([r[:2] for r in got_sampled] == [r[:2] for r in want]
          and len(want) > 0 and len(got) < n_sessions // 2
          and allclose([r[2] for r in got_sampled], [r[2] for r in want],
                       rtol=1e-5, atol=hll_atol(1 << p)),
          "processing-time sessions on the GPU backend grow over many "
          "records, and equal the heap backend's sessions and estimates on "
          "a tenth of the keys (rtol 1e-5 + log slack)")
    emit({"recovery": {"processing_sessions": _rate(
        n_sessions, ssecs["gpu"], sessions=len(got),
        heap_seconds=ssecs["heap"], heap_keys=len(sampled))}})


# ---------------------------------------------------------------------
# phase 17: the observability plane (tracer, telemetry, launch ledger)
# ---------------------------------------------------------------------

def _plane(on: bool) -> None:
    """Both planes on or off, their stores emptied."""
    from flink_tpu_torch.runtime import tracing as tr
    from flink_tpu_torch.runtime.device_stats import TELEMETRY
    TELEMETRY.reset()
    tr.get_tracer().reset()
    tr.reset_kernel_stats()
    TELEMETRY.enabled = on
    tr.get_tracer().enabled = on


def _ledger_leg(leg, before, secs) -> dict:
    """The launch ledger of one leg against the LAUNCHES delta: equal
    counts per kernel, every launch timed, device ms > 0 and within the
    leg's wall time."""
    from flink_tpu_torch import kernels as K
    from flink_tpu_torch.runtime import tracing as tr
    stats = tr.LAUNCH_LEDGER.stats()
    delta = {k: K.LAUNCHES[k] - before[k] for k in K.KERNELS
             if K.LAUNCHES[k] != before[k]}
    got = {k[len("cuda."):]: v["launches"] for k, v in stats.items()}
    check(got == delta and delta,
          f"telemetry {leg}: ledger launches {got} equal the LAUNCHES delta "
          f"{delta}")
    for k, v in stats.items():
        check(v["timed"] == v["launches"]
              and 0 < v["device_ms"] <= secs * 1e3,
              f"telemetry {leg}: {k} timed on every launch, device ms "
              f"{v['device_ms']} in (0, {secs * 1e3}]")
    return {k: {"launches": v["launches"], "device_ms": v["device_ms"],
                "p50_ms": v["p50_ms"], "p99_ms": v["p99_ms"]}
            for k, v in stats.items()}


def _trace_check(leg, kernels, names) -> int:
    """write_chrome_trace into a temporary directory; the file parses
    and holds a cuda.<kernel> event on the device lane for each launched
    kernel and the named events, each with ph and ts."""
    import tempfile
    from flink_tpu_torch.runtime import tracing as tr
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        written = tr.get_tracer().write_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    check(len(events) == written > 0, f"telemetry {leg}: the trace parses")
    seen = {}
    for e in events:
        seen[e["name"]] = seen.get(e["name"], 0) + 1
    bad = [e.get("name") for e in events if "ph" not in e or "ts" not in e]
    check(not bad, f"telemetry {leg}: every event has ph and ts ({bad[:3]})")
    for k in kernels:
        dev_ev = [e for e in events if e["name"] == k]
        check(dev_ev and all(e.get("lane") == "device" for e in dev_ev),
              f"telemetry {leg}: {k} events on the device lane")
    for n in names:
        check(seen.get(n, 0) > 0, f"telemetry {leg}: {n} in the trace")
    return len(events)


def _telemetry_job(dev, events, key_of, p, snap):
    """HLL p over 1 s tumbling windows through the environment; the first
    fired window takes the HBM snapshot while the engine is alive."""
    from flink_tpu_torch.ops.sketches import HyperLogLogAggregate
    from flink_tpu_torch.runtime.device_stats import TELEMETRY
    from flink_tpu_torch.streaming.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.streaming.sources import (
        BoundedOutOfOrdernessTimestampExtractor, CollectSink)
    from flink_tpu_torch.streaming.windowing import TumblingEventTimeWindows

    def window_fn(k, w, vals):
        if snap is not None and not snap:
            snap["hbm"] = TELEMETRY.hbm_snapshot()
            snap["framework"] = TELEMETRY.framework_hbm()
        return [(_key_id(k), w.start, vals[0])]

    agg = HyperLogLogAggregate(p)
    agg.extract_value = lambda e: e[1]
    out = []
    env = StreamExecutionEnvironment.get_execution_environment(device=dev)
    (env.from_collection(events)
        .assign_timestamps_and_watermarks(
            BoundedOutOfOrdernessTimestampExtractor(0, lambda e: e[2]))
        .key_by(key_of).window(TumblingEventTimeWindows.of(1000))
        .aggregate(agg, window_function=window_fn)
        .add_sink(CollectSink(out)))
    torch_sync()
    t0 = time.perf_counter()
    env.execute("telemetry")
    torch_sync()
    return out, time.perf_counter() - t0, env.get_metric_registry().dump()


def torch_sync() -> None:
    import torch
    torch.cuda.synchronize()


def _fresh_chain_split(leg, n_chain, n_keys, batch, seed) -> dict:
    """``_chain_profile_leg`` with the profiler, in a spawned worker:
    the ledger's d2h.chain.boundary bytes must equal the profiler's
    DtoH bytes there."""
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(1) as pool:
        fresh = pool.apply(_chain_profile_leg,
                           ("cuda", n_chain, n_keys, batch, True, seed, leg))
    check(fresh["device_events"] > 0
          and fresh["ledger_d2h_bytes"] == fresh["profiler_d2h_bytes"] > 0,
          f"{leg}: ledger D2H bytes {fresh['ledger_d2h_bytes']} equal the "
          f"profiler's DtoH bytes {fresh['profiler_d2h_bytes']}")
    return fresh


def _chain_profile_leg(dev, n_chain, n_keys, batch, profile, seed=43,
                       leg="telemetry chain"):
    """The fused chain's route mode on n_chain config #2 events (drawn
    first from ``seed``): a first pass (the program verifies), then,
    with the plane on, one pass (under torch.profiler when
    ``profile``).  Returns the ledger's chain.boundary copies and the
    profiler's split.  Also runs in a spawned worker, which sets
    itself up."""
    import torch
    if profile:
        sys.path.insert(0, str(ROOT))
    from flink_tpu_torch import kernels as K
    K.build_all(("chain_route",))
    from flink_tpu_torch.runtime.device_stats import TELEMETRY
    from flink_tpu_torch.streaming import chain_fusion as cf
    from flink_tpu_torch.streaming.elements import RecordBatch
    dev = torch.device(dev) if isinstance(dev, str) else dev
    keys, ts, vh = config2_events(np.random.default_rng(seed), n_chain, n_keys)
    f0, f1 = keys.astype(np.int64), (vh >> np.uint64(3)).astype(np.int64)
    batches = [RecordBatch({"f0": f0[i:i + batch], "f1": f1[i:i + batch]},
                           ts[i:i + batch]) for i in range(0, n_chain, batch)]
    fused = _KeyRouter(4)
    m2, f2 = _chain_ops(fused)
    prog = cf.compile_chain([m2, f2], router=fused, device=dev)
    check(prog is not None, f"{leg}: route mode compiled")
    _plane(False)
    for b in batches:              # the first pass verifies the program
        prog.run(b)
    _plane(True)
    before = dict(K.LAUNCHES)

    def chain_pass():
        for b in batches:
            prog.run(b)
    out = {"batches": len(batches)}
    if profile:
        split = _device_split(chain_pass)
        out.update(profiler_d2h_bytes=split["d2h_bytes"],
                   profiler_d2h_ms=(split["device_ms"] or {}).get("d2h"),
                   wall_ms=split["wall_ms"], idle_share=split["idle_share"],
                   device_events=split["device_events"],
                   device_ms=split["device_ms"])
    else:
        t0 = time.perf_counter()
        chain_pass()
        torch.cuda.synchronize()
        out["wall_ms"] = (time.perf_counter() - t0) * 1e3
    out["kernels"] = _ledger_leg(leg, before, out["wall_ms"] / 1e3)
    check(set(out["kernels"]) == {"cuda.chain_route"},
          f"{leg}: only chain_route launched ({set(out['kernels'])})")
    pay = TELEMETRY.payload()
    d2h = pay["transfers"]["d2h.chain.boundary"]
    check(pay["kernels"][prog.label]["dispatches"] == len(batches),
          f"{leg}: one dispatch of the program's label a batch")
    out.update(ledger_d2h_bytes=d2h["bytes"], ledger_d2h_ms=d2h["total_ms"],
               ledger_h2d=pay["transfers"]["h2d.chain.boundary"])
    return out


def telemetry_phase(dev, n_scatter=1 << 17, n_log=1 << 17, n_chain=1 << 21,
                    n_keys=1_000_000, batch=1 << 20, p=12):
    """The observability plane on the card: (a) config #2's events
    (2^17, keys as (key, key >> 10) pairs, which take the scatter tier)
    through the environment with the tracer and the telemetry off, then
    on: bit-equal windows, the off run records nothing; (b) 2^17
    integer-key events on the log tier with the device finish; (c) the
    fused chain's route mode on 2^21 events, traced by torch.profiler
    with the plane on: the ledger's chain.boundary D2H bytes are the
    profiler's DtoH bytes."""
    import torch
    from flink_tpu_torch import kernels as K
    from flink_tpu_torch.runtime import tracing as tr
    from flink_tpu_torch.runtime.device_stats import TELEMETRY

    rng = np.random.default_rng(41)
    tracer = tr.get_tracer()
    out = {}
    try:
        # (a) the scatter tier, off then on
        keys, ts, vh = config2_events(rng, n_scatter, n_keys)
        events = list(zip(keys.astype(np.int64).tolist(),
                          (vh >> np.uint64(1)).astype(np.int64).tolist(),
                          ts.tolist()))
        pair = lambda e: (e[0], e[0] >> 10)  # noqa: E731
        runs = {}
        for on in (False, True):
            _plane(on)
            before = dict(K.LAUNCHES)
            snap = {} if on else None
            res, secs, dump = _telemetry_job(dev, events, pair, p, snap)
            runs[on] = (sorted(res), secs)
            if not on:
                check(tracer.recent() == [] and tracer.stats() == {}
                      and TELEMETRY.payload()["transfers"] == {}
                      and tr.LAUNCH_LEDGER.stats() == {},
                      "telemetry scatter: the off run leaves the tracer, the "
                      "transfer ledger and the launch ledger empty")
                continue
            kernels = _ledger_leg("scatter", before, secs)
            for k in ("hll_update", "hll_estimate", "clear_rows"):
                check(f"cuda.{k}" in kernels, f"telemetry scatter: {k} ledgered")
            n_trace = _trace_check("scatter", kernels, (
                "device_window.flush", "device_window.fire", "device.transfer"))
            hbm, fw = snap["hbm"], snap["framework"]
            check(hbm["source"] == "memory_stats"
                  and hbm["bytes_in_use"] >= fw["bytes_in_use"] > 0,
                  f"telemetry scatter: HBM from memory_stats, in use "
                  f"{hbm['bytes_in_use']} >= the framework's "
                  f"{fw['bytes_in_use']} > 0")
            rec_in = sum(v for k, v in dump.items()
                         if "window_aggregate" in k and k.endswith(".numRecordsIn"))
            late = sum(v for k, v in dump.items()
                       if k.endswith(".numLateRecordsDropped"))
            check(rec_in == n_scatter and late == 0,
                  f"telemetry scatter: numRecordsIn {rec_in} == the events "
                  f"fed, numLateRecordsDropped {late} == 0")
            pay = TELEMETRY.payload()
            out["scatter"] = {
                "events": n_scatter, "windows": len(res),
                "trace_events": n_trace, "kernels": kernels,
                "transfers": pay["transfers"], "hbm": hbm,
                "framework_hbm_bytes": fw["bytes_in_use"]}
        check(runs[True][0] == runs[False][0] and len(runs[True][0]) > 0,
              "telemetry scatter: windows bit-equal with the plane on and off")
        out["scatter"]["events_per_s_off"] = n_scatter / runs[False][1]
        out["scatter"]["events_per_s_on"] = n_scatter / runs[True][1]
        out["scatter"]["seconds_off"] = runs[False][1]
        out["scatter"]["seconds_on"] = runs[True][1]
        del events, runs

        # (b) the log tier with the device finish
        keys, ts, vh = config2_events(rng, n_log, n_keys)
        events = list(zip(keys.astype(np.int64).tolist(),
                          (vh >> np.uint64(1)).astype(np.int64).tolist(),
                          ts.tolist()))
        _plane(True)
        before = dict(K.LAUNCHES)
        res, secs, dump = _telemetry_job(dev, events, lambda e: e[0], p, None)
        kernels = _ledger_leg("log", before, secs)
        check("cuda.hll_log_finish" in kernels,
              "telemetry log: the device finish (hll_log_finish) ledgered")
        pay = TELEMETRY.payload()
        check(pay["transfers"].get("d2h.log.finish", {}).get("count", 0) > 0,
              "telemetry log: the finish's copies ledgered under log.finish")
        _trace_check("log", kernels, ("device_window.fire",))
        out["log"] = {"events": n_log, "windows": len(res), "seconds": secs,
                      "events_per_s": n_log / secs, "kernels": kernels,
                      "transfers": pay["transfers"]}
        del events

        # (c) the fused chain's route mode: the ledger against LAUNCHES
        # here, against torch.profiler in a fresh process (a profile
        # taken late in a long process lost memcpy records on the card)
        ledger = _chain_profile_leg(dev, n_chain, n_keys, batch, profile=False)
        fresh = _fresh_chain_split("telemetry chain", n_chain, n_keys, batch,
                                   seed=43)
        check(ledger["ledger_d2h_bytes"] == fresh["ledger_d2h_bytes"],
              "telemetry chain: the same pass ledgers the same D2H bytes in "
              "both processes")
        out["chain"] = {"events": n_chain, "this_process": ledger,
                        "profiled": fresh}
    finally:
        _plane(False)
    gc.collect()
    torch.cuda.empty_cache()
    emit({"telemetry": out})


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
# ---------------------------------------------------------------------
# the sql path: the Table API and SQL, BASELINE config #5
# ---------------------------------------------------------------------

def config5_events(n, n_keys, seed=13):
    """Config #5's recipe (``bench.py``'s ``synth(n, n_keys, 1000)``):
    uniform uint64 keys, sorted timestamps in one second, uint64
    users."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n_keys, n).astype(np.uint64)
    ts = np.sort(rng.integers(0, 1000, n).astype(np.int64))
    users = rng.integers(0, 2 ** 63, n).astype(np.uint64)
    return keys, ts, users


CONFIG5_SQL = ("SELECT k, APPROX_COUNT_DISTINCT(u) AS d "
               "FROM ev GROUP BY TUMBLE(ts, INTERVAL '1' SECOND), k")


def _launch_delta(before) -> dict:
    from flink_tpu_torch import kernels as K
    return {k: K.LAUNCHES[k] - before[k] for k in before
            if K.LAUNCHES[k] != before[k]}


def _sql_run(dev, cols, sql, chunk, rowtime="ts", parallelism=1, mesh=None,
             tables=None):
    """One SQL query over columnar tables through
    ``StreamTableEnvironment`` on the card: (the result table, its
    batches' columns concatenated, seconds of env.execute, launches of
    the run, the engines its window operators built)."""
    import torch
    from flink_tpu_torch import kernels as K
    from flink_tpu_torch.streaming import columnar as col
    from flink_tpu_torch.streaming.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.table import StreamTableEnvironment
    env = StreamExecutionEnvironment.get_execution_environment(device=dev)
    env.set_parallelism(parallelism)
    if mesh is not None:
        env.set_mesh(mesh)
    t_env = StreamTableEnvironment.create(env)
    for name, (tcols, rt) in (tables or {"ev": (cols, rowtime)}).items():
        t_env.register_table(name, t_env.from_columns(tcols, rowtime=rt,
                                                      chunk=chunk))
    out = t_env.sql_query(sql)
    sink = col.ColumnarCollectSink()
    out.to_append_stream(batched=True).add_sink(sink)
    engines = []
    make = col.ColumnarWindowOperator._make_engine

    def noted(op, key_dtype, require_log=False):
        eng = make(op, key_dtype, require_log)
        mode = getattr(eng, "mode", None)
        engines.append((type(eng).__name__,
                        getattr(mode, "finish_tier", None)))
        return eng
    col.ColumnarWindowOperator._make_engine = noted
    before = dict(K.LAUNCHES)
    try:
        t0 = time.perf_counter()
        env.execute("chip-smoke-sql")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        col.ColumnarWindowOperator._make_engine = make
    names = list(sink.batches[0].cols) if sink.batches else []
    got = {n: np.concatenate([np.asarray(b.cols[n]) for b in sink.batches])
           for n in names}
    return out, got, secs, _launch_delta(before), engines


def _keyed_estimates(keys, est):
    order = np.argsort(keys, kind="stable")
    return keys[order], np.asarray(est, np.float64)[order]


def _distinct_counts(groups, values):
    """(sorted groups, distinct values of each) by one lexsort."""
    order = np.lexsort((values, groups))
    g, v = groups[order], values[order]
    new = np.ones(len(g), bool)
    new[1:] = (g[1:] != g[:-1]) | (v[1:] != v[:-1])
    starts = np.ones(len(g), bool)
    starts[1:] = g[1:] != g[:-1]
    return g[starts], np.add.reduceat(new.astype(np.int64),
                                      np.flatnonzero(starts))


def _hll_bound(exact, m):
    """4 standard errors of HLL at m registers (1.04 / sqrt(m)), plus 3
    counts: at a few distinct values a key (config #5 has ~8) the
    estimate is linear counting, which loses one count per register two
    values share; three such collisions in one key have a probability
    below 1e-4 at the largest keys of the run."""
    return 4 * 1.04 / np.sqrt(m) * exact + 3.0


def _sql_config5(dev, n, n_keys, chunk, n_sample, p, m):
    """(a): config #5's query at the reference's size on the columnar
    plan, against the DataStream job on the events of sampled keys and
    the exact distinct counts of every key."""
    from flink_tpu_torch.ops.sketches import HyperLogLogAggregate
    from flink_tpu_torch.streaming.windowing import TumblingEventTimeWindows
    keys, ts, users = config5_events(n, n_keys)
    out, got, secs, launched, engines = _sql_run(
        dev, {"k": keys, "u": users, "ts": ts}, CONFIG5_SQL, chunk)
    check(bool(getattr(out, "columnar", False))
          and out.stream.node.name == "columnar_window_agg",
          "sql (a): config #5 lowers to the columnar plan")
    check(engines == [("LogStructuredTumblingWindows", "device")],
          f"sql (a): the engine is the log tier with the device finish ({engines})")
    check(launched.get("hll_log_finish", 0) > 0,
          f"sql (a): hll_log_finish launched ({launched})")
    gk, gd = _keyed_estimates(got["k"], got["d"])
    uk, exact = _distinct_counts(keys, users)
    check(np.array_equal(gk, uk), f"sql (a): one row per key ({len(gk)})")
    err = np.abs(gd - exact)
    check(bool((err <= _hll_bound(exact, m)).all()),
          "sql (a): every estimate within 4 HLL standard errors (+ 3) of the "
          f"exact distinct count (worst {float(err.max()):.3f})")
    # sampled keys: numpy HLL of their users, and the DataStream job
    # key_by().window(1 s).aggregate(HLL 12) on their events
    rng = np.random.default_rng(14)
    sample = np.sort(rng.choice(uk, n_sample, replace=False))
    sel = np.isin(keys, sample)
    pos = np.searchsorted(gk, sample)
    want = hll_reference(np.searchsorted(sample, keys[sel]),
                         splitmix64_np(users[sel]), n_sample, p)
    check(allclose(gd[pos], want, rtol=1e-5, atol=hll_atol(m)),
          f"sql (a): {n_sample} sampled keys equal numpy HLL of their users")
    events = list(zip(keys[sel].tolist(), users[sel].tolist(),
                      ts[sel].tolist()))
    agg = HyperLogLogAggregate(p)
    agg.extract_value = lambda e: e[1]
    ds_rows, ds_s = _api_job(
        dev, events, lambda s: s.key_by(lambda e: e[0])
        .window(TumblingEventTimeWindows.of(1000))
        .aggregate(agg, lambda k, w, r: [(k, float(r[0]))]))
    dk = np.array([k for k, _ in ds_rows], np.uint64)
    dd = np.array([d for _, d in ds_rows], np.float64)
    dk, dd = _keyed_estimates(dk, dd)
    check(np.array_equal(dk, sample)
          and allclose(gd[pos], dd, rtol=1e-6, atol=hll_atol(m)),
          f"sql (a): {n_sample} sampled keys equal to the DataStream job "
          "(rtol 1e-6 + log slack)")
    return {"events": n, "keys": n_keys, "chunk": chunk, "rows": int(len(gk)),
            "execute_s": secs, "events_per_s": n / secs,
            "engines": engines, "launches": launched,
            "max_rel_err": float((err / exact).max()),
            "datastream_sample_events": int(sel.sum()),
            "datastream_sample_s": ds_s}


def _np_sessions(keys, ts, gap):
    """Sessions by key: a new one where the key changes or the next event
    is more than ``gap`` after the last; (order, session id per sorted
    event, session keys, starts, ends)."""
    order = np.lexsort((ts, keys))
    k, t = keys[order], ts[order]
    new = np.ones(len(k), bool)
    new[1:] = (k[1:] != k[:-1]) | (t[1:] - t[:-1] > gap)
    sid = np.cumsum(new) - 1
    starts = t[new]
    last = np.ones(len(k), bool)
    last[:-1] = new[1:]
    ends = t[last] + gap
    return order, sid, k[new], starts, ends


def _sql_session(dev, n, n_keys, span, gap, chunk, n_sample, p, m):
    """(b): SESSION on the columnar plan, which falls back to
    VectorizedSessionWindows on the card, against numpy's exact sessions
    and distinct counts.  Timestamps are multiples of 3, so no two
    events of a key are exactly a gap apart."""
    rng = np.random.default_rng(15)
    keys = rng.integers(0, n_keys, n).astype(np.int64)
    ts = np.sort(3 * rng.integers(0, span // 3, n)).astype(np.int64)
    users = rng.integers(0, 2 ** 63, n).astype(np.uint64)
    sql = ("SELECT k, APPROX_COUNT_DISTINCT(u) AS d, SESSION_START(ts) AS s0, "
           "SESSION_END(ts) AS s1 FROM ev "
           f"GROUP BY SESSION(ts, INTERVAL '{gap}' MILLISECOND), k")
    out, got, secs, launched, engines = _sql_run(
        dev, {"k": keys, "u": users, "ts": ts}, sql, chunk)
    check(bool(getattr(out, "columnar", False)),
          "sql (b): SESSION stays on the columnar plan")
    check([e for e, _ in engines] == ["VectorizedSessionWindows"],
          f"sql (b): the engine is VectorizedSessionWindows ({engines})")
    order, sid, sk, s0, s1 = _np_sessions(keys, ts, gap)
    g = np.lexsort((got["s0"], got["k"]))
    gk, g0, g1 = got["k"][g], got["s0"][g], got["s1"][g]
    gd = np.asarray(got["d"], np.float64)[g]
    check(np.array_equal(gk, sk) and np.array_equal(g0, s0)
          and np.array_equal(g1, s1),
          f"sql (b): the {len(sk)} sessions equal numpy's exactly")
    vh = splitmix64_np(users[order])
    _, exact = _distinct_counts(sid, users[order])
    err = np.abs(gd - exact)
    check(bool((err <= _hll_bound(exact, m)).all()),
          "sql (b): every session's estimate within 4 HLL standard errors "
          "(+ 3) of its exact distinct count")
    pick = np.sort(np.random.default_rng(16).choice(len(sk), n_sample,
                                                    replace=False))
    sel = np.isin(sid, pick)
    want = hll_reference(np.searchsorted(pick, sid[sel]), vh[sel], n_sample, p)
    check(allclose(gd[pick], want, rtol=1e-5, atol=hll_atol(m)),
          f"sql (b): {n_sample} sessions equal numpy HLL of their users")
    for kname in ("hll_update", "merge_rows", "hll_estimate"):
        check(launched.get(kname, 0) > 0, f"sql (b): {kname} launched ({launched})")
    return {"events": n, "keys": n_keys, "span_ms": span, "gap_ms": gap,
            "sessions": int(len(sk)), "execute_s": secs,
            "events_per_s": n / secs, "engines": engines,
            "launches": launched}


def _sql_mesh_and_parallel(dev, n, n_keys, chunk, m):
    """(c) config #5 on 8 virtual shards with env.set_mesh (the mesh log
    tier) and (d) at parallelism 2 (the split exchange), each against
    the meshless run at parallelism 1 on the same events."""
    from flink_tpu_torch.parallel.mesh import Mesh
    keys, ts, users = config5_events(n, n_keys, seed=17)
    cols = {"k": keys, "u": users, "ts": ts}
    runs = {}
    for leg, kw in (("single", {}), ("mesh", {"mesh": Mesh([dev] * 8)}),
                    ("parallel2", {"parallelism": 2})):
        out, got, secs, launched, engines = _sql_run(dev, cols, CONFIG5_SQL,
                                                     chunk, **kw)
        check(bool(getattr(out, "columnar", False)),
              f"sql ({leg}): the plan is columnar")
        gk, gd = _keyed_estimates(got["k"], got["d"])
        runs[leg] = (gk, gd, {"execute_s": secs, "events_per_s": n / secs,
                              "engines": engines, "launches": launched,
                              "rows": int(len(gk))})
    gk, gd, _ = runs["single"]
    for leg in ("mesh", "parallel2"):
        lk, ld, _ = runs[leg]
        check(np.array_equal(lk, gk) and allclose(ld, gd, rtol=1e-6,
                                                   atol=hll_atol(m)),
              f"sql ({leg}): rows equal the meshless run at parallelism 1")
    mesh_info = runs["mesh"][2]
    check([e for e, _ in mesh_info["engines"]] == ["MeshLogTumblingWindows"],
          f"sql (mesh): the engine is the mesh log tier ({mesh_info['engines']})")
    for kname in ("shard_pack", "hll_log_finish"):
        check(mesh_info["launches"].get(kname, 0) > 0,
              f"sql (mesh): {kname} launched ({mesh_info['launches']})")
    par = runs["parallel2"][2]
    check(len(par["engines"]) == 2 and par["launches"].get("hll_log_finish", 0) > 0,
          f"sql (parallel2): two subtasks' log tiers, device finish ({par})")
    return {"events": n, "keys": n_keys, **{leg: r[2] for leg, r in runs.items()}}


def _sql_join(dev, n_each, n_keys, bound_ms, span_ms, chunk, n_sample):
    """(e): the columnar interval join at bench_sql_join's size against
    an independent numpy join (sort by key and time, searchsorted)."""
    rng = np.random.default_rng(23)
    lk = rng.integers(0, n_keys, n_each).astype(np.uint64)
    lts = np.sort(rng.integers(0, span_ms, n_each).astype(np.int64))
    rk = rng.integers(0, n_keys, n_each).astype(np.uint64)
    rts = np.sort(rng.integers(0, span_ms, n_each).astype(np.int64))
    sql = ("SELECT a.lid, b.rid FROM l AS a JOIN r AS b "
           f"ON a.k = b.rk AND a.ts BETWEEN b.rts - INTERVAL '{bound_ms}' "
           f"MILLISECOND AND b.rts + INTERVAL '{bound_ms}' MILLISECOND")
    tables = {"l": ({"lid": np.arange(n_each), "k": lk, "ts": lts}, "ts"),
              "r": ({"rid": np.arange(n_each), "rk": rk, "rts": rts}, "rts")}
    out, got, secs, launched, _ = _sql_run(dev, None, sql, chunk,
                                           tables=tables)
    names = [nd.name for nd in out.stream.env.graph.nodes.values()]
    check(bool(getattr(out, "columnar", False))
          and "columnar_interval_join" in names,
          f"sql (e): the join lowers to the columnar interval join ({names})")
    # numpy: right rows sorted by (key, time); each left row's range
    comp = (rk.astype(np.int64) << 20) | rts
    r_order = np.argsort(comp, kind="stable")
    sc = comp[r_order]
    lkey = lk.astype(np.int64) << 20
    lo = np.searchsorted(sc, lkey | np.maximum(lts - bound_ms, 0), "left")
    hi = np.searchsorted(sc, lkey | (lts + bound_ms), "right")
    n_pairs = int((hi - lo).sum())
    lid, rid = got.get("lid", np.empty(0)), got.get("rid", np.empty(0))
    check(len(lid) == n_pairs and n_pairs > 0,
          f"sql (e): {len(lid)} pairs, numpy's join {n_pairs}")
    sample = np.sort(np.random.default_rng(24).choice(n_each, n_sample,
                                                      replace=False))
    want = sorted((int(i), int(r)) for i in sample
                  for r in r_order[lo[i]:hi[i]])
    sel = np.isin(lid, sample)
    have = sorted(zip(lid[sel].tolist(), rid[sel].tolist()))
    check(have == want, f"sql (e): the pairs of {n_sample} sampled left rows "
          "equal numpy's")
    check(not launched, f"sql (e): host C++ only, no kernel ({launched})")
    return {"rows_each": n_each, "keys": n_keys, "bound_ms": bound_ms,
            "span_ms": span_ms, "pairs": n_pairs, "execute_s": secs,
            "rows_per_s": 2 * n_each / secs}


def _sql_process_function(dev, n, n_keys, span, n_sample, p, m):
    """(f): a keyed process function on the GPU backend holding an
    AggregatingState of HyperLogLogAggregate(12), emitting each key's
    estimate at an event-time timer at each second's end and clearing
    it, against the same job on the heap backend on the events of
    sampled keys."""
    import torch
    from flink_tpu_torch import kernels as K
    from flink_tpu_torch.core.state import AggregatingStateDescriptor
    from flink_tpu_torch.streaming.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.streaming.sources import (
        BoundedOutOfOrdernessTimestampExtractor, CollectSink)
    from flink_tpu_torch.ops.sketches import HyperLogLogAggregate
    from flink_tpu_torch.state.gpu_backend import DeviceAggregatingState
    from flink_tpu_torch.streaming.operators import ProcessFunction
    rng = np.random.default_rng(25)
    events = list(zip(rng.integers(0, n_keys, n).tolist(),
                      rng.integers(0, 1 << 40, n).tolist(),
                      np.sort(rng.integers(0, span, n)).tolist()))
    kinds = set()

    class DistinctPerSecond(ProcessFunction):
        desc = AggregatingStateDescriptor("users", HyperLogLogAggregate(p))

        def process_element(self, value, ctx, out):
            st = ctx.get_state(self.desc)
            kinds.add(type(st).__name__)
            st.add(value[1])
            ctx.register_event_time_timer(value[2] - value[2] % 1000 + 999)

        def on_timer(self, timestamp, ctx, out):
            st = ctx.get_state(self.desc)
            out.collect((ctx.get_current_key(), timestamp, float(st.get())))
            st.clear()

    sample = set(np.random.default_rng(26).choice(n_keys, n_sample,
                                                  replace=False).tolist())
    res = {}
    for backend in ("gpu", "heap"):
        # a watermark after every record: a second's timer fires before
        # the next second's first record reaches the state.  The heap
        # backend (a Python HLL a record) sees the sampled keys only,
        # filtered after the timestamps so the watermarks are the same
        env = StreamExecutionEnvironment.get_execution_environment(device=dev)
        env.set_state_backend(backend)
        rows = []
        stream = env.from_collection(events).assign_timestamps_and_watermarks(
            BoundedOutOfOrdernessTimestampExtractor(0, lambda e: e[2]))
        if backend == "heap":
            stream = stream.filter(lambda e: e[0] in sample)
        (stream.key_by(lambda e: e[0]).process(DistinctPerSecond())
            .add_sink(CollectSink(rows)))
        before = dict(K.LAUNCHES)
        t0 = time.perf_counter()
        env.execute("chip-smoke-sql-process")
        torch.cuda.synchronize()
        res[backend] = (sorted(rows), time.perf_counter() - t0,
                        _launch_delta(before))
    (g, g_s, g_l), (h, h_s, _) = res["gpu"], res["heap"]
    check(DeviceAggregatingState.__name__ in kinds,
          f"sql (f): the GPU backend gave the process function its device state ({kinds})")
    gs = [r for r in g if r[0] in sample]
    check([r[:2] for r in gs] == [r[:2] for r in h] and len(h) > 0,
          f"sql (f): the same {len(h)} (key, second) timers of {n_sample} "
          f"sampled keys fired on both backends ({len(g)} in all)")
    check(allclose([r[2] for r in gs], [r[2] for r in h], rtol=1e-5,
                   atol=hll_atol(m)),
          "sql (f): GPU backend estimates equal the heap backend's on the "
          "sampled keys (rtol 1e-5 + log slack)")
    n_ticks = span // 1000
    check(len(g) == len({(e[0], e[2] // 1000) for e in events})
          and len(g) <= n_keys * n_ticks,
          f"sql (f): one estimate a (key, second) with events ({len(g)})")
    for kname in ("hll_update", "hll_estimate"):
        check(g_l.get(kname, 0) > 0, f"sql (f): {kname} launched ({g_l})")
    return {"events": n, "keys": n_keys, "timers": len(g),
            "sampled_keys": n_sample, "sampled_timers": len(h),
            "gpu_s": g_s, "heap_s": h_s, "gpu_events_per_s": n / g_s,
            "launches": g_l}


def sql_phase(dev, n_config5=1 << 22, config5_keys=500_000,
              config5_chunk=1 << 19, n_session=1 << 19, session_keys=100_000,
              n_mesh=1 << 20, n_join=1 << 21, join_keys=100_000,
              n_process=1 << 16, process_keys=10_000, n_process_sample=500,
              n_sample=4096):
    """The Table API and SQL on the card: (a) BASELINE config #5 on the
    columnar plan at the reference's size; (b) SESSION with
    APPROX_COUNT_DISTINCT on the columnar plan (VectorizedSessionWindows);
    (c) config #5 with env.set_mesh on 8 virtual shards and (d) at
    parallelism 2; (e) the columnar interval join; (f) a keyed process
    function with an HLL AggregatingState on the GPU backend, against
    the heap backend on 500 sampled keys."""
    from flink_tpu_torch.ops import link_probe
    p = 12
    m = 1 << p
    link_probe.measure(dev)        # once per process, outside the timings
    out = {"config5": _sql_config5(dev, n_config5, config5_keys,
                                   config5_chunk, n_sample, p, m)}
    out["session"] = _sql_session(dev, n_session, session_keys, 30_000, 1000,
                                  1 << 18, n_sample, p, m)
    out["mesh_parallel"] = _sql_mesh_and_parallel(dev, n_mesh, config5_keys,
                                                  config5_chunk, m)
    out["join"] = _sql_join(dev, n_join, join_keys, 500, 60_000, 1 << 20,
                            1024)
    out["process_function"] = _sql_process_function(
        dev, n_process, process_keys, 4000, n_process_sample, p, m)
    emit({"sql": out})


# ---- the sources path: config #1 from a socket, a threaded source and
# the replayable log, each failing once and restarting ------------------

_SOURCES_CLASSES = {}


class _Hold:
    """Shared by leg (b)'s source and its failing sink (class
    attributes: the source's factory copies the function).  The source
    holds at ``hold`` records until a checkpoint whose barrier it took
    there completes; the sink then fails at its next row, once."""

    hold = 0
    held_cid = None
    released = False
    failed = False
    fail = False
    restored_offsets = []
    #: checkpoint id -> the offset the source snapshotted for it
    snapshot_offsets = {}

    @classmethod
    def reset(cls, hold, fail):
        cls.hold, cls.held_cid = hold, None
        cls.released, cls.failed, cls.fail = not fail, False, fail
        cls.restored_offsets = []
        cls.snapshot_offsets = {}


def _sources_classes():
    """The user functions of the sources path, built once."""
    if _SOURCES_CLASSES:
        return _SOURCES_CLASSES
    from flink_tpu_torch.core.functions import MapFunction
    from flink_tpu_torch.streaming.elements import RecordBatch, Watermark
    from flink_tpu_torch.streaming.sources import SinkFunction, SourceFunction
    from flink_tpu_torch.streaming.two_phase import TransactionalCollectSink

    class WordTotals(SinkFunction):
        """(word, window start, count) rows: per-word totals, windows
        fired, and ``done`` once ``expect`` words were counted."""

        def __init__(self, expect):
            self.expect = expect
            self.totals = {}
            self.rows = 0
            self.total = 0.0
            self.done = threading.Event()

        def invoke(self, value, context=None):
            word, _start, count = value
            self.totals[word] = self.totals.get(word, 0.0) + count
            self.rows += 1
            self.total += count
            if self.total >= self.expect:
                self.done.set()

    class BlockingEvents(SourceFunction):
        """Leg (b)'s source: run() only (a thread of its own), over
        (key, user, ts) columns.  Its read position lives in operator
        list state, reached through ``initialize_state``; each
        RecordBatch of ``batch`` rows, the position and a watermark go
        out inside the checkpoint lock."""

        def __init__(self, keys, users, ts, batch=1024):
            self.keys, self.users, self.ts = keys, users, ts
            self.batch = batch
            self._op = None
            self._cancelled = False

        def initialize_state(self, op):
            self._op = op

        def run(self, ctx):
            state = self._op.operator_state_backend.get_list_state("offset")
            offset = (state.get() or [0])[0]
            _Hold.restored_offsets.append(offset)
            lock = ctx.get_checkpoint_lock()
            n = len(self.ts)
            while offset < n and not self._cancelled:
                if not _Hold.released and offset >= _Hold.hold:
                    time.sleep(0.001)       # held, outside the lock
                    continue
                end = min(n, offset + self.batch)
                if not _Hold.released:
                    end = min(end, _Hold.hold)
                sl = slice(offset, end)
                with lock:
                    ctx.collect_batch(RecordBatch(
                        {"f0": self.keys[sl], "f1": self.users[sl]},
                        ts=self.ts[sl]))
                    ctx.emit_watermark(Watermark(int(self.ts[end - 1]) - 1))
                    offset = end
                    state.update([offset])

        def cancel(self):
            self._cancelled = True

        def snapshot_function_state(self, checkpoint_id=None):
            offset = (self._op.operator_state_backend
                      .get_list_state("offset").get() or [0])[0]
            if checkpoint_id is not None:
                _Hold.snapshot_offsets[checkpoint_id] = offset
            if (_Hold.fail and not _Hold.released and checkpoint_id is not None
                    and offset >= _Hold.hold):
                _Hold.held_cid = checkpoint_id
            return {}

        def notify_checkpoint_complete(self, checkpoint_id):
            if _Hold.fail and checkpoint_id == _Hold.held_cid:
                _Hold.released = True

    class FailAfterHoldSink(TransactionalCollectSink):
        def invoke(self, value, context=None):
            if _Hold.fail and _Hold.released and not _Hold.failed:
                _Hold.failed = True
                raise RuntimeError("induced failure after the held checkpoint")
            super().invoke(value, context)

    class FailAfterHalf(MapFunction):
        """Leg (c)'s failure: once a checkpoint completes after half of
        the input went through, the next record fails, once (class
        attributes: four subtasks share them)."""

        half = 0
        seen = 0
        armed = False
        failed = False
        fail = False

        def notify_checkpoint_complete(self, checkpoint_id):
            cls = type(self)
            if cls.fail and cls.seen >= cls.half:
                cls.armed = True

        def map(self, value):
            cls = type(self)
            cls.seen += 1
            if cls.armed and not cls.failed:
                cls.failed = True
                raise RuntimeError("induced failure after a checkpoint")
            return value

    _SOURCES_CLASSES.update(totals=WordTotals, blocking=BlockingEvents,
                            fail_sink=FailAfterHoldSink,
                            fail_half=FailAfterHalf)
    return _SOURCES_CLASSES


class _SocketFeeder:
    """A TCP server on an ephemeral port of 127.0.0.1: sends ``chunks``
    to the first client, then keeps the connection open, quiet, until
    ``done`` is set (every window fired on the wall clock) or
    ``limit_s`` passed, then closes it, which ends the source."""

    def __init__(self, chunks, done, limit_s):
        import socket
        self.server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.server.bind(("127.0.0.1", 0))
        self.server.listen(1)
        self.server.settimeout(limit_s)
        self.port = self.server.getsockname()[1]
        self.chunks, self.done, self.limit_s = chunks, done, limit_s
        self.t_first = self.t_sent = self.t_closed = None
        self.error = None
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        try:
            conn, _ = self.server.accept()
            with conn:
                self.t_first = time.perf_counter()
                for chunk in self.chunks:
                    conn.sendall(chunk)
                self.t_sent = time.perf_counter()
                self.done.wait(self.limit_s)
            self.t_closed = time.perf_counter()
        except OSError as e:
            self.error = repr(e)
        finally:
            self.server.close()

    def join(self):
        self.thread.join(self.limit_s)
        check(not self.thread.is_alive() and self.error is None,
              f"sources: the socket feeder finished ({self.error})")


def _word_lines(rng, n_words, n_vocab, per_line):
    """n_words words of a seeded uniform n_vocab vocabulary, per_line a
    line, as byte chunks; and numpy's count per word."""
    idx = rng.integers(0, n_vocab, n_words)
    vocab = np.asarray([f"word{i}" for i in range(n_vocab)])
    words = vocab[idx].reshape(-1, per_line)
    text = "\n".join(" ".join(row) for row in words) + "\n"
    data = text.encode()
    chunks = [data[i:i + (1 << 16)] for i in range(0, len(data), 1 << 16)]
    counts = np.bincount(idx, minlength=n_vocab)
    want = {f"word{i}": float(c) for i, c in enumerate(counts) if c}
    return chunks, want


def _socket_wordcount(dev, n_words, n_vocab, per_line, window_s, backend,
                      reduce_form, limit_s, seed):
    """Config #1 as the example writes it, against a real local socket;
    returns (report, totals)."""
    from flink_tpu_torch import kernels as K
    from flink_tpu_torch.ops.device_agg import SumAggregate
    from flink_tpu_torch.streaming.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.streaming.timers import SystemProcessingTimeService
    from flink_tpu_torch.streaming.windowing import Time
    classes = _sources_classes()
    chunks, want = _word_lines(np.random.default_rng(seed), n_words, n_vocab,
                               per_line)
    sink = classes["totals"](n_words)
    feeder = _SocketFeeder(chunks, sink.done, limit_s)
    n_lines = n_words // per_line
    seen = {"lines": 0, "t_last": None}

    def split(line):
        seen["lines"] += 1
        if seen["lines"] == n_lines:
            seen["t_last"] = time.perf_counter()
        return [(w, 1) for w in line.split()]

    env = StreamExecutionEnvironment.get_execution_environment(device=dev)
    env.set_state_backend(backend)
    env.set_stream_time_characteristic("processing")
    env.processing_time_service = SystemProcessingTimeService()
    env.enable_checkpointing(1000)
    windowed = (env.socket_text_stream("127.0.0.1", feeder.port)
                .flat_map(split)
                .key_by(lambda wc: wc[0])
                .time_window(Time.seconds(window_s)))
    if reduce_form:
        counts = (windowed.reduce(lambda a, b: (a[0], a[1] + b[1]),
                                  lambda k, w, vals: [(k, w.start, float(v[1]))
                                                      for v in vals]))
    else:
        agg = SumAggregate(np.float64)
        agg.extract_value = lambda wc: wc[1]
        counts = windowed.aggregate(agg, window_function=lambda k, w, vals: [
            (k, w.start, float(vals[0]))])
    counts.add_sink(sink)
    before = dict(K.LAUNCHES)
    t0 = time.perf_counter()
    result = env.execute("chip-smoke-socket-word-count")
    torch_sync()
    wall = time.perf_counter() - t0
    feeder.join()
    launches = _launch_delta(before)
    check(seen["lines"] == n_lines,
          f"sources (a): the job read all {n_lines} lines ({seen['lines']})")
    ingest_s = seen["t_last"] - feeder.t_first
    report = {"words": n_words, "lines": n_lines, "vocabulary": n_vocab,
              "backend": backend, "form": "reduce" if reduce_form else "aggregate",
              "window_s": window_s, "windows_fired": sink.rows,
              "checkpoints_completed": result.checkpoints_completed,
              "ingest_s": ingest_s, "events_per_s": n_words / ingest_s,
              "send_s": feeder.t_sent - feeder.t_first,
              "quiet_until_last_fire_s": feeder.t_closed - feeder.t_sent,
              "job_wall_s": wall, "launches": launches}
    check(sink.totals == want,
          f"sources (a) {report['form']}: per word, the sum over every fired "
          f"window equals numpy's count exactly ({len(want)} words, "
          f"{sink.total} of {n_words})")
    check(result.checkpoints_completed >= 1,
          f"sources (a) {report['form']}: a checkpoint completed "
          f"({result.checkpoints_completed})")
    return report


def _blocking_job(dev, cols, p, fail, sink):
    from flink_tpu_torch.ops.sketches import HyperLogLogAggregate
    from flink_tpu_torch.streaming.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.streaming.windowing import TumblingEventTimeWindows
    classes = _sources_classes()
    agg = HyperLogLogAggregate(p)
    agg.extract_value = lambda e: e[1]
    env = StreamExecutionEnvironment.get_execution_environment(device=dev)
    env.set_state_backend("gpu")
    if fail:
        env.enable_checkpointing(2000)
        env.set_restart_strategy("fixed_delay", restart_attempts=2, delay_ms=0)
    (env.add_source(classes["blocking"](*cols), name="blocking").uid("blocking")
        .key_by(0).window(TumblingEventTimeWindows.of(1000))
        .disable_device_operator()
        .aggregate(agg, window_function=lambda k, w, vals: [
            (int(k), w.start, float(vals[0]))])
        .add_sink(sink))
    t0 = time.perf_counter()
    result = env.execute("chip-smoke-blocking-source")
    torch_sync()
    return result, time.perf_counter() - t0


def _committed_on_completion(commits, events) -> bool:
    """Every offset commit came from the completion of checkpoint c (or
    the end of input), and each committed offset is one the source
    snapshotted for c or an earlier checkpoint."""
    snapped = {}
    for _kind, cid, offsets in events:
        if cid is not None:
            snapped.setdefault(cid, {}).update(offsets)
    for by, offsets in commits:
        if by == "end":
            continue
        if by is None:
            return False
        for part, off in offsets.items():
            if not any(c <= by and snap.get(part) == off
                       for c, snap in snapped.items()):
                return False
    return True


def _log_job(dev, in_log, out_log, p, fail, parallelism):
    from flink_tpu_torch.connectors import (ReplayableLogSource,
                                            TransactionalLogSink)
    from flink_tpu_torch.ops.sketches import HyperLogLogAggregate
    from flink_tpu_torch.streaming.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.streaming.windowing import TumblingEventTimeWindows
    classes = _sources_classes()
    agg = HyperLogLogAggregate(p)
    agg.extract_value = lambda e: e[1]
    env = StreamExecutionEnvironment.get_execution_environment(device=dev)
    env.set_parallelism(parallelism)
    env.enable_checkpointing(250)
    if fail:
        env.set_restart_strategy("fixed_delay", restart_attempts=2, delay_ms=0)
    (env.add_source(ReplayableLogSource(in_log, bounded=True,
                                        watermark_lag_ms=0),
                    name="log", parallelism=parallelism)
        .map(classes["fail_half"](), name="failer")
        .key_by(lambda e: e[0]).window(TumblingEventTimeWindows.of(1000))
        .aggregate(agg, window_function=lambda k, w, vals: [
            (int(k), w.start, float(vals[0]))])
        # one sink subtask: its transactions are the checkpoint's alone
        .add_sink(TransactionalLogSink(out_log)).set_parallelism(1))
    t0 = time.perf_counter()
    result = env.execute("chip-smoke-replayable-log")
    torch_sync()
    return result, time.perf_counter() - t0


def sources_phase(dev, n_words=1 << 18, n_vocab=50_000, per_line=16,
                  window_s=5, n_reduce=1 << 16, n_blocking=1 << 17,
                  n_log=1 << 17, n_keys=1_000_000, span_ms=4000,
                  parallelism=4, limit_s=120.0):
    """Sources with their guarantees on the card, through
    StreamExecutionEnvironment: (a) BASELINE config #1 as the example
    writes it, socket_text_stream on its own thread fed by a local
    socket, processing-time 5 s windows on the system clock with
    checkpoints, Sum on the GPU backend, and the example's reduce form
    on the heap backend; (b) a blocking source keeping its offset in
    operator list state, 1 s HLL on WindowOperator over the GPU backend
    into TransactionalCollectSink, failing once after a checkpoint; (c)
    the replayable log at parallelism 4, 1 s HLL on the device window
    operator's log tier into a TransactionalLogSink, failing once after
    a checkpoint.  Events are cut to fit the path into ~60 s and again
    to make room for later paths (2^18 words, 2^17 events in (b) and
    (c)); key spaces and p are the
    configs'."""
    from flink_tpu_torch import kernels as K
    from flink_tpu_torch.connectors import InMemoryPartitionedLog
    from flink_tpu_torch.connectors.log_connector import ReplayableLogSource
    from flink_tpu_torch.streaming import window_operator as wo
    from flink_tpu_torch.streaming.two_phase import TransactionalCollectSink
    p = 12
    out = {}

    # (a) config #1 from a socket
    t0 = time.perf_counter()
    out["socket_gpu"] = _socket_wordcount(dev, n_words, n_vocab, per_line,
                                          window_s, "gpu", False, limit_s, 31)
    for kname in ("scatter_combine", "clear_rows"):
        check(out["socket_gpu"]["launches"].get(kname, 0) > 0,
              f"sources (a): {kname} launched ({out['socket_gpu']['launches']})")
    out["socket_heap_reduce"] = _socket_wordcount(
        dev, n_reduce, n_vocab, per_line, window_s, "heap", True, limit_s, 32)
    out["socket_wall_s"] = time.perf_counter() - t0
    emit({"sources": {"socket": out["socket_gpu"],
                      "socket_reduce": out["socket_heap_reduce"]}})

    # (b) a blocking source that fails after a checkpoint and restarts
    t0 = time.perf_counter()
    classes = _sources_classes()
    rng = np.random.default_rng(33)
    cols = (rng.integers(0, n_keys, n_blocking),
            rng.integers(0, 2 ** 62, n_blocking),
            np.sort(rng.integers(0, span_ms, n_blocking)))
    log = {}
    restore = _call_log(wo.WindowOperator, ("snapshot_state", "restore_state"),
                        log)
    try:
        _Hold.reset(0, False)
        clean_sink = TransactionalCollectSink()
        _, clean_s = _blocking_job(dev, cols, p, False, clean_sink)
        log.clear()
        _Hold.reset(n_blocking // 2, True)
        sink = classes["fail_sink"]()
        before = dict(K.LAUNCHES)
        result, secs = _blocking_job(dev, cols, p, True, sink)
        launches = _launch_delta(before)
    finally:
        restore()
    clean, got = clean_sink.committed, sink.committed
    check(_Hold.failed and result.restarts == 1,
          "sources (b): the job failed once, after the checkpoint taken at "
          "the hold completed, and restarted once")
    restored = _Hold.restored_offsets
    check(len(restored) == 2 and restored[0] == 0
          and restored[1] >= n_blocking // 2
          and restored[1] in _Hold.snapshot_offsets.values(),
          f"sources (b): the source's operator list state restored the "
          f"offset it snapshotted for a checkpoint at or past the hold "
          f"({restored}; snapshots {_Hold.snapshot_offsets})")
    check(len(set(got)) == len(got) and sorted(got) == sorted(clean)
          and len(clean) > 0,
          f"sources (b): the committed rows ({len(got)}) equal the "
          f"uninterrupted run's bit for bit, none twice")
    for kname in ("hll_update", "hll_estimate", "clear_rows", "set_rows"):
        check(launches.get(kname, 0) > 0,
              f"sources (b): {kname} launched ({launches})")
    snaps = [(s, r) for s, r in log.get("snapshot_state", [])]
    out["blocking"] = {
        "events": n_blocking, "keys": n_keys, "span_ms": span_ms,
        "rows": len(clean), "seconds": secs, "events_per_s": n_blocking / secs,
        "uninterrupted_seconds": clean_s,
        "uninterrupted_events_per_s": n_blocking / clean_s,
        "checkpoints_completed": result.checkpoints_completed,
        "snapshot_s": [s for s, _ in snaps],
        "snapshot_host_bytes": [_host_bytes(r) for _, r in snaps],
        "restore_s": [s for s, _ in log.get("restore_state", [])],
        "launches": launches, "wall_s": time.perf_counter() - t0}
    emit({"sources": {"blocking": out["blocking"]}})

    # (c) the replayable log, exactly once
    t0 = time.perf_counter()
    rng = np.random.default_rng(34)
    keys = rng.integers(0, n_keys, n_log)
    users = rng.integers(0, 2 ** 62, n_log)
    ts = np.sort(rng.integers(0, span_ms, n_log))
    in_log = InMemoryPartitionedLog(4)
    for i, (k, u, t) in enumerate(zip(keys.tolist(), users.tolist(),
                                      ts.tolist())):
        in_log.append(i % 4, (k, u), t)
    fill_s = time.perf_counter() - t0
    fail_cls = classes["fail_half"]
    runs = {}
    for name, fail in (("clean", False), ("failing", True)):
        fail_cls.half, fail_cls.seen = n_log // 2, 0
        fail_cls.armed = fail_cls.failed = False
        fail_cls.fail = fail
        out_log = InMemoryPartitionedLog(4)
        commits, events = [], []
        in_log._committed.clear()
        src_notify = ReplayableLogSource.notify_checkpoint_complete
        src_finish = ReplayableLogSource.finish
        src_snapshot = ReplayableLogSource.snapshot_function_state
        log_commit = type(in_log).commit_offsets
        phase = {"by": None}

        def notify(self, cid, _f=src_notify):
            phase["by"] = cid
            try:
                return _f(self, cid)
            finally:
                phase["by"] = None

        def finish(self, _f=src_finish):
            phase["by"] = "end"
            try:
                return _f(self)
            finally:
                phase["by"] = None

        def snapshot(self, cid, _f=src_snapshot):
            state = _f(self, cid)
            events.append(("snapshot", cid, dict(state["offsets"])))
            return state

        def commit(self, offsets, _f=log_commit):
            commits.append((phase["by"], dict(offsets)))
            return _f(self, offsets)

        ReplayableLogSource.notify_checkpoint_complete = notify
        ReplayableLogSource.finish = finish
        ReplayableLogSource.snapshot_function_state = snapshot
        type(in_log).commit_offsets = commit
        before = dict(K.LAUNCHES)
        try:
            result, secs = _log_job(dev, in_log, out_log, p, fail, parallelism)
        finally:
            ReplayableLogSource.notify_checkpoint_complete = src_notify
            ReplayableLogSource.finish = src_finish
            ReplayableLogSource.snapshot_function_state = src_snapshot
            type(in_log).commit_offsets = log_commit
        runs[name] = (sorted(out_log.all_values()), result, secs,
                      _launch_delta(before), commits, events)
    clean, _, clean_s, _, _, _ = runs["clean"]
    got, result, secs, launches, commits, events = runs["failing"]
    check(fail_cls.failed and result.restarts == 1,
          "sources (c): the job failed once and restarted once")
    check(got == clean and len(clean) > 0 and len(set(got)) == len(got),
          f"sources (c): the committed output ({len(got)} rows) equals the "
          "uninterrupted run's, none twice")
    by_checkpoint = [c for c in commits if c[0] != "end"]
    check(by_checkpoint and _committed_on_completion(commits, events),
          f"sources (c): the source committed its offsets only when a "
          f"checkpoint completed (offsets it had snapshotted for that "
          f"checkpoint or an earlier one) and at the end of input "
          f"({len(by_checkpoint)} commits on completion)")
    check(launches.get("hll_log_finish", 0) > 0,
          f"sources (c): hll_log_finish launched ({launches})")
    out["log"] = {"events": n_log, "keys": n_keys, "partitions": 4,
                  "parallelism": parallelism, "rows": len(clean),
                  "log_fill_s": fill_s, "seconds": secs,
                  "events_per_s": n_log / secs, "uninterrupted_seconds": clean_s,
                  "uninterrupted_events_per_s": n_log / clean_s,
                  "checkpoints_completed": result.checkpoints_completed,
                  "offset_commits_on_completion": len(by_checkpoint),
                  "offset_commits_at_end": len(commits) - len(by_checkpoint),
                  "launches": launches, "wall_s": time.perf_counter() - t0}
    emit({"sources": {"log": out["log"]}})


# ---------------------------------------------------------------------
# phase 22: the rest of the DataStream API and typed state
# ---------------------------------------------------------------------

_DS_CLASSES = {}


class _Ds:
    """Flags and records the datastream_api path's functions share
    (class attributes: each subtask runs its own copy of a function)."""

    lock = threading.Lock()

    @classmethod
    def reset(cls, need_rules=0):
        cls.need_rules = need_rules      # broadcast updates the data waits for
        cls.rules_seen = 0
        cls.rules_released = False       # the rules source may end
        cls.events_released = False      # the data source may end
        cls.events_done = threading.Event()
        cls.broadcast_states = {}        # subtask -> its rule map
        cls.ops = []                     # the broadcast operators, by open
        cls.failed = False
        cls.completed = False            # a checkpoint past half completed
        cls.snap_offsets = {}            # checkpoint id -> source offset
        cls.ingested = 0                 # records the loop has taken


def _ds_classes():
    """The user functions of the datastream_api path, built once."""
    if _DS_CLASSES:
        return _DS_CLASSES
    from flink_tpu_torch.core.functions import MapFunction
    from flink_tpu_torch.core.records import RecordSchema, RecordSerializer
    from flink_tpu_torch.core.state import (AggregatingStateDescriptor,
                                            MapStateDescriptor,
                                            ValueStateDescriptor)
    from flink_tpu_torch.ops.device_agg import CountAggregate
    from flink_tpu_torch.ops.sketches import HyperLogLogAggregate
    from flink_tpu_torch.streaming.elements import MAX_WATERMARK, RecordBatch
    from flink_tpu_torch.streaming.operators import (AsyncFunction,
                                                    KeyedBroadcastProcessFunction)
    from flink_tpu_torch.streaming.sources import SourceFunction

    rules_desc = MapStateDescriptor("rules")
    v1 = RecordSchema([("user", "long"), ("events", "long"), ("last", "long")])
    v2 = RecordSchema([("user", "long"), ("events", "long"), ("last", "long"),
                       ("region", "string", "unknown")])

    class ItemHll(HyperLogLogAggregate):
        """HLL of a record's last field (the item, or the user)."""

        def extract_value(self, value):
            return value[-1]

    class RulesSource(SourceFunction):
        """The broadcast side: every rule update once (a flag in its
        function state, so a restored job sends none again), then idle
        until released."""

        def __init__(self, rules):
            self.rules = list(rules)
            self.emitted = False

        def run(self, ctx):
            while self.emit_step(ctx, 1024):
                pass

        def emit_step(self, ctx, max_records):
            if not self.emitted:
                for r in self.rules:
                    ctx.collect(r)
                self.emitted = True
            if not _Ds.rules_released:
                time.sleep(0.0002)
                return True
            return False

        def snapshot_function_state(self, checkpoint_id=None):
            return {"emitted": self.emitted}

        def restore_function_state(self, state):
            self.emitted = state["emitted"]

    class ColumnSource(SourceFunction):
        """RecordBatches of ``batch`` rows over columns (the last the
        timestamps) and one watermark, at the end (so requests of an
        async operator stay in flight between barriers); waits for
        ``_Ds.need_rules`` broadcast updates first; its offset in
        operator list state; at the end idles until released when
        ``hold``."""

        def __init__(self, cols, batch=4096, hold=False, fail_half=False):
            self.cols = cols
            self.batch = batch
            self.hold = hold
            self.fail_half = fail_half
            self._op = None

        def initialize_state(self, op):
            self._op = op

        def run(self, ctx):
            while self.emit_step(ctx, 1024):
                pass

        def emit_step(self, ctx, max_records):
            if _Ds.rules_seen < _Ds.need_rules:
                time.sleep(0.0002)
                return True
            state = self._op.operator_state_backend.get_list_state("offset")
            offset = (state.get() or [0])[0]
            ts = self.cols[-1]
            n = len(ts)
            if self.fail_half and not _Ds.completed and offset >= n // 2:
                time.sleep(0.0002)         # hold at half for a checkpoint
                return True
            if offset < n:
                end = min(n, offset + self.batch)
                if self.fail_half and not _Ds.completed:
                    end = min(end, n // 2)
                sl = slice(offset, end)
                ctx.collect_batch(RecordBatch(
                    {f"f{i}": c[sl] for i, c in enumerate(self.cols[:-1])},
                    ts=ts[sl]))
                state.update([end])
                return True
            _Ds.events_done.set()
            if self.hold and not _Ds.events_released:
                time.sleep(0.0002)
                return True
            ctx.emit_watermark(MAX_WATERMARK)
            return False

        def snapshot_function_state(self, checkpoint_id=None):
            if checkpoint_id is not None and self._op is not None:
                _Ds.snap_offsets[checkpoint_id] = (
                    self._op.operator_state_backend.get_list_state("offset")
                    .get() or [0])[0]
            return {}

        def notify_checkpoint_complete(self, checkpoint_id):
            n = len(self.cols[-1])
            if self.fail_half and _Ds.snap_offsets.get(checkpoint_id, -1) >= n // 2:
                _Ds.completed = True

    def admit_class(schema, name):
        profile_desc = ValueStateDescriptor(
            "profile", serializer=RecordSerializer(schema))
        hll_desc = AggregatingStateDescriptor("uv", ItemHll(12))

        class Admit(KeyedBroadcastProcessFunction):
            """Leg (a): each rule update writes the category's verdict
            into broadcast state; each event of an admitted category
            adds its item to the user's HLL and updates the user's
            profile record.  Both states are bound at open, so a restore
            lands on the device (``set_rows``) and migrates."""

            def initialize_state(self, op):
                backend = op.keyed_backend
                self._hll = backend.get_partitioned_state((), hll_desc)
                self._profile = backend.get_partitioned_state((), profile_desc)
                self._seen_rules = False
                with _Ds.lock:
                    _Ds.ops.append((op, self._hll, self._profile))

            def process_broadcast_element(self, value, ctx, out):
                ctx.get_broadcast_state(rules_desc).put(value[0], value[1])
                with _Ds.lock:
                    _Ds.rules_seen += 1

            def process_element(self, value, ctx, out):
                rules = ctx.get_broadcast_state(rules_desc)
                if not self._seen_rules:
                    self._seen_rules = True
                    _Ds.broadcast_states[ctx._op.subtask_index] = dict(
                        rules.immutable_entries())
                if rules.get(value[1]):
                    self._hll.add(value)
                    prev = self._profile.value()
                    self._profile.update({
                        "user": value[0],
                        "events": 1 if prev is None else prev["events"] + 1,
                        "last": value[2]})

        Admit.__name__ = name
        return Admit

    class ImpressionsClicks:
        """Leg (c): per ad, impressions and clicks in two device Count
        states; at the window's end, one event-time timer per ad emits
        (ad, impressions, clicks) and clears both."""

        def __init__(self, window_end):
            self.window_end = window_end
            self.imps = AggregatingStateDescriptor("imps", CountAggregate())
            self.clicks = AggregatingStateDescriptor("clicks", CountAggregate())
            self._states = None

        def _bind(self, ctx):
            if self._states is None:
                self._states = (ctx.get_state(self.imps),
                                ctx.get_state(self.clicks))
            return self._states

        def process_element1(self, value, ctx, out):
            self._bind(ctx)[0].add(value)
            ctx.register_event_time_timer(self.window_end)

        def process_element2(self, value, ctx, out):
            self._bind(ctx)[1].add(value)
            ctx.register_event_time_timer(self.window_end)

        def on_timer(self, timestamp, ctx, out):
            imps, clicks = self._bind(ctx)
            out.collect((ctx.get_current_key(), imps.get() or 0,
                         clicks.get() or 0))
            imps.clear()
            clicks.clear()

    class Lookup(AsyncFunction):
        """Leg (d): a lookup that takes 1 ms and answers the user's
        category."""

        def __init__(self, delay_s=0.001):
            self.delay_s = delay_s

        def async_invoke(self, value, result_future):
            time.sleep(self.delay_s)
            result_future.complete([(value[0] % 64, value[0])])

    class FailOnce(MapFunction):
        """Leg (d): once a checkpoint taken at half the input completed,
        the next record fails, once."""

        def map(self, value):
            if _Ds.completed and not _Ds.failed:
                _Ds.failed = True
                raise RuntimeError("induced failure after a checkpoint")
            return value

    _DS_CLASSES.update(rules_desc=rules_desc, v1=v1, v2=v2, item_hll=ItemHll,
                       rules=RulesSource, columns=ColumnSource,
                       admit_v1=admit_class(v1, "AdmitV1"),
                       admit_v2=admit_class(v2, "AdmitV2"),
                       co=ImpressionsClicks, lookup=Lookup, fail_once=FailOnce)
    return _DS_CLASSES


def _ds_broadcast_job(dev, classes, events, rules, admit, parallelism,
                      savepoint=None):
    """Leg (a)'s job: the data stream keyed by user, connected to the
    broadcast rules, on the GPU backend at ``parallelism``; started with
    ``execute_async``."""
    from flink_tpu_torch.streaming.datastream import StreamExecutionEnvironment
    env = StreamExecutionEnvironment.get_execution_environment(device=dev)
    env.set_state_backend("gpu")
    env.set_parallelism(parallelism)
    env.enable_checkpointing(3_600_000)        # savepoints only
    if savepoint is not None:
        env.set_savepoint_restore(savepoint)
    data = env.add_source(classes["columns"](events, hold=True),
                          name="events").uid("events")
    rule_stream = env.add_source(classes["rules"](rules), name="rules").uid("rules")
    (data.key_by(lambda e: e[0])
        .connect(rule_stream.broadcast(classes["rules_desc"]))
        .process(admit()).uid("admit"))
    return env.execute_async("chip-smoke-broadcast-state")


def _ds_rows_equal(old, new):
    """Every key's device rows of two DeviceAggregatingStates equal, bit
    for bit (gathered on the card a block of keys at a time); the keys
    compared."""
    import torch
    keys = [k for k, ns in old.slot_index if ns == ()]
    if len(keys) != len(new.slot_index) or len(keys) != len(old.slot_index):
        return False, len(keys)
    for lo in range(0, len(keys), 1 << 16):
        block = keys[lo:lo + (1 << 16)]
        a = torch.tensor([old.slot_index[(k, ())] for k in block],
                         dtype=torch.int64, device=old.device)
        if any((k, ()) not in new.slot_index for k in block):
            return False, len(keys)
        b = torch.tensor([new.slot_index[(k, ())] for k in block],
                         dtype=torch.int64, device=new.device)
        for name, arr in old.device_state.items():
            if not torch.equal(arr.index_select(0, a),
                               new.device_state[name].index_select(0, b)):
                return False, len(keys)
    return True, len(keys)


def _ds_owner(ops, key):
    """(op, hll, profile) of the subtask whose key-group range holds key."""
    from flink_tpu_torch.core.keygroups import assign_to_key_group
    for entry in ops:
        backend = entry[0].keyed_backend
        if backend.key_group_range.contains(
                assign_to_key_group(key, backend.max_parallelism)):
            return entry
    raise KeyError(key)


def datastream_api_phase(dev, n_events=1 << 18, n_keys=1_000_000,
                         n_categories=64, n_rules=1024, parallelism=4,
                         n_query_events=1 << 18, n_queries=4096,
                         query_s=1.0, n_imps=1 << 16, n_clicks=1 << 13,
                         n_ads=100_000, n_async=1 << 14, n_serial=512,
                         n_async_fail=1 << 14, n_seeds=1 << 12,
                         n_sample=4096):
    """The rest of the DataStream API on the card through
    StreamExecutionEnvironment: (a) the broadcast state pattern, config
    #2 events keyed by user connected to 1,024 broadcast rule updates at
    parallelism 4, an HLL p = 12 per user on the GPU backend; (b)
    queryable HLL state read by a client thread while its job runs; (c)
    connect + a keyed co-process function with two device Count states
    and a timer per ad; (d) async I/O, ordered and unordered, into an
    HLL window, and a checkpoint with requests in flight; (e) (a)'s
    savepoint restored under an evolved profile schema; (f) a Collatz
    loop with iterate, split by parity into Sum windows.  Events are cut
    to fit the path into ~60 s (per-record Python: 2^18 events in (a)
    and (b), 2^16 impressions and 2^13 clicks in (c), 2^14 lookups in
    (d), 2^12 seeds in (f)); key spaces (1M users, 100,000 ads) and p
    are kept."""
    import tempfile

    import torch
    from flink_tpu_torch import kernels as K
    from flink_tpu_torch.core.state import AggregatingStateDescriptor
    from flink_tpu_torch.ops.device_agg import CountAggregate, SumAggregate
    from flink_tpu_torch.runtime.queryable import (DEFAULT_REGISTRY,
                                                   QueryableStateClient)
    from flink_tpu_torch.streaming.datastream import (AsyncDataStream,
                                                      StreamExecutionEnvironment)
    from flink_tpu_torch.streaming.operators import AsyncWaitOperator
    from flink_tpu_torch.streaming.sources import CollectSink, SourceFunction
    from flink_tpu_torch.streaming.windowing import TumblingEventTimeWindows
    classes = _ds_classes()
    rng = np.random.default_rng(22)
    out = {}

    # (a) the broadcast state pattern, with typed profile state
    t0 = time.perf_counter()
    users = rng.integers(0, n_keys, n_events)
    cats = rng.integers(0, n_categories, n_events)
    items = rng.integers(0, 1 << 40, n_events)
    ts = np.sort(rng.integers(0, 4000, n_events))
    rule_cats = rng.integers(0, n_categories, n_rules)
    rule_ok = rng.random(n_rules) < 0.875
    rules = list(zip(rule_cats.tolist(), rule_ok.tolist()))
    rule_map = dict(rules)                      # the last update wins
    _Ds.reset(need_rules=parallelism * n_rules)
    before = dict(K.LAUNCHES)
    client = _ds_broadcast_job(dev, classes, (users, cats, items, ts), rules,
                               classes["admit_v1"], parallelism)
    check(_Ds.events_done.wait(600), "datastream_api (a): the data source "
          "emitted every event")
    ingest_s = time.perf_counter() - t0
    sp_dir = tempfile.mkdtemp(prefix="chip-smoke-ds-")
    t1 = time.perf_counter()
    savepoint = client.trigger_savepoint(sp_dir, timeout=600)
    savepoint_s = time.perf_counter() - t1
    client.cancel()
    check(client.wait(120).cancelled, "datastream_api (a): the job cancelled")
    torch_sync()
    launches_a = _launch_delta(before)
    ops_a = list(_Ds.ops)
    check(len(ops_a) == parallelism and sorted(_Ds.broadcast_states) ==
          list(range(parallelism)) and all(
              s == rule_map for s in _Ds.broadcast_states.values()),
          f"datastream_api (a): the broadcast state of all {parallelism} "
          "instances equals the rule map when the first record arrives")
    admitted = np.array([rule_map.get(c, False) for c in range(n_categories)])[cats]
    live = int(np.unique(users[admitted]).size)
    n_live = sum(len(hll.slot_index) for _, hll, _ in ops_a)
    reg_bytes = n_live * 4096
    check(n_live == live, f"datastream_api (a): {n_live} users hold an HLL, "
          f"numpy's admitted distinct users {live}")
    adm_users = np.unique(users[admitted])
    sample = np.sort(rng.choice(adm_users, min(n_sample, len(adm_users)),
                                replace=False))
    sel = admitted & np.isin(users, sample)
    want = hll_reference(np.searchsorted(sample, users[sel]),
                         splitmix64_np(items[sel]), len(sample), 12)
    got = np.zeros(len(sample))
    by_owner = {}
    for i, u in enumerate(sample.tolist()):
        by_owner.setdefault(id(_ds_owner(ops_a, u)[0]), []).append((i, u))
    for op, hll, _ in ops_a:
        rows = by_owner.get(id(op), [])
        if rows:
            res, found, _ = op.keyed_backend.get_batch(
                hll, [u for _, u in rows], ())
            check(bool(found.all()), "datastream_api (a): every sampled user "
                  "has HLL state")
            got[[i for i, _ in rows]] = res
    check(allclose(got, want, rtol=1e-5, atol=hll_atol(4096)),
          f"datastream_api (a): {len(sample)} sampled users within rtol 1e-5 "
          "(+ log slack) of numpy HLL on the admitted events")
    out["broadcast"] = {
        "events": n_events, "keys": n_keys, "categories": n_categories,
        "rule_updates": n_rules, "parallelism": parallelism,
        "admitted_events": int(admitted.sum()), "users_with_state": n_live,
        "register_bytes": reg_bytes, "seconds": ingest_s,
        "events_per_s": n_events / ingest_s, "savepoint_s": savepoint_s,
        "savepoint_bytes": os.path.getsize(savepoint),
        "launches": launches_a}
    emit({"datastream_api": {"broadcast": out["broadcast"]}})

    # (e) the savepoint restored under profile schema v2
    t0 = time.perf_counter()
    old_profiles = {}
    for op, _, profile in ops_a:
        for _ns, key, value in profile._table.entries():
            old_profiles[key] = value
    _Ds.reset(need_rules=0)
    _Ds.rules_released = _Ds.events_released = True
    before = dict(K.LAUNCHES)
    client = _ds_broadcast_job(dev, classes, (users, cats, items, ts), rules,
                               classes["admit_v2"], parallelism, savepoint)
    result = client.wait(600)
    torch_sync()
    launches_e = _launch_delta(before)
    restore_s = time.perf_counter() - t0
    ops_e = list(_Ds.ops)
    check(result.restarts == 0 and _Ds.rules_seen == 0 and len(ops_e) == parallelism,
          "datastream_api (e): the restored job ran through, no rule sent again")
    compared, equal = 0, True
    for (op_a, hll_a, _), (op_e, hll_e, _) in zip(
            sorted(ops_a, key=lambda e: e[0].subtask_index),
            sorted(ops_e, key=lambda e: e[0].subtask_index)):
        ok, n = _ds_rows_equal(hll_a, hll_e)
        equal = equal and ok
        compared += n
    check(equal and compared == n_live, f"datastream_api (e): all {compared} "
          "users' HLL rows came back bit for bit")
    check(launches_e.get("set_rows", 0) > 0,
          f"datastream_api (e): the restore uploaded through set_rows ({launches_e})")
    new_profiles = {}
    for op, _, profile in ops_e:
        for _ns, key, value in profile._table.entries():
            new_profiles[key] = value
    check(len(new_profiles) == len(old_profiles) == live and all(
        new_profiles.get(k) == dict(v, region="unknown")
        for k, v in old_profiles.items()),
        f"datastream_api (e): every one of {len(old_profiles)} profile "
        "records migrated to v2 (the added field at its default)")
    out["migration"] = {"users": len(new_profiles), "restore_s": restore_s,
                        "launches": launches_e}
    emit({"datastream_api": {"migration": out["migration"]}})
    del ops_a, ops_e
    _Ds.reset()
    shutil.rmtree(sp_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    # (b) queryable HLL state read while its job runs
    t0 = time.perf_counter()
    qn = n_query_events
    q_users, q_items = users[:qn], items[:qn]

    class QuerySource(SourceFunction):
        def __init__(self):
            self._cancelled = False

        def run(self, ctx):
            from flink_tpu_torch.streaming.elements import RecordBatch
            lock = ctx.get_checkpoint_lock()
            for lo in range(0, qn, 4096):
                with lock:
                    ctx.collect_batch(RecordBatch(
                        {"f0": q_users[lo:lo + 4096], "f1": q_items[lo:lo + 4096]}))
            _Ds.events_done.set()
            while not self._cancelled:
                time.sleep(0.001)

        def cancel(self):
            self._cancelled = True

    def ingest(e):
        _Ds.ingested += 1
        return e

    DEFAULT_REGISTRY.unregister_all()
    env = StreamExecutionEnvironment.get_execution_environment(device=dev)
    env.set_state_backend("gpu")
    (env.add_source(QuerySource(), name="thread-source")
        .map(ingest, name="ingested")
        .key_by(lambda e: e[0])
        .as_queryable_state("uv", AggregatingStateDescriptor(
            "uv", classes["item_hll"](12))))
    _Ds.reset()
    client = env.execute_async("chip-smoke-queryable")
    check(_Ds.events_done.wait(300), "datastream_api (b): the source thread "
          "emitted every event")
    q_sample = np.sort(rng.choice(np.unique(q_users), n_queries, replace=False))
    qc = QueryableStateClient()
    before = dict(K.LAUNCHES)
    queries = {}

    def query_until(done):
        """Query the sample round robin until done(); the window's
        queries, answers (adds still pending are invisible) and
        latency."""
        lat, answered = [], 0
        t1 = time.perf_counter()
        while not done():
            u = int(q_sample[len(lat) % n_queries])
            t2 = time.perf_counter()
            v = qc.get_kv_state("uv", u)
            lat.append(time.perf_counter() - t2)
            answered += v is not None
        secs = time.perf_counter() - t1
        lat_ms = np.sort(np.asarray(lat)) * 1000.0
        return {"queries": len(lat), "answered": answered, "seconds": secs,
                "queries_per_s": len(lat) / secs,
                "p50_ms": float(lat_ms[len(lat_ms) // 2]) if len(lat) else None,
                "p99_ms": float(lat_ms[int(len(lat_ms) * 0.99)]) if len(lat)
                else None}

    # while the loop ingests (the client and the loop share the host),
    # then with the loop idle on its quiet source
    ingest_deadline = time.perf_counter() + 300
    queries["during_ingest"] = query_until(
        lambda: _Ds.ingested >= qn or time.perf_counter() > ingest_deadline)
    check(_Ds.ingested == qn, f"datastream_api (b): the loop took every event "
          f"({_Ds.ingested})")
    idle_deadline = time.perf_counter() + query_s
    queries["after_ingest"] = query_until(
        lambda: time.perf_counter() > idle_deadline)
    live_launches = _launch_delta(before)
    answered = sum(w["answered"] for w in queries.values())
    client.cancel()
    check(client.wait(120).cancelled, "datastream_api (b): the job cancelled")
    torch_sync()
    check(live_launches.get("hll_estimate", 0) == answered and answered > 0,
          f"datastream_api (b): each of {answered} answered queries was one "
          f"gathered hll_estimate launch ({live_launches})")
    final = np.array([qc.get_kv_state("uv", int(u)) for u in q_sample])
    backend, _desc = DEFAULT_REGISTRY.locate("uv", int(q_sample[0]))
    state = backend.get_or_create_keyed_state(_desc)
    res, found, _ = backend.get_batch(state, q_sample.tolist(), ())
    check(bool(found.all()) and np.array_equal(final.astype(np.float32),
                                               np.asarray(res, np.float32)),
          f"datastream_api (b): {n_queries} answers after the job bit-equal "
          "to the backend's get_batch")
    qsel = np.isin(q_users, q_sample)
    want = hll_reference(np.searchsorted(q_sample, q_users[qsel]),
                         splitmix64_np(q_items[qsel]), n_queries, 12)
    check(allclose(final, want, rtol=1e-5, atol=hll_atol(4096)),
          "datastream_api (b): the answers within rtol 1e-5 (+ log slack) of "
          "numpy HLL")
    out["queryable"] = {"events": qn, **queries,
                        "wall_s": time.perf_counter() - t0,
                        "launches": live_launches}
    DEFAULT_REGISTRY.unregister_all()
    del backend, state
    emit({"datastream_api": {"queryable": out["queryable"]}})

    # (c) connect + a keyed co-process function, two device Counts
    t0 = time.perf_counter()
    imp_ads = rng.integers(0, n_ads, n_imps)
    imp_ts = np.sort(rng.integers(0, 10_000, n_imps))
    click_ads = rng.integers(0, n_ads, n_clicks)
    click_ts = np.sort(rng.integers(0, 10_000, n_clicks))
    _Ds.reset()
    env = StreamExecutionEnvironment.get_execution_environment(device=dev)
    env.set_state_backend("gpu")
    co_out = []
    imps = env.add_source(classes["columns"]((imp_ads, imp_ts)), name="impressions")
    clicks = env.add_source(classes["columns"]((click_ads, click_ts)), name="clicks")
    (imps.connect(clicks).key_by(lambda e: e[0], lambda e: e[0])
        .process(classes["co"](9_999))
        .add_sink(CollectSink(co_out)))
    before = dict(K.LAUNCHES)
    env.execute("chip-smoke-connect")
    torch_sync()
    secs = time.perf_counter() - t0
    launches_c = _launch_delta(before)
    want_i = np.bincount(imp_ads, minlength=n_ads)
    want_c = np.bincount(click_ads, minlength=n_ads)
    got_i = np.zeros(n_ads, np.int64)
    got_c = np.zeros(n_ads, np.int64)
    for ad, ci, cc in co_out:
        got_i[ad] += int(ci)
        got_c[ad] += int(cc)
    present = (want_i + want_c) > 0
    check(len(co_out) == int(present.sum()) and np.array_equal(got_i, want_i)
          and np.array_equal(got_c, want_c),
          f"datastream_api (c): every one of {len(co_out)} ads' impressions "
          "and clicks equal numpy exactly")
    for kname in ("scatter_combine", "clear_rows"):
        check(launches_c.get(kname, 0) > 0,
              f"datastream_api (c): {kname} launched ({launches_c})")
    out["connect"] = {"impressions": n_imps, "clicks": n_clicks, "ads": n_ads,
                      "timers": len(co_out), "seconds": secs,
                      "events_per_s": (n_imps + n_clicks) / secs,
                      "launches": launches_c}
    emit({"datastream_api": {"connect": out["connect"]}})

    # (d) async I/O into an HLL window
    a_users = users[:n_async]
    a_ts = np.sort(rng.integers(0, 4000, n_async))
    a_events = list(zip(a_users.tolist(), a_ts.tolist()))
    hll_user = classes["item_hll"](12)

    def async_job(events, ordered, capacity, with_window=True, fail=False):
        env = StreamExecutionEnvironment.get_execution_environment(device=dev)
        env.set_state_backend("gpu")
        order, windows = [], []
        if fail:
            env.enable_checkpointing(20)
            env.set_restart_strategy("fixed_delay", restart_attempts=2,
                                     delay_ms=0)
            src = env.add_source(classes["columns"](
                (np.array([e[0] for e in events]), np.array([e[1] for e in events])),
                batch=256, fail_half=True), name="events").uid("events")
        else:
            src = env.from_collection([(e, e[1]) for e in events],
                                      timestamped=True)
        wait = AsyncDataStream.ordered_wait if ordered else AsyncDataStream.unordered_wait
        looked = wait(src, classes["lookup"](), capacity=capacity).uid("async")
        if fail:
            looked = looked.map(classes["fail_once"](), name="failer")
        looked.add_sink(CollectSink(order))
        if with_window:
            agg = CountAggregate() if fail else hll_user
            (looked.key_by(lambda e: e[0])
                .window(TumblingEventTimeWindows.of(1000))
                .aggregate(agg, window_function=lambda k, w, vals: [
                    (k, w.start, float(vals[0]))])
                .add_sink(CollectSink(windows)))
        t1 = time.perf_counter()
        result = env.execute("chip-smoke-async")
        torch_sync()
        return order, sorted(windows), time.perf_counter() - t1, result

    t0 = time.perf_counter()
    before = dict(K.LAUNCHES)
    ord_out, ord_win, ord_s, _ = async_job(a_events, True, 100)
    un_out, un_win, un_s, _ = async_job(a_events, False, 100)
    _, _, serial_s, _ = async_job(a_events[:n_serial], True, 1, with_window=False)
    launches_d = _launch_delta(before)
    want_order = [(u % 64, u) for u in a_users.tolist()]
    check(ord_out == want_order, "datastream_api (d): ordered output equals "
          "input order")
    check(sorted(un_out) == sorted(want_order), "datastream_api (d): unordered "
          "output holds every event")
    wins = sorted({(int(u % 64), int(t // 1000 * 1000)) for u, t in
                   zip(a_users.tolist(), a_ts.tolist())})
    check([w[:2] for w in ord_win] == wins and ord_win == un_win,
          "datastream_api (d): the HLL windows behind both modes are equal, "
          "with the (category, window) set exact")
    gid = np.searchsorted(np.array([c * 10 + s // 1000 for c, s in wins]),
                          (a_users % 64) * 10 + a_ts // 1000)
    want_h = hll_reference(gid, splitmix64_np(a_users), len(wins), 12)
    check(allclose([w[2] for w in ord_win], want_h, rtol=1e-5,
                   atol=hll_atol(4096)),
          "datastream_api (d): the window estimates within rtol 1e-5 (+ log "
          "slack) of numpy HLL")
    # a checkpoint with requests in flight, then a failure
    fail_events = a_events[:n_async_fail]
    snaps = []
    orig = AsyncWaitOperator.snapshot_state

    def counting_snapshot(op, checkpoint_id=None):
        snaps.append(len(op._pending))
        return orig(op, checkpoint_id)

    AsyncWaitOperator.snapshot_state = counting_snapshot
    _Ds.reset()
    try:
        f_out, f_win, f_s, f_result = async_job(fail_events, False, 100,
                                                fail=True)
    finally:
        AsyncWaitOperator.snapshot_state = orig
    f_users = a_users[:n_async_fail]
    f_ts = np.array([e[1] for e in fail_events])
    cnt = {}
    for u, t in zip(f_users.tolist(), f_ts.tolist()):
        cnt[(u % 64, t // 1000 * 1000)] = cnt.get((u % 64, t // 1000 * 1000), 0) + 1
    check(_Ds.failed and f_result.restarts == 1 and max(snaps, default=0) > 0,
          f"datastream_api (d): a checkpoint taken with requests in flight "
          f"(at most {max(snaps, default=0)}) completed, then the job failed "
          "once and restarted")
    check(f_win == sorted((k, s, float(c)) for (k, s), c in cnt.items()),
          "datastream_api (d): after the restart every window's count equals "
          "numpy exactly (no request lost, none twice)")
    out["async"] = {"events": n_async, "capacity": 100, "delay_ms": 1,
                    "ordered_s": ord_s, "ordered_events_per_s": n_async / ord_s,
                    "unordered_s": un_s, "unordered_events_per_s": n_async / un_s,
                    "serial_events": n_serial,
                    "serial_events_per_s": n_serial / serial_s,
                    "in_flight_at_snapshots": max(snaps, default=0),
                    "checkpointed_events": n_async_fail, "checkpointed_s": f_s,
                    "wall_s": time.perf_counter() - t0, "launches": launches_d}
    emit({"datastream_api": {"async": out["async"]}})

    # (f) iterate + split/select: a Collatz loop into Sum windows
    t0 = time.perf_counter()
    seeds = np.arange(2, 2 + n_seeds)
    env = StreamExecutionEnvironment.get_execution_environment(device=dev)
    loop_out = []
    src = env.from_collection([((int(s), int(s), 0), int(s)) for s in seeds],
                              timestamped=True)
    it = src.iterate()
    step = it.map(lambda t: (t[0], t[1] // 2 if t[1] % 2 == 0 else 3 * t[1] + 1,
                             t[2] + 1), name="collatz")
    it.close_with(step.filter(lambda t: t[1] != 1, name="again"))
    exits = step.filter(lambda t: t[1] == 1, name="exits").split(
        lambda t: ["even" if t[0] % 2 == 0 else "odd"])
    sum_steps = SumAggregate(np.float64)
    sum_steps.extract_value = lambda t: t[2]
    for parity in ("even", "odd"):
        (exits.select(parity).key_by(lambda t: t[0] % 2)
            .window(TumblingEventTimeWindows.of(1024))
            .aggregate(sum_steps, window_function=lambda k, w, vals: [
                (int(k), w.start, float(vals[0]))])
            .add_sink(CollectSink(loop_out)))
    env.execute("chip-smoke-iterate")
    torch_sync()
    secs = time.perf_counter() - t0
    steps = np.zeros(len(seeds), np.int64)
    cur = seeds.copy()
    while (cur != 1).any():
        live_ = cur != 1
        cur[live_] = np.where(cur[live_] % 2 == 0, cur[live_] // 2,
                              3 * cur[live_] + 1)
        steps[live_] += 1
    want_loop = {}
    for s, k in zip(seeds.tolist(), steps.tolist()):
        key = (s % 2, s // 1024 * 1024)
        want_loop[key] = want_loop.get(key, 0) + k
    check(sorted(loop_out) == sorted((p, w, float(v)) for (p, w), v
                                     in want_loop.items()),
          f"datastream_api (f): the Collatz loop over {n_seeds} seeds "
          f"({int(steps.sum())} rounds) split by parity into Sum windows "
          "equals numpy")
    out["iterate"] = {"seeds": n_seeds, "rounds": int(steps.sum()),
                      "seconds": secs, "rounds_per_s": int(steps.sum()) / secs}
    emit({"datastream_api": {"iterate": out["iterate"]}})


# ---------------------------------------------------------------------
# phase 23: the pre-flight analysis (graph linter, type-flow prover)
# ---------------------------------------------------------------------

_CHAIN_MAP2 = lambda t: (t[0], t[1] + 1)             # noqa: E731


class _PresizeWatch:
    """While installed: every ``grow_state`` call's new capacity, and per
    DeviceWindowOperator the engine it built at its first flush (tier,
    capacity, ``_predicted_slots``, ``initial_capacity``)."""

    def __init__(self):
        from flink_tpu_torch.ops.device_agg import DeviceAggregateFunction
        from flink_tpu_torch.streaming.device_window_operator import \
            DeviceWindowOperator
        self.grows, self.engines = [], []
        self._targets = ((DeviceAggregateFunction, "grow_state"),
                         (DeviceWindowOperator, "_ensure_engine"))
        self._saved = [getattr(c, n) for c, n in self._targets]

    def __enter__(self):
        real_grow, real_ensure = self._saved
        grows, engines = self.grows, self.engines

        def grow_state(agg, state, new_capacity):
            grows.append(int(new_capacity))
            return real_grow(agg, state, new_capacity)

        def ensure_engine(op, keys_arr):
            fresh = op.engine is None
            real_ensure(op, keys_arr)
            if fresh:
                engines.append({
                    "tier": type(op.engine).__name__,
                    "capacity": getattr(op.engine, "capacity", None),
                    "predicted_slots": getattr(op, "_predicted_slots", None),
                    "initial_capacity": op.initial_capacity})

        for (c, n), fn in zip(self._targets, (grow_state, ensure_engine)):
            setattr(c, n, fn)
        return self

    def __exit__(self, *exc):
        for (c, n), fn in zip(self._targets, self._saved):
            setattr(c, n, fn)


def _timed_preflight(env, into):
    """Time ``env._preflight`` (the linter and, when armed, the prover
    and apply_static) on its own."""
    real = env._preflight

    def preflight(job_name):
        t0 = time.perf_counter()
        try:
            return real(job_name)
        finally:
            into.append(time.perf_counter() - t0)
    env._preflight = preflight


def _analysis_presize(dev, n_events, n_keys, p, n_sample):
    """(a) config #2 on the scatter tier, the job run under
    ``lint.types.mode`` warn and off."""
    import torch
    from flink_tpu_torch.core.config import Configuration
    from flink_tpu_torch.ops.sketches import HyperLogLogAggregate
    from flink_tpu_torch.streaming.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.streaming.sources import CollectSink
    from flink_tpu_torch.streaming.windowing import TumblingEventTimeWindows

    rng = np.random.default_rng(22)
    users = rng.integers(0, n_keys, n_events)
    visitors = rng.integers(0, 2 ** 62, n_events)
    ts = np.sort(rng.integers(0, 1000, n_events))
    t0 = time.perf_counter()
    items = [((u >> 10, u & 1023, v), t) for u, v, t in
             zip(users.tolist(), visitors.tolist(), ts.tolist())]
    build_s = time.perf_counter() - t0
    distinct = int(np.unique(users).size)
    slot_bytes = 1 << p

    def run(mode):
        conf = Configuration().set("lint.types.mode", mode)
        env = StreamExecutionEnvironment(conf, device=dev)
        agg = HyperLogLogAggregate(p)
        agg.extract_value = lambda e: e[2]
        out = []
        (env.from_collection(items, timestamped=True)
            .key_by(lambda e: (e[0], e[1]))
            .window(TumblingEventTimeWindows.of(1000))
            .aggregate(agg, window_function=lambda k, w, v: [
                ((int(k[0]) << 10) | int(k[1]), float(v[0]))])
            .add_sink(CollectSink(out)))
        preflight = []
        _timed_preflight(env, preflight)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with _PresizeWatch() as watch:
            t0 = time.perf_counter()
            env.execute(f"analysis-presize-{mode}")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        dump = env.get_metric_registry().dump()
        job = f"analysis-presize-{mode}"
        row = {"mode": mode, "events": n_events, "seconds": secs,
               "events_per_s": n_events / secs, "preflight_s": preflight[0],
               "peak_bytes": int(peak), "grows": watch.grows,
               "grow_count": len(watch.grows), "engines": watch.engines,
               "lint_gauges": {k[len(job) + 1:]: v for k, v in dump.items()
                               if k.startswith(f"{job}.lint.")},
               "typeflow_gauges": {k[len(job) + 1:]: v for k, v in dump.items()
                                   if k.startswith(f"{job}.typeflow.")}}
        return dict(out), row, env

    res_w, row_w, env_w = run("warn")
    gc.collect()
    torch.cuda.empty_cache()
    res_o, row_o, env_o = run("off")
    check(len(row_w["engines"]) == 1 and row_w["engines"][0]["tier"]
          == "VectorizedTumblingWindows" and row_o["engines"][0]["tier"]
          == "VectorizedTumblingWindows",
          f"analysis (a): both runs on the scatter tier ({row_w['engines']}, "
          f"{row_o['engines']})")
    eng_w, eng_o = row_w["engines"][0], row_o["engines"][0]
    check(eng_w["predicted_slots"] == distinct,
          f"analysis (a): _predicted_slots {eng_w['predicted_slots']} equals "
          f"np.unique of the keys ({distinct})")
    check(eng_w["capacity"] == 1 << 20 and row_w["grow_count"] == 0,
          f"analysis (a) warn: capacity {eng_w['capacity']} at the first flush "
          f"(2^20) and no grow_state ({row_w['grows']})")
    check(eng_o["predicted_slots"] is None and eng_o["capacity"] == 1 << 14
          and row_o["grow_count"] >= 1,
          f"analysis (a) off: capacity {eng_o['capacity']} at the first flush "
          f"and {row_o['grow_count']} grows ({row_o['grows']})")
    tf = env_w._last_typeflow
    check(tf is not None and env_o._last_typeflow is None,
          "analysis (a): the prover ran under warn only")
    check(tf.summary()["predicted_state_bytes"] == distinct * slot_bytes,
          f"analysis (a): typeflow.predicted_state_bytes "
          f"{tf.summary()['predicted_state_bytes']} = {distinct} x {slot_bytes}")
    check(row_w["typeflow_gauges"].get("typeflow.predicted_state_bytes")
          == distinct * slot_bytes and "lint.errors" in row_w["lint_gauges"]
          and "lint.errors" in row_o["lint_gauges"]
          and not row_o["typeflow_gauges"],
          "analysis (a): lint.* gauges in both jobs' registries, typeflow.* "
          "in the warn job's")
    check(len(res_w) == distinct and res_w == res_o,
          f"analysis (a): {len(res_w)} per-key estimates bit-equal between "
          f"warn and off")
    uniq = np.unique(users)
    sample = np.sort(rng.choice(uniq, n_sample, replace=False))
    sel = np.isin(users, sample)
    want = hll_reference(np.searchsorted(sample, users[sel]),
                         splitmix64_np(visitors[sel]), len(sample), p)
    got = np.array([res_w[int(u)] for u in sample])
    check(allclose(got, want, rtol=1e-5, atol=hll_atol(1 << p)),
          f"analysis (a): {n_sample} sampled keys within rtol 1e-5 (+ log "
          f"slack) of numpy HLL")
    del res_w, res_o, env_w, env_o, items
    return {"events": n_events, "keys": n_keys, "distinct": distinct,
            "p": p, "items_build_s": build_s, "warn": row_w, "off": row_o}


def _analysis_fused(dev, n, n_keys):
    """(b) the chain job's shape with a third stage, under warn and off."""
    import torch
    from flink_tpu_torch import kernels as K
    from flink_tpu_torch.core.config import Configuration
    from flink_tpu_torch.ops.sketches import HyperLogLogAggregate
    from flink_tpu_torch.streaming import chain_fusion as cf
    from flink_tpu_torch.streaming import operators as ops
    from flink_tpu_torch.streaming.columnar import VectorizedCollectionSource
    from flink_tpu_torch.streaming.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.streaming.elements import RecordBatch
    from flink_tpu_torch.streaming.sources import CollectSink
    from flink_tpu_torch.streaming.windowing import Time
    rng = np.random.default_rng(23)
    keys = rng.integers(0, n_keys, n)
    vals = rng.integers(0, 1 << 40, n)
    ts = np.sort(rng.integers(0, 4000, n))
    data = RecordBatch({"f0": keys, "f1": vals}, ts)

    def run(mode):
        conf = Configuration().set("lint.types.mode", mode)
        env = StreamExecutionEnvironment(conf, device=dev)
        agg = HyperLogLogAggregate(12)
        agg.extract_value = lambda e: e[1]
        sink = []
        (env.add_source(VectorizedCollectionSource.from_batch(data, chunk=1 << 16))
            .map(_CHAIN_MAP).filter(_CHAIN_FILTER).map(_CHAIN_MAP2)
            .key_by(0).time_window(Time.milliseconds_of(1000))
            .aggregate(agg, window_function=lambda k, w, v: [
                (int(k), w.start, float(v[0]))])
            .set_parallelism(4)
            .add_sink(CollectSink(sink)))
        # the last operator each node's factory built is the executor's
        # (the linter builds one per node first)
        built = {}
        for nid, node in env.graph.nodes.items():
            def record(_f=node.operator_factory, _nid=nid):
                op = _f()
                built[_nid] = op
                return op
            node.operator_factory = record
        from flink_tpu_torch.analysis import typeflow as tfm
        applied = {}
        real_apply = tfm.apply_static

        def apply_static(graph, report):
            applied.update(real_apply(graph, report))
            return applied
        tfm.apply_static = apply_static
        ops.KERNEL_STATS.reset()
        cf.FUSION_STATS.reset()
        preflight = []
        _timed_preflight(env, preflight)
        before = dict(K.LAUNCHES)
        try:
            t0 = time.perf_counter()
            env.execute(f"analysis-chain-{mode}")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            tfm.apply_static = real_apply
        launched = {k: K.LAUNCHES[k] - before[k] for k in before}
        by_op = {f"{env.graph.nodes[nid].name}#{nid}": op.columnar_decided_by
                 for nid, op in sorted(built.items())
                 if isinstance(op, (ops.StreamMap, ops.StreamFilter))}
        return sorted(sink), {
            "mode": mode, "seconds": secs, "events_per_s": n / secs,
            "preflight_s": preflight[0], "apply_static": applied,
            "kernel_stats": {"probes": ops.KERNEL_STATS.probes,
                             "static_skips": ops.KERNEL_STATS.static_skips},
            "decided_by": by_op,
            "fused_batches": cf.FUSION_STATS.fused_batches,
            "demotions": cf.FUSION_STATS.demotions,
            "chain_route": launched["chain_route"],
            "hll_log_finish": launched["hll_log_finish"]}

    out_w, row_w = run("warn")
    out_o, row_o = run("off")
    check(row_w["apply_static"].get("kernels_proven") == 3,
          f"analysis (b): apply_static proved 3 kernels ({row_w['apply_static']})")
    check(out_w == out_o and len(out_w) > 0,
          f"analysis (b): {len(out_w)} results equal under warn and off")
    check(row_w["chain_route"] > 0 and row_o["chain_route"] > 0
          and row_w["demotions"] == row_o["demotions"] == 0,
          f"analysis (b): chain_route launched ({row_w['chain_route']}, "
          f"{row_o['chain_route']}), no demotion")
    return {"events": n, "keys": n_keys, "parallelism": 4,
            "results": len(out_w), "warn": row_w, "off": row_o}


def _analysis_strict(dev):
    """(c) lint.mode strict refuses a job with an ERROR diagnostic before
    anything reaches the card."""
    import torch
    from flink_tpu_torch import kernels as K
    from flink_tpu_torch.analysis import JobValidationError
    from flink_tpu_torch.core.config import Configuration
    from flink_tpu_torch.ops.sketches import HyperLogLogAggregate
    from flink_tpu_torch.streaming.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.streaming.sources import CollectSink
    from flink_tpu_torch.streaming.windowing import TumblingEventTimeWindows
    env = StreamExecutionEnvironment(
        Configuration().set("lint.mode", "strict"), device=dev)
    agg = HyperLogLogAggregate(12)
    agg.extract_value = lambda e: e[1]
    (env.from_collection([((i % 97, i), i) for i in range(1 << 14)],
                         timestamped=True)
        .key_by(lambda e: [e[0]])                   # FT101: unhashable
        .window(TumblingEventTimeWindows.of(1000))
        .aggregate(agg)
        .add_sink(CollectSink()))
    torch.cuda.synchronize()
    launches0, mem0 = dict(K.LAUNCHES), torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    try:
        env.execute("analysis-strict")
        refused, codes = False, []
    except JobValidationError as e:
        refused, codes = True, e.report.codes()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    check(refused and "FT101" in codes,
          f"analysis (c): strict refused the job ({codes})")
    check(dict(K.LAUNCHES) == launches0
          and torch.cuda.memory_allocated() == mem0
          and env._last_executor is None,
          "analysis (c): no launch, no allocation, no executor")
    return {"refused": refused, "codes": codes, "seconds": secs}


def analysis_phase(dev, n_events=1 << 20, n_keys=1_000_000, p=12,
                   n_sample=4096, n_chain=1 << 18, chain_keys=1_000_000):
    """The pre-flight analysis on the card: (a) config #2 (HLL p = 12,
    one 1 s tumbling window, 2^20 events over a 1M-key space, pair keys
    (u >> 10, u & 1023) so the device window operator takes the scatter
    tier; a 1-D string or integer key is interned onto the log tier) from
    a bounded ``from_collection`` that the prover reads ahead of time,
    run under ``lint.types.mode`` warn and off: under warn the engine
    starts at 2^20 slots (the distinct keys, rounded up to a power of
    two, at most ``_MAX_PRESIZE_SLOTS``) and never grows, under off it
    starts at 2^14 and doubles; the estimates bit-equal between the two
    and within the HLL tolerance of numpy on 4,096 keys; events/s, the
    peak device bytes and the pre-flight's seconds of each; (b) the
    chain job's shape (2^18 config #2 rows, map -> filter -> map ->
    key_by(0) to 4 HLL window subtasks, fused) under warn and off:
    three kernels proven, equal results, chain_route launched, the
    probe counters and each kernel operator's ``decided_by``; (c)
    ``lint.mode`` strict refusing an FT101 job with no launch and no
    allocation.  2^20 rows is ``_MAX_AOT_ROWS``: above it the prover
    reads no keys and pre-sizes nothing."""
    out = {"presize": _analysis_presize(dev, n_events, n_keys, p, n_sample)}
    emit({"analysis": {"presize": out["presize"]}})
    out["fused"] = _analysis_fused(dev, n_chain, chain_keys)
    emit({"analysis": {"fused": out["fused"]}})
    out["strict"] = _analysis_strict(dev)
    emit({"analysis": {"strict": out["strict"]}})
    return out


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
                                 "chain_route")),
         ("window_api", "window_api_phase", ("hll_update", "hll_estimate",
                                             "clear_rows", "scatter_combine")),
         ("recovery", "recovery_phase", ("hll_update", "hll_estimate",
                                         "clear_rows", "set_rows",
                                         "hll_log_finish")),
         ("telemetry", "telemetry_phase", ("hll_update", "hll_estimate",
                                           "clear_rows", "hll_log_finish",
                                           "chain_route")),
         ("sql", "sql_phase", ("hll_log_finish", "hll_update", "hll_estimate",
                               "merge_rows", "shard_pack", "clear_rows")),
         ("sources", "sources_phase", ("scatter_combine", "clear_rows",
                                       "hll_update", "hll_estimate",
                                       "set_rows", "hll_log_finish")),
         ("datastream_api", "datastream_api_phase", ("hll_update", "hll_estimate",
                                                     "scatter_combine",
                                                     "clear_rows", "set_rows")),
         ("analysis", "analysis_phase", ("hll_update", "hll_estimate",
                                         "clear_rows", "chain_route",
                                         "hll_log_finish")))


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
    # the graph path's host references run beside the paths before it
    t0 = time.perf_counter()
    graph_references_start(dev)
    seconds["graph_references_start"] = time.perf_counter() - t0
    # every job's pre-flight (execute's lint gates), summed per path
    from flink_tpu_torch.streaming.datastream import StreamExecutionEnvironment
    real_preflight = StreamExecutionEnvironment._preflight
    preflight = {}

    def timed_preflight(env, job_name):
        t = time.perf_counter()
        try:
            return real_preflight(env, job_name)
        finally:
            preflight[current] = preflight.get(current, 0.0) + \
                time.perf_counter() - t
    StreamExecutionEnvironment._preflight = timed_preflight
    try:
        for path, phase, needs in PATHS:
            current = path
            t0 = time.perf_counter()
            K.reset_launch_counts()             # each main-path run starts here
            globals()[phase](dev)
            per_path[path] = dict(K.LAUNCHES)
            seconds[path] = time.perf_counter() - t0
            for kname in needs:
                check(per_path[path][kname] > 0, f"{kname} launched on the {path} path")
    finally:
        StreamExecutionEnvironment._preflight = real_preflight
        graph_references_stop()
    emit({"launches": per_path})
    emit({"seconds": seconds})
    emit({"preflight_seconds": preflight})
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
