#!/usr/bin/env python3
"""The designs that ``clear_rows``, ``hll_update``, ``countmin_update``,
``table_insert``, ``quantile_result``, ``gram_accumulate``,
``edge_popcount``, ``merge_rows``, ``hll_log_finish``,
``quantile_update``, ``knn_topk`` and ``countmin_query`` were measured
against, and their floors, timed beside the kernels on the card at ``chip_smoke.py``'s
entry shapes; and the host time of a small launch, part by part.

    python3 scripts/kernel_probe.py [--groups clear_rows,hll_update,countmin,table_insert,quantile_result,quantile_wide,gram_accumulate,edge_popcount,merge_rows,launch_host,hll_log_finish,quantile_update,knn_topk,countmin_query,slot_rule]

Builds ``scripts/kernel_probe.cu`` (which includes nine kernels'
sources) with the loader's nvcc flags into the kernels' build directory
and prints one JSON object; every time is ``chip_smoke.cuda_ms`` (a
run of calls between one pair of CUDA events, / reps, or one call per
event pair after an untimed clear or restore, the median:
``*_after_clear``, ``single``).  ``--groups`` picks what runs (default:
all):

- ``clear_range``: the kernel's range form (a block a 32 KiB chunk), the
  same kernel with 8 blocks an SM walking the chunks (``walking``) and
  that with streaming stores (``streaming``), the
  TMA bulk-store form (``bulk``) and ``fill_`` over the whole [1.25M,
  4096] uint8 file (5.12 GB), in turns (each way, then each way again in
  reverse order); ``clear_list``: the list form over 2^18 random slots,
  over the same slots sorted, and the range form over as many bytes;
- ``hll``: 2^20 compressed rows (uint16 registers) into that file: the
  kernel, and for 1, 2, 4 and 8 rows a thread every row loading its word
  before its CAS (``load``), every row trying a CAS on an empty word
  first (``cas``) and the kernel's per-warp choice between the two
  (``sampled``), and the tiles ordered by address (``sorted``, 8 rows),
  each after a clear and onto the registers the batch left (every row
  loses); then with the slots confined to 262,144 slots (1 GiB) and to
  16,384 slots (64 MiB), to see what the walk over 5 GB costs;
  ``scatter_reduce_`` amax after a clear beside them.  Each variant's
  registers are checked bit-equal to the kernel's.
- ``countmin``: 2^19 records into a [2^14, 4, 2048] int32 table, weight
  1: the kernel, and its atomics alone (``atomics_only``: the same 4 + 1
  adds a record at cell indices made beforehand, loading only them;
  ``atomics_hashed``: as many adds at hashed cells, loading nothing;
  ``loads_only``: loads of the indexed cells in place of the adds),
  each a run; the indexed atomics' table is checked equal to the
  kernel's.  Then the same at 64 slots (a 2 MiB table the L2 holds).
- ``table_insert``: ``chip_smoke.table_insert_cases``' four states with
  1, 2, 4, 8 and 16 lanes a record (``g1`` .. ``g16``; the kernel is
  one of them), each checked as a key -> slot map and timed one call
  per event pair after a restore (all hits: a run).
- ``quantile_result``: the kernel's floor, a plain streaming read and
  sum of the same bytes (``stream_sum``), beside the kernel, at the
  config #3 geometry (2^20 rows of 210 buckets, from row 0 of a 2^22-row
  file) and the default one (2^17 rows of 2,075), in turns.
- ``quantile_wide``: the kernel (its launcher's pick of form) against
  its global-memory form forced, at 2,075 to 13,818 buckets (about 256
  MiB of rows each), in turns; the forced form checked bit-equal to the
  plain version.
- ``edge_popcount``: at the scale-18 triangle input, the bitset's
  streaming read (``stream_bitset``), the small rows' lists read alone in
  the plan's pair order (``lists_alone``), the pair pass in its
  shared-memory form and its global form forced, and the whole call.
- ``merge_rows``: the int32 add of 4,096 pairs of 32 KiB rows folded four
  to a target (the session Count-Min merge): the kernel, its atomics
  alone, its loads alone and the two in 4-byte words.
- ``launch_host``: host microseconds of a small ``merge_rows`` call and
  of its parts (checks, argument pack, stream handle, the launch, the
  ctypes call with no kernel), 20,000 calls each; and of an
  ``hll_log_finish`` call at the mesh launch shape and of its launch.
- ``gram_accumulate``: at MovieLens-20M's shape, f = 10, the factor-row
  gathers alone (``gathers``: each rating's column, value and factor
  row loaded and added up, no row structure) and the gathers with the
  FMAs (``gathers_fma``: each rating's 65 products added in registers),
  beside the kernel on its default plan, on both sides, in turns.
- ``hll_log_finish``: at the config #2 entry (the compacted cells of
  2^23 events over 1M keys) and at one of the mesh path's launches
  (``chip_smoke.MESH_LOG_FINISH``), the kernel against a streaming read
  of as many bytes as its ranks and run ends, a write of its estimates
  alone, itself at forced lanes a key, and its two tiled forms not kept
  (``registers``, ``staged``; the latter with each part taken out), in
  turns; device ms from a profiler trace.  Then config #2 with its keys
  drawn from a Zipf law (s = 0.99, YCSB's zipfian constant, over the
  same 1M keys): the kernel, and the launcher's lanes and 1 lane a key
  each with the warp's round for long runs and without it.
- ``quantile_update``: at the entry (2^19 lognormal values into a [2^22,
  210] int32 file), the kernel against its atomics alone at flat cell
  indices made beforehand, a plain load and store at the same cells,
  and a read of its inputs alone, in turns; its sector floor.
- ``knn_topk``: at the MNIST entry (10,000 x 60,000, k = 3), the kernel
  against a streaming read of qx, in turns.
- ``countmin_query``: at the entry (2^20 queries into a [2^14, 4, 2048]
  int32 table) and at the heavy_hitters phase's layout (2^19 queries
  into 100,000 live slots of [2^18, 4, 2048], 8 GiB;
  ``chip_smoke.countmin_query_inputs``): the kernel, the design before
  it (``old``), 1, 2, 4 and 8 queries a thread (a group a thread; 2 is
  the kernel's), 2 with cached loads, and 1, 2 and 4 on a grid capped
  at what the SMs hold at the kernel's occupancy (``*_capped``);
  its gathers alone at flat int64 cells made beforehand, in query order
  and in ascending cell order (``gathers_sorted``); its inputs alone;
  in turns, with device ms from a profiler trace.  Each form's and the
  gathers' estimates checked bit-equal to the plain version; the bound
  and the sector floor (32 B a distinct sector, 16 B a query).
- ``slot_rule``: the gathered ``hll_estimate`` at 2^18 of 1.25M slots
  (p = 12, 5.12 GB of registers): the kernel, and a copy of it with
  each rule for the slot's row (``ft_probe_hll_gathered``: the clamp of
  the design before, the wrap and clamp in 64 bits, ``ft_gather_row``,
  and two 32-bit forms), in turns, with device ms; each form's estimates
  checked equal to the kernel's.

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "scripts" / "kernel_probe.cu"


def _build() -> ctypes.CDLL:
    from flink_tpu_torch.kernels import loader
    csrc = ROOT / "flink_tpu_torch" / "kernels" / "csrc"
    h = hashlib.sha256()
    for f in (SRC, *sorted(csrc.glob("*.cuh")),
              *(csrc / f"{k}.cu" for k in KERNELS)):
        h.update(f.read_bytes())
    out = ROOT / "flink_tpu_torch" / "kernels" / "_build" / \
        f"kernel_probe-{h.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        res = subprocess.run([loader.nvcc_path(), *loader._FLAGS, "-o", str(out),
                              str(SRC)], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for kernel_probe.cu:\n{res.stdout}"
                               f"{res.stderr}")
    lib = ctypes.CDLL(str(out))
    P, LL, I, ULL = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_ulonglong
    lib.ft_probe_clear_range_bulk.argtypes = (P, LL, ULL, ULL, P)
    lib.ft_probe_clear_range.argtypes = (P, LL, I, P)
    lib.ft_probe_hll_update.argtypes = (P, P, P, P, LL, LL, LL, I, I, P)
    lib.ft_probe_countmin_red.argtypes = (P, P, P, P, LL, I, LL, LL, I, P)
    lib.ft_probe_table_insert.argtypes = (P, P, P, LL, P, P, P, P, LL, LL, LL,
                                          I, P, P, I, P)
    lib.ft_probe_stream_sum.argtypes = (P, LL, P, I, P)
    lib.ft_probe_gram_gather.argtypes = (P, P, P, LL, I, I, P, P)
    lib.ft_probe_quantile_global.argtypes = (P, P, LL, LL, LL, P, I, P, P, P)
    lib.ft_probe_edge_lists.argtypes = (P, LL, P, P, P, LL, P, P)
    lib.ft_probe_merge_add.argtypes = (P, P, P, LL, LL, I, P)
    lib.ft_probe_quantile_red.argtypes = (P, P, P, P, LL, I, P)
    lib.ft_probe_hll_finish_registers.argtypes = (P, P, LL, I, LL, ctypes.c_double, P,
                                                  P, P, P)
    lib.ft_probe_hll_log_finish.argtypes = (P, P, LL, I, I, LL, ctypes.c_double, P, P,
                                            P)
    lib.ft_probe_hll_lanes.argtypes = (LL, LL)
    lib.ft_probe_hll_finish_parts.argtypes = (P, P, LL, I, LL, ctypes.c_double, P, P,
                                              I, P)
    lib.ft_probe_countmin_query.argtypes = (P, P, P, P, LL, I, LL, LL, P, I, P)
    lib.ft_probe_cmq_gathers.argtypes = (P, P, LL, P, P)
    lib.ft_probe_cmq_inputs.argtypes = (P, P, P, LL, P, P)
    lib.ft_probe_hll_gathered.argtypes = (P, P, LL, LL, LL, ctypes.c_float, P, I, P)
    return lib


#: the kernels whose sources kernel_probe.cu includes
KERNELS = ("clear_rows", "countmin_update", "hll_update", "table_insert",
           "gram_accumulate", "quantile_result", "knn_topk", "hll_log_finish",
           "countmin_query")
GROUPS = ("clear_rows", "hll_update", "countmin", "table_insert",
          "quantile_result", "quantile_wide", "gram_accumulate", "edge_popcount",
          "merge_rows", "launch_host", "hll_log_finish", "quantile_update",
          "knn_topk", "countmin_query", "slot_rule")


def _stream():
    import torch
    return torch.cuda.current_stream().cuda_stream


def _ok(err):
    if err != 0:
        raise RuntimeError(f"probe launch failed with CUDA error {err}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--groups", default=",".join(GROUPS),
                    help="comma-separated, from " + ", ".join(GROUPS))
    groups = ap.parse_args().groups.split(",")
    if set(groups) - set(GROUPS):
        ap.error(f"unknown groups {sorted(set(groups) - set(GROUPS))}")
    sys.path.insert(0, str(ROOT))
    import torch
    from flink_tpu_torch import kernels as K
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    K.build_all((*KERNELS, "quantile_update", "quantile_result", "edge_popcount",
                 "merge_rows", "hll_log_finish", "knn_topk"))
    lib = _build()
    res = {"device": torch.cuda.get_device_name(0), "nvidia_smi": cs.nvidia_smi()}
    if "clear_rows" in groups or "hll_update" in groups:
        _clear_and_hll(K, cs, lib, res, groups)
    if "countmin" in groups:
        res["countmin"] = _countmin(K, cs, lib)
    if "table_insert" in groups:
        res["table_insert"] = _table_insert(K, cs, lib)
    if "quantile_result" in groups:
        res["quantile_result"] = _quantile(K, cs, lib)
    if "quantile_wide" in groups:
        res["quantile_wide"] = _quantile_wide(K, cs, lib)
    if "gram_accumulate" in groups:
        res["gram_accumulate"] = _gram(K, cs, lib)
    if "edge_popcount" in groups:
        res["edge_popcount"] = _edge_popcount(K, cs, lib)
    if "merge_rows" in groups:
        res["merge_rows"] = _merge_rows(K, cs, lib)
    if "launch_host" in groups:
        res["launch_host"] = _launch_host(K, cs)
    if "hll_log_finish" in groups:
        res["hll_log_finish"] = _hll_log_finish(K, cs, lib)
    if "quantile_update" in groups:
        res["quantile_update"] = _quantile_update(K, cs, lib)
    if "knn_topk" in groups:
        res["knn_topk"] = _knn_topk(K, cs, lib)
    if "countmin_query" in groups:
        res["countmin_query"] = _countmin_query(K, cs, lib)
    if "slot_rule" in groups:
        res["slot_rule"] = _slot_rule(K, cs, lib)
    print(json.dumps(res), flush=True)
    return 0


def _clear_and_hll(K, cs, lib, res, groups):
    import torch
    from flink_tpu_torch.ops.sketches import HyperLogLogAggregate
    dev = torch.device("cuda", 0)
    stream, ok = _stream, _ok
    C, P, N = 1_250_000, 12, 1 << 20
    m = 1 << P
    regs = torch.zeros((C, m), dtype=torch.uint8, device=dev)

    if "clear_rows" in groups:
        # the range clear, five ways, in turns
        ways = {"kernel": lambda: K.clear_rows(regs, 0),
                "walking": lambda: ok(lib.ft_probe_clear_range(
                    regs.data_ptr(), regs.numel(), 0, stream())),
                "streaming": lambda: ok(lib.ft_probe_clear_range(
                    regs.data_ptr(), regs.numel(), 1, stream())),
                "bulk": lambda: ok(lib.ft_probe_clear_range_bulk(
                    regs.data_ptr(), regs.numel(), 0, 0, stream())),
                "fill_": lambda: regs.fill_(0)}
        times = {k: [] for k in ways}
        for k in [*ways, *reversed(ways)]:
            times[k].append(cs.cuda_ms(ways[k], 20))
        filled = {}
        for k, fn in ways.items():
            regs.fill_(7)
            fn()
            torch.cuda.synchronize()
            filled[k] = int(regs.max()) == 0
        res["clear_range"] = {"bytes": regs.numel(), "ms": times, "filled": filled,
                              "bound_ms": cs.bound(regs.numel(), 0, 3.35e12)[0]}
        # the list form: 2^18 random slots, the same slots sorted, and the
        # range form over as many bytes
        lslots = np.random.default_rng(13).integers(0, C, 1 << 18).astype(np.int32)
        listed = {"random": torch.from_numpy(lslots).to(dev),
                  "sorted": torch.from_numpy(np.sort(lslots)).to(dev)}
        res["clear_list"] = {k: cs.cuda_ms(lambda s=s: K.clear_rows(regs, 0, slots=s), 20)
                             for k, s in listed.items()}
        res["clear_list"]["range_same_bytes"] = cs.cuda_ms(
            lambda: K.clear_rows(regs, 0, start=0, count=1 << 18), 20)
        res["clear_list"]["bound_ms"] = cs.bound((1 << 18) * (m + 4), 0, 3.35e12)[0]

    if "hll_update" in groups:
        # hll_update: chip_smoke.kernel_phase's batch
        rng = np.random.default_rng(11)
        slots_np = rng.integers(0, 1_000_000, N).astype(np.int32)
        vh = cs.splitmix64_np(rng.integers(0, 2**63, N, dtype=np.int64))
        agg = HyperLogLogAggregate(P)
        rank_np, reg_np = agg.compress_value_hash(
            (vh >> np.uint64(32)).astype(np.uint32),
            (vh & np.uint64(0xFFFFFFFF)).astype(np.uint32))
        rank = torch.from_numpy(rank_np).to(dev)
        reg = torch.from_numpy(reg_np.view(np.int16)).to(dev)
        clear = lambda: K.clear_rows(regs, 0)                    # noqa: E731
        hll = {}
        for corner in (None, 1 << 18, 1 << 14):
            sl = slots_np if corner is None else slots_np % corner
            slots = torch.from_numpy(sl).to(dev)
            tag = "file" if corner is None else f"{corner}_slots"
            clear()
            K.hll_update(regs, slots, rank, reg, N)
            want = regs.clone()

            def probe(r, mode, s=slots):
                return lambda: ok(lib.ft_probe_hll_update(
                    regs.data_ptr(), s.data_ptr(), rank.data_ptr(), reg.data_ptr(),
                    N, m, C, r, mode, stream()))

            variants = {"kernel": lambda s=slots: K.hll_update(regs, s, rank, reg, N)}
            for r in ((1, 2, 4, 8) if corner is None else (8,)):
                for mode, name in ((0, "load"), (1, "cas"), (3, "sampled")):
                    variants[f"{name}_r{r}"] = probe(r, mode)
            variants["sorted_r8"] = probe(8, 2)
            out = {}
            for name, fn in variants.items():
                clear()
                fn()
                torch.cuda.synchronize()
                equal = bool(torch.equal(regs, want))
                after = cs.cuda_ms(fn, 10, clear)
                clear()
                onto = cs.cuda_ms(fn, 10)                   # the batch onto itself
                out[name] = {"after_clear_ms": after, "onto_itself_ms": onto,
                             "bit_equal": equal}
            idx = slots.to(torch.int64) * m + reg.to(torch.int64)
            flat = regs.view(-1)
            out["scatter_reduce_"] = {"after_clear_ms": cs.cuda_ms(
                lambda: flat.scatter_reduce_(0, idx, rank, "amax"), 10, clear)}
            hll[tag] = out
            del want, idx, slots
            torch.cuda.empty_cache()
        res["hll"] = hll



def _countmin(K, cs, lib):
    import torch
    from flink_tpu_torch.ops.hashing import countmin_rows
    dev = torch.device("cuda", 0)
    out = {}
    for S in (1 << 14, 64):
        rng = np.random.default_rng(17)
        D, W, N = 4, 2048, 1 << 19
        slots = torch.from_numpy(rng.integers(0, S, N).astype(np.int32)).to(dev)
        ones = torch.ones(N, dtype=torch.float32, device=dev)
        vh = cs.splitmix64_np(rng.integers(0, 2**63, N, dtype=np.int64))
        hi, lo = (torch.from_numpy(a).to(dev) for a in cs.lanes_np(vh))
        cells = ((slots.to(torch.int64)[:, None] * D
                  + torch.arange(D, device=dev)[None, :]) * W
                 + countmin_rows(hi, lo, D, W).to(torch.int64).t()).to(torch.int32)
        cells = cells.contiguous()                 # [N, D], record-major
        table = torch.zeros((S, D, W), dtype=torch.int32, device=dev)
        total = torch.zeros(S, dtype=torch.int32, device=dev)
        ref, rtot = table.clone(), total.clone()

        def red(variant, t=table, tot=total, c=cells, s=slots, S=S):
            return lambda: _ok(lib.ft_probe_countmin_red(
                t.data_ptr(), tot.data_ptr(), c.data_ptr(), s.data_ptr(),
                N, D, S * D * W, S, variant, _stream()))
        K.countmin_update(table, total, slots, ones, hi, lo, N)
        red(0, ref, rtot)()
        torch.cuda.synchronize()
        row = {"records": N, "table": [S, D, W],
               "indexed_atomics_equal_kernel": bool(torch.equal(table, ref)
                                                    and torch.equal(total, rtot))}
        ways = {"kernel": lambda t=table, tot=total, s=slots, h=hi, l=lo, o=ones:
                K.countmin_update(t, tot, s, o, h, l, N),
                "atomics_only": red(0), "atomics_hashed": red(1),
                "loads_only": red(2)}
        times = {k: [] for k in ways}
        for k in [*ways, *reversed(ways)]:
            times[k].append(cs.cuda_ms(ways[k], 20))
        row["ms"] = times
        out[f"slots_{S}"] = row
        del table, total, ref, rtot, cells
        torch.cuda.empty_cache()
    return out


def _table_insert(K, cs, lib):
    import torch
    from flink_tpu_torch.ops.device_table import key_map_faults, make_table
    dev = torch.device("cuda", 0)
    C, P = cs.TI_POSITIONS, cs.TI_MAX_PROBES
    n = cs.TI_RECORDS - 1000
    live = np.arange(cs.TI_RECORDS) < n
    out = {}
    for case in cs.table_insert_cases(dev, np.random.default_rng(19)):
        state, (h_d, l_d), kw = case["state"], case["lanes"], case["kw"]
        reg = kw.get("region")
        size = kw.get("region_size", 0)
        card, plain = make_table(C, dev), make_table(C, dev)
        for t in (card, plain):
            case["fill"](t)
        K.table_insert_plain(*plain, h_d, l_d, n, P, **kw)
        saved = [a.clone() for a in card]

        def restore(c=card, s=saved):
            for a, b in zip(c, s):
                a.copy_(b)

        row = {}
        for g in (1, 2, 4, 8, 16):
            slots = torch.empty(len(h_d), dtype=torch.int32, device=dev)
            ov = torch.zeros(1, dtype=torch.int64, device=dev)

            def call(g=g, slots=slots, ov=ov):
                _ok(lib.ft_probe_table_insert(
                    card.key_hi.data_ptr(), card.key_lo.data_ptr(),
                    card.occupied.data_ptr(), C, h_d.data_ptr(), l_d.data_ptr(),
                    None, None if reg is None else reg.data_ptr(), size, n,
                    len(h_d), P, slots.data_ptr(), ov.data_ptr(), g, _stream()))
            restore()
            call()
            torch.cuda.synchronize()
            got = slots.cpu().numpy()
            faults, _ = key_map_faults(card, case["hi"], case["lo"], got, P, live,
                                       case["region"], size, reference=plain)
            faults["unresolved"] = int((got[live] < 0).sum())
            ms = (cs.cuda_ms(call, 20) if state == "all_hits"
                  else cs.cuda_ms(call, 10, restore))
            row[f"g{g}"] = {"ms": ms, "faults": faults, "overflow": int(ov)}
        out[state] = row
        del card, plain, saved
    return out

def _in_turns(cs, ways, reps=20):
    """Each way timed, then each again in reverse order."""
    times = {k: [] for k in ways}
    for k in [*ways, *reversed(ways)]:
        times[k].append(cs.cuda_ms(ways[k], reps))
    return times


def _quantile(K, cs, lib):
    import torch
    from flink_tpu_torch.ops.sketches import QuantileSketchAggregate
    dev = torch.device("cuda", 0)
    out = {}
    rng = np.random.default_rng(23)
    blocks = 132 * 8
    acc = torch.zeros(blocks, dtype=torch.int32, device=dev)
    for tag, geometry, C, R in (("config3", cs.Q3, 1 << 22, 1 << 20),
                                ("default", {}, 1 << 17, 1 << 17)):
        agg = QuantileSketchAggregate(**geometry)
        B, N = agg.buckets, 1 << 19
        hist = torch.zeros((C, B), dtype=torch.int32, device=dev)
        K.quantile_update(hist, torch.from_numpy(rng.integers(0, C, N).astype(np.int32)).to(dev),
                          torch.from_numpy(rng.lognormal(3.0, 1.0, N).astype(np.float32)).to(dev),
                          N, agg.min_value, agg.log_gamma, agg.offset)
        rows = hist[:R]
        qs, bv = agg._tables(dev)
        nbytes = R * B * 4 // 16 * 16
        ways = {"kernel": lambda r=rows, q=qs, b=bv: K.quantile_result(r, q, b),
                "stream_sum": lambda r=rows, n=nbytes: _ok(lib.ft_probe_stream_sum(
                    r.data_ptr(), n, acc.data_ptr(), blocks, _stream()))}
        out[tag] = {"rows": R, "buckets": B, "ms": _in_turns(cs, ways),
                    "bound_ms": cs.bound(R * B * 4 + R * 8, 2 * R * B, 3.35e12)[0]}
        del hist, rows
        torch.cuda.empty_cache()
    return out


def _quantile_wide(K, cs, lib):
    """The kernel (its launcher's pick) against the global-memory form
    forced, at widths from 2,075 to 13,818 buckets (relative accuracy
    0.01 to 0.0015 over 1e-9 .. 1e9), about 256 MiB of rows, Q = 5."""
    import torch
    from flink_tpu_torch.ops.sketches import QuantileSketchAggregate
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(29)
    out = {}
    for acc in (0.01, 0.007, 0.0047, 0.004, 0.003, 0.002, 0.0015):
        agg = QuantileSketchAggregate(quantiles=(0.0, 0.25, 0.5, 0.99, 1.0),
                                      relative_accuracy=acc)
        B = agg.buckets
        R, N = (1 << 26) // B, 1 << 22
        hist = torch.zeros((R, B), dtype=torch.int32, device=dev)
        K.quantile_update(hist, torch.from_numpy(rng.integers(0, R, N).astype(np.int32)).to(dev),
                          torch.from_numpy(rng.lognormal(3.0, 1.0, N).astype(np.float32)).to(dev),
                          N, agg.min_value, agg.log_gamma, agg.offset)
        qs, bv = agg._tables(dev)
        res = torch.empty((R, 5), dtype=torch.float32, device=dev)

        def forced(h=hist, r=R, b=B, q=qs, v=bv, o=res):
            _ok(lib.ft_probe_quantile_global(h.data_ptr(), None, r, b, r, q.data_ptr(), 5,
                                             v.data_ptr(), o.data_ptr(), _stream()))
        forced()
        same = bool(torch.equal(res, K.quantile_result_plain(hist, qs, bv)))
        ways = {"kernel": lambda h=hist, q=qs, v=bv: K.quantile_result(h, q, v),
                "global": forced}
        out[str(acc)] = {"buckets": B, "rows": R, "global_bit_equal": same,
                         "ms": _in_turns(cs, ways),
                         "bound_ms": cs.bound(R * B * 4 + R * 20, 2 * R * B, 3.35e12)[0]}
        del hist, res
        torch.cuda.empty_cache()
    return out


def _gram(K, cs, lib):
    import torch
    from flink_tpu_torch.kernels.gram_accumulate import rating_csr
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(31)
    u, i, r = cs.movielens_shape(rng)
    V = torch.from_numpy(rng.normal(0, 0.1, (int(i.max()) + 1, 10))
                         .astype(np.float32)).to(dev)
    U = torch.from_numpy(np.random.default_rng(32).normal(0, 0.1, (int(u.max()) + 1, 10))
                         .astype(np.float32)).to(dev)
    blocks = 132 * 16
    sink = torch.empty(blocks * 128, dtype=torch.float32, device=dev)
    out = {}
    for name, rows, cols, fixed in (("users", u, i, V), ("items", i, u, U)):
        indptr, c, v = rating_csr(*(torch.from_numpy(a).to(dev) for a in (rows, cols, r)),
                                  int(rows.max()) + 1)
        plan = K.gram_plan(indptr)
        n = len(c)

        def probe(variant, c=c, v=v, fixed=fixed, n=n):
            return lambda: _ok(lib.ft_probe_gram_gather(
                fixed.data_ptr(), c.data_ptr(), v.data_ptr(), n, blocks, variant,
                sink.data_ptr(), _stream()))
        ways = {"kernel": lambda f=fixed, ip=indptr, c=c, v=v, p=plan:
                K.gram_accumulate(f, ip, c, v, plan=p),
                "gathers": probe(0), "gathers_fma": probe(1)}
        nr, f = len(indptr) - 1, 10
        out[name] = {"ratings": n, "ms": _in_turns(cs, ways, 10),
                     "bound_ms": cs.gram_bound(n, nr, len(fixed), f, 3.35e12)[0]}
    return out


def _edge_popcount(K, cs, lib):
    """At chip_smoke's scale-18 triangle input: the bitset's streaming
    read, the small rows' lists read alone in the plan's pair order, the
    pair pass (its shared-memory form and its global form forced) and
    the whole call, in turns."""
    import torch
    from flink_tpu_torch.graph import library as tlib
    from flink_tpu_torch.kernels import loader
    from flink_tpu_torch.kernels.edge_popcount import _vec
    dev = torch.device("cuda", 0)
    n = 1 << 18
    src, dst, _ = cs.kronecker_edges(dev, 18, seed=62)
    pairs = tlib._NeighborPairs(cs._graph(src, dst, np.ones(len(src), np.float32),
                                          n)).pairs
    u, v = (torch.from_numpy(np.ascontiguousarray(pairs[:, i], np.int32)).to(dev)
            for i in (0, 1))
    adj = tlib.adjacency_bitset(n, u, v)
    plan = K.popcount_plan(adj, u, v)
    blocks = 132 * 8
    acc = torch.zeros(blocks, dtype=torch.int32, device=dev)
    out = torch.empty_like(u)
    words, p = adj.shape[1], len(u)

    def pairs_form(global_form):
        return lambda: loader.launch(
            "edge_popcount", "ft_edge_popcount", adj.data_ptr(), words, _vec(adj),
            plan.counts.data_ptr(), plan.dense_above, plan.offsets.data_ptr(),
            plan.entries.data_ptr(), plan.big.data_ptr(), plan.small.data_ptr(),
            plan.order.data_ptr(), p, out.data_ptr(), global_form)
    ways = {"stream_bitset": lambda: _ok(lib.ft_probe_stream_sum(
                adj.data_ptr(), 4 * n * words, acc.data_ptr(), blocks, _stream())),
            "lists_alone": lambda: _ok(lib.ft_probe_edge_lists(
                plan.counts.data_ptr(), plan.dense_above, plan.offsets.data_ptr(),
                plan.entries.data_ptr(), plan.small.data_ptr(), p, acc.data_ptr(),
                _stream())),
            "pairs_shared": pairs_form(0), "pairs_global": pairs_form(1),
            "whole_call": lambda: K.edge_popcount(adj, u, v)}
    return {"pairs": p, "bitset_bytes": 4 * n * words,
            "entries": len(plan.entries), "ms": _in_turns(cs, ways, 5),
            "bitset_read_ms": cs.bound(4 * n * words, 0, 3.35e12)[0]}


def _merge_rows(K, cs, lib):
    """merge_rows' int32 add at the session Count-Min row (32 KiB), 4,096
    sources folded four to a target of an 8,192-row table: the kernel
    against its atomics alone, its loads alone and both in 4-byte words,
    in turns; the table checked equal to the kernel's after the adds."""
    import torch
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(19)
    c, k, row_words = 8192, 4096, 4 * 2048
    perm = rng.permutation(c).astype(np.int32)
    dst = torch.from_numpy(np.repeat(perm[:1024], 4)).to(dev)
    src = torch.from_numpy(perm[1024:1024 + k]).to(dev)
    table = torch.randint(0, 99, (c, 4, 2048), dtype=torch.int32, device=dev)
    ref = table.clone()
    K.merge_rows(table, dst, src, "add")
    _ok(lib.ft_probe_merge_add(ref.data_ptr(), dst.data_ptr(), src.data_ptr(), k,
                               row_words, 2, _stream()))
    torch.cuda.synchronize()
    same = bool(torch.equal(table, ref))

    def probe(variant):
        return lambda: _ok(lib.ft_probe_merge_add(
            table.data_ptr(), dst.data_ptr(), src.data_ptr(), k, row_words, variant,
            _stream()))
    ways = {"kernel": lambda: K.merge_rows(table, dst, src, "add"),
            "atomics_only": probe(0), "loads_only": probe(1), "add_4b_words": probe(2)}
    return {"pairs": k, "row_bytes": 4 * row_words, "probe_equal_kernel": same,
            "ms": _in_turns(cs, ways),
            "bound_ms": cs.bound(k * (4 * row_words + 8) + 2 * 1024 * 4 * row_words,
                                 0, 3.35e12)[0]}


def _launch_host(K, cs, calls=20_000):
    """Host microseconds of one small ``merge_rows`` call and of its
    parts (the main path's form: uint8 max, 2 pairs into one target of a
    [4096, 4096] file), each the mean of ``calls`` calls in a loop ended
    by a synchronisation: the whole call; its tensor checks; the argument
    pack; the stream handle, and the ``torch.cuda.Stream`` object it
    replaces; the launch alone; the same ctypes call with no kernel to
    launch (k = 0).  Then an ``hll_log_finish`` call at the mesh launch
    shape and its launch alone (``loader.launch`` with the arguments
    made beforehand), each the mean of 500 calls queued without a
    synchronisation (the host's time, not the card's)."""
    import time
    import torch
    from flink_tpu_torch.kernels import loader
    from flink_tpu_torch.kernels.merge_rows import _INT32, _PACK
    dev = torch.device("cuda", 0)
    regs = torch.randint(0, 30, (4096, 4096), dtype=torch.uint8, device=dev)
    dst = torch.tensor([5, 5], dtype=torch.int32, device=dev)
    src = torch.tensor([6, 7], dtype=torch.int32, device=dev)
    args = (dst.data_ptr(), src.data_ptr(), 2, 0, regs.data_ptr(), 4096, 4096, 0, 2, 4)
    packed, empty = _PACK[1](*args), _PACK[1](*args[:2], 0, *args[3:])

    def us(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / calls * 1e6
    return {"calls": calls, "us": {
        "merge_rows_call": us(lambda: K.merge_rows(regs, dst, src, "max")),
        "check_all": us(lambda: loader.check_all(regs, (dst, "dst", _INT32, 1),
                                                 (src, "src", _INT32, 1))),
        "pack": us(lambda: _PACK[1](*args)),
        "current_stream": us(loader.current_stream),
        "torch_current_stream": us(lambda: torch.cuda.current_stream().cuda_stream),
        "launch": us(lambda: loader.launch("merge_rows", "ft_merge_rows", packed, 1)),
        "ctypes_call_no_kernel": us(lambda: loader.launch("merge_rows", "ft_merge_rows",
                                                          empty, 1)),
        **_log_finish_host_us(K, cs)}}


def _log_finish_host_us(K, cs, calls=500):
    import time
    import torch
    from flink_tpu_torch.kernels import loader
    from flink_tpu_torch.kernels.hll_log_finish import log_table
    dev = torch.device("cuda", 0)
    r, e, m, alpha, _ = cs.log_finish_inputs(dev, np.random.default_rng(31),
                                             *cs.MESH_LOG_FINISH)
    est = torch.empty(len(e), dtype=torch.float64, device=dev)
    args = (r.data_ptr(), e.data_ptr(), len(e), len(r), m, alpha * m * m,
            log_table(m, dev).data_ptr(), est.data_ptr(), None)

    def us(fn):
        best = float("inf")
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            best = min(best, time.perf_counter() - t0)
        torch.cuda.synchronize()
        return best / calls * 1e6
    return {"hll_log_finish_mesh_call": us(lambda: K.hll_log_finish(r, e, m, alpha)),
            "hll_log_finish_launch": us(lambda: loader.launch(
                "hll_log_finish", "ft_hll_log_finish", *args))}


#: the kernel's words a lane over which the warp sums a run, and a
#: threshold no run reaches (runs hold at most 65,536 cells)
LONG_WORDS = int(re.search(r"#define LF_LONG_WORDS (\d+)", (
    ROOT / "flink_tpu_torch" / "kernels" / "csrc" / "hll_log_finish.cu").read_text())[1])
NO_LONG = 1 << 20


def _zipf_log_finish_inputs(cs, dev, rng, n_events=1 << 23, n_keys=1_000_000,
                            s=0.99, p=12):
    """config #2's compacted cells with the keys drawn from a Zipf law of
    exponent s over the key space (the ranks of popularity shuffled over
    the key ids): (ranks, ends) on dev, m, alpha."""
    import torch
    from flink_tpu_torch import native as nat
    from flink_tpu_torch.ops.sketches import HyperLogLogAggregate
    w = 1.0 / np.arange(1, n_keys + 1, dtype=np.float64) ** s
    ranked = rng.choice(n_keys, n_events, p=w / w.sum())
    keys = rng.permutation(n_keys).astype(np.uint64)[ranked]
    vh = cs.splitmix64_np(rng.integers(0, 2**63, n_events).astype(np.uint64))
    regs, ranks = nat.hll_make_cells(vh, p)
    _, _, crk, ends = nat.hll_log_compact(keys, regs, ranks, p)
    return (torch.from_numpy(crk).to(dev), torch.from_numpy(ends).to(dev),
            1 << p, HyperLogLogAggregate(p).alpha)


def _hll_log_finish(K, cs, lib):
    """hll_log_finish at chip_smoke's config #2 entry and at the shape of
    one of the mesh path's launches: the kernel against a streaming read
    of as many bytes as its ranks and run ends (the floor of its reads),
    a write of its estimates alone (``zero_``), the kernel at forced
    lanes a key (1 to 32), and the two tiled forms not kept (at the
    tiles of keys a block they took there): ``registers`` and
    ``staged``, the latter also with a part taken out (``no_walk``,
    ``no_estimator``, ``no_rank_loads``, ``no_atomics``, and
    ``launch_and_ends`` with all three of the first out), in turns; the
    kernel's and the read's device ms from a profiler trace.  Then
    config #2 with Zipf keys (``zipf``): the kernel, the launcher's lanes
    without the warp's round for long runs (``no_long``), and 1 lane a
    key with and without it, in turns, each checked equal to the
    kernel."""
    import torch
    from flink_tpu_torch.kernels.hll_log_finish import log_table
    dev = torch.device("cuda", 0)
    blocks = 132 * 8
    acc = torch.zeros(blocks, dtype=torch.int32, device=dev)
    out = {}

    def forced(r, e, m, a, est, g, long_words):
        tab = log_table(m, dev)
        return lambda: _ok(lib.ft_probe_hll_log_finish(
            r.data_ptr(), e.data_ptr(), len(e), g, long_words, m, a * m * m,
            tab.data_ptr(), est.data_ptr(), _stream()))

    for tag, shape, tile in (("config2", (1 << 23, 1_000_000), 1024),
                             ("mesh_launch", cs.MESH_LOG_FINISH, 32)):
        r, e, m, alpha, _ = cs.log_finish_inputs(dev, np.random.default_rng(31),
                                                 *shape)
        n_cells, n_keys = len(r), len(e)
        nbytes = (n_cells + 4 * n_keys + 15) // 16 * 16
        buf = torch.ones(nbytes, dtype=torch.uint8, device=dev)
        est = torch.empty(n_keys, dtype=torch.float64, device=dev)
        tab = log_table(m, dev)
        ways = {"kernel": lambda r=r, e=e, m=m, a=alpha: K.hll_log_finish(r, e, m, a),
                "stream_read": lambda b=buf, n=nbytes: _ok(lib.ft_probe_stream_sum(
                    b.data_ptr(), n, acc.data_ptr(), blocks, _stream())),
                "write_estimates": est.zero_,
                "registers": lambda r=r, e=e, m=m, a=alpha: _ok(
                    lib.ft_probe_hll_finish_registers(
                        r.data_ptr(), e.data_ptr(), len(e), tile, m, a * m * m,
                        tab.data_ptr(), est.data_ptr(), None, _stream()))}
        for mode, part in ((0, "staged"), (1, "no_walk"), (2, "no_estimator"),
                           (4, "no_rank_loads"), (8, "no_atomics"),
                           (7, "launch_and_ends")):
            ways[part] = lambda r=r, e=e, m=m, a=alpha, md=mode: _ok(
                lib.ft_probe_hll_finish_parts(r.data_ptr(), e.data_ptr(), len(e), tile,
                                              m, a * m * m, tab.data_ptr(),
                                              est.data_ptr(), md, _stream()))
        for g in (1, 2, 4, 8, 16, 32):
            ways[f"lanes_{g}"] = forced(r, e, m, alpha, est, g, LONG_WORDS)
        want = K.hll_log_finish(r, e, m, alpha)
        same = {}
        for form in ("registers", "staged", *(f"lanes_{g}" for g in (1, 2, 4, 8, 16, 32))):
            est.zero_()
            ways[form]()
            same[form] = bool(torch.equal(est, want))
        out[tag] = {"cells": n_cells, "keys": n_keys, "forms_equal_kernel": same,
                    "lanes_per_key": lib.ft_probe_hll_lanes(n_keys, n_cells),
                    "old_tile": tile, "ms": _in_turns(cs, ways),
                    "device_ms": cs.kernel_device_ms(ways["kernel"]),
                    "lanes_device_ms": {g: cs.kernel_device_ms(ways[f"lanes_{g}"])
                                        for g in (1, 2, 4, 8, 16, 32)},
                    "staged_device_ms": cs.kernel_device_ms(ways["staged"]),
                    "stream_device_ms": cs.kernel_device_ms(ways["stream_read"]),
                    "bound_ms": cs.bound(n_cells + 12 * n_keys, n_cells + 8 * n_keys,
                                         3.35e12)[0]}
        del r, e, buf, est
    r, e, m, alpha = _zipf_log_finish_inputs(cs, dev, np.random.default_rng(43))
    n_cells, n_keys = len(r), len(e)
    lanes = lib.ft_probe_hll_lanes(n_keys, n_cells)
    runs = torch.diff(e.to(torch.int64), prepend=e.new_zeros(1, dtype=torch.int64))
    est = torch.empty(n_keys, dtype=torch.float64, device=dev)
    ways = {"kernel": lambda: K.hll_log_finish(r, e, m, alpha),
            "no_long": forced(r, e, m, alpha, est, lanes, NO_LONG),
            "lanes_1": forced(r, e, m, alpha, est, 1, LONG_WORDS),
            "lanes_1_no_long": forced(r, e, m, alpha, est, 1, NO_LONG)}
    want = K.hll_log_finish(r, e, m, alpha)
    same = {}
    for way in ("no_long", "lanes_1", "lanes_1_no_long"):
        est.zero_()
        ways[way]()
        same[way] = bool(torch.equal(est, want))
    # runs the warp sums: over LONG_WORDS words a lane (a run from byte 15)
    words = (runs + 30) // 16
    out["zipf"] = {"cells": n_cells, "keys": n_keys, "zipf_s": 0.99,
                   "lanes_per_key": lanes, "longest_run": int(runs.max()),
                   "warp_runs_at_lanes": int((words > LONG_WORDS * lanes).sum()),
                   "warp_runs_at_1_lane": int((words > LONG_WORDS).sum()),
                   "ways_equal_kernel": same, "ms": _in_turns(cs, ways),
                   "device_ms": {w: cs.kernel_device_ms(fn) for w, fn in ways.items()},
                   "bound_ms": cs.bound(n_cells + 12 * n_keys, n_cells + 8 * n_keys,
                                        3.35e12)[0]}
    return out


def _quantile_update(K, cs, lib):
    """quantile_update at chip_smoke's entry (2^19 lognormal values into a
    [2^22, 210] int32 file, 3.5 GB): the kernel against (a) its atomics
    alone at flat cell indices made beforehand, (b) a plain load and
    store at the same cells and (c) a read of its inputs alone, in
    turns; (a)'s histogram checked equal to the kernel's.  The sector
    floor: a 32-byte sector read and written per distinct cell, and the
    8 B a record of input."""
    import torch
    from flink_tpu_torch.kernels.quantile_update import bucket_of
    from flink_tpu_torch.ops.sketches import QuantileSketchAggregate
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(29)
    agg = QuantileSketchAggregate(**cs.Q3)
    B, C, N = agg.buckets, 1 << 22, 1 << 19
    slots = torch.from_numpy(rng.integers(0, C, N).astype(np.int32)).to(dev)
    v = torch.from_numpy(rng.lognormal(3.0, 1.0, N).astype(np.float32)).to(dev)
    args = (agg.min_value, agg.log_gamma, agg.offset)
    flat = (slots.to(torch.int64) * B + bucket_of(v, *args, B)).contiguous()
    hist = torch.zeros((C, B), dtype=torch.int32, device=dev)
    ref = torch.zeros_like(hist)
    K.quantile_update(hist, slots, v, N, *args)
    _ok(lib.ft_probe_quantile_red(ref.data_ptr(), flat.data_ptr(), slots.data_ptr(),
                                  v.data_ptr(), N, 0, _stream()))
    torch.cuda.synchronize()
    same = bool(torch.equal(hist, ref))
    del ref
    cells = int(torch.unique(flat).numel())

    def probe(variant):
        return lambda: _ok(lib.ft_probe_quantile_red(
            hist.data_ptr(), flat.data_ptr(), slots.data_ptr(), v.data_ptr(), N,
            variant, _stream()))
    ways = {"kernel": lambda: K.quantile_update(hist, slots, v, N, *args),
            "atomics_only": probe(0), "plain_rmw": probe(1), "inputs_only": probe(2)}
    return {"records": N, "file": [C, B], "distinct_cells": cells,
            "atomics_equal_kernel": same, "ms": _in_turns(cs, ways),
            "bound_ms": cs.bound(8 * N + 8 * cells, 30 * N, 3.35e12)[0],
            "sector_floor_ms": cs.bound(8 * N + 64 * cells, 0, 3.35e12)[0]}


def _knn_topk(K, cs, lib):
    """knn_topk at chip_smoke's MNIST entry (10,000 queries, 60,000
    points, k = 3): the kernel against a streaming read of qx (2.4 GB),
    in turns."""
    import torch
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(37)
    X = torch.from_numpy(cs.mnist_shape(rng, 60_000)).to(dev)
    Q = torch.from_numpy(cs.mnist_shape(rng, 10_000)).to(dev)
    qx = torch.matmul(Q, X.t())
    qn, xn = (Q * Q).sum(1), (X * X).sum(1)
    del X, Q
    blocks = 132 * 8
    acc = torch.zeros(blocks, dtype=torch.int32, device=dev)
    m, n = qx.shape
    ways = {"kernel": lambda: K.knn_topk(qx, qn, xn, 3),
            "stream_qx": lambda: _ok(lib.ft_probe_stream_sum(
                qx.data_ptr(), 4 * m * n, acc.data_ptr(), blocks, _stream()))}
    return {"queries": m, "points": n, "k": 3, "ms": _in_turns(cs, ways, 5),
            "bound_ms": cs.bound(4 * m * n + 4 * (m + n) + 12 * m, 3 * m * n,
                                 3.35e12)[0]}


def _countmin_query(K, cs, lib):
    """countmin_query at chip_smoke's entry and at the heavy_hitters
    phase's layout: the kernel against the forms tried (``ways`` below),
    its gathers alone (in query order and sorted by cell) and its inputs
    alone, in turns; every form checked bit-equal to the plain version."""
    import torch
    from flink_tpu_torch.ops.hashing import countmin_rows
    from flink_tpu_torch.ops.slot_index import gather_rows
    dev = torch.device("cuda", 0)
    out = {}
    for shape in ("entry", "path"):
        table, slots, hi, lo = cs.countmin_query_inputs(dev, np.random.default_rng(43),
                                                        shape)
        Q, (S, D, W) = slots.numel(), table.shape
        r = torch.arange(D, device=dev)[None, :]
        cells = ((gather_rows(slots, S)[:, None] * D + r) * W
                 + countmin_rows(hi, lo, D, W).to(torch.int64).t()).contiguous()
        ordered = torch.sort(cells.reshape(-1)).values
        want = K.countmin_query_plain(table, slots, hi, lo)
        o = torch.empty(Q, dtype=torch.int32, device=dev)

        def form(f):
            return lambda: _ok(lib.ft_probe_countmin_query(
                table.data_ptr(), slots.data_ptr(), hi.data_ptr(), lo.data_ptr(), Q,
                D, W, S, o.data_ptr(), f, _stream()))

        def gathers(c):
            return lambda: _ok(lib.ft_probe_cmq_gathers(
                table.data_ptr(), c.data_ptr(), Q, o.data_ptr(), _stream()))
        ways = {"kernel": lambda: K.countmin_query(table, slots, hi, lo),
                "old": form(0), "per1": form(1), "per2": form(2), "per4": form(4),
                "per8": form(8), "cached2": form(12), "per1_capped": form(101),
                "per2_capped": form(102), "per4_capped": form(104),
                "gathers": gathers(cells),
                "gathers_sorted": gathers(ordered),
                "inputs": lambda: _ok(lib.ft_probe_cmq_inputs(
                    slots.data_ptr(), hi.data_ptr(), lo.data_ptr(), Q, o.data_ptr(),
                    _stream()))}
        equal = {}
        for name in ("old", "per1", "per2", "per4", "per8", "cached2",
                     "per1_capped", "per2_capped", "per4_capped", "gathers"):
            o.zero_()
            ways[name]()
            torch.cuda.synchronize()
            equal[name] = bool(torch.equal(o, want))
        equal["kernel"] = bool(torch.equal(ways["kernel"](), want))
        sectors = int(torch.unique(cells // 8).numel())
        n_cells = int(torch.unique(cells).numel())
        out[shape] = {"queries": Q, "table": [S, D, W], "distinct_cells": n_cells,
                      "distinct_sectors": sectors, "equal_to_plain": equal,
                      "ms": _in_turns(cs, ways),
                      "device_ms": {w: cs.kernel_device_ms(fn) for w, fn in ways.items()},
                      "bound_ms": cs.bound(16 * Q + 4 * n_cells, 3 * D * Q, 3.35e12)[0],
                      "sector_floor_ms": cs.bound(16 * Q + 32 * sectors, 3 * D * Q,
                                                  3.35e12)[0]}
        del table, cells, ordered
        torch.cuda.empty_cache()
    return out


def _slot_rule(K, cs, lib):
    """The gathered hll_estimate with each rule for the slot's row."""
    import torch
    from flink_tpu_torch.kernels.hll_estimate import alpha_m2
    from flink_tpu_torch.ops.sketches import HyperLogLogAggregate
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(11)
    agg = HyperLogLogAggregate(12)
    C, m = 1_250_000, agg.m
    regs = torch.randint(0, 20, (C, m), dtype=torch.uint8, device=dev)
    fired = torch.from_numpy(rng.integers(0, C, 1 << 18).astype(np.int32)).to(dev)
    o = torch.empty(len(fired), dtype=torch.float32, device=dev)
    am2 = alpha_m2(agg.alpha, m)

    def rule(r):
        return lambda: _ok(lib.ft_probe_hll_gathered(
            regs.data_ptr(), fired.data_ptr(), len(fired), m, C, am2, o.data_ptr(), r,
            _stream()))
    ways = {"kernel": lambda: K.hll_estimate(regs, agg.alpha, slots=fired),
            **{f"rule{r}": rule(r) for r in range(5)}}
    want = ways["kernel"]()
    equal = {}
    for r in range(5):
        rule(r)()
        torch.cuda.synchronize()
        equal[f"rule{r}"] = bool(torch.equal(o, want))
    return {"rows": len(fired), "file": [C, m], "equal_to_kernel": equal,
            "ms": _in_turns(cs, ways),
            "device_ms": {w: cs.kernel_device_ms(fn) for w, fn in ways.items()}}


if __name__ == "__main__":
    sys.exit(main())
