#!/usr/bin/env python3
"""Time the redesigned kernels of two checkouts in turns, on one card.

    python3 scripts/kernel_ab.py --old PATH [--turns old,new,new,old]
                                 [--kernels clear_rows,hll_update]

PATH is another checkout of the repository (for example the parent
commit, unpacked with ``git archive``).  Each turn is one worker process
that puts a checkout first on ``sys.path``, builds that checkout's
kernels, and times them at the entry shapes of ``chip_smoke.py``, with
``chip_smoke.cuda_ms`` of THIS checkout (reps calls back to back between
one pair of CUDA events, / reps) on inputs made from fixed seeds, the
same in every turn.  ``--kernels`` picks the groups (default: all):

- ``shard_pack``: K11a (8 sources of 2^17 rows, five 4-byte lanes and
  the bool mask, hashed targets, cap 2^17) and K11c (8 x 2^17 rows of 6
  uint32 lanes, given targets, cap 2^16);
- ``gather_segment_sum`` on a Graph500 scale-22 graph (PageRank's
  contributions; a checkout with ``segment_plan`` is timed on its plan,
  built once beforehand and timed on its own);
- ``scatter_combine`` at the graph shape (the same graph: float32 min
  over its 67.1M edges, int32 min over the 134.2M undirected edges, into
  4,194,304 slots filled before each call, one call per event pair) and
  at the entry (2^20 rows into 50k slots, add / min / max in float32 and
  int32, the state carried over, a run; min and max also from one state
  each call, ``_fresh``, one call per event pair);
- ``chain_route`` in every mode of ``chip_smoke.chain_route_entry``
  (route4, route128, plain, window, mesh40; 2^20 rows): the launch
  alone as a run, without the host read of the class starts (a checkout
  without ``chain_route_launch`` runs its own wrapper's launch, scratch
  allocated per call as it did), and the call that reads the starts,
  one per event pair (``_host``);
- ``clear_rows`` on the [1.25M, 4096] uint8 register file (5.12 GB):
  the range form over all of it, the list form over 2^18 slots, with
  ``fill_`` and ``index_fill_`` (int64 index made beforehand) beside
  them; and the session path's small list clears, 48 slots of a [1024,
  4096] uint8 and of a [1024] float32 component (fill finfo.max);
- ``hll_update``: 2^20 compressed rows (uint16 registers) into that
  file, one call per event pair after an untimed clear
  (``_after_clear``), the same batch onto the registers it left as a
  run (``_onto_itself``: every row loses), the slots confined to 16,384
  slots after a clear (``_confined``), ``scatter_reduce_`` amax after a
  clear, and the keyed backend's flush (16,384 rows of raw lanes, a
  run);
- ``countmin_update``: 2^19 records into a [2^14, 4, 2048] int32 table
  (512 MiB), the table carried over, a run, beside ``index_put_`` with
  accumulate (indices made beforehand); and the same records onto 64
  slots (``_64_slots``: a 2 MiB table in the L2, slots repeating within
  a warp);
- ``table_insert`` at ``chip_smoke.table_insert_cases``' batches: 2^20
  records into 1.5M positions, empty, half full and regional (one call
  per event pair after an untimed restore of the table), and all hits
  (a run);
- ``quantile_result`` at ``chip_smoke.sketch_kernel_entries``' shapes:
  the config #3 file ([2^22, 210] int32, 2^19 lognormal values through
  ``quantile_update``), dense over 2^20 rows from row 0 and from row 1
  (8-byte aligned rows), Q = 2 and Q = 16, gathered over 2^18 slots;
  and the default geometry (2,075 buckets), dense over 2^17 rows from
  row 1;
- ``gram_accumulate`` at MovieLens-20M's shape, f = 10 (``chip_smoke.
  ml_kernel_entries``' ratings and factors): the user and the item
  side, and f = 64 on a user side of about 2M ratings; a checkout with
  ``gram_plan`` is timed on plans built beforehand (each build timed on
  its own, ``*_plan_ms``), and on plans of 512, 1024, 4096 and 8192
  ratings a chunk beside its default (``_w<N>``);
- ``edge_popcount`` at ``chip_smoke.graph_kernel_entries``' scale-18
  triangle input (3.8M pairs, an 8.59 GB bitset): the whole call, and on
  a checkout with ``popcount_plan`` the plan (one call per event pair)
  and the pair pass on it;
- ``merge_rows``: the main-path form (uint8 max, 2 pairs into one target
  of a [4096, 4096] file, a run of 200), a float32 add of 2 pairs, the
  session Count-Min merge through ``agg.merge_slots`` (table and total
  of 8,192 slots: two launches on a checkout without
  ``merge_rows_many``), int32 add of 4,096 pairs of 32 KiB rows folded
  four to a target, and 2^18 unique pairs of 840 B rows.
- ``hll_log_finish`` at ``chip_smoke.log_finish_entry``'s config #2
  entry (the compacted cells of 2^23 events over 1M keys, p = 12) and at
  the shape of one of the mesh path's launches
  (``chip_smoke.MESH_LOG_FINISH``: 2^16 events over 1,000 keys), a run
  of 50, and the host microseconds a call (``host_us``: 500 calls queued
  without a synchronisation, the least of 5 loops);
- ``knn_topk`` at ``chip_smoke.ml_kernel_entries``' MNIST shape (10,000
  queries, 60,000 points) for k = 3 (the entry), 1, 16 and 64.
- ``countmin_query`` at ``chip_smoke.countmin_query_inputs``' two
  shapes: the entry (2^20 queries into a [2^14, 4, 2048] int32 table)
  and the heavy_hitters phase's layout (2^19 queries into 100,000 live
  slots of [2^18, 4, 2048], 8 GiB), a run of 50, and the host
  microseconds a call (``host_us``).
- ``result_gather``: the aggregates' ``result`` at 2^18 slots of a
  1.25M-slot state (``chip_smoke.kernel_phase``'s rows): Sum (float32)
  and Avg, which are tensor indexing and no kernel, and HLL at p = 12
  (the gathered ``hll_estimate`` over 5.12 GB of registers), a run of
  200, and ``host_us``.

Most entries also get ``_split``: the device ms of each kernel per
call, from a ``torch.profiler`` trace of 10 calls
(``chip_smoke.kernel_device_ms``), taken at the end of the turn.

Prints one JSON object per turn, then a summary line: the median of each
checkout's turns per entry.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_timer",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GROUPS = ("shard_pack", "gather_segment_sum", "scatter_combine", "chain_route",
          "clear_rows", "hll_update", "countmin_update", "table_insert",
          "quantile_result", "gram_accumulate", "edge_popcount", "merge_rows",
          "hll_log_finish", "knn_topk", "countmin_query", "result_gather")


def worker(root: str, groups) -> dict:
    sys.path.insert(0, root)
    import torch
    from flink_tpu_torch import kernels as K
    cs = _chip_smoke()
    dev = torch.device("cuda", 0)
    K.build_all([g for g in groups if g in K.KERNELS])

    out = {"root": root, "package": K.__file__,
           "device": torch.cuda.get_device_name(0),
           "nvidia_smi": cs.nvidia_smi()}
    # profiled last: a trace slows the launches that follow it
    splits = {}
    for group in groups:
        GROUP_FNS[group](K, cs, dev, out, splits)
        torch.cuda.empty_cache()
    for name, fn in splits.items():
        out[name] = cs.kernel_device_ms(fn)
    return out


def _tensor(dev):
    import torch
    return lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _shard_pack(K, cs, dev, out, splits):
    import torch
    t = _tensor(dev)
    # shard_pack at chip_smoke.shard_pack_entry's inputs
    rng = np.random.default_rng(5)
    S, m = 8, 1 << 17
    n = S * m
    kh = cs.splitmix64_np(rng.integers(0, 1_000_000, n).astype(np.uint64))
    vh = cs.splitmix64_np(rng.integers(0, 2**63, n).astype(np.uint64))
    mask = rng.random(n) >= 0.01
    lanes = [t((kh >> np.uint64(32)).astype(np.uint32).view(np.int32)),
             t((kh & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)),
             t(rng.random(n).astype(np.float32)),
             t((vh >> np.uint64(32)).astype(np.uint32).view(np.int32)),
             t((vh & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)),
             t(mask)]
    tgt = rng.integers(0, S, n).astype(np.int32)
    tgt[~mask] = S
    rows = t(rng.integers(0, 2**31, (n, 6)).astype(np.int32))
    for name, data, cap, kw in (
            ("shard_pack_K11a", lanes, m, dict(hash_lo=lanes[1],
                                                max_parallelism=128,
                                                mask=lanes[5])),
            ("shard_pack_K11c", rows, 4 * m // S, dict(target=t(tgt)))):
        got = K.shard_pack(data, S, cap, **kw)
        want = K.shard_pack_plain(data, S, cap, **kw)
        outs = list(zip(got[0], want[0])) if isinstance(data, list) \
            else [(got[0], want[0])]
        ok = torch.equal(got[1], want[1]) and all(torch.equal(g, w) for g, w in outs)
        out[name] = {"ms": cs.cuda_ms(lambda: K.shard_pack(data, S, cap, **kw)),
                     "bit_equal_to_plain": bool(ok)}
        splits[name + "_split"] = (lambda d=data, c=cap, k=kw, s=S:
                                   K.shard_pack(d, s, c, **k))


def _graph(cs, dev):
    import torch
    src_np, dst_np, _ = cs.kronecker_edges(dev, 22, seed=61)
    return (torch.from_numpy(a).to(dev) for a in (src_np, dst_np))


def _gather_segment_sum(K, cs, dev, out, splits):
    import torch
    # gather_segment_sum at chip_smoke.graph_kernel_entries' inputs
    src, dst = _graph(cs, dev)
    n = 1 << 22
    deg = torch.clamp(torch.bincount(src, minlength=n), min=1).to(torch.float32)
    x = torch.full((n,), 1.0 / n, device=dev) / deg
    if hasattr(K, "segment_plan"):
        plan = K.segment_plan(src, dst, n)
        call = lambda: K.gather_segment_sum(x, plan)        # noqa: E731
        out["segment_plan_ms"] = cs.cuda_ms(lambda: K.segment_plan(src, dst, n),
                                            3, single=True)
    else:
        call = lambda: K.gather_segment_sum(x, src, dst, n)  # noqa: E731
    out["gather_segment_sum"] = {"ms": cs.cuda_ms(call)}


def _scatter_combine(K, cs, dev, out, splits):
    import torch
    t = _tensor(dev)
    src, dst = _graph(cs, dev)
    n = 1 << 22
    # scatter_combine at chip_smoke.scatter_combine_graph_entry's inputs
    gen = torch.Generator(device=dev)
    gen.manual_seed(63)
    for name, slots, msgs, ident in (
            ("f32_min_directed", dst, torch.rand(len(dst), generator=gen, device=dev),
             float("inf")),
            ("i32_min_undirected", torch.cat([dst, src]), torch.cat([src, dst]),
             int(np.iinfo(np.int32).max))):
        e = len(slots)
        state = torch.full((n,), ident, dtype=msgs.dtype, device=dev)
        fill = lambda: state.fill_(ident)                   # noqa: E731
        out[f"scatter_combine_graph_{name}"] = {"ms": cs.cuda_ms(
            lambda: K.scatter_combine(state, slots, msgs, e, "min"), 10, fill)}
        splits[f"scatter_combine_graph_{name}_split"] = (
            lambda st=state, sl=slots, m=msgs, e=e, i=ident:
            (st.fill_(i), K.scatter_combine(st, sl, m, e, "min")))
        idx = slots.to(torch.int64)
        splits[f"scatter_reduce_graph_{name}_split"] = (
            lambda st=state, x=idx, m=msgs, i=ident:
            (st.fill_(i), st.scatter_reduce_(0, x, m, "amin")))
        del state, slots, msgs, idx

    # scatter_combine at chip_smoke.kernel_phase's entry
    rng = np.random.default_rng(7)
    N, S = 1 << 20, 50_000
    cslots = t(rng.integers(0, S, N).astype(np.int32))
    for dt, tag in ((torch.float32, "f32"), (torch.int32, "i32")):
        vals = t(rng.integers(-1000, 1000, N)).to(dt)
        for op in ("add", "min", "max"):
            state = t(rng.integers(-50, 50, S)).to(dt)
            out[f"scatter_combine_{op}_{tag}"] = {"ms": cs.cuda_ms(
                lambda: K.scatter_combine(state, cslots, vals, N, op))}
            if op == "add":
                splits[f"scatter_combine_add_{tag}_split"] = (
                    lambda st=state, v=vals, c=cslots: K.scatter_combine(st, c, v, N, "add"))
                splits[f"index_add_{tag}_split"] = (
                    lambda st=state, v=vals, c=cslots: st.index_add_(0, c, v))
            if op != "add":     # from the same state each call
                base = state.clone()
                out[f"scatter_combine_{op}_{tag}_fresh"] = {"ms": cs.cuda_ms(
                    lambda: K.scatter_combine(state, cslots, vals, N, op), 10,
                    lambda: state.copy_(base))}


def _chain_route(K, cs, dev, out, splits):
    import torch
    # chain_route in chip_smoke.chain_route_entry's modes
    n = 1 << 20
    keys, ts, vh = cs.config2_events(np.random.default_rng(11), n_events=n)
    key = torch.from_numpy(keys.astype(np.int64)).to(dev)
    val = torch.from_numpy(vh.view(np.int64)).to(dev)
    tt = torch.from_numpy(ts).to(dev)
    t_neg = tt - 500
    keep = torch.from_numpy(vh.view(np.int64) % 7 != 0).to(dev)
    launch = getattr(K, "chain_route_launch", _old_chain_launch)
    route4 = dict(key=key, num_channels=4, max_parallelism=128)
    for mode, kw, tcol in (
            ("route4", route4, tt),
            ("route128", dict(key=key, num_channels=128, max_parallelism=128), tt),
            ("plain", {}, tt),
            ("window", dict(ts=t_neg, pane_offset=0, slide=1000), t_neg),
            ("mesh40", dict(route4, shard_rows=n // 8, n_shards=8), tt)):
        cols = [key, val, tcol]
        out[f"chain_route_{mode}"] = {"ms": cs.cuda_ms(lambda: launch(cols, keep, **kw))}
        splits[f"chain_route_{mode}_split"] = (lambda c=cols, k=kw, m=keep:
                                               launch(c, m, **k))
        out[f"chain_route_{mode}_host"] = {"ms": cs.cuda_ms(
            lambda: K.chain_route(cols, keep, **kw), single=True)}


def _clear_rows(K, cs, dev, out, splits):
    import torch
    C, m = 1_250_000, 4096
    regs = torch.zeros((C, m), dtype=torch.uint8, device=dev)
    rng = np.random.default_rng(13)
    gslots = torch.from_numpy(rng.integers(0, C, 1 << 18).astype(np.int32)).to(dev)
    gidx = gslots.to(torch.int64)
    small = torch.from_numpy(rng.integers(0, 1024, 48).astype(np.int32)).to(dev)
    u8 = torch.zeros((1024, m), dtype=torch.uint8, device=dev)
    f32 = torch.zeros(1024, dtype=torch.float32, device=dev)
    fmax = float(np.finfo(np.float32).max)
    calls = {"clear_rows_range": lambda: K.clear_rows(regs, 0),
             "fill_": lambda: regs.fill_(0),
             "clear_rows_list": lambda: K.clear_rows(regs, 0, slots=gslots),
             "index_fill_": lambda: regs.index_fill_(0, gidx, 0),
             "clear_rows_small_u8": lambda: K.clear_rows(u8, 0, slots=small),
             "clear_rows_small_f32": lambda: K.clear_rows(f32, fmax, slots=small)}
    for name, fn in calls.items():
        out[name] = {"ms": cs.cuda_ms(fn, 20)}
        splits[name + "_split"] = fn


def _hll_update(K, cs, dev, out, splits):
    import torch
    from flink_tpu_torch.ops.sketches import HyperLogLogAggregate
    t = _tensor(dev)
    C, P, N = 1_250_000, 12, 1 << 20
    m = 1 << P
    rng = np.random.default_rng(11)
    slots_np = rng.integers(0, 1_000_000, N).astype(np.int32)
    vh = cs.splitmix64_np(rng.integers(0, 2**63, N, dtype=np.int64))
    hi_np = (vh >> np.uint64(32)).astype(np.uint32)
    lo_np = (vh & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    rank_np, reg_np = HyperLogLogAggregate(P).compress_value_hash(hi_np, lo_np)
    slots, rank, reg = t(slots_np), t(rank_np), t(reg_np.view(np.int16))
    hi, lo = t(hi_np.view(np.int32)), t(lo_np.view(np.int32))
    confined = t(slots_np % (1 << 14))
    regs = torch.zeros((C, m), dtype=torch.uint8, device=dev)
    clear = lambda: K.clear_rows(regs, 0)                     # noqa: E731
    update = lambda: K.hll_update(regs, slots, rank, reg, N)  # noqa: E731
    out["hll_update_after_clear"] = {"ms": cs.cuda_ms(update, 10, clear)}
    clear()
    out["hll_update_onto_itself"] = {"ms": cs.cuda_ms(update, 10)}
    out["hll_update_confined"] = {"ms": cs.cuda_ms(
        lambda: K.hll_update(regs, confined, rank, reg, N), 10, clear)}
    idx = slots.to(torch.int64) * m + reg.to(torch.int64)
    flat = regs.view(-1)
    out["scatter_reduce_after_clear"] = {"ms": cs.cuda_ms(
        lambda: flat.scatter_reduce_(0, idx, rank, "amax"), 10, clear)}
    nf = 16384
    out["hll_update_raw_flush"] = {"ms": cs.cuda_ms(
        lambda: K.hll_update(regs, slots[:nf], hi[:nf], lo[:nf], nf), 20)}
    splits["hll_update_after_clear_split"] = lambda: (clear(), update())
    splits["hll_update_onto_itself_split"] = update
    splits["scatter_reduce_after_clear_split"] = lambda: (
        clear(), flat.scatter_reduce_(0, idx, rank, "amax"))


def _countmin_update(K, cs, dev, out, splits):
    import torch
    from flink_tpu_torch.ops.hashing import countmin_rows
    t = _tensor(dev)
    # chip_smoke.sketch_kernel_entries' shape: 2^19 records into
    # [2^14, 4, 2048] int32 (512 MiB), weights 1-3
    rng = np.random.default_rng(17)
    S, D, W, N = 1 << 14, 4, 2048, 1 << 19
    slots = t(rng.integers(0, S, N).astype(np.int32))
    vals = t(rng.integers(1, 4, N).astype(np.float32))
    vh = cs.splitmix64_np(rng.integers(0, 2**63, N, dtype=np.int64))
    hi, lo = (t(a) for a in cs.lanes_np(vh))
    table = torch.zeros((S, D, W), dtype=torch.int32, device=dev)
    total = torch.zeros(S, dtype=torch.int32, device=dev)
    call = lambda: K.countmin_update(table, total, slots, vals, hi, lo, N)  # noqa: E731
    rt, rtot = table.clone(), total.clone()
    call()
    K.countmin_update_plain(rt, rtot, slots, vals, hi, lo, N)
    out["countmin_update"] = {"ms": cs.cuda_ms(call, 20), "bit_equal_to_plain":
                              bool(torch.equal(table, rt) and torch.equal(total, rtot))}
    s64 = slots.to(torch.int64)
    flat = ((s64[None, :] * D + torch.arange(D, device=dev)[:, None]) * W
            + countmin_rows(hi, lo, D, W).to(torch.int64)).reshape(-1)
    w_rep = vals.to(torch.int32).expand(D, -1).reshape(-1)
    w32 = vals.to(torch.int32)

    def library():
        table.view(-1).index_put_((flat,), w_rep, accumulate=True)
        total.index_put_((s64,), w32, accumulate=True)
    out["index_put_"] = {"ms": cs.cuda_ms(library, 20)}
    splits["countmin_update_split"] = call
    splits["index_put_split"] = library
    # the same records onto 64 slots: a 2 MiB table the L2 holds, and
    # slots that repeat within a warp
    few = t(rng.integers(0, 64, N).astype(np.int32))
    small = torch.zeros((64, D, W), dtype=torch.int32, device=dev)
    small_total = torch.zeros(64, dtype=torch.int32, device=dev)
    call_l2 = lambda: K.countmin_update(small, small_total, few, vals, hi, lo, N)  # noqa: E731
    out["countmin_update_64_slots"] = {"ms": cs.cuda_ms(call_l2, 20)}
    splits["countmin_update_64_slots_split"] = call_l2


def _table_insert(K, cs, dev, out, splits):
    import torch
    from flink_tpu_torch.ops.device_table import make_table
    # chip_smoke.table_insert_entry's batches: 2^20 records (1000 of
    # them padding) into 1.5M positions
    C, P = cs.TI_POSITIONS, cs.TI_MAX_PROBES
    n = cs.TI_RECORDS - 1000
    for case in cs.table_insert_cases(dev, np.random.default_rng(19)):
        state, (h_d, l_d), kw = case["state"], case["lanes"], case["kw"]
        card = make_table(C, dev)
        case["fill"](card)
        saved = [a.clone() for a in card]
        restore = lambda c=card, s=saved: [a.copy_(b) for a, b in zip(c, s)]  # noqa: E731
        call = lambda c=card, h=h_d, l=l_d, k=kw: K.table_insert(*c, h, l, n, P, **k)  # noqa: E731
        if state == "all_hits":
            out[f"table_insert_{state}"] = {"ms": cs.cuda_ms(call, 20)}
            splits[f"table_insert_{state}_split"] = call
        else:
            out[f"table_insert_{state}"] = {"ms": cs.cuda_ms(call, 10, restore)}
            splits[f"table_insert_{state}_split"] = (
                lambda r=restore, c=call: (r(), c()))
        del saved


def _quantile_result(K, cs, dev, out, splits):
    import torch
    from flink_tpu_torch.ops.sketches import QuantileSketchAggregate
    t = _tensor(dev)
    rng = np.random.default_rng(23)
    for tag, geometry, C, R, starts in (("", cs.Q3, 1 << 22, 1 << 20, (0, 1)),
                                        ("_default", {}, (1 << 17) + 1, 1 << 17, (1,))):
        agg = QuantileSketchAggregate(**geometry)
        N = 1 << 19
        hist = torch.zeros((C, agg.buckets), dtype=torch.int32, device=dev)
        K.quantile_update(hist, t(rng.integers(0, C, N).astype(np.int32)),
                          t(rng.lognormal(3.0, 1.0, N).astype(np.float32)), N,
                          agg.min_value, agg.log_gamma, agg.offset)
        qs, bv = agg._tables(dev)
        calls = {}
        for s0 in starts:
            rows = hist[s0:s0 + R]
            name = f"quantile_result{tag}_dense" + ("_odd" if s0 % 2 else "")
            calls[name] = lambda r=rows, q=qs, b=bv: K.quantile_result(r, q, b)
        if not tag:
            q16 = t(np.float32(np.linspace(0.0, 1.0, 16)))
            calls["quantile_result_q16"] = (lambda r=hist[:R], q=q16, b=bv:
                                            K.quantile_result(r, q, b))
            gslots = t(rng.integers(0, C, 1 << 18).astype(np.int32))
            calls["quantile_result_gathered"] = (lambda h=hist, q=qs, b=bv, g=gslots:
                                                 K.quantile_result(h, q, b, slots=g))
        for name, fn in calls.items():
            out[name] = {"ms": cs.cuda_ms(fn, 20)}
            splits[name + "_split"] = fn    # the trace at the end keeps the file


def _gram_accumulate(K, cs, dev, out, splits):
    import torch
    from flink_tpu_torch.kernels.gram_accumulate import rating_csr
    planned = hasattr(K, "gram_plan")
    rng = np.random.default_rng(31)
    u, i, r = cs.movielens_shape(rng)
    V = torch.from_numpy(rng.normal(0, 0.1, (int(i.max()) + 1, 10))
                         .astype(np.float32)).to(dev)
    U = torch.from_numpy(np.random.default_rng(32).normal(0, 0.1, (int(u.max()) + 1, 10))
                         .astype(np.float32)).to(dev)
    r64 = np.random.default_rng(33)
    u6, i6, s6 = cs.movielens_shape(r64, 2_000_026, 13_849, 2_674)
    V64 = torch.from_numpy(r64.normal(0, 0.1, (int(i6.max()) + 1, 64))
                           .astype(np.float32)).to(dev)
    for name, rows, cols, vals, fixed in (("users", u, i, r, V), ("items", i, u, r, U),
                                          ("users_f64", u6, i6, s6, V64)):
        csr = rating_csr(*(torch.from_numpy(a).to(dev) for a in (rows, cols, vals)),
                         int(rows.max()) + 1)
        key = f"gram_accumulate_{name}"
        if planned:
            plan = K.gram_plan(csr[0])
            out[key + "_plan_ms"] = {"ms": cs.cuda_ms(lambda: K.gram_plan(csr[0]), 3,
                                                      single=True)}
            call = lambda c=csr, f=fixed, p=plan: K.gram_accumulate(f, *c, plan=p)  # noqa: E731
            for w in (512, 1024, 4096, 8192):
                pw = K.gram_plan(csr[0], w)
                out[f"{key}_w{w}"] = {"ms": cs.cuda_ms(
                    lambda c=csr, f=fixed, p=pw: K.gram_accumulate(f, *c, plan=p))}
        else:
            call = lambda c=csr, f=fixed: K.gram_accumulate(f, *c)  # noqa: E731
        out[key] = {"ms": cs.cuda_ms(call)}
        splits[key + "_split"] = call


def _edge_popcount(K, cs, dev, out, splits):
    import torch
    from flink_tpu_torch.graph import library as tlib
    # edge_popcount at chip_smoke.graph_kernel_entries' inputs: the scale-18
    # Kronecker graph's canonical pairs and bitset (8.59 GB)
    n = 1 << 18
    src, dst, _ = cs.kronecker_edges(dev, 18, seed=62)
    pairs = tlib._NeighborPairs(cs._graph(src, dst, np.ones(len(src), np.float32),
                                          n)).pairs
    u, v = (torch.from_numpy(np.ascontiguousarray(pairs[:, i], np.int32)).to(dev)
            for i in (0, 1))
    adj = tlib.adjacency_bitset(n, u, v)
    call = lambda: K.edge_popcount(adj, u, v)               # noqa: E731
    out["edge_popcount"] = {"ms": cs.cuda_ms(call, 5)}
    splits["edge_popcount_split"] = call
    if hasattr(K, "popcount_plan"):
        plan = K.popcount_plan(adj, u, v)
        out["edge_popcount_plan"] = {"ms": cs.cuda_ms(
            lambda: K.popcount_plan(adj, u, v), 5, single=True)}
        out["edge_popcount_pairs"] = {"ms": cs.cuda_ms(lambda: K.edge_pairs(adj, plan), 5)}


def _merge_rows(K, cs, dev, out, splits):
    import torch
    from flink_tpu_torch.ops.sketches import CountMinSketchAggregate
    t = _tensor(dev)
    rng = np.random.default_rng(41)
    perm = rng.permutation(1 << 12).astype(np.int32)
    dst2, src2 = t(perm[[0, 0]]), t(perm[1:3])            # 2 pairs, one target
    regs = torch.randint(0, 30, (4096, 4096), dtype=torch.uint8, device=dev)
    f32 = torch.randint(0, 99, (4096,), device=dev).to(torch.float32)
    table = torch.randint(0, 99, (8192, 4, 2048), dtype=torch.int32, device=dev)
    cm = {"table": table, "total": torch.randint(0, 99, (8192,), dtype=torch.int32,
                                                  device=dev)}
    agg = CountMinSketchAggregate(4, 2048)
    perm8 = rng.permutation(8192).astype(np.int32)
    dst4k, src4k = t(np.repeat(perm8[:1024], 4)), t(perm8[1024:5120])
    # the sliding unions' form: 2^18 unique pairs of 840 B rows
    hist = torch.randint(0, 9, (1 << 20, 210), dtype=torch.int32, device=dev)
    hperm = rng.permutation(1 << 20).astype(np.int32)
    hdst, hsrc = t(hperm[:1 << 18]), t(hperm[1 << 18:1 << 19])
    calls = {
        # chip_smoke.merge_set_entries' main-path form: u8 max, 2 pairs, a run
        "merge_rows_u8_max_2": lambda: K.merge_rows(regs, dst2, src2, "max"),
        "merge_rows_f32_add_2": lambda: K.merge_rows(f32, dst2, src2, "add"),
        "merge_rows_cm_merge_slots_2": lambda: agg.merge_slots(cm, dst2, src2),
        "merge_rows_i32_add_32k_4096": lambda: K.merge_rows(table, dst4k, src4k, "add"),
        "merge_rows_i32_add_840_unique": lambda: K.merge_rows(hist, hdst, hsrc, "add",
                                                              unique_dst=True)}
    for name, fn in calls.items():
        out[name] = {"ms": cs.cuda_ms(fn, 200 if name.endswith("_2") else 20)}
        splits[name + "_split"] = fn


def _hll_log_finish(K, cs, dev, out, splits):
    for tag, shape in (("config2", (1 << 23, 1_000_000)),
                       ("mesh_launch", cs.MESH_LOG_FINISH)):
        r, e, m, alpha, _ = cs.log_finish_inputs(dev, np.random.default_rng(31),
                                                 *shape)
        name = f"hll_log_finish_{tag}"

        def fn(r=r, e=e, m=m, a=alpha):
            return K.hll_log_finish(r, e, m, a)
        out[name] = {"ms": cs.cuda_ms(fn, 50), "host_us": _host_us(fn),
                     "cells": len(r), "keys": len(e)}
        splits[name + "_split"] = fn


def _host_us(fn, calls=500):
    """Host microseconds a call: the least of 5 loops of ``calls`` calls
    queued without a synchronisation."""
    import time
    import torch
    best = float("inf")
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, time.perf_counter() - t0)
    torch.cuda.synchronize()
    return best / calls * 1e6


def _knn_topk(K, cs, dev, out, splits):
    import torch
    rng = np.random.default_rng(37)
    X = torch.from_numpy(cs.mnist_shape(rng, 60_000)).to(dev)
    Q = torch.from_numpy(cs.mnist_shape(rng, 10_000)).to(dev)
    qx = torch.matmul(Q, X.t())
    qn, xn = (Q * Q).sum(1), (X * X).sum(1)
    del X, Q
    for k in (3, 1, 16, 64):
        name = f"knn_topk_k{k}"

        def fn(k=k):
            return K.knn_topk(qx, qn, xn, k)
        out[name] = {"ms": cs.cuda_ms(fn, 10)}
        if k == 3:
            splits[name + "_split"] = fn


def _countmin_query(K, cs, dev, out, splits):
    import torch
    for shape in ("entry", "path"):
        table, slots, hi, lo = cs.countmin_query_inputs(dev, np.random.default_rng(43),
                                                        shape)
        name = f"countmin_query_{shape}"

        def fn(t=table, s=slots, h=hi, l_=lo):
            return K.countmin_query(t, s, h, l_)
        out[name] = {"ms": cs.cuda_ms(fn, 50), "host_us": _host_us(fn),
                     "queries": len(slots), "table": list(table.shape),
                     "bit_equal_to_plain": bool(torch.equal(
                         fn(), K.countmin_query_plain(table, slots, hi, lo)))}
        splits[name + "_split"] = fn


def _result_gather(K, cs, dev, out, splits):
    import torch
    from flink_tpu_torch.ops.device_agg import AvgAggregate, SumAggregate
    from flink_tpu_torch.ops.sketches import HyperLogLogAggregate
    rng = np.random.default_rng(11)
    C = 1_250_000
    fired = torch.from_numpy(rng.integers(0, C, 1 << 18).astype(np.int32)).to(dev)
    for agg in (SumAggregate(np.float32), AvgAggregate(), HyperLogLogAggregate(12)):
        st = agg.init_state(C, device=dev)
        name = f"result_gather_{type(agg).__name__}"
        reps = 20 if isinstance(agg, HyperLogLogAggregate) else 200

        def fn(agg=agg, st=st):
            return agg.result(st, fired)
        out[name] = {"ms": cs.cuda_ms(fn, reps), "host_us": _host_us(fn, reps)}
        splits[name + "_split"] = fn
        del st


GROUP_FNS = {"shard_pack": _shard_pack, "gather_segment_sum": _gather_segment_sum,
             "scatter_combine": _scatter_combine, "chain_route": _chain_route,
             "clear_rows": _clear_rows, "hll_update": _hll_update,
             "countmin_update": _countmin_update, "table_insert": _table_insert,
             "quantile_result": _quantile_result, "gram_accumulate": _gram_accumulate,
             "edge_popcount": _edge_popcount, "merge_rows": _merge_rows,
             "hll_log_finish": _hll_log_finish, "knn_topk": _knn_topk,
             "countmin_query": _countmin_query, "result_gather": _result_gather}


def _old_chain_launch(cols, keep, key=None, num_channels=0, max_parallelism=0,
                      ts=None, pane_offset=0, slide=0, shard_rows=0, n_shards=0):
    """The launch of a checkout whose ``chain_route`` wrapper has no
    device-only form (the design before the tiled partition): its
    wrapper's allocations and launch, without the host read of the
    class starts."""
    import ctypes
    import torch
    cr = sys.modules["flink_tpu_torch.kernels.chain_route"]
    loader = cr.loader
    dev = keep.device
    nclass = cr._num_classes(key, num_channels, max_parallelism)
    n = keep.numel()
    shards = cr._shards(n, shard_rows, n_shards)
    outs = [torch.empty_like(c) for c in cols]
    pane = torch.empty(n, dtype=torch.int64, device=dev) if slide else None
    tiles = -(-n // cr.TILE_ROWS)
    counts = torch.empty(nclass * shards * tiles, dtype=torch.int32, device=dev)
    offsets = torch.empty_like(counts)
    starts = torch.empty(nclass * shards, dtype=torch.int64, device=dev)
    k = len(cols)
    src = (ctypes.c_longlong * k)(*[c.data_ptr() for c in cols])
    dst = (ctypes.c_longlong * k)(*[o.data_ptr() for o in outs])
    widths = (ctypes.c_int * k)(*[c.element_size() for c in cols])
    loader.launch("chain_route", "ft_chain_route", loader.ptr(key),
                  keep.data_ptr(), n, nclass, max_parallelism, shard_rows,
                  shards, ctypes.addressof(src), ctypes.addressof(dst),
                  ctypes.addressof(widths), k,
                  loader.ptr(ts) if slide else None, pane_offset, slide,
                  loader.ptr(pane), counts.data_ptr(), offsets.data_ptr(),
                  starts.data_ptr())
    return outs, pane, starts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", help="the other checkout's root")
    ap.add_argument("--turns", default="old,new,new,old")
    ap.add_argument("--kernels", default=",".join(GROUPS),
                    help="comma-separated groups, from " + ", ".join(GROUPS))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.kernels.split(","))), flush=True)
        return 0
    if not args.old:
        ap.error("--old is required")
    unknown = set(args.kernels.split(",")) - set(GROUPS)
    if unknown:
        ap.error(f"unknown kernel groups {sorted(unknown)}")
    roots = {"old": str(Path(args.old).resolve()), "new": str(HERE)}
    turns = []
    for turn in args.turns.split(","):
        res = subprocess.run([sys.executable, __file__, "--worker", roots[turn],
                              "--kernels", args.kernels],
                             capture_output=True, text=True)
        if res.returncode != 0:
            sys.stderr.write(res.stderr)
            return res.returncode
        got = json.loads(res.stdout.strip().splitlines()[-1])
        got["turn"] = turn
        print(json.dumps(got), flush=True)
        turns.append(got)
    summary = {}
    for side in ("old", "new"):
        mine = [tr for tr in turns if tr["turn"] == side]
        names = sorted({k for tr in mine for k, v in tr.items()
                        if isinstance(v, dict) and "ms" in v})
        summary[side] = {k: float(np.median([tr[k]["ms"] for tr in mine]))
                         for k in names}
        for k in names:
            if all("host_us" in tr[k] for tr in mine):
                summary[side][k + "_host_us"] = float(np.median(
                    [tr[k]["host_us"] for tr in mine]))
        if any("segment_plan_ms" in tr for tr in mine):
            summary[side]["segment_plan_ms"] = float(np.median(
                [tr["segment_plan_ms"] for tr in mine]))
    print(json.dumps({"summary": summary, "turns": args.turns}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
