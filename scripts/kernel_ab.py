#!/usr/bin/env python3
"""Time the redesigned kernels of two checkouts in turns, on one card.

    python3 scripts/kernel_ab.py --old PATH [--turns old,new,new,old]

PATH is another checkout of the repository (for example the parent
commit, unpacked with ``git archive``).  Each turn is one worker process
that puts a checkout first on ``sys.path``, builds that checkout's
kernels, and times them at the entry shapes of ``chip_smoke.py``, with
``chip_smoke.cuda_ms`` of THIS checkout (reps calls back to back between
one pair of CUDA events, / reps) on inputs made from fixed seeds, the
same in every turn:

- ``shard_pack`` K11a (8 sources of 2^17 rows, five 4-byte lanes and the
  bool mask, hashed targets, cap 2^17) and K11c (8 x 2^17 rows of 6
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
  one per event pair (``_host``).

``shard_pack``, ``chain_route`` and ``scatter_combine`` (add at the
entry, both graph shapes with the fill), with ``index_add_`` and
``scatter_reduce_`` beside them, also get ``_split``: the device ms of
each kernel per call, from a ``torch.profiler`` trace of 10 calls (CUPTI
kernel records, by kernel name), taken at the end of the turn.

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


def worker(root: str) -> dict:
    sys.path.insert(0, root)
    import torch
    from flink_tpu_torch import kernels as K
    cs = _chip_smoke()
    dev = torch.device("cuda", 0)
    K.build_all(("shard_pack", "gather_segment_sum", "chain_route",
                 "scatter_combine"))

    out = {"root": root, "package": K.__file__,
           "device": torch.cuda.get_device_name(0),
           "nvidia_smi": cs.nvidia_smi()}
    # profiled last: a trace slows the launches that follow it
    splits = {}

    # shard_pack at chip_smoke.shard_pack_entry's inputs
    rng = np.random.default_rng(5)
    S, m = 8, 1 << 17
    n = S * m
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)   # noqa: E731
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
    del lanes, rows, got, want, outs
    torch.cuda.empty_cache()

    # gather_segment_sum at chip_smoke.graph_kernel_entries' inputs
    src_np, dst_np, _ = cs.kronecker_edges(dev, 22, seed=61)
    n = 1 << 22
    src, dst = (torch.from_numpy(a).to(dev) for a in (src_np, dst_np))
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
    del deg, x, call
    torch.cuda.empty_cache()

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
    del src, dst
    torch.cuda.empty_cache()

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
    del cslots, vals, state, base

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
    for name, fn in splits.items():
        out[name] = _kernel_split(fn)
    return out


def _kernel_split(fn, reps: int = 10) -> dict:
    """Device ms per call of each kernel that fn launches (torch.profiler,
    CUDA activity): kernel name (up to its argument list) -> ms."""
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
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker)), flush=True)
        return 0
    if not args.old:
        ap.error("--old is required")
    roots = {"old": str(Path(args.old).resolve()), "new": str(HERE)}
    turns = []
    for turn in args.turns.split(","):
        res = subprocess.run([sys.executable, __file__, "--worker", roots[turn]],
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
        if any("segment_plan_ms" in tr for tr in mine):
            summary[side]["segment_plan_ms"] = float(np.median(
                [tr["segment_plan_ms"] for tr in mine]))
    print(json.dumps({"summary": summary, "turns": args.turns}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
