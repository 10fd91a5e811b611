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
- ``chain_route`` route4 and route128 (2^20 rows, one call per event
  pair, as ``chip_smoke.py`` times it: the call reads the host).

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
    K.build_all(("shard_pack", "gather_segment_sum", "chain_route"))
    out = {"root": root, "package": K.__file__,
           "device": torch.cuda.get_device_name(0),
           "nvidia_smi": cs.nvidia_smi()}

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
    del src, dst, deg, x, call
    torch.cuda.empty_cache()

    # chain_route, as chip_smoke.chain_route_entry times it
    keys, ts, vh = cs.config2_events(np.random.default_rng(11), n_events=1 << 20)
    key = torch.from_numpy(keys.astype(np.int64)).to(dev)
    cols = [key, torch.from_numpy(vh.view(np.int64)).to(dev),
            torch.from_numpy(ts).to(dev)]
    keep = torch.from_numpy(vh.view(np.int64) % 7 != 0).to(dev)
    for nch in (4, 128):
        kw = dict(key=key, num_channels=nch, max_parallelism=128)
        out[f"chain_route_route{nch}"] = {"ms": cs.cuda_ms(
            lambda: K.chain_route(cols, keep, **kw), single=True)}
    return out


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
