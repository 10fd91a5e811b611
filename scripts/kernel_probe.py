#!/usr/bin/env python3
"""The designs that ``clear_rows`` and ``hll_update`` were measured
against, timed beside the kernels on the card at ``chip_smoke.py``'s
entry shapes.

    python3 scripts/kernel_probe.py

Builds ``scripts/kernel_probe.cu`` (which includes the two kernels'
sources) with the loader's nvcc flags into the kernels' build directory
and prints one JSON object; every time is ``chip_smoke.cuda_ms`` (a
run of calls between one pair of CUDA events, / reps, or one call per
event pair after an untimed clear, the median: ``*_after_clear``):

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

Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import json
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
    for f in (SRC, *sorted(csrc.glob("*.cuh")), csrc / "clear_rows.cu",
              csrc / "hll_update.cu"):
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
    return lib


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch
    from flink_tpu_torch import kernels as K
    from flink_tpu_torch.ops.sketches import HyperLogLogAggregate
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    dev = torch.device("cuda", 0)
    K.build_all(("clear_rows", "hll_update"))
    lib = _build()
    stream = lambda: torch.cuda.current_stream().cuda_stream   # noqa: E731

    def ok(err):
        if err != 0:
            raise RuntimeError(f"probe launch failed with CUDA error {err}")

    res = {"device": torch.cuda.get_device_name(0), "nvidia_smi": cs.nvidia_smi()}
    C, P, N = 1_250_000, 12, 1 << 20
    m = 1 << P
    regs = torch.zeros((C, m), dtype=torch.uint8, device=dev)

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
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
