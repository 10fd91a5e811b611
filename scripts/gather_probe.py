#!/usr/bin/env python3
"""What holds ``gather_segment_sum`` back on the card: the kernel on the
Graph500 scale-22 graph of ``chip_smoke.py``'s kernel entry, beside the
same launch with the gathers taken out or reordered.

    python3 scripts/gather_probe.py

Prints one JSON object (device ms from ``chip_smoke.cuda_ms``, a run of
20 calls between one pair of CUDA events):

- ``kernel``: the plan of the graph, x = ranks / out-degree;
- ``cols_zero``: the same plan with every gathered index 0 (one address,
  so the gathers cost nothing; the rest of the kernel's work);
- ``cols_sequential``: gathered index = edge index mod n (each warp's
  gathers on consecutive addresses);
- ``relabeled``: vertices renumbered by how often they are gathered, most
  first, and x permuted to match (the hot values packed together); the
  result is checked bit-equal to ``kernel``'s;
- ``csr_spmv`` and ``index_add``: the two PyTorch yardsticks;
- the share of all gathers that fall on the 1k, 8k, 64k and 512k most
  gathered vertices, the largest in-degree and the empty rows.

Needs a CUDA card.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch
    from flink_tpu_torch import kernels as K
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    dev = torch.device("cuda", 0)
    K.build_all(("gather_segment_sum",))
    src_np, dst_np, _ = cs.kronecker_edges(dev, 22, seed=61)
    n, e = 1 << 22, len(src_np)
    src, dst = (torch.from_numpy(a).to(dev) for a in (src_np, dst_np))
    plan = K.segment_plan(src, dst, n)
    deg = torch.clamp(torch.bincount(src, minlength=n), min=1).to(torch.float32)
    x = torch.full((n,), 1.0 / n, device=dev) / deg
    ms = lambda fn: cs.cuda_ms(fn, 20)                     # noqa: E731
    res = {"device": torch.cuda.get_device_name(0), "nvidia_smi": cs.nvidia_smi(),
           "kernel": ms(lambda: K.gather_segment_sum(x, plan))}
    zero = plan._replace(cols=torch.zeros_like(plan.cols))
    res["cols_zero"] = ms(lambda: K.gather_segment_sum(x, zero))
    seq = plan._replace(cols=(torch.arange(e, device=dev) % n).to(torch.int32))
    res["cols_sequential"] = ms(lambda: K.gather_segment_sum(x, seq))
    freq = torch.bincount(src, minlength=n)
    perm = torch.argsort(freq, descending=True, stable=True)   # new -> old
    label = torch.empty_like(perm)
    label[perm] = torch.arange(n, device=dev)
    relabeled = plan._replace(cols=label[plan.cols.long()].to(torch.int32))
    xp = x[perm]
    res["relabeled"] = ms(lambda: K.gather_segment_sum(xp, relabeled))
    res["relabeled_bit_equal"] = bool(torch.equal(K.gather_segment_sum(x, plan),
                                                  K.gather_segment_sum(xp, relabeled)))
    csr = torch.sparse_csr_tensor(plan.indptr, plan.cols,
                                  torch.ones(e, device=dev), (n, n))
    res["csr_spmv"] = ms(lambda: csr @ x)
    xs, out = x[src], torch.zeros(n, device=dev)
    res["index_add"] = ms(lambda: out.index_add_(0, dst, xs))
    top = torch.sort(freq, descending=True).values.double().cumsum(0) / e
    res["gathers_on_top_1k_8k_64k_512k"] = [float(top[k - 1])
                                            for k in (1024, 8192, 65536, 524288)]
    indeg = torch.bincount(dst, minlength=n)
    res["max_in_degree"] = int(indeg.max())
    res["empty_rows"] = int((indeg == 0).sum())
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
