#!/usr/bin/env python3
"""Run paths of ``chip_smoke.py`` alone on the card: build the kernels
and the host runtime, then each named path's phase with the launch
counts reset before it, recording every check instead of stopping at
the first that fails.

    python3 scripts/chip_path.py datastream_api [sources ...]

Prints each phase's JSON lines, then per path its seconds, its launch
counts, whether every kernel of its ``needs`` launched, and the checks
that failed; exits 1 if any check failed.
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from flink_tpu_torch import kernels as K  # noqa: E402
from flink_tpu_torch import native  # noqa: E402

failed = []


def check(ok, what):
    cs.CHECKS.append(what)
    if not ok:
        failed.append(what)
        print("FAILED", what, flush=True)


def main(names) -> int:
    if not torch.cuda.is_available():
        print("chip_path: no CUDA device", file=sys.stderr)
        return 2
    phases = {path: (phase, needs) for path, phase, needs in cs.PATHS}
    unknown = [n for n in names if n not in phases]
    if not names or unknown:
        print(f"chip_path: name paths of {sorted(phases)}", file=sys.stderr)
        return 2
    cs.check = check
    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi())
    t0 = time.perf_counter()
    native.lib()
    K.build_all()
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    for name in names:
        phase, needs = phases[name]
        K.reset_launch_counts()
        t0 = time.perf_counter()
        getattr(cs, phase)(dev)
        secs = time.perf_counter() - t0
        launches = {k: v for k, v in K.LAUNCHES.items() if v}
        for kname in needs:
            check(launches.get(kname, 0) > 0, f"{kname} launched on the {name} path")
        print(json.dumps({"path": name, "seconds": secs, "launches": launches}),
              flush=True)
    print(json.dumps({"failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
