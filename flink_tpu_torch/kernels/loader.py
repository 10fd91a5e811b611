"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and builds with nvcc
into its own shared library, loaded through ``ctypes`` (device code
two kernels share lives in a ``csrc/*.cuh`` header):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o _build/<name>-<hash>.so csrc/<name>.cu

The build runs at first use (or all at once through ``build_all``,
one nvcc process per source, started together), into ``_build/``
beside this file, keyed by a hash of the source, the headers and the
flags, so a changed source rebuilds and an unchanged one loads what is
there.
Nothing here runs at import: this module imports on machines with no
CUDA toolkit, where only the plain PyTorch versions run.

``LAUNCHES`` counts kernel launches per kernel: each wrapper adds one
where it launches its kernel, and nowhere else.  ``launch`` keeps each
exported function once it is bound and reads the current stream's raw
handle, so a launch costs the ctypes call and little else on the host;
``check_all`` checks a wrapper's tensors in one pass.

While the tracer or the device telemetry is on, ``launch`` goes through
``runtime.tracing.LAUNCH_LEDGER``: the launch is counted under
``cuda.<kernel>`` and bracketed by a CUDA timing-event pair on its
stream, resolved later with no sync here.  Each nvcc build reports its
seconds through ``record_compile_event("cuda.build.<kernel>", s)``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

import torch

from flink_tpu_torch.runtime import tracing as _tracing
from flink_tpu_torch.runtime.device_stats import TELEMETRY

KERNELS = ("hll_update", "hll_estimate", "scatter_combine", "clear_rows",
           "merge_rows", "set_rows", "countmin_update", "countmin_query",
           "quantile_update", "quantile_result", "hll_log_finish",
           "table_insert", "chain_route", "gather_segment_sum",
           "edge_popcount", "gram_accumulate", "knn_topk", "shard_pack")

#: kernel name -> launches since the last reset
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
_launches_lock = threading.Lock()

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parent / "_build"
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_F = ctypes.c_float
_ULL = ctypes.c_ulonglong
_D = ctypes.c_double

#: C signatures of the exported functions (every one returns the
#: cudaError_t of its launch as an int)
_SIGNATURES = {
    "hll_update": {
        "ft_hll_update_raw": (_P, _P, _P, _P, _LL, _LL, _LL, _P),
        "ft_hll_update_compressed": (_P, _P, _P, _P, _I, _LL, _LL, _LL, _P),
    },
    "hll_estimate": {
        "ft_hll_estimate": (_P, _P, _LL, _LL, _LL, _F, _P, _P),
    },
    "scatter_combine": {
        "ft_scatter_combine": (_P, _P, _P, _LL, _LL, _I, _I, _P),
    },
    "clear_rows": {
        "ft_clear_rows": (_P, _P, _LL, _LL, _LL, _LL, _LL, _I, _ULL, _ULL,
                          _P),
    },
    "merge_rows": {
        "ft_merge_rows": (_P, _I, _P),
    },
    "set_rows": {
        "ft_set_rows": (_P, _P, _P, _LL, _LL, _LL, _I, _P),
    },
    "countmin_update": {
        "ft_countmin_update": (_P, _P, _P, _P, _P, _P, _LL, _I, _LL, _LL, _P),
    },
    "countmin_query": {
        "ft_countmin_query": (_P, _P, _P, _P, _LL, _I, _LL, _LL, _P, _P),
    },
    "quantile_update": {
        "ft_quantile_update": (_P, _P, _P, _LL, _LL, _LL, _F, _F, _LL, _P),
    },
    "quantile_result": {
        "ft_quantile_result": (_P, _P, _LL, _LL, _LL, _P, _I, _P, _P, _P),
    },
    "hll_log_finish": {
        "ft_hll_log_finish": (_P, _P, _LL, _LL, _LL, _D, _P, _P, _P, _P),
    },
    "table_insert": {
        "ft_table_insert": (_P, _P, _P, _LL, _P, _P, _P, _P, _LL, _LL, _LL,
                            _I, _P, _P, _P),
    },
    "chain_route": {
        "ft_chain_route": (_P, _P, _LL, _I, _LL, _LL, _I, _P, _P, _P, _I, _P,
                           _LL, _LL, _P, _P, _P, _P, _P, _P, _P),
    },
    "gather_segment_sum": {
        "ft_gather_segment_sum": (_P, _P, _P, _P, _P, _LL, _LL, _P, _P, _P,
                                  _P, _P),
    },
    "edge_popcount": {
        "ft_edge_scan": (_P, _LL, _LL, _I, _P, _P, _LL, _P),
        "ft_edge_fill": (_P, _LL, _LL, _I, _P, _LL, _P, _P, _LL, _P, _P),
        "ft_edge_popcount": (_P, _LL, _I, _P, _LL, _P, _P, _P, _P, _P, _LL, _P,
                             _I, _P),
    },
    "gram_accumulate": {
        "ft_gram_accumulate": (_P, _P, _P, _P, _P, _P, _LL, _P, _P, _LL, _I,
                               _P, _P, _P, _P),
    },
    "knn_topk": {
        "ft_knn_topk": (_P, _P, _P, _LL, _LL, _I, _P, _P),
    },
    "shard_pack": {
        "ft_shard_pack": (_P, _P, _LL, _P, _LL, _I, _I, _LL, _P, _P, _P, _I,
                          _P, _P, _P, _P, _P),
    },
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


#: where the CUDA toolkit is looked for after $CUDA_HOME and $CUDA_PATH
CUDA_ROOTS = ("/usr/local/cuda",)


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 *CUDA_ROOTS):
        if cand:
            path = Path(cand) / "bin" / "nvcc"
            if path.exists():
                return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in (*sorted(_CSRC.glob("*.cuh")), _CSRC / f"{name}.cu"):
        h.update(src.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return _BUILD / f"{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str) -> Optional[subprocess.Popen]:
    out = _library_path(name)
    if out.exists():
        return None
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = open(out.with_suffix(".log"), "w")
    try:
        return subprocess.Popen(
            [nvcc_path(), *_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT)
    finally:
        log.close()


def _finish_build(name: str, proc: Optional[subprocess.Popen],
                  t0: float) -> None:
    if proc is None:
        return
    out = _library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    rc = proc.wait()
    if rc != 0:
        log = out.with_suffix(".log").read_text()
        raise RuntimeError(f"nvcc failed for {name} (exit {rc}):\n{log}")
    os.replace(tmp, out)
    # started together: each build's seconds run from the common start
    _tracing.record_compile_event(f"cuda.build.{name}",
                                  time.perf_counter() - t0)


def build_all(names: Iterable[str] = KERNELS) -> float:
    """Build every named kernel that is not built yet, one nvcc per
    source, all started together; returns the seconds it took."""
    t0 = time.perf_counter()
    with _lock:
        procs = {name: _start_build(name) for name in names}
        for name, proc in procs.items():
            _finish_build(name, proc, t0)
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_library_path(name)))
            for fn, argtypes in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
    return lib


#: exported function name -> its ctypes function, bound at first launch
_functions: Dict[str, Callable[..., int]] = {}


def current_stream() -> int:
    """The raw handle of the current device's current CUDA stream (the
    one ``torch.cuda.stream(...)`` sets), read without building a
    ``torch.cuda.Stream`` object."""
    return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())


def launch(name: str, fn: str, *args) -> None:
    """Call one exported launcher on the current stream; count the
    launch and raise if CUDA refused it."""
    f = _functions.get(fn)
    if f is None:
        if fn not in _SIGNATURES[name]:
            raise KeyError(f"{name}: {fn} has no declared C signature")
        f = _functions[fn] = getattr(library(name), fn)
    if _tracing._tracer.enabled or TELEMETRY.enabled:
        stream = current_stream()
        err = _tracing.LAUNCH_LEDGER.record(name, lambda: f(*args, stream))
    else:
        err = f(*args, current_stream())
    # a queryable-state read launches from its client's thread
    with _launches_lock:
        LAUNCHES[name] += 1
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err} "
                           f"({fn})")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def check(t: torch.Tensor, what: str, dtypes, device: torch.device,
          ndim: Optional[int] = None) -> None:
    """Raise unless ``t`` is a contiguous tensor of one of ``dtypes``
    on ``device`` (and of ``ndim`` dimensions when given)."""
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what} has dtype {t.dtype}, expected one of "
                        f"{[str(d) for d in dtypes]}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{what} must have {ndim} dimensions, got "
                         f"{tuple(t.shape)}")


def check_all(first: torch.Tensor, *specs) -> None:
    """``check`` of every ``(tensor, what, dtypes, ndim)`` in ``specs``
    against ``first``'s device, in one pass: device indices are compared
    as ints, and only a tensor that fails the pass goes through
    ``check``, which raises its error."""
    index = first.get_device()
    for t, what, dtypes, ndim in specs:
        if (t.get_device() != index or t.dtype not in dtypes
                or not t.is_contiguous()
                or (ndim is not None and t.dim() != ndim)):
            check(t, what, dtypes, first.device, ndim)
