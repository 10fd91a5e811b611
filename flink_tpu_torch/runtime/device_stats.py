"""Device telemetry plane: the H2D/D2H transfer ledger, HBM
accounting, and per-kernel dispatch attribution (port of
``flink_tpu/runtime/device_stats.py``; ledger tags and payload shape are
the reference's).

* **Transfer ledger** — ``record_transfer(direction, nbytes, t0_ns,
  t1_ns, tag)`` around every host↔device copy (state flushes, fire
  reads, snapshot pulls, spill evictions, mesh exchanges, the fused
  chain's boundary).  Per ``(direction, tag)`` it keeps count, bytes
  and wall time; bytes are the host arrays' ``nbytes``, as in the
  reference.  While the span tracer is on each transfer also lands in
  the Chrome trace as a ``device.transfer`` event.

* **Exchange-phase ledger** — ``record_exchange_round`` keeps the
  per-round pack/H2D/collective/D2H breakdown of the mesh tier.

* **Dispatch attribution** — ``record_kernel_dispatch`` is fed by
  :func:`flink_tpu_torch.runtime.tracing.traced_call` under the
  reference's kernel labels.  The CUDA launch ledger (device time per
  hand-written kernel, from CUDA events) is ``tracing.LAUNCH_LEDGER``;
  ``payload()`` carries it as ``cuda_launches``.

* **HBM accounting** — ``hbm_snapshot()`` reads
  ``torch.cuda.memory_stats`` of the card the live engines and device
  states sit on, and falls back on the CPU to framework-level
  accounting: the summed ``nbytes`` of every live device state and
  window engine registered in :mod:`flink_tpu_torch.state.stats`.

The singleton ``TELEMETRY`` starts disabled, and every instrumented hot
path guards with one ``if TELEMETRY.enabled:`` attribute check: the
disabled path makes no timing call, allocates nothing, takes no lock.

Timing semantics: an H2D copy or a launch returns before the card is
done with it, so their wall times measure the dispatch; a D2H read into
host memory waits for the work before it, so its wall time is the copy
and whatever it waited on.  The ledger attributes cost; it is not a
hardware counter.  No call here moves a tensor or synchronizes, except
``payload()``, which resolves the launch ledger.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, Optional, Tuple

from flink_tpu_torch.runtime import tracing as _tracing

__all__ = [
    "DeviceTelemetry",
    "TELEMETRY",
    "get_telemetry",
    "tree_nbytes",
    "register_device_gauges",
]

_perf_ns = time.perf_counter_ns


def tree_nbytes(tree: Any) -> int:
    """Summed ``nbytes`` over the tensors and numpy arrays of a nested
    dict / list / tuple (anything else counts 0): the bytes-in/out
    estimate of a dispatch."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    nb = getattr(tree, "nbytes", None)
    return nb if isinstance(nb, int) else 0


class _TransferStat:
    __slots__ = ("count", "bytes", "total_ms")

    def __init__(self) -> None:
        self.count = 0
        self.bytes = 0
        self.total_ms = 0.0


class _KernelStat:
    __slots__ = ("dispatches", "total_ms", "bytes_in", "bytes_out")

    def __init__(self) -> None:
        self.dispatches = 0
        self.total_ms = 0.0
        self.bytes_in = 0
        self.bytes_out = 0


class _PhaseStat:
    __slots__ = ("rounds", "pack_ms", "h2d_ms", "collective_ms",
                 "d2h_ms", "bytes")

    def __init__(self) -> None:
        self.rounds = 0
        self.pack_ms = 0.0
        self.h2d_ms = 0.0
        self.collective_ms = 0.0
        self.d2h_ms = 0.0
        self.bytes = 0


class DeviceTelemetry:
    """Process-wide device-boundary ledger (singleton ``TELEMETRY``)."""

    def __init__(self) -> None:
        #: hot paths check ONLY this attribute; everything else is
        #: behind it
        self.enabled = False
        self._lock = threading.Lock()
        self._transfers: Dict[Tuple[str, str], _TransferStat] = {}
        self._kernels: Dict[str, _KernelStat] = {}
        self._phases: Dict[str, _PhaseStat] = {}
        #: recent exchange rounds (per-round phase ms) for bench output
        self._recent_rounds: deque = deque(maxlen=256)
        self.flushes = 0
        self.flush_rows = 0
        self.fire_reads = 0
        self.windows_fired = 0
        #: (monotonic seconds, cumulative windows_fired) samples, one
        #: per note_windows_fired — bounded ring feeding the
        #: windows-fired/s rate gauge
        self._fired_ring: deque = deque(maxlen=64)

    # ---- lifecycle --------------------------------------------------
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        with self._lock:
            self._transfers.clear()
            self._kernels.clear()
            self._phases.clear()
            self._recent_rounds.clear()
            self.flushes = 0
            self.flush_rows = 0
            self.fire_reads = 0
            self.windows_fired = 0
            self._fired_ring.clear()

    # ---- recording (callers guard on .enabled) ----------------------
    def record_transfer(self, direction: str, nbytes: int,
                        t0_ns: int, t1_ns: int, tag: str) -> None:
        """Account one host↔device copy.  ``direction`` is ``"h2d"``
        or ``"d2h"``; ``tag`` names the call site (``state.flush``,
        ``state.fire``, ``mesh.exchange``, ...)."""
        ms = (t1_ns - t0_ns) / 1e6
        key = (direction, tag)
        with self._lock:
            stat = self._transfers.get(key)
            if stat is None:
                stat = self._transfers[key] = _TransferStat()
            stat.count += 1
            stat.bytes += int(nbytes)
            stat.total_ms += ms
        tracer = _tracing._tracer
        if tracer.enabled:
            event = {
                "name": "device.transfer",
                "ph": "X",
                "ts": t0_ns / 1000.0,
                "dur": (t1_ns - t0_ns) / 1000.0,
                "pid": tracer._pid,
                "tid": threading.get_ident(),
                "args": {"direction": direction, "bytes": int(nbytes),
                         "tag": tag},
            }
            lane = tracer.current_lane()
            if lane is not None:
                event["lane"] = lane
            with tracer._lock:
                tracer._append_locked(event)

    def record_kernel_dispatch(self, label: str, ms: float,
                               bytes_in: int, bytes_out: int) -> None:
        """Per-label dispatch attribution (fed by ``traced_call``)."""
        with self._lock:
            stat = self._kernels.get(label)
            if stat is None:
                stat = self._kernels[label] = _KernelStat()
            stat.dispatches += 1
            stat.total_ms += ms
            stat.bytes_in += int(bytes_in)
            stat.bytes_out += int(bytes_out)

    def record_exchange_round(self, tag: str, pack_ms: float,
                              h2d_ms: float, collective_ms: float,
                              d2h_ms: float, nbytes: int) -> None:
        """One mesh exchange round's phase breakdown."""
        with self._lock:
            stat = self._phases.get(tag)
            if stat is None:
                stat = self._phases[tag] = _PhaseStat()
            stat.rounds += 1
            stat.pack_ms += pack_ms
            stat.h2d_ms += h2d_ms
            stat.collective_ms += collective_ms
            stat.d2h_ms += d2h_ms
            stat.bytes += int(nbytes)
            self._recent_rounds.append({
                "tag": tag,
                "pack_ms": round(pack_ms, 4),
                "h2d_ms": round(h2d_ms, 4),
                "collective_ms": round(collective_ms, 4),
                "d2h_ms": round(d2h_ms, 4),
                "bytes": int(nbytes),
            })

    def note_flush(self, n: int) -> None:
        with self._lock:
            self.flushes += 1
            self.flush_rows += n

    def note_fire_read(self, n: int = 1) -> None:
        with self._lock:
            self.fire_reads += n

    def note_windows_fired(self, n: int) -> None:
        if n:
            with self._lock:
                self.windows_fired += n
                self._fired_ring.append(
                    (time.monotonic(), self.windows_fired))

    # ---- aggregation ------------------------------------------------
    def direction_totals(self) -> Dict[str, Dict[str, float]]:
        """``{"h2d": {count, bytes, total_ms}, "d2h": {...}}``."""
        out: Dict[str, Dict[str, float]] = {
            "h2d": {"count": 0, "bytes": 0, "total_ms": 0.0},
            "d2h": {"count": 0, "bytes": 0, "total_ms": 0.0},
        }
        with self._lock:
            for (direction, _tag), stat in self._transfers.items():
                tot = out.setdefault(
                    direction, {"count": 0, "bytes": 0, "total_ms": 0.0})
                tot["count"] += stat.count
                tot["bytes"] += stat.bytes
                tot["total_ms"] += stat.total_ms
        return out

    def fire_flush_ratio(self) -> float:
        flushes = self.flushes
        return (self.fire_reads / flushes) if flushes else 0.0

    def windows_fired_rate(self, horizon: float = 5.0) -> float:
        """Windows fired per second over roughly the last ``horizon``
        seconds: the cumulative count's slope against the oldest ring
        sample still inside the horizon (or the oldest sample at all —
        a sparse firer still gets a rate).  0.0 when fewer than two
        samples or no time has passed — rate undefined, not infinite."""
        now = time.monotonic()
        with self._lock:
            ring = list(self._fired_ring)
        if len(ring) < 2:
            return 0.0
        base_t, base_c = ring[0]
        for t, c in ring:
            if now - t <= horizon:
                break
            base_t, base_c = t, c
        latest_t, latest_c = ring[-1]
        dt = latest_t - base_t
        if dt <= 0.0 or latest_c <= base_c:
            return 0.0
        return (latest_c - base_c) / dt

    def hbm_snapshot(self) -> Dict[str, Any]:
        """Device-memory picture: ``torch.cuda.memory_stats`` of the card
        the live device states and engines sit on (in use =
        ``allocated_bytes.all.current``, limit = the card's total from
        ``mem_get_info``), else framework-level accounting over them
        (the CPU fallback)."""
        dev = _live_cuda_device()
        if dev is not None:
            import torch
            stats = torch.cuda.memory_stats(dev)
            return {
                "source": "memory_stats",
                "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
                "bytes_limit": int(torch.cuda.mem_get_info(dev)[1]),
                "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            }
        return {"source": "framework", "bytes_limit": 0,
                "peak_bytes_in_use": 0, **self.framework_hbm()}

    @staticmethod
    def framework_hbm() -> Dict[str, Any]:
        """Summed ``nbytes`` (with a per-dtype breakdown) of the state
        components held by every live ``DeviceAggregatingState`` and
        window engine: what the framework itself put on the device."""
        total = 0
        by_dtype: Dict[str, int] = {}
        for arrays in _live_state_dicts():
            for arr in arrays.values():
                nb = getattr(arr, "nbytes", None)
                if not isinstance(nb, int):
                    continue
                total += nb
                dt = str(getattr(arr, "dtype", "unknown"))
                by_dtype[dt] = by_dtype.get(dt, 0) + nb
        return {"bytes_in_use": total, "by_dtype": by_dtype}

    @staticmethod
    def link_info() -> Dict[str, Any]:
        """The one-shot H2D link probe's cached result WITHOUT
        triggering a measurement (an unprobed process reports
        ``measured: False``)."""
        from flink_tpu_torch.ops import link_probe
        cache = dict(link_probe._cache)
        out: Dict[str, Any] = {"measured": bool(cache)}
        if cache:
            # the port probes per device: report the first one probed
            dev, m = next(iter(cache.items()))
            gbps = m.get("h2d_gbps", 0.0)
            out["h2d_gbps"] = (None if gbps == float("inf")
                               else float(gbps))
            out["cpu_backend"] = bool(m.get("cpu", 0.0))
            out["finish_tier"] = link_probe.recommended_finish_tier(dev)
        return out

    def payload(self) -> Dict[str, Any]:
        """The full device-plane payload (the reference's shape, plus
        ``cuda_launches``: the launch ledger, resolved here after one
        synchronize)."""
        cuda_launches = _tracing.LAUNCH_LEDGER.stats()
        with self._lock:
            transfers = {
                f"{direction}.{tag}": {
                    "count": stat.count,
                    "bytes": stat.bytes,
                    "total_ms": round(stat.total_ms, 4),
                }
                for (direction, tag), stat in sorted(self._transfers.items())
            }
            kernels = {
                label: {
                    "dispatches": stat.dispatches,
                    "total_ms": round(stat.total_ms, 4),
                    "bytes_in": stat.bytes_in,
                    "bytes_out": stat.bytes_out,
                }
                for label, stat in sorted(self._kernels.items())
            }
            phases = {
                tag: {
                    "rounds": stat.rounds,
                    "pack_ms": round(stat.pack_ms, 4),
                    "h2d_ms": round(stat.h2d_ms, 4),
                    "collective_ms": round(stat.collective_ms, 4),
                    "d2h_ms": round(stat.d2h_ms, 4),
                    "bytes": stat.bytes,
                }
                for tag, stat in sorted(self._phases.items())
            }
            recent_rounds = list(self._recent_rounds)
            counters = {
                "flushes": self.flushes,
                "flush_rows": self.flush_rows,
                "fire_reads": self.fire_reads,
                "windows_fired": self.windows_fired,
            }
        counters["fire_flush_ratio"] = round(self.fire_flush_ratio(), 4)
        counters["windows_fired_rate"] = round(self.windows_fired_rate(), 2)
        return {
            "enabled": self.enabled,
            "counters": counters,
            "transfers": transfers,
            "totals": self.direction_totals(),
            "kernels": kernels,
            "cuda_launches": cuda_launches,
            "exchange_phases": phases,
            "recent_exchange_rounds": recent_rounds,
            "hbm": self.hbm_snapshot(),
            "link": self.link_info(),
        }


TELEMETRY = DeviceTelemetry()


def _live_state_dicts():
    """The component dicts of every registered live device state and
    window engine."""
    from flink_tpu_torch.state.stats import (_LIVE_DEVICE_STATES,
                                             _LIVE_ENGINES, _LIVE_LOCK)
    with _LIVE_LOCK:
        live = list(_LIVE_DEVICE_STATES) + list(_LIVE_ENGINES)
    out = []
    for st in live:
        arrays = getattr(st, "device_state", None)
        if arrays is None:
            arrays = getattr(st, "state", None)
        if isinstance(arrays, dict):
            out.append(arrays)
        elif isinstance(arrays, (list, tuple)):
            # a mesh engine's per-shard states
            out.extend(a for a in arrays if isinstance(a, dict))
    return out


def _live_cuda_device() -> Optional[Any]:
    """The CUDA device of the first registered state tensor on one,
    else None."""
    for arrays in _live_state_dicts():
        for arr in arrays.values():
            dev = getattr(arr, "device", None)
            if getattr(dev, "type", None) == "cuda":
                return dev
    return None


def get_telemetry() -> DeviceTelemetry:
    return TELEMETRY


def register_device_gauges(metrics) -> None:
    """Publish the ``device.*`` gauge surface for a process: transfer
    ledger totals per direction, flush/fire/windows-fired counters and
    the fire-flush ratio, HBM in-use/limit, and the link probe's
    cached H2D bandwidth + chosen finish tier.  Registered under the
    registry root — the device is shared by every job a process runs,
    like the data and state planes."""
    t = TELEMETRY
    g = metrics.root.add_group("device")
    g.gauge("enabled", lambda: 1 if t.enabled else 0)
    g.gauge("flushes", lambda: t.flushes)
    g.gauge("flushRows", lambda: t.flush_rows)
    g.gauge("fireReads", lambda: t.fire_reads)
    g.gauge("windowsFired", lambda: t.windows_fired)
    g.gauge("windowsFiredRate", lambda: t.windows_fired_rate())
    g.gauge("fireFlushRatio", lambda: t.fire_flush_ratio())

    def _dir(direction, field):
        return t.direction_totals().get(direction, {}).get(field, 0)

    h2d = g.add_group("h2d")
    h2d.gauge("count", lambda: _dir("h2d", "count"))
    h2d.gauge("bytes", lambda: _dir("h2d", "bytes"))
    h2d.gauge("totalMs", lambda: _dir("h2d", "total_ms"))
    d2h = g.add_group("d2h")
    d2h.gauge("count", lambda: _dir("d2h", "count"))
    d2h.gauge("bytes", lambda: _dir("d2h", "bytes"))
    d2h.gauge("totalMs", lambda: _dir("d2h", "total_ms"))

    hbm = g.add_group("hbm")

    def _hbm(field):
        return t.hbm_snapshot().get(field, 0)

    hbm.gauge("bytesInUse", lambda: _hbm("bytes_in_use"))
    hbm.gauge("bytesLimit", lambda: _hbm("bytes_limit"))
    hbm.gauge("source", lambda: _hbm("source"))

    link = g.add_group("link")

    def _link(field, default=None):
        return t.link_info().get(field, default)

    link.gauge("h2dGbps", lambda: _link("h2d_gbps"))
    link.gauge("finishTier", lambda: _link("finish_tier", ""))
    link.gauge("measured", lambda: 1 if _link("measured") else 0)
