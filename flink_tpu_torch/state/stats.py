"""Process-wide state-pressure statistics (port of
``flink_tpu/state/stats.py``).

One mutable singleton (`STATE_STATS`) counts batched-vs-row state
ingest and device flush traffic, plus a weak registry of the live
device-resident aggregation states so gauges can report slots in use,
spill-tier size, evictions and pending-ring depth without the backend
holding a reference to the metrics plane.

Beside the reference's registry of keyed-backend states, the port keeps
one of the window engines (scatter, session, sliding, mesh): on the
card their register files are most of what the framework holds, so
``DeviceTelemetry.framework_hbm`` sums both.  The engines stay out of
``device_state_summary``, whose shape is the reference's.
"""

from __future__ import annotations

import threading
import weakref
from collections import deque


class StateStats:
    """Counters for the keyed-state ingest/flush hot path."""

    __slots__ = (
        "batch_rows", "row_fallback_rows", "batch_calls",
        "row_fallback_calls", "flush_batches", "flush_rows",
        "flush_sizes", "snapshot_columns", "snapshot_rows",
        "per_state_batch_rows", "per_state_batch_calls",
        "per_state_fallback_rows", "per_state_fallback_calls",
    )

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        #: rows ingested through a backend-native add_batch path
        self.batch_rows = 0
        #: rows that fell back to per-row state.add inside add_batch
        self.row_fallback_rows = 0
        self.batch_calls = 0
        self.row_fallback_calls = 0
        #: device micro-batch flushes and the rows they carried
        self.flush_batches = 0
        self.flush_rows = 0
        #: recent flush batch sizes (for mean/max gauges)
        self.flush_sizes = deque(maxlen=512)
        #: snapshot rows serialized as columns vs boxed per-row
        self.snapshot_columns = 0
        self.snapshot_rows = 0
        #: the same batch/fallback split ATTRIBUTED by state name, so a
        #: fallback is traceable to the state that caused it; the
        #: aggregate counters above stay authoritative for the
        #: established gauge names
        self.per_state_batch_rows = {}
        self.per_state_batch_calls = {}
        self.per_state_fallback_rows = {}
        self.per_state_fallback_calls = {}

    def note_batch(self, name: str, n: int) -> None:
        """One backend-native add_batch/get_batch call of `n` rows on
        state `name` (aggregates + the per-state split in one call)."""
        self.batch_calls += 1
        self.batch_rows += n
        self.per_state_batch_calls[name] = \
            self.per_state_batch_calls.get(name, 0) + 1
        self.per_state_batch_rows[name] = \
            self.per_state_batch_rows.get(name, 0) + n

    def note_fallback(self, name: str, n: int) -> None:
        """One per-row fallback pass of `n` rows on state `name`."""
        self.row_fallback_calls += 1
        self.row_fallback_rows += n
        self.per_state_fallback_calls[name] = \
            self.per_state_fallback_calls.get(name, 0) + 1
        self.per_state_fallback_rows[name] = \
            self.per_state_fallback_rows.get(name, 0) + n

    def note_flush(self, n: int) -> None:
        self.flush_batches += 1
        self.flush_rows += n
        self.flush_sizes.append(n)

    def flush_size_mean(self) -> float:
        sizes = self.flush_sizes
        return (sum(sizes) / len(sizes)) if sizes else 0.0

    def flush_size_max(self) -> int:
        sizes = self.flush_sizes
        return max(sizes) if sizes else 0


STATE_STATS = StateStats()

# Live device-resident states (DeviceAggregatingState instances).  A
# WeakSet so disposed backends drop out without an unregister call.
_LIVE_DEVICE_STATES: "weakref.WeakSet" = weakref.WeakSet()
_LIVE_LOCK = threading.Lock()


def register_device_state(state) -> None:
    with _LIVE_LOCK:
        _LIVE_DEVICE_STATES.add(state)


def device_state_summary() -> dict:
    """Aggregate live device-state pressure: slots in use, capacity,
    host-spill entries, evictions, host→device promotions, pending-ring
    depth.  Safe to call from a gauge thread."""
    slots = capacity = spilled = evictions = promotions = pending = 0
    states = 0
    with _LIVE_LOCK:
        live = list(_LIVE_DEVICE_STATES)
    for st in live:
        try:
            states += 1
            slots += len(st.slot_index)
            capacity += st.capacity
            spilled += len(st.host_tier)
            evictions += st.evictions
            promotions += st.promotions
            pending += len(st._pending_slots)
        except Exception:  # noqa: BLE001 — racing dispose
            continue
    return {
        "states": states,
        "slots_in_use": slots,
        "capacity": capacity,
        "spilled_entries": spilled,
        "evictions": evictions,
        "promotions": promotions,
        "pending_depth": pending,
    }


# Live window engines holding device tensors (``.state``: a dict of
# tensors, or ``.device_state``), read only by framework_hbm.
_LIVE_ENGINES: "weakref.WeakSet" = weakref.WeakSet()


def register_device_engine(engine) -> None:
    with _LIVE_LOCK:
        _LIVE_ENGINES.add(engine)
