"""Keyed-state introspection plane: per-key-group accounting, hot-key
skew detection, and the offline snapshot inspector (port of
``flink_tpu/state/introspect.py``).  The port's backends account by
decoding their own snapshot (``KeyedStateBackend.accounting_breakdown``),
and the inspector reads checkpoint directories written by either
package.

One process-global singleton (`INTROSPECTION`, mirroring
`runtime.device_stats.TELEMETRY`): disabled by default, the hot-path
cost of the disabled state is ONE attribute check.  Three legs:

- **accounting** — authoritative per-(state, key-group) rows / bytes /
  namespace counts, pulled from the live backends' tables on demand
  (``accounting_breakdown()`` on both backends walks the SAME columnar
  blocks / slot tables a snapshot serializes, with the same key-group
  split and the same bytes definition, so live accounting and the
  offline inspector agree exactly).  A disposing backend freezes its
  breakdown here first, so a finished job's numbers survive it.

- **skew** — per-state Count-Min sketch + top-k candidate ring fed from
  the batched ingest path's ONE splitmix64 hash pass (the host twin of
  ``ops/sketches.py::CountMinSketchAggregate`` — identical
  Kirsch–Mitzenmacher column derivation as ``ops/hashing.countmin_rows``,
  uint32 arithmetic and all), plus per-key-group ingest counts.  Derives
  ``state.keyGroupSkew`` (max / mean occupied key-group load) and the
  hot-key list the `key-skew-sustained` health rule names.

- **inspection** — `inspect_checkpoint` reads a v2 columnar checkpoint
  directory WITHOUT a running job (read-only: no orphan sweep, no
  chunk adoption) and reproduces the exact same per-state per-key-group
  rows/bytes, a component dtype breakdown, the top-N heaviest keys and
  a rescale preview (`flink_tpu state inspect`).
"""

from __future__ import annotations

import pickle
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.core.keygroups import (
    assign_key_groups_np,
    compute_key_group_range_for_operator_index,
    murmur_hash,
    stable_hash64,
    stable_hashes_np,
)

#: skew verdict threshold (max/mean occupied key-group load); the
#: HealthEvaluator's `key_skew_threshold` defaults to the same value
SKEW_THRESHOLD = 3.0

#: Count-Min geometry — matches CountMinSketchAggregate's defaults
CM_DEPTH = 4
CM_WIDTH = 2048

#: hot-key candidate ring: prune back to CAND_KEEP once CAND_CAP hit
CAND_CAP = 64
CAND_KEEP = 32


def pickled_len(value) -> int:
    """THE bytes definition for boxed (per-row pickled) state values —
    shared by live accounting and the offline inspector so the two can
    never disagree."""
    return len(pickle.dumps(value, protocol=pickle.HIGHEST_PROTOCOL))


class _SkewTracker:
    """Per-state ingest sketch: Count-Min over key hashes (host twin of
    the device CountMinSketchAggregate), per-key-group ingest counts,
    and a bounded hot-key candidate ring."""

    __slots__ = ("table", "kg_counts", "candidates", "total")

    def __init__(self):
        self.table = np.zeros((CM_DEPTH, CM_WIDTH), np.int64)
        #: key group -> rows ingested
        self.kg_counts: Dict[int, int] = {}
        #: candidate key -> Count-Min estimate at last sighting
        self.candidates: Dict[Any, int] = {}
        self.total = 0

    # -- Kirsch–Mitzenmacher columns, EXACTLY ops/hashing.countmin_rows:
    # idx = (lo + r*hi) % width in uint32 arithmetic -------------------
    def _columns(self, hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
        r = np.arange(CM_DEPTH, dtype=np.uint32)[:, None]
        with np.errstate(over="ignore"):
            return ((lo[None, :] + r * hi[None, :])
                    % np.uint32(CM_WIDTH)).astype(np.int64)

    def note(self, keys, hashes: np.ndarray, kgs: np.ndarray) -> None:
        n = len(keys)
        if n == 0:
            return
        self.total += n
        for kg, cnt in zip(*np.unique(kgs, return_counts=True)):
            kg = int(kg)
            self.kg_counts[kg] = self.kg_counts.get(kg, 0) + int(cnt)
        # dedupe to unique hashes: ONE sketch update per distinct key
        uh, first, counts = np.unique(hashes, return_index=True,
                                      return_counts=True)
        hi = (uh >> np.uint64(32)).astype(np.uint32)
        lo = (uh & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        cols = self._columns(hi, lo)
        rows = np.broadcast_to(
            np.arange(CM_DEPTH, dtype=np.int64)[:, None], cols.shape)
        np.add.at(self.table, (rows, cols),
                  np.broadcast_to(counts[None, :], cols.shape))
        est = self.table[rows, cols].min(axis=0)
        cand = self.candidates
        for i, e in zip(first, est):
            cand[keys[int(i)]] = int(e)
        if len(cand) > CAND_CAP:
            keep = sorted(cand.items(), key=lambda kv: -kv[1])[:CAND_KEEP]
            self.candidates = dict(keep)

    def note_one(self, key, h: int, kg: int) -> None:
        self.total += 1
        self.kg_counts[kg] = self.kg_counts.get(kg, 0) + 1
        hi = np.uint32(h >> 32)
        lo = np.uint32(h & 0xFFFFFFFF)
        est = None
        with np.errstate(over="ignore"):
            for r in range(CM_DEPTH):
                c = int((lo + np.uint32(r) * hi) % np.uint32(CM_WIDTH))
                self.table[r, c] += 1
                v = int(self.table[r, c])
                est = v if est is None or v < est else est
        cand = self.candidates
        cand[key] = est
        if len(cand) > CAND_CAP:
            keep = sorted(cand.items(), key=lambda kv: -kv[1])[:CAND_KEEP]
            self.candidates = dict(keep)

    def skew(self) -> Tuple[float, Optional[int], int]:
        """(max/mean occupied key-group load, hottest key group,
        occupied key-group count)."""
        if not self.kg_counts:
            return 0.0, None, 0
        occupied = len(self.kg_counts)
        hot_kg, hot = max(self.kg_counts.items(), key=lambda kv: kv[1])
        mean = self.total / occupied
        return (hot / mean if mean else 0.0), hot_kg, occupied


class StateIntrospection:
    """Process-global keyed-state introspection (the house singleton
    shape of runtime.device_stats.DeviceTelemetry).  Everything is a
    no-op until `enable()`; hot paths guard with ONE attribute check
    (`if INTROSPECTION.enabled:`)."""

    def __init__(self):
        self.enabled = False
        self._lock = threading.Lock()
        import weakref
        #: live keyed backends (registered unconditionally at __init__;
        #: a WeakSet so leaked backends drop out without unregister)
        self._backends: "weakref.WeakSet" = weakref.WeakSet()
        #: accounting breakdowns frozen at backend dispose
        self._frozen: List[dict] = []
        #: state name -> skew tracker
        self._trackers: Dict[str, _SkewTracker] = {}

    # ---- lifecycle --------------------------------------------------
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        with self._lock:
            self._frozen.clear()
            self._trackers.clear()

    # ---- backend registry -------------------------------------------
    def register_backend(self, backend) -> None:
        with self._lock:
            self._backends.add(backend)

    def note_dispose(self, backend) -> None:
        """Called by KeyedStateBackend.dispose BEFORE tables clear:
        freeze the disposing backend's accounting so a finished job's
        numbers survive into the archive payload."""
        try:
            bd = backend.accounting_breakdown()
        except Exception:  # noqa: BLE001 — racing teardown
            bd = None
        with self._lock:
            self._backends.discard(backend)
            if bd:
                self._frozen.append(bd)

    # ---- ingest hooks (enabled path only) ---------------------------
    def _tracker(self, state_name: str) -> _SkewTracker:
        t = self._trackers.get(state_name)
        if t is None:
            with self._lock:
                t = self._trackers.setdefault(state_name, _SkewTracker())
        return t

    def note_ingest(self, state_name: str, keys,
                    max_parallelism: int) -> None:
        """Batched ingest: ONE vectorized splitmix64 pass over the key
        column feeds both the key-group counts and the Count-Min
        columns (hash halves are the CM's (hi, lo) pair, exactly like
        the device sketch)."""
        if not len(keys):
            return
        try:
            hashes = stable_hashes_np(keys)
            kgs = assign_key_groups_np(hashes, max_parallelism)
            self._tracker(state_name).note(list(keys), hashes, kgs)
        except Exception:  # noqa: BLE001 — observability never faults
            pass           # the ingest path

    def note_row(self, state_name: str, key, max_parallelism: int) -> None:
        """Scalar-path twin of note_ingest (per-element window adds)."""
        try:
            h = stable_hash64(key)
            kg = murmur_hash(h & 0xFFFFFFFF) % max_parallelism
            self._tracker(state_name).note_one(key, h, kg)
        except Exception:  # noqa: BLE001
            pass

    # ---- accounting (pull model) ------------------------------------
    def _merged_accounting(self) -> Dict[str, Dict[int, dict]]:
        with self._lock:
            sources = list(self._frozen)
            backends = list(self._backends)
        for b in backends:
            try:
                sources.append(b.accounting_breakdown())
            except Exception:  # noqa: BLE001 — racing mutation/dispose
                continue
        merged: Dict[str, Dict[int, dict]] = {}
        for bd in sources:
            for name, per_kg in bd.items():
                dst = merged.setdefault(name, {})
                for kg, e in per_kg.items():
                    d = dst.get(kg)
                    if d is None:
                        dst[kg] = dict(e)
                    else:
                        d["rows"] += e["rows"]
                        d["bytes"] += e["bytes"]
                        # key-group ranges are disjoint across subtask
                        # backends, so summing distinct-namespace counts
                        # is exact; frozen vs live never double-counts
                        # (dispose removes from the registry first)
                        d["namespaces"] += e["namespaces"]
        return merged

    # ---- gauge surface (cheap: trackers only, no accounting walk) ---
    def skew_summary(self) -> dict:
        """What the `state.keyGroupSkew` / `state.hotKey*` gauges read:
        worst per-state skew ratio, the hottest key group, occupied
        key-group count, the top hot-key share and the number of keys
        estimated at >= 5% of their state's ingest.  Zeros while
        disabled or idle (the health rule stays quiet)."""
        out = {"ratio": 0.0, "hot_key_group": -1,
               "occupied_key_groups": 0, "hot_key_share": 0.0,
               "hot_keys": 0}
        if not self.enabled:
            return out
        with self._lock:
            trackers = list(self._trackers.values())
        for t in trackers:
            r, kg, occ = t.skew()
            out["occupied_key_groups"] += occ
            if r > out["ratio"]:
                out["ratio"] = r
                out["hot_key_group"] = kg if kg is not None else -1
            if t.total:
                for cnt in t.candidates.values():
                    share = cnt / t.total
                    if share >= 0.05:
                        out["hot_keys"] += 1
                    if share > out["hot_key_share"]:
                        out["hot_key_share"] = share
        out["ratio"] = round(out["ratio"], 4)
        out["hot_key_share"] = round(out["hot_key_share"], 4)
        return out

    # ---- payload (live REST, archive, `top`) ------------------------
    def payload(self, top: Optional[int] = None) -> dict:
        if not self.enabled:
            return {"enabled": False, "accounting": {}, "ingest": {},
                    "skew": {"ratio": 0.0, "hot_key_group": None,
                             "occupied_key_groups": 0, "verdict": "disabled",
                             "per_state": {}},
                    "hot_keys": []}
        top = 10 if top is None else top
        merged = self._merged_accounting()
        accounting = {}
        for name in sorted(merged):
            per_kg = merged[name]
            rows = sum(e["rows"] for e in per_kg.values())
            nbytes = sum(e["bytes"] for e in per_kg.values())
            accounting[name] = {
                "rows": int(rows), "bytes": int(nbytes),
                "key_groups": {
                    str(kg): {"rows": int(e["rows"]),
                              "bytes": int(e["bytes"]),
                              "namespaces": int(e["namespaces"])}
                    for kg, e in sorted(per_kg.items())},
            }
        with self._lock:
            trackers = dict(self._trackers)
        ingest = {name: int(t.total)
                  for name, t in sorted(trackers.items())}
        per_state_skew = {}
        ratio, hot_kg = 0.0, None
        occupied = 0
        for name, t in sorted(trackers.items()):
            r, kg, occ = t.skew()
            per_state_skew[name] = {"ratio": round(r, 4),
                                    "hot_key_group": kg,
                                    "occupied_key_groups": occ,
                                    "rows": int(t.total)}
            occupied += occ
            if r > ratio:
                ratio, hot_kg = r, kg
        verdict = ("idle" if not trackers
                   else "skewed" if ratio >= SKEW_THRESHOLD
                   else "balanced")
        hot_keys = []
        for name, t in sorted(trackers.items()):
            for key, cnt in t.candidates.items():
                share = cnt / t.total if t.total else 0.0
                hot_keys.append({"state": name, "key": repr(key),
                                 "count": int(cnt),
                                 "share": round(share, 4)})
        hot_keys.sort(key=lambda e: (-e["count"], e["state"], e["key"]))
        return {
            "enabled": True,
            "accounting": accounting,
            "ingest": ingest,
            "skew": {"ratio": round(ratio, 4), "hot_key_group": hot_kg,
                     "occupied_key_groups": int(occupied),
                     "verdict": verdict, "per_state": per_state_skew},
            "hot_keys": hot_keys[:top],
        }


INTROSPECTION = StateIntrospection()


def get_introspection() -> StateIntrospection:
    return INTROSPECTION


# ====================================================================
# Offline snapshot inspector (`flink_tpu state inspect`)
# ====================================================================

def _read_checkpoint_entry(fs, path: str):
    from flink_tpu_torch.runtime.checkpoints import _crc_unwrap
    from flink_tpu_torch.state import portable
    with fs.open(path, "rb") as f:
        data = f.read()
    # either package's files: portable maps the reference's classes
    return portable.loads(_crc_unwrap(data, path))


def load_checkpoint_readonly(directory: str,
                             checkpoint_id: Optional[int] = None) -> dict:
    """Read-only twin of FsCheckpointStorage.load: no orphan sweep, no
    chunk adoption, no registry — safe to point at a LIVE job's
    checkpoint directory.  Resolves ChunkRefs straight off
    `shared/<hash>` files."""
    from flink_tpu_torch.core.fs import get_file_system
    from flink_tpu_torch.state.shared_registry import ChunkRef, map_chunks
    fs, directory = get_file_system(directory)
    ids = []
    for name in fs.listdir(directory):
        if name.startswith("chk-") and not name.endswith(".part"):
            try:
                ids.append(int(name[4:]))
            except ValueError:
                pass
    if not ids:
        raise FileNotFoundError(
            f"no chk-N checkpoint files under {directory!r}")
    if checkpoint_id is None:
        checkpoint_id = max(ids)
    elif checkpoint_id not in ids:
        raise FileNotFoundError(
            f"checkpoint {checkpoint_id} not in {sorted(ids)}")
    entry = _read_checkpoint_entry(
        fs, f"{directory.rstrip('/')}/chk-{checkpoint_id}")
    shared = f"{directory.rstrip('/')}/shared"
    cache: Dict[str, Any] = {}

    def fetch(r):
        if not isinstance(r, ChunkRef):
            return r
        if r.hash not in cache:
            cache[r.hash] = _read_checkpoint_entry(fs, f"{shared}/{r.hash}")
        return cache[r.hash]

    return {**entry, "tasks": map_chunks(entry["tasks"], fetch)}


def _walk_keyed_snapshots(node, out: list) -> None:
    """Collect every KeyedStateSnapshot in a checkpoint's tasks tree
    (tolerant of the exact nesting — tasks → operators → snapshots)."""
    from flink_tpu_torch.state.backend import KeyedStateSnapshot
    if isinstance(node, KeyedStateSnapshot):
        out.append(node)
    elif isinstance(node, dict):
        for v in node.values():
            _walk_keyed_snapshots(v, out)
    elif isinstance(node, (list, tuple)):
        for v in node:
            _walk_keyed_snapshots(v, out)


def _acct_entry(per_kg: Dict[int, dict], kg: int) -> dict:
    e = per_kg.get(kg)
    if e is None:
        e = per_kg[kg] = {"rows": 0, "bytes": 0, "_ns": set()}
    return e


def inspect_snapshot_chunks(snapshots) -> dict:
    """Decode v2 columnar chunks into the introspection accounting
    shape: per-state per-key-group rows/bytes/namespace counts, a
    component dtype breakdown, and per-key weights for the heaviest-key
    report.  Bytes definitions are EXACTLY the live accounting's:
    component ndarray nbytes for columnar rows, pickled length for
    boxed rows."""
    from flink_tpu_torch.state import portable
    from flink_tpu_torch.state.backend import decode_obj_column
    states: Dict[str, Dict[int, dict]] = {}
    dtypes: Dict[str, Dict[str, int]] = {}
    key_weights: Dict[Tuple[str, Any], List[int]] = {}
    backends: List[str] = []
    max_parallelism = None

    def _dt(name: str, dtype: str, nbytes: int) -> None:
        d = dtypes.setdefault(name, {})
        d[dtype] = d.get(dtype, 0) + nbytes

    def _key(name: str, key, rows: int, nbytes: int) -> None:
        w = key_weights.setdefault((name, key), [0, 0])
        w[0] += rows
        w[1] += nbytes

    for snap in snapshots:
        meta = snap.meta or {}
        if meta.get("backend") and meta["backend"] not in backends:
            backends.append(meta["backend"])
        if meta.get("max_parallelism"):
            max_parallelism = int(meta["max_parallelism"])
        for kg, blob in snap.blobs():
            chunk = portable.loads(blob)
            if not (isinstance(chunk, dict) and chunk.get("v") == 2):
                raise ValueError(
                    f"key group {kg}: not a v2 columnar chunk "
                    f"(legacy snapshots are not inspectable offline)")
            for name, namespace, key, value in chunk["rows"]:
                e = _acct_entry(states.setdefault(name, {}), kg)
                nbytes = pickled_len(value)
                e["rows"] += 1
                e["bytes"] += nbytes
                e["_ns"].add(namespace)
                _dt(name, "pickled", nbytes)
                _key(name, key, 1, nbytes)
            for name, blocks in chunk["cols"].items():
                per_kg = states.setdefault(name, {})
                for block in blocks:
                    comps = block["comps"]
                    n = len(next(iter(comps.values()))) if comps else 0
                    e = _acct_entry(per_kg, kg)
                    block_bytes = 0
                    row_bytes = 0
                    for comp, arr in comps.items():
                        arr = np.asarray(arr)
                        block_bytes += arr.nbytes
                        row_bytes += arr.nbytes // max(n, 1)
                        _dt(name, str(arr.dtype), arr.nbytes)
                    e["rows"] += n
                    e["bytes"] += block_bytes
                    ns_field = block["ns"]
                    if ns_field[0] == "const":
                        e["_ns"].add(ns_field[1])
                    else:
                        e["_ns"].update(decode_obj_column(ns_field[1], n))
                    for key in decode_obj_column(block["keys"], n):
                        _key(name, key, 1, row_bytes)
    out_states = {}
    for name in sorted(states):
        per_kg = states[name]
        out_states[name] = {
            "rows": sum(e["rows"] for e in per_kg.values()),
            "bytes": sum(e["bytes"] for e in per_kg.values()),
            "dtypes": dict(sorted(dtypes.get(name, {}).items())),
            "key_groups": {
                kg: {"rows": e["rows"], "bytes": e["bytes"],
                     "namespaces": len(e["_ns"])}
                for kg, e in sorted(per_kg.items())},
        }
    return {"states": out_states, "backends": backends,
            "max_parallelism": max_parallelism,
            "_key_weights": key_weights}


def top_keys(report: dict, n: int = 10) -> List[dict]:
    """Top-N heaviest keys across all states, by bytes then rows."""
    weights = report.get("_key_weights", {})
    ranked = sorted(weights.items(),
                    key=lambda kv: (-kv[1][1], -kv[1][0],
                                    kv[0][0], repr(kv[0][1])))
    return [{"state": name, "key": repr(key),
             "rows": rows, "bytes": nbytes}
            for (name, key), (rows, nbytes) in ranked[:n]]


def rescale_preview(report: dict, parallelism: int,
                    max_parallelism: Optional[int] = None) -> dict:
    """Predicted per-subtask key-group ranges and load for a
    hypothetical rescale to `parallelism` — the exact input the
    autoscaler's rescale decision needs."""
    from flink_tpu_torch.core.keygroups import (
        DEFAULT_LOWER_BOUND_MAX_PARALLELISM)
    mp = (max_parallelism or report.get("max_parallelism")
          or DEFAULT_LOWER_BOUND_MAX_PARALLELISM)
    if parallelism < 1 or parallelism > mp:
        raise ValueError(
            f"parallelism must be in [1, {mp}] (max parallelism)")
    per_kg_rows: Dict[int, int] = {}
    per_kg_bytes: Dict[int, int] = {}
    for st in report["states"].values():
        for kg, e in st["key_groups"].items():
            kg = int(kg)
            per_kg_rows[kg] = per_kg_rows.get(kg, 0) + e["rows"]
            per_kg_bytes[kg] = per_kg_bytes.get(kg, 0) + e["bytes"]
    subtasks = []
    for i in range(parallelism):
        rng = compute_key_group_range_for_operator_index(
            mp, parallelism, i)
        kgs = range(rng.start_key_group, rng.end_key_group + 1)
        rows = sum(per_kg_rows.get(kg, 0) for kg in kgs)
        nbytes = sum(per_kg_bytes.get(kg, 0) for kg in kgs)
        subtasks.append({
            "subtask": i,
            "key_group_range": [rng.start_key_group, rng.end_key_group],
            "rows": rows, "bytes": nbytes,
        })
    total_rows = sum(s["rows"] for s in subtasks)
    mean = total_rows / parallelism if parallelism else 0.0
    hottest = max(subtasks, key=lambda s: s["rows"]) if subtasks else None
    return {
        "parallelism": parallelism,
        "max_parallelism": mp,
        "subtasks": subtasks,
        "imbalance": round(hottest["rows"] / mean, 4)
        if hottest and mean else 0.0,
    }


def inspect_checkpoint(directory: str,
                       checkpoint_id: Optional[int] = None,
                       top: int = 10,
                       parallelism: Optional[int] = None) -> dict:
    """The `flink_tpu state inspect` engine: load a checkpoint
    read-only, decode every keyed snapshot's v2 chunks, and build the
    full report (accounting + dtypes + heaviest keys + optional rescale
    preview)."""
    entry = load_checkpoint_readonly(directory, checkpoint_id)
    snapshots: list = []
    _walk_keyed_snapshots(entry.get("tasks"), snapshots)
    report = inspect_snapshot_chunks(snapshots)
    report["checkpoint_id"] = entry.get("checkpoint_id")
    report["directory"] = directory
    report["top_keys"] = top_keys(report, top)
    if parallelism is not None:
        report["rescale"] = rescale_preview(report, parallelism)
    report.pop("_key_weights", None)
    return report
