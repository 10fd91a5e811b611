"""The generic window tier: batched execution for any Python
``AggregateFunction`` (port of ``flink_tpu/streaming/generic_agg.py``).

The device engines cover aggregates with a cell decomposition
(``DeviceAggregateFunction``); every other aggregate over an eligible
window shape (tumbling, sliding with size % slide == 0, sessions;
default trigger, no evictor, lateness 0) runs here instead of per
record on ``WindowOperator``:

- **ingest** appends (key, value columns) rows to a per-window log:
  array appends, no hash probes, no per-record Python;
- **fire** sorts the log by key (stable, so a key's arrival order is
  kept) and folds each key's run with the user's ``add``;
- the fold runs in **diagonal rounds**: round *r* gathers the *r*-th
  row of every key's run and calls the user's ``add`` once with numpy
  column vectors, so the user's arithmetic runs over all keys at once.
  Python ``add`` calls per fire = the largest run, not the record count.

Whether an aggregate's ``add`` / ``get_result`` / ``merge`` take arrays
is decided by the static verdict of ``analysis.liftability`` or, when
that is inconclusive, by a runtime **probe** on the first batch: the
lifted fold runs against the scalar reference on a sample and must
agree.  Aggregates that fail run the same sorted-segment fold with
scalar ``add`` calls: no per-record state probes, the same semantics.

This is host code by design.  The user's functions get **numpy**
columns, as in the reference: a user ``add`` that calls ``np.*``
computes the same thing in both packages, which it would not on torch
tensors.  So the tier keeps no device state and takes no device.  The
grouping runs on the port's C++ host runtime (``native.fold_prep``,
``group_cols``, ``argsort_u64``).

Windows fire by watermark like the other tiers (window [start,
start + size) fires when ``start + size - 1 <= watermark``); logs past
a size threshold compact into per-key accumulator rows (folded with
``merge`` at fire), so steady-state memory is O(keys), not O(records).
The operator's lift decision is published as the reference's ``lift``
gauges (``decision``, ``decided_by``, ``fallback_reason``) and as a
``lift.decision`` trace instant.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from flink_tpu_torch import native as nat
from flink_tpu_torch.core.functions import _FieldKeySelector
from flink_tpu_torch.core.keygroups import make_key_group_keep_fn
from flink_tpu_torch.runtime.tracing import get_tracer
from flink_tpu_torch.streaming.device_window_operator import \
    batch_window_eligible
from flink_tpu_torch.streaming.elements import MAX_TIMESTAMP
from flink_tpu_torch.streaming.operators import (StreamOperator,
                                                TimestampedCollector)
from flink_tpu_torch.streaming.windowing import (EventTimeSessionWindows,
                                                 SlidingEventTimeWindows,
                                                 TimeWindow,
                                                 TumblingEventTimeWindows)

log = logging.getLogger("flink_tpu_torch.generic_agg")

#: (aggregate class name, reason head) pairs already warned about —
#: the probe fallback warning fires once per aggregate/cause, not once
#: per subtask
_FALLBACK_WARNED: set = set()

__all__ = [
    "LiftedAggregate",
    "GenericLogTumblingWindows",
    "GenericLogSlidingWindows",
    "GenericLogSessionWindows",
    "GenericWindowOperator",
    "generic_engine_for_assigner",
    "is_generic_eligible",
]

_NUMERIC = (int, float, bool, np.integer, np.floating, np.bool_)


class _ProbeDisagreement(Exception):
    """Lifted fold and scalar reference disagreed on the probe sample
    (message carries the failing field/dtype for the fallback log)."""


def _stable_argsort(keys: np.ndarray) -> np.ndarray:
    """Stable argsort; 64-bit integer keys ride the C++ radix sort
    (numpy's stable 64-bit sort is a comparison sort, ~5x slower at
    fire-path sizes).  Signed keys map through a sign-bit flip, which
    is order-preserving into unsigned space."""
    if keys.dtype == np.uint64 or keys.dtype == np.int64:
        u = (keys if keys.dtype == np.uint64
             else keys.view(np.uint64) ^ np.uint64(1 << 63))
        return nat.argsort_u64(u)
    return np.argsort(keys, kind="stable")


def _grouped(keys: np.ndarray):
    """Fused C++ grouping (argsort + segments + length-descending
    layout) for 64-bit integer keys: (order, seg_starts, seg_lens,
    ukeys) or None when the dtype does not apply.  ukeys come back in
    the original dtype."""
    if keys.dtype not in (np.dtype(np.uint64), np.dtype(np.int64)) \
            or len(keys) == 0:
        return None
    signed = keys.dtype == np.int64
    u = (keys.view(np.uint64) ^ np.uint64(1 << 63)) if signed else keys
    order, starts, lens, ukeys = nat.fold_prep(u)
    if signed:
        ukeys = (ukeys ^ np.uint64(1 << 63)).view(np.int64)
    return order, starts, lens, ukeys


def columnify(rows: Sequence[Any]):
    """rows of scalars / uniform tuples → (cols, spec).

    spec: "scalar" | ("tuple", k) | ("list", k); None when the rows
    are not column-representable (ragged / nested / non-scalar
    fields) — callers then keep the rows as an object column.
    """
    first = rows[0]
    if isinstance(first, _NUMERIC + (str, np.str_, bytes)):
        try:
            col = np.asarray(rows)
        except Exception:
            return None, None   # mixed scalar/sequence rows
        if col.dtype.kind == "O" or col.ndim != 1:
            return None, None
        return [col], "scalar"
    if isinstance(first, (tuple, list)):
        k = len(first)
        if k == 0 or any(
                not isinstance(f, _NUMERIC + (str, np.str_, bytes))
                for f in first):
            return None, None
        try:
            cols = [np.asarray([r[i] for r in rows]) for i in range(k)]
        except Exception:
            return None, None
        if any(c.dtype.kind == "O" or c.ndim != 1 for c in cols):
            return None, None
        return cols, ("tuple" if isinstance(first, tuple) else "list", k)
    return None, None


def _value_struct(cols, spec):
    if spec == "scalar":
        return cols[0]
    kind, _ = spec
    return tuple(cols) if kind == "tuple" else list(cols)


class LiftedAggregate:
    """A Python ``AggregateFunction`` with (probed) array semantics.

    Accumulators are represented as a tuple of parallel numpy arrays
    ("fields"); the user's functions are called with the SAME Python
    structure they declared (scalar / tuple / list), just holding
    arrays instead of scalars.

    An aggregate that would pass the probe but must not be lifted
    (see ``AggregateFunction.force_scalar``) pins ``mode`` to
    "scalar" here, before any probe runs.
    """

    def __init__(self, agg):
        self.agg = agg
        self.acc0 = agg.create_accumulator()
        self.acc_spec = self._spec_of(self.acc0)
        pinned = bool(getattr(agg, "force_scalar", False))
        #: "lifted" | "scalar" | None (undecided — probe on first use)
        self.mode: Optional[str] = "scalar" if pinned else None
        self.field_dtypes: Optional[List[np.dtype]] = None
        #: whether get_result lifts too (it can fail independently of
        #: add — e.g. a result built via data-dependent branching)
        self.result_lifted = False
        #: who decided the mode: "static" (AOT analysis), "probe"
        #: (runtime sample), "pin" (force_scalar), "restore"
        self.decided_by: Optional[str] = "pin" if pinned else None
        #: why the scalar path was chosen (None while undecided/lifted)
        self.fallback_reason: Optional[str] = (
            "force_scalar" if pinned else None)
        #: operator uid/name for log + trace context (set by the owner)
        self.owner: str = ""
        self._static_lift = False
        self._static_result_lift = False

    # ---- ahead-of-time verdict --------------------------------------
    def apply_static(self, report) -> None:
        """Feed a conclusive AOT verdict (analysis.liftability).

        SCALAR_ONLY / IMPURE locks the scalar fold immediately; a
        LIFTABLE proof arms a probe-skip fast path — the probe still
        dry-runs one ``add`` to learn field dtypes, but skips the
        scalar-reference replay and comparison (one less warm-up
        batch).  Inconclusive (or None) leaves the runtime probe in
        charge."""
        if report is None or self.mode is not None:
            return
        verdict = getattr(report, "verdict", None)
        if verdict == "LIFTABLE":
            self._static_lift = True
            self._static_result_lift = bool(
                getattr(report, "result_liftable", False))
        elif verdict in ("SCALAR_ONLY", "IMPURE"):
            reasons = "; ".join(getattr(report, "reasons", [])) \
                or verdict.lower()
            self._lock("scalar", "static", reasons, warn=False)

    def _lock(self, mode: str, decided_by: str,
              reason: Optional[str] = None, warn: bool = True) -> None:
        self.mode = mode
        self.decided_by = decided_by
        if mode == "scalar" and reason:
            self.fallback_reason = reason
            if warn:
                self._warn_fallback(reason)
        get_tracer().record_instant(
            "lift.decision", mode=mode, decided_by=decided_by,
            reason=reason or "", operator=self.owner,
            aggregate=type(self.agg).__name__)

    def _warn_fallback(self, reason: str) -> None:
        key = (type(self.agg).__name__, reason.split(":")[0])
        if key in _FALLBACK_WARNED:
            return
        _FALLBACK_WARNED.add(key)
        where = f" (operator {self.owner})" if self.owner else ""
        log.warning(
            "aggregate %s%s falls back to the per-record scalar "
            "fold: %s", type(self.agg).__name__, where, reason)

    # ---- accumulator structure --------------------------------------
    @staticmethod
    def _spec_of(acc0):
        if isinstance(acc0, _NUMERIC):
            return "scalar"
        if isinstance(acc0, (tuple, list)) and len(acc0) and all(
                isinstance(f, _NUMERIC) for f in acc0):
            return ("tuple" if isinstance(acc0, tuple) else "list",
                    len(acc0))
        return None

    def _n_fields(self) -> int:
        return 1 if self.acc_spec == "scalar" else self.acc_spec[1]

    def _acc_struct(self, fields):
        if self.acc_spec == "scalar":
            return fields[0]
        kind, _ = self.acc_spec
        return tuple(fields) if kind == "tuple" else list(fields)

    def _fields_of(self, acc_struct, n: int):
        """Validate + normalize a lifted call's return into field
        arrays of length n (scalars broadcast)."""
        if self.acc_spec == "scalar":
            parts = [acc_struct]
        else:
            kind, k = self.acc_spec
            if not isinstance(acc_struct, (tuple, list)) \
                    or len(acc_struct) != k:
                raise TypeError("accumulator structure changed")
            parts = list(acc_struct)
        out = []
        for p in parts:
            a = np.asarray(p)
            if a.ndim == 0:
                a = np.full(n, a[()])
            elif a.shape != (n,):
                raise TypeError("accumulator field is not a column")
            out.append(a)
        return out

    def init_fields(self, n: int) -> List[np.ndarray]:
        inits = ([self.acc0] if self.acc_spec == "scalar"
                 else list(self.acc0))
        return [np.full(n, v, dt)
                for v, dt in zip(inits, self.field_dtypes)]

    # ---- probe ------------------------------------------------------
    def probe(self, cols, vspec, obj_rows=None) -> str:
        """Decide lifted vs scalar on a data sample; locks the mode."""
        if self.mode is not None:
            return self.mode
        agg = self.agg
        if self.acc_spec is None or vspec is None:
            self._lock("scalar", "probe",
                       "accumulator or value rows are not "
                       "column-representable", warn=False)
            return self.mode
        if self._static_lift:
            # AOT-proven liftable: skip the scalar-reference replay.
            # One dry-run add still runs to learn the field dtypes.
            try:
                probe_fields = self._fields_of(
                    agg.add(_value_struct([c[:1] for c in cols], vspec),
                            self._acc_struct([np.asarray([v]) for v in (
                                [self.acc0] if self.acc_spec == "scalar"
                                else list(self.acc0))])), 1)
                self.field_dtypes = [f.dtype for f in probe_fields]
                self.result_lifted = self._static_result_lift
                self._lock("lifted", "static")
                return self.mode
            except Exception:
                # the proof did not survive contact with real data —
                # fall back to the full runtime probe
                self._static_lift = False
        m = min(64, len(cols[0]))
        sample = [c[:m] for c in cols]
        rows = list(zip(*[c.tolist() for c in sample])) \
            if vspec != "scalar" else sample[0].tolist()
        if vspec is not None and vspec != "scalar" and vspec[0] == "list":
            rows = [list(r) for r in rows]
        # scalar reference: up to two interleaved groups (a 1-record
        # first batch probes with one group — an empty group's
        # get_result may legitimately raise, e.g. mean's 0/0)
        n_groups = 2 if m >= 2 else 1
        try:
            ref = []
            for g in range(n_groups):
                acc = agg.create_accumulator()
                for r in rows[g::2]:
                    acc = agg.add(r, acc)
                ref.append(acc)
            ref_res = [agg.get_result(a) for a in ref]
        except Exception as e:
            self._lock("scalar", "probe",
                       f"scalar reference replay raised {e!r}")
            return self.mode
        # lifted: the same groups as slot columns, diagonal rounds
        try:
            # dry-run one add to learn the field dtypes
            probe_fields = self._fields_of(
                agg.add(_value_struct([c[:1] for c in sample], vspec),
                        self._acc_struct([np.asarray([v]) for v in (
                            [self.acc0] if self.acc_spec == "scalar"
                            else list(self.acc0))])), 1)
            self.field_dtypes = [f.dtype for f in probe_fields]
            fields = self.init_fields(n_groups)
            max_len = (m + 1) // 2 if n_groups == 2 else m
            for r in range(max_len):
                idx = [g + 2 * r for g in range(n_groups)
                       if g + 2 * r < m]
                if not idx:
                    break
                slots = np.asarray([i % 2 for i in idx])
                vs = _value_struct([c[idx] for c in sample], vspec)
                acc = self._acc_struct([f[slots] for f in fields])
                new = self._fields_of(agg.add(vs, acc), len(idx))
                for f, nf in zip(fields, new):
                    f[slots] = nf.astype(f.dtype, copy=False)
            lift = [self._acc_struct([np.asarray([f[g]]) for f in fields])
                    for g in range(n_groups)]
            mismatch = None
            for g in range(n_groups):
                detail = self._acc_mismatch(lift[g], ref[g])
                if detail is not None:
                    mismatch = f"group {g}: {detail}"
                    break
            if mismatch is None and n_groups == 2:
                merged = agg.merge(lift[0], lift[1])
                mf = self._fields_of(merged, 1)
                detail = self._acc_mismatch(self._acc_struct(
                    [np.asarray([f[0]]) for f in mf]),
                    agg.merge(ref[0], ref[1]))
                if detail is not None:
                    mismatch = f"merge: {detail}"
            if mismatch is not None:
                raise _ProbeDisagreement(mismatch)
            # result lifting probed separately (failure only demotes
            # get_result, not the fold)
            try:
                res = agg.get_result(self._acc_struct(
                    [np.asarray([float(f[g]) for g in range(n_groups)])
                     .astype(f.dtype) for f in fields]))
                self.result_lifted = self._res_close(
                    res, ref_res[:n_groups])
            except Exception:
                self.result_lifted = False
            self._lock("lifted", "probe")
        except _ProbeDisagreement as e:
            self._lock("scalar", "probe",
                       f"lifted fold disagrees with the scalar "
                       f"reference — {e}")
        except Exception as e:
            self._lock("scalar", "probe",
                       f"lifted replay raised {e!r}")
        return self.mode

    def _acc_mismatch(self, lifted_struct, scalar_acc) -> Optional[str]:
        """First disagreeing accumulator field between a 1-slot lifted
        struct and a scalar reference, or None when they agree.  The
        detail (field index, dtype, both values) feeds the structured
        fallback warning."""
        lf = self._fields_of(lifted_struct, 1)
        sf = ([scalar_acc] if self.acc_spec == "scalar"
              else list(scalar_acc))
        for i, (a, b) in enumerate(zip(lf, sf)):
            if not np.allclose(np.asarray(a, np.float64),
                               np.float64(b), rtol=1e-9, atol=1e-12,
                               equal_nan=True):
                return (f"field {i} (dtype {np.asarray(a).dtype}): "
                        f"lifted={np.asarray(a)[0]!r} "
                        f"scalar={b!r}")
        return None

    @staticmethod
    def _res_close(lifted_res, scalar_results):
        n = len(scalar_results)
        try:
            if isinstance(scalar_results[0], _NUMERIC):
                arr = np.asarray(lifted_res)
                if arr.shape != (n,):
                    return False
                return np.allclose(arr.astype(np.float64),
                                   np.asarray(scalar_results, np.float64),
                                   rtol=1e-9, atol=1e-12, equal_nan=True)
            if isinstance(scalar_results[0], (tuple, list)):
                k = len(scalar_results[0])
                if not isinstance(lifted_res, (tuple, list)) \
                        or len(lifted_res) != k:
                    return False
                for i in range(k):
                    arr = np.asarray(lifted_res[i])
                    if arr.shape != (n,):
                        return False
                    want = np.asarray([r[i] for r in scalar_results],
                                      np.float64)
                    if not np.allclose(arr.astype(np.float64), want,
                                       rtol=1e-9, atol=1e-12,
                                       equal_nan=True):
                        return False
                return True
        except Exception:
            return False
        return False

    # ---- folds ------------------------------------------------------
    def fold_rows(self, order, seg_starts, seg_lens, cols, vspec,
                  seg_perm=None, presorted=False,
                  cols_presorted=False):
        """Fold sorted segments of value rows into per-segment
        accumulator fields.  order: stable sort permutation over the
        rows; seg_starts/lens: segment layout in sorted space.

        Lifted path: segments are processed in LENGTH-DESCENDING order
        (either already laid out that way — ``presorted`` from the C++
        ``ft_fold_prep`` — or permuted here; the returned fields follow
        that order) so each diagonal round's live set is a prefix —
        accumulator reads/writes are slice views, not gather/scatter."""
        n_seg = len(seg_starts)
        if self.mode == "lifted":
            if presorted:
                starts_d, lens_d = seg_starts, seg_lens
            else:
                if seg_perm is None:
                    # length-descending permutation via the radix
                    # argsort (lens are small ints: one counting pass)
                    mx = int(seg_lens.max()) if n_seg else 0
                    seg_perm = _stable_argsort(
                        (mx - seg_lens).astype(np.uint64))
                starts_d = seg_starts[seg_perm]
                lens_d = seg_lens[seg_perm]
            fields = self.init_fields(n_seg)
            max_len = int(lens_d[0]) if n_seg else 0
            # survivors per round from the length histogram: k(r) =
            # #segments with len > r (lens_d is descending, so those
            # are exactly the first k(r) segments)
            hist = np.bincount(lens_d, minlength=max_len + 1)
            alive = n_seg - np.cumsum(hist)
            # pre-permute the value columns once: per-round gathers
            # then index near-sorted positions instead of random rows
            # (skipped when the C++ group kernel already co-scattered)
            cols_s = cols if cols_presorted else [c[order] for c in cols]
            for r in range(max_len):
                k = int(alive[r])
                if k <= 0:
                    break
                rows = starts_d[:k] + r
                vs = _value_struct([c[rows] for c in cols_s], vspec)
                acc = self._acc_struct([f[:k] for f in fields])
                new = self._fields_of(self.agg.add(vs, acc), k)
                for f, nf in zip(fields, new):
                    f[:k] = nf
            return fields, seg_perm
        # scalar fallback: per-segment Python fold (no per-record
        # state probes — the sort already grouped the keys)
        agg = self.agg
        accs = np.empty(n_seg, object)
        if vspec is None:
            obj = cols  # cols IS the object row list here
            for i in range(n_seg):
                s = seg_starts[i]
                acc = agg.create_accumulator()
                for j in range(int(seg_lens[i])):
                    acc = agg.add(obj[order[s + j]], acc)
                accs[i] = acc
        else:
            pycols = [c.tolist() for c in cols]
            mk = (
                (lambda j: pycols[0][j]) if vspec == "scalar" else
                (lambda j: tuple(c[j] for c in pycols))
                if vspec[0] == "tuple" else
                (lambda j: [c[j] for c in pycols]))
            for i in range(n_seg):
                s = seg_starts[i]
                acc = agg.create_accumulator()
                for j in range(int(seg_lens[i])):
                    acc = agg.add(mk(int(order[s + j])), acc)
                accs[i] = acc
        return accs, None

    def merge_sorted(self, order, seg_starts, seg_lens, accs,
                     presorted=False):
        """Fold sorted segments of accumulator rows with ``merge``.
        accs: field-array list (lifted) or object array (scalar).
        Returns (merged, seg_perm) like fold_rows — merged follows
        the length-descending segment order in lifted mode."""
        n_seg = len(seg_starts)
        if self.mode == "lifted":
            seg_perm = None
            if presorted:
                starts_d, lens_d = seg_starts, seg_lens
            else:
                mx = int(seg_lens.max()) if n_seg else 0
                seg_perm = _stable_argsort(
                    (mx - seg_lens).astype(np.uint64))
                starts_d = seg_starts[seg_perm]
                lens_d = seg_lens[seg_perm]
            accs_s = accs if order is None else [f[order] for f in accs]
            fields = [f[starts_d].copy() for f in accs_s]
            max_len = int(lens_d[0]) if n_seg else 0
            hist = np.bincount(lens_d, minlength=max_len + 1)
            alive = n_seg - np.cumsum(hist)
            for r in range(1, max_len):
                k = int(alive[r])
                if k <= 0:
                    break
                rows = starts_d[:k] + r
                a = self._acc_struct([f[:k] for f in fields])
                b = self._acc_struct([f[rows] for f in accs_s])
                new = self._fields_of(self.agg.merge(a, b), k)
                for f, nf in zip(fields, new):
                    f[:k] = nf
            return fields, seg_perm
        agg = self.agg
        out = np.empty(n_seg, object)
        for i in range(n_seg):
            s = seg_starts[i]
            acc = accs[order[s]]
            for j in range(1, int(seg_lens[i])):
                acc = agg.merge(acc, accs[order[s + j]])
            out[i] = acc
        return out, None

    def merge_chunks(self, keys: np.ndarray, accs):
        """Concatenated acc rows (possibly several chunks' worth) →
        per-key merged accs: group by key (co-scattering the acc
        fields through the C++ kernel when eligible) and fold with
        ``merge``.  Returns (ukeys, merged)."""
        if self.mode == "lifted" \
                and keys.dtype in (np.dtype(np.uint64),
                                   np.dtype(np.int64)):
            g = nat.group_cols(keys.view(np.uint64), accs,
                               want_order=False)
            if g is not None:
                _, saccs, starts, lens, ukeys = g
                if keys.dtype == np.dtype(np.int64):
                    ukeys = ukeys.view(np.int64)
                merged, _ = self.merge_sorted(
                    None, starts, lens, saccs, presorted=True)
                return ukeys, merged
        prep = _grouped(keys)
        if prep is not None:
            order, starts, lens, ukeys = prep
            merged, _ = self.merge_sorted(order, starts, lens, accs,
                                          presorted=True)
            return ukeys, merged
        order = _stable_argsort(keys)
        skeys = keys[order]
        starts, lens = _segments(skeys)
        merged, seg_perm = self.merge_sorted(order, starts, lens, accs)
        return (skeys[starts] if seg_perm is None
                else skeys[starts[seg_perm]]), merged

    def results_of(self, accs, n: int):
        """Accumulators → list of per-key Python results."""
        agg = self.agg
        if self.mode == "lifted":
            if self.result_lifted:
                res = agg.get_result(self._acc_struct(list(accs)))
                if isinstance(res, (tuple, list)):
                    parts = [np.asarray(p).tolist() for p in res]
                    mk = tuple if isinstance(res, tuple) else list
                    return [mk(p[i] for p in parts) for i in range(n)]
                return np.asarray(res).tolist()
            structs = (accs[0].tolist() if self.acc_spec == "scalar"
                       else None)
            if structs is not None:
                return [agg.get_result(a) for a in structs]
            kind, _ = self.acc_spec
            mk = tuple if kind == "tuple" else list
            pyfields = [f.tolist() for f in accs]
            return [agg.get_result(mk(f[i] for f in pyfields))
                    for i in range(n)]
        return [agg.get_result(a) for a in accs]


class _WindowLog:
    """Append-only row log for one window: chunks of raw value rows
    plus compacted accumulator chunks (per-key, key-sorted)."""

    __slots__ = ("key_chunks", "col_chunks", "acc_key_chunks",
                 "acc_chunks", "count")

    def __init__(self):
        self.key_chunks: List[np.ndarray] = []
        self.col_chunks: List[Any] = []   # per chunk: cols list | obj rows
        self.acc_key_chunks: List[np.ndarray] = []
        self.acc_chunks: List[Any] = []   # fields list | object array
        self.count = 0

    def append(self, keys, cols):
        self.key_chunks.append(keys)
        self.col_chunks.append(cols)
        self.count += len(keys)


def _segments(sorted_keys: np.ndarray):
    """Boundaries of equal-key runs in an already-sorted key column."""
    n = len(sorted_keys)
    if n == 0:
        return (np.zeros(0, np.int64),) * 2
    change = np.empty(n, bool)
    change[0] = True
    np.not_equal(sorted_keys[1:], sorted_keys[:-1], out=change[1:])
    starts = np.flatnonzero(change)
    lens = np.diff(np.append(starts, n))
    return starts, lens


class _GenericLogEngine:
    """Shared machinery: value columnification, the probe, the
    sort+fold fire path, snapshot/restore.  Subclasses define window
    assignment and the fire schedule."""

    def __init__(self, aggregate, compact_threshold: int = 1 << 21):
        self.agg = aggregate
        self.lift = LiftedAggregate(aggregate)
        self.compact_threshold = compact_threshold
        self.windows: Dict[int, _WindowLog] = {}
        self.watermark = -(2 ** 63)
        self.emitted: List[Tuple[Any, Any, int, int]] = []
        self.emit_arrays = False
        self.fired: List[Tuple[np.ndarray, Any, int, int]] = []
        self.num_late_dropped = 0
        self.vspec = None
        self._vspec_locked = False

    # -- interface parity with the other engine tiers ---------------
    def flush(self, grow_to=None):
        pass

    def block_until_ready(self):
        pass

    @property
    def mode(self) -> Optional[str]:
        return self.lift.mode

    # -- ingest ------------------------------------------------------
    def _prep_values(self, values, n: int):
        """values (array | list of rows | None) → (cols, obj_rows).

        The value spec locks on the first batch; a later batch with a
        DIFFERENT shape (heterogeneous stream) demotes the whole
        engine to object-row mode — semantics match the per-record
        WindowOperator, only the vectorization is lost."""
        if values is None:
            raise ValueError(
                "generic aggregates need the record values "
                "(process_batch(values=...))")
        rows = None
        if isinstance(values, np.ndarray) and values.dtype.kind != "O":
            if values.ndim == 1:
                cols, vspec = [values], "scalar"
            else:
                cols = [values[:, i] for i in range(values.shape[1])]
                vspec = ("tuple", values.shape[1])
        else:
            rows = (values.tolist()
                    if isinstance(values, np.ndarray) else list(values))
            cols, vspec = columnify(rows)
        if not self._vspec_locked:
            self.vspec, self._vspec_locked = vspec, True
            if vspec is None:
                self.lift.mode = "scalar"
            else:
                self.lift.probe(cols, vspec)
        elif vspec != self.vspec:
            # shape change mid-stream: demote everything to object rows
            if self.vspec is not None:
                self._demote_to_object()
            vspec = None
        if vspec is None:
            if rows is None:
                rows = (values.tolist()
                        if isinstance(values, np.ndarray)
                        else list(values))
            obj = np.empty(n, object)
            obj[:] = rows
            return None, obj
        return cols, None

    def _demote_to_object(self):
        """Convert buffered column chunks (and the locked spec) to
        object-row mode — the correctness path for value streams whose
        shape changes after the first batch.  Compacted acc chunks
        stay: merge/get_result consume accumulators, not values."""
        if self.lift.mode == "lifted":
            # re-materialize lifted acc chunks as scalar accumulators
            for log in self.windows.values():
                for i, fields in enumerate(log.acc_chunks):
                    m = len(log.acc_key_chunks[i])
                    accs = np.empty(m, object)
                    if self.lift.acc_spec == "scalar":
                        vals = fields[0].tolist()
                        accs[:] = vals
                    else:
                        kind, _ = self.lift.acc_spec
                        mk = tuple if kind == "tuple" else list
                        pyf = [f.tolist() for f in fields]
                        accs[:] = [mk(f[j] for f in pyf)
                                   for j in range(m)]
                    log.acc_chunks[i] = accs
        self.lift.mode = "scalar"
        spec = self.vspec
        self.vspec = None
        for log in self.windows.values():
            for i, cc in enumerate(log.col_chunks):
                if not isinstance(cc, list):
                    continue  # already object rows
                m = len(log.key_chunks[i])
                obj = np.empty(m, object)
                if spec == "scalar":
                    obj[:] = cc[0].tolist()
                else:
                    kind, _ = spec
                    mk = tuple if kind == "tuple" else list
                    pyc = [col.tolist() for col in cc]
                    obj[:] = [mk(col[j] for col in pyc)
                              for j in range(m)]
                log.col_chunks[i] = obj

    def _append(self, start: int, keys, cols, obj):
        log = self.windows.get(start)
        if log is None:
            log = self.windows[start] = _WindowLog()
        log.append(keys, cols if obj is None else obj)
        if log.count >= self.compact_threshold:
            self._compact(log)

    # -- fold machinery ----------------------------------------------
    def _fold_sorted_rows(self, keys, cols, payload):
        """Group a row chunk by key and fold → (ukeys, accs).  Three
        grouping tiers: fused C++ count+co-scatter (small key domains,
        numeric value columns), C++ radix fold_prep (64-bit integer
        keys), numpy stable argsort (everything else)."""
        if cols is not None \
                and keys.dtype in (np.dtype(np.uint64),
                                   np.dtype(np.int64)):
            lifted = self.lift.mode == "lifted"
            g = nat.group_cols(keys.view(np.uint64),
                               cols if lifted else (),
                               want_order=not lifted)
            if g is not None:
                order, scols, starts, lens, ukeys = g
                if keys.dtype == np.dtype(np.int64):
                    ukeys = ukeys.view(np.int64)
                if lifted:
                    # columns came back co-scattered: rounds index
                    # them directly, no numpy re-permute
                    accs, _ = self.lift.fold_rows(
                        order, starts, lens, scols, self.vspec,
                        presorted=True, cols_presorted=True)
                else:
                    accs, _ = self.lift.fold_rows(
                        order, starts, lens, cols, self.vspec,
                        presorted=True)
                return ukeys, accs
        prep = _grouped(keys)
        if prep is not None:
            order, starts, lens, ukeys = prep
            accs, _ = self.lift.fold_rows(
                order, starts, lens,
                payload if self.vspec is None else cols,
                self.vspec, presorted=True)
            return ukeys, accs
        order = _stable_argsort(keys)
        skeys = keys[order]
        starts, lens = _segments(skeys)
        accs, seg_perm = self.lift.fold_rows(
            order, starts, lens,
            payload if self.vspec is None else cols, self.vspec)
        return (skeys[starts] if seg_perm is None
                else skeys[starts[seg_perm]]), accs

    def _fold_log(self, log: _WindowLog):
        """→ (keys_sorted_unique, accs) folding raw rows with add and
        compacted chunks with merge."""
        acc_keys: List[np.ndarray] = list(log.acc_key_chunks)
        acc_chunks: List[Any] = list(log.acc_chunks)
        if log.key_chunks:
            keys = (log.key_chunks[0] if len(log.key_chunks) == 1
                    else np.concatenate(log.key_chunks))
            if self.vspec is None:
                obj = (log.col_chunks[0] if len(log.col_chunks) == 1
                       else np.concatenate(log.col_chunks))
                cols, payload = None, obj
            else:
                k = len(log.col_chunks[0])
                cols = [np.concatenate([c[i] for c in log.col_chunks])
                        if len(log.col_chunks) > 1 else
                        log.col_chunks[0][i] for i in range(k)]
                payload = cols
            ukeys, accs = self._fold_sorted_rows(keys, cols, payload)
            acc_keys.append(ukeys)
            acc_chunks.append(accs)
        if not acc_keys:
            return np.zeros(0, np.int64), None
        if len(acc_keys) == 1:
            return acc_keys[0], acc_chunks[0]
        keys = np.concatenate(acc_keys)
        if self.lift.mode == "lifted":
            nf = self.lift._n_fields()
            accs = [np.concatenate([c[i] for c in acc_chunks])
                    for i in range(nf)]
        else:
            accs = np.concatenate(acc_chunks)
        return self.lift.merge_chunks(keys, accs)

    def _compact(self, log: _WindowLog):
        """Fold the raw rows into an acc chunk.  Acc chunks are NOT
        merged here — re-merging the carry on every compaction is the
        quadratic-retained-state trap; fire merges all chunks once.
        Only when the acc chunks alone outgrow the threshold (heavy
        key churn) are they deduped into one."""
        raw_only = _WindowLog()
        raw_only.key_chunks = log.key_chunks
        raw_only.col_chunks = log.col_chunks
        ukeys, accs = self._fold_log(raw_only)
        log.key_chunks, log.col_chunks = [], []
        if len(ukeys):
            log.acc_key_chunks.append(ukeys)
            log.acc_chunks.append(accs)
        acc_rows = sum(len(c) for c in log.acc_key_chunks)
        if len(log.acc_key_chunks) > 1 \
                and acc_rows >= self.compact_threshold:
            merged = _WindowLog()
            merged.acc_key_chunks = log.acc_key_chunks
            merged.acc_chunks = log.acc_chunks
            ukeys, accs = self._fold_log(merged)
            log.acc_key_chunks = [ukeys]
            log.acc_chunks = [accs]
            acc_rows = len(ukeys)
        log.count = acc_rows

    def _emit(self, ukeys, accs, start: int, end: int):
        n = len(ukeys)
        if n == 0:
            return 0
        if self.emit_arrays:
            if self.lift.mode == "lifted" and self.lift.result_lifted:
                res = self.agg.get_result(self.lift._acc_struct(
                    list(accs)))
            else:
                res = np.asarray(self.lift.results_of(accs, n),
                                 dtype=object)
            self.fired.append((ukeys, res, start, end))
        else:
            results = self.lift.results_of(accs, n)
            pykeys = ukeys.tolist()
            self.emitted.extend(
                (pykeys[i], results[i], start, end) for i in range(n))
        return n

    # -- checkpoint ---------------------------------------------------
    def snapshot(self) -> dict:
        for log in self.windows.values():
            # compacted acc rows are only portable when the fold ran;
            # raw rows always are — compact so restarts resume from
            # bounded state
            if log.key_chunks and self.lift.mode is not None:
                self._compact(log)
        wins = {}
        for start, log in self.windows.items():
            if log.key_chunks:   # mode never probed: raw rows
                wins[start] = {
                    "raw_keys": [np.asarray(c) for c in log.key_chunks],
                    "raw_cols": log.col_chunks,
                    "vspec": self.vspec,
                }
            else:
                wins[start] = {
                    "acc_keys": log.acc_key_chunks,
                    "accs": log.acc_chunks,
                }
        return {
            "generic_log": True,
            "watermark": self.watermark,
            "num_late_dropped": self.num_late_dropped,
            "vspec": self.vspec,
            "vspec_locked": self._vspec_locked,
            "mode": self.lift.mode,
            "decided_by": self.lift.decided_by,
            "result_lifted": self.lift.result_lifted,
            "field_dtypes": ([str(d) for d in self.lift.field_dtypes]
                             if self.lift.field_dtypes else None),
            "windows": wins,
        }

    def restore(self, snap: dict) -> None:
        self.watermark = snap["watermark"]
        self.num_late_dropped = snap["num_late_dropped"]
        self.vspec = snap["vspec"]
        if isinstance(self.vspec, list):   # JSON round-trip safety
            self.vspec = tuple(self.vspec)
        self._vspec_locked = snap["vspec_locked"]
        self.lift.mode = snap["mode"]
        if self.lift.mode is not None:
            self.lift.decided_by = snap.get("decided_by") or "restore"
        self.lift.result_lifted = snap["result_lifted"]
        if snap["field_dtypes"]:
            self.lift.field_dtypes = [np.dtype(d)
                                      for d in snap["field_dtypes"]]
        self.windows = {}
        for start, w in snap["windows"].items():
            log = _WindowLog()
            if "raw_keys" in w:
                log.key_chunks = list(w["raw_keys"])
                log.col_chunks = list(w["raw_cols"])
                log.count = sum(len(c) for c in log.key_chunks)
            else:
                log.acc_key_chunks = list(w["acc_keys"])
                log.acc_chunks = list(w["accs"])
                log.count = sum(len(c) for c in log.acc_key_chunks)
            self.windows[int(start)] = log

    def restore_many(self, snaps, keep_fn=None) -> None:
        """Union-restore (rescale): accumulate every snapshot's chunks,
        filtering keys by the key-group keep_fn.  Subtasks probe
        independently, so snapshots may disagree on lifted-vs-scalar
        mode or the value spec (one subtask alone may have seen a
        demoting shape change) — a mixed set restores on the common
        denominator: every restored engine demotes to object-row /
        scalar mode before its chunks are adopted."""
        mixed = (len({(s.get("mode"), repr(s.get("vspec")))
                      for s in snaps if s.get("mode") is not None}) > 1)
        for snap in snaps:
            other = type(self)(self.agg, **self._ctor_extra())
            other.restore(snap)
            if mixed and other.lift.mode is not None:
                other._demote_to_object()
                self.vspec = None
                self._vspec_locked = True
                self.lift.mode = "scalar"
                self.lift.decided_by = "restore"
                self.lift.fallback_reason = \
                    "mixed-mode snapshot set restored on the common " \
                    "denominator"
            self.watermark = max(self.watermark, other.watermark)
            self.num_late_dropped += other.num_late_dropped
            if self.lift.mode is None and other.lift.mode is not None:
                self.vspec = other.vspec
                self._vspec_locked = other._vspec_locked
                self.lift.mode = other.lift.mode
                self.lift.decided_by = other.lift.decided_by \
                    or "restore"
                self.lift.result_lifted = other.lift.result_lifted
                self.lift.field_dtypes = other.lift.field_dtypes
            for start, log in other.windows.items():
                mine = self.windows.get(start)
                if mine is None:
                    mine = self.windows[start] = _WindowLog()
                for kc, cc in zip(log.key_chunks, log.col_chunks):
                    keep = keep_fn(kc) if keep_fn is not None else None
                    if keep is None:
                        mine.key_chunks.append(kc)
                        mine.col_chunks.append(cc)
                        mine.count += len(kc)
                    else:
                        mine.key_chunks.append(kc[keep])
                        mine.col_chunks.append(
                            cc[keep] if self.vspec is None
                            else [c[keep] for c in cc])
                        mine.count += int(keep.sum())
                for kc, ac in zip(log.acc_key_chunks, log.acc_chunks):
                    keep = keep_fn(kc) if keep_fn is not None else None
                    if keep is None:
                        mine.acc_key_chunks.append(kc)
                        mine.acc_chunks.append(ac)
                        mine.count += len(kc)
                    else:
                        mine.acc_key_chunks.append(kc[keep])
                        mine.acc_chunks.append(
                            [f[keep] for f in ac]
                            if self.lift.mode == "lifted" else ac[keep])
                        mine.count += int(keep.sum())

    def _ctor_extra(self) -> dict:
        return {"compact_threshold": self.compact_threshold}


class GenericLogTumblingWindows(_GenericLogEngine):
    """keyBy().window(Tumbling).aggregate(<any AggregateFunction>)."""

    def __init__(self, aggregate, window_size_ms: int,
                 compact_threshold: int = 1 << 21):
        super().__init__(aggregate, compact_threshold)
        self.size = window_size_ms
        self.lateness_horizon = window_size_ms

    def _ctor_extra(self) -> dict:
        return {"window_size_ms": self.size,
                "compact_threshold": self.compact_threshold}

    def process_batch(self, keys, timestamps, values=None,
                      key_hashes=None, value_hashes=None) -> None:
        ts = np.asarray(timestamps, np.int64)
        keys = np.asarray(keys)
        if len(keys) == 0:
            return
        starts = ts - np.mod(ts, self.size)
        lo = int(starts.min())
        hi = int(starts.max())
        # fast path: the oldest record in the batch is still live →
        # no late mask, no per-record bool work
        if lo + self.lateness_horizon - 1 <= self.watermark:
            live = starts + self.lateness_horizon - 1 > self.watermark
            self.num_late_dropped += int((~live).sum())
            if not live.any():
                return
            keys, ts, starts = keys[live], ts[live], starts[live]
            if values is not None:
                values = (values[live]
                          if isinstance(values, np.ndarray)
                          else [v for v, ok in zip(values, live) if ok])
            lo = int(starts.min())
            hi = int(starts.max())
        cols, obj = self._prep_values(values, len(keys))
        if lo == hi:
            self._append(lo, keys, cols, obj)
            return
        for start in np.unique(starts):
            m = starts == start
            self._append(int(start), keys[m],
                         None if cols is None else [c[m] for c in cols],
                         None if obj is None else obj[m])

    def advance_watermark(self, watermark: int) -> int:
        self.watermark = watermark
        fired = 0
        for start in sorted(self.windows):
            if start + self.size - 1 > watermark:
                continue
            log = self.windows.pop(start)
            if log.count == 0:
                continue
            ukeys, accs = self._fold_log(log)
            fired += self._emit(ukeys, accs, start, start + self.size)
        return fired


class GenericLogSlidingWindows(_GenericLogEngine):
    """Sliding windows via pane decomposition: ingest into panes of
    the slide, fire merges size/slide folded panes per key (the panes
    optimization the reference applies to aligned sliding windows)."""

    def __init__(self, aggregate, window_size_ms: int, slide_ms: int,
                 compact_threshold: int = 1 << 21):
        if window_size_ms % slide_ms:
            raise ValueError("size must be a multiple of slide")
        super().__init__(aggregate, compact_threshold)
        self.size = window_size_ms
        self.slide = slide_ms
        self.n_panes = window_size_ms // slide_ms
        self.lateness_horizon = window_size_ms
        #: pane start -> folded (ukeys, accs), computed on first use
        self._pane_folds: Dict[int, Tuple[np.ndarray, Any]] = {}
        #: end of the last fired window (panes outlive their windows,
        #: so fired windows must never re-fire on the next advance)
        self._fired_until = -(2 ** 63)

    def _ctor_extra(self) -> dict:
        return {"window_size_ms": self.size, "slide_ms": self.slide,
                "compact_threshold": self.compact_threshold}

    def process_batch(self, keys, timestamps, values=None,
                      key_hashes=None, value_hashes=None) -> None:
        ts = np.asarray(timestamps, np.int64)
        keys = np.asarray(keys)
        if len(keys) == 0:
            return
        pane = ts - np.mod(ts, self.slide)
        lo = int(pane.min())
        hi = int(pane.max())
        if lo + self.lateness_horizon - 1 <= self.watermark:
            live = pane + self.lateness_horizon - 1 > self.watermark
            self.num_late_dropped += int((~live).sum())
            if not live.any():
                return
            keys, ts, pane = keys[live], ts[live], pane[live]
            if values is not None:
                values = (values[live]
                          if isinstance(values, np.ndarray)
                          else [v for v, ok in zip(values, live) if ok])
            lo = int(pane.min())
            hi = int(pane.max())
        cols, obj = self._prep_values(values, len(keys))
        if lo == hi:
            self._pane_folds.pop(lo, None)  # pane grew: refold
            self._append(lo, keys, cols, obj)
            return
        for start in np.unique(pane):
            self._pane_folds.pop(int(start), None)
            m = pane == start
            self._append(int(start), keys[m],
                         None if cols is None else [c[m] for c in cols],
                         None if obj is None else obj[m])

    def _pane_fold(self, start: int):
        cached = self._pane_folds.get(start)
        if cached is not None:
            return cached
        log = self.windows.get(start)
        if log is None or log.count == 0:
            out = (np.zeros(0, np.int64), None)
        else:
            out = self._fold_log(log)
        self._pane_folds[start] = out
        return out

    def advance_watermark(self, watermark: int) -> int:
        self.watermark = watermark
        fired = 0
        if not self.windows and not self._pane_folds:
            return 0
        # candidate window ends come from the panes that EXIST — never
        # walk the raw event-time range one slide at a time (a week's
        # idle gap at a 10 ms slide would be ~60M iterations)
        pane_starts = sorted(set(self.windows) | set(self._pane_folds))
        fireable = ((watermark + 1) // self.slide) * self.slide
        ends: set = set()
        for p in pane_starts:
            e_lo = max(p + self.slide, self._fired_until + self.slide)
            e_hi = min(p + self.size, fireable)
            ends.update(range(e_lo, e_hi + 1, self.slide))
        for e in sorted(ends):
            ps = [p for p in range(e - self.size, e, self.slide)
                  if p in self.windows or p in self._pane_folds]
            if ps:
                folds = [self._pane_fold(p) for p in ps]
                folds = [(k, a) for k, a in folds if len(k)]
                if folds:
                    fired += self._fire_merged(folds, e - self.size, e)
            self._fired_until = e
            # retire panes that no future window can contain
            for p in [p for p in list(self.windows)
                      if p + self.size <= e]:
                self.windows.pop(p, None)
                self._pane_folds.pop(p, None)
            for p in [p for p in self._pane_folds
                      if p + self.size <= e]:
                self._pane_folds.pop(p, None)
        # panes fully behind an empty stretch the loop never visited
        # still retire once every window containing them is fireable
        for p in [p for p in list(self.windows)
                  if p + self.size <= max(self._fired_until, fireable)
                  and p + self.size - 1 <= watermark]:
            self.windows.pop(p, None)
            self._pane_folds.pop(p, None)
        return fired

    def _demote_to_object(self):
        super()._demote_to_object()
        self._pane_folds.clear()  # cached folds hold lifted fields

    def snapshot(self) -> dict:
        snap = super().snapshot()
        snap["fired_until"] = self._fired_until
        return snap

    def restore(self, snap: dict) -> None:
        super().restore(snap)
        self._fired_until = snap.get("fired_until", -(2 ** 63))
        self._pane_folds = {}

    def restore_many(self, snaps, keep_fn=None) -> None:
        super().restore_many(snaps, keep_fn)
        for snap in snaps:
            self._fired_until = max(
                self._fired_until, snap.get("fired_until", -(2 ** 63)))
        self._pane_folds = {}

    def _fire_merged(self, folds, start: int, end: int) -> int:
        if len(folds) == 1:
            ukeys, accs = folds[0]
            return self._emit(ukeys, accs, start, end)
        keys = np.concatenate([k for k, _ in folds])
        if self.lift.mode == "lifted":
            nf = self.lift._n_fields()
            accs = [np.concatenate([a[i] for _, a in folds])
                    for i in range(nf)]
        else:
            accs = np.concatenate([a for _, a in folds])
        ukeys, merged = self.lift.merge_chunks(keys, accs)
        return self._emit(ukeys, merged, start, end)


class GenericLogSessionWindows(_GenericLogEngine):
    """Event-time session windows for arbitrary aggregates: retained
    open-session rows are carried in (key, ts) sorted order (the
    contract that keeps long-gap sessions linear — see session_cm);
    each watermark sorts only the NEW rows and merges two key-major
    streams, then folds closed sessions with the lifted add."""

    def __init__(self, aggregate, gap_ms: int,
                 compact_threshold: int = 1 << 21):
        super().__init__(aggregate, compact_threshold)
        self.gap = gap_ms
        # retained open-session rows, (key, ts)-sorted
        self._r_keys = np.zeros(0, np.int64)
        self._r_ts = np.zeros(0, np.int64)
        self._r_cols: Optional[List[np.ndarray]] = None
        self._r_obj: Optional[np.ndarray] = None
        # new rows since the last advance (unsorted chunks)
        self._n_keys: List[np.ndarray] = []
        self._n_ts: List[np.ndarray] = []
        self._n_cols: List[Any] = []

    def _ctor_extra(self) -> dict:
        return {"compact_threshold": self.compact_threshold}

    def _demote_to_object(self):
        spec = self.vspec
        super()._demote_to_object()

        def to_obj(cc):
            if not isinstance(cc, list):
                return cc
            m = len(cc[0])
            obj = np.empty(m, object)
            if spec == "scalar":
                obj[:] = cc[0].tolist()
            else:
                kind, _ = spec
                mk = tuple if kind == "tuple" else list
                pyc = [col.tolist() for col in cc]
                obj[:] = [mk(col[j] for col in pyc) for j in range(m)]
            return obj

        if self._r_cols is not None:
            self._r_obj = to_obj(self._r_cols)
            self._r_cols = None
        self._n_cols = [to_obj(c) for c in self._n_cols]

    def process_batch(self, keys, timestamps, values=None,
                      key_hashes=None, value_hashes=None) -> None:
        ts = np.asarray(timestamps, np.int64)
        keys = np.asarray(keys)
        if len(keys) == 0:
            return
        live = ts + self.gap - 1 > self.watermark
        if not live.all():
            # merge-before-drop: WindowOperator merges a late record
            # with the existing sessions first and drops it only when
            # the merged window is late.  A record whose own window
            # [ts, ts+gap) is behind the watermark therefore survives
            # when it chains, directly or through other rows within
            # the gap, to a session that is still open.  (The session
            # log tier cannot offer this: it keeps no host-visible
            # open-session rows.)
            live |= self._revive_late(keys, ts, live)
            self.num_late_dropped += int((~live).sum())
            if not live.any():
                return
            if not live.all():
                keys, ts = keys[live], ts[live]
                if values is not None:
                    values = (values[live]
                              if isinstance(values, np.ndarray)
                              else [v for v, ok in zip(values, live)
                                    if ok])
        cols, obj = self._prep_values(values, len(keys))
        self._n_keys.append(keys)
        self._n_ts.append(ts)
        self._n_cols.append(cols if obj is None else obj)

    def _revive_late(self, keys, ts, live) -> np.ndarray:
        """Mask of initially-late rows that still belong to an OPEN
        session.  Anchors are every accepted open row: the retained
        set, pending new rows, and this batch's live rows.  Rows and
        anchors of one key are chained into components with the same
        inclusive-touch rule the fire path uses (Δts <= gap); a late
        row in a component that contains any anchor is revived —
        including rows that only reach an anchor through OTHER late
        rows (the transitive merge the reference performs session by
        session)."""
        out = np.zeros(len(keys), bool)
        late_idx = np.flatnonzero(~live)
        ak = ([self._r_keys] + list(self._n_keys) + [keys[live]])
        at = ([self._r_ts] + list(self._n_ts) + [ts[live]])
        ak = np.concatenate(ak)
        if len(ak) == 0:
            return out
        at = np.concatenate(at)
        allk = np.concatenate([ak, keys[late_idx]])
        allt = np.concatenate([at, ts[late_idx]])
        anchor = np.zeros(len(allk), bool)
        anchor[:len(ak)] = True
        src = np.full(len(allk), -1, np.int64)
        src[len(ak):] = late_idx
        order = np.lexsort((allt, allk))
        k2, t2 = allk[order], allt[order]
        a2, s2 = anchor[order], src[order]
        newc = np.empty(len(k2), bool)
        newc[0] = True
        np.not_equal(k2[1:], k2[:-1], out=newc[1:])
        np.logical_or(newc[1:], t2[1:] - t2[:-1] > self.gap,
                      out=newc[1:])
        comp = np.cumsum(newc) - 1
        has_anchor = np.zeros(int(comp[-1]) + 1, bool)
        np.logical_or.at(has_anchor, comp, a2)
        revived = s2[has_anchor[comp] & (s2 >= 0)]
        out[revived] = True
        return out

    def _merge_sorted_streams(self, keys, ts, payload):
        """Merge (key,ts)-sorted retained rows with the (key,ts)-sorted
        new rows WITHOUT re-sorting the retained set."""
        rk, rt = self._r_keys, self._r_ts
        if len(rk) == 0:
            return keys, ts, payload
        # one lexsort of the two concatenated sorted runs: the
        # retained set is never re-sorted on its own each advance
        mk = np.concatenate([rk, keys])
        mt = np.concatenate([rt, ts])
        order = np.lexsort((mt, mk))
        if self.vspec is None:
            obj = np.concatenate([self._r_obj, payload])
            return mk[order], mt[order], obj[order]
        cols = [np.concatenate([rc, nc])[order]
                for rc, nc in zip(self._r_cols, payload)]
        return mk[order], mt[order], cols

    def advance_watermark(self, watermark: int) -> int:
        self.watermark = watermark
        if self._n_keys:
            nk = np.concatenate(self._n_keys)
            nt = np.concatenate(self._n_ts)
            if self.vspec is None:
                payload = np.concatenate(self._n_cols)
            else:
                k = len(self._n_cols[0])
                payload = [np.concatenate([c[i] for c in self._n_cols])
                           for i in range(k)]
            order = np.lexsort((nt, nk))
            nk, nt = nk[order], nt[order]
            payload = (payload[order] if self.vspec is None
                       else [c[order] for c in payload])
            self._n_keys, self._n_ts, self._n_cols = [], [], []
            keys, ts, payload = self._merge_sorted_streams(nk, nt, payload)
        else:
            keys, ts, payload = self._r_keys, self._r_ts, (
                self._r_obj if self.vspec is None else self._r_cols)
        n = len(keys)
        if n == 0:
            return 0
        # session boundaries: new key OR ts gap STRICTLY over the gap
        # (touching windows merge: TimeWindow.intersects is inclusive)
        new_sess = np.empty(n, bool)
        new_sess[0] = True
        np.not_equal(keys[1:], keys[:-1], out=new_sess[1:])
        np.logical_or(new_sess[1:], ts[1:] - ts[:-1] > self.gap,
                      out=new_sess[1:])
        sess_id = np.cumsum(new_sess) - 1
        starts = np.flatnonzero(new_sess)
        lens = np.diff(np.append(starts, n))
        last_ts = ts[starts + lens - 1]
        closed = last_ts + self.gap - 1 <= watermark
        fired = 0
        if closed.any():
            cs, cl = starts[closed], lens[closed]
            # vectorized ragged-range build (no per-session Python):
            # order = [cs_i, cs_i+1, ..., cs_i+cl_i) for every closed
            # session, via repeat + a running-offset correction
            total = int(cl.sum())
            seg_starts = np.zeros(len(cl), np.int64)
            np.cumsum(cl[:-1], out=seg_starts[1:])
            order = (np.repeat(cs - seg_starts, cl)
                     + np.arange(total, dtype=np.int64)) \
                if total else np.zeros(0, np.int64)
            accs, seg_perm = self.lift.fold_rows(
                order, seg_starts.astype(np.int64), cl, payload,
                self.vspec)
            if seg_perm is not None:
                cs, cl = cs[seg_perm], cl[seg_perm]
            first_ts = ts[cs]
            end_ts = ts[cs + cl - 1] + self.gap
            ukeys = keys[cs]
            if self.emit_arrays:
                res = (self.agg.get_result(self.lift._acc_struct(
                    list(accs)))
                    if self.lift.mode == "lifted"
                    and self.lift.result_lifted
                    else np.asarray(
                        self.lift.results_of(accs, len(cs)),
                        dtype=object))
                self.fired.append((ukeys, res, first_ts, end_ts))
            else:
                results = self.lift.results_of(accs, len(cs))
                pykeys = ukeys.tolist()
                self.emitted.extend(
                    (pykeys[i], results[i], int(first_ts[i]),
                     int(end_ts[i])) for i in range(len(cs)))
            fired += len(cs)
        keep_rows = ~closed[sess_id]
        self._r_keys = keys[keep_rows]
        self._r_ts = ts[keep_rows]
        if self.vspec is None:
            self._r_obj = payload[keep_rows]
            self._r_cols = None
        else:
            self._r_cols = [c[keep_rows] for c in payload]
            self._r_obj = None
        return fired

    # session state rides the retained rows, not window logs
    def snapshot(self) -> dict:
        snap = super().snapshot()
        snap["session"] = {
            "r_keys": self._r_keys, "r_ts": self._r_ts,
            "r_cols": self._r_cols, "r_obj": self._r_obj,
            "n_keys": list(self._n_keys), "n_ts": list(self._n_ts),
            "n_cols": list(self._n_cols),
        }
        return snap

    def restore(self, snap: dict) -> None:
        super().restore(snap)
        s = snap["session"]
        self._r_keys, self._r_ts = s["r_keys"], s["r_ts"]
        self._r_cols, self._r_obj = s["r_cols"], s["r_obj"]
        self._n_keys = list(s["n_keys"])
        self._n_ts = list(s["n_ts"])
        self._n_cols = list(s["n_cols"])

    def restore_many(self, snaps, keep_fn=None) -> None:
        # as in the base class: a mode/spec-mixed snapshot set restores
        # on the common denominator (object rows, scalar folds)
        mixed = (len({(s.get("mode"), repr(s.get("vspec")))
                      for s in snaps if s.get("mode") is not None}) > 1)
        for snap in snaps:
            other = GenericLogSessionWindows(self.agg, self.gap)
            other.restore(snap)
            if mixed and other.lift.mode is not None:
                other._demote_to_object()
                self.vspec = None
                self._vspec_locked = True
                self.lift.mode = "scalar"
                self.lift.decided_by = "restore"
                self.lift.fallback_reason = \
                    "mixed-mode snapshot set restored on the common " \
                    "denominator"
            self.watermark = max(self.watermark, other.watermark)
            self.num_late_dropped += other.num_late_dropped
            if self.lift.mode is None and other.lift.mode is not None:
                self.vspec = other.vspec
                self._vspec_locked = other._vspec_locked
                self.lift.mode = other.lift.mode
                self.lift.decided_by = other.lift.decided_by \
                    or "restore"
                self.lift.result_lifted = other.lift.result_lifted
                self.lift.field_dtypes = other.lift.field_dtypes
            keep = (keep_fn(other._r_keys) if keep_fn is not None
                    else np.ones(len(other._r_keys), bool))
            # re-queue as new rows; the next advance merge-sorts them
            if keep.any():
                self._n_keys.append(other._r_keys[keep])
                self._n_ts.append(other._r_ts[keep])
                self._n_cols.append(
                    other._r_obj[keep] if other._r_obj is not None
                    else [c[keep] for c in other._r_cols])
            for nk, nt, nc in zip(other._n_keys, other._n_ts,
                                  other._n_cols):
                k2 = keep_fn(nk) if keep_fn is not None else None
                if k2 is None:
                    self._n_keys.append(nk)
                    self._n_ts.append(nt)
                    self._n_cols.append(nc)
                elif k2.any():
                    self._n_keys.append(nk[k2])
                    self._n_ts.append(nt[k2])
                    self._n_cols.append(
                        nc[k2] if not isinstance(nc, list)
                        else [c[k2] for c in nc])


def is_generic_eligible(assigner, aggregate_function, trigger, evictor,
                        allowed_lateness, late_tag,
                        window_function) -> bool:
    """Graph-builder gate for the generic vectorized tier: the window
    shapes of the device gate (``batch_window_eligible``) for any Python
    AggregateFunction; the graph builder asks the device gate first."""
    return batch_window_eligible(assigner, trigger, evictor,
                                 allowed_lateness, late_tag, window_function)


class GenericWindowOperator(StreamOperator):
    """Batched window operator for ARBITRARY Python AggregateFunctions
    — the DataStream-facing face of the generic log engines.  Buffers
    records, flushes them as columns into the engine, fires on
    watermarks; same lifecycle contract as DeviceWindowOperator
    (which serves DeviceAggregateFunction; this serves the rest)."""

    def __init__(self, assigner, aggregate_function,
                 window_function=None, flush_batch: int = 8192,
                 compact_threshold: int = 1 << 21,
                 force_scalar: bool = False):
        super().__init__()
        self.assigner = assigner
        self.agg = aggregate_function
        self.window_function = window_function
        self.flush_batch = flush_batch
        self.compact_threshold = compact_threshold
        #: pin the engine's per-record scalar fold even when the
        #: lift probe would accept the aggregate (see
        #: AggregateFunction.force_scalar for when that matters)
        self.force_scalar = force_scalar
        self.engine = None
        #: AOT liftability report (computed lazily, sentinel = unset)
        self._lift_report = False
        self._keys: List[Any] = []
        self._ts: List[int] = []
        self._values: List[Any] = []
        self._last_fireable = None
        self.num_late_records_dropped = 0

    # ---- lifecycle --------------------------------------------------
    def open(self):
        if generic_engine_for_assigner(self.assigner, self.agg) is None:
            raise ValueError(
                f"no generic engine for assigner {self.assigner!r}")
        self.collector = TimestampedCollector(self.output)
        if self.metrics is not None:
            self.metrics.counter("numLateRecordsDropped").count = 0
            g = self.metrics.add_group("lift")
            g.gauge("decision", lambda: (
                (self.engine.lift.mode if self.engine is not None
                 else None) or "undecided"))
            g.gauge("decided_by", lambda: (
                (self.engine.lift.decided_by if self.engine is not None
                 else None) or "undecided"))
            g.gauge("fallback_reason", lambda: (
                (self.engine.lift.fallback_reason
                 if self.engine is not None else None) or ""))

    def _static_verdict(self):
        """AOT liftability analysis of the aggregate (pass 2), cached;
        None when opted out (force_probe) or the analyzer errored."""
        if self._lift_report is False:
            self._lift_report = None
            if not self.force_scalar \
                    and not getattr(self.agg, "force_probe", False):
                try:
                    from flink_tpu_torch.analysis.liftability import \
                        analyze_aggregate
                    self._lift_report = analyze_aggregate(self.agg)
                except Exception:
                    self._lift_report = None
        return self._lift_report

    def set_key_context(self, record):
        pass  # keys resolve vectorized at flush

    def process_element(self, record):
        if record.timestamp is None:
            raise ValueError(
                "generic window operator requires event-time records "
                "(assign timestamps upstream)")
        self._keys.append(self.key_selector.get_key(record.value)
                          if self.key_selector is not None
                          else record.value)
        self._ts.append(record.timestamp)
        self._values.append(record.value)
        if len(self._keys) >= self.flush_batch:
            self._flush_buffer()

    def process_batch(self, batch):
        """Columnar ingest: a RecordBatch feeds the engine as ready
        columns — no StreamRecord boxing, no per-row buffer appends.
        Buffered scalar rows flush first (they predate the batch, and
        the engine must see rows in arrival order)."""
        n = len(batch)
        if n == 0:
            return
        if batch.ts is None or (batch.ts_mask is not None
                                and not batch.ts_mask.all()):
            # same contract as the scalar path: every row needs an
            # event timestamp
            raise ValueError(
                "generic window operator requires event-time records "
                "(assign timestamps upstream)")
        self._flush_buffer()
        self._ensure_engine()
        values = batch.row_values()
        keys_arr = self._batch_keys(batch, values)
        self.engine.process_batch(
            keys_arr, np.asarray(batch.ts, np.int64), values)
        self._note_columnar(n)

    def _batch_keys(self, batch, values):
        """Key column for a batch: a ready column when the selector is
        positional (or absent on scalar rows), else per-row get_key —
        always the exact keys the scalar path would have buffered."""
        sel = self.key_selector
        if sel is None and batch.is_scalar:
            return np.asarray(next(iter(batch.cols.values())))
        if isinstance(sel, _FieldKeySelector) \
                and type(sel._field) is int and not batch.is_scalar:
            col = batch.cols.get(f"f{sel._field}")
            if col is not None:
                return np.asarray(col)
        keys = ([sel.get_key(v) for v in values] if sel is not None
                else values)
        keys_arr = np.asarray(keys)
        if keys_arr.ndim != 1:
            karr = np.empty(len(keys), object)
            karr[:] = keys
            keys_arr = karr
        return keys_arr

    def _ensure_engine(self):
        if self.engine is None:
            self.engine = generic_engine_for_assigner(
                self.assigner, self.agg, self.compact_threshold)
            self.engine.lift.owner = self.operator_id or ""
            if self.force_scalar:
                self.engine.lift.mode = "scalar"
                self.engine.lift.decided_by = "pin"
                self.engine.lift.fallback_reason = "force_scalar"
            else:
                self.engine.lift.apply_static(self._static_verdict())

    def _flush_buffer(self):
        if not self._keys:
            return
        self._ensure_engine()
        keys_arr = np.asarray(self._keys)
        if keys_arr.ndim != 1:
            # composite keys stay object rows (sortable tuples)
            karr = np.empty(len(self._keys), object)
            karr[:] = self._keys
            keys_arr = karr
        self.engine.process_batch(
            keys_arr, np.asarray(self._ts, np.int64), self._values)
        self._keys.clear()
        self._ts.clear()
        self._values.clear()

    def process_watermark(self, watermark):
        wm = watermark.timestamp
        grid = None
        if isinstance(self.assigner, SlidingEventTimeWindows):
            grid = self.assigner.slide
        elif isinstance(self.assigner, TumblingEventTimeWindows):
            grid = self.assigner.size
        if grid is not None and wm != MAX_TIMESTAMP:
            fireable = ((wm + 1) // grid) * grid if wm >= 0 else None
            if fireable is not None and fireable == self._last_fireable:
                self.current_watermark = wm
                self.output.emit_watermark(watermark)
                return
            self._last_fireable = fireable
        self._flush_buffer()
        if self.engine is not None:
            before = len(self.engine.emitted)
            self.engine.advance_watermark(wm)
            self._emit_from(before)
            self.num_late_records_dropped = self.engine.num_late_dropped
            if self.metrics is not None:
                self.metrics.counter("numLateRecordsDropped").count = \
                    self.engine.num_late_dropped
        self.current_watermark = wm
        self.output.emit_watermark(watermark)

    def _emit_from(self, start_idx: int):
        emitted = self.engine.emitted
        fn = self.window_function
        for key, result, w_start, w_end in emitted[start_idx:]:
            self.collector.set_absolute_timestamp(w_end - 1)
            if fn is None:
                self.collector.collect(result)
            else:
                out = fn(key, TimeWindow(w_start, w_end), [result])
                if out is not None:
                    for v in out:
                        self.collector.collect(v)
        del emitted[start_idx:]

    # ---- checkpoint -------------------------------------------------
    def snapshot_state(self, checkpoint_id: Optional[int] = None) -> dict:
        self._flush_buffer()
        snap = StreamOperator.snapshot_state(self, checkpoint_id)
        if self.engine is not None:
            snap["generic_engine"] = self.engine.snapshot()
        return snap

    def restore_state(self, snapshots) -> None:
        StreamOperator.restore_state(self, snapshots)
        engine_snaps = [s["generic_engine"] for s in snapshots
                        if s.get("generic_engine") is not None]
        if not engine_snaps:
            return
        self._ensure_engine()
        rescaled = any(
            s.get("restore_old_parallelism", self.num_subtasks)
            != self.num_subtasks for s in snapshots)
        if rescaled or len(engine_snaps) > 1 or self.num_subtasks > 1:
            keep_fn = make_key_group_keep_fn(
                self.max_parallelism, self.num_subtasks,
                self.subtask_index)
            self.engine.restore_many(engine_snaps, keep_fn)
        else:
            self.engine.restore(engine_snaps[0])
        if self.force_scalar:
            # the pin outranks a checkpoint taken without it
            self.engine.lift.mode = "scalar"
            self.engine.lift.decided_by = "pin"
            self.engine.lift.fallback_reason = "force_scalar"


def generic_engine_for_assigner(assigner, aggregate,
                                compact_threshold: int = 1 << 21):
    """Assigner → generic log engine, or None when the assigner shape
    has no generic tier (custom assigners stay on the scalar path)."""
    if isinstance(assigner, TumblingEventTimeWindows) \
            and assigner.offset == 0:
        return GenericLogTumblingWindows(
            aggregate, assigner.size, compact_threshold)
    if isinstance(assigner, SlidingEventTimeWindows) \
            and assigner.offset == 0 \
            and assigner.size % assigner.slide == 0:
        return GenericLogSlidingWindows(
            aggregate, assigner.size, assigner.slide, compact_threshold)
    if isinstance(assigner, EventTimeSessionWindows):
        return GenericLogSessionWindows(
            aggregate, assigner.gap, compact_threshold)
    return None
