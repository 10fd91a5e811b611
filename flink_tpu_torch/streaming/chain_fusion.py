"""Chain fusion: one program on the card for the fusable run of an
operator chain (port of ``flink_tpu/streaming/chain_fusion.py:69-710``).

A chain of column kernels pays one dispatch and one host column set per
operator per batch.  This module runs the maximal fusable run of a
chain (map arithmetic, filter masks, the splitmix64 keyBy hash and
channel, the stable partition and compaction, and the pane start of a
tumbling or sliding window) as one program: the columns move to the
card once, the map/filter UDFs run on CUDA tensors (user code, as the
reference traces it into its XLA program), the ``chain_route`` kernel
partitions the rows and moves their columns, and the results come back
once.

Position in the pipeline: ``try_fuse_subtask`` runs at the end of
``SubtaskInstance.open()``, when the router's routes (so the channel
count) are fixed.  It anchors a :class:`FusedChainProgram` on the first
operator of the run; the chain head's batch dispatch and
``_ChainedOutput.collect_batch`` hand a batch to the program when it
``wants`` it.

What fuses: ``StreamMap`` / ``StreamFilter`` whose UDF the liftability
analyzer proves LIFTABLE (or that the type-flow prover stamped
``_static_kernel``: the analysis is not run again) and that have not
locked onto the boxed path;
when the run ends the chain and its one data route is a
``KeyGroupStreamPartitioner`` on a positional field to more than one
channel, the key-group exchange too (route mode); a tumbling or sliding
``WindowOperator`` right after the run, which takes the pane starts
through ``process_batch_fused`` (window mode).  Otherwise plain mode:
the run's compaction.

Safety: compute, verify, then emit.  The first batch of each dtype
signature is compared exactly (NaN-aware) with ``_numpy_twin``, the
per-operator computation in numpy, before anything is emitted; a
mismatch, a UDF stage that raises or does not run on tensors, or a
column dtype torch cannot hold demotes the whole chain with a recorded
reason and replays the batch through the per-operator path, which never
changed.  The kernel is not a reason to demote: the kernel's channel
limit is checked when the chain compiles (a route to more channels
keeps the per-operator exchange), and an error of the kernel or of a
copy to or from the card is raised to the caller.

The UDF stages run with torch's default dtype set to float64 (restored
after), and constants a map returns broadcast with numpy's dtype for
them, so ``int / int`` and ``int32 * 1.5`` give numpy's float64 and
more UDFs fuse; a dtype torch lacks an operation for (``%`` on
uint16/uint32) still demotes.

Mesh leg (``chain_fusion.py:832-849``): with two or more devices in
``parallel.mesh.devices()`` (the cards, or virtual shards) and a bucket
(the batch's rows rounded up to a power of two, as the reference pads)
of at least ``mesh_shards * MESH_MIN_ROWS_PER_SHARD`` rows, the program
runs sharded over the rows axis: shard s holds rows ``[s * m, (s + 1)
* m)`` (m = bucket / shards), and one ``chain_route`` launch with the
composite class ``shard * nclass + class`` partitions every shard's
block on its own.  The host gathers the shards' kept rows in shard
order (channel-major for a route), which is the single-device program's
global stable order, bit for bit.  A route whose ``shards * (channels +
1)`` classes exceed the kernel's limit takes the single-device program.

Telemetry: while ``TELEMETRY`` is on, a run is one dispatch of the
program's label (``chain.<head>→<tail>``, the reference's ``traced_jit``
label) and the ledger's ``chain.boundary`` tag holds its copies: one
h2d of the columns, and one d2h of the results, the stage row counts,
the pane starts and ``chain_route``'s class starts, so its bytes are
every device-to-host byte of the run.  The reference pads to the
bucket, so its bytes differ.

Not ported: ``attach`` mode (the reference's ``_execute`` never
produces it).  ``fusion_report`` feeds the linter's FT184
(``analysis/columnar_eligibility.py``).
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from flink_tpu_torch.device import DeviceLike, resolve_device
from flink_tpu_torch.kernels.chain_route import MAX_CLASSES
from flink_tpu_torch.parallel import mesh as _mesh
from flink_tpu_torch.runtime.device_stats import TELEMETRY
from flink_tpu_torch.runtime.tracing import traced_call

log = logging.getLogger(__name__)

#: master switch
FUSION_ENABLED = True

#: batches below this row count take the per-operator path: a program
#: dispatch costs more than a few small numpy passes
MIN_FUSED_ROWS = 512

#: per-shard row floor before the mesh leg runs instead of one block
MESH_MIN_ROWS_PER_SHARD = 2048


class _FusionStats:
    """Process-wide counters of the fused-chain path."""

    def __init__(self) -> None:
        self.programs = 0        # anchored FusedChainPrograms
        self.fused_batches = 0
        self.fused_rows = 0
        self.probes = 0          # numpy-twin verifications run
        self.demotions = 0
        self.small_batches = 0   # wanted but under MIN_FUSED_ROWS
        self.last_demotion: Optional[Tuple[str, str]] = None

    def reset(self) -> None:
        self.__init__()


FUSION_STATS = _FusionStats()


class _Demoted(Exception):
    """Raised inside _execute after demote() ran."""


def _stage_err(msg: str) -> Exception:
    return TypeError(f"chain fusion: {msg}")


def _gather_shards(host, pane, starts, shards: int, nclass: int):
    """A row-sharded result in the single-device layout: each shard's
    kept rows gathered in shard order (class-major, shard-minor for a
    route: shards are position ranges, so that is the global stable
    order), and ``starts`` of the classes over all shards."""
    st = np.asarray(starts, np.int64).reshape(shards, nclass)
    sel = np.concatenate([np.arange(st[i, c], st[i, c + 1])
                          for c in range(nclass - 1) for i in range(shards)])
    per_class = (st[:, 1:] - st[:, :-1]).sum(axis=0)
    glob = np.concatenate(([0], np.cumsum(per_class)))
    return ([a[sel] for a in host], None if pane is None else pane[sel],
            glob)


# ---------------------------------------------------------------------
# eligibility (no device work)
# ---------------------------------------------------------------------

def _kernel_stage(op) -> Optional[Tuple[str, Callable]]:
    """(kind, fn) when ``op`` is a fusable map/filter stage, else None."""
    from flink_tpu_torch.streaming.operators import (StreamFilter, StreamMap,
                                                     _kernel_fn, _udf_liftable)
    if isinstance(op, StreamMap):
        kind = "map"
    elif isinstance(op, StreamFilter):
        kind = "filter"
    else:
        return None
    if op._batch_kernel is False:
        return None
    if not op._static_kernel:
        ok, _reason = _udf_liftable(op.user_function, op._KERNEL_ATTR)
        if not ok:
            return None
    return kind, _kernel_fn(op.user_function, op._KERNEL_ATTR)


def _window_stage_reason(op) -> Optional[str]:
    """None when ``op`` takes a fused pane column, else why not."""
    from flink_tpu_torch.streaming.window_operator import WindowOperator
    if not isinstance(op, WindowOperator):
        return "not a window operator"
    return op._batch_eligibility()


def _blocker_reason(op) -> str:
    """Why ``op`` blocks fusion (for reports)."""
    from flink_tpu_torch.streaming.operators import (StreamFilter, StreamMap,
                                                     _udf_liftable)
    if isinstance(op, (StreamMap, StreamFilter)):
        if op._batch_kernel is False:
            return (op.columnar_fallback_reason
                    or "operator locked onto the boxed path")
        if not op._static_kernel:
            ok, reason = _udf_liftable(op.user_function, op._KERNEL_ATTR)
            if not ok:
                return reason
        return "fusable"
    wreason = _window_stage_reason(op)
    if wreason != "not a window operator":
        return wreason or "fusable"
    return f"{type(op).__name__} has no columnar kernel"


def select_run(operators) -> Tuple[int, int, Optional[int]]:
    """The maximal fusable run of a chain: ``(start, n_kernel,
    window_index)``, covering ``operators[start:start + n_kernel]`` and,
    when ``window_index`` is not None, the window operator right after.
    ``n_kernel == 0``: nothing fuses."""
    n = len(operators)
    start = 0
    while start < n and _kernel_stage(operators[start]) is None:
        start += 1
    k = 0
    while start + k < n and _kernel_stage(operators[start + k]) is not None:
        k += 1
    if k == 0:
        return 0, 0, None
    widx = None
    nxt = start + k
    if nxt < n and _window_stage_reason(operators[nxt]) is None:
        widx = nxt
    return start, k, widx


def fusion_report(operators) -> dict:
    """What would fuse in one chain, and the first operator that stops
    the run, with its reason."""
    start, k, widx = select_run(operators)
    names = [getattr(op, "operator_id", "") or type(op).__name__
             for op in operators]
    if k == 0:
        blocker = None
        reason = None
        for i, op in enumerate(operators):
            if _kernel_stage(op) is None and _window_stage_reason(op) is not None:
                blocker = names[i]
                reason = _blocker_reason(op)
                break
        return {"fusable": False, "fused_ops": [],
                "first_blocker": blocker, "blocker_reason": reason}
    end = (widx + 1) if widx is not None else (start + k)
    blocker = None
    reason = None
    if end < len(operators):
        blocker = names[end]
        reason = _blocker_reason(operators[end])
    elif start > 0:
        # a non-fusable prefix (usually the source) keeps the run from
        # covering the whole chain: name its last operator
        blocker = names[start - 1]
        reason = _blocker_reason(operators[start - 1])
    return {"fusable": True, "fused_ops": names[start:end],
            "first_blocker": blocker, "blocker_reason": reason}


# ---------------------------------------------------------------------
# compile
# ---------------------------------------------------------------------

def try_fuse_subtask(subtask) -> None:
    """Compile and anchor a fused program for one SubtaskInstance (at
    the end of its ``open()``).  Never raises: a failure leaves the
    per-operator path as it was."""
    if not FUSION_ENABLED:
        return
    try:
        ops = getattr(subtask, "operators", None)
        if not ops:
            return
        for op in ops:
            if op.__dict__.get("_fused_chain") is not None:
                return
        program = compile_chain(ops, router=getattr(subtask, "router", None),
                                device=getattr(subtask, "device", None))
        if program is not None:
            program.anchor._fused_chain = program
            FUSION_STATS.programs += 1
    except Exception as e:  # noqa: BLE001
        log.warning("chain fusion disabled for subtask: %r", e)


def compile_chain(operators, router=None,
                  device: DeviceLike = None) -> Optional["FusedChainProgram"]:
    """The :class:`FusedChainProgram` of the maximal fusable run of
    ``operators`` on ``device`` (the card unless "cpu"), or None when
    nothing fuses or a single stage has no routing or window leg."""
    start, k, widx = select_run(operators)
    if k == 0:
        return None
    stages = [_kernel_stage(op) for op in operators[start:start + k]]
    window_op = operators[widx] if widx is not None else None
    kernel_ops = list(operators[start:start + k])
    tail_op = operators[widx] if widx is not None else operators[start + k - 1]

    # routing leg: the run ends the chain and the one data route is a
    # key-group exchange over a positional field of the post-map rows
    route_field = route_channels = route_part = None
    if window_op is None and start + k == len(operators) and router is not None:
        from flink_tpu_torch.core.functions import _FieldKeySelector
        from flink_tpu_torch.streaming.partitioners import (
            KeyGroupStreamPartitioner)
        data_routes = [r for r in getattr(router, "routes", []) if r[2] is None]
        if len(data_routes) == 1:
            part, channels, _tag = data_routes[0]
            sel = getattr(part, "key_selector", None)
            if (isinstance(part, KeyGroupStreamPartitioner)
                    and 1 < len(channels) < MAX_CLASSES
                    and isinstance(sel, _FieldKeySelector)
                    and type(sel._field) is int):
                route_field = sel._field
                route_channels = channels
                route_part = part
    if k == 1 and window_op is None and route_field is None:
        # one stage and nothing else: the per-operator kernel is already
        # one vectorized pass
        return None
    return FusedChainProgram(
        operators=operators, start=start, kernel_ops=kernel_ops,
        stages=stages, window_op=window_op, router=router,
        route_field=route_field, route_channels=route_channels,
        route_part=route_part, tail_op=tail_op,
        device=resolve_device(device))


# ---------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------

def _run_program(prog: "FusedChainProgram", batch, tel):
    """The program's traced body: a function of the module, so the
    wrapper a program keeps holds no reference back to it."""
    return prog._execute_inner(batch, tel)


class FusedChainProgram:
    """One fused chain run: the UDF stages and ``chain_route`` on the
    card, the numpy-twin verification, and the host emission.  Anchored
    on the run's first operator; the task layer calls :meth:`wants` and
    :meth:`run`."""

    def __init__(self, operators, start, kernel_ops, stages, window_op,
                 router, route_field, route_channels, route_part, tail_op,
                 device):
        self.operators = operators
        self.start = start
        self.anchor = operators[start]
        self.kernel_ops = kernel_ops
        self.stages = stages
        self.window_op = window_op
        self.router = router
        self.route_field = route_field
        self.route_channels = route_channels
        self.route_part = route_part
        self.device = device
        self.renames = any(kind == "map" for kind, _ in stages)
        self.members = list(kernel_ops) + ([window_op] if window_op else [])
        head_id = getattr(self.anchor, "operator_id", "") \
            or type(self.anchor).__name__
        tail_id = getattr(tail_op, "operator_id", "") or type(tail_op).__name__
        self.label = f"chain.{head_id}→{tail_id}"
        # the reference's traced_jit label for the fused program
        self._traced = traced_call(_run_program, self.label)
        self.active = True
        self.demoted_reason: Optional[str] = None
        self._verified_sigs: set = set()
        for op in self.members:
            op._fused_member = self
        if self.window_op is not None:
            wassigner = self.window_op.assigner
            self._w_size = int(wassigner.size)
            self._w_slide = int(getattr(wassigner, "slide", wassigner.size))
            self._w_offset = int(wassigner.offset)
        if self.route_part is not None:
            self._r_maxpar = int(self.route_part.max_parallelism)
            self._r_nch = len(self.route_channels)
        # the mesh leg: the largest power-of-two prefix of the devices
        devs = _mesh.devices()
        self.mesh_shards = (1 << (len(devs).bit_length() - 1)
                            if len(devs) >= 2 else 1)

    # ---- dispatch predicate -----------------------------------------
    def wants(self, batch) -> bool:
        if not self.active:
            return False
        if len(batch) < MIN_FUSED_ROWS:
            FUSION_STATS.small_batches += 1
            return False
        if batch.routing is not None:
            return False  # routed upstream already
        if self.window_op is not None:
            # the pane column needs every row stamped; the per-operator
            # path takes a partly stamped batch
            if batch.ts is None:
                return False
            m = batch.ts_mask
            if m is not None and not m.all():
                return False
        return True

    # ---- demotion ----------------------------------------------------
    def demote(self, reason: str) -> None:
        if not self.active:
            return
        self.active = False
        self.demoted_reason = reason
        FUSION_STATS.demotions += 1
        FUSION_STATS.last_demotion = (self.label, reason)
        for op in self.members:
            if op.columnar_decided_by == "fused":
                op.columnar_decided_by = None
            op._fused_member = None
        log.warning("fused chain %s demoted to per-operator dispatch: %s",
                    self.label, reason)

    # ---- run ---------------------------------------------------------
    def run(self, batch) -> None:
        """Run the program on ``batch``.  When the UDF stages or the
        verification fail, the chain demotes and the batch replays
        through the per-operator path (nothing was emitted yet).  An
        error of the kernel or of a copy to or from the card is raised:
        the batch is on the card by then, and no host path stands in
        for the kernel."""
        try:
            emit = self._execute(batch)
        except _Demoted:
            self.anchor.process_batch(batch)
            return
        emit()

    # ---- internals ---------------------------------------------------
    def _execute(self, batch):
        tel = TELEMETRY
        if not tel.enabled:
            return self._execute_inner(batch, None)
        return self._traced(self, batch, tel)

    def _execute_inner(self, batch, tel):
        """The program on ``batch``; ``tel`` (the telemetry, when on)
        ledgers the region's boundary copies under ``chain.boundary``:
        one h2d of the columns, one d2h of the results with the class
        starts that ``chain_route`` reads back."""
        from flink_tpu_torch.kernels.chain_route import chain_route

        n = len(batch)
        col_arrays = tuple(batch.cols.values())
        host_cols = []
        for name, a in batch.cols.items():
            try:
                if a.dtype.kind not in "biuf":
                    raise TypeError(a.dtype)
                host_cols.append(torch.as_tensor(np.ascontiguousarray(a)))
            except TypeError:
                self.demote(f"column {name!r} dtype {a.dtype} is not "
                            "device-representable")
                raise _Demoted from None
        scalar = batch.is_scalar
        ts, tsm = batch.ts, batch.ts_mask
        use_window = self.window_op is not None and ts is not None
        mode = ("window" if use_window
                else ("route" if self.route_field is not None else "plain"))
        dev = self.device

        def to_dev(a):
            return None if a is None else \
                torch.as_tensor(np.ascontiguousarray(a)).to(dev)

        nclass = self._r_nch + 1 if mode == "route" else 2
        bucket = max(MIN_FUSED_ROWS, 1 << (n - 1).bit_length())
        shards = self.mesh_shards
        use_mesh = (shards > 1
                    and bucket >= shards * MESH_MIN_ROWS_PER_SHARD
                    and shards * nclass <= MAX_CLASSES)
        if tel is not None:
            t0 = time.perf_counter_ns()
        d_cols = tuple(c.to(dev) for c in host_cols)
        d_ts, d_tsm = to_dev(ts), to_dev(tsm)
        if tel is not None:
            tel.record_transfer(
                "h2d", sum(c.nbytes for c in host_cols)
                + sum(a.nbytes for a in (ts, tsm) if a is not None),
                t0, time.perf_counter_ns(), "chain.boundary")
        try:
            out_cols, keep, stage_rows, tuple_out = self._stages(
                d_cols, scalar, n)
            key = self._route_key(out_cols, tuple_out) \
                if mode == "route" else None
        except Exception as e:  # noqa: BLE001
            self.demote(f"device stage failed: {e!r}")
            raise _Demoted from e
        moved = [c.contiguous() for c in out_cols] + \
            [a for a in (d_ts, d_tsm) if a is not None]
        outs, pane, starts = chain_route(
            moved, keep, key,
            num_channels=self._r_nch if mode == "route" else 0,
            max_parallelism=self._r_maxpar if mode == "route" else 0,
            ts=d_ts if mode == "window" else None,
            pane_offset=self._w_offset if mode == "window" else 0,
            slide=self._w_slide if mode == "window" else 0,
            shard_rows=bucket // shards if use_mesh else 0,
            n_shards=shards if use_mesh else 0)
        if tel is not None:
            t2 = time.perf_counter_ns()
        host = [o.cpu().numpy() for o in outs]
        pane = pane.cpu().numpy() if pane is not None else None
        stage_rows = stage_rows.cpu().numpy()
        if tel is not None:
            # the class starts came back inside chain_route; their bytes
            # count here, their copy time in the launch's
            tel.record_transfer(
                "d2h", sum(h.nbytes for h in host) + stage_rows.nbytes
                + (pane.nbytes if pane is not None else 0)
                + np.asarray(starts).nbytes,
                t2, time.perf_counter_ns(), "chain.boundary")
        if use_mesh:
            host, pane, starts = _gather_shards(host, pane, starts, shards,
                                                nclass)
        count = int(starts[-1])
        n_out = len(out_cols)
        out_np = tuple(host[:n_out])
        rest = host[n_out:]
        out_ts = rest.pop(0) if ts is not None else None
        out_tsm = rest.pop(0) if tsm is not None else None
        bounds = starts if mode == "route" else None

        sig = (mode, scalar, use_mesh, tuple(a.dtype.str for a in col_arrays),
               ts is None, tsm is None)
        if sig not in self._verified_sigs:
            self._verify(batch, n, mode, out_np, out_ts, out_tsm, count,
                         bounds, pane)
            self._verified_sigs.add(sig)
        return self._make_emit(batch, n, mode, tuple_out, out_np, out_ts,
                               out_tsm, stage_rows, count, bounds, pane)

    def _route_key(self, out_cols, tuple_out):
        """The routing leg's key column of the stages' output."""
        if not tuple_out or self.route_field >= len(out_cols):
            raise _stage_err("routing leg needs tuple rows with the key field")
        key = out_cols[self.route_field]
        if key.dtype != torch.int64:
            raise _stage_err(f"key column dtype {key.dtype} is not int64 "
                             "(routing parity needs the int fast path)")
        return key

    def _stages(self, cols, scalar, n):
        """The UDF stages on device tensors: (output columns, keep mask,
        rows entering each stage, tuple rows?).  torch's default dtype is
        float64 while they run, so true division and float scalars
        promote as in numpy (the default is process-wide: the executor
        runs every subtask on one thread)."""
        dev = self.device
        vals = cols[0] if scalar else cols
        keep = torch.ones(n, dtype=torch.bool, device=dev)
        stage_rows = []
        saved = torch.get_default_dtype()
        torch.set_default_dtype(torch.float64)
        try:
            for kind, fn in self.stages:
                stage_rows.append(keep.sum())
                out = fn(vals)
                if kind == "map":
                    vals = self._norm_map(out, n)
                else:
                    if not (isinstance(out, torch.Tensor)
                            and out.dtype == torch.bool
                            and tuple(out.shape) == (n,)
                            and out.device == dev):
                        raise _stage_err("filter kernel did not produce a "
                                         "bool mask on the device")
                    keep = keep & out
        finally:
            torch.set_default_dtype(saved)
        tuple_out = type(vals) is tuple
        out_cols = vals if tuple_out else (vals,)
        return out_cols, keep, torch.stack(stage_rows), tuple_out

    def _norm_map(self, out, n):
        dev = self.device

        def column(item):
            if isinstance(item, torch.Tensor):
                if tuple(item.shape) != (n,) or item.device != dev:
                    raise _stage_err("kernel output is not a column on the "
                                     "device")
                return item
            if isinstance(item, (bool, int, float, np.generic)):
                # numpy's dtype for the constant, as np.full gives it
                return torch.full((n,), item, device=dev, dtype=getattr(
                    torch, np.asarray(item).dtype.name))
            raise _stage_err(f"map output field of type "
                             f"{type(item).__name__} is not a device column")

        if type(out) is tuple:
            if not out:
                raise _stage_err("map kernel returned an empty tuple")
            return tuple(column(item) for item in out)
        if isinstance(out, torch.Tensor):
            return column(out)
        raise _stage_err("kernel output is not a column on the device")

    # .................................................................
    def _numpy_twin(self, batch, n, mode):
        """The per-operator computation in numpy on the batch: (cols, ts,
        tsm, count, bounds, pane) in emission order, or None when it is
        not columnar."""
        from flink_tpu_torch.core.keygroups import (assign_operator_indexes_np,
                                                    splitmix64_np)
        from flink_tpu_torch.streaming.operators import _normalize_kernel_output
        vals = batch.value_arrays()
        keep = np.ones(n, bool)
        for kind, fn in self.stages:
            out = fn(vals)
            if kind == "map":
                arrays = _normalize_kernel_output(out, n)
                if arrays is None:
                    return None
                vals = arrays
            else:
                if not (isinstance(out, np.ndarray) and out.shape == (n,)
                        and out.dtype == np.bool_):
                    return None
                keep = keep & out
        cols = vals if type(vals) is tuple else (vals,)
        eff = None
        bounds = None
        if mode == "route":
            if type(vals) is not tuple or self.route_field >= len(cols):
                return None
            key = cols[self.route_field]
            if key.dtype != np.int64:
                return None
            idx = assign_operator_indexes_np(splitmix64_np(key),
                                             self._r_maxpar, self._r_nch)
            eff = np.where(keep, idx, self._r_nch)
        if eff is None:
            eff = np.where(keep, 0, 1)
        order = np.argsort(eff, kind="stable")
        cnt = int(keep.sum())
        kord = order[:cnt]
        if mode == "route":
            bounds = np.searchsorted(eff[order], np.arange(self._r_nch + 1))
        ref_cols = tuple(a[kord] for a in cols)
        ref_ts = batch.ts[kord] if batch.ts is not None else None
        ref_tsm = batch.ts_mask[kord] if batch.ts_mask is not None else None
        ref_pane = None
        if mode == "window" and ref_ts is not None:
            t = ref_ts.astype(np.int64)
            ref_pane = t - ((t - self._w_offset) % self._w_slide)
        return ref_cols, ref_ts, ref_tsm, cnt, bounds, ref_pane

    @staticmethod
    def _arr_eq(a, b) -> bool:
        if a is None or b is None:
            return a is None and b is None
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype != b.dtype or a.shape != b.shape:
            return False
        if a.dtype.kind == "f":
            return bool(np.array_equal(a, b, equal_nan=True))
        return bool(np.array_equal(a, b))

    def _verify(self, batch, n, mode, out_cols, out_ts, out_tsm, count,
                bounds, pane) -> None:
        """First batch of a dtype signature: exact comparison with the
        numpy twin before anything is emitted; a mismatch demotes."""
        FUSION_STATS.probes += 1
        try:
            ref = self._numpy_twin(batch, n, mode)
        except Exception as e:  # noqa: BLE001
            self.demote(f"probe: numpy reference raised {e!r}")
            raise _Demoted from e
        if ref is None:
            self.demote("probe: numpy reference not columnar "
                        "(kernel output shape or key dtype)")
            raise _Demoted
        ref_cols, ref_ts, ref_tsm, cnt, ref_bounds, ref_pane = ref
        ok = (cnt == count
              and len(ref_cols) == len(out_cols)
              and all(self._arr_eq(a, b) for a, b in zip(out_cols, ref_cols))
              and self._arr_eq(out_ts, ref_ts)
              and self._arr_eq(out_tsm, ref_tsm)
              and self._arr_eq(bounds, ref_bounds)
              and self._arr_eq(pane, ref_pane))
        if not ok:
            self.demote("probe mismatch (fused != per-operator result)")
            raise _Demoted

    # .................................................................
    def _make_emit(self, batch, n, mode, tuple_out, out_cols, out_ts,
                   out_tsm, stage_rows, count, bounds, pane):
        """The emission closure: it runs outside the demotion handler,
        once the result is verified (or its signature was)."""
        from flink_tpu_torch.streaming.elements import RecordBatch
        if self.renames:
            # map stages name columns as the per-operator kernel does
            if tuple_out:
                cols = {f"f{i}": a for i, a in enumerate(out_cols)}
            else:
                cols = {"v": out_cols[0]}
        else:
            cols = dict(zip(batch.cols.keys(), out_cols))

        def emit():
            for op, r in zip(self.kernel_ops, stage_rows.tolist()):
                op._note_fused(int(r))
            FUSION_STATS.fused_batches += 1
            FUSION_STATS.fused_rows += n
            if count == 0:
                return
            out = RecordBatch(cols, out_ts, out_tsm)
            if mode == "window":
                self.window_op.process_batch_fused(out, pane)
                return
            if mode == "route":
                channels = self.route_channels
                bl = bounds.tolist()
                for c in range(self._r_nch):
                    lo, hi = int(bl[c]), int(bl[c + 1])
                    if lo < hi:
                        channels[c].push(RecordBatch(
                            {k: a[lo:hi] for k, a in cols.items()},
                            out_ts[lo:hi] if out_ts is not None else None,
                            out_tsm[lo:hi] if out_tsm is not None else None))
                return
            self.kernel_ops[-1].output.collect_batch(out)

        return emit
