"""Pre-flight graph linter, pass 1 (port of
``flink_tpu/analysis/graph_linter.py``).

Walks a :class:`~flink_tpu_torch.streaming.graph.StreamGraph` before
execution and emits structured :class:`~.diagnostics.Diagnostic`
findings: topology defects (cycles outside iterations, unreachable or
sink-less branches), window/trigger/lateness inconsistencies, key
selectors that cannot key, state serializers that do not round-trip,
chaining rejections, and, through the liftability analyzer (pass 2),
aggregates that run the scalar path or are impure.  The codes,
severities, operators, messages and hints are the reference's on the
same job.

The linter builds one operator per node through the node's factory
(``_instantiate``), as the executor does: no operator constructor of
the port touches the card, opens a socket or starts a thread, so the
pre-flight allocates and launches nothing.  Every check is
fault-isolated: an exception inside one becomes an FT199 info
diagnostic, never a failed job.
"""

from __future__ import annotations

import logging
from collections import Counter, deque
from typing import Any, Dict, List

from flink_tpu_torch.analysis.diagnostics import Diagnostic, Diagnostics
from flink_tpu_torch.analysis.liftability import (
    IMPURE,
    LIFTABLE,
    SCALAR_ONLY,
    analyze_aggregate,
    analyze_udf,
    returns_unhashable,
)

log = logging.getLogger("flink_tpu_torch.lint")


def lint_graph(graph, config=None, env=None,
               types: bool = False) -> Diagnostics:
    """Run all pre-flight checks over a StreamGraph.

    With ``types=True`` the column type-flow prover (pass 3,
    :mod:`~flink_tpu_torch.analysis.typeflow`) also runs: its FT185–FT188
    findings land in the returned report, and the full
    :class:`~flink_tpu_torch.analysis.typeflow.TypeflowReport` is attached
    as ``report.typeflow`` for callers that want the per-edge schema
    dump or to feed verdicts into the runtime."""
    return _GraphLinter(graph, config=config, env=env,
                        types=types).run()


class _GraphLinter:
    def __init__(self, graph, config=None, env=None, types=False):
        self.graph = graph
        self.config = config
        self.env = env
        self.types = types
        self.typeflow = None
        self.report = Diagnostics(
            job_name=getattr(graph, "job_name", None))
        #: node_id -> operator instance (from the node's factory), or
        #: None when construction failed (captured separately)
        self.ops: Dict[int, Any] = {}
        self.op_errors: Dict[int, Exception] = {}

    # ---- helpers ----------------------------------------------------
    def _diag(self, code, message, node=None, **kw):
        if node is not None:
            kw.setdefault("operator_id", node.id)
            kw.setdefault("operator_name", node.name)
        return self.report.add(code, message, **kw)

    def _instantiate(self):
        for nid, node in self.graph.nodes.items():
            try:
                self.ops[nid] = node.operator_factory()
            except Exception as e:
                self.op_errors[nid] = e

    def _upstream(self, nid) -> List[int]:
        """All transitive upstream node ids (feedback edges excluded)."""
        seen, work = set(), deque([nid])
        while work:
            cur = work.popleft()
            for e in self.graph.in_edges(cur):
                if e.is_feedback or e.source_id in seen:
                    continue
                seen.add(e.source_id)
                work.append(e.source_id)
        return list(seen)

    # ---- the run ----------------------------------------------------
    def run(self) -> Diagnostics:
        self._instantiate()
        checks = (
            self._check_factory_errors,
            self._check_cycles,
            self._check_duplicates,
            self._check_reachability,
            self._check_chaining,
            self._check_windows,
            self._check_keys,
            self._check_state_serializers,
            self._check_unbounded_state,
            self._check_timestamps,
            self._check_liftability,
            self._check_typeflow,
            self._check_columnar,
        )
        for check in checks:
            try:
                check()
            except Exception as e:
                self._diag("FT199",
                           f"check {check.__name__} skipped: {e!r}")
        return self.report

    # ---- checks -----------------------------------------------------
    def _check_factory_errors(self):
        for nid, e in self.op_errors.items():
            node = self.graph.nodes[nid]
            msg = str(e)
            code = ("FT110" if "merge" in msg and "trigger" in msg
                    else "FT190")
            self._diag(code, f"operator construction failed: {msg}",
                       node=node,
                       hint=("use a merge-capable trigger (EventTime/"
                             "ProcessingTime/Count/Purging) with "
                             "merging assigners" if code == "FT110"
                             else None))

    def _check_cycles(self):
        # DFS coloring over non-feedback edges; a back edge is a cycle
        # the runtime never declared as an iteration
        WHITE, GRAY, BLACK = 0, 1, 2
        color = {nid: WHITE for nid in self.graph.nodes}
        for root in self.graph.nodes:
            if color[root] != WHITE:
                continue
            stack = [(root, iter(self.graph.out_edges(root)))]
            color[root] = GRAY
            path = [root]
            while stack:
                nid, it = stack[-1]
                advanced = False
                for e in it:
                    if e.is_feedback:
                        continue
                    t = e.target_id
                    if color[t] == GRAY:
                        names = " -> ".join(
                            self.graph.nodes[p].name
                            for p in path[path.index(t):] + [t])
                        self._diag(
                            "FT160",
                            f"cycle outside a declared iteration: "
                            f"{names}",
                            node=self.graph.nodes[t],
                            hint="use env-level iterate()/close_with() "
                                 "so the runtime knows the feedback "
                                 "edge")
                        continue
                    if color[t] == WHITE:
                        color[t] = GRAY
                        path.append(t)
                        stack.append((t, iter(self.graph.out_edges(t))))
                        advanced = True
                        break
                if not advanced:
                    color[nid] = BLACK
                    stack.pop()
                    if path and path[-1] == nid:
                        path.pop()

    def _check_duplicates(self):
        uids = Counter(n.uid for n in self.graph.nodes.values())
        for uid, cnt in uids.items():
            if cnt > 1:
                nodes = [n for n in self.graph.nodes.values()
                         if n.uid == uid]
                self._diag(
                    "FT170",
                    f"uid '{uid}' assigned to {cnt} operators — "
                    f"savepoint state cannot be mapped back",
                    node=nodes[0],
                    hint="give each operator a distinct .uid()")
        names = Counter(n.name for n in self.graph.nodes.values())
        dups = {n: c for n, c in names.items() if c > 1}
        if dups:
            listing = ", ".join(f"'{n}'x{c}" for n, c in
                                sorted(dups.items()))
            self._diag("FT171",
                       f"duplicate operator names: {listing}",
                       hint="name operators with .name() to make "
                            "metrics and logs distinguishable")

    def _check_reachability(self):
        from flink_tpu_torch.streaming.operators import StreamSink
        reachable = set()
        work = deque(n.id for n in self.graph.sources())
        reachable.update(work)
        while work:
            cur = work.popleft()
            for e in self.graph.out_edges(cur):
                if e.target_id not in reachable:
                    reachable.add(e.target_id)
                    work.append(e.target_id)
        for nid, node in self.graph.nodes.items():
            if nid not in reachable and not node.is_source:
                self._diag("FT151",
                           "operator is unreachable from any source",
                           node=node)
                continue
            if not self.graph.out_edges(nid):
                op = self.ops.get(nid)
                if op is not None and not isinstance(op, StreamSink) \
                        and not node.is_source:
                    self._diag(
                        "FT150",
                        "branch ends without a sink — emitted records "
                        "are dropped",
                        node=node,
                        hint="terminate with add_sink()/print(), or "
                             "drop the branch")

    def _check_chaining(self):
        from flink_tpu_torch.streaming.graph import (
            chain_rejection_reasons,
            is_chainable,
        )
        from flink_tpu_torch.streaming.partitioners import ForwardPartitioner
        for e in self.graph.edges:
            if not isinstance(e.partitioner, ForwardPartitioner):
                continue
            up = self.graph.nodes[e.source_id]
            down = self.graph.nodes[e.target_id]
            if up.parallelism != down.parallelism:
                self._diag(
                    "FT131",
                    f"forward partitioner from '{up.name}' (p="
                    f"{up.parallelism}) to '{down.name}' (p="
                    f"{down.parallelism}) — forward requires equal "
                    f"parallelism",
                    node=down,
                    hint="use rebalance()/rescale() across "
                         "parallelism changes")
            elif not is_chainable(e, self.graph):
                reasons = chain_rejection_reasons(e, self.graph)
                self._diag(
                    "FT130",
                    f"'{up.name}' -> '{down.name}' not chained: "
                    + "; ".join(reasons),
                    node=down)

    def _check_windows(self):
        for nid, op in self.ops.items():
            assigner = getattr(op, "assigner", None)
            if assigner is None:
                continue
            node = self.graph.nodes[nid]
            gap = getattr(assigner, "gap", None)
            if isinstance(gap, (int, float)) and gap <= 0:
                self._diag(
                    "FT111",
                    f"session gap must be positive, got {gap}",
                    node=node,
                    hint="Time.milliseconds(n) with n >= 1")
            size = getattr(assigner, "size", None)
            slide = getattr(assigner, "slide", None)
            if isinstance(size, (int, float)) and size <= 0:
                self._diag("FT111",
                           f"window size must be positive, got {size}",
                           node=node)
            if isinstance(slide, (int, float)) and slide <= 0:
                self._diag("FT111",
                           f"window slide must be positive, got "
                           f"{slide}",
                           node=node)
            lateness = getattr(op, "allowed_lateness", 0) or 0
            if isinstance(size, (int, float)) and size > 0 \
                    and lateness > size:
                self._diag(
                    "FT112",
                    f"allowed lateness ({lateness}ms) exceeds the "
                    f"window size ({size}ms) — every element keeps "
                    f"more than one fired window alive",
                    node=node,
                    hint="late data beyond the window usually wants a "
                         "side output (late_tag), not more lateness")
            try:
                event_time = bool(assigner.is_event_time())
            except Exception:
                event_time = False
            if event_time and isinstance(size, (int, float)) \
                    and size > 0:
                offset = getattr(assigner, "offset", 0) or 0
                if isinstance(slide, (int, float)) and slide > 0 \
                        and size % slide != 0:
                    self._diag(
                        "FT113",
                        f"sliding window size {size} is not a multiple "
                        f"of slide {slide} — falls off the vectorized "
                        f"generic tier onto the per-record scalar path",
                        node=node)
                elif offset != 0:
                    self._diag(
                        "FT113",
                        f"window offset {offset} falls off the "
                        f"vectorized generic tier onto the per-record "
                        f"scalar path",
                        node=node)

    def _check_keys(self):
        import cloudpickle
        for nid, node in self.graph.nodes.items():
            selector = getattr(node, "key_selector", None)
            if selector is None:
                continue
            kind = returns_unhashable(selector)
            if kind:
                self._diag(
                    "FT101",
                    f"key selector returns a {kind} — keys must be "
                    f"hashable (keyed state and key-group routing "
                    f"hash them)",
                    node=node,
                    hint="return a tuple (or a scalar) instead of a "
                         f"{kind}")
                continue
            try:
                cloudpickle.loads(cloudpickle.dumps(selector))
            except Exception as e:
                self._diag(
                    "FT102",
                    f"key selector does not survive serialization "
                    f"({e!r}) — remote submission ships operators "
                    f"through the blob server",
                    node=node,
                    hint="avoid capturing sockets/files/locks in the "
                         "selector closure")

    def _check_state_serializers(self):
        from flink_tpu_torch.core.state import AggregatingStateDescriptor
        for nid, op in self.ops.items():
            desc = getattr(op, "state_descriptor", None)
            if desc is None:
                continue
            node = self.graph.nodes[nid]
            try:
                if isinstance(desc, AggregatingStateDescriptor):
                    sample = desc.aggregate_function.create_accumulator()
                else:
                    sample = desc.get_default_value()
            except Exception:
                continue
            if sample is None:
                continue
            ser = getattr(desc, "serializer", None)
            if ser is None:
                continue
            try:
                back = ser.deserialize_from_bytes(
                    ser.serialize_to_bytes(sample))
                same = _roughly_equal(back, sample)
            except Exception as e:
                self._diag(
                    "FT120",
                    f"state serializer {type(ser).__name__} failed the "
                    f"round-trip on a sample value: {e!r}",
                    node=node,
                    hint="checkpoints persist through this serializer "
                         "— fix it before relying on recovery")
                continue
            if not same:
                self._diag(
                    "FT120",
                    f"state serializer {type(ser).__name__} round-trip "
                    f"does not reproduce the value ({sample!r} -> "
                    f"{back!r})",
                    node=node)

    def _check_unbounded_state(self):
        from flink_tpu_torch.streaming.operators import (
            KeyedProcessOperator,
            StreamGroupedReduce,
        )
        from flink_tpu_torch.streaming.sources import (
            FileTextSource,
            FromCollectionSource,
            StreamSource,
        )
        for nid, op in self.ops.items():
            if not isinstance(op, (StreamGroupedReduce,
                                   KeyedProcessOperator)):
                continue
            node = self.graph.nodes[nid]
            what = ("keyed reduce" if isinstance(op, StreamGroupedReduce)
                    else "keyed process function")
            bounded = True
            for up in self._upstream(nid):
                src_op = self.ops.get(up)
                if isinstance(src_op, StreamSource):
                    fn = getattr(src_op, "user_function", None)
                    if not isinstance(fn, (FromCollectionSource,
                                           FileTextSource)):
                        bounded = False
            self._diag(
                "FT140",
                f"{what} holds per-key state forever (no window or "
                f"TTL scoping it)",
                node=node,
                severity=("warning" if not bounded else "info"),
                hint="window the stream, or clear state from a timer")

    def _check_timestamps(self):
        from flink_tpu_torch.streaming.sources import (
            FromCollectionSource,
            StreamSource,
            TimestampsAndWatermarksOperator,
        )
        for nid, op in self.ops.items():
            assigner = getattr(op, "assigner", None)
            if assigner is None:
                continue
            try:
                if not assigner.is_event_time():
                    continue
            except Exception:
                continue
            node = self.graph.nodes[nid]
            upstream = self._upstream(nid)
            if any(isinstance(self.ops.get(u),
                              TimestampsAndWatermarksOperator)
                   for u in upstream):
                continue
            sources = [self.ops.get(u) for u in upstream
                       if isinstance(self.ops.get(u), StreamSource)]
            if not sources:
                continue
            provably_untimestamped = all(
                isinstance(getattr(s, "user_function", None),
                           FromCollectionSource)
                and not s.user_function.timestamped
                and getattr(s, "time_characteristic", "event") == "event"
                for s in sources)
            if provably_untimestamped:
                self._diag(
                    "FT115",
                    "event-time window but no upstream path assigns "
                    "timestamps (source is a non-timestamped "
                    "collection and there is no "
                    "assign_timestamps_and_watermarks)",
                    node=node,
                    hint="from_collection(..., timestamped=True) with "
                         "(value, ts) pairs, or add "
                         "assign_timestamps_and_watermarks(...)")

    def _check_liftability(self):
        from flink_tpu_torch.core.state import AggregatingStateDescriptor
        from flink_tpu_torch.streaming.generic_agg import GenericWindowOperator
        from flink_tpu_torch.streaming.operators import (
            StreamFilter,
            StreamFlatMap,
            StreamGroupedReduce,
            StreamMap,
        )
        for nid, op in self.ops.items():
            node = self.graph.nodes[nid]
            agg, generic = None, False
            if isinstance(op, GenericWindowOperator):
                agg, generic = op.agg, True
            else:
                desc = getattr(op, "state_descriptor", None)
                if isinstance(desc, AggregatingStateDescriptor):
                    agg = desc.aggregate_function
            if agg is not None:
                self._lint_aggregate(node, agg, generic)
            udf_attr = {StreamMap: "map", StreamFilter: "filter",
                        StreamFlatMap: "flat_map",
                        StreamGroupedReduce: "reduce"}.get(type(op))
            if udf_attr is not None:
                uf = getattr(op, "user_function", None)
                # lambda wrappers (_LambdaMap & friends) hold the real
                # UDF in ._fn; analyzing the wrapper method would stop
                # at the opaque self._fn call
                fn = getattr(uf, "_fn", None)
                if not callable(fn):
                    fn = getattr(uf, udf_attr, uf)
                rep = analyze_udf(fn, name=f"{node.name}.{udf_attr}")
                if rep.verdict == IMPURE:
                    self._diag(
                        "FT183",
                        f"{udf_attr} function is impure: "
                        + "; ".join(rep.reasons),
                        node=node,
                        location=rep.location,
                        hint="impure UDFs break replay determinism — "
                             "recovery re-processes records after the "
                             "last checkpoint")

    def _check_typeflow(self):
        """Pass 3 (opt-in via ``types=True`` / lint.types.mode): run
        the whole-graph column type-flow prover, fold its FT185–FT188
        findings into this report, and keep the full
        :class:`~flink_tpu_torch.analysis.typeflow.TypeflowReport` around
        as ``report.typeflow`` (per-edge schemas for the CLI's
        ``--json`` dump, FT184 enrichment below, and
        :func:`~flink_tpu_torch.analysis.typeflow.apply_static`)."""
        if not self.types:
            return
        from flink_tpu_torch.analysis.typeflow import analyze_graph
        tf = analyze_graph(self.graph, config=self.config,
                           ops=self.ops)
        self.typeflow = tf
        self.report.typeflow = tf
        self.report.extend(tf.diagnostics)

    def _check_columnar(self):
        """FT184: per-chain columnar eligibility (informational).

        Reconstructs the greedy operator chains that job-graph
        construction would form and asks the eligibility pass
        (:mod:`~flink_tpu_torch.analysis.columnar_eligibility`) how far a
        RecordBatch survives down each chain before an operator boxes
        it back to per-record StreamRecords — and which operator is
        the first to force the fallback.  Chains whose head never
        accepts batches (ordinary boxed sources) are silent: the
        diagnostic is for pipelines that start columnar, not a blanket
        nag on every legacy job."""
        from flink_tpu_torch.analysis.columnar_eligibility import chain_report
        from flink_tpu_torch.streaming.graph import is_chainable
        chained_into = {e.target_id for e in self.graph.edges
                        if is_chainable(e, self.graph)}
        for nid, node in self.graph.nodes.items():
            if nid in chained_into:
                continue  # interior of some chain
            chain_nodes = [node]
            cur = nid
            while True:
                nxt = [e.target_id for e in self.graph.out_edges(cur)
                       if is_chainable(e, self.graph)]
                if len(nxt) != 1:
                    break
                cur = nxt[0]
                chain_nodes.append(self.graph.nodes[cur])
            ops = [self.ops.get(c.id) for c in chain_nodes]
            if any(op is None for op in ops):
                continue  # factory errors already reported (FT190)
            rep = chain_report(ops)
            names = " -> ".join(c.name for c in chain_nodes)
            fus = rep["fusion"]
            if fus["fusable"]:
                fused_note = (
                    f"; fuses {len(fus['fused_ops'])} operators into one "
                    f"jitted program"
                    + (f", fusion stops at '{fus['first_blocker']}': "
                       f"{fus['blocker_reason']}"
                       if fus["first_blocker"] else ""))
            else:
                fused_note = (
                    f"; no fusable run"
                    + (f" — first fusion blocker '{fus['first_blocker']}': "
                       f"{fus['blocker_reason']}"
                       if fus["first_blocker"] else ""))
            if rep["eligible"] and rep["first_blocker"] is None:
                self._diag(
                    "FT184",
                    f"chain [{names}] consumes columnar batches end to "
                    f"end ({', '.join(f'{n}:{m}' for n, m, _ in rep['modes'])})"
                    f"{fused_note}",
                    node=node)
            elif rep["eligible"]:
                blocker_i = rep["prefix_len"]
                _, _, reason = rep["modes"][blocker_i]
                edge_info = ""
                if self.typeflow is not None and blocker_i > 0:
                    # name the exact edge/dtype the batch dies on:
                    # the schema leaving the last columnar operator
                    prev = chain_nodes[blocker_i - 1]
                    schema = self.typeflow.node_schemas.get(prev.id)
                    if schema is not None and schema.conclusive:
                        edge_info = (
                            f" — boxing the edge '{prev.name}' -> "
                            f"'{chain_nodes[blocker_i].name}' carrying "
                            f"{schema.describe()}")
                self._diag(
                    "FT184",
                    f"chain [{names}] rides columns for "
                    f"{rep['prefix_len']} of {len(ops)} operators, then "
                    f"boxes at '{chain_nodes[blocker_i].name}': "
                    f"{reason}{edge_info}{fused_note}",
                    node=chain_nodes[blocker_i],
                    hint="operators past the first boxing point pay "
                         "per-record StreamRecord costs")

    def _lint_aggregate(self, node, agg, generic: bool):
        if getattr(agg, "force_scalar", False):
            return  # an explicit opt-out is not a finding
        rep = analyze_aggregate(agg)
        if rep.verdict == IMPURE:
            self._diag(
                "FT180",
                f"aggregate {type(agg).__name__} is impure: "
                + "; ".join(rep.reasons),
                node=node,
                location=rep.location,
                hint="aggregates are replayed on recovery and lifted "
                     "onto columns — they must be pure functions of "
                     "(value, accumulator)")
        elif rep.verdict == SCALAR_ONLY and generic:
            self._diag(
                "FT181",
                f"aggregate {type(agg).__name__} conclusively runs the "
                f"per-record scalar path: " + "; ".join(rep.reasons),
                node=node,
                location=rep.location,
                hint="rewrite data-dependent branches as arithmetic "
                     "(e.g. np.where(cond, a, b)) to ride the "
                     "vectorized tier")
        elif rep.verdict == LIFTABLE and generic:
            self._diag(
                "FT182",
                f"aggregate {type(agg).__name__} proven liftable — "
                f"the runtime probe is skipped"
                + ("" if rep.result_liftable
                   else " (get_result stays per-key)"),
                node=node,
                location=rep.location)


def _roughly_equal(a, b) -> bool:
    try:
        eq = a == b
        import numpy as np
        if isinstance(eq, np.ndarray):
            return bool(eq.all())
        if eq:
            return True
    except Exception:
        pass
    try:
        return repr(a) == repr(b)
    except Exception:
        return False
