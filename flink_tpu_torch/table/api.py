"""Table API and SQL planner, lowered onto the DataStream operators
(port of ``flink_tpu/table/api.py``).

``StreamTableEnvironment.create(env)`` registers tables from a stream
of tuples (``from_data_stream``) or from numpy columns
(``from_columns``), and plans SQL text (``sql_query``, ``execute_sql``
with INSERT INTO) or fluent Table calls the same way as the JAX
package:

- a windowed GROUP BY (TUMBLE / HOP / SESSION) on a columnar table with
  one key column and one device aggregate over a column lowers to the
  columnar plan (``ColumnarWindowOperator``: whole batches into a
  window engine on the environment's device; ``BatchKeyGroupSplitOperator``
  and ``partition_custom`` at parallelism > 1; the mesh log tier under
  ``env.set_mesh``).  Any other windowed GROUP BY goes through
  ``key_by().window().aggregate()``, where a single device aggregate
  takes ``DeviceWindowOperator`` and the rest the generic tier or
  ``WindowOperator``.  ``APPROX_COUNT_DISTINCT`` is the port's
  ``HyperLogLogAggregate(precision=12)``;
- a continuous GROUP BY is a keyed process function emitting the
  retract protocol; a JOIN with an equi key and a rowtime bound is the
  interval join (the columnar one when both sides are columnar); OVER
  windows, event-time sorts, LIMIT and top-N are process functions or
  operators of their own; LATERAL TABLE is a flat map.
"""

from __future__ import annotations

import numpy as np

from typing import Any, Callable, Dict, List, Optional, Sequence

from flink_tpu_torch.table.expressions import (
    AggCall,
    BinaryOp,
    Column,
    Expr,
    Literal,
    OverCall,
    Schema,
    UnaryOp,
    WindowProp,
    find_aggs,
    find_overs,
    output_name,
    output_names,
    strip_alias,
    substitute,
)
from flink_tpu_torch.table.functions import (
    UDAF_DEVICE,
    make_builtin_agg,
)
from flink_tpu_torch.table.sql_parser import (
    InsertStatement,
    LateralCall,
    Query,
    SqlError,
    UnionQuery,
    WindowSpec,
    parse,
    parse_statement,
)


class Table:
    """A (possibly derived) relational view over a DataStream.

    Thin by design: transformations apply eagerly to the underlying
    stream; windowed grouping happens through sql_query / window()."""

    def __init__(self, t_env: "StreamTableEnvironment", stream,
                 schema: Schema):
        self.t_env = t_env
        self.stream = stream
        self.schema = schema

    def _as_rows(self) -> "Table":
        """Row view of a columnar table: explode RecordBatches so the
        row-at-a-time operators can consume them (the fallback bridge
        out of the columnar tier)."""
        if not getattr(self, "columnar", False):
            return self
        from flink_tpu_torch.streaming.columnar import explode_to_rows
        t = Table(self.t_env, explode_to_rows(self.stream), self.schema)
        t.rowtime = getattr(self, "rowtime", None)
        return t

    # ---- Table API (subset of ref Table.scala ops) -------------------
    def select(self, *exprs) -> "Table":
        exprs = [self.t_env._expr(e) for e in exprs]
        if any(find_aggs(e) for e in exprs):
            raise SqlError("aggregates need group_by().window() or SQL")
        names = output_names(exprs)
        inner = [strip_alias(e) for e in exprs]
        if getattr(self, "columnar", False) and all(
                isinstance(e, Column) and e.name in self.schema.index
                for e in inner):
            # pure column projection stays columnar: rename/select
            # batch columns without exploding to rows (names resolve
            # through the schema to the canonical batch column name)
            src = [self.schema.fields[self.schema.index[e.name]]
                   for e in inner]
            from flink_tpu_torch.streaming.columnar import RecordBatch

            def project(b, names=tuple(names), src=tuple(src)):
                return RecordBatch({n: b.cols[s]
                                    for n, s in zip(names, src)}, b.ts)

            t = Table(self.t_env,
                      self.stream.map(project, name="columnar_select"),
                      Schema(names))
            t.columnar = True
            # rowtime follows the projection: the new name if the
            # rowtime column was selected (possibly renamed), None if
            # the projection dropped it
            rt = getattr(self, "rowtime", None)
            canon_rt = (self.schema.fields[self.schema.index[rt]]
                        if rt in self.schema.index else None)
            t.rowtime = next((n for n, s in zip(names, src)
                              if s == canon_rt), None)
            return t
        fns = [e.compile(self.schema) for e in inner]
        out = self._as_rows().stream.map(
            lambda row, fns=fns: tuple(f(row) for f in fns),
            name="select")
        t = Table(self.t_env, out, Schema(names))
        t._updating = getattr(self, "_updating", False)
        # the time attribute survives a projection that keeps its
        # column (possibly renamed) — same rule as the columnar branch
        rt = getattr(self, "rowtime", None)
        if rt is not None:
            t.rowtime = next(
                (n for n, e in zip(names, inner)
                 if isinstance(e, Column)
                 and e.name in (rt, rt.split(".")[-1])), None)
        return t

    def filter(self, predicate) -> "Table":
        e = self.t_env._expr(predicate)
        fn = e.compile(self.schema)
        t = Table(self.t_env,
                  self._as_rows().stream.filter(lambda row: bool(fn(row)),
                                                name="filter"),
                  self.schema)
        t._updating = getattr(self, "_updating", False)
        return t

    where = filter

    def union_all(self, other: "Table") -> "Table":
        # positional schema match, names from the left input (the
        # reference unions by field position/type, Table.unionAll)
        if len(other.schema.fields) != len(self.schema.fields):
            raise SqlError(
                f"UNION ALL requires same arity: "
                f"{self.schema.fields} vs {other.schema.fields}")
        return Table(self.t_env,
                     self._as_rows().stream.union(
                         other._as_rows().stream),
                     self.schema)

    def group_by(self, *exprs) -> "GroupedTable":
        return GroupedTable(self, [self.t_env._expr(e) for e in exprs])

    def window(self, spec: WindowSpec) -> "WindowedTable":
        return WindowedTable(self, spec)

    # ---- sinks -------------------------------------------------------
    def to_retract_stream(self):
        """(is_add: bool, row) pairs — retractions precede each
        update's refreshed row (the reference's toRetractStream /
        GroupAggProcessFunction protocol).  Available on continuous
        (non-windowed) aggregation results; append-only tables emit
        (True, row) for every row."""
        rs = getattr(self, "_retract_stream", None)
        if rs is not None:
            rs.carries_retract_pairs = True
            return rs
        if getattr(self, "_updating", False):
            # derived from an updating aggregate: the retraction half
            # was lost by the intervening filter/select — mislabeling
            # the upsert rows as append-only adds would double-count
            raise SqlError(
                "retract protocol lost: consume to_retract_stream() "
                "on the aggregation result BEFORE filter/select, or "
                "use a windowed aggregation (append-only)")
        out = self._as_rows().stream.map(lambda row: (True, row),
                                         name="as_retract")
        out.carries_retract_pairs = True
        return out

    def to_append_stream(self, batched: bool = False):
        """Stream of row tuples regardless of the physical plan: a
        columnar fast-path plan is bridged through explode_to_rows so
        the element type never depends on planner eligibility.
        ``batched=True`` opts into RecordBatch
        elements when the plan is columnar (zero bridging cost; a
        row-at-a-time plan still yields row tuples)."""
        if batched:
            return self.stream
        return self._as_rows().stream

    def execute_insert(self, sink, batched: bool = False) -> None:
        self.to_append_stream(batched=batched).add_sink(sink)


class GroupedTable:
    def __init__(self, table: Table, keys: List[Expr]):
        self.table = table
        self.keys = keys

    def window(self, spec: WindowSpec) -> "WindowedGroupedTable":
        return WindowedGroupedTable(self.table, self.keys, spec)

    def select(self, *exprs) -> Table:
        """Continuous (non-windowed) grouped aggregation: emits an
        updated result row per input record (the upsert shape of the
        reference's GroupAggProcessFunction — toRetractStream's
        accumulate side)."""
        exprs = [self.table.t_env._expr(e) for e in exprs]
        return _lower_continuous_group_agg(self.table, self.keys, exprs)


class WindowedTable:
    def __init__(self, table: Table, spec: WindowSpec):
        self.table = table
        self.spec = spec

    def group_by(self, *exprs) -> "WindowedGroupedTable":
        return WindowedGroupedTable(
            self.table, [self.table.t_env._expr(e) for e in exprs],
            self.spec)


class WindowedGroupedTable:
    def __init__(self, table: Table, keys: List[Expr], spec: WindowSpec):
        self.table = table
        self.keys = keys
        self.spec = spec

    def select(self, *exprs) -> Table:
        exprs = [self.table.t_env._expr(e) for e in exprs]
        return _lower_windowed_agg(self.table, self.keys, self.spec, exprs)


# ---------------------------------------------------------------------
# window spec builders (Table API twins of SQL TUMBLE/HOP/SESSION;
# ref: org.apache.flink.table.api.{Tumble, Slide, Session})
# ---------------------------------------------------------------------

class Tumble:
    @staticmethod
    def over(size_ms: int):
        return _WindowBuilder(WindowSpec("tumble", "", size_ms=size_ms))


class Slide:
    @staticmethod
    def over(size_ms: int):
        return _SlideBuilder(size_ms)


class Session:
    @staticmethod
    def with_gap(gap_ms: int):
        return _WindowBuilder(WindowSpec("session", "", gap_ms=gap_ms))


class _SlideBuilder:
    def __init__(self, size_ms: int):
        self.size_ms = size_ms

    def every(self, slide_ms: int):
        return _WindowBuilder(WindowSpec("hop", "", size_ms=self.size_ms,
                                         slide_ms=slide_ms))


class _WindowBuilder:
    def __init__(self, spec: WindowSpec):
        self.spec = spec

    def on(self, time_col: str) -> WindowSpec:
        self.spec.time_col = time_col
        return self.spec


# ---------------------------------------------------------------------
# environment
# ---------------------------------------------------------------------

class StreamTableEnvironment:
    """(ref: StreamTableEnvironment.scala — create/fromDataStream/
    registerTable/sqlQuery/toAppendStream)"""

    def __init__(self, env):
        self.env = env
        self.tables: Dict[str, Table] = {}
        self.udafs: Dict[str, Callable[[], Any]] = {}
        #: name -> sink function (INSERT INTO targets; ref
        #: TableEnvironment.registerTableSink)
        self.sinks: Dict[str, Any] = {}
        #: name -> TableFunction factory (UDTFs, LATERAL TABLE)
        self.udtfs: Dict[str, Callable[[], Any]] = {}

    @staticmethod
    def create(env) -> "StreamTableEnvironment":
        return StreamTableEnvironment(env)

    # ---- registration -----------------------------------------------
    def from_data_stream(self, stream, fields: Sequence[str],
                         rowtime: Optional[str] = None) -> Table:
        """Interpret a stream of tuples as rows.  `rowtime` names the
        field carrying the event-time attribute — the stream must have
        timestamps/watermarks assigned upstream (the .rowtime marker
        of the reference)."""
        t = Table(self, stream, Schema(fields))
        t.rowtime = rowtime
        return t

    def from_columns(self, cols, rowtime: str, chunk: int = 1 << 19,
                     ooo_slack_ms: int = 0) -> Table:
        """Columnar source table: numpy column arrays, time-sorted on
        `rowtime`.  Eligible windowed GROUP BY plans over it compile
        onto the vectorized RecordBatch tier
        (streaming/columnar.py) — the Blink-planner analogue of the
        reference's Janino codegen (codegen/CodeGenerator.scala): the
        per-record interpretation gap closes by batching, not by
        generating row code."""
        from flink_tpu_torch.streaming.columnar import ColumnarSource
        stream = self.env.add_source(
            ColumnarSource(dict(cols), rowtime, chunk, ooo_slack_ms),
            name="columnar_source")
        t = Table(self, stream, Schema(list(cols)))
        t.rowtime = rowtime
        t.columnar = True
        t.col_dtypes = {k: np.asarray(v).dtype for k, v in cols.items()}
        return t

    def register_table(self, name: str, table: Table) -> None:
        self.tables[name] = table

    def register_table_sink(self, name: str, sink) -> None:
        """Register a sink function as an INSERT INTO target
        (ref: TableEnvironment.registerTableSink,
        TableEnvironment.scala:578)."""
        self.sinks[name] = sink

    def register_table_function(self, name: str,
                                factory: Callable[[], Any]) -> None:
        """Register a UDTF: `factory()` returns a fresh TableFunction
        consumed via `, LATERAL TABLE(name(...)) AS t(col, ...)`
        (ref: TableEnvironment.registerFunction for TableFunction)."""
        self.udtfs[name.upper()] = factory

    def register_function(self, name: str, factory: Callable[[], Any]
                          ) -> None:
        """Register a UDAF: `factory()` returns a fresh
        AggregateFunction (device aggregates take the device window
        engines when the query shape allows)."""
        self.udafs[name.upper()] = factory

    def scan(self, name: str) -> Table:
        return self.tables[name]

    # ---- SQL ---------------------------------------------------------
    def sql_query(self, sql: str) -> Table:
        q = parse(sql, udaf_names=self.udafs.keys())
        return self._lower_node(q)

    def execute_sql(self, sql: str):
        """Execute a SQL statement: SELECT returns the result Table;
        INSERT INTO plans the query and wires it to the registered
        sink (ref: TableEnvironment.sqlUpdate,
        TableEnvironment.scala:614)."""
        stmt = parse_statement(sql, udaf_names=self.udafs.keys())
        if isinstance(stmt, InsertStatement):
            sink = self.sinks.get(stmt.target)
            if sink is None:
                raise SqlError(
                    f"unknown sink table {stmt.target!r} "
                    "(register_table_sink first)")
            self._lower_node(stmt.query).execute_insert(sink)
            return None
        return self._lower_node(stmt)

    # the reference's sqlUpdate name, kept as an alias
    sql_update = execute_sql

    def _lower_node(self, q) -> Table:
        if isinstance(q, UnionQuery):
            t = self._lower_query(q.queries[0])
            for sub in q.queries[1:]:
                t = t.union_all(self._lower_query(sub))
            return _lower_order_limit(t, q.order_by, q.limit)
        return self._lower_query(q)

    def _lower_query(self, q: Query) -> Table:
        t = self._resolve_from(q)
        out = self._lower_select_clauses(q, t)
        return _lower_order_limit(out, q.order_by, q.limit)

    def _resolve_from(self, q: Query) -> Table:
        if isinstance(q.table, (Query, UnionQuery)):
            t = self._lower_node(q.table)
        else:
            if q.table not in self.tables:
                raise SqlError(f"unknown table {q.table!r}")
            if q.join is not None:
                t = _lower_join(self, q)
            else:
                t = self.tables[q.table]
        if q.join is not None and isinstance(q.table, (Query, UnionQuery)):
            raise SqlError("JOIN over a subquery is not supported")
        for lat in q.laterals:
            t = _lower_lateral(self, t, lat)
        return t

    def _lower_select_clauses(self, q: Query, t: Table) -> Table:
        if q.where is not None:
            t = t.filter(q.where)
        has_overs = any(find_overs(e) for e in q.select)
        if has_overs:
            if q.window is not None or q.group_by or q.having is not None:
                raise SqlError(
                    "OVER aggregates cannot mix with GROUP BY/HAVING")
            if any(find_aggs(e) for e in q.select):
                raise SqlError(
                    "cannot mix OVER aggregates with plain aggregates "
                    "in one SELECT")
            return _lower_over_agg(t, q.select)
        has_aggs = any(find_aggs(e) for e in q.select)
        if q.window is not None:
            if not has_aggs:
                raise SqlError("group window without aggregates")
            out = _lower_windowed_agg(t, q.group_by, q.window, q.select,
                                      having=q.having)
            return out
        if q.group_by or has_aggs:
            if q.having is not None:
                raise SqlError(
                    "HAVING on continuous aggregation not supported")
            return _lower_continuous_group_agg(t, q.group_by, q.select)
        # plain projection
        return t.select(*q.select)

    # ---- conversion --------------------------------------------------
    def to_append_stream(self, table: Table, batched: bool = False):
        return table.to_append_stream(batched=batched)

    def _expr(self, e) -> Expr:
        if isinstance(e, Expr):
            return e
        if isinstance(e, str):
            from flink_tpu_torch.table.sql_parser import _parse_select_item, _Tokens
            return _parse_select_item(_Tokens(e), set(self.udafs))
        raise TypeError(f"not an expression: {e!r}")


# ---------------------------------------------------------------------
# lowering
# ---------------------------------------------------------------------

def _assigner_for(spec: WindowSpec):
    from flink_tpu_torch.streaming.windowing import (
        EventTimeSessionWindows,
        SlidingEventTimeWindows,
        TumblingEventTimeWindows,
    )
    if spec.kind == "tumble":
        return TumblingEventTimeWindows.of(spec.size_ms)
    if spec.kind == "hop":
        return SlidingEventTimeWindows.of(spec.size_ms, spec.slide_ms)
    return EventTimeSessionWindows.with_gap(spec.gap_ms)


from flink_tpu_torch.core.functions import AggregateFunction as _AggBase


class _CompositeAgg(_AggBase):
    """N aggregate functions over projected inputs, one accumulator
    tuple (the AggregateAggFunction role,
    runtime/aggregate/AggregateAggFunction.scala)."""

    def __init__(self, parts):
        self.parts = parts  # [(agg_fn, input_fn)]
        # a composite whose every sub-accumulator is a plain number
        # presents a flat numeric list and may still lift; any
        # sketch/object sub-accumulator conclusively pins the
        # per-record scalar path — declare that (the force_scalar
        # opt-out the generic tier's lift decision honors)
        try:
            self.force_scalar = any(
                not isinstance(a.create_accumulator(), (int, float))
                for a, _ in parts)
        except Exception:  # noqa: BLE001 — probing must never fail a plan
            self.force_scalar = False

    def create_accumulator(self):
        return [a.create_accumulator() for a, _ in self.parts]

    def add(self, value, acc):
        return [a.add(f(value), sub)
                for (a, f), sub in zip(self.parts, acc)]

    def get_result(self, acc):
        return tuple(a.get_result(sub)
                     for (a, _), sub in zip(self.parts, acc))

    def merge(self, x, y):
        return [a.merge(sx, sy)
                for (a, _), sx, sy in zip(self.parts, x, y)]


def _try_columnar_windowed_agg(table: Table, keys: List[Expr],
                               spec: WindowSpec, select: List[Expr],
                               having: Optional[Expr]) -> Optional[Table]:
    """Columnar physical plan: single group key, single device-eligible
    aggregate over a plain column, projection of key/agg/window-props
    only, columnar source; at parallelism > 1 the keyBy edge goes
    through the batch key-group split exchange.  Compiles onto
    ColumnarWindowOperator — whole RecordBatches feed the window
    engine, fires leave as RecordBatches (streaming/columnar.py).
    Returns None when the plan doesn't fit (row path takes over)."""
    if having is not None or not getattr(table, "columnar", False):
        return None
    key_exprs = [strip_alias(k) for k in keys]
    if len(key_exprs) != 1 or not isinstance(key_exprs[0], Column):
        return None
    key_col = key_exprs[0].name
    agg_sites: List[AggCall] = []
    for e in select:
        for a in find_aggs(e):
            if not any(repr(a) == repr(x) for x in agg_sites):
                agg_sites.append(a)
    if len(agg_sites) != 1:
        return None
    site = agg_sites[0]
    if site.args and not isinstance(site.args[0], Column):
        return None
    input_col = site.args[0].name if site.args else None
    t_env = table.t_env
    try:
        agg = (t_env.udafs[site.name]() if site.name in t_env.udafs
               else make_builtin_agg(site))
    except SqlError:
        return None
    if not _is_device_agg(agg):
        # builtin substitution only — a user-registered UDAF under the
        # same name must keep its own semantics (row path)
        if site.name in t_env.udafs:
            return None
        agg = _device_builtin_equivalent(
            site, getattr(table, "col_dtypes", {}).get(input_col))
        if agg is None:
            return None
    out_fields = []
    out_names = []
    for i, e in enumerate(select):
        inner = strip_alias(e)
        nm = output_name(e, i)
        if isinstance(inner, AggCall) and repr(inner) == repr(site):
            out_fields.append((nm, "agg"))
        elif isinstance(inner, Column) and inner.name == key_col:
            out_fields.append((nm, "key"))
        elif isinstance(inner, WindowProp):
            out_fields.append((nm, "wstart" if inner.kind == "start"
                               else "wend"))
        else:
            return None
        out_names.append(nm)
    assigner = _assigner_for(spec)
    from flink_tpu_torch.streaming.columnar import (
        BatchKeyGroupSplitOperator,
        ColumnarWindowOperator,
    )

    # with a mesh instance set (and task parallelism 1), the keyBy
    # exchange is the mesh axis (the pack and all_to_all of the
    # per-shard log engines, parallel/mesh_log.py) instead of the split
    # exchange: the mesh is the scale axis.  A mesh factory keeps the
    # environment's parallelism: the split exchange shards keys across
    # subtasks and each subtask's own mesh shards its range (the same
    # contract as the DataStream path).
    from flink_tpu_torch.streaming.device_window_operator import (
        is_mesh_factory,
    )
    env = table.stream.env
    mesh = (env.mesh if env.parallelism == 1
            or is_mesh_factory(env.mesh) else None)
    mesh_axis = env.mesh_axis
    device = env.device

    def factory(assigner=assigner, agg=agg, key_col=key_col,
                input_col=input_col, out_fields=tuple(out_fields),
                mesh=mesh, mesh_axis=mesh_axis, device=device):
        return ColumnarWindowOperator(assigner, agg, key_col, input_col,
                                      out_fields, mesh=mesh,
                                      mesh_axis=mesh_axis, device=device)

    # stable operator uid: state must survive re-lowering the same
    # query at a DIFFERENT parallelism (the topology gains/loses the
    # split node, shifting positional ids) — restore matches vertices
    # by operator uid, so the window operator names itself by query
    # order + logical shape, not topology position
    seq = t_env._columnar_uid_seq = getattr(
        t_env, "_columnar_uid_seq", -1) + 1
    agg_uid = (f"columnar-window-agg:{seq}:{key_col}:"
               f"{site.name}:{input_col}")

    par = table.stream.env.parallelism
    if par == 1:
        out = table.stream._add_op("columnar_window_agg", factory,
                                   parallelism=1)
    else:
        # parallelism > 1: the keyBy exchange splits each batch by
        # key-group-derived target (one hash pass + one mask per
        # subtask, C++ key-group arithmetic) and a tag partitioner
        # routes the sub-batches: RecordBatches cross the shuffle whole
        max_par = table.stream.env.max_parallelism

        def split_factory(key_col=key_col, max_par=max_par, par=par):
            return BatchKeyGroupSplitOperator(key_col, max_par, par)

        split = table.stream._add_op("columnar_keyby_split",
                                     split_factory, parallelism=1)
        out = split.partition_custom(lambda tagged, n: tagged[0]) \
            ._add_op("columnar_window_agg", factory, parallelism=par)
    out.node.uid = agg_uid
    t = Table(t_env, out, Schema(out_names))
    t.columnar = True
    return t


def _device_builtin_equivalent(site: AggCall, input_dtype=None):
    """Vectorized twin of a scalar builtin aggregate for the columnar
    plan.  None -> the plan stays on the row path.  SUM/MIN/MAX only
    substitute for FLOATING input columns: the device twins accumulate
    float64, which matches the row path exactly there but would round
    int64 values beyond 2^53 (and change the output type).  AVG is
    excluded outright — AvgAggregate accumulates float32."""
    from flink_tpu_torch.ops import device_agg as da
    if getattr(site, "distinct", False):
        return None
    if site.name == "COUNT":
        return da.CountAggregate()
    if input_dtype is None or not np.issubdtype(input_dtype, np.floating):
        return None
    return {
        "SUM": lambda: da.SumAggregate(np.float64),
        "MIN": lambda: da.MinAggregate(np.float64),
        "MAX": lambda: da.MaxAggregate(np.float64),
    }.get(site.name, lambda: None)()


def _lower_windowed_agg(table: Table, keys: List[Expr], spec: WindowSpec,
                        select: List[Expr], having: Optional[Expr] = None
                        ) -> Table:
    """keyBy(group keys) → window(assigner) → aggregate(composite)
    with the select list evaluated at fire time (the
    DataStreamGroupWindowAggregate.scala:197-238 shape)."""
    fast = _try_columnar_windowed_agg(table, keys, spec, select, having)
    if fast is not None:
        return fast
    table = table._as_rows()
    t_env = table.t_env
    schema = table.schema
    key_exprs = [strip_alias(k) for k in keys]
    key_fns = [k.compile(schema) for k in key_exprs]
    key_names = {k.name: i for i, k in enumerate(key_exprs)
                 if isinstance(k, Column)}

    # collect distinct agg call sites (structural identity — the same
    # textual COUNT(*) in SELECT and HAVING shares one accumulator)
    agg_sites: List[AggCall] = []
    site_index: Dict[str, int] = {}
    sources = list(select) + ([having] if having is not None else [])
    for e in sources:
        for a in find_aggs(e):
            if repr(a) not in site_index:
                site_index[repr(a)] = len(agg_sites)
                agg_sites.append(a)
    parts, device_single = _build_agg_parts(t_env, agg_sites, schema)

    # compile each select item against the synthetic post-agg row:
    #   [key0..km, agg0..an, wstart, wend]
    n_keys = len(key_exprs)
    n_aggs = len(agg_sites)
    post_fields = ([f"__k{i}" for i in range(n_keys)]
                   + [f"__a{i}" for i in range(n_aggs)]
                   + ["__wstart", "__wend"])
    post_schema = Schema(post_fields)

    def remap(e):
        if isinstance(e, AggCall):
            return Column(f"__a{site_index[repr(e)]}")
        if isinstance(e, WindowProp):
            return Column("__wstart" if e.kind == "start" else "__wend")
        if isinstance(e, Column):
            if e.name in key_names:
                return Column(f"__k{key_names[e.name]}")
            if e.name.startswith("__"):
                return None
            raise SqlError(
                f"column {e.name!r} must appear in GROUP BY or inside "
                f"an aggregate")
        return None

    out_fns = [substitute(strip_alias(e), remap).compile(post_schema)
               for e in select]
    out_names = output_names(select)
    having_fn = (substitute(strip_alias(having), remap).compile(post_schema)
                 if having is not None else None)

    def key_selector(row):
        ks = tuple(f(row) for f in key_fns)
        return ks if len(ks) != 1 else ks[0]

    def window_fn(key, window, results):
        acc_res = results[0]
        if device_single:
            aggs = (acc_res,)
        else:
            aggs = acc_res  # _CompositeAgg result tuple, one per site
        if n_keys == 0:
            key_t = ()
        elif n_keys == 1:
            key_t = (key,)
        else:
            key_t = key
        row = (*key_t, *aggs, window.start, window.end)
        if having_fn is not None and not having_fn(row):
            return []
        return [tuple(f(row) for f in out_fns)]

    stream = table.stream
    # rowtime: records must already carry event timestamps; the SQL
    # window's time column names the stream's rowtime attribute
    windowed = (stream.key_by(key_selector if key_exprs
                              else (lambda row: 0))
                .window(_assigner_for(spec)))
    if device_single:
        agg_fn = parts[0][0]
        agg_fn.extract_value = parts[0][1]
        out = windowed.aggregate(agg_fn, window_function=window_fn,
                                 name="sql_window_agg")
    else:
        out = windowed.aggregate(_CompositeAgg(parts),
                                 window_function=window_fn,
                                 name="sql_window_agg")
    return Table(t_env, out, Schema(out_names))


def _build_agg_parts(t_env, agg_sites: List[AggCall], schema: Schema):
    """(agg_fn, input_fn) per call site; device_single=True when the
    single aggregate is device-eligible (takes the device window
    engines)."""
    parts = []
    device_single = False
    for a in agg_sites:
        input_fn = (a.args[0].compile(schema) if a.args
                    else (lambda row: 1))
        if a.name in t_env.udafs:
            agg = t_env.udafs[a.name]()
        else:
            agg = make_builtin_agg(a)
        parts.append((agg, input_fn))
    if len(agg_sites) == 1:
        agg = parts[0][0]
        if type(agg).__name__ in UDAF_DEVICE or _is_device_agg(agg):
            device_single = True
    return parts, device_single


def _is_device_agg(agg) -> bool:
    from flink_tpu_torch.ops.device_agg import DeviceAggregateFunction
    return isinstance(agg, DeviceAggregateFunction)


def _lower_continuous_group_agg(table: Table, keys: List[Expr],
                                select: List[Expr]) -> Table:
    """Non-windowed GROUP BY: per input record, update the group's
    accumulators and emit the refreshed result row (the accumulate
    side of GroupAggProcessFunction.scala; consume via
    to_retract_stream semantics — last row per key wins)."""
    table = table._as_rows()
    t_env = table.t_env
    schema = table.schema
    key_exprs = [strip_alias(k) for k in keys]
    key_fns = [k.compile(schema) for k in key_exprs]
    key_names = {k.name: i for i, k in enumerate(key_exprs)
                 if isinstance(k, Column)}
    agg_sites: List[AggCall] = []
    site_index: Dict[str, int] = {}
    for e in select:
        for a in find_aggs(e):
            if repr(a) not in site_index:
                site_index[repr(a)] = len(agg_sites)
                agg_sites.append(a)
    parts, _ = _build_agg_parts(t_env, agg_sites, schema)
    composite = _CompositeAgg(parts)

    n_keys = len(key_exprs)
    post_fields = ([f"__k{i}" for i in range(n_keys)]
                   + [f"__a{i}" for i in range(len(agg_sites))])
    post_schema = Schema(post_fields)

    def remap(e):
        if isinstance(e, AggCall):
            return Column(f"__a{site_index[repr(e)]}")
        if isinstance(e, Column):
            if e.name in key_names:
                return Column(f"__k{key_names[e.name]}")
            raise SqlError(
                f"column {e.name!r} must appear in GROUP BY or inside "
                f"an aggregate")
        return None

    out_fns = [substitute(strip_alias(e), remap).compile(post_schema)
               for e in select]
    out_names = output_names(select)

    from flink_tpu_torch.core.state import ValueStateDescriptor
    from flink_tpu_torch.streaming.operators import ProcessFunction

    acc_desc = ValueStateDescriptor("sql_group_acc")

    prev_desc = ValueStateDescriptor("sql_group_prev")

    class GroupAgg(ProcessFunction):
        """Emits the retract-stream protocol: (False, old_row) then
        (True, new_row) per update (GroupAggProcessFunction.scala's
        retract/accumulate pair; first result for a key emits only the
        accumulate side)."""

        def process_element(self, value, ctx, out):
            st = ctx.get_state(acc_desc)
            acc = st.value()
            if acc is None:
                acc = composite.create_accumulator()
            acc = composite.add(value, acc)
            st.update(acc)
            aggs = composite.get_result(acc)
            key = ctx.get_current_key()
            if n_keys == 0:
                key_t = ()
            elif n_keys == 1:
                key_t = (key,)
            else:
                key_t = key
            row = (*key_t, *aggs)
            out_row = tuple(f(row) for f in out_fns)
            prev = ctx.get_state(prev_desc)
            old = prev.value()
            if old is not None:
                out.collect((False, old))
            out.collect((True, out_row))
            prev.update(out_row)

    def key_selector(row):
        ks = tuple(f(row) for f in key_fns)
        return ks if len(ks) != 1 else ks[0]

    pairs = (table.stream.key_by(key_selector if keys
                                 else (lambda row: 0))
             .process(GroupAgg(), name="sql_group_agg"))
    # append view: the accumulate side only (the upsert stream — last
    # row per key wins, exactly the pre-retraction behavior)
    out = pairs.filter(lambda p: p[0], name="sql_group_adds") \
               .map(lambda p: p[1], name="sql_group_rows")
    t = Table(t_env, out, Schema(out_names))
    t._retract_stream = pairs
    t._updating = True
    return t


# ---------------------------------------------------------------------
# stream-stream join lowering (ref: the Table layer's windowed join —
# plan/nodes/datastream/DataStreamWindowJoin.scala with
# WindowJoinUtil.scala's time-bound analysis)
# ---------------------------------------------------------------------

def _flatten_and(e: Expr):
    e = strip_alias(e)
    if isinstance(e, BinaryOp) and e.op == "AND":
        return _flatten_and(e.left) + _flatten_and(e.right)
    return [e]


def _linear(e: Expr):
    """expr -> (coeffs {col: +/-1}, const_ms) for +/- trees of columns
    and numeric literals; None when non-linear."""
    e = strip_alias(e)
    if isinstance(e, Column):
        return {e.name: 1}, 0
    if isinstance(e, Literal) and isinstance(e.value, (int, float)) \
            and not isinstance(e.value, bool):
        return {}, e.value
    if isinstance(e, UnaryOp) and e.op == "-":
        r = _linear(e.operand)
        if r is None:
            return None
        return {k: -v for k, v in r[0].items()}, -r[1]
    if isinstance(e, BinaryOp) and e.op in ("+", "-"):
        l, r = _linear(e.left), _linear(e.right)
        if l is None or r is None:
            return None
        sign = 1 if e.op == "+" else -1
        coeffs = dict(l[0])
        for k, v in r[0].items():
            coeffs[k] = coeffs.get(k, 0) + sign * v
            if coeffs[k] == 0:
                del coeffs[k]
        return coeffs, l[1] + sign * r[1]
    return None


def _lower_join(t_env: "StreamTableEnvironment", q) -> Table:
    """FROM a JOIN b ON a.k = b.k AND a.ts BETWEEN b.ts - X AND
    b.ts + Y → the interval join operator (equal keys, r.ts - l.ts in
    [lower, upper]); residual conjuncts become a post-join filter.
    The joined schema qualifies every field with its table alias and
    keeps unqualified names that are unambiguous."""
    if q.join.table not in t_env.tables:
        raise SqlError(f"unknown table {q.join.table!r}")
    left_src = t_env.tables[q.table]
    right_src = t_env.tables[q.join.table]
    la = q.table_alias or q.table
    ra = q.join.alias
    lf, rf = left_src.schema.fields, right_src.schema.fields

    # name -> (side, position); qualified always, unqualified if unique
    resolve: Dict[str, tuple] = {}
    for i, f in enumerate(lf):
        resolve[f"{la}.{f}"] = ("l", i)
    for i, f in enumerate(rf):
        resolve[f"{ra}.{f}"] = ("r", i)
    for i, f in enumerate(lf):
        if f not in rf:
            resolve.setdefault(f, ("l", i))
    for i, f in enumerate(rf):
        if f not in lf:
            resolve.setdefault(f, ("r", i))

    def side_of(name):
        if name not in resolve:
            raise SqlError(f"unknown or ambiguous join column {name!r}")
        return resolve[name]

    l_rt = getattr(left_src, "rowtime", None)
    r_rt = getattr(right_src, "rowtime", None)
    rt_names = set()
    if l_rt is not None:
        rt_names.update({l_rt, f"{la}.{l_rt}"})
    if r_rt is not None:
        rt_names.update({r_rt, f"{ra}.{r_rt}"})

    equi_l: List[int] = []
    equi_r: List[int] = []
    lower = upper = None
    residual: List[Expr] = []
    for conj in _flatten_and(q.join.on):
        handled = False
        if isinstance(conj, BinaryOp) and conj.op in (
                "=", "<", "<=", ">", ">="):
            ll = _linear(conj.left)
            rr = _linear(conj.right)
            if ll is not None and rr is not None:
                coeffs = dict(ll[0])
                for k, v in rr[0].items():
                    coeffs[k] = coeffs.get(k, 0) - v
                    if coeffs[k] == 0:
                        del coeffs[k]
                const = ll[1] - rr[1]     # coeffs . cols + const OP 0
                cols = list(coeffs)
                if (conj.op == "=" and len(cols) == 2 and const == 0
                        and not any(c in rt_names for c in cols)):
                    (s1, p1), (s2, p2) = side_of(cols[0]), side_of(cols[1])
                    if {coeffs[cols[0]], coeffs[cols[1]]} == {1, -1} \
                            and {s1, s2} == {"l", "r"}:
                        if s1 == "l":
                            equi_l.append(p1)
                            equi_r.append(p2)
                        else:
                            equi_l.append(p2)
                            equi_r.append(p1)
                        handled = True
                elif (len(cols) == 2
                      and all(c in rt_names for c in cols)
                      and {coeffs[cols[0]], coeffs[cols[1]]} == {1, -1}
                      and {side_of(cols[0])[0],
                           side_of(cols[1])[0]} == {"l", "r"}):
                    # normalize to d = r.ts - l.ts:  d OP bound
                    c_l = next(coeffs[c] for c in cols
                               if side_of(c)[0] == "l")
                    # c_l*l + c_r*r + const OP 0; c_r = -c_l
                    # c_l = +1:  l - r + const OP 0  ->  d INV(OP) const
                    # c_l = -1:  r - l + const OP 0  ->  d OP -const
                    if c_l == 1:
                        op = {"<": ">", "<=": ">=",
                              ">": "<", ">=": "<="}[conj.op] \
                            if conj.op != "=" else "="
                        bound = const
                    else:
                        op = conj.op
                        bound = -const
                    if op in (">=", ">"):
                        lo = bound if op == ">=" else bound + 1
                        lower = lo if lower is None else max(lower, lo)
                    elif op in ("<=", "<"):
                        hi = bound if op == "<=" else bound - 1
                        upper = hi if upper is None else min(upper, hi)
                    else:  # d = bound
                        lower = upper = bound
                    handled = True
        if not handled:
            residual.append(conj)
    if not equi_l:
        raise SqlError(
            "streaming join needs at least one equi-key conjunct "
            "(a.k = b.k)")
    if lower is None or upper is None:
        raise SqlError(
            "streaming join needs a rowtime bound, e.g. "
            "a.ts BETWEEN b.ts - INTERVAL '5' SECOND AND "
            "b.ts + INTERVAL '5' SECOND "
            "(unbounded stream joins would hold infinite state)")

    el, er = list(equi_l), list(equi_r)
    fields = [f"{la}.{f}" for f in lf] + [f"{ra}.{f}" for f in rf]

    def _joined_schema():
        schema = Schema(fields)
        # unqualified access for unambiguous names
        for i, f in enumerate(lf):
            if f not in rf:
                schema.index.setdefault(f, i)
        for i, f in enumerate(rf):
            if f not in lf:
                schema.index.setdefault(f, len(lf) + i)
        return schema

    # columnar fast path: both sides columnar, one equi key, no
    # residual — the vectorized hash-join operator keeps RecordBatches
    # end to end (the "windowed join on the columnar tier")
    if (not residual and len(el) == 1
            and getattr(left_src, "columnar", False)
            and getattr(right_src, "columnar", False)
            and left_src.stream.env.parallelism == 1):
        from flink_tpu_torch.streaming.columnar import (
            ColumnarIntervalJoinOperator,
        )
        key_l, key_r = lf[el[0]], rf[er[0]]
        tagged_l = left_src.stream.map(lambda b: (0, b),
                                       name="cj_tag_left")
        tagged_r = right_src.stream.map(lambda b: (1, b),
                                        name="cj_tag_right")
        unioned = tagged_l.union(tagged_r)
        out_l = [(f"{la}.{f}", f) for f in lf]
        out_r = [(f"{ra}.{f}", f) for f in rf]

        def factory(key_l=key_l, key_r=key_r, lower=int(lower),
                    upper=int(upper), out_l=tuple(out_l),
                    out_r=tuple(out_r)):
            return ColumnarIntervalJoinOperator(key_l, key_r, lower,
                                                upper, out_l, out_r)

        out = unioned._add_op("columnar_interval_join", factory,
                              parallelism=1)
        t = Table(t_env, out, _joined_schema())
        t.columnar = True
        t.rowtime = f"{la}.{l_rt}" if l_rt else None
        return t

    left = left_src._as_rows()
    right = right_src._as_rows()

    def ksl(row):
        ks = tuple(row[p] for p in el)
        return ks if len(ks) != 1 else ks[0]

    def ksr(row):
        ks = tuple(row[p] for p in er)
        return ks if len(ks) != 1 else ks[0]

    out = (left.stream.interval_join(right.stream)
           .where(ksl).equal_to(ksr)
           .between(int(lower), int(upper))
           .apply(lambda l, r: (*l, *r), name="sql_interval_join"))
    t = Table(t_env, out, _joined_schema())
    t.rowtime = f"{la}.{l_rt}" if l_rt else None
    for conj in residual:
        t = t.filter(conj)
    return t


# ---------------------------------------------------------------------
# OVER window lowering (ref: DataStreamOverAggregate.scala ->
# RowTimeBoundedRowsOver.scala / RowTimeBoundedRangeOver.scala)
# ---------------------------------------------------------------------

def _lower_over_agg(table: Table, select: List[Expr]) -> Table:
    """Per-row bounded trailing aggregation: key by PARTITION BY, park
    rows until the watermark passes their timestamp, then emit — in
    timestamp order — the input row extended with each OVER agg
    computed over its trailing frame (ROWS n / RANGE t PRECEDING)."""
    table = table._as_rows()
    t_env = table.t_env
    schema = table.schema

    overs: List[OverCall] = []
    for e in select:
        for o in find_overs(e):
            if not any(o is x for x in overs):
                overs.append(o)
    spec = overs[0]
    if any(o.spec_key() != spec.spec_key() for o in overs):
        raise SqlError(
            "all OVER aggregates in one query must share the same "
            "window spec (the reference's single-over rule)")
    schema.pos(spec.order_by)  # ORDER BY column must exist
    rowtime = getattr(table, "rowtime", None)
    if rowtime is not None and spec.order_by not in (
            rowtime, rowtime.split(".")[-1]):
        # frames advance in event time; ordering by anything else
        # would silently compute rowtime-ordered frames (the
        # reference's restriction: ORDER BY must be the time attr)
        raise SqlError(
            f"OVER ORDER BY must name the rowtime attribute "
            f"{rowtime!r}, got {spec.order_by!r}")
    part_fns = [t_env._expr(p).compile(schema) for p in spec.partition_by]
    parts, _ = _build_agg_parts(
        t_env, [o.agg for o in overs], schema)

    # post-row = input row + one result column per OverCall
    over_index = {id(o): i for i, o in enumerate(overs)}
    post_fields = list(schema.fields) + [f"__o{i}"
                                         for i in range(len(overs))]
    post_schema = Schema(post_fields)
    n_in = len(schema.fields)

    def remap(e):
        if isinstance(e, OverCall):
            return Column(f"__o{over_index[id(e)]}")
        return None

    out_fns = [substitute(strip_alias(e), remap).compile(post_schema)
               for e in select]
    out_names = output_names(select)

    from flink_tpu_torch.core.state import ValueStateDescriptor
    from flink_tpu_torch.streaming.operators import ProcessFunction

    pending_desc = ValueStateDescriptor("over_pending")
    frame_desc = ValueStateDescriptor("over_frame")
    mode, preceding = spec.mode, spec.preceding

    class OverAgg(ProcessFunction):
        def process_element(self, value, ctx, out):
            ts = ctx.timestamp()
            if ts is None:
                raise SqlError("OVER window needs event-time records")
            if ts <= ctx.current_watermark():
                return  # late row: the frame already advanced past it
            st = ctx.get_state(pending_desc)
            pend = st.value() or {}
            pend.setdefault(ts, []).append(value)
            st.update(pend)
            ctx.register_event_time_timer(ts)

        def on_timer(self, timestamp, ctx, out):
            st = ctx.get_state(pending_desc)
            pend = st.value()
            if not pend or timestamp not in pend:
                return
            rows = pend.pop(timestamp)
            st.update(pend)
            fst = ctx.get_state(frame_desc)
            frame = fst.value() or []        # [(ts, row)] emitted
            out.set_absolute_timestamp(timestamp)
            for row in rows:
                frame.append((timestamp, row))
                if mode == "rows":
                    if len(frame) > preceding + 1:
                        del frame[:len(frame) - (preceding + 1)]
                else:
                    lo = timestamp - preceding
                    k = 0
                    while k < len(frame) and frame[k][0] < lo:
                        k += 1
                    if k:
                        del frame[:k]
                # recompute each agg over the frame (the reference
                # retracts incrementally — accumulate/retract; the
                # recompute is exact for any UDAF without a retract
                # method, and the ROWS frame is bounded by n)
                results = []
                for agg, input_fn in parts:
                    acc = agg.create_accumulator()
                    for _t, r in frame:
                        acc = agg.add(input_fn(r), acc)
                    results.append(agg.get_result(acc))
                post = (*row, *results)
                out.collect(tuple(f(post) for f in out_fns))
            fst.update(frame)

    def key_selector(row):
        ks = tuple(f(row) for f in part_fns)
        return ks if len(ks) != 1 else (ks[0] if ks else 0)

    keyed = table.stream.key_by(key_selector if part_fns
                                else (lambda row: 0))
    out = keyed.process(OverAgg(), name="sql_over_agg")
    return Table(t_env, out, Schema(out_names))


# ---------------------------------------------------------------------
# LATERAL TABLE (UDTF) + ORDER BY / LIMIT lowering
# ---------------------------------------------------------------------

def _lower_lateral(t_env: StreamTableEnvironment, table: Table,
                   lat: LateralCall) -> Table:
    """`FROM t, LATERAL TABLE(fn(args)) AS s(cols...)` — cross-apply
    the registered TableFunction to every row; output rows are the
    input row extended with the UDTF's columns (ref: the reference's
    LogicalTableFunctionScan over TableFunction.scala:69-90)."""
    factory = t_env.udtfs.get(lat.fn.upper())
    if factory is None:
        raise SqlError(f"unknown table function {lat.fn!r} "
                       "(register_table_function first)")
    table = table._as_rows()
    schema = table.schema
    arg_fns = [t_env._expr(a).compile(schema) for a in lat.args]
    fn = factory()
    col_names = lat.col_names or [lat.alias]

    def apply(row, fn=fn, arg_fns=arg_fns, width=len(col_names)):
        args = [f(row) for f in arg_fns]
        for out in fn.eval(*args):
            if width == 1 and not isinstance(out, tuple):
                yield (*row, out)
            else:
                out_t = tuple(out) if not isinstance(out, tuple) else out
                if len(out_t) != width:
                    raise SqlError(
                        f"table function {lat.fn} yielded {len(out_t)} "
                        f"columns, alias declares {width}")
                yield (*row, *out_t)

    out = table.stream.flat_map(apply, name=f"lateral_{lat.fn}")
    t = Table(t_env, out,
              Schema(list(schema.fields) + list(col_names)))
    t.rowtime = getattr(table, "rowtime", None)
    return t


def _lower_order_limit(table: Table, order_by, limit) -> Table:
    """ORDER BY / LIMIT on a streaming result.

    - no ORDER BY, no LIMIT: pass through;
    - LIMIT n alone: emit the first n rows (append-only);
    - ORDER BY rowtime [secondary keys] [LIMIT n]: event-time sort —
      rows buffer until the watermark passes them, then emit in
      (time, keys) order (the reference's streaming-sort rule: the
      primary sort key must be the time attribute ascending);
    - ORDER BY anything else + LIMIT n: continuous Top-N — an
      updating result maintained over the whole stream, consumed via
      to_retract_stream (ref: the reference's streaming ORDER BY
      restriction + the Blink Top-N pattern);
    - ORDER BY anything else without LIMIT: rejected (unbounded
      full-history sort on an unbounded stream)."""
    if not order_by and limit is None:
        return table
    table = table._as_rows()
    t_env = table.t_env
    schema = table.schema
    if not order_by:
        # LIMIT alone: first-n (parallelism 1 so the count is global;
        # the emitted count is operator state so a restore does not
        # re-open the quota)
        from flink_tpu_torch.streaming.operators import StreamOperator

        class FirstN(StreamOperator):
            def __init__(self):
                super().__init__()
                self._n = 0

            def process_element(self, record):
                if self._n < limit:
                    self._n += 1
                    self.output.collect(record)

            def snapshot_state(self, checkpoint_id=None):
                snap = super().snapshot_state(checkpoint_id)
                snap["limit_emitted"] = self._n
                return snap

            def restore_state(self, snapshots):
                super().restore_state(snapshots)
                for s in snapshots:
                    self._n += s.get("limit_emitted", 0)

        out = table.stream._add_op("sql_limit", FirstN, parallelism=1)
        t = Table(t_env, out, schema)
        t.rowtime = getattr(table, "rowtime", None)
        return t

    rowtime = getattr(table, "rowtime", None)
    first_expr, first_desc = order_by[0]
    time_leading = (rowtime is not None and not first_desc
                    and isinstance(first_expr, Column)
                    and first_expr.name in (rowtime,
                                            rowtime.split(".")[-1]))
    if time_leading:
        key_fns = [t_env._expr(e).compile(schema) for e, _ in order_by]
        descs = [d for _, d in order_by]
        return _lower_event_time_sort(table, key_fns, descs, limit)
    if limit is None:
        raise SqlError(
            "streaming ORDER BY must lead with the rowtime attribute "
            "ascending unless a LIMIT makes it a Top-N")
    key_fns = [t_env._expr(e).compile(schema) for e, _ in order_by]
    descs = [d for _, d in order_by]
    return _lower_top_n(table, key_fns, descs, limit)


def _lower_event_time_sort(table: Table, key_fns, descs, limit) -> Table:
    """Buffer rows until the watermark passes their timestamp, then
    emit in sort order (ref: the reference's streaming sort on a time
    attribute, RowTimeSortOperator)."""
    from flink_tpu_torch.streaming.operators import StreamOperator

    class EventTimeSort(StreamOperator):
        def __init__(self):
            super().__init__()
            self._rows = []      # (ts, row)
            self._emitted = 0

        def process_element(self, record):
            self._rows.append((record.timestamp, record.value))

        def process_watermark(self, watermark):
            wm = watermark.timestamp
            ready = [(t, r) for t, r in self._rows if t <= wm]
            self._rows = [(t, r) for t, r in self._rows if t > wm]
            if ready:
                def sort_key(item):
                    t, r = item
                    return tuple(
                        (_NegWrap(k) if d else k)
                        for k, d in zip(
                            (f(r) for f in key_fns), descs))
                ready.sort(key=sort_key)
                for t, r in ready:
                    if limit is not None and self._emitted >= limit:
                        break
                    self._emitted += 1
                    from flink_tpu_torch.streaming.elements import StreamRecord
                    self.output.collect(StreamRecord(r, timestamp=t))
            self.output.emit_watermark(watermark)

        def snapshot_state(self, checkpoint_id=None):
            snap = super().snapshot_state(checkpoint_id)
            snap["sort_rows"] = list(self._rows)
            snap["sort_emitted"] = self._emitted
            return snap

        def restore_state(self, snapshots):
            super().restore_state(snapshots)
            for s in snapshots:
                self._rows.extend(s.get("sort_rows", ()))
                self._emitted += s.get("sort_emitted", 0)

    out = table.stream._add_op("sql_sort", EventTimeSort,
                               parallelism=1)
    t = Table(table.t_env, out, table.schema)
    t.rowtime = getattr(table, "rowtime", None)
    return t


def _lower_top_n(table: Table, key_fns, descs, limit) -> Table:
    """Continuous Top-N with retractions: the best `limit` rows by the
    sort key, updated as rows arrive; emits (is_add, row) through
    to_retract_stream (the Blink Top-N pattern over the repo's
    retract protocol)."""
    import bisect

    from flink_tpu_torch.streaming.elements import StreamRecord
    from flink_tpu_torch.streaming.operators import StreamOperator

    def sort_key(row):
        return tuple((_NegWrap(k) if d else k)
                     for k, d in zip((f(row) for f in key_fns), descs))

    class TopN(StreamOperator):
        """State (the current best-n) snapshots with checkpoints so a
        restore neither re-adds rows nor loses pending retractions."""

        def __init__(self):
            super().__init__()
            self._heap = []   # (key, row), best first

        def process_element(self, record):
            row = record.value
            heap = self._heap
            key = sort_key(row)
            pos = bisect.bisect_right([e[0] for e in heap], key)
            if len(heap) < limit:
                heap.insert(pos, (key, row))
                self.output.collect(StreamRecord((True, row),
                                                 record.timestamp))
            elif pos < limit:
                evicted = heap.pop()
                heap.insert(pos, (key, row))
                self.output.collect(StreamRecord((False, evicted[1]),
                                                 record.timestamp))
                self.output.collect(StreamRecord((True, row),
                                                 record.timestamp))

        def snapshot_state(self, checkpoint_id=None):
            snap = super().snapshot_state(checkpoint_id)
            snap["top_n_rows"] = [r for _, r in self._heap]
            return snap

        def restore_state(self, snapshots):
            super().restore_state(snapshots)
            for s in snapshots:
                for r in s.get("top_n_rows", ()):
                    self._heap.append((sort_key(r), r))
            self._heap.sort(key=lambda e: e[0])
            del self._heap[limit:]

    out = table.stream._add_op("sql_top_n", TopN, parallelism=1)
    t = Table(table.t_env, out, table.schema)
    t._retract_stream = out
    t._updating = True
    return t


class _NegWrap:
    """Descending-order wrapper for non-numeric sort keys."""

    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def __lt__(self, other):
        return other.v < self.v

    def __eq__(self, other):
        return self.v == other.v
