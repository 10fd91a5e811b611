"""Minimal SQL parser for the streaming Table layer (port of
``flink_tpu/table/sql_parser.py``).

The role Calcite's parser/validator plays in the reference
(flink-libraries/flink-table — `TableEnvironment.sqlQuery` :578): a
hand-rolled tokenizer + recursive-descent parser for the supported
streaming subset:

    SELECT <exprs> FROM <table>
      [WHERE <predicate>]
      [GROUP BY <group items>]          -- items may include
                                        -- TUMBLE/HOP/SESSION(ts, ...)
      [HAVING <predicate>]

with expressions (+ - * / %, comparisons, AND/OR/NOT, parentheses,
literals incl. INTERVAL '<n>' <unit>), scalar functions, and aggregate
calls COUNT([DISTINCT] x | *), SUM, MIN, MAX, AVG,
APPROX_COUNT_DISTINCT, plus registered UDAFs.  Window properties
TUMBLE_START/TUMBLE_END/HOP_START/HOP_END/SESSION_START/SESSION_END
select the fired window's bounds.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, List, Optional

from flink_tpu_torch.table.expressions import (
    AggCall,
    Alias,
    BinaryOp,
    Column,
    Expr,
    Literal,
    ScalarCall,
    UnaryOp,
    WindowProp,
)

_TOKEN_RE = re.compile(r"""
      (?P<ws>\s+)
    | (?P<number>\d+\.\d+|\d+)
    | (?P<string>'(?:[^']|'')*')
    | (?P<op><>|!=|>=|<=|[=<>+\-*/%(),.])
    | (?P<name>[A-Za-z_][A-Za-z_0-9]*)
""", re.VERBOSE)

_UNITS_MS = {
    "MILLISECOND": 1, "SECOND": 1000, "MINUTE": 60_000,
    "HOUR": 3_600_000, "DAY": 86_400_000,
}

_WINDOW_FNS = {"TUMBLE": "tumble", "HOP": "hop", "SESSION": "session"}
_AGG_FNS = {"COUNT", "SUM", "MIN", "MAX", "AVG", "APPROX_COUNT_DISTINCT"}
_KEYWORDS = {"SELECT", "FROM", "WHERE", "GROUP", "BY", "HAVING", "AS",
             "AND", "OR", "NOT", "DISTINCT", "INTERVAL", "NULL", "TRUE",
             "FALSE", "JOIN", "ON", "OVER", "PARTITION", "ORDER", "ROWS",
             "RANGE", "BETWEEN", "PRECEDING", "CURRENT", "ROW",
             "INSERT", "INTO", "UNION", "ALL", "LATERAL", "TABLE",
             "ASC", "DESC", "LIMIT"}


@dataclass
class WindowSpec:
    kind: str                 # tumble | hop | session
    time_col: str
    size_ms: Optional[int] = None     # tumble/hop
    slide_ms: Optional[int] = None    # hop
    gap_ms: Optional[int] = None      # session


@dataclass
class JoinClause:
    """FROM a [AS x] JOIN b [AS y] ON <condition> (streaming interval
    join: the condition must carry equi-key conjuncts plus a time
    bound on the two rowtimes — analyzed by the planner)."""
    table: str
    alias: str
    on: Expr


@dataclass
class LateralCall:
    """`, LATERAL TABLE(fn(args)) AS alias(col, ...)` — a UDTF
    cross-apply in the FROM clause (ref: the reference's
    LogicalTableFunctionScan / UserDefinedTableFunction path,
    flink-table/.../functions/TableFunction.scala)."""
    fn: str
    args: List[Expr]
    alias: str
    col_names: List[str]


@dataclass
class Query:
    select: List[Expr]
    #: source table name, or a nested Query/UnionQuery (subquery in
    #: FROM — ref TableEnvironment.scala's sqlQuery over views)
    table: Any
    where: Optional[Expr] = None
    group_by: List[Expr] = field(default_factory=list)
    window: Optional[WindowSpec] = None
    having: Optional[Expr] = None
    table_alias: Optional[str] = None
    join: Optional[JoinClause] = None
    laterals: List[LateralCall] = field(default_factory=list)
    order_by: List[tuple] = field(default_factory=list)  # (Expr, desc)
    limit: Optional[int] = None


@dataclass
class UnionQuery:
    """`q1 UNION ALL q2 [UNION ALL ...]` (ref Table.unionAll /
    TableEnvironment UNION planning)."""
    queries: List[Query]
    order_by: List[tuple] = field(default_factory=list)
    limit: Optional[int] = None


@dataclass
class InsertStatement:
    """`INSERT INTO sink <query>` — the SQL write path
    (ref: TableEnvironment.sqlUpdate, TableEnvironment.scala:614)."""
    target: str
    query: Any  # Query | UnionQuery


class SqlError(ValueError):
    pass


class _Tokens:
    def __init__(self, sql: str):
        self.toks: List[tuple] = []
        pos = 0
        while pos < len(sql):
            m = _TOKEN_RE.match(sql, pos)
            if m is None:
                raise SqlError(f"cannot tokenize at: {sql[pos:pos+20]!r}")
            pos = m.end()
            kind = m.lastgroup
            if kind == "ws":
                continue
            text = m.group()
            if kind == "name" and text.upper() in _KEYWORDS:
                self.toks.append(("kw", text.upper()))
            else:
                self.toks.append((kind, text))
        self.i = 0

    def peek(self, k=0):
        return self.toks[self.i + k] if self.i + k < len(self.toks) else (None, None)

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def accept(self, kind, text=None):
        k, t = self.peek()
        if k == kind and (text is None or t == text):
            self.i += 1
            return t
        return None

    def expect(self, kind, text=None):
        got = self.accept(kind, text)
        if got is None:
            raise SqlError(f"expected {text or kind}, got {self.peek()}")
        return got

    @property
    def done(self):
        return self.i >= len(self.toks)


def parse(sql: str, udaf_names=()):
    """Parse one SELECT statement (possibly a UNION ALL chain with a
    trailing ORDER BY / LIMIT).  Returns Query or UnionQuery."""
    tk = _Tokens(sql)
    udafs = {n.upper() for n in udaf_names}
    q = _parse_union(tk, udafs)
    if not tk.done:
        raise SqlError(f"unexpected trailing tokens: {tk.peek()}")
    return q


def parse_statement(sql: str, udaf_names=()):
    """Parse a top-level statement: SELECT ... (Query | UnionQuery)
    or INSERT INTO sink SELECT ... (InsertStatement)."""
    tk = _Tokens(sql)
    udafs = {n.upper() for n in udaf_names}
    if tk.accept("kw", "INSERT"):
        tk.expect("kw", "INTO")
        target = tk.expect("name")
        q = _parse_union(tk, udafs)
        if not tk.done:
            raise SqlError(f"unexpected trailing tokens: {tk.peek()}")
        return InsertStatement(target=target, query=q)
    q = _parse_union(tk, udafs)
    if not tk.done:
        raise SqlError(f"unexpected trailing tokens: {tk.peek()}")
    return q


def _parse_union(tk: _Tokens, udafs):
    queries = [_parse_query(tk, udafs)]
    while tk.accept("kw", "UNION"):
        if not tk.accept("kw", "ALL"):
            raise SqlError(
                "streaming UNION requires ALL (distinct UNION would "
                "need a retracting dedup; use UNION ALL)")
        queries.append(_parse_query(tk, udafs))
    order_by, limit = _parse_order_limit(tk, udafs)
    if len(queries) == 1:
        q = queries[0]
        q.order_by, q.limit = order_by, limit
        return q
    return UnionQuery(queries=queries, order_by=order_by, limit=limit)


def _parse_order_limit(tk: _Tokens, udafs):
    order_by: List[tuple] = []
    limit = None
    if tk.accept("kw", "ORDER"):
        tk.expect("kw", "BY")
        while True:
            e = _parse_expr(tk, udafs)
            desc = False
            if tk.accept("kw", "DESC"):
                desc = True
            else:
                tk.accept("kw", "ASC")
            order_by.append((e, desc))
            if not tk.accept("op", ","):
                break
    if tk.accept("kw", "LIMIT"):
        limit = int(tk.expect("number"))
    return order_by, limit


def _parse_from_item(tk: _Tokens, udafs):
    """table-name | ( subquery ) — with optional alias."""
    if tk.accept("op", "("):
        sub = _parse_union(tk, udafs)
        tk.expect("op", ")")
        table = sub
    else:
        table = tk.expect("name")
    alias = None
    if tk.accept("kw", "AS"):
        alias = tk.expect("name")
    elif tk.peek()[0] == "name":
        alias = tk.next()[1]
    return table, alias


def _parse_query(tk: _Tokens, udafs) -> Query:
    tk.expect("kw", "SELECT")
    select = [_parse_select_item(tk, udafs)]
    while tk.accept("op", ","):
        select.append(_parse_select_item(tk, udafs))
    tk.expect("kw", "FROM")
    table, table_alias = _parse_from_item(tk, udafs)
    laterals: List[LateralCall] = []
    while tk.peek() == ("op", ",") and tk.peek(1) == ("kw", "LATERAL"):
        tk.next()
        tk.expect("kw", "LATERAL")
        tk.expect("kw", "TABLE")
        tk.expect("op", "(")
        fn = tk.expect("name")
        tk.expect("op", "(")
        args: List[Expr] = []
        if tk.peek() != ("op", ")"):
            args.append(_parse_expr(tk, udafs))
            while tk.accept("op", ","):
                args.append(_parse_expr(tk, udafs))
        tk.expect("op", ")")
        tk.expect("op", ")")
        alias = fn
        col_names: List[str] = []
        if tk.accept("kw", "AS"):
            alias = tk.expect("name")
            if tk.accept("op", "("):
                col_names.append(tk.expect("name"))
                while tk.accept("op", ","):
                    col_names.append(tk.expect("name"))
                tk.expect("op", ")")
        laterals.append(LateralCall(fn=fn, args=args, alias=alias,
                                    col_names=col_names))
    join = None
    if tk.accept("kw", "JOIN"):
        jt = tk.expect("name")
        jalias = None
        if tk.accept("kw", "AS"):
            jalias = tk.expect("name")
        elif tk.peek()[0] == "name":
            jalias = tk.next()[1]
        tk.expect("kw", "ON")
        on = _parse_expr(tk, udafs)
        join = JoinClause(table=jt, alias=jalias or jt, on=on)
    where = None
    if tk.accept("kw", "WHERE"):
        where = _parse_expr(tk, udafs)
    group_by: List[Expr] = []
    window = None
    if tk.accept("kw", "GROUP"):
        tk.expect("kw", "BY")
        while True:
            k, t = tk.peek()
            if k == "name" and t.upper() in _WINDOW_FNS and \
                    tk.peek(1) == ("op", "("):
                if window is not None:
                    raise SqlError("only one group window supported")
                window = _parse_window(tk)
            else:
                group_by.append(_parse_expr(tk, udafs))
            if not tk.accept("op", ","):
                break
    having = None
    if tk.accept("kw", "HAVING"):
        having = _parse_expr(tk, udafs)
    return Query(select=select, table=table, where=where,
                 group_by=group_by, window=window, having=having,
                 table_alias=table_alias, join=join, laterals=laterals)


def _parse_window(tk: _Tokens) -> WindowSpec:
    _, name = tk.next()
    kind = _WINDOW_FNS[name.upper()]
    tk.expect("op", "(")
    time_col = tk.expect("name")
    tk.expect("op", ",")
    first = _parse_interval(tk)
    spec = WindowSpec(kind=kind, time_col=time_col)
    if kind == "tumble":
        spec.size_ms = first
    elif kind == "session":
        spec.gap_ms = first
    else:  # hop(ts, slide, size) — Calcite's HOP argument order
        tk.expect("op", ",")
        second = _parse_interval(tk)
        spec.slide_ms = first
        spec.size_ms = second
    tk.expect("op", ")")
    return spec


def _parse_interval(tk: _Tokens) -> int:
    tk.expect("kw", "INTERVAL")
    text = tk.expect("string")
    value = float(text[1:-1].replace("''", "'"))
    _, unit = tk.next()
    unit = (unit or "").upper().rstrip("S") + ""
    if unit not in _UNITS_MS:
        raise SqlError(f"unsupported interval unit {unit!r}")
    return int(value * _UNITS_MS[unit])


def _parse_select_item(tk: _Tokens, udafs) -> Expr:
    e = _parse_expr(tk, udafs)
    if tk.accept("kw", "AS"):
        e = Alias(e, tk.expect("name"))
    else:
        k, t = tk.peek()
        if k == "name":  # implicit alias
            tk.next()
            e = Alias(e, t)
    return e


# precedence-climbing expression parser
def _parse_expr(tk, udafs) -> Expr:
    return _parse_or(tk, udafs)


def _parse_or(tk, udafs) -> Expr:
    e = _parse_and(tk, udafs)
    while tk.accept("kw", "OR"):
        e = BinaryOp("OR", e, _parse_and(tk, udafs))
    return e


def _parse_and(tk, udafs) -> Expr:
    e = _parse_not(tk, udafs)
    while tk.accept("kw", "AND"):
        e = BinaryOp("AND", e, _parse_not(tk, udafs))
    return e


def _parse_not(tk, udafs) -> Expr:
    if tk.accept("kw", "NOT"):
        return UnaryOp("NOT", _parse_not(tk, udafs))
    return _parse_cmp(tk, udafs)


def _parse_cmp(tk, udafs) -> Expr:
    e = _parse_add(tk, udafs)
    k, t = tk.peek()
    if k == "op" and t in ("=", "<>", "!=", "<", "<=", ">", ">="):
        tk.next()
        e = BinaryOp(t, e, _parse_add(tk, udafs))
    elif k == "kw" and t == "BETWEEN":
        # e BETWEEN lo AND hi -> (e >= lo) AND (e <= hi); the inner
        # AND binds to the BETWEEN, not the boolean layer
        tk.next()
        lo = _parse_add(tk, udafs)
        tk.expect("kw", "AND")
        hi = _parse_add(tk, udafs)
        e = BinaryOp("AND", BinaryOp(">=", e, lo), BinaryOp("<=", e, hi))
    return e


def _parse_add(tk, udafs) -> Expr:
    e = _parse_mul(tk, udafs)
    while True:
        k, t = tk.peek()
        if k == "op" and t in ("+", "-"):
            tk.next()
            e = BinaryOp(t, e, _parse_mul(tk, udafs))
        else:
            return e


def _parse_mul(tk, udafs) -> Expr:
    e = _parse_unary(tk, udafs)
    while True:
        k, t = tk.peek()
        if k == "op" and t in ("*", "/", "%"):
            tk.next()
            e = BinaryOp(t, e, _parse_unary(tk, udafs))
        else:
            return e


def _parse_unary(tk, udafs) -> Expr:
    if tk.accept("op", "-"):
        return UnaryOp("-", _parse_unary(tk, udafs))
    return _parse_atom(tk, udafs)


def _parse_atom(tk, udafs) -> Expr:
    k, t = tk.peek()
    if k == "op" and t == "(":
        tk.next()
        e = _parse_expr(tk, udafs)
        tk.expect("op", ")")
        return e
    if k == "number":
        tk.next()
        return Literal(float(t) if "." in t else int(t))
    if k == "string":
        tk.next()
        return Literal(t[1:-1].replace("''", "'"))
    if k == "kw" and t in ("TRUE", "FALSE", "NULL"):
        tk.next()
        return Literal({"TRUE": True, "FALSE": False, "NULL": None}[t])
    if k == "kw" and t == "INTERVAL":
        # interval literal in expression position (join time bounds:
        # b.ts - INTERVAL '5' SECOND); value = milliseconds
        return Literal(_parse_interval(tk))
    if k == "name":
        name = t
        upper = name.upper()
        if tk.peek(1) == ("op", "."):
            # qualified column: alias.field (join queries)
            tk.next()
            tk.next()
            fieldname = tk.expect("name")
            return Column(f"{name}.{fieldname}")
        if tk.peek(1) == ("op", "("):
            tk.next()
            tk.next()  # (
            # window properties
            for prefix in ("TUMBLE", "HOP", "SESSION"):
                if upper == f"{prefix}_START" or upper == f"{prefix}_END":
                    _skip_call_args(tk)
                    return WindowProp(
                        "start" if upper.endswith("START") else "end")
            distinct = tk.accept("kw", "DISTINCT") is not None
            args: List[Expr] = []
            if tk.accept("op", "*"):
                pass  # COUNT(*)
            elif tk.peek() != ("op", ")"):
                args.append(_parse_expr(tk, udafs))
                while tk.accept("op", ","):
                    args.append(_parse_expr(tk, udafs))
            tk.expect("op", ")")
            if upper in _AGG_FNS or upper in udafs:
                agg = AggCall(upper, args, distinct=distinct)
                if tk.accept("kw", "OVER"):
                    return _parse_over(tk, udafs, agg)
                return agg
            return ScalarCall(upper, args)
        tk.next()
        return Column(name)
    raise SqlError(f"unexpected token {tk.peek()}")


def _parse_over(tk: _Tokens, udafs, agg: AggCall):
    """OVER (PARTITION BY e[, e..] ORDER BY col
    ROWS BETWEEN <n> PRECEDING AND CURRENT ROW |
    RANGE BETWEEN INTERVAL '..' unit PRECEDING AND CURRENT ROW)
    (the reference's bounded streaming OVER shapes:
    RowTimeBoundedRowsOver / RowTimeBoundedRangeOver)."""
    from flink_tpu_torch.table.expressions import OverCall
    tk.expect("op", "(")
    partition: List[Expr] = []
    if tk.accept("kw", "PARTITION"):
        tk.expect("kw", "BY")
        partition.append(_parse_expr(tk, udafs))
        while tk.accept("op", ","):
            partition.append(_parse_expr(tk, udafs))
    tk.expect("kw", "ORDER")
    tk.expect("kw", "BY")
    order_col = tk.expect("name")
    if tk.accept("op", "."):
        order_col = f"{order_col}.{tk.expect('name')}"
    k, t = tk.peek()
    if k == "kw" and t == "ROWS":
        tk.next()
        tk.expect("kw", "BETWEEN")
        num = tk.expect("number")
        if "." in num:
            raise SqlError("ROWS frame size must be an integer")
        preceding = int(num)
        mode = "rows"
    elif k == "kw" and t == "RANGE":
        tk.next()
        tk.expect("kw", "BETWEEN")
        preceding = _parse_interval(tk)
        mode = "range"
    else:
        raise SqlError(
            "OVER window needs ROWS or RANGE BETWEEN ... PRECEDING "
            "AND CURRENT ROW (unbounded OVER is not supported)")
    tk.expect("kw", "PRECEDING")
    tk.expect("kw", "AND")
    tk.expect("kw", "CURRENT")
    tk.expect("kw", "ROW")
    tk.expect("op", ")")
    return OverCall(agg, partition, order_col, mode, preceding)


def _skip_call_args(tk: _Tokens) -> None:
    depth = 1
    while depth:
        k, t = tk.next()
        if k is None:
            raise SqlError("unterminated call")
        if (k, t) == ("op", "("):
            depth += 1
        elif (k, t) == ("op", ")"):
            depth -= 1
