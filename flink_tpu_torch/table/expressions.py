"""Expression tree for the Table/SQL layer (port of
``flink_tpu/table/expressions.py``).

The role of the reference's Calcite RexNode + code generation
(flink-libraries/flink-table/.../codegen/CodeGenerator.scala): here
expressions compile to plain Python closures over row tuples — the
"codegen" target is a closure the vectorized operators call,
not Janino-compiled Java (ref: TableEnvironment.scala:578 pipeline).

Rows are plain tuples; a Schema maps field names to positions.
"""

from __future__ import annotations

import operator
from typing import Any, Callable, List, Optional, Sequence, Tuple


class Schema:
    def __init__(self, fields: Sequence[str]):
        self.fields = list(fields)
        self.index = {f: i for i, f in enumerate(self.fields)}

    def pos(self, name: str) -> int:
        if name not in self.index:
            raise KeyError(
                f"column {name!r} not in schema {self.fields}")
        return self.index[name]

    def __repr__(self):
        return f"Schema({self.fields})"


class Expr:
    """Base expression node; `compile(schema)` returns row -> value."""

    def compile(self, schema: Schema) -> Callable[[Any], Any]:
        raise NotImplementedError

    # fluent operators (Table API expressions)
    def __add__(self, other):
        return BinaryOp("+", self, lit(other))

    def __sub__(self, other):
        return BinaryOp("-", self, lit(other))

    def __mul__(self, other):
        return BinaryOp("*", self, lit(other))

    def __truediv__(self, other):
        return BinaryOp("/", self, lit(other))

    def __gt__(self, other):
        return BinaryOp(">", self, lit(other))

    def __ge__(self, other):
        return BinaryOp(">=", self, lit(other))

    def __lt__(self, other):
        return BinaryOp("<", self, lit(other))

    def __le__(self, other):
        return BinaryOp("<=", self, lit(other))

    def eq(self, other):
        return BinaryOp("=", self, lit(other))

    def ne(self, other):
        return BinaryOp("<>", self, lit(other))

    def and_(self, other):
        return BinaryOp("AND", self, lit(other))

    def or_(self, other):
        return BinaryOp("OR", self, lit(other))

    def alias(self, name: str) -> "Alias":
        return Alias(self, name)


class Column(Expr):
    def __init__(self, name: str):
        self.name = name

    def compile(self, schema: Schema):
        i = schema.pos(self.name)
        return lambda row: row[i]

    def __repr__(self):
        return f"col({self.name})"


class Literal(Expr):
    def __init__(self, value: Any):
        self.value = value

    def compile(self, schema: Schema):
        v = self.value
        return lambda row: v

    def __repr__(self):
        return f"lit({self.value!r})"


def lit(v) -> Expr:
    return v if isinstance(v, Expr) else Literal(v)


def col(name: str) -> Column:
    return Column(name)


_BIN_OPS = {
    "+": operator.add, "-": operator.sub, "*": operator.mul,
    "/": operator.truediv, "%": operator.mod,
    "=": operator.eq, "<>": operator.ne, "!=": operator.ne,
    ">": operator.gt, ">=": operator.ge,
    "<": operator.lt, "<=": operator.le,
}


class BinaryOp(Expr):
    def __init__(self, op: str, left: Expr, right: Expr):
        self.op = op
        self.left = left
        self.right = right

    def compile(self, schema: Schema):
        lf = self.left.compile(schema)
        rf = self.right.compile(schema)
        if self.op == "AND":
            return lambda row: bool(lf(row)) and bool(rf(row))
        if self.op == "OR":
            return lambda row: bool(lf(row)) or bool(rf(row))
        fn = _BIN_OPS[self.op]
        return lambda row: fn(lf(row), rf(row))

    def __repr__(self):
        return f"({self.left!r} {self.op} {self.right!r})"


class UnaryOp(Expr):
    def __init__(self, op: str, operand: Expr):
        self.op = op
        self.operand = operand

    def compile(self, schema: Schema):
        f = self.operand.compile(schema)
        if self.op == "NOT":
            return lambda row: not f(row)
        if self.op == "-":
            return lambda row: -f(row)
        raise ValueError(self.op)


_SCALAR_FUNCS = {
    "ABS": abs,
    "UPPER": lambda s: s.upper(),
    "LOWER": lambda s: s.lower(),
    "CHAR_LENGTH": len,
    "MOD": operator.mod,
    "POWER": operator.pow,
}


class ScalarCall(Expr):
    """Built-in or registered scalar function call."""

    def __init__(self, name: str, args: List[Expr], fn=None):
        self.name = name.upper()
        self.args = args
        self._fn = fn

    def compile(self, schema: Schema):
        fn = self._fn or _SCALAR_FUNCS.get(self.name)
        if fn is None:
            raise ValueError(f"unknown scalar function {self.name}")
        arg_fns = [a.compile(schema) for a in self.args]
        return lambda row: fn(*(f(row) for f in arg_fns))

    def __repr__(self):
        return f"{self.name}({', '.join(map(repr, self.args))})"


class AggCall(Expr):
    """An aggregate function call site (COUNT/SUM/.../UDAF).  Not
    row-compilable; the planner lowers it onto the window operator."""

    def __init__(self, name: str, args: List[Expr], distinct: bool = False):
        self.name = name.upper()
        self.args = args
        self.distinct = distinct

    def compile(self, schema: Schema):
        raise ValueError(
            f"aggregate {self.name} outside GROUP BY context")

    def __repr__(self):
        d = "DISTINCT " if self.distinct else ""
        return f"{self.name}({d}{', '.join(map(repr, self.args))})"


class OverCall(Expr):
    """agg(...) OVER (PARTITION BY ... ORDER BY rowtime ROWS|RANGE
    BETWEEN <n> PRECEDING AND CURRENT ROW) — per-row aggregation over
    a bounded trailing frame (ref: DataStreamOverAggregate.scala /
    RowTimeBoundedRangeOver.scala, RowTimeBoundedRowsOver.scala).  Not
    row-compilable; the planner lowers the query onto the keyed Over
    process function."""

    def __init__(self, agg: "AggCall", partition_by: List[Expr],
                 order_by: str, mode: str, preceding: int):
        self.agg = agg
        self.partition_by = partition_by
        self.order_by = order_by
        self.mode = mode            # "rows" | "range"
        self.preceding = preceding  # rows count | range ms

    def spec_key(self) -> str:
        """Identity of the window spec (all OverCalls in one query
        must share it — same restriction as the reference's
        DataStreamOverAggregate single-over rule)."""
        return repr((list(map(repr, self.partition_by)), self.order_by,
                     self.mode, self.preceding))

    def compile(self, schema: Schema):
        raise ValueError("OVER aggregate outside the over-window "
                         "lowering")

    def __repr__(self):
        return (f"{self.agg!r} OVER (partition {self.partition_by!r} "
                f"order {self.order_by} {self.mode} {self.preceding})")


class WindowProp(Expr):
    """TUMBLE_START/TUMBLE_END/HOP_*/SESSION_* — resolved by the
    windowed lowering (the window's [start, end))."""

    def __init__(self, kind: str):  # "start" | "end"
        self.kind = kind

    def compile(self, schema: Schema):
        raise ValueError("window property outside a windowed GROUP BY")

    def __repr__(self):
        return f"window_{self.kind}()"


class Alias(Expr):
    def __init__(self, expr: Expr, name: str):
        self.expr = expr
        self.name = name

    def compile(self, schema: Schema):
        return self.expr.compile(schema)

    def __repr__(self):
        return f"{self.expr!r} AS {self.name}"


def output_name(e: Expr, i: int) -> str:
    if isinstance(e, Alias):
        return e.name
    if isinstance(e, Column):
        # a qualified column projects under its simple name
        # (SELECT a.lid -> output column "lid"), as in the reference
        return e.name.split(".")[-1]
    return f"EXPR${i}"


def output_names(exprs: Sequence[Expr]) -> List[str]:
    """Output column names with collision recovery: when stripping
    qualifiers makes two names collide (SELECT a.id, b.id), the later
    ones keep their qualified form instead of silently shadowing."""
    names: List[str] = []
    seen = set()
    for i, e in enumerate(exprs):
        n = output_name(e, i)
        if n in seen:
            inner = strip_alias(e)
            n = inner.name if isinstance(inner, Column) else f"{n}${i}"
        while n in seen:  # pathological: qualified name collides too
            n = f"{n}${i}"
        seen.add(n)
        names.append(n)
    return names


def strip_alias(e: Expr) -> Expr:
    return e.expr if isinstance(e, Alias) else e


def find_aggs(e: Expr) -> List[AggCall]:
    """All AggCall nodes in an expression tree (OVER frames hold
    their own agg — excluded here; see find_overs)."""
    out: List[AggCall] = []

    def walk(x):
        if isinstance(x, OverCall):
            return
        if isinstance(x, AggCall):
            out.append(x)
            return
        for child in _children(x):
            walk(child)

    walk(strip_alias(e))
    return out


def find_overs(e: Expr) -> List[OverCall]:
    out: List[OverCall] = []

    def walk(x):
        if isinstance(x, OverCall):
            out.append(x)
            return
        for child in _children(x):
            walk(child)

    walk(strip_alias(e))
    return out


def _children(e: Expr) -> Tuple[Expr, ...]:
    if isinstance(e, BinaryOp):
        return (e.left, e.right)
    if isinstance(e, UnaryOp):
        return (e.operand,)
    if isinstance(e, (ScalarCall, AggCall)):
        return tuple(e.args)
    if isinstance(e, Alias):
        return (e.expr,)
    return ()


def substitute(e: Expr, mapping) -> Expr:
    """Replace nodes per `mapping(node) -> Optional[Expr]` (pre-order)."""
    r = mapping(e)
    if r is not None:
        return r
    if isinstance(e, Alias):
        return Alias(substitute(e.expr, mapping), e.name)
    if isinstance(e, BinaryOp):
        return BinaryOp(e.op, substitute(e.left, mapping),
                        substitute(e.right, mapping))
    if isinstance(e, UnaryOp):
        return UnaryOp(e.op, substitute(e.operand, mapping))
    if isinstance(e, ScalarCall):
        return ScalarCall(e.name, [substitute(a, mapping) for a in e.args],
                          e._fn)
    return e
