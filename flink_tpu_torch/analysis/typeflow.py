"""Whole-graph column type-flow prover, pass 3 (port of
``flink_tpu/analysis/typeflow.py``; the schemas, verdicts, footprints
and diagnostics are the reference's on the same job).

Propagates a per-edge :class:`ColumnSchema` — value dtype(s), tuple
arity, string columns, timestamp nullability, and ahead-of-time value
ranges — from every source through map/filter/keyBy/window/sink over a
:class:`~flink_tpu_torch.streaming.graph.StreamGraph`, without running the
job.  Source schemas are read straight off
:class:`~flink_tpu_torch.streaming.columnar.VectorizedCollectionSource`
payloads (the columns already exist AOT) or rebuilt from declared
collection elements; UDF output dtypes come from a linear abstract
interpretation of the ``dis`` bytecode that runs ONLY after the
liftability analyzer (pass 2) proved the function branch-free and
fully modelled.

The conservatism contract is the same as pass 2's: any unmodelled
opcode, call, dtype combination, or value range degrades to an
INCONCLUSIVE schema — never to a conclusive verdict the runtime could
contradict.  Conclusive verdicts feed the runtime three ways (all via
:func:`apply_static`, under ``decided_by=static``):

- statically proven map/filter kernels skip the first-batch probe
  (``_ColumnKernelMixin``): the operator is stamped
  ``_static_kernel=True`` and records ``decided_by=static``; the
  output-shape validation stays armed, so a wrong kernel still
  demotes boxed with a recorded reason,
- exchange edges learn their predicted wire-codec tier
  (``StreamEdge.predicted_codec_tier``, carried onto the JobEdge; the
  reference's network channel reads it, the port has none yet),
- device window operators learn their predicted slot count
  (``_predicted_slots``) so engines pre-size instead of grow-doubling:
  on the card the scatter tier then allocates its register file once,
  where it would otherwise copy every row at each doubling
  (``VectorizedTumblingWindows.flush(grow_to=)``); the footprint
  estimate is checked against ``state.backend.tpu.max-device-slots``
  (FT187).

Reading a bounded source ahead of time costs host time: up to
``_MAX_AOT_ROWS`` rows, one key-selector call each for the distinct-key
count.  Above that the source is inconclusive and nothing is pre-sized.

Findings surface as linter diagnostics:

``FT185``  exchange edge conclusively demotes to the pickle wire tier
           (names the column dtype and the operator that forces it)
``FT186``  dtype-overflow hazard in an otherwise liftable kernel
           (int64 wraparound the runtime probe currently catches) —
           the kernel keeps its probe
``FT187``  predicted device state footprint exceeds the configured
           slot budget (the estimate is a LOWER bound: distinct keys
           read AOT from the bounded source, so over-budget here is
           over-budget at runtime)
``FT188``  conclusive schema conflict at a union/merge point
"""

from __future__ import annotations

import dis
import logging
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.analysis.diagnostics import Diagnostics
from flink_tpu_torch.analysis.liftability import (
    LIFTABLE,
    analyze_udf,
    unwrap_udf,
)

log = logging.getLogger("flink_tpu_torch.typeflow")

#: dtype tokens: the vocabulary of the schema lattice
I8, F8, F4, I4, BOOL, STR, OBJ = "i8", "f8", "f4", "i4", "bool", "str", "obj"

#: tokens with a columnar wire tier (netchannel._encode_value_column);
#: everything else rides per-batch pickle
_WIRE_TOKENS = frozenset({I8, F8, STR})

_INT_TOKENS = frozenset({I8, I4})
_FLOAT_TOKENS = frozenset({F8, F4})
_NUMERIC_TOKENS = _INT_TOKENS | _FLOAT_TOKENS

_I64_MIN, _I64_MAX = -(2 ** 63), 2 ** 63 - 1


# ---------------------------------------------------------------------
# schema model
# ---------------------------------------------------------------------


@dataclass(frozen=True)
class Col:
    """One column: name, dtype token, and AOT value bounds (numeric
    columns only; bounds flow through interval arithmetic so the
    prover can rule out int64 wraparound)."""

    name: str
    token: str
    lo: Optional[float] = None
    hi: Optional[float] = None

    def describe(self) -> str:
        return self.token


@dataclass(frozen=True)
class ColumnSchema:
    """The element schema of one edge: column dtypes in order, tuple
    arity (``scalar`` means rows are the single "v" column's cells),
    and timestamp nullability.  ``conclusive=False`` means the prover
    gave up — the runtime probe/codec decides, as today."""

    cols: Tuple[Col, ...] = ()
    ts: str = "none"  # "none" | "all" | "masked"
    conclusive: bool = False
    note: str = ""

    @property
    def scalar(self) -> bool:
        return len(self.cols) == 1 and self.cols[0].name == "v"

    def tokens(self) -> Tuple[str, ...]:
        return tuple(c.token for c in self.cols)

    def describe(self) -> str:
        if not self.conclusive:
            return f"inconclusive ({self.note})" if self.note \
                else "inconclusive"
        if self.scalar:
            body = self.cols[0].token
        else:
            body = "(" + ", ".join(
                f"{c.name}:{c.token}" for c in self.cols) + ")"
        return f"{body} ts={self.ts}"

    def to_dict(self) -> dict:
        return {
            "conclusive": self.conclusive,
            "cols": [{"name": c.name, "dtype": c.token,
                      "lo": c.lo, "hi": c.hi} for c in self.cols],
            "scalar": self.scalar,
            "ts": self.ts,
            "note": self.note,
        }


def _unknown(note: str) -> ColumnSchema:
    return ColumnSchema(conclusive=False, note=note)


def codec_tier(schema: ColumnSchema) -> Tuple[Optional[str], str]:
    """Predicted wire-codec tier for elements of this schema:
    ``("col", "")``, ``("pickle", offending_dtype)``, or
    ``(None, "")`` when the schema is inconclusive."""
    if not schema.conclusive or not schema.cols:
        return None, ""
    for c in schema.cols:
        if c.token not in _WIRE_TOKENS:
            return "pickle", c.token
    return "col", ""


# ---------------------------------------------------------------------
# source schemas (read off the AOT payload)
# ---------------------------------------------------------------------


def _token_of_dtype(dtype) -> str:
    if dtype == np.int64:
        return I8
    if dtype == np.float64:
        return F8
    if dtype == np.float32:
        return F4
    if dtype == np.int32:
        return I4
    if dtype == np.bool_:
        return BOOL
    if dtype == object:
        return STR  # pipeline convention: object columns hold str cells
    return OBJ


def _col_of_array(name: str, arr: np.ndarray) -> Col:
    tok = _token_of_dtype(arr.dtype)
    lo = hi = None
    if tok in _NUMERIC_TOKENS and arr.size:
        lo, hi = float(arr.min()), float(arr.max())
    elif tok in _NUMERIC_TOKENS:
        lo = hi = 0.0
    return Col(name, tok, lo, hi)


def _schema_of_batch(batch) -> ColumnSchema:
    """Schema of a materialized RecordBatch (a vectorized source's
    master batch IS the whole input, so the bounds are exact)."""
    cols = tuple(_col_of_array(name, arr)
                 for name, arr in batch.cols.items())
    if batch.ts is None:
        ts = "none"
    elif batch.ts_mask is not None:
        ts = "masked"
    else:
        ts = "all"
    return ColumnSchema(cols, ts, conclusive=True)


#: AOT row cap for schema/key extraction from declared collections
_MAX_AOT_ROWS = 1 << 20


def _source_schema(op) -> Tuple[ColumnSchema, Optional[Any]]:
    """(schema, source_function_or_None) for a StreamSource.  The
    source function is returned so the footprint pass can read its
    rows for the distinct-key estimate."""
    from flink_tpu_torch.streaming.columnar import (
        ColumnarSource,
        VectorizedCollectionSource,
        batch_from_records,
    )
    from flink_tpu_torch.streaming.sources import FromCollectionSource

    fn = getattr(op, "user_function", None)
    if isinstance(fn, VectorizedCollectionSource):
        if fn._batch is None:
            return _unknown("empty vectorized source"), fn
        return _schema_of_batch(fn._batch), fn
    if isinstance(fn, ColumnarSource):
        cols = tuple(_col_of_array(name, np.asarray(arr))
                     for name, arr in fn.cols.items())
        return ColumnSchema(cols, "all", conclusive=True), fn
    if isinstance(fn, FromCollectionSource):
        items = fn.items
        if not items or len(items) > _MAX_AOT_ROWS:
            return _unknown("collection empty or too large for AOT "
                            "schema"), fn
        if fn.timestamped:
            try:
                raw = [v for v, _ in items]
                ts = [t for _, t in items]
            except Exception:
                return _unknown("malformed (value, ts) pairs"), fn
        else:
            raw, ts = list(items), None
        batch = batch_from_records(raw, ts)
        if batch is None:
            return _unknown("collection does not fit the columnar "
                            "convention"), fn
        return _schema_of_batch(batch), fn
    return _unknown(
        f"source {type(fn).__name__ if fn is not None else '?'} has no "
        f"declared element schema"), fn


# ---------------------------------------------------------------------
# UDF output-dtype inference (linear abstract interpretation)
# ---------------------------------------------------------------------


class _DV:
    """Abstract dtype value on the simulated stack.

    ``tok`` is a dtype token for element-derived columns, "const" for
    a Python constant (value in ``const``), "tuple" for a built tuple
    (``fields``), "obj" for a resolved non-element Python object
    (value in ``const``; used to classify calls), or None = unknown.
    Numeric columns carry interval bounds in (lo, hi)."""

    __slots__ = ("tok", "const", "fields", "lo", "hi")

    def __init__(self, tok=None, const=None, fields=None,
                 lo=None, hi=None):
        self.tok = tok
        self.const = const
        self.fields = fields
        self.lo = lo
        self.hi = hi

    @property
    def is_col(self):
        return self.tok in (I8, F8, F4, I4, BOOL, STR)


def _const_dv(value) -> _DV:
    if type(value) is bool:
        return _DV("const", const=value)
    if type(value) in (int, float):
        return _DV("const", const=value, lo=float(value),
                   hi=float(value))
    return _DV("const", const=value)


_LEGACY_BINOP = {
    "BINARY_ADD": "+", "INPLACE_ADD": "+",
    "BINARY_SUBTRACT": "-", "INPLACE_SUBTRACT": "-",
    "BINARY_MULTIPLY": "*", "INPLACE_MULTIPLY": "*",
    "BINARY_TRUE_DIVIDE": "/", "INPLACE_TRUE_DIVIDE": "/",
    "BINARY_FLOOR_DIVIDE": "//", "INPLACE_FLOOR_DIVIDE": "//",
    "BINARY_MODULO": "%", "INPLACE_MODULO": "%",
    "BINARY_POWER": "**", "INPLACE_POWER": "**",
    "BINARY_LSHIFT": "<<", "INPLACE_LSHIFT": "<<",
    "BINARY_RSHIFT": ">>", "INPLACE_RSHIFT": ">>",
    "BINARY_AND": "&", "INPLACE_AND": "&",
    "BINARY_OR": "|", "INPLACE_OR": "|",
    "BINARY_XOR": "^", "INPLACE_XOR": "^",
}

_NOP_OPS = {"NOP", "EXTENDED_ARG", "RESUME", "CACHE", "PRECALL",
            "SETUP_ANNOTATIONS", "MAKE_CELL", "COPY_FREE_VARS",
            "GEN_START"}

#: float-returning elementwise ufuncs (numpy promotes int inputs to
#: float64; float32 stays float32)
_FLOAT_UFUNCS = {
    "sqrt", "exp", "exp2", "expm1", "log", "log2", "log10", "log1p",
    "sin", "cos", "tan", "arcsin", "arccos", "arctan", "sinh", "cosh",
    "tanh", "floor", "ceil", "trunc", "rint",
}
#: dtype-preserving elementwise ufuncs
_PRESERVE_UFUNCS = {"abs", "absolute", "negative", "positive",
                    "fabs", "conjugate"}
_PROMOTE_UFUNCS = {"maximum", "minimum", "fmax", "fmin"}

_NP_CASTS = {
    np.int64: I8, np.int32: I4, np.float64: F8, np.float32: F4,
    np.bool_: BOOL,
}


class _DtypeSim:
    """Linear dtype walk over straight-line bytecode.

    Precondition: pass 2 returned LIFTABLE for this function, so the
    code is branch-free, loop-free and fully modelled by the taint
    sim.  This walk re-executes the same instruction stream tracking
    numpy result dtypes and value intervals instead of taint.  It is
    allowed to model FEWER opcodes than pass 2: anything it cannot
    model yields an unknown value and, if that reaches the return, an
    inconclusive output schema (the kernel keeps its probe)."""

    def __init__(self, fn, skip_first: bool, param: _DV):
        self.fn = fn
        self.code = fn.__code__
        argc = (self.code.co_argcount
                + getattr(self.code, "co_kwonlyargcount", 0))
        params = list(self.code.co_varnames[:argc])
        if skip_first and params and params[0] in ("self", "cls"):
            params = params[1:]
        self.ok = len(params) == 1
        self.param_name = params[0] if params else None
        self.param = param
        self.locals: Dict[str, _DV] = {}
        if self.param_name is not None:
            self.locals[self.param_name] = param
        self.hazards: List[str] = []
        self.note = ""
        self.ret: Optional[_DV] = None
        self._closure = self._closure_map()

    def _closure_map(self):
        out = {}
        try:
            for name, cell in zip(self.code.co_freevars,
                                  self.fn.__closure__ or ()):
                try:
                    out[name] = cell.cell_contents
                except ValueError:
                    pass
        except Exception:
            pass
        return out

    def _bail(self, note: str) -> None:
        self.note = note
        self.ret = None
        self.ok = False

    # ---- interval helpers -------------------------------------------
    def _int_guard(self, lo, hi, sym: str) -> Tuple[Optional[float],
                                                    Optional[float]]:
        """Check an int-token result interval against int64; record a
        hazard (FT186) on possible wraparound."""
        if lo is None or hi is None:
            self.hazards.append(
                f"'{sym}' on int64 columns with unbounded value range")
            return None, None
        if lo < _I64_MIN or hi > _I64_MAX:
            self.hazards.append(
                f"'{sym}' can overflow int64 (value range "
                f"[{lo:.3g}, {hi:.3g}])")
        return lo, hi

    def _binary(self, a: _DV, b: _DV, sym: str) -> _DV:
        # const ⊗ const folds (pure arithmetic on literals)
        if a.tok == "const" and b.tok == "const":
            import operator as _op
            fns = {"+": _op.add, "-": _op.sub, "*": _op.mul,
                   "/": _op.truediv, "//": _op.floordiv, "%": _op.mod,
                   "**": _op.pow, "<<": _op.lshift, ">>": _op.rshift,
                   "&": _op.and_, "|": _op.or_, "^": _op.xor}
            try:
                return _const_dv(fns[sym](a.const, b.const))
            except Exception:
                return _DV()
        col, other = (a, b) if a.is_col else (b, a)
        if not col.is_col:
            return _DV()
        if other.tok not in ("const",) and not other.is_col:
            return _DV()
        toks = {a.tok if a.is_col else _const_token(a),
                b.tok if b.is_col else _const_token(b)}
        if None in toks:
            return _DV()
        if STR in toks:
            # object str columns: only '+' (concat) with str operands
            if sym == "+" and toks == {STR}:
                return _DV(STR)
            return _DV()
        if BOOL in toks:
            if sym in ("&", "|", "^") and toks == {BOOL}:
                return _DV(BOOL)
            return _DV()  # bool arithmetic: numpy semantics diverge
        # numeric promotion (numpy 2 / NEP 50: python scalars are weak)
        a_lo, a_hi = a.lo, a.hi
        b_lo, b_hi = b.lo, b.hi
        tok = _promote_tokens(a, b, sym)
        if tok is None:
            return _DV()
        lo, hi = _interval(sym, a_lo, a_hi, b_lo, b_hi)
        if tok in _INT_TOKENS:
            if sym in ("/",):
                raise AssertionError  # '/' always promotes to float
            if sym in ("//", "%") and _spans_zero(b_lo, b_hi):
                self.hazards.append(
                    f"'{sym}' divisor range includes zero (numpy "
                    f"yields 0, the scalar path raises)")
            if sym in ("<<", "**", "*", "+", "-"):
                lo, hi = self._int_guard(lo, hi, sym)
        return _DV(tok, lo=lo, hi=hi)

    # ---- call classification ----------------------------------------
    def _call(self, callee: _DV, args: List[_DV]) -> _DV:
        obj = callee.const if callee.tok == "obj" else None
        if obj is None:
            return _DV()
        if isinstance(obj, type) and obj in _NP_CASTS:
            tok = _NP_CASTS[obj]
            src = args[0] if args else _DV()
            lo, hi = (src.lo, src.hi)
            if tok in _INT_TOKENS:
                # casts wrap identically on the scalar and vectorized
                # paths (both go through numpy), so no hazard — but
                # the bounds are no longer trustworthy after a wrap
                if lo is not None and (lo < _I64_MIN or hi > _I64_MAX):
                    lo = hi = None
            return _DV(tok, lo=lo, hi=hi)
        if obj is abs:
            src = args[0] if args else _DV()
            if src.is_col and src.tok in _NUMERIC_TOKENS:
                lo, hi = _abs_interval(src.lo, src.hi)
                return _DV(src.tok, lo=lo, hi=hi)
            return _DV()
        if isinstance(obj, np.ufunc):
            name = obj.__name__
            srcs = [s for s in args if s.is_col]
            if not srcs:
                return _DV()
            if name in _FLOAT_UFUNCS:
                tok = F4 if all(s.tok == F4 for s in srcs) else F8
                return _DV(tok)
            if name in _PRESERVE_UFUNCS:
                s = srcs[0]
                if name in ("abs", "absolute", "fabs"):
                    lo, hi = _abs_interval(s.lo, s.hi)
                    return _DV(s.tok, lo=lo, hi=hi)
                if name in ("negative",):
                    lo = -s.hi if s.hi is not None else None
                    hi = -s.lo if s.lo is not None else None
                    return _DV(s.tok, lo=lo, hi=hi)
                return _DV(s.tok, lo=s.lo, hi=s.hi)
            if name in _PROMOTE_UFUNCS and len(args) == 2:
                return self._binary(args[0], args[1], "+") \
                    ._with_minmax(args)
            return _DV()
        fname = getattr(obj, "__name__", "")
        mod = (getattr(obj, "__module__", None) or "").split(".")[0]
        if mod == "numpy" and fname in ("where", "clip"):
            cands = [s for s in args[1:] if s.is_col or s.tok == "const"] \
                if fname == "where" else \
                [s for s in args if s.is_col or s.tok == "const"]
            out = None
            for c in cands:
                out = c if out is None else self._binary(out, c, "+")
            if out is not None and out.is_col:
                # bounds of a select/clamp stay within the operands'
                # combined range; '+' above overshoots, so recompute
                los = [c.lo for c in cands]
                his = [c.hi for c in cands]
                if all(v is not None for v in los + his):
                    return _DV(out.tok, lo=min(los), hi=max(his))
                return _DV(out.tok)
            return _DV()
        return _DV()

    # ---- main walk --------------------------------------------------
    def run(self) -> "_DtypeSim":
        if not self.ok:
            self._bail("UDF does not take exactly one element "
                       "parameter")
            return self
        stack: List[_DV] = []
        try:
            for ins in dis.get_instructions(self.code):
                op, argval, arg = ins.opname, ins.argval, ins.arg
                if op in _NOP_OPS:
                    continue
                if op == "LOAD_FAST":
                    stack.append(self.locals.get(argval, _DV()))
                elif op == "STORE_FAST":
                    self.locals[argval] = stack.pop()
                elif op == "DELETE_FAST":
                    self.locals.pop(argval, None)
                elif op == "LOAD_CONST":
                    stack.append(_const_dv(argval))
                elif op in ("LOAD_GLOBAL", "LOAD_NAME"):
                    g = self.fn.__globals__
                    obj = g.get(argval, getattr(
                        __import__("builtins"), str(argval), None))
                    stack.append(_DV("obj", const=obj)
                                 if obj is not None else _DV())
                elif op in ("LOAD_DEREF", "LOAD_CLOSURE"):
                    if argval in self._closure:
                        stack.append(_DV("obj",
                                         const=self._closure[argval]))
                    else:
                        stack.append(_DV())
                elif op in ("LOAD_ATTR", "LOAD_METHOD"):
                    base = stack.pop()
                    if base.tok == "obj":
                        try:
                            stack.append(_DV("obj", const=getattr(
                                base.const, argval)))
                        except Exception:
                            stack.append(_DV())
                    else:
                        stack.append(_DV())
                elif op == "PUSH_NULL":
                    stack.append(_DV("null"))
                elif op in _LEGACY_BINOP:
                    b, a = stack.pop(), stack.pop()
                    stack.append(self._binary(a, b, _LEGACY_BINOP[op]))
                elif op == "BINARY_OP":  # 3.11+
                    b, a = stack.pop(), stack.pop()
                    sym = ins.argrepr
                    if sym.endswith("=") and sym not in ("<=", ">=",
                                                         "==", "!="):
                        sym = sym[:-1]
                    stack.append(self._binary(a, b, sym))
                elif op == "BINARY_SUBSCR":
                    idx, base = stack.pop(), stack.pop()
                    if base.tok == "tuple" and idx.tok == "const" \
                            and isinstance(idx.const, int) \
                            and -len(base.fields) <= idx.const \
                            < len(base.fields):
                        stack.append(base.fields[idx.const])
                    else:
                        stack.append(_DV())
                elif op in ("UNARY_NEGATIVE",):
                    a = stack.pop()
                    if a.is_col and a.tok in _NUMERIC_TOKENS:
                        lo = -a.hi if a.hi is not None else None
                        hi = -a.lo if a.lo is not None else None
                        stack.append(_DV(a.tok, lo=lo, hi=hi))
                    elif a.tok == "const":
                        stack.append(_const_dv(-a.const)
                                     if isinstance(a.const, (int, float))
                                     else _DV())
                    else:
                        stack.append(_DV())
                elif op in ("UNARY_POSITIVE",):
                    pass  # identity: leave the operand in place
                elif op == "UNARY_INVERT":
                    a = stack.pop()
                    stack.append(_DV(BOOL) if a.tok == BOOL else _DV())
                elif op == "UNARY_NOT":
                    stack.pop()
                    stack.append(_DV())  # `not column` raises; probe path
                elif op == "COMPARE_OP":
                    b, a = stack.pop(), stack.pop()
                    stack.append(self._compare(a, b))
                elif op in ("IS_OP", "CONTAINS_OP"):
                    stack.pop(), stack.pop()
                    stack.append(_DV())
                elif op == "BUILD_TUPLE":
                    n = arg or 0
                    parts = [stack.pop() for _ in range(n)][::-1]
                    stack.append(_DV("tuple", fields=tuple(parts)))
                elif op == "UNPACK_SEQUENCE":
                    v = stack.pop()
                    n = arg or 0
                    if v.tok == "tuple" and len(v.fields) == n:
                        stack.extend(reversed(v.fields))
                    else:
                        stack.extend(_DV() for _ in range(n))
                elif op in ("CALL_FUNCTION", "CALL_METHOD"):
                    n = arg or 0
                    args = [stack.pop() for _ in range(n)][::-1]
                    callee = stack.pop()
                    stack.append(self._call(callee, args))
                elif op == "CALL_FUNCTION_KW":
                    stack.pop()
                    n = arg or 0
                    args = [stack.pop() for _ in range(n)][::-1]
                    callee = stack.pop()
                    stack.append(self._call(callee, args))
                elif op == "CALL":  # 3.11+
                    n = arg or 0
                    args = [stack.pop() for _ in range(n)][::-1]
                    callee = stack.pop()
                    if stack and stack[-1].tok == "null":
                        stack.pop()
                    stack.append(self._call(callee, args))
                elif op == "POP_TOP":
                    stack.pop()
                elif op == "DUP_TOP":
                    stack.append(stack[-1])
                elif op == "COPY":
                    stack.append(stack[-(arg or 1)])
                elif op == "SWAP":
                    i = arg or 2
                    stack[-1], stack[-i] = stack[-i], stack[-1]
                elif op == "ROT_TWO":
                    stack[-1], stack[-2] = stack[-2], stack[-1]
                elif op == "ROT_THREE":
                    stack[-1], stack[-2], stack[-3] = \
                        stack[-2], stack[-3], stack[-1]
                elif op in ("RETURN_VALUE", "RETURN_CONST"):
                    self.ret = (stack.pop() if op == "RETURN_VALUE"
                                else _const_dv(argval))
                    return self
                else:
                    self._bail(f"bytecode '{op}' not dtype-modelled")
                    return self
        except Exception as e:  # never break the pipeline
            self._bail(f"dtype walk failed: {e!r}")
            return self
        self._bail("no return reached")
        return self

    def _compare(self, a: _DV, b: _DV) -> _DV:
        def comparable(v):
            return (v.is_col and v.tok in
                    (_NUMERIC_TOKENS | {STR, BOOL})) \
                or (v.tok == "const"
                    and isinstance(v.const, (int, float, str, bool)))
        if comparable(a) and comparable(b):
            ta = a.tok if a.is_col else _const_token(a)
            tb = b.tok if b.is_col else _const_token(b)
            # numeric vs numeric or str vs str compare elementwise;
            # mixed kinds diverge (numpy broadcasts, python raises or
            # compares by type) — conservative
            num = _NUMERIC_TOKENS | {BOOL, "pyint", "pyfloat"}
            str_like = {STR}
            if (ta in num and tb in num) or \
                    (ta in str_like and tb in str_like):
                return _DV(BOOL)
        return _DV()


# monkey-free helper: _DV needs a small combinator for promote ufuncs
def _with_minmax(self, args):
    los = [a.lo for a in args]
    his = [a.hi for a in args]
    if self.is_col and all(v is not None for v in los + his):
        return _DV(self.tok, lo=min(los), hi=max(his))
    return self


_DV._with_minmax = _with_minmax


def _const_token(v: _DV) -> Optional[str]:
    if v.tok != "const":
        return None
    if type(v.const) is bool:
        return BOOL
    if type(v.const) is int:
        return "pyint"
    if type(v.const) is float:
        return "pyfloat"
    if type(v.const) is str:
        return STR
    return None


def _promote_tokens(a: _DV, b: _DV, sym: str) -> Optional[str]:
    """Numpy-2 result dtype for a binary op over numeric operands
    (python consts are weak per NEP 50).  None = not provable."""
    ta = a.tok if a.is_col else _const_token(a)
    tb = b.tok if b.is_col else _const_token(b)
    weak = {"pyint", "pyfloat"}
    if ta in weak and tb in weak:
        return None  # const·const handled upstream
    col_toks = [t for t in (ta, tb) if t in _NUMERIC_TOKENS]
    if not col_toks:
        return None
    consts = [t for t in (ta, tb) if t in weak]
    if sym == "/":
        if any(t in (F4,) for t in col_toks) \
                and all(t == F4 for t in col_toks):
            return F4
        if any(t == F4 for t in col_toks) and len(col_toks) == 1:
            return F4  # f4 / weak-const
        return F8
    has_float = any(t in _FLOAT_TOKENS for t in col_toks) \
        or "pyfloat" in consts
    if sym in ("<<", ">>", "&", "|", "^"):
        if has_float:
            return None
        return I8 if I8 in col_toks else I4
    if not has_float:
        if sym == "**":
            return I8 if I8 in col_toks else I4
        return I8 if I8 in col_toks else I4
    # float result: f4 only when no f8/i8/i4 column widens it
    if all(t == F4 for t in col_toks):
        return F4
    if F4 in col_toks and any(t in (F8, I8, I4) for t in col_toks):
        return F8
    if F4 in col_toks:
        return F4
    return F8


def _spans_zero(lo, hi) -> bool:
    if lo is None or hi is None:
        return True
    return lo <= 0 <= hi


def _abs_interval(lo, hi):
    if lo is None or hi is None:
        return None, None
    if lo >= 0:
        return lo, hi
    if hi <= 0:
        return -hi, -lo
    return 0.0, max(-lo, hi)


def _interval(sym, a_lo, a_hi, b_lo, b_hi):
    """Interval arithmetic for the value-range lattice; (None, None)
    when a bound cannot be proven."""
    if None in (a_lo, a_hi, b_lo, b_hi):
        return None, None
    try:
        if sym == "+":
            return a_lo + b_lo, a_hi + b_hi
        if sym == "-":
            return a_lo - b_hi, a_hi - b_lo
        if sym == "*":
            prods = (a_lo * b_lo, a_lo * b_hi, a_hi * b_lo, a_hi * b_hi)
            return min(prods), max(prods)
        if sym == "/":
            return None, None  # float result: no wraparound to guard
        if sym in ("//", "%"):
            if _spans_zero(b_lo, b_hi):
                return None, None
            qs = (a_lo / b_lo, a_lo / b_hi, a_hi / b_lo, a_hi / b_hi)
            if sym == "//":
                return min(qs) - 1, max(qs) + 1
            m = max(abs(b_lo), abs(b_hi))
            return -m, m
        if sym == "<<":
            if b_lo != b_hi or b_lo < 0 or b_lo > 63:
                return None, None
            f = float(2 ** int(b_lo))
            return a_lo * f, a_hi * f
        if sym == ">>":
            return (min(a_lo, 0), max(a_hi, 0))
        if sym == "**":
            if b_lo != b_hi or b_lo < 0 or b_lo != int(b_lo):
                return None, None
            e = int(b_lo)
            cands = [a_lo ** e, a_hi ** e]
            if _spans_zero(a_lo, a_hi):
                cands.append(0.0)
            return min(cands), max(cands)
    except OverflowError:
        return float("-inf"), float("inf")
    return None, None


# ---------------------------------------------------------------------
# kernel verdicts
# ---------------------------------------------------------------------


@dataclass
class KernelVerdict:
    """Type-flow verdict for one map/filter column kernel."""

    node_id: int
    name: str
    kind: str                   # "map" | "filter"
    proven: bool
    out_schema: ColumnSchema
    hazards: List[str] = field(default_factory=list)
    note: str = ""

    def describe(self) -> str:
        state = "proven" if self.proven else "not proven"
        extra = f"; hazards: {'; '.join(self.hazards)}" \
            if self.hazards else ""
        if self.note and not self.proven:
            extra += f"; {self.note}"
        return (f"{self.kind} kernel {state} "
                f"-> {self.out_schema.describe()}{extra}")

    def to_dict(self) -> dict:
        return {"node_id": self.node_id, "name": self.name,
                "kind": self.kind, "proven": self.proven,
                "out_schema": self.out_schema.to_dict(),
                "hazards": list(self.hazards), "note": self.note}


def _param_dv(schema: ColumnSchema) -> _DV:
    if schema.scalar:
        c = schema.cols[0]
        return _DV(c.token, lo=c.lo, hi=c.hi)
    return _DV("tuple", fields=tuple(
        _DV(c.token, lo=c.lo, hi=c.hi) for c in schema.cols))


def _schema_from_ret(ret: _DV, in_schema: ColumnSchema
                     ) -> ColumnSchema:
    """Map-kernel output value → output ColumnSchema (timestamps pass
    through map/filter unchanged)."""
    def col_of(name: str, v: _DV) -> Optional[Col]:
        if v.is_col and v.tok != OBJ:
            return Col(name, v.tok, v.lo, v.hi)
        if v.tok == "const":
            t = _const_token(v)
            if t == "pyint":
                return Col(name, I8, float(v.const), float(v.const))
            if t == "pyfloat":
                return Col(name, F8, float(v.const), float(v.const))
            if t == BOOL:
                return Col(name, BOOL)
            # const str broadcasts to a <U array, which has no wire
            # tier — track it as "obj"
            if t == STR:
                return Col(name, OBJ)
        return None

    if ret is None:
        return _unknown("return value not dtype-provable")
    if ret.tok == "tuple":
        cols = []
        for i, f in enumerate(ret.fields):
            c = col_of(f"f{i}", f)
            if c is None:
                return _unknown(f"tuple field {i} not dtype-provable")
            cols.append(c)
        if not cols:
            return _unknown("empty tuple return")
        return ColumnSchema(tuple(cols), in_schema.ts, conclusive=True)
    c = col_of("v", ret)
    if c is None:
        return _unknown("return dtype not provable")
    return ColumnSchema((c,), in_schema.ts, conclusive=True)


def _kernel_udf(op, attr: str):
    """The raw Python function behind a map/filter operator's UDF
    (same unwrap discipline as the linter's liftability check)."""
    uf = getattr(op, "user_function", None)
    fn = getattr(uf, "_fn", None)
    if not callable(fn):
        fn = getattr(uf, attr, uf)
    return fn


def analyze_map_kernel(node_id: int, name: str, fn,
                       in_schema: ColumnSchema) -> KernelVerdict:
    rep = analyze_udf(fn, name=name)
    if rep.verdict != LIFTABLE:
        return KernelVerdict(
            node_id, name, "map", False,
            _unknown(f"UDF {rep.verdict}"),
            note=f"liftability: {rep.verdict}")
    if not in_schema.conclusive:
        return KernelVerdict(node_id, name, "map", False,
                             _unknown("input schema inconclusive"),
                             note="input schema inconclusive")
    raw, skip_first = unwrap_udf(fn)
    if raw is None:
        return KernelVerdict(node_id, name, "map", False,
                             _unknown("no Python bytecode"),
                             note="no Python bytecode")
    sim = _DtypeSim(raw, skip_first, _param_dv(in_schema)).run()
    out = _schema_from_ret(sim.ret, in_schema)
    if sim.note and not out.conclusive:
        out = _unknown(sim.note or out.note)
    proven = out.conclusive and not sim.hazards
    return KernelVerdict(node_id, name, "map", proven, out,
                         hazards=sim.hazards, note=sim.note)


def analyze_filter_kernel(node_id: int, name: str, fn,
                          in_schema: ColumnSchema) -> KernelVerdict:
    # a filter NEVER changes values, so its output schema is the
    # input schema whether or not the kernel is proven
    out = in_schema
    rep = analyze_udf(fn, name=name)
    if rep.verdict != LIFTABLE:
        return KernelVerdict(node_id, name, "filter", False, out,
                             note=f"liftability: {rep.verdict}")
    if not in_schema.conclusive:
        return KernelVerdict(node_id, name, "filter", False, out,
                             note="input schema inconclusive")
    raw, skip_first = unwrap_udf(fn)
    if raw is None:
        return KernelVerdict(node_id, name, "filter", False, out,
                             note="no Python bytecode")
    sim = _DtypeSim(raw, skip_first, _param_dv(in_schema)).run()
    is_bool = sim.ret is not None and (
        sim.ret.tok == BOOL
        or (sim.ret.tok == "const" and type(sim.ret.const) is bool))
    proven = is_bool and not sim.hazards
    note = sim.note if sim.note else \
        ("" if is_bool else "predicate not proven to yield a bool mask")
    return KernelVerdict(node_id, name, "filter", proven, out,
                         hazards=sim.hazards, note=note)


# ---------------------------------------------------------------------
# graph propagation
# ---------------------------------------------------------------------


@dataclass
class EdgeFlow:
    """Type-flow facts for one StreamGraph edge."""

    edge_index: int
    source_id: int
    target_id: int
    source_name: str
    target_name: str
    exchange: bool              # non-forward partitioner
    schema: ColumnSchema
    tier: Optional[str] = None  # "col" | "pickle" | None
    tier_blocker: str = ""      # offending dtype token for "pickle"

    def to_dict(self) -> dict:
        return {
            "edge": self.edge_index,
            "from": self.source_name, "to": self.target_name,
            "from_id": self.source_id, "to_id": self.target_id,
            "exchange": self.exchange,
            "schema": self.schema.to_dict(),
            "codec_tier": self.tier,
            "tier_blocker": self.tier_blocker,
        }


@dataclass
class FootprintEstimate:
    """AOT device state footprint for one device window operator.
    ``slots`` is a LOWER bound (distinct keys read off the bounded
    source; (key, window) slot tables only grow from there)."""

    node_id: int
    name: str
    slots: Optional[int]
    bytes_per_slot: int
    budget_slots: Optional[int]
    note: str = ""

    @property
    def total_bytes(self) -> Optional[int]:
        if self.slots is None:
            return None
        return self.slots * self.bytes_per_slot

    @property
    def over_budget(self) -> bool:
        return (self.slots is not None and self.budget_slots is not None
                and self.slots > self.budget_slots)

    def to_dict(self) -> dict:
        return {"node_id": self.node_id, "name": self.name,
                "slots": self.slots,
                "bytes_per_slot": self.bytes_per_slot,
                "total_bytes": self.total_bytes,
                "budget_slots": self.budget_slots,
                "over_budget": self.over_budget, "note": self.note}


@dataclass
class TypeflowReport:
    """Everything the prover learned about one StreamGraph."""

    node_schemas: Dict[int, ColumnSchema] = field(default_factory=dict)
    edges: List[EdgeFlow] = field(default_factory=list)
    kernels: Dict[int, KernelVerdict] = field(default_factory=dict)
    footprints: Dict[int, FootprintEstimate] = field(
        default_factory=dict)
    diagnostics: Diagnostics = field(default_factory=Diagnostics)

    def edge_schema(self, source_id: int, target_id: int
                    ) -> Optional[ColumnSchema]:
        for f in self.edges:
            if f.source_id == source_id and f.target_id == target_id:
                return f.schema
        return None

    def summary(self) -> dict:
        kernels = list(self.kernels.values())
        slots = [fp.total_bytes for fp in self.footprints.values()
                 if fp.total_bytes is not None]
        return {
            "edges_total": len(self.edges),
            "edges_conclusive": sum(
                1 for f in self.edges if f.schema.conclusive),
            "kernels_total": len(kernels),
            "kernels_proven": sum(1 for k in kernels if k.proven),
            "pickle_edges": sum(
                1 for f in self.edges
                if f.exchange and f.tier == "pickle"),
            "predicted_state_bytes": int(sum(slots)),
        }

    def to_dict(self) -> dict:
        return {
            "edges": [f.to_dict() for f in self.edges],
            "kernels": {str(k): v.to_dict()
                        for k, v in self.kernels.items()},
            "footprints": {str(k): v.to_dict()
                           for k, v in self.footprints.items()},
            "summary": self.summary(),
            "diagnostics": self.diagnostics.to_dict(),
        }


def _toposort(graph) -> List[int]:
    indeg = {nid: 0 for nid in graph.nodes}
    for e in graph.edges:
        if not e.is_feedback and e.target_id in indeg:
            indeg[e.target_id] += 1
    from collections import deque
    work = deque(nid for nid, d in indeg.items() if d == 0)
    order = []
    while work:
        nid = work.popleft()
        order.append(nid)
        for e in graph.out_edges(nid):
            if e.is_feedback:
                continue
            indeg[e.target_id] -= 1
            if indeg[e.target_id] == 0:
                work.append(e.target_id)
    # cycles (FT160 territory) simply get no schema
    return order


def _merge_schemas(schemas: List[ColumnSchema]
                   ) -> Tuple[ColumnSchema, bool]:
    """Join the in-edge schemas of a multi-input node.  Returns
    (schema, conflict): conflict is True when two CONCLUSIVE schemas
    disagree on dtypes/arity (FT188)."""
    if not schemas:
        return _unknown("no input"), False
    if len(schemas) == 1:
        return schemas[0], False
    conclusive = [s for s in schemas if s.conclusive]
    if len(conclusive) != len(schemas):
        return _unknown("inconclusive merge input"), False
    sigs = {(s.tokens(), s.scalar) for s in conclusive}
    if len(sigs) > 1:
        return _unknown("schema conflict at merge"), True
    # same dtypes: union the value intervals, weaken the ts mode
    base = conclusive[0]
    cols = []
    for i, c in enumerate(base.cols):
        los = [s.cols[i].lo for s in conclusive]
        his = [s.cols[i].hi for s in conclusive]
        lo = min(los) if all(v is not None for v in los) else None
        hi = max(his) if all(v is not None for v in his) else None
        cols.append(Col(c.name, c.token, lo, hi))
    ts_modes = {s.ts for s in conclusive}
    ts = ts_modes.pop() if len(ts_modes) == 1 else "masked"
    return ColumnSchema(tuple(cols), ts, conclusive=True), False


def _bytes_per_slot(agg) -> Optional[int]:
    try:
        specs = agg.state_specs()
        total = 0
        for spec in specs.values():
            n = 1
            for d in spec.shape:
                n *= int(d)
            total += int(np.dtype(spec.dtype).itemsize) * n
        return total
    except Exception:
        return None


def _aot_rows(src_fn) -> Optional[list]:
    """The source's row values, read AOT (bounded collections only)."""
    from flink_tpu_torch.streaming.columnar import VectorizedCollectionSource
    from flink_tpu_torch.streaming.sources import FromCollectionSource
    try:
        if isinstance(src_fn, VectorizedCollectionSource):
            if src_fn._batch is None or len(src_fn._batch) > _MAX_AOT_ROWS:
                return None
            return src_fn._batch.row_values()
        if isinstance(src_fn, FromCollectionSource):
            items = src_fn.items
            if not items or len(items) > _MAX_AOT_ROWS:
                return None
            if src_fn.timestamped:
                return [v for v, _ in items]
            return list(items)
    except Exception:
        return None
    return None


def _distinct_keys(rows: list, key_selector) -> Optional[int]:
    try:
        if key_selector is None:
            return None
        get = getattr(key_selector, "get_key", key_selector)
        return len({get(v) for v in rows})
    except Exception:
        return None


def analyze_graph(graph, config=None, ops: Optional[Dict[int, Any]]
                  = None) -> TypeflowReport:
    """Run the type-flow pass over a StreamGraph.  ``ops`` lets the
    graph linter share its already-instantiated operators; otherwise
    the node factories run here (fault-isolated per node)."""
    from flink_tpu_torch.streaming.columnar import (
        BatchKeyGroupSplitOperator,
        ColumnarSource,
        ColumnarWindowOperator,
    )
    from flink_tpu_torch.streaming.operators import StreamFilter, StreamMap
    from flink_tpu_torch.streaming.partitioners import ForwardPartitioner
    from flink_tpu_torch.streaming.sources import (
        StreamSource,
        TimestampsAndWatermarksOperator,
    )

    report = TypeflowReport(
        diagnostics=Diagnostics(job_name=getattr(graph, "job_name",
                                                 None)))
    if ops is None:
        ops = {}
        for nid, node in graph.nodes.items():
            try:
                ops[nid] = node.operator_factory()
            except Exception:
                ops[nid] = None

    src_fns: Dict[int, Any] = {}
    conflict_nodes = set()

    for nid in _toposort(graph):
        node = graph.nodes[nid]
        op = ops.get(nid)
        if op is None:
            report.node_schemas[nid] = _unknown(
                "operator construction failed")
            continue
        in_edges = [e for e in graph.in_edges(nid) if not e.is_feedback]
        in_schemas = [report.node_schemas.get(e.source_id,
                                              _unknown("no schema"))
                      for e in in_edges]
        in_schema, conflict = _merge_schemas(in_schemas)
        if conflict:
            conflict_nodes.add(nid)
            ups = ", ".join(
                f"'{graph.nodes[e.source_id].name}' "
                f"({report.node_schemas[e.source_id].describe()})"
                for e in in_edges)
            report.diagnostics.add(
                "FT188",
                f"schema conflict at merge point '{node.name}': "
                f"inputs disagree — {ups}; the merged stream loses "
                f"its columnar schema (pickle codec, boxed kernels)",
                operator_id=nid, operator_name=node.name,
                hint="map the branches to one common element shape "
                     "before union()")

        if isinstance(op, StreamSource):
            schema, src_fn = _source_schema(op)
            src_fns[nid] = src_fn
            report.node_schemas[nid] = schema
            continue
        if isinstance(op, StreamMap):
            fn = _kernel_udf(op, "map")
            verdict = analyze_map_kernel(nid, node.name, fn, in_schema)
            report.kernels[nid] = verdict
            report.node_schemas[nid] = verdict.out_schema \
                if verdict.proven else _unknown(
                    verdict.note or "map kernel not proven")
            for hz in verdict.hazards:
                report.diagnostics.add(
                    "FT186",
                    f"map '{node.name}' has a dtype-overflow hazard: "
                    f"{hz} — the kernel keeps its first-batch probe",
                    operator_id=nid, operator_name=node.name,
                    hint="cast to float64, or keep values inside "
                         "int64 — python scalars don't wrap, int64 "
                         "columns do")
            continue
        if isinstance(op, StreamFilter):
            fn = _kernel_udf(op, "filter")
            verdict = analyze_filter_kernel(nid, node.name, fn,
                                            in_schema)
            report.kernels[nid] = verdict
            # values pass through a filter untouched either way
            report.node_schemas[nid] = in_schema
            for hz in verdict.hazards:
                report.diagnostics.add(
                    "FT186",
                    f"filter '{node.name}' has a dtype-overflow "
                    f"hazard: {hz} — the kernel keeps its probe",
                    operator_id=nid, operator_name=node.name)
            continue
        if isinstance(op, TimestampsAndWatermarksOperator):
            if in_schema.conclusive:
                report.node_schemas[nid] = ColumnSchema(
                    in_schema.cols, "all", conclusive=True)
            else:
                report.node_schemas[nid] = in_schema
            continue
        if isinstance(op, BatchKeyGroupSplitOperator):
            # routing wrapper: sub-batches keep the element schema
            report.node_schemas[nid] = in_schema
            continue
        from flink_tpu_torch.streaming.operators import StreamSink
        if isinstance(op, StreamSink):
            report.node_schemas[nid] = in_schema
            continue
        report.node_schemas[nid] = _unknown(
            f"no type-flow rule for {type(op).__name__}")

    # ---- per-edge flows + FT185 -------------------------------------
    for i, e in enumerate(graph.edges):
        up = graph.nodes[e.source_id]
        down = graph.nodes[e.target_id]
        schema = report.node_schemas.get(e.source_id,
                                         _unknown("no schema"))
        exchange = not isinstance(e.partitioner, ForwardPartitioner) \
            and not e.is_feedback
        tier, blocker = codec_tier(schema)
        flow = EdgeFlow(i, e.source_id, e.target_id, up.name,
                        down.name, exchange, schema, tier, blocker)
        report.edges.append(flow)
        if exchange and tier == "pickle":
            report.diagnostics.add(
                "FT185",
                f"exchange edge '{up.name}' -> '{down.name}' "
                f"conclusively demotes to the pickle wire codec: "
                f"column dtype '{blocker}' (produced by '{up.name}') "
                f"has no columnar tier",
                operator_id=e.source_id, operator_name=up.name,
                hint="int64/float64/str columns ride the zero-copy "
                     "tier; cast bools and narrow dtypes before the "
                     "exchange")

    # ---- device state footprints + FT187 ----------------------------
    budget = None
    if config is not None:
        try:
            from flink_tpu_torch.core.config import StateBackendOptions
            budget = config.get_integer(
                StateBackendOptions.TPU_MAX_DEVICE_SLOTS)
        except Exception:
            budget = None

    from flink_tpu_torch.ops.device_agg import DeviceAggregateFunction
    for nid, node in graph.nodes.items():
        op = ops.get(nid)
        agg = getattr(op, "agg", None)
        if not isinstance(agg, DeviceAggregateFunction):
            continue
        bps = _bytes_per_slot(agg)
        if bps is None:
            continue
        slots = None
        note = ""
        upstream_sources = [u for u in _upstream_ids(graph, nid)
                            if u in src_fns]
        if isinstance(op, ColumnarWindowOperator):
            for u in upstream_sources:
                fn = src_fns[u]
                if isinstance(fn, ColumnarSource) \
                        and op.key_col in fn.cols:
                    try:
                        slots = int(np.unique(
                            np.asarray(fn.cols[op.key_col])).size)
                        note = f"distinct '{op.key_col}' keys AOT"
                    except Exception:
                        slots = None
                    break
        if slots is None:
            selector = getattr(node, "key_selector", None)
            for u in upstream_sources:
                rows = _aot_rows(src_fns[u])
                if rows is None:
                    continue
                n = _distinct_keys(rows, selector)
                if n is not None:
                    slots = n
                    note = "distinct keys via key selector AOT"
                    break
        fp = FootprintEstimate(nid, node.name, slots, bps, budget,
                               note=note)
        report.footprints[nid] = fp
        if fp.over_budget:
            report.diagnostics.add(
                "FT187",
                f"device window '{node.name}' needs at least "
                f"{fp.slots} state slots x {bps} B/slot = "
                f"{fp.total_bytes} B, over the configured "
                f"state.backend.tpu.max-device-slots budget of "
                f"{budget} — the backend will spill to host at "
                f"runtime",
                operator_id=nid, operator_name=node.name,
                hint="raise state.backend.tpu.max-device-slots, or "
                     "reduce key cardinality before the window")
    return report


def _upstream_ids(graph, nid) -> List[int]:
    from collections import deque
    seen, work = set(), deque([nid])
    while work:
        cur = work.popleft()
        for e in graph.in_edges(cur):
            if e.is_feedback or e.source_id in seen:
                continue
            seen.add(e.source_id)
            work.append(e.source_id)
    return list(seen)


# ---------------------------------------------------------------------
# feeding verdicts into the runtime
# ---------------------------------------------------------------------


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


#: pre-size cap: never allocate more than this many slots AOT, even
#: for a huge predicted cardinality (the engine still grows on demand)
_MAX_PRESIZE_SLOTS = 1 << 20


def _wrap_factory(node, attrs: dict) -> None:
    """Re-wrap the node's operator factory so every built instance
    carries the static verdict attributes: the executor's first
    attempt, restarts, region failover and savepoint restores all build
    operators through it.  Idempotent: re-applying replaces the
    previous wrap instead of stacking."""
    orig = getattr(node.operator_factory, "_typeflow_orig",
                   node.operator_factory)

    def factory(_orig=orig, _attrs=dict(attrs)):
        op = _orig()
        for k, v in _attrs.items():
            if k == "_presize_slots":
                cap = getattr(op, "initial_capacity", None)
                if isinstance(cap, int):
                    op.initial_capacity = max(
                        cap, _next_pow2(min(v, _MAX_PRESIZE_SLOTS)))
                continue
            setattr(op, k, v)
        return op

    factory._typeflow_orig = orig
    node.operator_factory = factory


def apply_static(graph, report: TypeflowReport) -> dict:
    """Feed conclusive type-flow verdicts into the runtime
    (``decided_by=static``, graph-wide):

    - proven map/filter kernels get ``_static_kernel=True`` (the
      ``_ColumnKernelMixin`` skips the first-batch probe; the output
      shape validation still demotes on any runtime mismatch),
    - exchange edges with a conclusive codec tier get
      ``predicted_codec_tier`` (carried onto the JobEdge),
    - device window operators with an AOT slot estimate get
      ``_predicted_slots`` and a pre-sized ``initial_capacity``.

    Returns ``{"kernels_proven", "edges_predicted", "footprints"}``.
    """
    kernels = 0
    for nid, verdict in report.kernels.items():
        node = graph.nodes.get(nid)
        if node is None:
            continue
        if verdict.proven:
            _wrap_factory(node, {
                "_static_kernel": True,
                "_typeflow_verdict": verdict.describe(),
            })
            kernels += 1
        else:
            # record the verdict so the runtime fallback warning can
            # name it even when the kernel was not proven
            _wrap_factory(node, {
                "_typeflow_verdict": verdict.describe(),
            })

    edges = 0
    for flow in report.edges:
        if flow.exchange and flow.tier is not None \
                and flow.edge_index < len(graph.edges):
            graph.edges[flow.edge_index].predicted_codec_tier = \
                flow.tier
            edges += 1

    footprints = 0
    for nid, fp in report.footprints.items():
        node = graph.nodes.get(nid)
        if node is None or fp.slots is None:
            continue
        _wrap_factory(node, {
            "_predicted_slots": fp.slots,
            "_presize_slots": fp.slots,
        })
        footprints += 1
    return {"kernels_proven": kernels, "edges_predicted": edges,
            "footprints": footprints}
