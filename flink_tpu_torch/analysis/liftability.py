"""Ahead-of-time UDF liftability analysis (port of
``flink_tpu/analysis/liftability.py``).

Classifies a user function (a map/filter lambda, a key selector) from
its CPython bytecode and closure, without running it:

``LIFTABLE``
    Proven safe to call with columns in place of scalars: branch-free,
    only whitelisted elementwise calls (numpy ufuncs, dtype casts,
    ``abs``), no side effects.  The column kernels and the fused chain
    program run only such functions.
``SCALAR_ONLY``
    Proven to reject columns: data-dependent branching on element
    values, or scalar-only calls (``float()``/``min()``/``math.*``)
    applied to element data.
``IMPURE``
    Writes global/nonlocal state, mutates ``self`` or a captured
    object, or calls I/O / ``time`` / ``random``.  Never lifted.
``INCONCLUSIVE``
    Anything the analyzer cannot prove either way (loops, unknown
    calls, bytecode it does not model).

The verdicts are the reference's on every function (held by
``tests/test_torch_columnar.py``): a wrong ``LIFTABLE`` would let a
function that is not elementwise run on columns, so anything
unmodelled degrades to ``INCONCLUSIVE``.  The analysis reads bytecode
only, so a ``LIFTABLE`` verdict says nothing of which array library
the function calls: a UDF calling numpy is liftable on host columns,
and the fused program, which runs it on torch tensors, demotes when
the call raises there.

``analyze_aggregate`` combines the verdicts of an ``AggregateFunction``'s
methods into an ``AggregateReport``: the generic window tier
(``streaming/generic_agg.py``) takes a conclusive one in place of its
runtime probe.
"""

from __future__ import annotations

import builtins
import dis
import functools
import inspect
import types
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

LIFTABLE = "LIFTABLE"
SCALAR_ONLY = "SCALAR_ONLY"
IMPURE = "IMPURE"
INCONCLUSIVE = "INCONCLUSIVE"

# modules whose use inside a UDF is a side effect / nondeterminism
_IMPURE_MODULE_ROOTS = {
    "time", "random", "os", "io", "socket", "subprocess", "secrets",
    "uuid", "sys", "threading", "multiprocessing", "logging", "urllib",
    "http", "shutil", "tempfile",
}
_IMPURE_BUILTINS = {"print", "open", "input", "exec", "eval",
                    "breakpoint", "__import__"}
# builtins that force per-element scalars (raise or collapse on
# columns of length > 1) — conclusive SCALAR_ONLY when fed element data
_SCALAR_CAST_BUILTINS = {"float", "int", "bool", "round", "min", "max",
                         "divmod", "str", "ord", "chr", "format"}
# builtins that are fine regardless of columns (elementwise via dunder)
_OK_BUILTINS = {"abs"}
# non-ufunc numpy callables known elementwise-safe
_NUMPY_OK_NAMES = {"where", "clip"}
# ndarray/np-scalar methods that keep element alignment
_ARRAY_METHODS_OK = {"copy", "astype", "clip", "round", "conjugate"}
# methods that mutate their receiver in place
_MUTATING_METHODS = {
    "append", "extend", "insert", "add", "update", "pop", "popitem",
    "remove", "discard", "clear", "setdefault", "write", "writelines",
    "sort", "reverse",
}

_BRANCH_OPS = {
    "POP_JUMP_IF_TRUE", "POP_JUMP_IF_FALSE",
    "JUMP_IF_TRUE_OR_POP", "JUMP_IF_FALSE_OR_POP",
    "JUMP_IF_NOT_EXC_MATCH",
    # 3.11+/3.12 spellings (best effort; any mismatch just bails)
    "POP_JUMP_FORWARD_IF_TRUE", "POP_JUMP_FORWARD_IF_FALSE",
    "POP_JUMP_BACKWARD_IF_TRUE", "POP_JUMP_BACKWARD_IF_FALSE",
    "POP_JUMP_IF_NONE", "POP_JUMP_IF_NOT_NONE",
    "POP_JUMP_FORWARD_IF_NONE", "POP_JUMP_FORWARD_IF_NOT_NONE",
}
_BINARY_OPS = {
    "BINARY_ADD", "BINARY_SUBTRACT", "BINARY_MULTIPLY",
    "BINARY_TRUE_DIVIDE", "BINARY_FLOOR_DIVIDE", "BINARY_MODULO",
    "BINARY_POWER", "BINARY_LSHIFT", "BINARY_RSHIFT", "BINARY_AND",
    "BINARY_OR", "BINARY_XOR", "BINARY_MATRIX_MULTIPLY",
    "BINARY_SUBSCR", "BINARY_OP",
    "INPLACE_ADD", "INPLACE_SUBTRACT", "INPLACE_MULTIPLY",
    "INPLACE_TRUE_DIVIDE", "INPLACE_FLOOR_DIVIDE", "INPLACE_MODULO",
    "INPLACE_POWER", "INPLACE_LSHIFT", "INPLACE_RSHIFT", "INPLACE_AND",
    "INPLACE_OR", "INPLACE_XOR", "INPLACE_MATRIX_MULTIPLY",
}
_UNARY_OPS = {"UNARY_POSITIVE", "UNARY_NEGATIVE", "UNARY_NOT",
              "UNARY_INVERT"}
_NOP_OPS = {"NOP", "EXTENDED_ARG", "RESUME", "CACHE", "PRECALL",
            "SETUP_ANNOTATIONS", "MAKE_CELL", "COPY_FREE_VARS",
            "GEN_START"}


class _Unknown:
    def __repr__(self):
        return "<?>"


_UNKNOWN = _Unknown()


class _V:
    """Abstract stack value: taint (derived from element data),
    best-effort resolved object, display name, container kind."""

    __slots__ = ("tainted", "obj", "desc", "kind", "impure_src")

    def __init__(self, tainted=False, obj=_UNKNOWN, desc="?", kind=None,
                 impure_src=None):
        self.tainted = tainted
        self.obj = obj
        self.desc = desc
        self.kind = kind
        self.impure_src = impure_src


@dataclass
class _SimResult:
    complete: bool = False      # reached the end of the bytecode
    branches: int = 0
    loop: bool = False
    impure: List[str] = field(default_factory=list)
    scalar: List[str] = field(default_factory=list)
    inconclusive: List[str] = field(default_factory=list)
    return_kinds: List[Optional[str]] = field(default_factory=list)


@dataclass
class UdfReport:
    """Analysis result for one user function."""

    verdict: str
    reasons: List[str]
    name: str = "<udf>"
    location: Optional[str] = None

    @property
    def conclusive(self) -> bool:
        return self.verdict != INCONCLUSIVE


@dataclass
class AggregateReport:
    """Combined verdict over add / merge / get_result of an
    AggregateFunction.  ``result_liftable`` tracks get_result on its
    own (it can demote independently of the fold)."""

    verdict: str
    reasons: List[str]
    result_liftable: bool = False
    add: Optional[UdfReport] = None
    merge: Optional[UdfReport] = None
    get_result: Optional[UdfReport] = None
    location: Optional[str] = None

    @property
    def conclusive(self) -> bool:
        return self.verdict != INCONCLUSIVE


# ---------------------------------------------------------------------
# unwrapping


def unwrap_udf(fn) -> tuple:
    """Peel wrappers down to the plain Python function holding the
    user's bytecode.  Returns (function_or_None, skip_first_param)."""
    skip_first = False
    for _ in range(8):
        if fn is None:
            return None, skip_first
        if inspect.ismethod(fn):
            fn, skip_first = fn.__func__, True
            continue
        if isinstance(fn, functools.partial):
            fn = fn.func
            continue
        if inspect.isfunction(fn):
            return fn, skip_first
        # lambda wrappers from core.functions (_LambdaMap & friends)
        inner = None
        for attr in ("_fn", "fn", "_func", "func"):
            cand = getattr(fn, attr, None)
            if callable(cand):
                inner = cand
                break
        if inner is not None:
            fn = inner
            continue
        call = getattr(fn, "__call__", None)
        if call is not None and inspect.ismethod(call):
            fn, skip_first = call.__func__, True
            continue
        return None, skip_first
    return None, skip_first


def _location_of(fn) -> Optional[str]:
    try:
        code = fn.__code__
        return f"{code.co_filename}:{code.co_firstlineno}"
    except Exception:
        return None


# ---------------------------------------------------------------------
# resolution helpers


def _module_impurity(obj) -> Optional[str]:
    if isinstance(obj, types.ModuleType):
        name = obj.__name__
        if name.split(".")[0] in _IMPURE_MODULE_ROOTS \
                or name.endswith(".random"):
            return name
    return None


def _safe_getattr(obj, name):
    if obj is _UNKNOWN:
        return _UNKNOWN
    try:
        return getattr(obj, name, _UNKNOWN)
    except Exception:
        return _UNKNOWN


# ---------------------------------------------------------------------
# the simulator


class _Sim:
    """Linear abstract interpretation of one code object.

    Simulates taint and best-effort object resolution up to the first
    conditional jump / loop / unmodelled opcode, and scans the whole
    instruction list for context-free impurity signals (global and
    nonlocal writes).  Everything it cannot model degrades to
    INCONCLUSIVE, never to a conclusive verdict.
    """

    def __init__(self, fn, skip_first: bool, depth: int = 0,
                 taint_all_params: bool = True):
        self.fn = fn
        self.code = fn.__code__
        self.depth = depth
        argc = (self.code.co_argcount
                + getattr(self.code, "co_kwonlyargcount", 0))
        params = list(self.code.co_varnames[:argc])
        if skip_first and params and params[0] in ("self", "cls"):
            params = params[1:]
        elif params and params[0] == "self":
            # unbound method accessed via the class
            params = params[1:]
        self.params = set(params) if taint_all_params else set()
        self.res = _SimResult()
        self.tainted_locals: dict = {}
        self.local_objs: dict = {}   # name -> resolved obj (untainted)
        self._closure = self._closure_map()

    def _closure_map(self):
        out = {}
        try:
            free = self.code.co_freevars
            cells = self.fn.__closure__ or ()
            for name, cell in zip(free, cells):
                try:
                    out[name] = cell.cell_contents
                except ValueError:
                    out[name] = _UNKNOWN
        except Exception:
            pass
        return out

    # ---- impurity scan (no stack context needed) --------------------
    def scan_impurity(self):
        cellvars = set(self.code.co_cellvars)
        instrs = list(dis.get_instructions(self.code))
        for i, ins in enumerate(instrs):
            op = ins.opname
            if op in ("STORE_GLOBAL", "DELETE_GLOBAL"):
                self.res.impure.append(f"writes global '{ins.argval}'")
            elif op in ("STORE_DEREF", "DELETE_DEREF"):
                # a cellvar is a local captured by an inner function —
                # writing it is still local; freevars are nonlocal
                if ins.argval not in cellvars:
                    self.res.impure.append(
                        f"writes nonlocal '{ins.argval}'")
            elif op == "STORE_ATTR":
                # the store target's load may be several instructions
                # back (augmented assigns compile to LOAD self;
                # DUP_TOP; LOAD_ATTR; ...; ROT_TWO/SWAP; STORE_ATTR) —
                # take the nearest preceding owner-capable load
                target = None
                for back in reversed(instrs[max(0, i - 8):i]):
                    if back.opname in ("LOAD_FAST", "LOAD_GLOBAL",
                                       "LOAD_DEREF", "LOAD_NAME"):
                        target = back
                        break
                if target is not None and target.opname == "LOAD_FAST" \
                        and target.argval == "self":
                    self.res.impure.append(
                        f"mutates self.{ins.argval} across calls")
                elif target is not None and target.opname in (
                        "LOAD_GLOBAL", "LOAD_DEREF", "LOAD_NAME"):
                    self.res.impure.append(
                        f"mutates attribute '.{ins.argval}' of captured "
                        f"'{target.argval}'")
                else:
                    self.res.inconclusive.append(
                        f"stores attribute '.{ins.argval}'")
            elif op == "IMPORT_NAME":
                root = str(ins.argval).split(".")[0]
                if root in _IMPURE_MODULE_ROOTS:
                    self.res.impure.append(
                        f"imports '{ins.argval}' at call time")
                else:
                    self.res.inconclusive.append(
                        f"imports '{ins.argval}' at call time")

    # ---- call classification ----------------------------------------
    def _classify_call(self, callable_v: _V, arg_vs: List[_V]) -> _V:
        tainted = callable_v.tainted or any(a.tainted for a in arg_vs)
        out = _V(tainted=tainted, desc=f"{callable_v.desc}(...)")
        if callable_v.impure_src:
            self.res.impure.append(
                f"calls '{callable_v.desc}' ({callable_v.impure_src})")
            return out
        obj = callable_v.obj
        name = callable_v.desc
        if obj is _UNKNOWN:
            if callable_v.tainted:
                last = name.rsplit(".", 1)[-1]
                if last in _ARRAY_METHODS_OK:
                    return out
                self.res.inconclusive.append(
                    f"call on element value ('{name}') not analyzable")
            else:
                self.res.inconclusive.append(
                    f"call to '{name}' not analyzable")
            return out
        # builtins
        bname = getattr(obj, "__name__", None)
        if obj is getattr(builtins, bname or "", None):
            if bname in _IMPURE_BUILTINS:
                self.res.impure.append(f"calls {bname}()")
            elif bname in _OK_BUILTINS:
                pass
            elif bname in _SCALAR_CAST_BUILTINS:
                if tainted:
                    self.res.scalar.append(
                        f"{bname}() on element data forces scalars")
                if obj in (list, set, dict):
                    out.kind = bname
            elif obj in (list, set, dict):
                out.kind = bname
                if tainted:
                    self.res.inconclusive.append(
                        f"builds a {bname} from element data")
            elif tainted:
                self.res.inconclusive.append(
                    f"{bname}() on element data not analyzable")
            return out
        # numpy
        if isinstance(obj, np.ufunc):
            return out
        if isinstance(obj, type) and issubclass(obj, np.generic):
            return out  # dtype cast — elementwise on arrays
        mod = getattr(obj, "__module__", None) or ""
        if mod.split(".")[0] == "numpy":
            if name.rsplit(".", 1)[-1] in _NUMPY_OK_NAMES:
                return out
            if tainted:
                self.res.inconclusive.append(
                    f"'{name}' not in the elementwise numpy whitelist")
            return out
        if mod == "math":
            if tainted:
                self.res.scalar.append(
                    f"math function '{name}' operates on scalars only")
            return out
        # user helper function: recurse one level
        if inspect.isfunction(obj) and self.depth < 2:
            sub = _analyze_function(obj, skip_first=False,
                                    depth=self.depth + 1)
            if sub.impure:
                self.res.impure.append(
                    f"calls impure '{name}': {sub.impure[0]}")
            elif tainted and sub.scalar:
                self.res.scalar.append(
                    f"calls scalar-only '{name}': {sub.scalar[0]}")
            elif not (sub.complete and not sub.branches and not sub.loop
                      and not sub.inconclusive and not sub.scalar):
                self.res.inconclusive.append(
                    f"call to helper '{name}' not proven elementwise")
            return out
        # classes / constructors
        if isinstance(obj, type):
            if tainted:
                self.res.inconclusive.append(
                    f"constructs {name}(...) from element data")
            return out
        self.res.inconclusive.append(f"call to '{name}' not analyzable")
        return out

    # ---- main loop ---------------------------------------------------
    def run(self) -> _SimResult:
        self.scan_impurity()
        try:
            self._run_stack()
        except Exception:
            self.res.complete = False
        return self.res

    def _load_root(self, op, argval) -> _V:
        if op in ("LOAD_GLOBAL", "LOAD_NAME"):
            g = self.fn.__globals__
            if argval in g:
                obj = g[argval]
            else:
                obj = getattr(builtins, argval, _UNKNOWN)
            v = _V(False, obj, argval)
            v.impure_src = _module_impurity(obj)
            return v
        if op in ("LOAD_DEREF", "LOAD_CLOSURE"):
            obj = self._closure.get(argval, _UNKNOWN)
            v = _V(False, obj, argval)
            v.impure_src = _module_impurity(obj)
            if isinstance(obj, (list, dict, set, bytearray)):
                v.kind = type(obj).__name__
            return v
        raise AssertionError(op)

    def _run_stack(self):
        stack: List[_V] = []
        instrs = list(dis.get_instructions(self.code))
        offsets = [i.offset for i in instrs]
        idx = 0
        cur_line = self.code.co_firstlineno
        while idx < len(instrs):
            ins = instrs[idx]
            if ins.starts_line is not None:
                cur_line = ins.starts_line
            op, argval, arg = ins.opname, ins.argval, ins.arg

            if op in _NOP_OPS:
                pass
            elif op == "LOAD_FAST":
                tainted = (argval in self.params
                           or self.tainted_locals.get(argval, False))
                v = _V(tainted, self.local_objs.get(argval, _UNKNOWN),
                       argval)
                if argval == "self":
                    v.obj = _UNKNOWN
                stack.append(v)
            elif op == "STORE_FAST":
                v = stack.pop()
                self.tainted_locals[argval] = v.tainted
                self.local_objs[argval] = (
                    v.obj if not v.tainted else _UNKNOWN)
            elif op == "DELETE_FAST":
                self.tainted_locals.pop(argval, None)
                self.local_objs.pop(argval, None)
            elif op == "LOAD_CONST":
                stack.append(_V(False, argval, repr(argval)))
            elif op in ("LOAD_GLOBAL", "LOAD_NAME", "LOAD_DEREF",
                        "LOAD_CLOSURE"):
                stack.append(self._load_root(op, argval))
            elif op in ("LOAD_ATTR", "LOAD_METHOD"):
                base = stack.pop()
                obj = (_safe_getattr(base.obj, argval)
                       if not base.tainted else _UNKNOWN)
                v = _V(base.tainted, obj, f"{base.desc}.{argval}")
                v.impure_src = (base.impure_src
                                or _module_impurity(base.obj)
                                or _module_impurity(obj))
                if base.tainted and argval in _MUTATING_METHODS \
                        and base.kind in ("list", "dict", "set",
                                          "bytearray"):
                    pass  # mutating a local container: pure
                if not base.tainted and argval in _MUTATING_METHODS \
                        and base.desc in self._closure:
                    self.res.impure.append(
                        f"mutates captured object "
                        f"'{base.desc}.{argval}(...)'")
                stack.append(v)
            elif op == "STORE_DEREF":
                stack.pop()  # impurity handled by scan_impurity
            elif op in _BINARY_OPS:
                b, a = stack.pop(), stack.pop()
                stack.append(_V(a.tainted or b.tainted,
                                desc=f"({a.desc}·{b.desc})"))
            elif op in _UNARY_OPS:
                a = stack.pop()
                stack.append(_V(a.tainted, desc=f"(·{a.desc})"))
            elif op in ("COMPARE_OP", "IS_OP", "CONTAINS_OP"):
                b, a = stack.pop(), stack.pop()
                stack.append(_V(a.tainted or b.tainted,
                                desc=f"({a.desc}?{b.desc})"))
            elif op in ("BUILD_TUPLE", "BUILD_LIST", "BUILD_SET",
                        "BUILD_STRING"):
                n = arg or 0
                parts = [stack.pop() for _ in range(n)]
                kind = {"BUILD_LIST": "list",
                        "BUILD_SET": "set"}.get(op)
                stack.append(_V(any(p.tainted for p in parts),
                                desc=op.lower(), kind=kind))
            elif op == "BUILD_MAP":
                n = (arg or 0) * 2
                parts = [stack.pop() for _ in range(n)]
                stack.append(_V(any(p.tainted for p in parts),
                                desc="build_map", kind="dict"))
            elif op == "BUILD_CONST_KEY_MAP":
                n = (arg or 0) + 1
                parts = [stack.pop() for _ in range(n)]
                stack.append(_V(any(p.tainted for p in parts),
                                desc="build_map", kind="dict"))
            elif op == "LIST_EXTEND":
                item = stack.pop()
                if stack:
                    stack[-1].tainted |= item.tainted
            elif op == "BUILD_SLICE":
                n = arg or 2
                parts = [stack.pop() for _ in range(n)]
                stack.append(_V(any(p.tainted for p in parts),
                                desc="slice"))
            elif op == "UNPACK_SEQUENCE":
                v = stack.pop()
                for _ in range(arg or 0):
                    stack.append(_V(v.tainted, desc=f"{v.desc}[·]"))
            elif op == "STORE_SUBSCR":
                stack.pop(); stack.pop(); stack.pop()
            elif op == "DELETE_SUBSCR":
                stack.pop(); stack.pop()
            elif op in ("CALL_FUNCTION", "CALL_METHOD"):
                n = arg or 0
                args = [stack.pop() for _ in range(n)][::-1]
                callee = stack.pop()
                stack.append(self._classify_call(callee, args))
            elif op == "CALL_FUNCTION_KW":
                stack.pop()  # kw-names tuple
                n = arg or 0
                args = [stack.pop() for _ in range(n)][::-1]
                callee = stack.pop()
                stack.append(self._classify_call(callee, args))
            elif op == "CALL":  # 3.11+
                n = arg or 0
                args = [stack.pop() for _ in range(n)][::-1]
                callee = stack.pop()
                if stack and stack[-1].obj is None:
                    stack.pop()  # PUSH_NULL slot
                stack.append(self._classify_call(callee, args))
            elif op == "PUSH_NULL":
                stack.append(_V(False, None, "NULL"))
            elif op == "POP_TOP":
                stack.pop()
            elif op == "DUP_TOP":
                stack.append(stack[-1])
            elif op == "DUP_TOP_TWO":
                stack.extend([stack[-2], stack[-1]])
            elif op == "ROT_TWO":
                stack[-1], stack[-2] = stack[-2], stack[-1]
            elif op == "ROT_THREE":
                stack[-1], stack[-2], stack[-3] = \
                    stack[-2], stack[-3], stack[-1]
            elif op == "ROT_FOUR":
                stack[-1], stack[-2], stack[-3], stack[-4] = \
                    stack[-2], stack[-3], stack[-4], stack[-1]
            elif op == "COPY":
                stack.append(stack[-(arg or 1)])
            elif op == "SWAP":
                i = arg or 2
                stack[-1], stack[-i] = stack[-i], stack[-1]
            elif op in ("RETURN_VALUE", "RETURN_CONST"):
                v = (stack.pop() if op == "RETURN_VALUE"
                     else _V(False, argval, repr(argval)))
                kind = v.kind
                if kind is None and isinstance(
                        v.obj, (list, dict, set, bytearray)) \
                        and v.obj is not _UNKNOWN:
                    kind = type(v.obj).__name__
                self.res.return_kinds.append(kind)
                if idx == len(instrs) - 1:
                    self.res.complete = True
                    return
                # mid-body return: only reachable via a branch we
                # already counted; keep going on a fresh stack
                stack = []
            elif op in _BRANCH_OPS:
                test = stack.pop() if stack else _V(True)
                self.res.branches += 1
                if test.tainted:
                    self.res.scalar.append(
                        "data-dependent branch on element values "
                        f"(line {cur_line})")
                return  # stack state beyond the first branch is unknown
            elif op in ("FOR_ITER", "GET_ITER"):
                self.res.loop = True
                return
            elif op in ("JUMP_ABSOLUTE", "JUMP_BACKWARD",
                        "JUMP_BACKWARD_NO_INTERRUPT"):
                target_idx = offsets.index(ins.argval) \
                    if ins.argval in offsets else None
                if target_idx is not None and target_idx <= idx:
                    self.res.loop = True
                return
            else:
                # unmodelled opcode (try/except, generators, nested
                # functions, f-strings, ...) — give up on conclusions
                self.res.inconclusive.append(
                    f"bytecode '{op}' not modelled")
                return
            idx += 1
        self.res.complete = True


def _analyze_function(fn, skip_first: bool, depth: int = 0) -> _SimResult:
    try:
        sim = _Sim(fn, skip_first, depth=depth)
        return sim.run()
    except Exception as e:  # never let analysis break the pipeline
        res = _SimResult()
        res.inconclusive.append(f"analysis failed: {e!r}")
        return res


# ---------------------------------------------------------------------
# public API


def analyze_udf(fn, name: Optional[str] = None) -> UdfReport:
    """Classify one user function. See the module docstring for the
    verdict contract."""
    raw, skip_first = unwrap_udf(fn)
    display = name or getattr(raw or fn, "__qualname__",
                              getattr(fn, "__name__", "<udf>"))
    if raw is None:
        return UdfReport(INCONCLUSIVE,
                         ["no Python bytecode (builtin or C function)"],
                         name=display)
    res = _analyze_function(raw, skip_first)
    return UdfReport(_verdict_of(res), _reasons_of(res), name=display,
                     location=_location_of(raw))


def _verdict_of(res: _SimResult) -> str:
    if res.impure:
        return IMPURE
    if res.scalar:
        return SCALAR_ONLY
    if res.complete and not res.branches and not res.loop \
            and not res.inconclusive:
        return LIFTABLE
    return INCONCLUSIVE


def _reasons_of(res: _SimResult) -> List[str]:
    if res.impure:
        return list(dict.fromkeys(res.impure))
    if res.scalar:
        return list(dict.fromkeys(res.scalar))
    reasons = list(dict.fromkeys(res.inconclusive))
    if res.loop:
        reasons.append("iterates (loop)")
    elif res.branches and not res.scalar:
        reasons.append("conditional branching (test not element-derived)")
    if not res.complete and not reasons:
        reasons.append("bytecode not fully analyzable")
    return reasons


def returns_unhashable(fn) -> Optional[str]:
    """If ``fn`` provably returns an unhashable container (list, dict,
    set) on its straight-line path, that kind, else None."""
    raw, skip_first = unwrap_udf(fn)
    if raw is None:
        return None
    res = _analyze_function(raw, skip_first)
    for kind in res.return_kinds:
        if kind in ("list", "dict", "set", "bytearray"):
            return kind
    return None


def _spec_of_acc(acc0) -> Optional[object]:
    """``LiftedAggregate._spec_of`` (a copy here: generic_agg imports
    this module)."""
    numeric = (int, float, bool, np.integer, np.floating, np.bool_)
    if isinstance(acc0, numeric):
        return "scalar"
    if isinstance(acc0, (tuple, list)) and len(acc0) and all(
            isinstance(f, numeric) for f in acc0):
        return ("tuple" if isinstance(acc0, tuple) else "list", len(acc0))
    return None


def analyze_aggregate(agg) -> AggregateReport:
    """Classify an ``AggregateFunction`` ahead of time.

    The combined verdict follows the runtime probe's order: an impure
    method anywhere makes the whole IMPURE; an accumulator that is not
    numeric, or a SCALAR_ONLY add or merge, is SCALAR_ONLY; add and
    merge both LIFTABLE lift the fold, with ``result_liftable`` for
    get_result on its own.
    """
    reports = {m: analyze_udf(getattr(agg, m, None),
                              name=f"{type(agg).__name__}.{m}")
               for m in ("add", "merge", "get_result",
                         "create_accumulator")}
    add_r, merge_r = reports["add"], reports["merge"]
    res_r, create_r = reports["get_result"], reports["create_accumulator"]
    loc = add_r.location

    impure = [r for r in reports.values() if r.verdict == IMPURE]
    if impure:
        reasons = [f"{r.name}: {why}" for r in impure for why in r.reasons]
        return AggregateReport(IMPURE, reasons, add=add_r, merge=merge_r,
                               get_result=res_r, location=loc)

    try:
        acc0 = agg.create_accumulator()
        spec = _spec_of_acc(acc0)
    except Exception as e:
        return AggregateReport(
            INCONCLUSIVE, [f"create_accumulator raised {e!r}"],
            add=add_r, merge=merge_r, get_result=res_r, location=loc)
    if spec is None:
        return AggregateReport(
            SCALAR_ONLY,
            ["accumulator is not a numeric scalar or a flat numeric "
             "tuple/list — the lifted tier stores accumulators as "
             "parallel numpy columns"],
            add=add_r, merge=merge_r, get_result=res_r, location=loc)

    if SCALAR_ONLY in (add_r.verdict, merge_r.verdict):
        src = add_r if add_r.verdict == SCALAR_ONLY else merge_r
        reasons = [f"{src.name}: {why}" for why in src.reasons]
        return AggregateReport(SCALAR_ONLY, reasons, add=add_r,
                               merge=merge_r, get_result=res_r,
                               location=loc)

    if add_r.verdict == LIFTABLE and merge_r.verdict == LIFTABLE \
            and create_r.verdict in (LIFTABLE, INCONCLUSIVE):
        return AggregateReport(
            LIFTABLE,
            ["add and merge proven elementwise over numpy columns"],
            result_liftable=(res_r.verdict == LIFTABLE),
            add=add_r, merge=merge_r, get_result=res_r, location=loc)

    reasons = []
    for r in (add_r, merge_r):
        if r.verdict != LIFTABLE:
            reasons.extend(f"{r.name}: {why}" for why in r.reasons)
    return AggregateReport(INCONCLUSIVE, reasons or ["not provable"],
                           add=add_r, merge=merge_r, get_result=res_r,
                           location=loc)
