"""User-function SPI (subset of ``flink_tpu/core/functions.py:25-340``).

Plain callables are accepted wherever a single-method function is
expected; the classes exist for the rich lifecycle (open/close) and
for the multi-method ``AggregateFunction`` contract that the device
window engine vectorizes.
"""

from __future__ import annotations

import abc
from typing import Any, Generic, Iterable, Optional, TypeVar

IN = TypeVar("IN")
OUT = TypeVar("OUT")
ACC = TypeVar("ACC")
KEY = TypeVar("KEY")


class Function:
    """Marker base for all user functions."""


class RuntimeContext:
    """Per-subtask metadata handed to rich functions, and keyed state
    on a keyed stream (``get_state`` and the other accessors)."""

    def __init__(self, task_name: str = "task", index_of_subtask: int = 0,
                 parallelism: int = 1, max_parallelism: int = 128,
                 keyed_state_store=None):
        self.task_name = task_name
        self.index_of_this_subtask = index_of_subtask
        self.number_of_parallel_subtasks = parallelism
        self.max_number_of_parallel_subtasks = max_parallelism
        self._keyed_state_store = keyed_state_store
        self.accumulators: dict[str, Any] = {}

    def _keyed(self):
        if self._keyed_state_store is None:
            raise RuntimeError(
                "Keyed state is only available on a keyed stream "
                "(call .key_by(...) before the stateful function)")
        return self._keyed_state_store

    def get_state(self, descriptor):
        return self._keyed().get_value_state(descriptor)

    def get_list_state(self, descriptor):
        return self._keyed().get_list_state(descriptor)

    def get_reducing_state(self, descriptor):
        return self._keyed().get_reducing_state(descriptor)

    def get_aggregating_state(self, descriptor):
        return self._keyed().get_aggregating_state(descriptor)

    def get_map_state(self, descriptor):
        return self._keyed().get_map_state(descriptor)


class RichFunction(Function):
    """Rich variant with lifecycle + runtime context."""

    def __init__(self):
        self._runtime_context: Optional[RuntimeContext] = None

    def open(self, configuration) -> None:  # noqa: B027
        pass

    def close(self) -> None:  # noqa: B027
        pass

    def set_runtime_context(self, ctx: RuntimeContext) -> None:
        self._runtime_context = ctx

    def get_runtime_context(self) -> RuntimeContext:
        if self._runtime_context is None:
            raise RuntimeError("runtime context not initialized; "
                               "function not opened yet")
        return self._runtime_context


class MapFunction(Function, Generic[IN, OUT], abc.ABC):
    @abc.abstractmethod
    def map(self, value: IN) -> OUT:
        ...


class FlatMapFunction(Function, Generic[IN, OUT], abc.ABC):
    """Returns an iterable of outputs per input."""

    @abc.abstractmethod
    def flat_map(self, value: IN) -> Iterable[OUT]:
        ...


class FilterFunction(Function, Generic[IN], abc.ABC):
    @abc.abstractmethod
    def filter(self, value: IN) -> bool:
        ...


class ReduceFunction(Function, Generic[IN], abc.ABC):
    @abc.abstractmethod
    def reduce(self, value1: IN, value2: IN) -> IN:
        ...


class FoldFunction(Function, Generic[IN, OUT], abc.ABC):
    @abc.abstractmethod
    def fold(self, accumulator: OUT, value: IN) -> OUT:
        ...


class AggregateFunction(Function, Generic[IN, ACC, OUT], abc.ABC):
    """Incremental aggregation contract: create_accumulator / add /
    get_result / merge.  Implementations whose accumulator is a
    fixed-shape array state additionally implement
    :class:`flink_tpu_torch.ops.device_agg.DeviceAggregateFunction` to
    run micro-batched on the card.

    **The lift probe.**  Any other Python aggregate runs batched on the
    generic tier (``streaming/generic_agg.py``) when the window shape
    is eligible: the runtime probes it on a sample of at most 64
    records of the first batch, replaying ``add`` / ``merge`` /
    ``get_result`` with numpy columns in place of the scalar
    accumulator fields against a per-record scalar reference.  Only an
    exact match locks the lifted mode; an exception or a mismatch pins
    the per-record scalar fold.  The contract this relies on:

    - the accumulator is a number or a fixed-arity tuple/list of
      numbers whose shape never changes across ``add``;
    - ``add`` / ``merge`` / ``get_result`` are built from operations
      numpy broadcasts elementwise (arithmetic, comparisons, ufuncs).
      Python control flow on accumulator values (``if acc > ...:``)
      fails the probe and demotes to the scalar fold, which is safe.

    A probe can pass while lifting is still unwanted: the sample may
    miss a value-dependent branch, or numpy's dtype promotion may hide
    an overflow the scalar path would raise on.  Set the class or
    instance attribute ``force_scalar = True`` to skip the probe and
    pin the scalar fold; ``GenericWindowOperator(force_scalar=True)``
    offers the same per operator.

    **Ahead-of-time analysis.**  Before the probe runs, the liftability
    analyzer (:mod:`flink_tpu_torch.analysis.liftability`) reads the
    bytecode of ``add`` / ``merge`` / ``get_result``.  A conclusive
    verdict decides the mode without the probe's scalar replay; an
    inconclusive one leaves the probe in charge.  Set
    ``force_probe = True`` to ignore the static verdict and always let
    the runtime probe decide.
    """

    #: opt out of the generic tier's lift probe (see the class docstring)
    force_scalar: bool = False
    #: opt out of the ahead-of-time analysis: always probe
    force_probe: bool = False

    @abc.abstractmethod
    def create_accumulator(self) -> ACC:
        ...

    @abc.abstractmethod
    def add(self, value: IN, accumulator: ACC) -> ACC:
        ...

    @abc.abstractmethod
    def get_result(self, accumulator: ACC) -> OUT:
        ...

    @abc.abstractmethod
    def merge(self, a: ACC, b: ACC) -> ACC:
        ...


class KeySelector(Function, Generic[IN, KEY], abc.ABC):
    @abc.abstractmethod
    def get_key(self, value: IN) -> KEY:
        ...


def as_map_function(fn) -> MapFunction:
    if isinstance(fn, MapFunction):
        return fn
    if callable(fn):
        return _LambdaMap(fn)
    raise TypeError(f"not a map function: {fn!r}")


def as_flat_map_function(fn) -> FlatMapFunction:
    if isinstance(fn, FlatMapFunction):
        return fn
    if callable(fn):
        return _LambdaFlatMap(fn)
    raise TypeError(f"not a flat-map function: {fn!r}")


def as_filter_function(fn) -> FilterFunction:
    if isinstance(fn, FilterFunction):
        return fn
    if callable(fn):
        return _LambdaFilter(fn)
    raise TypeError(f"not a filter function: {fn!r}")


# The lambda adapters keep the callable as ``_fn``: the column kernels
# apply it to whole columns (a filter's ``bool()`` would reject a mask).

class _LambdaMap(MapFunction):
    def __init__(self, fn):
        self._fn = fn

    def map(self, value):
        return self._fn(value)


class _LambdaFlatMap(FlatMapFunction):
    def __init__(self, fn):
        self._fn = fn

    def flat_map(self, value):
        out = self._fn(value)
        return out if out is not None else ()


class _LambdaFilter(FilterFunction):
    def __init__(self, fn):
        self._fn = fn

    def filter(self, value):
        return bool(self._fn(value))


class _LambdaReduce(ReduceFunction):
    def __init__(self, fn):
        self._fn = fn

    def reduce(self, value1, value2):
        return self._fn(value1, value2)


def as_reduce_function(fn) -> ReduceFunction:
    if isinstance(fn, ReduceFunction):
        return fn
    if callable(fn):
        return _LambdaReduce(fn)
    raise TypeError(f"not a reduce function: {fn!r}")


def as_key_selector(fn) -> KeySelector:
    if isinstance(fn, KeySelector):
        return fn
    if callable(fn):
        return _LambdaKeySelector(fn)
    if isinstance(fn, (str, int)):
        return _FieldKeySelector(fn)
    if isinstance(fn, (tuple, list)) and all(isinstance(f, (str, int)) for f in fn):
        return _CompositeFieldKeySelector(tuple(fn))
    raise TypeError(f"not a key selector: {fn!r}")


class _LambdaKeySelector(KeySelector):
    def __init__(self, fn):
        self._fn = fn

    def get_key(self, value):
        return self._fn(value)


class _FieldKeySelector(KeySelector):
    """keyBy("word") / keyBy(0): positional or named field access."""

    def __init__(self, field):
        self._field = field

    def get_key(self, value):
        if isinstance(self._field, int):
            return value[self._field]
        if isinstance(value, dict):
            return value[self._field]
        return getattr(value, self._field)


class _CompositeFieldKeySelector(KeySelector):
    def __init__(self, fields):
        self._selectors = tuple(_FieldKeySelector(f) for f in fields)

    def get_key(self, value):
        return tuple(s.get_key(value) for s in self._selectors)
