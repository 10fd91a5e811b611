"""User-function SPI (subset of ``flink_tpu/core/functions.py:25-230``).

Plain callables are accepted wherever a single-method function is
expected; the classes exist for the rich lifecycle (open/close) and
for the multi-method ``AggregateFunction`` contract that the device
window engine vectorizes.
"""

from __future__ import annotations

import abc
from typing import Any, Generic, Optional, TypeVar

IN = TypeVar("IN")
OUT = TypeVar("OUT")
ACC = TypeVar("ACC")
KEY = TypeVar("KEY")


class Function:
    """Marker base for all user functions."""


class RuntimeContext:
    """Per-subtask metadata handed to rich functions."""

    def __init__(self, task_name: str = "task", index_of_subtask: int = 0,
                 parallelism: int = 1, max_parallelism: int = 128):
        self.task_name = task_name
        self.index_of_this_subtask = index_of_subtask
        self.number_of_parallel_subtasks = parallelism
        self.max_number_of_parallel_subtasks = max_parallelism
        self.accumulators: dict[str, Any] = {}


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
    run micro-batched on the card."""

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
