"""User-facing keyed-state API: state interfaces and descriptors (port
of ``flink_tpu/core/state.py``).

A descriptor names a state, carries its serializer (the
``PickleSerializer`` unless one is given, or one picked from
``type_hint``), its default value and, for reducing, aggregating and
folding state, the user function; backends bind descriptors to live
state objects.  A snapshot records each state's serializer
configuration, and a restore holds it against the registered
serializer (``state/backend.py``).  ``set_queryable`` names the state
for the queryable-state client (``runtime/queryable.py``).
"""

from __future__ import annotations

import abc
from typing import Any, Generic, Iterable, Optional, Tuple, TypeVar

from flink_tpu_torch.core.functions import (AggregateFunction, FoldFunction,
                                            ReduceFunction, as_reduce_function)
from flink_tpu_torch.core.serialization import (PickleSerializer,
                                                TypeSerializer,
                                                serializer_for)

T = TypeVar("T")
K = TypeVar("K")
V = TypeVar("V")
IN = TypeVar("IN")
ACC = TypeVar("ACC")
OUT = TypeVar("OUT")


# ---------------------------------------------------------------------
# State interfaces
# ---------------------------------------------------------------------

class State(abc.ABC):
    @abc.abstractmethod
    def clear(self) -> None:
        ...


class ValueState(State, Generic[T]):
    @abc.abstractmethod
    def value(self) -> Optional[T]:
        ...

    @abc.abstractmethod
    def update(self, value: Optional[T]) -> None:
        ...


class AppendingState(State, Generic[IN, OUT]):
    @abc.abstractmethod
    def get(self) -> Optional[OUT]:
        ...

    @abc.abstractmethod
    def add(self, value: IN) -> None:
        ...


class MergingState(AppendingState[IN, OUT]):
    """Marker: backends can merge namespaces of this state."""


class ListState(MergingState[T, Iterable[T]]):
    @abc.abstractmethod
    def update(self, values: Iterable[T]) -> None:
        ...

    @abc.abstractmethod
    def add_all(self, values: Iterable[T]) -> None:
        ...


class ReducingState(MergingState[T, T]):
    pass


class AggregatingState(MergingState[IN, OUT]):
    pass


class FoldingState(AppendingState[IN, OUT]):
    pass


class MapState(State, Generic[K, V]):
    @abc.abstractmethod
    def get(self, key: K) -> Optional[V]:
        ...

    @abc.abstractmethod
    def put(self, key: K, value: V) -> None:
        ...

    @abc.abstractmethod
    def put_all(self, mapping: dict) -> None:
        ...

    @abc.abstractmethod
    def remove(self, key: K) -> None:
        ...

    @abc.abstractmethod
    def contains(self, key: K) -> bool:
        ...

    @abc.abstractmethod
    def entries(self) -> Iterable[Tuple[K, V]]:
        ...

    @abc.abstractmethod
    def keys(self) -> Iterable[K]:
        ...

    @abc.abstractmethod
    def values(self) -> Iterable[V]:
        ...

    @abc.abstractmethod
    def is_empty(self) -> bool:
        ...


# ---------------------------------------------------------------------
# Descriptors
# ---------------------------------------------------------------------

class StateDescriptor(Generic[T]):
    """Names a state and carries its serializer and default value."""

    #: the kind of state; a name bound as one kind cannot rebind as another
    TYPE = "value"

    def __init__(self, name: str, serializer: Optional[TypeSerializer] = None,
                 default_value: Optional[T] = None,
                 type_hint: Optional[Any] = None):
        if not name:
            raise ValueError("state name must be non-empty")
        self.name = name
        if serializer is None:
            serializer = (serializer_for(type_hint) if type_hint is not None
                          else PickleSerializer())
        self.serializer = serializer
        self.default_value = default_value
        self.queryable_state_name: Optional[str] = None

    def set_queryable(self, queryable_state_name: str) -> None:
        self.queryable_state_name = queryable_state_name

    @property
    def is_queryable(self) -> bool:
        return self.queryable_state_name is not None

    def get_default_value(self) -> Optional[T]:
        if self.default_value is not None:
            return self.serializer.copy(self.default_value)
        return None

    def __eq__(self, other):
        return (type(self) is type(other) and self.name == other.name
                and self.serializer == other.serializer)

    def __hash__(self):
        return hash((type(self).__name__, self.name))

    def __repr__(self):
        return f"{type(self).__name__}(name={self.name!r})"


class ValueStateDescriptor(StateDescriptor[T]):
    TYPE = "value"


class ListStateDescriptor(StateDescriptor[T]):
    TYPE = "list"


class ReducingStateDescriptor(StateDescriptor[T]):
    TYPE = "reducing"

    def __init__(self, name: str, reduce_function, serializer=None, **kw):
        super().__init__(name, serializer, **kw)
        self.reduce_function: ReduceFunction = as_reduce_function(reduce_function)


class AggregatingStateDescriptor(StateDescriptor[ACC], Generic[IN, ACC, OUT]):
    TYPE = "aggregating"

    def __init__(self, name: str, aggregate_function: AggregateFunction,
                 serializer=None, **kw):
        super().__init__(name, serializer, **kw)
        if not isinstance(aggregate_function, AggregateFunction):
            raise TypeError("aggregate_function must be an AggregateFunction")
        self.aggregate_function = aggregate_function


class FoldingStateDescriptor(StateDescriptor[OUT], Generic[IN, OUT]):
    TYPE = "folding"

    def __init__(self, name: str, initial_value: OUT, fold_function,
                 serializer=None, **kw):
        super().__init__(name, serializer, default_value=initial_value, **kw)
        if isinstance(fold_function, FoldFunction):
            self.fold_function = fold_function.fold
        elif callable(fold_function):
            self.fold_function = fold_function
        else:
            raise TypeError("fold_function must be callable")


class MapStateDescriptor(StateDescriptor, Generic[K, V]):
    TYPE = "map"

    def __init__(self, name: str, key_serializer=None, value_serializer=None,
                 **kw):
        super().__init__(name, serializer=None, **kw)
        self.key_serializer = key_serializer or PickleSerializer()
        self.value_serializer = value_serializer or PickleSerializer()
