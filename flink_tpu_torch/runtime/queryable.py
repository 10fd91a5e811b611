"""Queryable state: point reads into live keyed state from another
thread (port of ``flink_tpu/runtime/queryable.py``).

A keyed backend registers each queryable state with a
``KvStateRegistry`` (``KeyedStream.as_queryable_state`` registers with
``DEFAULT_REGISTRY``); the client routes a key through the key-group
arithmetic the runtime partitions by (key → key group → the backend
whose range holds it) and reads the value.  Reads are dirty: no
checkpoint consistency, as in the reference.

A read never touches the owner's current key or namespace.  A host
table is read by key; a device aggregate of the GPU backend is read by
``DeviceAggregatingState.query_by_key``: one gathered result launch
(``hll_estimate`` for HLL) under the state's device lock, so it cannot
run ahead of a flush into the same rows.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

from flink_tpu_torch.core.keygroups import assign_to_key_group
from flink_tpu_torch.state.backend import VOID_NAMESPACE


class KvStateRegistry:
    """Where each queryable state's key-group ranges live."""

    def __init__(self):
        self._lock = threading.Lock()
        #: state_name -> [(key_group_range, backend, descriptor)]
        self._entries: Dict[str, List[Tuple[Any, Any, Any]]] = {}

    def register(self, state_name: str, key_group_range, backend,
                 descriptor) -> None:
        """A restart or a new job registers ranges that may overlap the
        old ones (at another parallelism, too): the newest registration
        wins every key group it covers."""
        with self._lock:
            entries = self._entries.setdefault(state_name, [])

            def overlaps(r):
                lo = max(r.start_key_group, key_group_range.start_key_group)
                hi = min(r.end_key_group, key_group_range.end_key_group)
                return lo <= hi
            entries[:] = [(r, b, d) for (r, b, d) in entries
                          if not overlaps(r)]
            entries.append((key_group_range, backend, descriptor))

    def unregister_all(self, state_name: Optional[str] = None) -> None:
        with self._lock:
            if state_name is None:
                self._entries.clear()
            else:
                self._entries.pop(state_name, None)

    def locate(self, state_name: str, key) -> Tuple[Any, Any]:
        with self._lock:
            entries = list(self._entries.get(state_name, ()))
        if not entries:
            raise KeyError(f"no queryable state {state_name!r} registered")
        for rng, backend, desc in entries:
            kg = assign_to_key_group(key, backend.max_parallelism)
            if rng.contains(kg):
                return backend, desc
        raise KeyError(
            f"no instance of {state_name!r} owns the key group of {key!r}")


#: the process-wide registry
DEFAULT_REGISTRY = KvStateRegistry()


class QueryableStateClient:
    """``get_kv_state(name, key)`` from any thread."""

    def __init__(self, registry: Optional[KvStateRegistry] = None):
        self.registry = registry or DEFAULT_REGISTRY

    def get_kv_state(self, state_name: str, key, namespace=VOID_NAMESPACE):
        """The current value of ``state_name`` for ``key``: what
        ``state.get()`` would give (an aggregating state's result, not
        its accumulator), or the descriptor's default when the key has
        none."""
        backend, desc = self.registry.locate(state_name, key)
        # binds without setting the state's namespace, which belongs to
        # the owner's thread
        state = backend.get_or_create_keyed_state(desc)
        table = getattr(state, "_table", None)
        if table is not None:
            value = table.get(key, namespace)
            agg = getattr(desc, "aggregate_function", None)
            if value is not None and agg is not None:
                value = agg.get_result(value)
        else:
            query = getattr(state, "query_by_key", None)
            if query is None:
                raise NotImplementedError(
                    f"{type(state).__name__} supports neither table "
                    "nor device queryable reads")
            value = query(key, namespace)
        if value is None and hasattr(desc, "get_default_value"):
            return desc.get_default_value()
        return value
