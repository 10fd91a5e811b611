"""Operator (non-keyed) state (port of
``flink_tpu/state/operator_state.py:1-171``).

Each operator has named list states, such as a source's read
positions, and named broadcast states, a map that is the same on every
subtask.  A list state redistributes on rescale in one of two modes:

- ``split``: the items of every old subtask are dealt round robin over
  the new subtasks;
- ``union``: every new subtask gets the whole concatenated list.

A snapshot pickles each state's items.  Blobs are written with
``state.portable.dumps`` and read with ``state.portable.loads``, so a
snapshot of either package restores in the other.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Tuple

SPLIT_DISTRIBUTE = "split"
UNION = "union"


def _dumps(obj) -> bytes:
    from flink_tpu_torch.state.portable import dumps
    return dumps(obj)


def _loads(blob: bytes):
    from flink_tpu_torch.state.portable import loads
    return loads(blob)


class OperatorListState:
    def __init__(self, name: str, mode: str = SPLIT_DISTRIBUTE):
        self.name = name
        self.mode = mode
        self._items: List[Any] = []

    def get(self) -> List[Any]:
        return list(self._items)

    def add(self, value) -> None:
        self._items.append(value)

    def add_all(self, values: Iterable[Any]) -> None:
        self._items.extend(values)

    def update(self, values: Iterable[Any]) -> None:
        self._items = list(values)

    def clear(self) -> None:
        self._items.clear()


class BroadcastState:
    """A map kept the same on every subtask."""

    def __init__(self, name: str):
        self.name = name
        self._map: Dict[Any, Any] = {}

    def get(self, key):
        return self._map.get(key)

    def put(self, key, value) -> None:
        self._map[key] = value

    def put_all(self, mapping: dict) -> None:
        self._map.update(mapping)

    def remove(self, key) -> None:
        self._map.pop(key, None)

    def contains(self, key) -> bool:
        return key in self._map

    def entries(self):
        return list(self._map.items())

    def keys(self):
        return list(self._map.keys())

    def values(self):
        return list(self._map.values())

    def immutable_entries(self):
        return tuple(self._map.items())

    def clear(self) -> None:
        self._map.clear()


class OperatorStateSnapshot:
    """name -> (mode, pickled items) list states and name -> pickled
    entries broadcast states."""

    __slots__ = ("list_states", "broadcast_states")

    def __init__(self, list_states: Dict[str, Tuple[str, bytes]],
                 broadcast_states: Dict[str, bytes]):
        self.list_states = list_states
        self.broadcast_states = broadcast_states

    @staticmethod
    def redistribute(snapshots: List["OperatorStateSnapshot"],
                     new_parallelism: int) -> List["OperatorStateSnapshot"]:
        """Every old subtask's state over ``new_parallelism`` subtasks:
        split lists round robin, union lists whole to each, broadcast
        states (the same on every old subtask) to each."""
        all_items: Dict[str, Tuple[str, List[Any]]] = {}
        bcast: Dict[str, bytes] = {}
        for snap in snapshots:
            for name, (mode, blob) in snap.list_states.items():
                all_items.setdefault(name, (mode, []))[1].extend(_loads(blob))
            bcast.update(snap.broadcast_states)
        outs = []
        for i in range(new_parallelism):
            lists = {name: (mode, _dumps(
                items if mode == UNION else items[i::new_parallelism]))
                for name, (mode, items) in all_items.items()}
            outs.append(OperatorStateSnapshot(lists, dict(bcast)))
        return outs


class OperatorStateBackend:
    def __init__(self):
        self._list_states: Dict[str, OperatorListState] = {}
        self._broadcast_states: Dict[str, BroadcastState] = {}

    def get_list_state(self, name: str) -> OperatorListState:
        return self._get_list(name, SPLIT_DISTRIBUTE)

    def get_union_list_state(self, name: str) -> OperatorListState:
        return self._get_list(name, UNION)

    def _get_list(self, name: str, mode: str) -> OperatorListState:
        st = self._list_states.get(name)
        if st is None:
            st = self._list_states[name] = OperatorListState(name, mode)
        elif st.mode != mode:
            raise ValueError(
                f"operator state {name!r} already registered with mode {st.mode}")
        return st

    def get_broadcast_state(self, name: str) -> BroadcastState:
        st = self._broadcast_states.get(name)
        if st is None:
            st = self._broadcast_states[name] = BroadcastState(name)
        return st

    def snapshot(self) -> OperatorStateSnapshot:
        return OperatorStateSnapshot(
            {name: (st.mode, _dumps(st.get()))
             for name, st in self._list_states.items()},
            {name: _dumps(st.entries())
             for name, st in self._broadcast_states.items()})

    def restore(self, snapshot: OperatorStateSnapshot) -> None:
        for name, (mode, blob) in snapshot.list_states.items():
            self._get_list(name, mode).update(_loads(blob))
        for name, blob in snapshot.broadcast_states.items():
            st = self.get_broadcast_state(name)
            st.clear()
            st.put_all(dict(_loads(blob)))

    def dispose(self) -> None:
        self._list_states.clear()
        self._broadcast_states.clear()
