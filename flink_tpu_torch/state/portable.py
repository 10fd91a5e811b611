"""Pickles that cross the two packages: checkpoint and savepoint files
and keyed-state chunks.

A snapshot's envelope holds a few classes that both packages define
with the same fields: ``KeyedStateSnapshot``, ``SharedChunk``,
``ChunkRef``, ``OperatorStateSnapshot``, ``SerializerConfigSnapshot``,
``TimeWindow`` and ``GlobalWindow``.  ``dumps`` writes the port's
instances of them under the JAX package's names, so that package reads
a file of the port with its plain ``pickle`` loader.  The class is
written as a call of ``importlib.import_module`` and ``getattr``:
pickling a class by name would import its module here.

``loads`` reads a file of either package.  Its unpickler maps each of
those JAX-package classes onto the port's copy and refuses every other
class of the JAX package; it never imports that package.

``OperatorStateSnapshot`` and ``SerializerConfigSnapshot`` are kept
here as data only: the JAX package writes them into every operator
and keyed snapshot, the port writes neither (operator state and
serializer migration are not ported).
"""

from __future__ import annotations

import importlib
import io
import pickle
import types
from typing import Any, Dict, List, Optional, Tuple

_REF = "flink_tpu"


class OperatorStateSnapshot:
    """The JAX package's operator-state snapshot: name -> (mode,
    pickled items) list states and name -> pickled broadcast states."""

    __slots__ = ("list_states", "broadcast_states")

    def __init__(self, list_states: Dict[str, Tuple[str, bytes]],
                 broadcast_states: Dict[str, bytes]):
        self.list_states = list_states
        self.broadcast_states = broadcast_states

    @staticmethod
    def redistribute(snapshots: List["OperatorStateSnapshot"],
                     new_parallelism: int) -> List["OperatorStateSnapshot"]:
        """Round-robin re-split of every old subtask's list items over
        ``new_parallelism`` subtasks; union lists go whole to each."""
        all_items: Dict[str, Tuple[str, List[Any]]] = {}
        bcast: Dict[str, bytes] = {}
        for snap in snapshots:
            for name, (mode, blob) in snap.list_states.items():
                all_items.setdefault(name, (mode, []))[1].extend(loads(blob))
            bcast.update(snap.broadcast_states)
        outs = []
        for i in range(new_parallelism):
            lists = {name: (mode, pickle.dumps(
                items if mode == "union" else items[i::new_parallelism]))
                for name, (mode, items) in all_items.items()}
            outs.append(OperatorStateSnapshot(lists, dict(bcast)))
        return outs


class SerializerConfigSnapshot:
    """A state's serializer name and configuration, as the JAX
    package records it in a keyed snapshot's meta."""

    def __init__(self, serializer_name: str, details: Optional[dict] = None):
        self.serializer_name = serializer_name
        self.details = details or {}

    def __eq__(self, other):
        return (getattr(other, "serializer_name", None) == self.serializer_name
                and getattr(other, "details", None) == self.details)

    def __repr__(self):
        return f"SerializerConfigSnapshot({self.serializer_name}, {self.details})"


def _classes() -> Dict[Tuple[str, str], type]:
    """(JAX-package module, class name) -> the port's class."""
    from flink_tpu_torch.state.backend import KeyedStateSnapshot
    from flink_tpu_torch.state.shared_registry import ChunkRef, SharedChunk
    from flink_tpu_torch.streaming.windowing import GlobalWindow, TimeWindow
    return {
        (f"{_REF}.state.backend", "KeyedStateSnapshot"): KeyedStateSnapshot,
        (f"{_REF}.state.shared_registry", "SharedChunk"): SharedChunk,
        (f"{_REF}.state.shared_registry", "ChunkRef"): ChunkRef,
        (f"{_REF}.state.operator_state", "OperatorStateSnapshot"):
            OperatorStateSnapshot,
        (f"{_REF}.core.serialization", "SerializerConfigSnapshot"):
            SerializerConfigSnapshot,
        (f"{_REF}.streaming.windowing", "TimeWindow"): TimeWindow,
        (f"{_REF}.streaming.windowing", "GlobalWindow"): GlobalWindow,
    }


_TABLES: Dict[str, Any] = {}


def _tables():
    if not _TABLES:
        classes = _classes()
        _TABLES["imports"] = classes
        modules: Dict[str, Dict[str, type]] = {}
        for (mod, name), cls in classes.items():
            modules.setdefault(mod, {})[name] = cls
        _TABLES["modules"] = {mod: types.SimpleNamespace(**names)
                              for mod, names in modules.items()}
        _TABLES["exports"] = {cls: _ClassByName(mod, name)
                              for (mod, name), cls in classes.items()}
    return _TABLES


# ---- writing ----------------------------------------------------------

class _ModuleByName:
    """Pickles as ``importlib.import_module(name)``."""

    def __init__(self, name: str):
        self.name = name

    def __reduce__(self):
        return importlib.import_module, (self.name,)


class _ClassByName:
    """Pickles as ``getattr(import_module(module), name)``."""

    def __init__(self, module: str, name: str):
        self.module = _ModuleByName(module)
        self.name = name

    def __reduce__(self):
        return getattr, (self.module, self.name)

    def __call__(self, *args):
        # a reduce tuple's first item must be callable; this one is
        # only ever written, and it names the class that loads it
        raise TypeError(f"{self.module.name}.{self.name} is resolved "
                        "when a file is loaded")


def _ctor_args(obj) -> tuple:
    """The JAX-package constructor's arguments for a port instance."""
    name = type(obj).__name__
    if name == "KeyedStateSnapshot":
        return dict(obj.key_group_bytes), obj.meta, False
    if name == "SharedChunk":
        return obj.payload, obj.hash
    if name == "ChunkRef":
        return (obj.hash,)
    if name == "OperatorStateSnapshot":
        return obj.list_states, obj.broadcast_states
    if name == "SerializerConfigSnapshot":
        return obj.serializer_name, obj.details
    if name == "TimeWindow":
        return obj.start, obj.end
    return ()  # GlobalWindow


class _Pickler(pickle.Pickler):
    def reducer_override(self, obj):
        cls = _tables()["exports"].get(type(obj))
        if cls is None:
            return NotImplemented
        return cls, _ctor_args(obj)


def dump(obj, f) -> None:
    _Pickler(f, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)


def dumps(obj) -> bytes:
    buf = io.BytesIO()
    dump(obj, buf)
    return buf.getvalue()


# ---- reading ----------------------------------------------------------

def _is_reference_module(module: str) -> bool:
    return module == _REF or module.startswith(_REF + ".")


def _import_module(name: str):
    """``import_module`` as a file may call it: the JAX package's
    modules of the shared classes map onto the port's copies, the
    port's own modules import, anything else is refused."""
    table = _tables()["modules"]
    if name in table:
        return table[name]
    if name == "flink_tpu_torch" or name.startswith("flink_tpu_torch."):
        return importlib.import_module(name)
    raise pickle.UnpicklingError(
        f"a checkpoint file asks to import {name!r}; the port loads only "
        "the shared snapshot classes and its own modules")


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "importlib" and name == "import_module":
            return _import_module
        if _is_reference_module(module):
            cls = _tables()["imports"].get((module, name))
            if cls is None:
                raise pickle.UnpicklingError(
                    f"{module}.{name} is a class of the JAX package that the "
                    "port does not read (only the shared snapshot classes "
                    "cross the packages)")
            return cls
        return super().find_class(module, name)


def load(f):
    return _Unpickler(f).load()


def loads(data: bytes):
    return _Unpickler(io.BytesIO(data)).load()
