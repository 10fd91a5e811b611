"""Type serializers (port of ``flink_tpu/core/serialization.py``).

A ``TypeSerializer`` writes a value to bytes and back, in the same byte
layout as the reference package, so checkpoint, savepoint and
sharded-stream files cross the two packages.  Each serializer has a
``SerializerConfigSnapshot``: a keyed snapshot records one per state,
and a restore asks the registered serializer whether it can read it
(``ensure_compatibility``; else ``StateMigrationException``) and, when
the configuration changed but stays readable, migrates every restored
value (``migrate_value``).
"""


from __future__ import annotations

import abc
import io
import pickle
import struct
from typing import Any, Generic, Optional, TypeVar

import numpy as np

T = TypeVar("T")


class StateMigrationException(Exception):
    """A restored state's recorded serializer configuration is not
    readable by the currently registered serializer (ref:
    flink-runtime/.../state/StateMigrationException.java + the
    TypeSerializerConfigSnapshot compatibility contract)."""


class TypeSerializer(Generic[T], abc.ABC):
    """(ref: flink-core/.../typeutils/TypeSerializer.java)"""

    @abc.abstractmethod
    def serialize(self, value: T, stream: io.BytesIO) -> None:
        ...

    @abc.abstractmethod
    def deserialize(self, stream: io.BytesIO) -> T:
        ...

    def serialize_to_bytes(self, value: T) -> bytes:
        buf = io.BytesIO()
        self.serialize(value, buf)
        return buf.getvalue()

    def deserialize_from_bytes(self, data: bytes) -> T:
        return self.deserialize(io.BytesIO(data))

    def copy(self, value: T) -> T:
        """Deep copy of a value; default round-trips through bytes."""
        return self.deserialize_from_bytes(self.serialize_to_bytes(value))

    def create_instance(self) -> Optional[T]:
        return None

    def snapshot_configuration(self) -> "SerializerConfigSnapshot":
        return SerializerConfigSnapshot(type(self).__name__)

    def ensure_compatibility(self, snapshot: "SerializerConfigSnapshot") -> bool:
        """True if state written with `snapshot`'s serializer can be read
        (ref: TypeSerializerConfigSnapshot compatibility checks)."""
        return snapshot.serializer_name == type(self).__name__

    def migrate_value(self, value: T,
                      restored: "SerializerConfigSnapshot") -> T:
        """Transform a value restored from state written under
        `restored`'s (compatible) configuration into this serializer's
        current shape — the COMPATIBLE_AFTER_MIGRATION leg of the
        reference's TypeSerializerSchemaCompatibility.  Backends call
        it for every restored value of a state whose recorded config
        differs from the registered serializer's.  Default: identity
        (most serializers are compatible as-is)."""
        return value

    # the numpy dtype values of this type embed into losslessly
    def numpy_dtype(self) -> Optional[np.dtype]:
        """dtype if values of this type embed losslessly into a numpy
        array (enables the vectorized device path); None otherwise."""
        return None

    def __eq__(self, other):
        return type(self) is type(other)

    def __hash__(self):
        return hash(type(self))


class SerializerConfigSnapshot:
    """(ref: flink-core/.../typeutils/TypeSerializerConfigSnapshot.java)"""

    def __init__(self, serializer_name: str, details: Optional[dict] = None):
        self.serializer_name = serializer_name
        self.details = details or {}

    def __eq__(self, other):
        # by fields: a configuration the other package recorded is equal
        # to this package's copy of it
        return (getattr(other, "serializer_name", None) == self.serializer_name
                and getattr(other, "details", None) == self.details)

    def __repr__(self):
        return f"SerializerConfigSnapshot({self.serializer_name}, {self.details})"


class _StructSerializer(TypeSerializer[T]):
    FMT = ""

    def serialize(self, value, stream):
        stream.write(struct.pack(self.FMT, value))

    def deserialize(self, stream):
        size = struct.calcsize(self.FMT)
        return struct.unpack(self.FMT, stream.read(size))[0]

    def copy(self, value):
        return value


class LongSerializer(_StructSerializer[int]):
    """(ref: flink-core/.../typeutils/base/LongSerializer.java)"""
    FMT = ">q"

    def create_instance(self):
        return 0

    def numpy_dtype(self):
        return np.dtype(np.int64)


class IntSerializer(_StructSerializer[int]):
    FMT = ">i"

    def create_instance(self):
        return 0

    def numpy_dtype(self):
        return np.dtype(np.int32)


class DoubleSerializer(_StructSerializer[float]):
    FMT = ">d"

    def create_instance(self):
        return 0.0

    def numpy_dtype(self):
        return np.dtype(np.float64)


class FloatSerializer(_StructSerializer[float]):
    FMT = ">f"

    def numpy_dtype(self):
        return np.dtype(np.float32)


class BooleanSerializer(_StructSerializer[bool]):
    FMT = ">?"

    def numpy_dtype(self):
        return np.dtype(np.bool_)


class StringSerializer(TypeSerializer[str]):
    """(ref: flink-core/.../typeutils/base/StringSerializer.java)"""

    def serialize(self, value, stream):
        data = value.encode("utf-8")
        stream.write(struct.pack(">i", len(data)))
        stream.write(data)

    def deserialize(self, stream):
        (n,) = struct.unpack(">i", stream.read(4))
        return stream.read(n).decode("utf-8")

    def copy(self, value):
        return value

    def create_instance(self):
        return ""


class BytesSerializer(TypeSerializer[bytes]):
    def serialize(self, value, stream):
        stream.write(struct.pack(">i", len(value)))
        stream.write(value)

    def deserialize(self, stream):
        (n,) = struct.unpack(">i", stream.read(4))
        return stream.read(n)

    def copy(self, value):
        return value


class PickleSerializer(TypeSerializer[Any]):
    """Fallback generic serializer — plays the role of the reference's
    Kryo fallback (ref: flink-core/.../typeutils/runtime/kryo/)."""

    def serialize(self, value, stream):
        data = pickle.dumps(value, protocol=pickle.HIGHEST_PROTOCOL)
        stream.write(struct.pack(">i", len(data)))
        stream.write(data)

    def deserialize(self, stream):
        (n,) = struct.unpack(">i", stream.read(4))
        return pickle.loads(stream.read(n))


class TupleSerializer(TypeSerializer[tuple]):
    """(ref: flink-core/.../typeutils/runtime/TupleSerializer.java)"""

    def __init__(self, field_serializers: "list[TypeSerializer]"):
        self.field_serializers = list(field_serializers)

    def serialize(self, value, stream):
        for fs, v in zip(self.field_serializers, value):
            fs.serialize(v, stream)

    def deserialize(self, stream):
        return tuple(fs.deserialize(stream) for fs in self.field_serializers)

    def snapshot_configuration(self):
        return SerializerConfigSnapshot(
            "TupleSerializer",
            {"fields": [fs.snapshot_configuration().serializer_name
                        for fs in self.field_serializers]})

    def ensure_compatibility(self, snapshot):
        return (snapshot.serializer_name == "TupleSerializer"
                and snapshot.details.get("fields")
                == [fs.snapshot_configuration().serializer_name
                    for fs in self.field_serializers])

    def __eq__(self, other):
        return (isinstance(other, TupleSerializer)
                and self.field_serializers == other.field_serializers)


class ListSerializer(TypeSerializer[list]):
    def __init__(self, element_serializer: TypeSerializer):
        self.element_serializer = element_serializer

    def serialize(self, value, stream):
        stream.write(struct.pack(">i", len(value)))
        for v in value:
            self.element_serializer.serialize(v, stream)

    def deserialize(self, stream):
        (n,) = struct.unpack(">i", stream.read(4))
        return [self.element_serializer.deserialize(stream) for _ in range(n)]

    def __eq__(self, other):
        return (isinstance(other, ListSerializer)
                and self.element_serializer == other.element_serializer)


class MapSerializer(TypeSerializer[dict]):
    def __init__(self, key_serializer: TypeSerializer, value_serializer: TypeSerializer):
        self.key_serializer = key_serializer
        self.value_serializer = value_serializer

    def serialize(self, value, stream):
        stream.write(struct.pack(">i", len(value)))
        for k, v in value.items():
            self.key_serializer.serialize(k, stream)
            self.value_serializer.serialize(v, stream)

    def deserialize(self, stream):
        (n,) = struct.unpack(">i", stream.read(4))
        return {self.key_serializer.deserialize(stream): self.value_serializer.deserialize(stream)
                for _ in range(n)}

    def __eq__(self, other):
        return (isinstance(other, MapSerializer)
                and self.key_serializer == other.key_serializer
                and self.value_serializer == other.value_serializer)


class NumpyArraySerializer(TypeSerializer[np.ndarray]):
    """ndarray values: a dtype|shape header and the raw bytes
    (accumulator snapshots of the device backend)."""

    def serialize(self, value, stream):
        arr = np.ascontiguousarray(value)
        header = f"{arr.dtype.str}|{','.join(map(str, arr.shape))}".encode()
        stream.write(struct.pack(">i", len(header)))
        stream.write(header)
        data = arr.tobytes()
        stream.write(struct.pack(">q", len(data)))
        stream.write(data)

    def deserialize(self, stream):
        (hn,) = struct.unpack(">i", stream.read(4))
        # the shape holds no "|", a dtype may ("|u1"): split at the last
        dtype_str, _, shape_str = stream.read(hn).decode().rpartition("|")
        shape = tuple(int(s) for s in shape_str.split(",")) if shape_str else ()
        (dn,) = struct.unpack(">q", stream.read(8))
        return np.frombuffer(stream.read(dn), dtype=np.dtype(dtype_str)).reshape(shape).copy()

    def copy(self, value):
        return np.array(value, copy=True)


def serializer_for(value_or_type: Any) -> TypeSerializer:
    """Type extraction: pick a serializer from an example value or a
    type (ref: flink-core/.../typeutils/TypeExtractor.java — reflective
    extraction becomes duck-typed dispatch)."""
    t = value_or_type if isinstance(value_or_type, type) else type(value_or_type)
    if t is bool:
        return BooleanSerializer()
    if t is int or issubclass(t, (int, np.integer)):
        return LongSerializer()
    if t is float or issubclass(t, (float, np.floating)):
        return DoubleSerializer()
    if t is str:
        return StringSerializer()
    if t is bytes:
        return BytesSerializer()
    if t is np.ndarray:
        return NumpyArraySerializer()
    if t is tuple and not isinstance(value_or_type, type):
        return TupleSerializer([serializer_for(v) for v in value_or_type])
    return PickleSerializer()
