"""Schema'd records with evolution (port of ``flink_tpu/core/records.py``).

- :class:`RecordSchema`: named, typed fields with optional defaults; a
  stable fingerprint identifies a schema version.
- :class:`RecordSerializer`: serializes dict records; every value is
  prefixed with its writer schema's fingerprint, so old and new bytes
  coexist in one state and each decodes under the schema that wrote
  it, then resolves to the reader schema.
- Compatibility rides the migration seam of ``serialization.py``: the
  config snapshot records the schema; ``ensure_compatibility`` accepts
  a writer schema the reader can resolve (and registers it for reads)
  and rejects any other, which a backend's restore raises as
  ``StateMigrationException``.

Resolution rules: a reader field present in the writer keeps its type
or promotes long to double; a reader field missing in the writer needs
a default; a writer field missing in the reader is skipped.
"""


from __future__ import annotations

import hashlib
import io
import struct
from typing import Any, Dict, List, Optional, Tuple

from flink_tpu_torch.core.serialization import (
    SerializerConfigSnapshot,
    StateMigrationException,
    TypeSerializer,
)

#: field type tags and their codecs
_TYPES = ("long", "double", "string", "bool", "bytes")
_NO_DEFAULT = object()


class RecordField:
    __slots__ = ("name", "type", "default")

    def __init__(self, name: str, type: str, default: Any = _NO_DEFAULT):
        if type not in _TYPES:
            raise ValueError(f"unknown field type {type!r}; "
                             f"choose from {_TYPES}")
        self.name = name
        self.type = type
        self.default = default

    @property
    def has_default(self) -> bool:
        return self.default is not _NO_DEFAULT

    def to_dict(self) -> dict:
        d = {"name": self.name, "type": self.type}
        if self.has_default:
            d["default"] = self.default
        return d

    @staticmethod
    def from_dict(d: dict) -> "RecordField":
        return RecordField(d["name"], d["type"],
                           d.get("default", _NO_DEFAULT)
                           if "default" in d else _NO_DEFAULT)


class RecordSchema:
    """An ordered set of named fields (ref: the Avro record schema)."""

    def __init__(self, fields: List[Tuple]):
        self.fields: List[RecordField] = [
            f if isinstance(f, RecordField) else RecordField(*f)
            for f in fields]
        names = [f.name for f in self.fields]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate field names in {names}")

    def fingerprint(self) -> bytes:
        """8-byte stable id of (names, types) — defaults don't change
        the WIRE format, so they stay out of the fingerprint."""
        spec = "|".join(f"{f.name}:{f.type}" for f in self.fields)
        return hashlib.sha256(spec.encode()).digest()[:8]

    def to_dict(self) -> dict:
        return {"fields": [f.to_dict() for f in self.fields]}

    @staticmethod
    def from_dict(d: dict) -> "RecordSchema":
        return RecordSchema([RecordField.from_dict(f)
                             for f in d["fields"]])

    def __eq__(self, other):
        return (isinstance(other, RecordSchema)
                and self.fingerprint() == other.fingerprint())

    def __repr__(self):
        return (f"RecordSchema({[f.name + ':' + f.type for f in self.fields]})")


def _can_resolve(reader: RecordSchema, writer: RecordSchema
                 ) -> Optional[str]:
    """None when `reader` can read data written by `writer`; else the
    reason it cannot (the Avro schema-resolution check)."""
    wtypes = {f.name: f.type for f in writer.fields}
    for f in reader.fields:
        wt = wtypes.get(f.name)
        if wt is None:
            if not f.has_default:
                return (f"reader field {f.name!r} is missing from the "
                        f"writer schema and has no default")
        elif wt != f.type and not (wt == "long" and f.type == "double"):
            return (f"field {f.name!r} changed type {wt} -> {f.type} "
                    f"(only long->double promotes)")
    return None


def _write_value(t: str, v: Any, stream: io.BytesIO) -> None:
    if t == "long":
        stream.write(struct.pack(">q", v))
    elif t == "double":
        stream.write(struct.pack(">d", v))
    elif t == "bool":
        stream.write(struct.pack(">?", v))
    elif t == "string":
        data = v.encode("utf-8")
        stream.write(struct.pack(">i", len(data)))
        stream.write(data)
    else:  # bytes
        stream.write(struct.pack(">i", len(v)))
        stream.write(v)


def _read_value(t: str, stream: io.BytesIO) -> Any:
    if t == "long":
        return struct.unpack(">q", stream.read(8))[0]
    if t == "double":
        return struct.unpack(">d", stream.read(8))[0]
    if t == "bool":
        return struct.unpack(">?", stream.read(1))[0]
    (n,) = struct.unpack(">i", stream.read(4))
    data = stream.read(n)
    return data.decode("utf-8") if t == "string" else data


class RecordSerializer(TypeSerializer[dict]):
    """Serializer for dict records under a :class:`RecordSchema`.

    Values carry their writer schema's fingerprint; the serializer
    keeps a registry of every schema it has been told about (its own
    + any compatible writer registered via `ensure_compatibility`),
    so restored bytes and fresh bytes decode side by side and each
    resolves to the reader schema on read."""

    def __init__(self, schema: RecordSchema):
        self.schema = schema
        self._known: Dict[bytes, RecordSchema] = {
            schema.fingerprint(): schema}

    # ---- wire format ------------------------------------------------
    def serialize(self, value: dict, stream: io.BytesIO) -> None:
        stream.write(self.schema.fingerprint())
        for f in self.schema.fields:
            if f.name in value:
                v = value[f.name]
            elif f.has_default:
                v = f.default
            else:
                raise KeyError(
                    f"record is missing field {f.name!r} (no default)")
            _write_value(f.type, v, stream)

    def deserialize(self, stream: io.BytesIO) -> dict:
        fp = stream.read(8)
        writer = self._known.get(fp)
        if writer is None:
            raise StateMigrationException(
                f"record written under unknown schema fingerprint "
                f"{fp.hex()}; was the state restored without the "
                f"compatibility check?")
        raw = {f.name: _read_value(f.type, stream)
               for f in writer.fields}
        if writer is self.schema:
            return raw
        # reader/writer resolution: project onto the reader schema
        out = {}
        for f in self.schema.fields:
            if f.name in raw:
                v = raw[f.name]
                wt = next(w.type for w in writer.fields
                          if w.name == f.name)
                if wt == "long" and f.type == "double":
                    v = float(v)
                out[f.name] = v
            else:
                out[f.name] = f.default
        return out

    # ---- migration seam ---------------------------------------------
    def snapshot_configuration(self) -> SerializerConfigSnapshot:
        return SerializerConfigSnapshot(
            "RecordSerializer",
            {"schema": self.schema.to_dict(),
             "fingerprint": self.schema.fingerprint().hex()})

    def ensure_compatibility(self, snapshot) -> bool:
        if snapshot.serializer_name != "RecordSerializer":
            return False
        writer = RecordSchema.from_dict(snapshot.details["schema"])
        if _can_resolve(self.schema, writer) is not None:
            return False
        # compatible: register the writer schema so restored values
        # decode (and resolve) under it
        self._known[writer.fingerprint()] = writer
        return True

    def migrate_value(self, value: dict, restored) -> dict:
        """Value-level reader/writer resolution for backends that
        snapshot live objects rather than serializer bytes (the heap
        table): same rules as the byte path."""
        writer = RecordSchema.from_dict(restored.details["schema"])
        wtypes = {f.name: f.type for f in writer.fields}
        out = {}
        for f in self.schema.fields:
            if f.name in value and f.name in wtypes:
                v = value[f.name]
                if wtypes[f.name] == "long" and f.type == "double":
                    v = float(v)
                out[f.name] = v
            else:
                out[f.name] = f.default
        return out

    def __eq__(self, other):
        return (isinstance(other, RecordSerializer)
                and self.schema == other.schema)

    def __hash__(self):
        return hash(self.schema.fingerprint())
