"""Columnar files with the writer's schema in the header (port of
``flink_tpu/core/colformat.py``, the same bytes).

Columns are stored whole (numpy columns copy in and out, no row pivot)
after the writer's ``RecordSchema``, so a reader resolves against its
own schema by the rules of ``records.py``: missing reader fields take
their defaults, extra writer columns are skipped, long promotes to
double.

Layout:
  magic "FTCF1\\n" | schema-JSON length + bytes | n_rows |
  per column: name len+bytes, dtype-descr len+bytes, payload
  (fixed-width columns: raw little-endian array bytes; string
  columns: i64 offsets array + utf-8 blob)
"""


from __future__ import annotations

import json
import os
import struct
from typing import Dict, Optional

import numpy as np

from flink_tpu_torch.core.records import RecordSchema, _can_resolve

__all__ = ["write_columnar_file", "read_columnar_file",
           "ColumnarFileInputFormat", "ColumnarFileOutputFormat"]

_MAGIC = b"FTCF1\n"

#: RecordSchema type -> the numpy dtype it stores as
_TYPE_DTYPES = {"long": np.dtype("<i8"), "double": np.dtype("<f8"),
                "bool": np.dtype("?")}


def _write_block(f, data: bytes) -> None:
    f.write(struct.pack("<q", len(data)))
    f.write(data)


def _read_block(f) -> bytes:
    (n,) = struct.unpack("<q", f.read(8))
    return f.read(n)


def write_columnar_file(path: str, schema: RecordSchema,
                        cols: Dict[str, np.ndarray]) -> None:
    """Write columns under `schema` (every schema field must have a
    column of matching length).  Atomic: temp file + rename."""
    names = [fld.name for fld in schema.fields]
    missing = [n for n in names if n not in cols]
    if missing:
        raise ValueError(f"columns missing for schema fields {missing}")
    n_rows = len(next(iter(cols.values()))) if cols else 0
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        _write_block(f, json.dumps(schema.to_dict()).encode("utf-8"))
        f.write(struct.pack("<q", n_rows))
        for fld in schema.fields:
            col = np.asarray(cols[fld.name])
            if len(col) != n_rows:
                raise ValueError(
                    f"column {fld.name!r} has {len(col)} rows, "
                    f"expected {n_rows}")
            _write_block(f, fld.name.encode("utf-8"))
            if fld.type == "string":
                blobs = [s.encode("utf-8") for s in col.tolist()]
                offsets = np.zeros(n_rows + 1, "<i8")
                np.cumsum([len(b) for b in blobs],
                          out=offsets[1:]) if n_rows else None
                _write_block(f, b"string8")
                _write_block(f, offsets.tobytes())
                _write_block(f, b"".join(blobs))
            elif fld.type == "bytes":
                blobs = list(col.tolist())
                offsets = np.zeros(n_rows + 1, "<i8")
                np.cumsum([len(b) for b in blobs],
                          out=offsets[1:]) if n_rows else None
                _write_block(f, b"bytes8")
                _write_block(f, offsets.tobytes())
                _write_block(f, b"".join(blobs))
            else:
                dt = _TYPE_DTYPES[fld.type]
                _write_block(f, dt.str.encode("ascii"))
                _write_block(f, np.ascontiguousarray(
                    col.astype(dt, copy=False)).tobytes())
    os.replace(tmp, path)


def read_columnar_file(path: str,
                       reader_schema: Optional[RecordSchema] = None
                       ) -> Dict[str, np.ndarray]:
    """Read columns, resolved against `reader_schema` (None = the
    writer's own schema).  Evolution rules match core/records.py."""
    with open(path, "rb") as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            raise ValueError(f"{path!r} is not a columnar file")
        writer = RecordSchema.from_dict(
            json.loads(_read_block(f).decode("utf-8")))
        (n_rows,) = struct.unpack("<q", f.read(8))
        raw: Dict[str, np.ndarray] = {}
        wtypes = {fld.name: fld.type for fld in writer.fields}
        for _ in writer.fields:
            name = _read_block(f).decode("utf-8")
            kind = _read_block(f).decode("ascii")
            if kind in ("string", "bytes", "string8", "bytes8"):
                # "string8"/"bytes8" carry i8 offsets (2 GiB+ columns
                # wrapped the original i4); the DISTINCT kind tag makes
                # an old reader fail loudly on a new file instead of
                # mis-slicing interleaved 32-bit words
                raw_off = _read_block(f)
                # "string8"/"bytes8" are explicitly i8; the LEGACY
                # tags existed with both widths (an i8 interim wrote
                # them untagged), so they sniff by block length
                if kind.endswith("8") \
                        or len(raw_off) == 8 * (n_rows + 1):
                    odt = "<i8"
                else:
                    odt = "<i4"
                offsets = np.frombuffer(raw_off, odt)
                blob = _read_block(f)
                vals = [blob[offsets[i]:offsets[i + 1]]
                        for i in range(n_rows)]
                if kind.startswith("string"):
                    raw[name] = np.asarray(
                        [v.decode("utf-8") for v in vals])
                else:
                    out = np.empty(n_rows, object)
                    out[:] = vals
                    raw[name] = out
            else:
                raw[name] = np.frombuffer(_read_block(f),
                                          np.dtype(kind))
    if reader_schema is None:
        return raw
    reason = _can_resolve(reader_schema, writer)
    if reason is not None:
        raise ValueError(
            f"reader schema cannot read {path!r}: {reason}")
    out: Dict[str, np.ndarray] = {}
    for fld in reader_schema.fields:
        if fld.name in raw:
            col = raw[fld.name]
            if wtypes[fld.name] == "long" and fld.type == "double":
                col = col.astype("<f8")   # the promoting resolution
            out[fld.name] = col
        else:
            default = fld.default
            if fld.type == "string":
                out[fld.name] = np.asarray([default] * n_rows)
            elif fld.type == "bytes":
                o = np.empty(n_rows, object)
                o[:] = [default] * n_rows
                out[fld.name] = o
            else:
                out[fld.name] = np.full(
                    n_rows, default, _TYPE_DTYPES[fld.type])
    return out


class ColumnarFileOutputFormat:
    """DataSet OutputFormat face: rows are dicts (record form) or
    tuples in schema field order."""

    def __init__(self, path: str, schema: RecordSchema):
        self.path = path
        self.schema = schema

    def write(self, records) -> str:
        rows = list(records)
        names = [fld.name for fld in self.schema.fields]
        if rows and not isinstance(rows[0], dict):
            rows = [dict(zip(names, r)) for r in rows]
        cols = {n: np.asarray([r[n] for r in rows]) for n in names} \
            if rows else {n: np.asarray([]) for n in names}
        write_columnar_file(self.path, self.schema, cols)
        return self.path


class ColumnarFileInputFormat:
    """DataSet InputFormat face: yields dict records resolved against
    `reader_schema` (schema evolution applies)."""

    def __init__(self, path: str,
                 reader_schema: Optional[RecordSchema] = None):
        self.path = path
        self.reader_schema = reader_schema

    def read(self):
        cols = read_columnar_file(self.path, self.reader_schema)
        names = list(cols)
        n = len(cols[names[0]]) if names else 0
        pycols = {k: v.tolist() for k, v in cols.items()}
        return [{k: pycols[k][i] for k in names} for i in range(n)]
