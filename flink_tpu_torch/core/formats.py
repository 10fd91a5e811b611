"""Input and output formats (port of ``flink_tpu/core/formats.py``):
text lines, CSV rows as typed tuples and newline-delimited JSON rows,
each written atomically (a temporary file, then a rename).

    env.from_collection(CsvInputFormat(path, types=[int, str]).read())
    CsvOutputFormat(path).write(rows)
"""


from __future__ import annotations

import csv
import json
import os
from typing import Any, Callable, Iterable, List, Optional, Sequence


class InputFormat:
    def read(self) -> Iterable[Any]:
        raise NotImplementedError


class OutputFormat:
    def write(self, records: Iterable[Any]) -> str:
        raise NotImplementedError


class TextInputFormat(InputFormat):
    """(ref: TextInputFormat.java — one record per line)."""

    def __init__(self, path: str):
        self.path = path

    def read(self) -> List[str]:
        with open(self.path) as f:
            return [line.rstrip("\n") for line in f]


class TextOutputFormat(OutputFormat):
    def __init__(self, path: str, formatter: Callable[[Any], str] = str):
        self.path = path
        self.formatter = formatter

    def write(self, records: Iterable[Any]) -> str:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        tmp = self.path + ".part"
        with open(tmp, "w") as f:
            for r in records:
                f.write(self.formatter(r) + "\n")
        os.replace(tmp, self.path)
        return self.path


class CsvInputFormat(InputFormat):
    """(ref: CsvInputFormat.java — typed field parsing into tuples)."""

    def __init__(self, path: str, types: Optional[Sequence[type]] = None,
                 delimiter: str = ",", skip_header: bool = False):
        self.path = path
        self.types = list(types) if types else None
        self.delimiter = delimiter
        self.skip_header = skip_header

    def read(self) -> List[tuple]:
        out = []
        with open(self.path, newline="") as f:
            reader = csv.reader(f, delimiter=self.delimiter)
            for i, row in enumerate(reader):
                if i == 0 and self.skip_header:
                    continue
                if self.types is not None:
                    row = [t(v) for t, v in zip(self.types, row)]
                out.append(tuple(row))
        return out


class CsvOutputFormat(OutputFormat):
    def __init__(self, path: str, delimiter: str = ","):
        self.path = path
        self.delimiter = delimiter

    def write(self, records: Iterable[Any]) -> str:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        tmp = self.path + ".part"
        with open(tmp, "w", newline="") as f:
            writer = csv.writer(f, delimiter=self.delimiter)
            for r in records:
                writer.writerow(r if isinstance(r, (tuple, list)) else [r])
        os.replace(tmp, self.path)
        return self.path


class JsonRowInputFormat(InputFormat):
    """One JSON object per line (the newline-delimited-JSON row
    format)."""

    def __init__(self, path: str):
        self.path = path

    def read(self) -> List[dict]:
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]


class JsonRowOutputFormat(OutputFormat):
    def __init__(self, path: str):
        self.path = path

    def write(self, records: Iterable[Any]) -> str:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        tmp = self.path + ".part"
        with open(tmp, "w") as f:
            for r in records:
                f.write(json.dumps(r) + "\n")
        os.replace(tmp, self.path)
        return self.path
