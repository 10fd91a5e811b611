"""Unused-import detection (port of
``flink_tpu/analysis/imports_check.py``).

``python -m flink_tpu_torch lint --check-imports`` runs a deliberately
conservative AST checker, so no pyflakes is needed: an import is flagged
only when its bound name appears exactly once in the whole source text
(the import statement itself).  Any other occurrence — code, a
docstring example, ``__all__``, a comment — keeps it.  That trades
recall for a near-zero false-positive rate, which is the right trade
for a checker whose findings people are expected to fix.

``__init__.py`` files are skipped unless they declare ``__all__``
(re-export modules), and ``# noqa`` on the import line always wins.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from typing import List, Optional


@dataclass
class UnusedImport:
    path: str
    line: int
    name: str       # the bound name, e.g. "np" for `import numpy as np`
    statement: str  # e.g. "import numpy as np"

    def render(self) -> str:
        return f"{self.path}:{self.line}: unused import '{self.name}'"


def _bound_names(node) -> List[tuple]:
    """(bound_name, statement_text) pairs for one import node."""
    out = []
    if isinstance(node, ast.Import):
        for alias in node.names:
            bound = alias.asname or alias.name.split(".")[0]
            stmt = f"import {alias.name}" + (
                f" as {alias.asname}" if alias.asname else "")
            out.append((bound, stmt))
    elif isinstance(node, ast.ImportFrom):
        for alias in node.names:
            if alias.name == "*":
                continue  # cannot reason about star imports
            bound = alias.asname or alias.name
            stmt = (f"from {'.' * node.level}{node.module or ''} "
                    f"import {alias.name}"
                    + (f" as {alias.asname}" if alias.asname else ""))
            out.append((bound, stmt))
    return out


def check_file(path: str, source: Optional[str] = None
               ) -> List[UnusedImport]:
    if source is None:
        with open(path, encoding="utf-8") as f:
            source = f.read()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError:
        return []

    if path.endswith("__init__.py") and "__all__" not in source:
        return []  # bare re-export package: imports ARE the API

    lines = source.splitlines()
    findings: List[UnusedImport] = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.Import, ast.ImportFrom)):
            continue
        line_text = (lines[node.lineno - 1]
                     if node.lineno - 1 < len(lines) else "")
        if "noqa" in line_text:
            continue
        if isinstance(node, ast.ImportFrom) and node.module == "__future__":
            continue
        for bound, stmt in _bound_names(node):
            if bound == "_":
                continue
            uses = len(re.findall(rf"\b{re.escape(bound)}\b", source))
            if uses == 1:
                findings.append(UnusedImport(
                    path=path, line=node.lineno, name=bound,
                    statement=stmt))
    return findings


def check_tree(root: str) -> List[UnusedImport]:
    import os
    findings: List[UnusedImport] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", ".git")]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                findings.extend(check_file(os.path.join(dirpath, fn)))
    return findings
