"""Structured diagnostics of the pre-flight analysis (port of
``flink_tpu/analysis/diagnostics.py``).

Every finding carries a stable ``FTxxx`` code, a severity, the operator
it points at, a best-effort source location and a fix hint, whether it
came from the graph linter (pass 1), the liftability analyzer (pass 2)
or the type-flow prover (pass 3), and whether it surfaces through
``env.validate()``, ``execute()`` (warn/strict) or ``python -m
flink_tpu_torch lint``.  The catalog (``CODES``) is the reference's,
code for code and severity for severity, so a job gets the same report
from either package (``tests/test_torch_analysis.py``).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

ERROR = "error"
WARNING = "warning"
INFO = "info"

_SEVERITY_ORDER = {ERROR: 0, WARNING: 1, INFO: 2}

#: code -> (default severity, one-line title). The single source of
#: truth for which codes exist; emitting an unknown code is a bug.
CODES: Dict[str, tuple] = {
    # --- keys / serialization ---------------------------------------
    "FT101": (ERROR, "key selector returns an unhashable value"),
    "FT102": (WARNING, "function is not serializable for remote submission"),
    # --- windows / triggers / lateness ------------------------------
    "FT110": (ERROR, "window operator rejected its trigger/assigner combination"),
    "FT111": (ERROR, "non-positive window size, slide or session gap"),
    "FT112": (WARNING, "allowed lateness exceeds the window size"),
    "FT113": (INFO, "window shape falls off the vectorized generic tier"),
    "FT115": (ERROR, "event-time window but no upstream path assigns timestamps"),
    # --- state ------------------------------------------------------
    "FT120": (WARNING, "state descriptor serializer fails a round-trip"),
    "FT140": (WARNING, "unbounded keyed state without a window or TTL"),
    # --- chaining / parallelism -------------------------------------
    "FT130": (INFO, "forward edge not chained"),
    "FT131": (ERROR, "forward partitioner across a parallelism change"),
    # --- topology ---------------------------------------------------
    "FT150": (WARNING, "branch ends without a sink"),
    "FT151": (WARNING, "operator unreachable from any source"),
    "FT160": (ERROR, "cycle outside a declared iteration"),
    "FT170": (ERROR, "duplicate operator uid"),
    "FT171": (INFO, "duplicate operator name"),
    # --- UDF liftability (pass 2) -----------------------------------
    "FT180": (ERROR, "aggregate function is impure"),
    "FT181": (WARNING, "aggregate is conclusively scalar-only (perf footgun)"),
    "FT182": (INFO, "aggregate proven liftable; runtime probe will be skipped"),
    "FT183": (WARNING, "impure map/filter/reduce function"),
    "FT184": (INFO, "columnar batch eligibility of an operator chain"),
    # --- column type flow (pass 3) ----------------------------------
    "FT185": (WARNING, "exchange edge conclusively demotes to the pickle wire tier"),
    "FT186": (WARNING, "dtype-overflow hazard in a lifted kernel"),
    "FT187": (WARNING, "predicted device state footprint exceeds the slot budget"),
    "FT188": (WARNING, "schema conflict at a union/merge point"),
    # --- pre-flight construction / linter self-errors ---------------
    "FT190": (ERROR, "operator factory raised during pre-flight construction"),
    "FT199": (INFO, "linter check skipped (internal error)"),
}


@dataclass
class Diagnostic:
    code: str
    message: str
    severity: Optional[str] = None          # default: catalog severity
    operator_id: Optional[int] = None       # StreamNode id
    operator_name: Optional[str] = None
    location: Optional[str] = None          # "file.py:42"
    hint: Optional[str] = None

    def __post_init__(self):
        if self.severity is None:
            self.severity = CODES.get(self.code, (WARNING, ""))[0]

    def render(self) -> str:
        op = ""
        if self.operator_name is not None:
            op = f" [{self.operator_name}" + (
                f"#{self.operator_id}]" if self.operator_id is not None
                else "]")
        loc = f" ({self.location})" if self.location else ""
        hint = f"\n        hint: {self.hint}" if self.hint else ""
        return (f"{self.severity.upper():7s} {self.code}{op} "
                f"{self.message}{loc}{hint}")

    def to_dict(self) -> dict:
        return {
            "code": self.code,
            "severity": self.severity,
            "message": self.message,
            "operator_id": self.operator_id,
            "operator_name": self.operator_name,
            "location": self.location,
            "hint": self.hint,
        }


@dataclass
class Diagnostics:
    """An ordered report of :class:`Diagnostic` findings for one job."""

    job_name: Optional[str] = None
    _diags: List[Diagnostic] = field(default_factory=list)

    # ---- building ---------------------------------------------------
    def append(self, diag: Diagnostic) -> None:
        self._diags.append(diag)

    def add(self, code: str, message: str, **kw) -> Diagnostic:
        d = Diagnostic(code=code, message=message, **kw)
        self.append(d)
        return d

    def extend(self, other: "Diagnostics") -> None:
        self._diags.extend(other._diags)

    # ---- reading ----------------------------------------------------
    def __iter__(self) -> Iterator[Diagnostic]:
        return iter(sorted(
            self._diags, key=lambda d: _SEVERITY_ORDER.get(d.severity, 3)))

    def __len__(self) -> int:
        return len(self._diags)

    def errors(self) -> List[Diagnostic]:
        return [d for d in self._diags if d.severity == ERROR]

    def warnings(self) -> List[Diagnostic]:
        return [d for d in self._diags if d.severity == WARNING]

    def infos(self) -> List[Diagnostic]:
        return [d for d in self._diags if d.severity == INFO]

    def has_errors(self) -> bool:
        return any(d.severity == ERROR for d in self._diags)

    def by_code(self, code: str) -> List[Diagnostic]:
        return [d for d in self._diags if d.code == code]

    def codes(self) -> List[str]:
        return sorted({d.code for d in self._diags})

    def counts(self) -> Dict[str, int]:
        c = {ERROR: 0, WARNING: 0, INFO: 0}
        for d in self._diags:
            c[d.severity] = c.get(d.severity, 0) + 1
        return c

    # ---- presentation -----------------------------------------------
    def render(self, min_severity: str = INFO) -> str:
        cut = _SEVERITY_ORDER[min_severity]
        lines = [d.render() for d in self
                 if _SEVERITY_ORDER.get(d.severity, 3) <= cut]
        counts = self.counts()
        head = (f"{counts[ERROR]} error(s), {counts[WARNING]} warning(s), "
                f"{counts[INFO]} info")
        if self.job_name:
            head = f"{self.job_name}: {head}"
        return "\n".join([head] + lines)

    def to_dict(self) -> dict:
        return {
            "job_name": self.job_name,
            "counts": self.counts(),
            "diagnostics": [d.to_dict() for d in self],
        }

    def log(self, logger: Optional[logging.Logger] = None,
            limit: int = 25) -> None:
        """Log errors/warnings (warn mode of execute())."""
        logger = logger or logging.getLogger("flink_tpu_torch.lint")
        shown = 0
        for d in self:
            if d.severity == INFO:
                continue
            if shown >= limit:
                logger.warning("... %d more diagnostics suppressed",
                               len(self.errors()) + len(self.warnings())
                               - shown)
                break
            fn = logger.error if d.severity == ERROR else logger.warning
            fn("%s", d.render())
            shown += 1


class JobValidationError(Exception):
    """Raised by strict-mode validation when the report has errors."""

    def __init__(self, report: Diagnostics):
        self.report = report
        super().__init__(
            "job failed pre-flight validation:\n" + report.render())
