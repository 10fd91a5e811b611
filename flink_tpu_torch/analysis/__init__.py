"""Pre-flight static analysis (port of ``flink_tpu/analysis``).

Three passes over a job before any record flows:

- **Pass 1 — graph linter** (``graph_linter.py``): walks the
  StreamGraph and checks key selectors, window configurations, state
  serializers, chaining, reachability and cycles.  Every finding is a
  :class:`Diagnostic` with a stable ``FTxxx`` code from :data:`CODES`.
- **Pass 2 — liftability analyzer** (``liftability.py``): bytecode
  analysis of aggregates and map/filter/reduce UDFs (LIFTABLE /
  SCALAR_ONLY / IMPURE / INCONCLUSIVE).
- **Pass 3 — column type-flow prover** (``typeflow.py``): per-edge
  column schemas, kernel dtype proofs, codec tiers and device-state
  footprints; its conclusive verdicts feed the runtime (probe-free
  kernels, pre-sized device window state).

Entry points: ``env.validate()``, ``execute()`` under the ``lint.mode``
and ``lint.types.mode`` keys (``off`` | ``warn`` | ``strict``), and
``python -m flink_tpu_torch lint``.
"""

from flink_tpu_torch.analysis.diagnostics import (  # noqa: F401
    CODES,
    ERROR,
    INFO,
    WARNING,
    Diagnostic,
    Diagnostics,
    JobValidationError,
)
from flink_tpu_torch.analysis.graph_linter import lint_graph  # noqa: F401
from flink_tpu_torch.analysis.liftability import (  # noqa: F401
    IMPURE,
    INCONCLUSIVE,
    LIFTABLE,
    SCALAR_ONLY,
    AggregateReport,
    UdfReport,
    analyze_aggregate,
    analyze_udf,
)

__all__ = [
    "CODES", "ERROR", "WARNING", "INFO",
    "Diagnostic", "Diagnostics", "JobValidationError",
    "lint_graph",
    "LIFTABLE", "SCALAR_ONLY", "IMPURE", "INCONCLUSIVE",
    "AggregateReport", "UdfReport",
    "analyze_aggregate", "analyze_udf",
]
