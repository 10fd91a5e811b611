"""Lint a job script without running it (port of
``flink_tpu/analysis/script_lint.py``).

``python -m flink_tpu_torch lint <script.py>`` runs the script the same
way ``run`` does (runpy, ``__main__``), but with the port's
``StreamExecutionEnvironment`` patched so that

- every environment the script constructs is captured, and
- ``execute()`` / ``execute_async()`` build the graph and return a
  permissive stand-in result instead of running the job.

After the script finishes (or dies — a script crash is reported, not
fatal), every captured environment is validated with the pre-flight
linter, including environments the script built but never executed.
The patched methods are put back afterwards, whatever the script did.
"""

from __future__ import annotations

import runpy
import sys
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

from flink_tpu_torch.analysis.diagnostics import Diagnostics


class _FakeResult:
    """Stands in for JobExecutionResult: common fields are real,
    anything else resolves to None rather than AttributeError."""

    def __init__(self, job_name: str):
        self.job_name = job_name
        self.accumulators: dict = {}
        self.checkpoints_completed = 0
        self.restarts = 0
        self.region_restarts = 0
        self.cancelled = False

    def __getattr__(self, name):
        return None


class _FakeClient:
    """Stands in for JobClient (execute_async)."""

    def __init__(self, job_name: str):
        self.job_name = job_name
        self.job_id = f"lint-{job_name}"

    def wait(self, timeout: Optional[float] = None):
        return _FakeResult(self.job_name)

    def cancel(self) -> None:
        pass

    def stop_with_savepoint(self, path: str) -> str:
        return path

    def trigger_savepoint(self, path: str) -> str:
        return path

    def __getattr__(self, name):
        return lambda *a, **kw: None


@dataclass
class ScriptLintResult:
    path: str
    #: (job_name, report) per captured environment, in creation order
    reports: List[Tuple[str, Diagnostics]] = field(default_factory=list)
    #: exception the script itself raised while building graphs, if any
    script_error: Optional[BaseException] = None

    def has_errors(self) -> bool:
        return any(r.has_errors() for _, r in self.reports)

    def counts(self) -> dict:
        total = {"error": 0, "warning": 0, "info": 0}
        for _, r in self.reports:
            for k, v in r.counts().items():
                total[k] = total.get(k, 0) + v
        return total


def lint_script(path: str, argv: Optional[List[str]] = None,
                types: bool = False) -> ScriptLintResult:
    """Capture-and-validate run of one job script (see module doc).

    With ``types=True`` (``lint --types``) the column
    type-flow prover also runs per environment: FT185–FT188 findings
    join each report and the per-edge schema dump rides along as
    ``report.typeflow`` (surfaced by the CLI's ``--json``)."""
    from flink_tpu_torch.streaming.datastream import StreamExecutionEnvironment

    captured: List[Any] = []
    orig_init = StreamExecutionEnvironment.__init__
    orig_execute = StreamExecutionEnvironment.execute
    orig_execute_async = StreamExecutionEnvironment.execute_async

    def lint_init(self, *a, **kw):
        orig_init(self, *a, **kw)
        captured.append(self)

    def lint_execute(self, job_name: str = "job"):
        self.graph.job_name = job_name
        return _FakeResult(job_name)

    def lint_execute_async(self, job_name: str = "job"):
        self.graph.job_name = job_name
        return _FakeClient(job_name)

    result = ScriptLintResult(path=path)
    old_argv = sys.argv
    StreamExecutionEnvironment.__init__ = lint_init
    StreamExecutionEnvironment.execute = lint_execute
    StreamExecutionEnvironment.execute_async = lint_execute_async
    try:
        sys.argv = [path] + list(argv or [])
        try:
            runpy.run_path(path, run_name="__main__")
        except SystemExit:
            pass
        except BaseException as e:  # noqa: BLE001 — report, don't die
            result.script_error = e
    finally:
        sys.argv = old_argv
        StreamExecutionEnvironment.__init__ = orig_init
        StreamExecutionEnvironment.execute = orig_execute
        StreamExecutionEnvironment.execute_async = orig_execute_async

    for env in captured:
        if not env.graph.nodes:
            continue  # constructed but never populated
        try:
            report = env.validate(types=types)
        except Exception as e:  # noqa: BLE001
            report = Diagnostics(job_name=env.graph.job_name)
            report.add("FT199", f"validation crashed: {e!r}")
        result.reports.append((env.graph.job_name, report))
    return result
