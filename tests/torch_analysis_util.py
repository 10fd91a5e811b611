"""Shared helpers of the pre-flight analysis differential tests
(``tests/test_torch_{analysis,typeflow,cli}.py``): one namespace per
package, so a job written once runs against the JAX package
and against the port, and the normalisation under which their
diagnostics compare (the package name, object addresses)."""

import importlib
import re

_MODULES = {
    "ds": "streaming.datastream",
    "sources": "streaming.sources",
    "windowing": "streaming.windowing",
    "columnar": "streaming.columnar",
    "operators": "streaming.operators",
    "graph": "streaming.graph",
    "partitioners": "streaming.partitioners",
    "chain_fusion": "streaming.chain_fusion",
    "config": "core.config",
    "config_docs": "core.config_docs",
    "functions": "core.functions",
    "elements": "streaming.elements",
    "device_agg": "ops.device_agg",
    "sketches": "ops.sketches",
    "analysis": "analysis",
    "typeflow": "analysis.typeflow",
    "graph_linter": "analysis.graph_linter",
    "eligibility": "analysis.columnar_eligibility",
    "script_lint": "analysis.script_lint",
    "imports_check": "analysis.imports_check",
    "liftability": "analysis.liftability",
    "metrics": "runtime.metrics",
}


class Pkg:
    """One package's modules under short names (``P.ds``, ``P.sources``,
    ...), ``P.env(conf)`` for an environment (the port's on the CPU),
    ``P.conf(**keys)`` for a Configuration."""

    def __init__(self, is_torch: bool):
        self.is_torch = is_torch
        self.name = "flink_tpu_torch" if is_torch else "flink_tpu"
        for attr, mod in _MODULES.items():
            setattr(self, attr, importlib.import_module(f"{self.name}.{mod}"))

    def env(self, conf=None):
        if self.is_torch:
            return self.ds.StreamExecutionEnvironment(conf, device="cpu")
        return self.ds.StreamExecutionEnvironment(conf)

    def conf(self, items=None):
        c = self.config.Configuration()
        for k, v in (items or {}).items():
            c.set(k, v)
        return c

    def __repr__(self):
        return self.name


_PKGS = {}


def pkgs():
    """(reference, port)"""
    if not _PKGS:
        _PKGS["j"] = Pkg(False)
        _PKGS["t"] = Pkg(True)
    return _PKGS["j"], _PKGS["t"]


def norm(text):
    """A message or hint as both packages should write it: the port's
    package name read as the reference's, object addresses elided, and
    an object's repr cut to its class name (the port's window assigners
    and triggers print their parameters, the reference's their
    address)."""
    if text is None:
        return None
    text = str(text).replace("flink_tpu_torch", "flink_tpu")
    text = re.sub(r"<[\w.]+\.(\w+) object at 0x[0-9a-fA-F]+>", r"\1", text)
    text = re.sub(r"\b([A-Z]\w*)\([^()]*\)", r"\1", text)
    return re.sub(r"0x[0-9a-fA-F]+", "0x?", text)


def diag_rows(report):
    """Every diagnostic of a report, in report order, as a comparable
    tuple: (code, severity, operator id, operator name, message, hint,
    location)."""
    return [(d.code, d.severity, d.operator_id, d.operator_name,
             norm(d.message), norm(d.hint), d.location) for d in report]


def norm_obj(obj):
    """A JSON-like payload with every string normalised (``norm``)."""
    if isinstance(obj, dict):
        return {norm(k): norm_obj(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [norm_obj(v) for v in obj]
    if isinstance(obj, str):
        return norm(obj)
    return obj
