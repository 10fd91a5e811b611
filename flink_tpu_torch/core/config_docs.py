"""Config-options documentation (port of
``flink_tpu/core/config_docs.py``).

``generate_config_docs()`` finds every ``ConfigOption`` on the option
groups of ``flink_tpu_torch.core.config`` (the classes named
``*Options``) and renders one markdown table per group, in the
reference's layout; the CLI exposes it as ``python -m flink_tpu_torch
config-docs``.  Only the keys the port reads are listed."""

from __future__ import annotations

import inspect
from typing import List, Tuple

from flink_tpu_torch.core import config as _config
from flink_tpu_torch.core.config import ConfigOption


def collect_options() -> List[Tuple[str, List[Tuple[str, ConfigOption]]]]:
    """[(group_class_name, [(attr_name, option), ...]), ...]"""
    groups = []
    for name, cls in sorted(vars(_config).items()):
        if not inspect.isclass(cls) or not name.endswith("Options"):
            continue
        opts = [(attr, val) for attr, val in sorted(vars(cls).items())
                if isinstance(val, ConfigOption)]
        if opts:
            groups.append((name, opts))
    return groups


def generate_config_docs() -> str:
    lines = ["# Configuration options", "",
             "Generated from the option groups in "
             "`flink_tpu_torch/core/config.py` (the keys the port reads).",
             ""]
    for group, opts in collect_options():
        lines.append(f"## {group}")
        lines.append("")
        lines.append("| Key | Default | Type |")
        lines.append("|---|---|---|")
        for _attr, opt in opts:
            default_str = repr(opt.default) if opt.has_default() else "(none)"
            vtype = opt.value_type
            tname = getattr(vtype, "__name__", "") if vtype else ""
            lines.append(f"| `{opt.key}` | {default_str} | {tname} |")
        lines.append("")
    return "\n".join(lines)


def main() -> int:
    print(generate_config_docs())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
