"""Command-line front end of the port (port of ``flink_tpu/cli.py``, its
local verbs).

    python -m flink_tpu_torch run <script.py> [args...]   execute a job script
    python -m flink_tpu_torch lint <script.py|dir> [args...]
                                   [--strict]        pre-flight checks
                                   [--json]          without executing:
                                   [--types]         graph linter, UDF
                                   [--check-imports] liftability, column
                                                     type flow
    python -m flink_tpu_torch profile <script.py> [args...]
                                   [--trace-out F]   run with the tracer
                                   [--flame]         on; write a Chrome
                                   [--flame-out F]   trace (and a folded
                                   [--flame-hz N]    stack profile)
    python -m flink_tpu_torch state inspect <dir>    offline checkpoint
                                   [--checkpoint N]  inspector: per-state
                                   [--top K]         per-key-group rows and
                                   [--parallelism P] bytes, dtypes, heaviest
                                   [--json]          keys, rescale preview
    python -m flink_tpu_torch info                   versions, CUDA devices,
                                                     host runtime
    python -m flink_tpu_torch config-docs            the config-option table
    python -m flink_tpu_torch shell                  interactive REPL with an
                                                     environment

The reference's cluster verbs (``top``, ``list``, ``cancel``,
``savepoint``, ``stop``, ``jobmanager``, ``taskmanager``, ``shell
--master``) wait for the port's cluster runtime, and ``bench`` for its
benchmark: each exits 2 saying so.
"""

from __future__ import annotations

import runpy
import sys

#: reference verbs the port does not have yet
_NOT_PORTED = {
    "top": "the cluster runtime",
    "list": "the cluster runtime",
    "cancel": "the cluster runtime",
    "savepoint": "the cluster runtime",
    "stop": "the cluster runtime",
    "jobmanager": "the cluster runtime",
    "taskmanager": "the cluster runtime",
    "bench": "the port's benchmark",
}


def _not_ported(verb: str) -> int:
    print(f"flink_tpu_torch {verb}: not in the port yet (it needs "
          f"{_NOT_PORTED.get(verb, 'the cluster runtime')})",
          file=sys.stderr)
    return 2


def _info() -> int:
    import torch

    import flink_tpu_torch
    print(f"flink_tpu_torch {flink_tpu_torch.__version__}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            print(f"cuda:{i} {torch.cuda.get_device_name(i)}")
    else:
        print("no CUDA device (entry points need device=\"cpu\")")
    from flink_tpu_torch import native
    path = native.library_path()
    print("host runtime: " + (f"built ({path})" if path.exists()
                              else "not built (g++ builds it at first use)"))
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        print(__doc__)
        return 0
    verb, rest = argv[0], argv[1:]
    if verb == "info":
        return _info()
    if verb == "run":
        if not rest:
            print("usage: flink_tpu_torch run <script.py> [args...]",
                  file=sys.stderr)
            return 2
        sys.argv = rest
        runpy.run_path(rest[0], run_name="__main__")
        return 0
    if verb == "lint":
        return _lint(rest)
    if verb == "profile":
        return _profile(rest)
    if verb == "state":
        return _state(rest)
    if verb == "shell":
        return _shell(rest)
    if verb == "config-docs":
        from flink_tpu_torch.core.config_docs import main as docs_main
        return docs_main()
    if verb in _NOT_PORTED:
        return _not_ported(verb)
    print(f"unknown command {verb!r}; "
          f"try: run | lint | profile | state | info | config-docs | shell",
          file=sys.stderr)
    return 2


def _lint(rest) -> int:
    """Pre-flight static analysis of job scripts: capture the
    topologies a script builds (execute() is neutered), run the graph
    linter, the liftability analyzer and, with --types, the type-flow
    prover, and report FTxxx diagnostics.  Exit code 0 = no errors,
    1 = errors (or, with --strict, warnings or unused imports),
    2 = usage."""
    import contextlib
    import json as _json
    import os

    strict = json_out = check_imports = types = False
    args = []
    for a in rest:
        if a == "--strict":
            strict = True
        elif a == "--json":
            json_out = True
        elif a == "--check-imports":
            check_imports = True
        elif a == "--types":
            types = True
        else:
            args.append(a)
    if not args:
        print("usage: flink_tpu_torch lint [--strict] [--json] [--types] "
              "[--check-imports] <script.py|dir> [script args...]",
              file=sys.stderr)
        return 2
    target, script_args = args[0], args[1:]

    if os.path.isdir(target):
        scripts = sorted(
            os.path.join(target, f) for f in os.listdir(target)
            if f.endswith(".py") and not f.startswith("_"))
        if script_args:
            print("script args only apply to a single script",
                  file=sys.stderr)
            return 2
    else:
        scripts = [target]

    from flink_tpu_torch.analysis.script_lint import lint_script
    total_errors = total_warnings = 0
    payload = []
    for script in scripts:
        if json_out:
            # the linted script's own prints must not corrupt the
            # machine-readable payload on stdout
            with contextlib.redirect_stdout(sys.stderr):
                res = lint_script(script, script_args, types=types)
        else:
            res = lint_script(script, script_args, types=types)
        c = res.counts()
        total_errors += c["error"]
        total_warnings += c["warning"]
        if json_out:
            jobs = []
            for _, report in res.reports:
                j = report.to_dict()
                tf = getattr(report, "typeflow", None)
                if tf is not None:
                    j["typeflow"] = tf.to_dict()
                jobs.append(j)
            payload.append({
                "script": script,
                "script_error": (repr(res.script_error)
                                 if res.script_error else None),
                "jobs": jobs,
            })
            continue
        print(f"== {script}")
        if res.script_error is not None:
            print(f"   script raised during graph construction: "
                  f"{res.script_error!r}")
        if not res.reports:
            print("   (no topology captured)")
        for _, report in res.reports:
            print("   " + report.render().replace("\n", "\n   "))
            tf = getattr(report, "typeflow", None)
            if tf is not None:
                s = tf.summary()
                print(f"   typeflow: {s['edges_conclusive']}/"
                      f"{s['edges_total']} edges conclusive, "
                      f"{s['kernels_proven']}/{s['kernels_total']} "
                      f"kernels proven probe-free, "
                      f"{s['pickle_edges']} pickle-tier exchange "
                      f"edge(s), predicted state "
                      f"{s['predicted_state_bytes']} B")

    imports_rc = 0
    if check_imports:
        from flink_tpu_torch.analysis.imports_check import (check_file,
                                                            check_tree)
        findings = []
        for t in args:
            findings.extend(check_tree(t) if os.path.isdir(t)
                            else check_file(t))
        if json_out:
            payload.append({"unused_imports": [
                f.__dict__ for f in findings]})
        else:
            for f in findings:
                print(f.render())
        imports_rc = 1 if findings else 0

    if json_out:
        print(_json.dumps(payload, indent=2))
    if total_errors or (strict and (total_warnings or imports_rc)):
        return 1
    return imports_rc if strict else 0


def _take_value(rest, flag):
    """(value, rest without the flag and its value), or (None, rest);
    raises ValueError when the flag has no value."""
    if flag not in rest:
        return None, rest
    i = rest.index(flag)
    if i + 1 >= len(rest):
        raise ValueError(flag)
    return rest[i + 1], rest[:i] + rest[i + 2:]


def _profile(rest) -> int:
    """Run a job script with the tracer on; at its end write the Chrome
    trace-event file (Perfetto / chrome://tracing) and print the span,
    host-runtime and CUDA-launch summaries to stderr.  With --flame the
    sampling profiler runs too and its folded stacks (flamegraph.pl /
    speedscope input) are written."""
    try:
        out, rest = _take_value(rest, "--trace-out")
        flame_out, rest = _take_value(rest, "--flame-out")
        flame_hz, rest = _take_value(rest, "--flame-hz")
    except ValueError as e:
        print(f"{e} needs a value", file=sys.stderr)
        return 2
    out = out or "trace.json"
    flame = "--flame" in rest or flame_out is not None or flame_hz is not None
    rest = [a for a in rest if a != "--flame"]
    flame_out = flame_out or "profile.folded"
    try:
        flame_hz = float(flame_hz) if flame_hz is not None else 50.0
    except ValueError:
        print(f"--flame-hz wants a number, got {flame_hz!r}", file=sys.stderr)
        return 2
    if not rest:
        print("usage: flink_tpu_torch profile <script.py> [args...] "
              "[--trace-out trace.json] [--flame] "
              "[--flame-out profile.folded] [--flame-hz 50]",
              file=sys.stderr)
        return 2

    from flink_tpu_torch.runtime import tracing
    tracer = tracing.get_tracer()
    tracer.enabled = True
    profiler = None
    if flame:
        from flink_tpu_torch.runtime.profiler import get_profiler
        profiler = get_profiler()
        profiler.enable(hz=flame_hz)
    sys.argv = rest
    try:
        runpy.run_path(rest[0], run_name="__main__")
    finally:
        if profiler is not None:
            profiler.disable()
            from flink_tpu_torch.runtime.profiler import collapsed_lines
            folded = collapsed_lines(profiler.export())
            with open(flame_out, "w") as f:
                f.write("\n".join(folded) + ("\n" if folded else ""))
            print(f"-- flame: {sum(profiler.samples)} samples, "
                  f"{len(folded)} stacks -> {flame_out}", file=sys.stderr)
        n = tracer.write_chrome_trace(out)
        print(f"-- trace: {n} events -> {out}", file=sys.stderr)
        stats = sorted(tracer.stats().items(),
                       key=lambda kv: -kv[1]["total_ms"])
        for name, s in stats[:20]:
            print(f"{name:<40} n={s['count']:<8} "
                  f"total={s['total_ms']:.1f}ms self={s['self_ms']:.1f}ms "
                  f"p99={s['p99_ms']:.3f}ms", file=sys.stderr)
        kernels = sorted(tracing.kernel_stats().items(),
                         key=lambda kv: -kv[1]["total_ms"])
        for name, s in kernels[:20]:
            print(f"native.{name:<33} n={s['dispatches']:<8} "
                  f"total={s['total_ms']:.1f}ms p99={s['p99_ms']:.3f}ms",
                  file=sys.stderr)
        launches = sorted(tracing.LAUNCH_LEDGER.stats().items(),
                          key=lambda kv: -kv[1].get("launches", 0))
        for name, s in launches[:20]:
            print(f"{name:<40} n={s['launches']:<8} "
                  f"device={s['device_ms']:.1f}ms p99={s['p99_ms']:.3f}ms",
                  file=sys.stderr)
    return 0


def _fmt_bytes(n) -> str:
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return (f"{n:,.0f} {unit}" if unit == "B"
                    else f"{n:,.1f} {unit}")
        n /= 1024
    return f"{n:,.1f} GiB"


def _state(rest) -> int:
    """Offline keyed-state tools: ``state inspect <dir>`` reads a
    completed checkpoint of either package straight off the filesystem
    (no running job) and prints per-state per-key-group rows and bytes,
    the dtype breakdown, the heaviest keys and, with --parallelism, a
    rescale preview."""
    import argparse
    import json as _json

    ap = argparse.ArgumentParser(prog="flink_tpu_torch state")
    sub = ap.add_subparsers(dest="cmd")
    ins = sub.add_parser("inspect",
                         help="inspect a checkpoint directory offline")
    ins.add_argument("directory", help="checkpoint directory (the one "
                                       "holding chk-N subdirs/files)")
    ins.add_argument("--checkpoint", type=int, default=None,
                     help="checkpoint id (default: latest completed)")
    ins.add_argument("--top", type=int, default=10,
                     help="how many heaviest keys to list (default 10)")
    ins.add_argument("--parallelism", type=int, default=None,
                     help="preview per-subtask key-group load at this "
                          "parallelism")
    ins.add_argument("--json", action="store_true", dest="json_out",
                     help="emit the raw report as JSON")
    args = ap.parse_args(rest)
    if args.cmd != "inspect":
        ap.print_help(sys.stderr)
        return 2

    from flink_tpu_torch.state.introspect import inspect_checkpoint
    try:
        report = inspect_checkpoint(args.directory,
                                    checkpoint_id=args.checkpoint,
                                    top=args.top,
                                    parallelism=args.parallelism)
    except (FileNotFoundError, ValueError) as e:
        print(f"state inspect: {e}", file=sys.stderr)
        return 1
    if args.json_out:
        print(_json.dumps(report, indent=2, default=str))
        return 0

    print(f"checkpoint chk-{report['checkpoint_id']} "
          f"({report['directory']})")
    backends = ", ".join(report.get("backends") or []) or "?"
    print(f"backends: {backends}; "
          f"max parallelism: {report.get('max_parallelism')}")
    states = report.get("states") or {}
    if not states:
        print("(no keyed state in this checkpoint)")
        return 0
    for name, st in states.items():
        kgs = st["key_groups"]
        print(f"\nstate {name!r}: {st['rows']:,} rows, "
              f"{_fmt_bytes(st['bytes'])} across {len(kgs)} key group(s)")
        dt = ", ".join(f"{d} {_fmt_bytes(b)}"
                       for d, b in st["dtypes"].items())
        if dt:
            print(f"  dtypes: {dt}")
        print(f"  {'kg':>5}  {'rows':>10}  {'bytes':>12}  {'ns':>4}")
        for kg, e in st["key_groups"].items():
            print(f"  {kg:>5}  {e['rows']:>10,}  "
                  f"{_fmt_bytes(e['bytes']):>12}  {e['namespaces']:>4}")
    if report.get("top_keys"):
        print(f"\nheaviest keys (top {args.top}):")
        for k in report["top_keys"]:
            print(f"  {k['state']:<24} {k['key']:<24} "
                  f"{k['rows']:>8,} rows  {_fmt_bytes(k['bytes'])}")
    rescale = report.get("rescale")
    if rescale:
        print(f"\nrescale preview at parallelism "
              f"{rescale['parallelism']} "
              f"(max {rescale['max_parallelism']}, "
              f"imbalance {rescale['imbalance']:.2f}x):")
        for s in rescale["subtasks"]:
            lo, hi = s["key_group_range"]
            print(f"  subtask {s['subtask']:>3}  kg [{lo:>4}, {hi:>4}]  "
                  f"{s['rows']:>10,} rows  {_fmt_bytes(s['bytes'])}")
    return 0


def _shell(rest) -> int:
    """Interactive REPL with an environment (ref: FlinkShell.scala).
    ``--device cpu`` runs it on the CPU; ``--master`` (a cluster) is
    not in the port yet."""
    import argparse
    import code

    ap = argparse.ArgumentParser(prog="flink_tpu_torch shell")
    ap.add_argument("--master", default=None,
                    help="attach to a running cluster (not in the port yet)")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run without a card (default: the card)")
    args = ap.parse_args(rest)
    if args.master:
        return _not_ported("shell --master")

    import flink_tpu_torch
    from flink_tpu_torch.streaming.datastream import StreamExecutionEnvironment
    env = StreamExecutionEnvironment(device=args.device)
    namespace = {"env": env, "flink_tpu_torch": flink_tpu_torch}
    banner = (f"flink_tpu_torch {flink_tpu_torch.__version__} shell — "
              f"`env` is a StreamExecutionEnvironment on {env.device}"
              "\nExample: env.from_collection([1,2,3])"
              ".map(lambda x: x*2).print_(); env.execute()")
    code.interact(banner=banner, local=namespace)
    return 0
