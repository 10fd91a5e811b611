"""Sampling profiler & flame-graph plane (port of
``flink_tpu/runtime/profiler.py``; the port's executor calls
``set_scope`` before each source step, and the subtasks downstream run
inside that call, so their samples land on the source's scope).

The reference exposes operator flame graphs from the web UI by
periodically collecting task-thread stack traces and merging them
per job vertex (FLIP-165, `JobVertexThreadInfoTracker` /
`VertexFlameGraphFactory`).  The rebuild keeps the same shape in one
process-wide singleton:

- a daemon thread walks ``sys._current_frames()`` at a configurable
  Hz and folds every attributed stack into a bounded collapsed-stack
  trie (Gregg's flame-graph folding — ``a;b;c count``);
- attribution rides the per-thread labelling of the trace lanes:
  executor loops register the subtask they are about to
  step (guarded on ``PROFILER.enabled`` so the disabled path stays a
  single attribute check, like ``DeviceTelemetry``), threaded sources
  register once at thread spawn;
- every sample is classified ON_CPU / OFF_CPU / BACKPRESSURED from
  the subtask's live ``TimeAccounting`` state (the busy / idle /
  backpressured attribution of ``runtime/backpressure.py``) plus the
  sticky
  ``router_blocked`` predicate at sample time — the flame graph splits
  the same way Flink's does (full / on-CPU / off-CPU modes);
- tries are bounded: once ``max_nodes`` trie nodes exist, samples
  whose stacks would need new nodes are truncated at the deepest
  existing prefix and counted in ``profiler.dropped`` — memory never
  grows without bound no matter how long the profiler runs.

One payload shape (:meth:`SamplingProfiler.export`) feeds every
surface, and increments of it merge (:func:`merge_export`); the
d3-flame-graph JSON tree is always built by :func:`flamegraph_payload`
from such an export, and :func:`collapsed_lines` renders the collapsed
stack text.

This module is also the tree's single windowed-sampling core
(:func:`sample_windowed`): ``runtime.backpressure`` delegates its
N-samples-over-a-window loop here, so there is exactly one sampler
idiom (and one ``sys._current_frames`` walker) in the codebase.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "ON_CPU", "OFF_CPU", "BACKPRESSURED", "CLASS_NAMES", "MODES",
    "SamplingProfiler", "get_profiler", "PROFILER",
    "classify_subtask", "fold_stack", "sample_windowed",
    "empty_export", "merge_export", "flamegraph_payload",
    "collapsed_lines", "hottest_frame", "register_profiler_gauges",
]

#: sample classes — index into every counts triple in this module.
#: ``TimeAccounting.last_class`` uses the same encoding.
ON_CPU = 0
OFF_CPU = 1
BACKPRESSURED = 2
CLASS_NAMES = ("on_cpu", "off_cpu", "backpressured")

#: flame-graph modes: ``full`` sums all classes, ``on_cpu`` keeps
#: only ON_CPU samples, ``off_cpu`` keeps OFF_CPU + BACKPRESSURED
#: (a backpressured thread is off-CPU waiting for credit)
MODES = ("full", "on_cpu", "off_cpu")

#: frames kept per sampled stack, leaf-most first — deeper recursion
#: is truncated at the root end (the leaf is what makes a frame hot)
MAX_STACK_DEPTH = 128


def sample_windowed(probe: Callable[[int], None], num_samples: int = 20,
                    delay_s: float = 0.005) -> int:
    """The one N-samples-over-a-window loop in the tree: invoke
    ``probe(i)`` ``num_samples`` times, sleeping ``delay_s`` between
    consecutive samples (not after the last — the window is
    ``(num_samples - 1) * delay_s`` long).  ``sample_backpressure``
    drives its capacity-predicate reads through this; the profiler's
    own daemon loop is the continuous analogue."""
    for i in range(num_samples):
        probe(i)
        if delay_s and i < num_samples - 1:
            time.sleep(delay_s)
    return num_samples


def fold_stack(frame, limit: int = MAX_STACK_DEPTH) -> List[str]:
    """Collapse a frame chain into root-first ``file.py:function``
    labels (the collapsed-stack frame naming).  Works on any object
    exposing ``f_code``/``f_back`` so tests can fold fake frames."""
    leafward: List[str] = []
    f = frame
    while f is not None and len(leafward) < limit:
        code = f.f_code
        leafward.append("%s:%s" % (
            os.path.basename(code.co_filename), code.co_name))
        f = f.f_back
    leafward.reverse()
    return leafward


def classify_subtask(st) -> int:
    """Classify a sample for ``st`` at sample time.  Live
    ``router_blocked`` takes precedence (the subtask is waiting on
    downstream credit RIGHT NOW), then the last class its
    ``TimeAccounting`` assigned (busy ⇒ on-CPU, idle ⇒ off-CPU,
    backpressured ⇒ backpressured).  Unknown state reads as on-CPU —
    a thread we caught running Python is at least plausibly busy."""
    from flink_tpu_torch.runtime.backpressure import router_blocked
    router = getattr(st, "router", None)
    if router is not None:
        try:
            if router_blocked(router):
                return BACKPRESSURED
        except Exception:
            pass
    acct = getattr(st, "time_accounting", None)
    last = getattr(acct, "last_class", None)
    if last == OFF_CPU:
        return OFF_CPU
    if last == BACKPRESSURED:
        return BACKPRESSURED
    return ON_CPU


class _Node:
    """One collapsed-stack trie node: cumulative per-class counts of
    samples that TERMINATED here (the flame-graph tree builder sums
    descendants at render time) plus the not-yet-shipped delta the
    cluster increment path drains."""

    __slots__ = ("children", "counts", "delta")

    def __init__(self):
        self.children: Dict[str, "_Node"] = {}
        self.counts = [0, 0, 0]
        self.delta = [0, 0, 0]


class SamplingProfiler:
    """Process-wide sampling profiler.  Off by default; the ONLY cost
    anywhere on the hot path while disabled is reading ``.enabled``
    (kept the first attribute set, same discipline as
    ``DeviceTelemetry``)."""

    DEFAULT_HZ = 50
    #: global trie-node budget across all jobs/vertices — beyond it,
    #: new stack shapes truncate at their deepest existing prefix and
    #: ``dropped`` counts them
    MAX_NODES = 50_000

    def __init__(self):
        self.enabled = False  # MUST stay the first attribute set
        self.hz = float(self.DEFAULT_HZ)
        self.max_nodes = self.MAX_NODES
        self.dropped = 0
        self.samples = [0, 0, 0]
        self._samples_delta = [0, 0, 0]
        self._lock = threading.Lock()
        #: thread ident -> subtask-like scope (survives reset(): the
        #: registrations belong to live threads, not to the data)
        self._scopes: Dict[int, Any] = {}
        #: job -> vertex label -> trie root
        self._tries: Dict[str, Dict[str, _Node]] = {}
        #: (job, vertex label, subtask index) -> per-class counts
        self._subtask_counts: Dict[Tuple[str, str, int], List[int]] = {}
        self._subtask_delta: Dict[Tuple[str, str, int], List[int]] = {}
        self._dropped_delta = 0
        self._node_count = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- lifecycle ----------------------------------------------------

    def enable(self, hz: Optional[float] = None) -> None:
        """Start the daemon sampler (idempotent; ``hz`` updates the
        rate either way)."""
        if hz is not None:
            self.hz = float(hz)
        if self.enabled and self._thread is not None:
            return
        self._stop.clear()
        self.enabled = True
        t = threading.Thread(target=self._run, daemon=True,
                             name="stack-profiler")
        self._thread = t
        t.start()

    def disable(self) -> None:
        """Stop sampling; collected tries stay readable until
        :meth:`reset`."""
        self.enabled = False
        self._stop.set()
        t = self._thread
        self._thread = None
        if t is not None and t is not threading.current_thread():
            t.join(timeout=2.0)

    def reset(self) -> None:
        """Drop all collected samples (thread scope registrations are
        kept — they describe live threads, not data)."""
        with self._lock:
            self._tries.clear()
            self._subtask_counts.clear()
            self._subtask_delta.clear()
            self.samples = [0, 0, 0]
            self._samples_delta = [0, 0, 0]
            self.dropped = 0
            self._dropped_delta = 0
            self._node_count = 0
            self.hz = float(self.DEFAULT_HZ)
            self.max_nodes = self.MAX_NODES

    # -- attribution --------------------------------------------------

    def set_scope(self, subtask) -> None:
        """Attribute the calling thread's samples to ``subtask`` until
        the next call.  Executor loops call this (guarded on
        ``.enabled``) right before stepping each subtask; threaded
        sources call it once at thread spawn."""
        self._scopes[threading.get_ident()] = subtask

    def clear_scope(self) -> None:
        self._scopes.pop(threading.get_ident(), None)

    @staticmethod
    def _scope_key(st) -> Tuple[str, str, int]:
        key = getattr(st, "profiler_scope", None)
        if key is not None:
            return key
        try:
            vid, idx = st.task_key
            vertex = "%s_%s" % (vid, st.vertex.name)
        except Exception:
            vertex, idx = "unknown", 0
        group = getattr(st, "metrics_group", None)
        scope = getattr(group, "scope", None) or ()
        job = scope[0] if scope else "unknown"
        key = (str(job), vertex, int(idx))
        try:
            st.profiler_scope = key
        except Exception:
            pass
        return key

    # -- sampling -----------------------------------------------------

    def _run(self) -> None:
        while self.enabled and not self._stop.is_set():
            t0 = time.perf_counter()
            try:
                self.sample_once()
            except Exception:
                pass
            period = 1.0 / max(1e-3, float(self.hz))
            self._stop.wait(max(0.0, period -
                                (time.perf_counter() - t0)))

    def sample_once(self) -> int:
        """One sampling pass: snapshot every thread's frame, fold the
        frames of threads with a registered scope, classify, ingest.
        Returns the number of samples recorded.  Scopes whose thread
        has exited are pruned here (``sys._current_frames`` is the
        authority on live threads)."""
        frames = sys._current_frames()
        try:
            own = threading.get_ident()
            recorded = 0
            for tid, st in list(self._scopes.items()):
                frame = frames.get(tid)
                if frame is None:
                    self._scopes.pop(tid, None)
                    continue
                if tid == own:
                    continue
                job, vertex, idx = self._scope_key(st)
                cls = classify_subtask(st)
                stack = fold_stack(frame)
                self.ingest(job, vertex, idx, stack, cls)
                recorded += 1
            return recorded
        finally:
            del frames

    def ingest(self, job: str, vertex: str, subtask_index: int,
               stack: List[str], cls: int) -> None:
        """Fold one (possibly fake — tests) stack into the trie."""
        with self._lock:
            self.samples[cls] += 1
            self._samples_delta[cls] += 1
            key = (job, vertex, subtask_index)
            counts = self._subtask_counts.get(key)
            if counts is None:
                counts = self._subtask_counts[key] = [0, 0, 0]
            counts[cls] += 1
            delta = self._subtask_delta.get(key)
            if delta is None:
                delta = self._subtask_delta[key] = [0, 0, 0]
            delta[cls] += 1
            vertices = self._tries.get(job)
            if vertices is None:
                vertices = self._tries[job] = {}
            node = vertices.get(vertex)
            if node is None:
                if self._node_count >= self.max_nodes:
                    self.dropped += 1
                    self._dropped_delta += 1
                    return
                node = vertices[vertex] = _Node()
                self._node_count += 1
            for name in stack:
                child = node.children.get(name)
                if child is None:
                    if self._node_count >= self.max_nodes:
                        # budget exhausted: truncate at the deepest
                        # existing prefix, remember we lied about depth
                        self.dropped += 1
                        self._dropped_delta += 1
                        break
                    child = node.children[name] = _Node()
                    self._node_count += 1
                node = child
            node.counts[cls] += 1
            node.delta[cls] += 1

    # -- export / merge ----------------------------------------------

    @staticmethod
    def _node_payload(node: _Node, delta: bool) -> Optional[dict]:
        if delta:
            counts = list(node.delta)
            node.delta[0] = node.delta[1] = node.delta[2] = 0
        else:
            counts = list(node.counts)
        children = {}
        for name, child in node.children.items():
            cp = SamplingProfiler._node_payload(child, delta)
            if cp is not None:
                children[name] = cp
        if delta and not any(counts) and not children:
            return None
        return {"counts": counts, "children": children}

    def export(self, job: Optional[str] = None,
               delta: bool = False) -> dict:
        """Serialize collected tries (one job, or all).  With
        ``delta=True`` only counts accrued since the previous delta
        export are returned AND those accumulators reset — the cluster
        increment-shipping primitive (each TaskExecutor ships its own
        deltas, the JobMaster merges)."""
        with self._lock:
            jobs: Dict[str, dict] = {}
            for jname, vertices in self._tries.items():
                if job is not None and jname != job:
                    continue
                vmap: Dict[str, dict] = {}
                for vlabel, root in vertices.items():
                    nd = self._node_payload(root, delta)
                    if nd is None:
                        continue
                    source = (self._subtask_delta if delta
                              else self._subtask_counts)
                    subtasks = {}
                    for (j, v, i), c in source.items():
                        if j == jname and v == vlabel and any(c):
                            subtasks[str(i)] = list(c)
                            if delta:
                                source[(j, v, i)] = [0, 0, 0]
                    vmap[vlabel] = {"root": nd, "subtasks": subtasks}
                if vmap:
                    jobs[jname] = vmap
            if delta:
                dropped = self._dropped_delta
                self._dropped_delta = 0
                counts = list(self._samples_delta)
                self._samples_delta = [0, 0, 0]
            else:
                dropped = self.dropped
                counts = list(self.samples)
            return {"version": 1, "enabled": self.enabled,
                    "hz": self.hz, "nodes": self._node_count,
                    "dropped": dropped,
                    "samples": {
                        "total": sum(counts),
                        "on_cpu": counts[ON_CPU],
                        "off_cpu": counts[OFF_CPU],
                        "backpressured": counts[BACKPRESSURED]},
                    "jobs": jobs}


def empty_export() -> dict:
    """A zero export — the JobMaster's merge seed."""
    return {"version": 1, "enabled": True,
            "hz": float(SamplingProfiler.DEFAULT_HZ), "nodes": 0,
            "dropped": 0,
            "samples": {"total": 0, "on_cpu": 0, "off_cpu": 0,
                        "backpressured": 0},
            "jobs": {}}


def _copy_node(nd: dict) -> dict:
    return {"counts": list(nd["counts"]),
            "children": {name: _copy_node(c)
                         for name, c in nd["children"].items()}}


def _merge_node(dst: dict, src: dict) -> None:
    for i in range(3):
        dst["counts"][i] += src["counts"][i]
    for name, child in src["children"].items():
        mine = dst["children"].get(name)
        if mine is None:
            dst["children"][name] = _copy_node(child)
        else:
            _merge_node(mine, child)


def merge_export(dst: dict, inc: dict) -> dict:
    """Merge one shipped increment (or full export) into an
    accumulating export in place (JobMaster side of
    ``report_profile``)."""
    dst["hz"] = inc.get("hz", dst.get("hz"))
    dst["dropped"] = dst.get("dropped", 0) + inc.get("dropped", 0)
    for jname, vertices in (inc.get("jobs") or {}).items():
        djob = dst["jobs"].setdefault(jname, {})
        for vlabel, ventry in vertices.items():
            mine = djob.get(vlabel)
            if mine is None:
                mine = djob[vlabel] = {"root": _copy_node(ventry["root"]),
                                      "subtasks": {}}
            else:
                _merge_node(mine["root"], ventry["root"])
            for idx, counts in (ventry.get("subtasks") or {}).items():
                have = mine["subtasks"].setdefault(idx, [0, 0, 0])
                for i in range(3):
                    have[i] += counts[i]
    samples = dst.get("samples") or {}
    inc_s = inc.get("samples") or {}
    for k in ("total", "on_cpu", "off_cpu", "backpressured"):
        samples[k] = samples.get(k, 0) + inc_s.get(k, 0)
    dst["samples"] = samples
    return dst


# ---------------------------------------------------------------------
# flame-graph rendering
# ---------------------------------------------------------------------

def _mode_weight(counts: List[int], mode: str) -> int:
    if mode == "on_cpu":
        return counts[ON_CPU]
    if mode == "off_cpu":
        return counts[OFF_CPU] + counts[BACKPRESSURED]
    return counts[0] + counts[1] + counts[2]


def _tree_node(name: str, nd: dict, mode: str) -> Optional[dict]:
    self_w = _mode_weight(nd["counts"], mode)
    children = []
    value = self_w
    for cname in sorted(nd["children"]):
        child = _tree_node(cname, nd["children"][cname], mode)
        if child is not None:
            children.append(child)
            value += child["value"]
    if value == 0:
        return None
    return {"name": name, "value": value, "self": self_w,
            "children": children}


def _vertex_matches(vlabel: str, vertex: str) -> bool:
    if vlabel == vertex:
        return True
    vid, _, name = vlabel.partition("_")
    return vertex == vid or vertex == name


def _cumulative(nd: dict, into: List[int]) -> None:
    for i in range(3):
        into[i] += nd["counts"][i]
    for child in nd["children"].values():
        _cumulative(child, into)


def flamegraph_payload(export: dict, job: str,
                       vertex: Optional[str] = None,
                       mode: str = "full") -> dict:
    """Build the d3-flame-graph JSON payload the ``/flamegraph``
    routes serve from an export (one builder for every surface).
    ``vertex`` filters to one vertex (matched by full label, vertex id, or name);
    ``samples`` reports the per-class split of whatever matched
    regardless of ``mode``, so callers can see the on/off-CPU split
    even while rendering a filtered tree."""
    vertices = (export.get("jobs") or {}).get(job) or {}
    children = []
    split = [0, 0, 0]
    for vlabel in sorted(vertices):
        if vertex is not None and not _vertex_matches(vlabel, vertex):
            continue
        entry = vertices[vlabel]
        _cumulative(entry["root"], split)
        tree = _tree_node(vlabel, entry["root"], mode)
        if tree is not None:
            children.append(tree)
    value = sum(c["value"] for c in children)
    return {"job": job, "vertex": vertex, "mode": mode,
            "enabled": bool(export.get("enabled")),
            "hz": export.get("hz"),
            "dropped": export.get("dropped", 0),
            "samples": {"total": split[0] + split[1] + split[2],
                        "on_cpu": split[ON_CPU],
                        "off_cpu": split[OFF_CPU],
                        "backpressured": split[BACKPRESSURED]},
            "tree": {"name": job, "value": value, "self": 0,
                     "children": children}}


def collapsed_lines(export: dict, job: Optional[str] = None,
                    mode: str = "full") -> List[str]:
    """Render an export as collapsed-stack text (``flamegraph.pl`` /
    speedscope input): one ``vertex;frame;...;frame count`` line per
    trie node with terminal samples."""
    lines: List[str] = []

    def walk(prefix: str, nd: dict) -> None:
        w = _mode_weight(nd["counts"], mode)
        if w:
            lines.append("%s %d" % (prefix, w))
        for name in sorted(nd["children"]):
            walk(prefix + ";" + name, nd["children"][name])

    for jname in sorted(export.get("jobs") or {}):
        if job is not None and jname != job:
            continue
        for vlabel in sorted(export["jobs"][jname]):
            walk(vlabel, export["jobs"][jname][vlabel]["root"])
    return lines


def hottest_frame(tree: dict) -> Optional[Tuple[str, int]]:
    """The single hottest frame (max self-samples) in a flame-graph
    tree."""
    best: Optional[Tuple[str, int]] = None

    def walk(node: dict) -> None:
        nonlocal best
        self_w = int(node.get("self") or 0)
        if self_w and (best is None or self_w > best[1]):
            best = (node["name"], self_w)
        for child in node.get("children") or ():
            walk(child)

    walk(tree)
    return best


# ---------------------------------------------------------------------
# process-wide singleton + gauges
# ---------------------------------------------------------------------

PROFILER = SamplingProfiler()


def get_profiler() -> SamplingProfiler:
    return PROFILER


def register_profiler_gauges(metrics) -> None:
    """Register process-wide ``profiler.*`` gauges on a registry —
    journaled by the MetricsJournal with everything else it samples.
    Safe to call repeatedly (gauges re-register)."""
    p = get_profiler()
    g = metrics.root.add_group("profiler")
    g.gauge("enabled", lambda: 1 if p.enabled else 0)
    g.gauge("hz", lambda: float(p.hz))
    g.gauge("samples", lambda: float(sum(p.samples)))
    g.gauge("on_cpu", lambda: float(p.samples[ON_CPU]))
    g.gauge("off_cpu", lambda: float(p.samples[OFF_CPU]))
    g.gauge("backpressured", lambda: float(p.samples[BACKPRESSURED]))
    g.gauge("dropped", lambda: float(p.dropped))
    g.gauge("nodes", lambda: float(p._node_count))
    g.gauge("threads", lambda: float(len(p._scopes)))
