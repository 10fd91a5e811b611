"""Graph iteration models on the device (port of
``flink_tpu/graph/iterations.py``).

Gelly's three models (scatter-gather, gather-sum-apply, vertex-centric
Pregel) are message-combine-update loops.  One superstep here is, over
every edge at once:

1. gather ``vals[src]`` (tensor indexing);
2. the user's message callable on torch tensors, ``gather(src_values,
   edge_values)`` or ``message(src_values, edge_values)``;
3. the combine by ``dst`` on the ``scatter_combine`` kernel
   (``combine``: "sum" | "min" | "max"; float32 or int32 messages on the
   card), into a tensor filled first with the segment identity (0, the
   dtype's max, its min), so a vertex with no in-edges receives the
   identity as ``jax.ops.segment_*`` gives it;
4. the user's update callable, ``apply(old, combined)`` or
   ``compute(vals, combined, superstep)``;
5. ``changed``: any value moved, read on the host every superstep (the
   empty-workset test of Gelly's delta iteration).

Vertex values, edge values and messages take the dtypes JAX gives them
with x64 off: int64 -> int32, float64 -> float32.  Every class runs on
``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from flink_tpu_torch.device import DeviceLike, resolve_device
from flink_tpu_torch.graph.graph import Graph
from flink_tpu_torch.kernels import scatter_combine
from flink_tpu_torch.ops.device_agg import device_dtype

_OPS = {"sum": "add", "min": "min", "max": "max"}


_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32}


def to_device(values, dev: torch.device) -> torch.Tensor:
    """A host column on the device in the dtype JAX with x64 off gives
    it."""
    arr = np.asarray(values)
    return torch.from_numpy(np.ascontiguousarray(arr, device_dtype(arr.dtype))).to(dev)


def narrow(t: torch.Tensor) -> torch.Tensor:
    """A user callable's result in the dtype JAX with x64 off gives it
    (torch promotes to 64 bits where JAX stays at 32)."""
    return t.to(_NARROW[t.dtype]) if t.dtype in _NARROW else t


def _identity(kind: str, dtype: torch.dtype):
    if kind == "sum":
        return 0
    info = torch.finfo(dtype) if dtype.is_floating_point else torch.iinfo(dtype)
    if kind == "min":
        return float("inf") if dtype.is_floating_point else info.max
    return float("-inf") if dtype.is_floating_point else info.min


def segment_combine(kind: str, msgs: torch.Tensor, dst: torch.Tensor,
                    n: int) -> torch.Tensor:
    """``jax.ops.segment_{sum,min,max}(msgs, dst, num_segments=n)``."""
    if kind not in _OPS:
        raise ValueError(f"unknown combine {kind!r}")
    msgs = narrow(msgs).contiguous()
    out = torch.full((n,), _identity(kind, msgs.dtype), dtype=msgs.dtype,
                     device=msgs.device)
    scatter_combine(out, dst, msgs, len(dst), _OPS[kind])
    return out


class GatherSumApplyIteration:
    """(ref: gsa/GatherSumApplyIteration.java)  One superstep = gather
    per edge -> combine per target -> apply per vertex; runs until no
    value changes or ``max_iterations``.  A vertex with no in-edges
    receives the combine's identity, which ``apply`` must treat as "no
    message" (``torch.minimum(old, combined)`` does)."""

    def __init__(self, gather: Callable, combine: str, apply: Callable,
                 max_iterations: int = 100, device: DeviceLike = None):
        if combine not in _OPS:
            raise ValueError(f"unknown combine {combine!r}")
        self.gather = gather
        self.combine = combine
        self.apply = apply
        self.max_iterations = max_iterations
        self.device = device

    def run_arrays(self, values: np.ndarray, src: np.ndarray,
                   dst: np.ndarray, edge_values: np.ndarray) -> np.ndarray:
        dev = resolve_device(self.device)
        n = len(values)
        vals = to_device(values, dev)
        src_t = to_device(np.asarray(src, np.int32), dev)
        dst_t = to_device(np.asarray(dst, np.int32), dev)
        ev = to_device(edge_values, dev)
        for _ in range(self.max_iterations):
            msgs = self.gather(vals.index_select(0, src_t), ev)
            new = narrow(self.apply(vals, segment_combine(self.combine, msgs, dst_t, n)))
            changed = bool((new != vals).any())
            vals = new
            if not changed:
                break
        return vals.cpu().numpy()

    def run(self, graph):
        new_vals = self.run_arrays(
            np.asarray(graph.vertex_values), graph.edge_src,
            graph.edge_dst, graph.edge_values)
        return Graph(graph.vertex_ids, new_vals, graph.edge_src,
                     graph.edge_dst, graph.edge_values)


class ScatterGatherIteration(GatherSumApplyIteration):
    """(ref: spargel/ScatterGatherIteration.java)  Scatter-gather is
    gather-sum-apply on the message direction: the scatter callable
    that makes the message is the gather callable here."""


class PregelIteration:
    """(ref: pregel/VertexCentricIteration.java)  ``compute(vals,
    combined_messages, superstep)`` gives the new values; the message a
    vertex sends along each out-edge is ``message(src_values,
    edge_values)``; it halts when no value changes."""

    def __init__(self, message: Callable, combine: str, compute: Callable,
                 max_iterations: int = 100, device: DeviceLike = None):
        if combine not in _OPS:
            raise ValueError(f"unknown combine {combine!r}")
        self.message = message
        self.combine = combine
        self.compute = compute
        self.max_iterations = max_iterations
        self.device = device

    def run(self, graph):
        dev = resolve_device(self.device)
        n = graph.number_of_vertices()
        vals = to_device(np.asarray(graph.vertex_values), dev)
        src = to_device(graph.edge_src, dev)
        dst = to_device(graph.edge_dst, dev)
        ev = to_device(graph.edge_values, dev)
        for superstep in range(self.max_iterations):
            msgs = self.message(vals.index_select(0, src), ev)
            new = narrow(self.compute(vals, segment_combine(self.combine, msgs, dst, n),
                                      superstep))
            changed = bool((new != vals).any())
            vals = new
            if not changed:
                break
        return Graph(graph.vertex_ids, vals.cpu().numpy(), graph.edge_src,
                     graph.edge_dst, graph.edge_values)
