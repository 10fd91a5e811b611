"""DeviceAggregateFunction: the vectorized aggregation contract (port
of ``flink_tpu/ops/device_agg.py:36-172, 255-370``).

Accumulators for all keys of a window engine live as struct-of-arrays
in device memory, ``state[name][slot, ...]``, one ``torch.Tensor`` per
component.  ``update`` scatters a whole micro-batch in place (the JAX
package donates its buffers, ``donate_argnums=0``; here the kernels
write into the tensors); ``result`` / ``result_dense`` finalize slots;
``clear_slots`` / ``clear_range`` refill them; ``merge_slots`` (a dst
may repeat) and ``merge_rows`` (unique dst) fold rows into rows for
session-window merges, each component by its ``combiners`` entry.
Every device program is a kernel of ``flink_tpu_torch.kernels``, whose
wrappers run the plain PyTorch version for CPU tensors.

dtype canonicalisation: the JAX package runs with x64 off, so a
``StateSpec`` of ``float64`` / ``int64`` (e.g. ``SumAggregate(np.float64)``)
lives on its device as ``float32`` / ``int32``.  The port keeps device
state in the same canonical dtypes (``device_dtype``), so both packages
compute the same numbers.

Each device aggregate is also a plain ``AggregateFunction``: the scalar
contract (``create_accumulator`` / ``add`` / ``get_result`` / ``merge``)
is a host path over single-slot CPU tensors, as the JAX package pins
its scalar programs to the CPU.
"""

from __future__ import annotations

import abc
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from flink_tpu_torch.core.functions import AggregateFunction
from flink_tpu_torch.core.keygroups import stable_hash64
from flink_tpu_torch.device import DeviceLike, resolve_device
from flink_tpu_torch.kernels import clear_rows, merge_rows, scatter_combine

State = Dict[str, torch.Tensor]


class StateSpec(NamedTuple):
    """Per-slot layout of one state component."""
    shape: Tuple[int, ...]   # trailing shape per slot (() for scalar)
    dtype: np.dtype
    fill: float              # initial/cleared value


_CANONICAL = {np.dtype(np.float64): np.dtype(np.float32),
              np.dtype(np.int64): np.dtype(np.int32),
              np.dtype(np.uint64): np.dtype(np.uint32)}


def device_dtype(dtype) -> np.dtype:
    """The dtype a state component or value column has on the device:
    64-bit types narrow to 32 bits, as JAX with x64 off keeps them."""
    dtype = np.dtype(dtype)
    return _CANONICAL.get(dtype, dtype)


def torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, device_dtype(dtype))).dtype


def _fill_value(spec: StateSpec):
    """The fill as a Python number of the component's device dtype
    (finfo(float64).max narrows to +inf in float32, as in JAX)."""
    with np.errstate(over="ignore"):
        return np.array(spec.fill).astype(device_dtype(spec.dtype)).item()


def state_from_numpy(agg: "DeviceAggregateFunction",
                     np_state: Dict[str, np.ndarray],
                     device: DeviceLike = None) -> State:
    """Host arrays (e.g. a JAX engine's snapshot ``state``) → device
    state in the canonical dtypes."""
    dev = resolve_device(device)
    out = {}
    for name, spec in agg.state_specs().items():
        # a copy: on the CPU the tensor must not alias the caller's array
        arr = np.array(np_state[name], dtype=device_dtype(spec.dtype),
                       order="C", copy=True)
        out[name] = torch.from_numpy(arr).to(dev)
    return out


def state_to_numpy(state: State) -> Dict[str, np.ndarray]:
    """Device state → host numpy arrays (the snapshot format), always
    a copy that later updates do not reach."""
    return {k: (v.detach().cpu() if v.is_cuda else v.detach().clone()).numpy()
            for k, v in state.items()}


class DeviceAggregateFunction(AggregateFunction):
    """Batched aggregation over slot-indexed device state."""

    #: update() consumes the `values` column
    needs_value: bool = False
    #: update() consumes value-hash lanes (distinct-count sketches)
    needs_value_hash: bool = False
    #: dtype the batcher should coerce values to (host side)
    value_dtype: np.dtype = np.float32
    #: how the scalar ``merge`` combines each state component
    combiners: Dict[str, str] = {}

    # ---- device contract -------------------------------------------
    def extract_value(self, value):
        """Project the aggregated quantity out of a record before it is
        buffered/hashed for the device."""
        return value

    def extract_column(self, values):
        """Vectorized twin of extract_value; None when this aggregate
        needs per-row extraction."""
        if type(self).extract_value is DeviceAggregateFunction.extract_value:
            return values
        return None

    def compress_value_hash(self, vh_hi: np.ndarray, vh_lo: np.ndarray):
        """Optionally shrink the per-record value-hash lanes on the host
        before transfer; whatever this returns is what update()
        receives as (vh_hi, vh_lo)."""
        return vh_hi, vh_lo

    @abc.abstractmethod
    def state_specs(self) -> Dict[str, StateSpec]:
        ...

    def init_state(self, capacity: int, device: DeviceLike = None) -> State:
        """Fresh state of ``capacity`` slots on ``device`` (the card
        unless ``device="cpu"``), every row at its fill."""
        dev = resolve_device(device)
        state = {name: torch.empty((capacity, *spec.shape),
                                   dtype=torch_dtype(spec.dtype), device=dev)
                 for name, spec in self.state_specs().items()}
        return self.clear_range(state, 0, capacity)

    def grow_state(self, state: State, new_capacity: int) -> State:
        """New tensors of ``new_capacity`` rows: the old rows copied,
        the new ones filled."""
        out = {}
        for name, spec in self.state_specs().items():
            old = state[name]
            new = torch.empty((new_capacity, *spec.shape), dtype=old.dtype,
                              device=old.device)
            new[:old.shape[0]].copy_(old)
            clear_rows(new, _fill_value(spec), start=old.shape[0],
                       count=new_capacity - old.shape[0])
            out[name] = new
        return out

    @abc.abstractmethod
    def update(self, state: State, slots: torch.Tensor,
               values: Optional[torch.Tensor], vh_hi: Optional[torch.Tensor],
               vh_lo: Optional[torch.Tensor], n: int) -> State:
        """Scatter rows ``[0, n)`` into ``state`` in place (rows at or
        beyond ``n`` contribute nothing — the reference's
        ``arange < n`` mask); returns ``state``.  slots: int32 [N];
        values: [N] of the state's device dtype; vh_hi/vh_lo: value
        hash lanes, or whatever ``compress_value_hash`` returned."""

    @abc.abstractmethod
    def result(self, state: State, slots: torch.Tensor) -> torch.Tensor:
        """Finalize the rows ``slots`` (int32)."""

    def result_dense(self, state: State) -> torch.Tensor:
        """Finalize every row of a (possibly sliced) state block."""
        first = next(iter(state.values()))
        return self.result(state, torch.arange(
            first.shape[0], dtype=torch.int32, device=first.device))

    def clear_slots(self, state: State, slots: torch.Tensor) -> State:
        for name, spec in self.state_specs().items():
            clear_rows(state[name], _fill_value(spec), slots=slots)
        return state

    def merge_slots(self, state: State, dst: torch.Tensor,
                    src: torch.Tensor) -> State:
        """In place: ``state[dst] ⊕= state[src]`` per component (its
        ``combiners`` op), a dst may repeat — the session-window
        namespace merge.  No src may also be a dst (see
        ``kernels.merge_rows``)."""
        return self._merge(state, dst, src, unique_dst=False)

    def merge_rows(self, state: State, dst: torch.Tensor,
                   src: torch.Tensor) -> State:
        """``merge_slots`` for pairs whose dst are unique: plain loads
        and stores instead of atomics (the reference's vmapped pair
        merge, ``device_agg.py:139-165``)."""
        return self._merge(state, dst, src, unique_dst=True)

    def _merge(self, state: State, dst, src, unique_dst: bool) -> State:
        for name in self.state_specs():
            op = self.combiners.get(name)
            if op is None:
                raise NotImplementedError(
                    f"{type(self).__name__} does not support merging")
            merge_rows(state[name], dst, src, op, unique_dst=unique_dst)
        return state

    def clear_range(self, state: State, start: int, count: int) -> State:
        """Refill rows ``start .. start + count`` in place — the
        contiguous-tile clear and, over the whole arena, the re-init
        after a full fire."""
        for name, spec in self.state_specs().items():
            clear_rows(state[name], _fill_value(spec), start=start,
                       count=count)
        return state

    # ---- scalar AggregateFunction contract (host path) --------------
    def create_accumulator(self):
        with np.errstate(over="ignore"):
            return {name: np.full(spec.shape if spec.shape else (1,), spec.fill,
                                  dtype=device_dtype(spec.dtype))
                    for name, spec in self.state_specs().items()}

    def _acc_state(self, accumulator) -> State:
        specs = self.state_specs()
        return {k: torch.from_numpy(np.array(accumulator[k], dtype=device_dtype(
            specs[k].dtype)).reshape(1, *specs[k].shape)) for k in specs}

    def _acc_of(self, state: State):
        return {k: v.numpy()[0] if v.dim() > 1 else v.numpy()
                for k, v in state.items()}

    def add(self, value, accumulator):
        state = self._acc_state(accumulator)
        vals, hi, lo = self._host_record(value)
        if self.needs_value_hash:
            hi, lo = self.compress_value_hash(hi, lo)
        self.update(state, torch.zeros(1, dtype=torch.int32),
                    torch.from_numpy(vals), torch.from_numpy(hi),
                    torch.from_numpy(lo), 1)
        return self._acc_of(state)

    def get_result(self, accumulator):
        out = self.result(self._acc_state(accumulator),
                          torch.zeros(1, dtype=torch.int32)).numpy()[0]
        return out.item() if np.ndim(out) == 0 else out

    def merge(self, a, b):
        """a ⊕ b: ``merge_rows`` on a two-row CPU state, as the reference
        runs ``merge_slots`` on its two stacked rows (float min / max in
        its order: NaN wins, -0 < +0)."""
        specs = self.state_specs()
        state = {k: torch.from_numpy(np.stack([
            np.asarray(x[k], device_dtype(specs[k].dtype)).reshape(np.shape(a[k]))
            for x in (a, b)])) for k in specs}
        self.merge_rows(state, torch.zeros(1, dtype=torch.int32),
                        torch.ones(1, dtype=torch.int32))
        return {k: v.numpy()[0] for k, v in state.items()}

    def _host_record(self, value):
        """One scalar value → (values[1], vh_hi[1], vh_lo[1])."""
        value = self.extract_value(value)
        if self.needs_value_hash:
            h = stable_hash64(value)
            hi = np.array([h >> 32], np.uint32)
            lo = np.array([h & 0xFFFFFFFF], np.uint32)
        else:
            hi = np.zeros(1, np.uint32)
            lo = np.zeros(1, np.uint32)
        if self.needs_value:
            vals = np.array([value], device_dtype(self.value_dtype))
        else:
            vals = np.zeros(1, device_dtype(self.value_dtype))
        return vals, hi, lo


# ---------------------------------------------------------------------
# Plain arithmetic aggregates (sum/count/min/max/avg)
# ---------------------------------------------------------------------

def _column(values: torch.Tensor, state_comp: torch.Tensor) -> torch.Tensor:
    return values if values.dtype == state_comp.dtype else values.to(state_comp.dtype)


class SumAggregate(DeviceAggregateFunction):
    needs_value = True
    combiners = {"sum": "add"}

    def __init__(self, dtype=np.float32):
        self._dtype = np.dtype(dtype)
        self.value_dtype = self._dtype

    def state_specs(self):
        return {"sum": StateSpec((), self._dtype, 0)}

    def update(self, state, slots, values, vh_hi, vh_lo, n):
        scatter_combine(state["sum"], slots, _column(values, state["sum"]),
                        n, "add")
        return state

    def result(self, state, slots):
        return state["sum"][slots.to(torch.int64)]

    def result_dense(self, state):
        return state["sum"]


class CountAggregate(DeviceAggregateFunction):
    combiners = {"count": "add"}

    def state_specs(self):
        return {"count": StateSpec((), np.dtype(np.int32), 0)}

    def update(self, state, slots, values, vh_hi, vh_lo, n):
        scatter_combine(state["count"], slots, None, n, "add")
        return state

    def result(self, state, slots):
        return state["count"][slots.to(torch.int64)]

    def result_dense(self, state):
        return state["count"]


class MinAggregate(DeviceAggregateFunction):
    needs_value = True
    combiners = {"min": "min"}

    def __init__(self, dtype=np.float32):
        self._dtype = np.dtype(dtype)
        self.value_dtype = self._dtype

    def state_specs(self):
        big = np.finfo(self._dtype).max if np.issubdtype(self._dtype, np.floating) \
            else np.iinfo(self._dtype).max
        return {"min": StateSpec((), self._dtype, big)}

    def update(self, state, slots, values, vh_hi, vh_lo, n):
        scatter_combine(state["min"], slots, _column(values, state["min"]),
                        n, "min")
        return state

    def result(self, state, slots):
        return state["min"][slots.to(torch.int64)]


class MaxAggregate(DeviceAggregateFunction):
    needs_value = True
    combiners = {"max": "max"}

    def __init__(self, dtype=np.float32):
        self._dtype = np.dtype(dtype)
        self.value_dtype = self._dtype

    def state_specs(self):
        small = np.finfo(self._dtype).min if np.issubdtype(self._dtype, np.floating) \
            else np.iinfo(self._dtype).min
        return {"max": StateSpec((), self._dtype, small)}

    def update(self, state, slots, values, vh_hi, vh_lo, n):
        scatter_combine(state["max"], slots, _column(values, state["max"]),
                        n, "max")
        return state

    def result(self, state, slots):
        return state["max"][slots.to(torch.int64)]


class AvgAggregate(DeviceAggregateFunction):
    needs_value = True
    combiners = {"sum": "add", "count": "add"}

    def state_specs(self):
        return {"sum": StateSpec((), np.dtype(np.float32), 0),
                "count": StateSpec((), np.dtype(np.int32), 0)}

    def update(self, state, slots, values, vh_hi, vh_lo, n):
        scatter_combine(state["sum"], slots, _column(values, state["sum"]),
                        n, "add")
        scatter_combine(state["count"], slots, None, n, "add")
        return state

    def result(self, state, slots):
        idx = slots.to(torch.int64)
        cnt = state["count"][idx]
        return state["sum"][idx] / torch.clamp(cnt, min=1).to(torch.float32)
