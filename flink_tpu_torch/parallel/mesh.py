"""The port's device mesh: the counterpart of ``jax.sharding.Mesh`` and
``lax.all_to_all`` as the mesh engines use them.

A :class:`Mesh` holds one torch device per shard along one named axis
(repeats allowed: S virtual shards on one card, as the reference's tests
run 8 virtual CPU devices).  Shard s keeps its table and state on
``mesh.devices[s]`` and runs its kernels inside ``mesh.on(s)``; the
step's pack runs on shard 0's device.  ``mesh.shape[axis]`` is the shard
count, so the reference's ``mesh.shape[axis]`` code reads the same.

``all_to_all`` is the keyBy exchange: ``[S_src, S_tgt, ...]`` buckets in,
``recv[j][s] = buckets[s][j]`` out, ``recv[j]`` on shard j's device.  On
one device it is a transpose made contiguous: the collective's stand-in,
not a kernel.  The whole mesh runs in one process, as the reference's
does; NCCL would need a process per card (``all_to_all_single`` gives
the same layout, which the tests show on a gloo group).

``devices()`` lists what a chain program may shard its rows over: the
cards of this process, or, inside ``virtual_devices(n)``, n virtual
shards on one device (the stand-in for the reference's
``--xla_force_host_platform_device_count``).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Sequence, Union

import torch

from flink_tpu_torch.device import DeviceLike, resolve_device

Received = Union[torch.Tensor, List[torch.Tensor]]


class Mesh:
    """S shards along one named axis, shard s on ``devices[s]``.  Each
    device resolves as every entry point's does: a CUDA device, or the
    CPU only when named."""

    def __init__(self, devices: Sequence[DeviceLike],
                 axis_names: Sequence[str] = ("kg",)):
        if isinstance(axis_names, str):
            axis_names = (axis_names,)
        if len(axis_names) != 1:
            raise ValueError("the port's mesh has one axis")
        self.devices: List[torch.device] = [resolve_device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = tuple(axis_names)
        self.shape = {self.axis_names[0]: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        """Where a step's rows are packed: the first shard's device."""
        return self.devices[0]

    @property
    def single_device(self) -> bool:
        return all(d == self.devices[0] for d in self.devices)

    def on(self, shard: int):
        """Shard ``shard``'s device as the current CUDA device, so that
        kernels launch on its stream (a no-op on the CPU)."""
        d = self.devices[shard]
        return torch.cuda.device(d) if d.type == "cuda" else contextlib.nullcontext()

    def all_to_all(self, buckets: torch.Tensor) -> Received:
        """``[S_src, S_tgt, ...]`` on one device -> ``recv`` with
        ``recv[j][s] = buckets[s][j]``, ``recv[j]`` on shard j's device:
        one ``[S_tgt, S_src, ...]`` tensor when every shard shares a
        device, else a list of ``[S_src, ...]`` tensors."""
        if buckets.shape[0] != self.size or buckets.shape[1] != self.size:
            raise ValueError(f"buckets of shape {tuple(buckets.shape)} on a "
                             f"mesh of {self.size} shards")
        if self.single_device:
            return buckets.to(self.home).transpose(0, 1).contiguous()
        return [buckets[:, j].contiguous().to(d)
                for j, d in enumerate(self.devices)]


_VIRTUAL: Optional[List[torch.device]] = None


def devices() -> List[torch.device]:
    """The devices a chain program may shard its rows over."""
    if _VIRTUAL is not None:
        return list(_VIRTUAL)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@contextlib.contextmanager
def virtual_devices(n: int, device: DeviceLike = None) -> Iterator[None]:
    """Within the block, ``devices()`` is n virtual shards on
    ``device`` (the card unless "cpu")."""
    global _VIRTUAL
    saved = _VIRTUAL
    _VIRTUAL = [resolve_device(device)] * n
    try:
        yield
    finally:
        _VIRTUAL = saved
