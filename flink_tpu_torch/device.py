"""Device resolution for the port's entry points.

Entry points (``StreamExecutionEnvironment.get_execution_environment``,
``VectorizedTumblingWindows``, ``DeviceAggregateFunction.init_state``)
run on ``cuda`` unless the caller asks for the CPU with
``device="cpu"``.  There is no silent CPU path: without a card and
without ``device="cpu"`` they raise.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """None → the first CUDA device; "cpu" → the CPU; any other
    spelling must name an available CUDA device."""
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" to run the "
            "port on the CPU with the kernels' plain PyTorch versions")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev

