"""flink_tpu_torch: the PyTorch/CUDA port of flink_tpu.

A second package beside ``flink_tpu`` (the JAX reference, which stays
as it is).  It carries the job path

    env.from_collection(...) -> assign_timestamps_and_watermarks(...)
       -> key_by(...) -> window(TumblingEventTimeWindows.of(size))
       -> aggregate(HyperLogLog | Sum | Count | Min | Max | Avg)
       -> add_sink(...)

with the window state resident in device memory and every device
program on that path a hand-written CUDA kernel for sm_90a
(``flink_tpu_torch/kernels``).  The module layout mirrors
``flink_tpu`` so each counterpart is found under the same name.

Rules the package keeps: it imports ``torch`` and ``numpy``, never
``jax`` and no module of ``flink_tpu``; entry points run on the card
unless the caller passes ``device="cpu"`` (see ``device.py``).
``python -m flink_tpu_torch`` is its command line (``cli.py``).
"""

from flink_tpu_torch.device import resolve_device

__version__ = "0.1.0"

__all__ = ["resolve_device", "__version__"]
