"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain
PyTorch versions.

=================  ==================================================
``hll_update``     HLL register scatter-max (raw or compressed input)
``hll_estimate``   per-slot HLL estimate, dense range or gathered
``scatter_combine``  scatter-add/-min/-max of one f32/i32 column
``clear_rows``     fill slot rows (list or range) with a bit pattern
``merge_rows``     ``state[dst] (op)= state[src]`` row merge (session
                   windows), repeated or unique dst
``set_rows``       write host/device rows into listed slots (restore,
                   host-tier promotion)
=================  ==================================================

A wrapper given CUDA tensors launches its kernel or raises; given CPU
tensors it runs the plain version.  Nothing builds at import (see
``loader``).
"""

from flink_tpu_torch.kernels.clear_rows import clear_rows, clear_rows_plain
from flink_tpu_torch.kernels.hll_estimate import (hll_estimate,
                                                  hll_estimate_plain)
from flink_tpu_torch.kernels.hll_update import hll_update, hll_update_plain
from flink_tpu_torch.kernels.loader import (KERNELS, LAUNCHES, build_all,
                                            reset_launch_counts)
from flink_tpu_torch.kernels.merge_rows import merge_rows, merge_rows_plain
from flink_tpu_torch.kernels.scatter_combine import (scatter_combine,
                                                     scatter_combine_plain)
from flink_tpu_torch.kernels.set_rows import set_rows, set_rows_plain

__all__ = [
    "KERNELS", "LAUNCHES", "build_all", "reset_launch_counts",
    "clear_rows", "clear_rows_plain", "hll_estimate", "hll_estimate_plain",
    "hll_update", "hll_update_plain", "merge_rows", "merge_rows_plain",
    "scatter_combine", "scatter_combine_plain", "set_rows", "set_rows_plain",
]
