"""Multi-shard parallelism: key-group sharding over a device mesh (port
of ``flink_tpu/parallel``).

Keyed state is distributed by assigning key-group ranges to shards, and
the keyBy exchange is a pack into per-target buckets (``shard_pack``)
followed by ``Mesh.all_to_all``.  Every shard of a mesh may live on one
card (virtual shards) or on cards of their own.
"""

from flink_tpu_torch.parallel.mesh import Mesh, devices, virtual_devices
from flink_tpu_torch.parallel.mesh_agg import (MeshWindowAggregation,
                                               make_sharded_step)
from flink_tpu_torch.parallel.mesh_log import (MeshLogSessionWindows,
                                               MeshLogSlidingWindows,
                                               MeshLogTumblingWindows,
                                               mesh_log_engine_for_assigner)
from flink_tpu_torch.parallel.mesh_windows import (MeshSlidingWindows,
                                                   MeshTumblingWindows,
                                                   MeshWindowOverflowError)

__all__ = ["Mesh", "devices", "virtual_devices",
           "MeshWindowAggregation", "make_sharded_step",
           "MeshTumblingWindows", "MeshSlidingWindows",
           "MeshWindowOverflowError",
           "MeshLogTumblingWindows", "MeshLogSlidingWindows",
           "MeshLogSessionWindows", "mesh_log_engine_for_assigner"]
