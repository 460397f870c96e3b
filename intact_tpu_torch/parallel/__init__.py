"""Several cards: the ranks' mesh, the block-row split, the process group and
its collectives (intact_tpu/parallel's counterpart).

The JAX package declares shardings and lets XLA insert the collectives; the
port runs one process per card and issues them itself. The trainer's
standard step is ZeRO-3 over fsdp: each rank holds its slice of every leaf
the rules split (params, gradients, accumulators, moments), a layer is
gathered in one collective where it is used and its gradient
reduce-scattered in one (`sharding.GatherLayer`). The fused step reduces
each gradient over the ranks and updates this rank's global block rows of
the optimizer state (ZeRO-2 over fsdp), then gathers the updated parameters.
NCCL on the card, gloo on the CPU.
"""

from intact_tpu_torch.parallel.mesh import AXIS_NAMES, Mesh, MeshConfig, default_mesh_for, make_mesh
from intact_tpu_torch.parallel.sharding import RowShard, local_rows, row_shard

__all__ = [
    "AXIS_NAMES",
    "Mesh",
    "MeshConfig",
    "default_mesh_for",
    "make_mesh",
    "RowShard",
    "row_shard",
    "local_rows",
]
