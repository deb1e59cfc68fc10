"""The port's mesh: E shards of one device, laid out as the JAX mesh,
and the shard stacks over it; ``multihost`` spans a mesh over the ranks
of a ``torch.distributed`` group."""

from sparkrdma_tpu_torch.parallel.mesh import (
    DCN_AXIS,
    EXEC_AXIS,
    ShardMesh,
    all_exchange_axes,
    dcn_axis,
    exec_axis,
    make_mesh,
    mesh_axis_size,
    named_mesh,
    shard,
    unshard,
)

__all__ = [
    "DCN_AXIS", "EXEC_AXIS", "ShardMesh", "all_exchange_axes", "dcn_axis",
    "exec_axis", "make_mesh", "mesh_axis_size", "named_mesh", "shard",
    "unshard",
]
