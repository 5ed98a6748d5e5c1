"""Mesh construction and multi-process initialization (port of
``ct_mapreduce_tpu.parallel``).

Where the reference coordinates many processes through Redis, this
layer places work on a :class:`~.mesh.Mesh` of ``torch.device`` objects
(batches sharded along the batch axis, reduce state sharded by key),
with copies between the shards' tensors inside a process and
``torch.distributed`` collectives between processes, and rank-0
leadership replacing the Redis election for multi-process runs.
"""

from ct_mapreduce_tpu_torch.parallel.mesh import (
    Mesh,
    MeshSpec,
    make_mesh,
    parse_mesh_shape,
)
from ct_mapreduce_tpu_torch.parallel.distributed import (
    DistributedCoordinator,
    device_barrier,
    initialize_multihost,
    is_leader,
)

__all__ = [
    "Mesh",
    "MeshSpec",
    "make_mesh",
    "parse_mesh_shape",
    "DistributedCoordinator",
    "device_barrier",
    "initialize_multihost",
    "is_leader",
]
