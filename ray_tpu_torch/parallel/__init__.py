"""Parallel layer of the port: meshes, logical shardings, ring attention.

Counterpart of ``ray_tpu/parallel`` (without its pipeline, ROADMAP A1b):
``MeshSpec``/``make_mesh`` build a ``DeviceMesh`` over the world's ranks
(gloo on the CPU, NCCL on the card), the logical-axis rules give DTensor
placements, and ``ring_attention`` runs the sequence axis through the flash
kernels B1, B2 and B3.
"""

from ray_tpu_torch.parallel.mesh import (MESH_AXES, MeshSpec, make_mesh,
                                         single_device_mesh)
from ray_tpu_torch.parallel.ring import reference_attention, ring_attention
from ray_tpu_torch.parallel.sharding import (
    DEFAULT_RULES,
    logical_placements,
    logical_to_spec,
    shard_array,
    tree_shardings,
    with_logical_constraint,
)

__all__ = [
    "MESH_AXES", "MeshSpec", "make_mesh", "single_device_mesh",
    "DEFAULT_RULES", "logical_to_spec", "logical_placements",
    "tree_shardings", "with_logical_constraint", "shard_array",
    "ring_attention", "reference_attention",
]
