"""Parallel layer of the port: meshes, logical shardings, ring attention,
Megatron's operators and the GPipe pipeline.

Counterpart of ``ray_tpu/parallel``: ``MeshSpec``/``make_mesh`` build a
``DeviceMesh`` over the world's ranks (gloo on the CPU, NCCL on the card),
the logical-axis rules give DTensor placements, ``ring_attention`` runs the
sequence axis through the flash kernels B1, B2 and B3, ``copy_to`` /
``reduce_from`` bracket a region split over the ``tensor`` (or ``expert``)
ranks, and ``pipeline_scan`` runs stacked layers as GPipe stages over
``pipeline``. ``VirtualMesh`` runs one axis' ranks in turn in one process.
"""

from ray_tpu_torch.parallel.mesh import (MESH_AXES, MeshSpec, VirtualMesh,
                                         copy_to, make_mesh, reduce_from,
                                         single_device_mesh)
from ray_tpu_torch.parallel.pipeline import pipeline_axis_size, pipeline_scan
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
    "MESH_AXES", "MeshSpec", "VirtualMesh", "make_mesh",
    "single_device_mesh", "copy_to", "reduce_from", "DEFAULT_RULES",
    "logical_to_spec", "logical_placements", "tree_shardings",
    "with_logical_constraint", "shard_array", "ring_attention",
    "reference_attention", "pipeline_scan", "pipeline_axis_size",
]
