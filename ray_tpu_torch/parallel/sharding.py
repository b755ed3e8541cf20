"""Logical-axis sharding rules: the port of ``ray_tpu/parallel/sharding.py``.

Every array carries *logical* axis names; a rule table maps them to mesh
axes. The reference turns the result into a ``PartitionSpec`` and lets XLA
insert the collectives; here it becomes DTensor placements over a
``DeviceMesh`` (one placement per mesh dim: ``Shard(d)`` where the spec
names that mesh axis for tensor dim ``d``, ``Replicate()`` elsewhere), and
the model code gathers and reduces explicitly (``gather``): over the
data-like axes a weight is gathered whole (ZeRO-3 over ``fsdp``), over
``tensor``, ``expert`` and ``pipeline`` each rank keeps its shard.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ray_tpu_torch.parallel.mesh import MODEL_AXES, TOKEN_AXES

# logical axis -> mesh axis (or tuple of mesh axes, or None = replicate).
# Batch shards over every data-like axis (incl. the "slice" axis of hybrid
# multi-slice meshes); embed shards over fsdp (ZeRO-3); heads/mlp/vocab
# shard over tensor (Megatron); seq over sequence (ring CP). Axes absent
# from a given mesh are dropped at spec-build time.
DEFAULT_RULES: Tuple[Tuple[str, Any], ...] = (
    ("batch", ("slice", "data", "fsdp")),
    ("seq", "sequence"),
    ("embed", "fsdp"),
    ("heads", "tensor"),
    ("kv_heads", "tensor"),
    ("qkv_dim", None),
    ("mlp", "tensor"),
    ("vocab", "tensor"),
    ("experts", "expert"),
    ("layers", None),
    ("stages", "pipeline"),
)

LogicalAxes = Tuple[Optional[str], ...]


def rules_to_dict(rules=None) -> dict:
    return dict(rules if rules is not None else DEFAULT_RULES)


def logical_to_spec(logical: Sequence[Optional[str]], rules=None,
                    mesh_axes: Optional[Sequence[str]] = None) -> tuple:
    """Translate logical axis names into a spec via the rule table: a tuple
    with one entry per tensor dim, each None, a mesh axis name or a tuple
    of them (the reference's ``PartitionSpec`` entries). ``mesh_axes``
    (when given) drops rule axes the target mesh doesn't have — e.g.
    "slice" on a single-slice mesh."""
    table = rules_to_dict(rules)
    out, used = [], set()
    for name in logical:
        mesh_ax = table.get(name) if name is not None else None
        if mesh_ax is not None and mesh_axes is not None:
            if isinstance(mesh_ax, tuple):
                mesh_ax = tuple(a for a in mesh_ax if a in mesh_axes) \
                    or None
            elif mesh_ax not in mesh_axes:
                mesh_ax = None
        # A mesh axis may appear only once per spec; later duplicates replicate.
        if mesh_ax is None:
            out.append(None)
        elif isinstance(mesh_ax, tuple):
            fresh = tuple(a for a in mesh_ax if a not in used)
            used.update(fresh)
            out.append(fresh if fresh else None)
        elif mesh_ax in used:
            out.append(None)
        else:
            used.add(mesh_ax)
            out.append(mesh_ax)
    return tuple(out)


def spec_to_placements(spec: Sequence[Any],
                       mesh_dim_names: Sequence[str]) -> tuple:
    """A spec (``logical_to_spec``) -> one placement per mesh dim:
    ``Shard(d)`` on each mesh dim the spec names for tensor dim ``d``,
    ``Replicate()`` elsewhere. A tensor dim split over several mesh dims
    (``("slice", "data", "fsdp")``) is split in mesh-dim order, outermost
    first, as the reference's tuple entries are."""
    out = [Replicate() for _ in mesh_dim_names]
    for d, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        for ax in axes:
            if ax is not None:
                out[list(mesh_dim_names).index(ax)] = Shard(d)
    return tuple(out)


def logical_placements(mesh: DeviceMesh, logical: Sequence[Optional[str]],
                       rules=None) -> tuple:
    """Placements on ``mesh`` for an array with logical axes ``logical``:
    the counterpart of the reference's ``logical_sharding``."""
    names = mesh.mesh_dim_names
    return spec_to_placements(logical_to_spec(logical, rules, names), names)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def tree_shardings(mesh: DeviceMesh, logical_tree: Any, rules=None) -> Any:
    """Map a (dict) tree of logical-axis tuples to a tree of placements."""
    if isinstance(logical_tree, dict):
        return {k: tree_shardings(mesh, v, rules)
                for k, v in logical_tree.items()}
    if not _is_axes(logical_tree):
        raise TypeError(f"not a logical-axis tuple: {logical_tree!r}")
    return logical_placements(mesh, logical_tree, rules)


def local_shard(x: torch.Tensor, mesh: DeviceMesh, placements) -> torch.Tensor:
    """This rank's shard of the global ``x`` under ``placements``, by
    slicing (no communication): ``torch.chunk`` along each sharded dim, in
    mesh-dim order, as DTensor splits."""
    coord = mesh.get_coordinate()
    for mesh_dim, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(mesh_dim)
            chunks = torch.chunk(x, n, dim=p.dim)
            i = coord[mesh_dim]
            x = (chunks[i] if i < len(chunks) else
                 x.narrow(p.dim, x.shape[p.dim], 0))
    return x


def distribute(x: torch.Tensor, mesh: DeviceMesh, placements) -> DTensor:
    """A global tensor, the same on every rank, as a DTensor: each rank keeps
    its own shard (``local_shard``), so nothing is sent."""
    local = local_shard(x, mesh, placements).contiguous()
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=x.shape, stride=x.stride())


def shard_array(mesh: DeviceMesh, x: torch.Tensor, logical, rules=None):
    """``x`` as a DTensor placed by its logical axes (``distribute``: every
    rank passes the same global ``x``)."""
    return distribute(x, mesh, logical_placements(mesh, logical, rules))


def with_logical_constraint(x, logical: Sequence[Optional[str]], rules=None,
                            mesh: Optional[DeviceMesh] = None):
    """``lax.with_sharding_constraint`` in logical-axis vocabulary: a
    DTensor is redistributed to the placements of ``logical``; a plain
    tensor, or no mesh, passes through unchanged (the model code works on
    local shards, whose layout the rules already fix)."""
    if not isinstance(x, DTensor):
        return x
    mesh = mesh or x.device_mesh
    return x.redistribute(mesh, logical_placements(mesh, logical, rules))


def gather(x, whole: Sequence[str] = (),
           grad_sum: Sequence[str] = TOKEN_AXES):
    """A DTensor's value for a local computation, as a plain tensor: gathered
    over every mesh dim that shards it except the model axes (tensor,
    expert, pipeline), whose shards each rank keeps, unless named in
    ``whole``. The gradient that flows back is summed over the ranks of
    ``grad_sum`` (by default the token axes, whose ranks see different
    tokens) and reduce-scattered where the weight is sharded over them;
    over every other dim each rank's gradient is already its shard's whole
    gradient, and summing it there would count it once a rank. A plain
    tensor passes through."""
    if not isinstance(x, DTensor):
        return x
    names = x.device_mesh.mesh_dim_names
    target = [p if n in MODEL_AXES and n not in whole else Replicate()
              for n, p in zip(names, x.placements)]
    grads = [Partial() if n in grad_sum else p
             for n, p in zip(names, target)]
    return x.redistribute(x.device_mesh, target).to_local(
        grad_placements=grads)


def layer_shard(w, i: int, local=None):
    """Layer ``i`` of a stacked ``[L, ...]`` weight: a view, or for a DTensor
    the DTensor of this rank's slice of its shard (nothing is sent).
    ``local`` is ``w.to_local()``, taken once for all layers: the layers'
    gradients then add up in that plain tensor, not as DTensors. A stack
    split over pipeline stages (``Shard(0)``) holds this stage's layers in
    ``local`` and ``i`` counts within them; the layer's DTensor is
    replicated over that dim (its gather sends nothing there)."""
    if not isinstance(w, DTensor):
        return w[i] if local is None else local[i]
    placements = [(Replicate() if p.dim == 0 else Shard(p.dim - 1))
                  if isinstance(p, Shard) else p for p in w.placements]
    local = w.to_local() if local is None else local
    shape = w.shape[1:]
    return DTensor.from_local(local[i], w.device_mesh, placements,
                              run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())
