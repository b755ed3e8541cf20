"""Device meshes for SPMD programs: the port of ``ray_tpu/parallel/mesh.py``.

The reference names its parallelism axes and builds a ``jax.sharding.Mesh``
over ``jax.devices()``; here the same axes name the dimensions of a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
process group, one rank per device. Everything downstream (sharding rules,
ring attention, the meshed forward and train step) speaks in these names.

Axes (as in the reference):
    data      — pure data parallelism (params replicated)
    fsdp      — data parallelism with sharded params/opt state (ZeRO-3)
    tensor    — Megatron-style tensor parallelism (heads/mlp sharded)
    sequence  — context parallelism (ring attention)
    expert    — MoE expert parallelism
    pipeline  — pipeline stages

Every axis runs at any size that divides the model (``check_supported``).
Ranks along ``tensor``, ``expert`` and ``pipeline`` (``MODEL_AXES``) hold the
same tokens and split the model: Megatron's two operators, ``copy_to``
(identity forward, all-reduce backward) and ``reduce_from`` (all-reduce
forward, identity backward), join their partial results.

``VirtualMesh`` names one axis whose ranks a single process runs in turn
(one card): the same per-rank functions, with each collective a sum over
the ranks' results or a copy from one to the next.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ray_tpu_torch._device import resolve_device

# Canonical axis order: outermost (infrequent comm) first, innermost
# (per-layer comm) last. "slice" (data parallelism across pod slices over
# the data-centre network) only appears when MeshSpec(slices=) > 1.
MESH_AXES: Tuple[str, ...] = (
    "data", "fsdp", "expert", "pipeline", "sequence", "tensor")
DCN_AXIS = "slice"
# axes whose shards hold different batch rows (ring attention's default
# batch_axes, the MoE load-balance statistics)
BATCH_AXES: Tuple[str, ...] = ("slice", "data", "fsdp")
# axes whose shards hold different tokens: the loss's global mean
TOKEN_AXES: Tuple[str, ...] = BATCH_AXES + ("sequence",)
# axes whose ranks hold the same tokens and split the model; a weight
# replicated over them has its whole gradient on each of their ranks
MODEL_AXES: Tuple[str, ...] = ("expert", "pipeline", "tensor")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape; -1 in at most one axis means "fill the rest".

    Example::

        MeshSpec(fsdp=-1, tensor=4).sizes(32)   # -> (1, 8, 1, 1, 1, 4)

    ``slices > 1`` adds a leading "slice" axis over ``slices`` contiguous
    groups of ranks (the reference's simulation branch: torch reports no
    hardware slice index); the ICI axes above describe one slice::

        MeshSpec(fsdp=-1, slices=2).build()  # 8 ranks -> slice=2, fsdp=4
    """

    data: int = 1
    fsdp: int = -1
    expert: int = 1
    pipeline: int = 1
    sequence: int = 1
    tensor: int = 1
    slices: int = 1

    def sizes(self, n_devices: int) -> Tuple[int, ...]:
        """Per-slice ICI axis sizes over n_devices // slices."""
        if self.slices < 1:
            raise ValueError("slices must be >= 1")
        if n_devices % self.slices:
            raise ValueError(
                f"{n_devices} devices not divisible into {self.slices} "
                f"slices")
        per_slice = n_devices // self.slices
        raw = [self.data, self.fsdp, self.expert, self.pipeline,
               self.sequence, self.tensor]
        fills = [i for i, v in enumerate(raw) if v == -1]
        if len(fills) > 1:
            raise ValueError("at most one mesh axis may be -1 (fill)")
        fixed = math.prod(v for v in raw if v != -1)
        if fills:
            if per_slice % fixed:
                raise ValueError(
                    f"{per_slice} per-slice devices not divisible by "
                    f"fixed axes {fixed}")
            raw[fills[0]] = per_slice // fixed
        elif fixed != per_slice:
            raise ValueError(
                f"mesh {raw} needs {fixed} devices/slice, have {per_slice}")
        return tuple(raw)

    def build(self, device=None) -> DeviceMesh:
        """A DeviceMesh over every rank of the default process group, dims
        named MESH_AXES (with a leading "slice" dim when slices > 1), on
        ``device``'s type (CUDA unless the caller asks for the CPU). With no
        process group yet, a world of one is started (``init_world``)."""
        dev = resolve_device(device)
        if not dist.is_initialized():
            init_world(dev)
        world = dist.get_world_size()
        shape = self.sizes(world)
        names = MESH_AXES
        if self.slices > 1:
            shape, names = (self.slices,) + shape, (DCN_AXIS,) + MESH_AXES
        if dev.type == "cuda":
            torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
        # The Partial -> Replicate gradient sums over several replica dims
        # run as one all-reduce per dim; DTensor logs a hint about it once
        # per mesh, which would repeat on every rank of every run.
        logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
            logging.ERROR)
        return init_device_mesh(dev.type, shape, mesh_dim_names=names)


def init_world(device=None) -> None:
    """Starts a default process group of one rank through an in-memory
    store: NCCL on CUDA, gloo only when the caller asks for the CPU. The
    counterpart of ``jax.devices()`` always being there."""
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def make_mesh(n_devices: Optional[int] = None, device=None,
              **axis_sizes) -> DeviceMesh:
    """Shorthand: ``make_mesh(fsdp=8)`` or ``make_mesh(8, tensor=2)``.

    The mesh spans every rank of the world; ``n_devices``, when given, must
    be the world size (the reference may take the leading devices of a
    larger set; a torch world is sized for its mesh instead)."""
    spec = MeshSpec(**axis_sizes) if axis_sizes else MeshSpec()
    if not dist.is_initialized():
        init_world(device)
    if n_devices is not None and n_devices != dist.get_world_size():
        raise ValueError(f"make_mesh({n_devices}): the mesh spans the "
                         f"world's {dist.get_world_size()} ranks")
    return spec.build(device)


def single_device_mesh(device=None) -> DeviceMesh:
    return MeshSpec(fsdp=1).build(device)


# ---- queries ---------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class VirtualMesh:
    """The ``size`` ranks of mesh axis ``axis`` run in turn by one process:
    what one card runs of a multi-rank path. The model calls the real
    driver's per-rank functions for each rank; a collective becomes a sum
    over the ranks' results (``region_sum`` with no groups), an all-gather
    a list, the pipeline's hand-off a copy. Used by ``transformer.forward``
    and ``loss_fn`` (``tensor``, ``pipeline``) and ``moe.moe_ffn``
    (``expert``, ``sequence``); every other axis has size 1."""

    axis: str
    size: int

    def __post_init__(self):
        if self.axis not in MESH_AXES or self.size < 1:
            raise ValueError(f"VirtualMesh({self.axis!r}, {self.size}): "
                             f"an axis of {MESH_AXES} and a size >= 1")


def axis_size(mesh, name: str) -> int:
    """Size of mesh axis ``name``; 1 when the mesh has no such axis (or
    there is no mesh)."""
    if mesh is None:
        return 1
    if isinstance(mesh, VirtualMesh):
        return mesh.size if mesh.axis == name else 1
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(name)) if name in names else 1


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate along ``name`` (0 when the mesh lacks it, for
    no mesh and for a virtual one)."""
    if not isinstance(mesh, DeviceMesh):
        return 0
    names = mesh.mesh_dim_names or ()
    if name not in names:
        return 0
    return mesh.get_coordinate()[names.index(name)]


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's shards live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def present_axes(mesh, names: Sequence[str]) -> Tuple[str, ...]:
    """``names`` that are dims of ``mesh`` with more than one rank."""
    return tuple(n for n in names if axis_size(mesh, n) > 1)


def axis_groups(mesh, names: Sequence[str]) -> tuple:
    """The process groups of ``names`` on a DeviceMesh, those above size 1,
    in the order given; none for no mesh or a virtual one."""
    if not isinstance(mesh, DeviceMesh):
        return ()
    return tuple(mesh.get_group(a) for a in present_axes(mesh, names))


def check_divides(cfg, sizes: dict) -> None:
    """ValueError unless the model splits evenly over the mesh: heads, kv
    heads, d_ff and vocab over ``tensor``, layers over ``pipeline``, experts
    over ``expert``."""
    t = sizes.get("tensor", 1)
    for what, n in (("n_heads", cfg.n_heads), ("kv_heads", cfg.kv_heads),
                    ("d_ff", cfg.d_ff), ("vocab_size", cfg.vocab_size)):
        if n % t:
            raise ValueError(f"{what}={n} does not split over tensor={t}")
    p = sizes.get("pipeline", 1)
    if cfg.n_layers % p:
        raise ValueError(f"n_layers={cfg.n_layers} does not split over "
                         f"pipeline={p}")
    e = sizes.get("expert", 1)
    if cfg.moe_experts and cfg.moe_experts % e:
        raise ValueError(f"moe_experts={cfg.moe_experts} does not split "
                         f"over expert={e}")


def check_supported(mesh, cfg=None) -> None:
    """A mesh is a DeviceMesh (``make_mesh``) or a ``VirtualMesh``, and
    ``cfg`` (when given) divides over it (``check_divides``)."""
    if not isinstance(mesh, (DeviceMesh, VirtualMesh)):
        raise TypeError(f"mesh must be a torch DeviceMesh (make_mesh), got "
                        f"{type(mesh).__name__}")
    if cfg is not None:
        check_divides(cfg, {a: axis_size(mesh, a) for a in MESH_AXES})


def _all_reduce(x, group, op: str = "sum"):
    return funcol.wait_tensor(funcol.all_reduce(x, op, group))


class _AllReduceSum(torch.autograd.Function):
    """y = sum over the group's ranks of x; each rank's dx is the sum of
    the ranks' dy (every rank's loss reads y)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, dy):
        return _all_reduce(dy.contiguous(), ctx.group), None


def psum(x, mesh, axes, differentiable: bool = False):
    """Sum of ``x`` over the ranks of mesh ``axes`` (one functional
    all-reduce per axis above size 1). ``differentiable``: the backward sums
    the gradients over the same ranks; else ``x`` is detached."""
    for group in axis_groups(mesh, axes):
        x = (_AllReduceSum.apply(x, group) if differentiable
             else _all_reduce(x.detach(), group))
    return x


# ---- Megatron's operators over model axes -----------------------------------

class _Copy(torch.autograd.Function):
    """Megatron's "f": the input of a region split over model ranks. The
    forward is the identity; the backward all-reduces the gradient, whose
    ranks each hold the part from their shard."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        for group in ctx.groups:
            dy = _all_reduce(dy.contiguous(), group)
        return dy, None


class _Reduce(torch.autograd.Function):
    """Megatron's "g": the output of such a region. The forward all-reduces
    the ranks' partial sums; the backward is the identity, since every rank
    reads the same loss (``psum``'s backward would count it once a rank)."""

    @staticmethod
    def forward(ctx, x, groups):
        for group in groups:
            x = _all_reduce(x.contiguous(), group)
        return x

    @staticmethod
    def backward(ctx, dy):
        return dy, None


def copy_to(x, groups):
    """``_Copy`` over ``groups`` (``axis_groups``); ``x`` for none."""
    return _Copy.apply(x, tuple(groups)) if groups else x


def rank_inputs(x, groups, n: int = 1) -> list:
    """The input of a region split over model ranks, once for each of the
    ``n`` ranks this process runs: ``copy_to`` on a real mesh (n = 1); for
    virtual ranks an alias each, so that a rank's gradient adds up on its
    own before the ranks' are summed, as on a real mesh."""
    if n == 1:
        return [copy_to(x, groups)]
    return [_Copy.apply(x, ()) for _ in range(n)]


def reduce_from(x, groups):
    """``_Reduce`` over ``groups``; ``x`` for none."""
    return _Reduce.apply(x, tuple(groups)) if groups else x


def region_sum(parts, groups):
    """The partial results of a region split over model ranks -> their sum:
    ``parts`` holds one result for each rank this process runs (one on a
    real mesh, every rank's for a virtual one), added in rank order, then
    ``reduce_from`` over ``groups``."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return reduce_from(out, groups)


def reduce_max(x, groups):
    """Elementwise max over the ranks of ``groups`` (no gradient)."""
    x = x.detach()
    for group in groups:
        x = _all_reduce(x.contiguous(), group, "max")
    return x
