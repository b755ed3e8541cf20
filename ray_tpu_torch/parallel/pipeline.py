"""Pipeline parallelism: the port of ``ray_tpu/parallel/pipeline.py``.

GPipe over the ``pipeline`` mesh axis. The stacked ``[L, ...]`` layers split
into S stages of L/S contiguous layers (a weight placed by
``interop.shard_params`` holds its stage's layers: ``Shard(0)`` over
``pipeline``), the batch into M microbatches, and the M + S - 1 ticks of the
schedule run stage s on microbatch t - s at tick t. After each tick every
stage hands its output to the next over the pipeline group: one
``batch_isend_irecv`` of a send and a receive on every stage, every tick
(the reference's symmetric ``ppermute``; stage S-1 sends to stage 0, which
drops it). Each stage finishes its work before it posts the hand-off, so no
other collective of the stage (the ring's P2P, the tensor axis'
all-reduces) runs while one is pending. At the end the last stage's outputs
are broadcast to every pipeline rank.

The port skips the bubble ticks' work: a stage computes only where it holds
a microbatch, M times a pass, where the reference computes all M + S - 1
ticks and discards S - 1 of them. The hand-off still runs every tick.

The backward is one autograd Function (``_Pipelined``). Its forward keeps
each (stage, microbatch) graph, the stage's layers under their own
per-layer remat; its backward runs the schedule in reverse: a stage takes
its output's gradient (the last stage from the broadcast's, the others from
the next stage), runs ``torch.autograd.grad`` through that graph for its
input's and its weights' gradients, and hands the input's back. A weight's
gradient adds up over its stage's microbatches, latest first. Stage 0's
input gradient is broadcast to every pipeline rank: the pipeline ranks hold
the same tokens, so every weight outside the stages has the same gradient
on each of them.

With a ``VirtualMesh("pipeline", S)`` one process runs all S stages in the
same schedule: the hand-off is a copy, the broadcasts take the last and the
first stage's own tensors.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from ray_tpu_torch.parallel._dtensor import is_dtensor
from ray_tpu_torch.parallel.mesh import VirtualMesh, axis_index, axis_size
from ray_tpu_torch.parallel.sharding import layer_shard

Params = Dict[str, Any]


def pipeline_axis_size(mesh) -> int:
    return axis_size(mesh, "pipeline")


def microbatch_count(batch: int, stages: int,
                     requested: Optional[int] = None) -> int:
    """M: ``requested`` or 2 S, else the largest count below it that
    divides the batch (the reference's fallback)."""
    m = requested or 2 * stages
    if batch % m:
        m = next((c for c in range(min(m, batch), 0, -1) if batch % c == 0),
                 1)
    return m


def _stage_stack(w, s: int, stages: int):
    """Stage s's ``[L/S, ...]`` part of a stacked weight. A DTensor must be
    split over ``pipeline`` (its local shard is this rank's stage); a plain
    tensor is cut, and only this stage's layers then get a gradient."""
    if not is_dtensor(w):
        return w.chunk(stages)[s]
    from torch.distributed.tensor import Shard

    names = w.device_mesh.mesh_dim_names
    if not any(n == "pipeline" and isinstance(p, Shard) and p.dim == 0
               for n, p in zip(names, w.placements)):
        raise ValueError("a stacked DTensor on a pipeline mesh must be split "
                         "over 'pipeline' on its layers dim "
                         "(interop.shard_params places it so)")
    return w.to_local()


class _Schedule:
    """One pipelined pass: the stages this process runs, the layer body,
    the weights' names and their stacked originals (for the layers'
    DTensors), and the pipeline group (None for virtual stages)."""

    def __init__(self, body, metas: List[Any], stages: List[int], n: int,
                 m: int, group):
        self.body, self.metas, self.stages = body, metas, stages
        self.n, self.m, self.group = n, m, group

    def run_stage(self, act, leaves):
        """The stage's layers, in order, on one microbatch."""
        for i in range(leaves[0].shape[0]):
            lp = {name: layer_shard(meta, i, leaf)
                  for (name, meta), leaf in zip(self.metas, leaves)}
            act, _ = self.body(act, lp)
        return act

    def exchange(self, sent: Dict[int, torch.Tensor], like: torch.Tensor,
                 backward: bool) -> Dict[int, torch.Tensor]:
        """One tick's hand-off, forward (to stage s + 1) or backward (to
        s - 1) -> {stage: what it received}."""
        step = -1 if backward else 1
        if self.group is None:
            return {s + step: x for s, x in sent.items()
                    if 0 <= s + step < self.n}
        (s,) = self.stages
        x = sent.get(s)
        x = torch.zeros_like(like) if x is None else x.contiguous()
        buf = torch.empty_like(like)
        to = dist.get_global_rank(self.group, (s + step) % self.n)
        frm = dist.get_global_rank(self.group, (s - step) % self.n)
        ops = [dist.P2POp(dist.isend, x, to, self.group),
               dist.P2POp(dist.irecv, buf, frm, self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return {s: buf}

    def broadcast(self, parts: List[Optional[torch.Tensor]], src: int,
                  like: torch.Tensor) -> torch.Tensor:
        """Stage ``src``'s microbatch tensors, concatenated, on every
        pipeline rank."""
        if self.group is None or self.stages == [src]:
            out = torch.cat(parts)
        else:
            out = torch.empty((like.shape[0] * self.m, *like.shape[1:]),
                              dtype=like.dtype, device=like.device)
        if self.group is not None:
            dist.broadcast(out, dist.get_global_rank(self.group, src),
                           group=self.group)
        return out


class _Pipelined(torch.autograd.Function):
    """The schedule as one autograd node: forward over the ticks, backward
    over them in reverse (module docstring). Inputs: the schedule, the
    activations x [B, ...], then each stage's stacked leaves, stage by
    stage in ``sched.stages`` order."""

    @staticmethod
    def forward(ctx, sched: _Schedule, x, *leaves):
        n, m, k = sched.n, sched.m, len(sched.metas)
        need = any(ctx.needs_input_grad[1:])
        grad_mode = torch.enable_grad if need else contextlib.nullcontext
        owned = {s: [w.detach().requires_grad_(need)
                     for w in leaves[j * k:(j + 1) * k]]
                 for j, s in enumerate(sched.stages)}
        mbs = x.detach().chunk(m)
        saved, outs, buf = {}, [None] * m, {}
        for t in range(m + n - 1):
            sent = {}
            for s in sched.stages:
                mb = t - s
                if not 0 <= mb < m:
                    continue
                a = (mbs[mb] if s == 0 else buf[s]).detach().requires_grad_(
                    need)
                with grad_mode():
                    y = sched.run_stage(a, owned[s])
                if need:
                    saved[(s, mb)] = (a, y)
                sent[s] = y.detach()
                if s == n - 1:
                    outs[mb] = sent[s]
            if t < m + n - 2:  # the last tick's outputs go nowhere
                buf = sched.exchange(sent, mbs[0], backward=False)
        ctx.sched, ctx.saved, ctx.owned = sched, saved, owned
        return sched.broadcast(outs, n - 1, mbs[0])

    @staticmethod
    def backward(ctx, g):
        sched, saved, owned = ctx.sched, ctx.saved, ctx.owned
        n, m = sched.n, sched.m
        gm = g.contiguous().chunk(m)
        grads = {s: [None] * len(ws) for s, ws in owned.items()}
        dx, gbuf = [None] * m, {}
        for t in reversed(range(m + n - 1)):
            sent = {}
            for s in sched.stages:
                mb = t - s
                if not 0 <= mb < m:
                    continue
                a, y = saved.pop((s, mb))
                gy = gm[mb] if s == n - 1 else gbuf[s]
                res = torch.autograd.grad(y, [a, *owned[s]], gy,
                                          allow_unused=True)
                for i, gi in enumerate(res[1:]):
                    if gi is not None:
                        grads[s][i] = (gi if grads[s][i] is None
                                       else grads[s][i] + gi)
                if s == 0:
                    dx[mb] = res[0]
                else:
                    sent[s] = res[0]
            if t > 0:
                gbuf = sched.exchange(sent, gm[0], backward=True)
        gx = (sched.broadcast(dx, 0, gm[0]) if ctx.needs_input_grad[1]
              else None)
        ctx.saved = ctx.owned = None
        return (None, gx, *[gi for s in sched.stages for gi in grads[s]])


def pipeline_scan(body: Callable, x: torch.Tensor, stacked_params: Params,
                  mesh, num_microbatches: Optional[int] = None
                  ) -> torch.Tensor:
    """``for each layer: x, _ = body(x, layer_params)`` over the stacked
    ``[L, ...]`` weights, pipelined over the mesh's ``pipeline`` axis (a
    DeviceMesh, or a ``VirtualMesh("pipeline", S)`` for all stages in one
    process). ``body`` is the same per-layer function the unpipelined loop
    uses, its remat included; ``x`` is [B, ...] activations, the same on
    every pipeline rank. -> the final activations [B, ...] on every
    pipeline rank, equal to the plain loop's."""
    names = list(stacked_params)
    n = pipeline_axis_size(mesh)
    if n <= 1:
        for i in range(stacked_params[names[0]].shape[0]):
            x, _ = body(x, {k: layer_shard(w, i)
                            for k, w in stacked_params.items()})
        return x
    layers = stacked_params[names[0]].shape[0]
    if layers % n:
        raise ValueError(f"n_layers {layers} not divisible by pipeline "
                         f"size {n}")
    m = microbatch_count(x.shape[0], n, num_microbatches)
    if isinstance(mesh, VirtualMesh):
        stages, group = list(range(n)), None
    else:
        stages = [axis_index(mesh, "pipeline")]
        group = mesh.get_group("pipeline")
    metas = [(k, stacked_params[k]) for k in names]
    leaves = [_stage_stack(stacked_params[k], s, n)
              for s in stages for k in names]
    sched = _Schedule(body, metas, stages, n, m, group)
    return _Pipelined.apply(sched, x, *leaves)
