"""Train step: the port of ``ray_tpu/models/training.py``.

The optimizer is the reference's optax chain, ``clip_by_global_norm`` then
``adamw`` (``scale_by_adam``, ``add_decayed_weights`` on every leaf,
``scale_by_learning_rate``), with an optional warmup-cosine schedule,
written out as plain functions on tensors in the order and the dtypes that
optax 0.2.6 computes in: a Python scalar is rounded to the tensor's dtype
before it multiplies (JAX's weak typing), the update uses the first moment
before it is cast to ``mu_dtype``, and the second moment keeps the param
dtype. ``torch.optim.AdamW`` decays the params before its step, the same
mathematics in another rounding order, which bf16 params would show.

The train step updates params and moments in place under ``no_grad``,
standing in for the reference's donated state.

With a ``mesh``, params and both moments are DTensors placed by
``param_logical_axes`` (``state_shardings``: ZeRO-3 over ``fsdp``, Megatron
over ``tensor``, experts over ``expert``, the layer stacks' stages over
``pipeline``; each moment placed as its param), the batch is split by
``batch_sharding``, the loss and its gradient are the global ones
(``transformer.loss_fn``), the gradient norm sums each leaf's squares over
the axes that shard it, and the optimizer updates each rank's shards.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ray_tpu_torch.models.config import TransformerConfig
from ray_tpu_torch.models.transformer import (init_params, loss_fn,
                                              placed_logical_axes)
from ray_tpu_torch.parallel.mesh import check_supported, mesh_device, psum
from ray_tpu_torch.parallel.sharding import logical_placements, tree_shardings

TrainState = Dict[str, Any]  # {"step", "params", "opt_state"}
OptState = Dict[str, Any]    # {"count": int32 [], "mu": tree, "nu": tree}
Schedule = Callable[[torch.Tensor], torch.Tensor]


# ---- trees -----------------------------------------------------------------

def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves in ``jax.tree.leaves`` order (dict keys sorted), which is
    the order the global norm sums them in."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def _unflatten(like, leaves: List[torch.Tensor]):
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(like)


def _sum_sq(x) -> torch.Tensor:
    """sum(x * x) of a leaf; for a DTensor, its shard's, all-reduced over
    the mesh axes that shard it (never over its replicas)."""
    if not isinstance(x, DTensor):
        return (x * x).sum()
    local = x.to_local()
    names = x.device_mesh.mesh_dim_names
    axes = [names[i] for i, p in enumerate(x.placements)
            if isinstance(p, Shard)]
    return psum((local * local).sum(), x.device_mesh, axes)


def global_norm(tree) -> torch.Tensor:
    """``optax.global_norm``: sqrt of the sum over leaves of sum(x * x), each
    in its leaf's dtype, added leaf by leaf; a DTensor leaf counts once."""
    return torch.sqrt(sum(_sum_sq(x) for x in tree_leaves(tree)))


def _local(x):
    return x.to_local() if isinstance(x, DTensor) else x


def _scalar(x: float, dtype: torch.dtype) -> float:
    """A Python scalar as JAX's weak typing makes it: rounded to ``dtype``."""
    return torch.tensor(x, dtype=dtype).item()


# ---- schedule --------------------------------------------------------------

def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Schedule:
    """``optax.warmup_cosine_decay_schedule`` on an fp32 count tensor: linear
    from ``init_value`` to ``peak_value`` over ``warmup_steps``, then cosine
    down to ``end_value`` at ``decay_steps``."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError(f"the cosine part needs decay_steps > warmup_steps, "
                         f"got {decay_steps} and {warmup_steps}")

    def schedule(count: torch.Tensor) -> torch.Tensor:
        c = count.to(torch.float32)
        frac = 1 - torch.clamp(c, 0, warmup_steps) / warmup_steps
        warm = (init_value - peak_value) * frac + peak_value
        k = torch.clamp(c - warmup_steps, max=float(cos_steps))
        cosine = 0.5 * (1 + torch.cos(math.pi * k / cos_steps))
        decayed = peak_value * ((1 - alpha) * cosine + alpha)
        return torch.where(c < warmup_steps, warm, decayed)

    return schedule


# ---- optimizer -------------------------------------------------------------

class AdamW:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(...))``.

    ``init(params)`` -> state; ``update(grads, state, params)`` -> (updates,
    new state), as optax's ``tx.update``; ``step_(grads, state, params)``
    applies the same arithmetic in place and returns the raw grads' global
    norm."""

    def __init__(self, learning_rate, *, weight_decay: float, b1: float,
                 b2: float, eps: float, grad_clip: float,
                 mu_dtype: Optional[torch.dtype]):
        self.learning_rate = learning_rate  # a float or a Schedule
        self.weight_decay, self.b1, self.b2 = weight_decay, b1, b2
        self.eps, self.grad_clip, self.mu_dtype = eps, grad_clip, mu_dtype

    def init(self, params) -> OptState:
        leaf = tree_leaves(params)[0]
        return {"count": torch.zeros((), dtype=torch.int32,
                                     device=leaf.device),
                "mu": tree_map(lambda p: torch.zeros_like(
                    p, dtype=self.mu_dtype or p.dtype), params),
                "nu": tree_map(torch.zeros_like, params)}

    def _scalars(self, state: OptState, g_norm: torch.Tensor):
        """Per-step tensors: the clip's norm, the bias corrections for the
        new count (fp32) and the learning rate (fp32, or a float)."""
        count = state["count"]
        c = (count + 1).to(torch.float32)
        dev = count.device
        bc1 = 1 - torch.tensor(self.b1, dtype=torch.float32, device=dev) ** c
        bc2 = 1 - torch.tensor(self.b2, dtype=torch.float32, device=dev) ** c
        lr = self.learning_rate
        if callable(lr):  # scale_by_schedule reads the count before the step
            lr = lr(count)
        return g_norm, bc1, bc2, lr

    def _leaf(self, g, mu, nu, p, scalars):
        """One leaf through the chain -> (update, new mu, new nu)."""
        g_norm, bc1, bc2, lr = scalars
        dt = g.dtype
        # clip_by_global_norm: scale only when the norm reaches max_norm
        g = torch.where(g_norm < self.grad_clip, g,
                        (g / g_norm.to(dt)) * _scalar(self.grad_clip, dt))
        # scale_by_adam: moments, then bias correction in the moments' dtype
        mu = (_scalar(1 - self.b1, dt) * g
              + _scalar(self.b1, mu.dtype) * mu)
        nu = (_scalar(1 - self.b2, dt) * (g * g)
              + _scalar(self.b2, nu.dtype) * nu)
        mu_hat = mu / bc1.to(mu.dtype)
        nu_hat = nu / bc2.to(nu.dtype)
        u = mu_hat / (torch.sqrt(nu_hat) + _scalar(self.eps, nu_hat.dtype))
        if self.mu_dtype is not None:
            mu = mu.to(self.mu_dtype)
        # add_decayed_weights on every leaf (the reference passes no mask)
        u = u + _scalar(self.weight_decay, p.dtype) * p
        # scale_by_learning_rate
        if isinstance(lr, torch.Tensor):
            u = (-lr).to(u.dtype) * u
        else:
            u = _scalar(-lr, u.dtype) * u
        return u, mu, nu

    def update(self, grads, state: OptState, params):
        g_leaves = tree_leaves(grads)
        scalars = self._scalars(state, global_norm(grads))
        outs = [self._leaf(g, m, n, p, scalars) for g, m, n, p in zip(
            g_leaves, tree_leaves(state["mu"]), tree_leaves(state["nu"]),
            tree_leaves(params))]
        new = {"count": state["count"] + 1,
               "mu": _unflatten(params, [o[1] for o in outs]),
               "nu": _unflatten(params, [o[2] for o in outs])}
        return _unflatten(params, [o[0] for o in outs]), new

    @torch.no_grad()
    def step_(self, grads, state: OptState, params,
              g_norm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``g_norm`` (default: ``global_norm(grads)``) is the raw grads'
        norm, given when the trees are shards of larger ones."""
        if g_norm is None:
            g_norm = global_norm(grads)
        scalars = self._scalars(state, g_norm)
        for g, m, n, p in zip(tree_leaves(grads), tree_leaves(state["mu"]),
                              tree_leaves(state["nu"]), tree_leaves(params)):
            u, new_m, new_n = self._leaf(g, m, n, p, scalars)
            p.copy_(apply_updates(p, u))
            m.copy_(new_m)
            n.copy_(new_n)
        state["count"] += 1
        return g_norm


def apply_updates(p: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``optax.apply_updates`` for one leaf: p + u, cast to p's dtype."""
    return (p + u).to(p.dtype)


def make_optimizer(learning_rate: float = 3e-4, *, weight_decay: float = 0.1,
                   b1: float = 0.9, b2: float = 0.95, grad_clip: float = 1.0,
                   warmup_steps: int = 0, total_steps: Optional[int] = None,
                   mu_dtype: Optional[torch.dtype] = None) -> AdamW:
    """AdamW + global-norm clip (+ optional warmup-cosine schedule), as the
    reference builds it. ``mu_dtype=torch.bfloat16`` halves the first
    moment."""
    if warmup_steps or total_steps:
        schedule = warmup_cosine_decay_schedule(
            0.0, learning_rate, max(warmup_steps, 1),
            max(total_steps or warmup_steps * 10, warmup_steps + 1))
    else:
        schedule = learning_rate
    return AdamW(schedule, weight_decay=weight_decay, b1=b1, b2=b2, eps=1e-8,
                 grad_clip=grad_clip, mu_dtype=mu_dtype)


# ---- state and steps -------------------------------------------------------

def make_init_fn(cfg: TransformerConfig, tx: AdamW, device=None):
    def init(rng: torch.Generator) -> TrainState:
        params = init_params(rng, cfg, device)
        return {"step": torch.zeros((), dtype=torch.int32,
                                    device=tree_leaves(params)[0].device),
                "params": params, "opt_state": tx.init(params)}
    return init


def state_shardings(cfg: TransformerConfig, tx: AdamW, mesh, rules=None):
    """Placements for the whole TrainState, same structure.

    The optimizer moments have the params' tree, so each moment takes its
    own param's placements (ZeRO: moments shard exactly like their params;
    the reference matches them by shape, which two params of one shape but
    different axes, such as w_gate and w_down when d_ff == d_model, would
    confuse). The step and the count are replicated."""
    del tx  # the moments' structure is the params'
    place = tree_shardings(mesh, placed_logical_axes(cfg, mesh), rules)
    repl = tuple(Replicate() for _ in mesh.mesh_dim_names)
    return {"step": repl, "params": place,
            "opt_state": {"count": repl, "mu": place, "nu": place}}


def batch_sharding(mesh, rules=None):
    """Placements of a [B, T] token batch array (every key of the batch):
    rows over the batch axes, the sequence over ``sequence``.

    Under sequence parallelism use the {"inputs", "targets"} batch format
    with T divisible by the sequence axis: a raw {"tokens": [B, T+1]} batch
    generally isn't evenly shardable on the seq dim."""
    return logical_placements(mesh, ("batch", "seq"), rules)


def init_train_state(rng: torch.Generator, cfg: TransformerConfig, tx: AdamW,
                     mesh=None, rules=None, device=None) -> TrainState:
    """Params from ``rng`` (on ``device``, CUDA unless the caller asks for
    the CPU) and zero moments. With a ``mesh``: on the mesh's device, every
    rank draws the same params and keeps its shards (``state_shardings``);
    give every rank a generator with the same seed."""
    if mesh is None:
        return make_init_fn(cfg, tx, device)(rng)
    from ray_tpu_torch.interop import shard_state

    check_supported(mesh, cfg)
    state = make_init_fn(cfg, tx, mesh_device(mesh))(rng)
    return shard_state(mesh, state, cfg, tx, rules)


def make_train_step(cfg: TransformerConfig, tx: AdamW, mesh=None,
                    rules=None):
    """-> ``step(state, batch) -> (state, metrics)``. The state is updated
    in place and returned; metrics are ``loss_fn``'s (``loss`` is the cross
    entropy; MoE adds ``moe_aux`` and ``total_loss``, the loss the gradient
    is of), ``grad_norm`` (of the raw grads, before the clip) and
    ``step``. With a ``mesh``, the state is a sharded one
    (``init_train_state(..., mesh)`` or ``interop.shard_state``) and the
    batch the global one: the gradient of the global loss comes back as
    DTensors placed as their params (the gathers' backward), its norm is
    the global one, and the optimizer runs on this rank's shards."""
    del rules  # the state carries its placements
    if mesh is not None:
        check_supported(mesh, cfg)

    def step(state: TrainState, batch):
        params = state["params"]
        leaves = tree_leaves(params)
        flags = [p.requires_grad for p in leaves]
        for p in leaves:
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                loss, metrics = loss_fn(params, batch, cfg, mesh)
                grads = torch.autograd.grad(loss, leaves)
        finally:
            for p, flag in zip(leaves, flags):
                p.requires_grad_(flag)
        grads = _unflatten(params, list(grads))
        grad_norm = global_norm(grads)
        opt = state["opt_state"]
        tx.step_(tree_map(_local, grads),
                 {"count": opt["count"], "mu": tree_map(_local, opt["mu"]),
                  "nu": tree_map(_local, opt["nu"])},
                 tree_map(_local, params), g_norm=grad_norm)
        del grads
        state["step"] += 1
        return state, {**{k: v.detach() for k, v in metrics.items()},
                       "grad_norm": grad_norm, "step": state["step"].clone()}

    return step


def make_eval_step(cfg: TransformerConfig, mesh=None):
    """-> ``step(params, batch) -> metrics`` (``loss_fn``'s, global on a
    ``mesh``)."""
    if mesh is not None:
        check_supported(mesh, cfg)

    @torch.no_grad()
    def step(params, batch):
        _, metrics = loss_fn(params, batch, cfg, mesh)
        return metrics

    return step
