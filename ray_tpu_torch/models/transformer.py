"""Llama-family decoder in PyTorch: the port of ``ray_tpu/models/transformer.py``.

Plain functions on a params dict that keeps the reference's names and
stacked ``[L, ...]`` shapes (``embed``, ``layers/{attn_norm, wq, wk, wv, wo,
mlp_norm, w_gate, w_up, w_down}``, plus ``router`` and per-expert FFN
weights for MoE, ``final_norm``, optional ``lm_head``); ``Transformer`` is an
``nn.Module`` holding the same tensors. A Python loop over the layer index
takes the place of ``lax.scan``; with ``cfg.remat`` each layer runs under
``torch.utils.checkpoint``, the counterpart of ``jax.checkpoint``: policy
``"nothing"`` recomputes the whole layer, ``"dots"`` keeps the outputs of
products without batch dimensions (``dots_with_no_batch_dims_saveable``).
Numerics follow the reference: compute in ``cfg.dtype``, RMSNorm
statistics, softmax, router and logits in fp32.

With a ``mesh`` (``ray_tpu_torch.parallel.make_mesh``), params are DTensors
placed by ``param_logical_axes`` (ZeRO-3 over ``fsdp``; heads, kv heads,
mlp and vocab over ``tensor``; experts over ``expert``; the layer stacks
over ``pipeline``) and each rank runs its batch rows and sequence chunk: a
layer gathers its weights where it uses them (``parallel.sharding.gather``,
inside the remat region, so the backward gathers again and reduce-scatters
the gradient), RoPE takes the chunk's global positions, attention on a
``sequence`` axis above 1 is ring attention, and the loss is the global
mean (``loss_fn``). On ``tensor`` (Megatron) a rank runs its heads and its
d_ff columns between ``copy_to`` and ``reduce_from``, looks tokens up in
its vocabulary rows, and projects onto them; the loss takes the
log-sum-exp over the ranks' logits. On ``pipeline`` the layers run as
GPipe stages (``parallel.pipeline.pipeline_scan``).

The per-rank steps take a list of weight sets, one for each tensor rank the
process runs: one on a real mesh, all of them under a
``VirtualMesh("tensor", t)``, where the reductions are sums in one process
(``forward``, ``loss_fn``).
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.config import TransformerConfig
from ray_tpu_torch.models.moe import (ROUTER_GATHER, _silu,
                                      init_moe_params, moe_ffn,
                                      moe_param_logical_axes,
                                      moe_param_shapes)
from ray_tpu_torch.ops.flash_attention import flash_attention
from ray_tpu_torch.parallel._dtensor import is_dtensor
from ray_tpu_torch.parallel.mesh import (BATCH_AXES, TOKEN_AXES, VirtualMesh,
                                         axis_groups, axis_index, axis_size,
                                         check_supported, psum,
                                         rank_inputs, reduce_max,
                                         region_sum)
from ray_tpu_torch.parallel.pipeline import pipeline_scan
from ray_tpu_torch.parallel.ring import reference_attention, ring_attention
from ray_tpu_torch.parallel.sharding import (gather, layer_shard,
                                             local_shard, logical_placements,
                                             logical_to_spec)

Params = Dict[str, Any]

# ---- parameter structure ---------------------------------------------------

def param_logical_axes(cfg: TransformerConfig) -> Params:
    """Same-structure dict of logical axis tuples (for shardings)."""
    lay = {
        "attn_norm": ("layers", "embed"),
        "wq": ("layers", "embed", "heads", "qkv_dim"),
        "wk": ("layers", "embed", "kv_heads", "qkv_dim"),
        "wv": ("layers", "embed", "kv_heads", "qkv_dim"),
        "wo": ("layers", "heads", "qkv_dim", "embed"),
        "mlp_norm": ("layers", "embed"),
    }
    if cfg.moe_experts:
        lay.update(moe_param_logical_axes())
    else:
        lay.update({
            "w_gate": ("layers", "embed", "mlp"),
            "w_up": ("layers", "embed", "mlp"),
            "w_down": ("layers", "mlp", "embed"),
        })
    axes = {
        "embed": ("vocab", "embed"),
        "layers": lay,
        "final_norm": ("embed",),
    }
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    return axes


def placed_logical_axes(cfg: TransformerConfig, mesh) -> Params:
    """``param_logical_axes`` as a mesh places them: on a ``pipeline`` axis
    above 1 the layer stacks' leading axis is "stages" (``Shard(0)`` over
    ``pipeline``: each stage holds its own L/S layers)."""
    axes = param_logical_axes(cfg)
    if axis_size(mesh, "pipeline") > 1:
        axes["layers"] = {k: ("stages",) + ax[1:]
                          for k, ax in axes["layers"].items()}
    return axes


def tensor_ranks(params: Params, cfg: TransformerConfig, t: int) -> list:
    """Full params -> the weights of each of ``t`` tensor ranks (views),
    split as the rules split them over ``tensor``: heads, kv heads, mlp
    and vocab."""
    def split(x, axes, r):
        spec = logical_to_spec(axes, mesh_axes=("tensor",))
        return x.chunk(t, dim=spec.index("tensor"))[r] \
            if "tensor" in spec else x

    def tree(p, axes, r):
        if isinstance(p, dict):
            return {k: tree(p[k], axes[k], r) for k in p}
        return split(p, axes, r)

    return [tree(params, param_logical_axes(cfg), r) for r in range(t)]


def param_shapes(cfg: TransformerConfig) -> Params:
    """Same-structure dict of each parameter's shape."""
    d, v, L = cfg.d_model, cfg.vocab_size, cfg.n_layers
    hd, H, KV, ff = cfg.head_dim, cfg.n_heads, cfg.kv_heads, cfg.d_ff
    shapes: Params = {
        "embed": (v, d),
        "layers": {
            "attn_norm": (L, d),
            "wq": (L, d, H, hd),
            "wk": (L, d, KV, hd),
            "wv": (L, d, KV, hd),
            "wo": (L, H, hd, d),
            "mlp_norm": (L, d),
        },
        "final_norm": (d,),
    }
    if cfg.moe_experts:
        shapes["layers"].update(moe_param_shapes(cfg))
    else:
        shapes["layers"].update({"w_gate": (L, d, ff), "w_up": (L, d, ff),
                                 "w_down": (L, ff, d)})
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, v)
    return shapes


def init_params(rng: torch.Generator, cfg: TransformerConfig,
                device=None) -> Params:
    """Random params with the reference's shapes and scales (not its bits:
    numbers are drawn from ``rng``, on the generator's device, then moved to
    ``device``, CUDA unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    d, L, ff = cfg.d_model, cfg.n_layers, cfg.d_ff
    pd = cfg.param_dtype

    def normal(shape, scale):
        x = torch.randn(shape, generator=rng, device=rng.device,
                        dtype=torch.float32) * scale
        return x.to(dev, pd)

    def ones(shape):
        return torch.ones(shape, dtype=pd, device=dev)

    shapes = param_shapes(cfg)
    ls = shapes["layers"]
    in_scale = d ** -0.5
    out_scale = (2 * L) ** -0.5 * d ** -0.5  # depth-scaled residual outputs
    lay = {
        "attn_norm": ones(ls["attn_norm"]),
        "wq": normal(ls["wq"], in_scale),
        "wk": normal(ls["wk"], in_scale),
        "wv": normal(ls["wv"], in_scale),
        "wo": normal(ls["wo"], out_scale),
        "mlp_norm": ones(ls["mlp_norm"]),
    }
    if cfg.moe_experts:
        lay.update(init_moe_params(rng, cfg, dev))
    else:
        lay.update({
            "w_gate": normal(ls["w_gate"], in_scale),
            "w_up": normal(ls["w_up"], in_scale),
            "w_down": normal(ls["w_down"], out_scale * (ff / d) ** 0.5),
        })
    params: Params = {
        "embed": normal(shapes["embed"], d ** -0.5),
        "layers": lay,
        "final_norm": ones(shapes["final_norm"]),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(shapes["lm_head"], in_scale)
    return params


def layer(params: Params, i: int, local=None) -> Params:
    """Layer ``i``'s slice of the stacked ``[L, ...]`` weights (views);
    ``local``: the DTensor leaves' ``to_local()`` by name."""
    local = local or {}
    return {k: layer_shard(w, i, local.get(k))
            for k, w in params["layers"].items()}


class Transformer(nn.Module):
    """The params dict as an ``nn.Module``: the stacked weights under the
    reference's names (``layers`` is a ``ParameterDict``), sharing the
    dict's storage and trainable like any module's parameters."""

    def __init__(self, params: Params, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(params["embed"])
        self.layers = nn.ParameterDict(
            {k: nn.Parameter(w) for k, w in params["layers"].items()})
        self.final_norm = nn.Parameter(params["final_norm"])
        self.lm_head = (None if cfg.tie_embeddings else
                        nn.Parameter(params["lm_head"]))

    def params(self) -> Params:
        p = {"embed": self.embed, "layers": dict(self.layers.items()),
             "final_norm": self.final_norm}
        if self.lm_head is not None:
            p["lm_head"] = self.lm_head
        return p

    def forward(self, tokens):
        return forward(self.params(), tokens, self.cfg)


# ---- building blocks -------------------------------------------------------

def rms_norm(x, gamma, eps):
    x32 = x.float()
    scale = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * scale).to(x.dtype) * gamma.to(x.dtype)


def _rope(x, positions, theta):
    """Rotary embedding. x: [B, T, H, D]; positions: [T] (shared across the
    batch) or [B, T] (per-row: continuous-batching decode, where each cache
    slot sits at its own write position)."""
    d_half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, d_half, dtype=torch.float32,
                                    device=x.device) / d_half)
    angles = positions.to(x.device, torch.float32)[..., None] * freqs
    if angles.dim() == 2:
        angles = angles[None]  # shared positions: broadcast over batch
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _select_attention(cfg: TransformerConfig, device: torch.device,
                      mesh=None) -> str:
    """"auto" is the ring on a mesh whose ``sequence`` axis is above 1, else
    the flash kernels on CUDA and plain attention on the CPU. A sequence
    split over ranks runs only as the ring (plain or flash attention would
    see one chunk of it)."""
    impl = cfg.attention_impl
    if impl not in ("auto", "pallas", "xla", "ring"):
        raise ValueError(f"unknown attention_impl {cfg.attention_impl!r}")
    split = mesh is not None and axis_size(mesh, "sequence") > 1
    if impl == "auto":
        impl = "ring" if split else ("pallas" if device.type == "cuda"
                                     else "xla")
    if impl == "ring" and mesh is None:
        raise ValueError("attention_impl='ring' needs a mesh (its "
                         "'sequence' axis)")
    if split and impl != "ring":
        raise NotImplementedError(
            f"attention_impl={impl!r} on a mesh with 'sequence' > 1: a "
            f"split sequence runs as ring attention ('ring' or 'auto')")
    return impl


def _attention(q, k, v, cfg: TransformerConfig, mesh=None):
    impl = _select_attention(cfg, q.device, mesh)
    if impl == "ring":
        return ring_attention(q, k, v, mesh, causal=cfg.causal)
    if impl == "pallas":
        return flash_attention(q, k, v, causal=cfg.causal)
    return reference_attention(q, k, v, causal=cfg.causal)


def _proj(h, w, dtype):
    """h [B, T, d] @ w [d, *out] -> [B, T, *out] in ``dtype``."""
    out = w.shape[1:]
    return (h @ w.to(dtype).reshape(w.shape[0], -1)).reshape(
        *h.shape[:-1], *out)


def qkv_proj(h, lp, cfg: TransformerConfig, positions):
    """Q/K/V projections + RoPE, shared by the forward and the KV-cache
    inference path (models/generate)."""
    q = _proj(h, lp["wq"], cfg.dtype)
    k = _proj(h, lp["wk"], cfg.dtype)
    v = _proj(h, lp["wv"], cfg.dtype)
    return (_rope(q, positions, cfg.rope_theta),
            _rope(k, positions, cfg.rope_theta), v)


def attn_out(o, lp, cfg: TransformerConfig):
    """o [B, T, H, hd] @ wo [H, hd, d] -> [B, T, d]."""
    wo = lp["wo"]
    return o.reshape(*o.shape[:2], -1) @ wo.to(cfg.dtype).reshape(
        -1, wo.shape[-1])


def _swiglu(h, lp, cfg: TransformerConfig):
    gate = h @ lp["w_gate"].to(cfg.dtype)
    up = h @ lp["w_up"].to(cfg.dtype)
    return (_silu(gate) * up) @ lp["w_down"].to(cfg.dtype)


def ffn_block(h, lp, cfg: TransformerConfig, mesh=None):
    """SwiGLU (or MoE) FFN -> (down, aux); shared by the forward and
    inference. The aux term (MoE load balance) is 0 for the dense FFN.
    ``lp``: one rank's weights, or a list (the tensor ranks run here); on a
    tensor mesh each rank runs its d_ff columns between ``copy_to`` and
    ``region_sum``."""
    lps = lp if isinstance(lp, list) else [lp]
    if cfg.moe_experts:
        return moe_ffn(h, lps, cfg, mesh)
    groups = axis_groups(mesh, ("tensor",))
    hs = rank_inputs(h, groups, len(lps))
    down = region_sum([_swiglu(h, one, cfg) for h, one in zip(hs, lps)],
                      groups)
    return down, torch.zeros((), dtype=torch.float32, device=h.device)


def _head(params: Params, cfg: TransformerConfig):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def lm_head(params: Params, x, cfg: TransformerConfig):
    """Final norm + (tied or separate) vocabulary projection, in fp32."""
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return x.float() @ _head(params, cfg).float()


def embed_tokens(params: Params, tokens, cfg: TransformerConfig, mesh=None):
    """tokens [B, T] -> their rows of ``params["embed"]`` in ``cfg.dtype``;
    on a tensor mesh, of this rank's vocabulary rows (``_embed``)."""
    return _embed([params["embed"]], tokens, cfg, mesh)


def _embed(embeds, tokens, cfg: TransformerConfig, mesh=None):
    """The lookup over the vocabulary shards of the tensor ranks run here
    (``embeds``, rank order): each shard gives the rows of the tokens it
    holds and zero elsewhere, and ``region_sum`` adds them (exact: one
    term is not zero). On one whole table, the plain lookup."""
    if len(embeds) == 1 and axis_size(mesh, "tensor") == 1:
        e = embeds[0]
        # gather, then cast: the same values as casting the table first
        return e[tokens.to(e.device)].to(cfg.dtype)
    first = axis_index(mesh, "tensor") * len(embeds)
    parts = []
    for j, e in enumerate(embeds):
        rows = e.shape[0]
        local = tokens.to(e.device).long() - (first + j) * rows
        inside = (local >= 0) & (local < rows)
        x = e[local.clamp(0, rows - 1)].to(cfg.dtype)
        parts.append(torch.where(inside[..., None], x, x.new_zeros(())))
    return region_sum(parts, axis_groups(mesh, ("tensor",)))


def _logits(ranks, x, cfg: TransformerConfig, mesh=None) -> list:
    """Final norm, then each tensor rank's vocabulary projection in fp32:
    [B, T, V/t] each."""
    xs = rank_inputs(rms_norm(x, ranks[0]["final_norm"], cfg.rms_eps),
                     axis_groups(mesh, ("tensor",)), len(ranks))
    return [x.float() @ _head(r, cfg).float() for x, r in zip(xs, ranks)]


def _nll(parts, targets, mesh=None):
    """-log softmax(logits)[target] per token from the vocabulary shards'
    logits (``parts``, rank order, plus those of the other tensor ranks of
    ``mesh``): the log-sum-exp from the max over all shards, then the sum
    of exp over them (``region_sum``: each shard's gradient is its own);
    the gold logit from the shard that holds it."""
    targets = targets.to(parts[0].device).long()
    if len(parts) == 1 and axis_size(mesh, "tensor") == 1:
        logits = parts[0]
        return (torch.logsumexp(logits, dim=-1)
                - torch.gather(logits, -1, targets[..., None])[..., 0])
    groups = axis_groups(mesh, ("tensor",))
    m = reduce_max(torch.stack([p.max(dim=-1).values for p in parts])
                   .amax(dim=0), groups)
    sumexp = region_sum([torch.exp(p - m[..., None]).sum(dim=-1)
                         for p in parts], groups)
    first = axis_index(mesh, "tensor") * len(parts)
    golds = []
    for j, p in enumerate(parts):
        v = p.shape[-1]
        local = targets - (first + j) * v
        inside = (local >= 0) & (local < v)
        g = torch.gather(p, -1, local.clamp(0, v - 1)[..., None])[..., 0]
        golds.append(torch.where(inside, g, torch.zeros_like(g)))
    return m + torch.log(sumexp) - region_sum(golds, groups)


# ---- forward ---------------------------------------------------------------

# remat_policy="dots": jax.checkpoint_policies.dots_with_no_batch_dims_saveable
# saves the outputs of dot_generals without batch dimensions: here aten.mm
# and addmm (the q/k/v/o projections, the dense FFN, the MoE router).
# Batched products (aten.bmm: the MoE experts, plain attention), the flash
# Function (a pallas_call is no dot_general) and every elementwise op are
# recomputed, allocations included: B1 writes its output through ctypes
# into a torch.empty, so a cached allocation would hand the recompute a
# tensor the kernel has already filled.
_DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS_SAVED
            else CheckpointPolicy.PREFER_RECOMPUTE)


_DOTS_CONTEXT = functools.partial(create_selective_checkpoint_contexts,
                                  _dots_policy)


def _gather_layer(lp: Params) -> Params:
    return {k: gather(w, **(ROUTER_GATHER if k == "router" else {}))
            for k, w in lp.items()}


def _attention_part(h, lp, cfg: TransformerConfig, positions, mesh=None):
    """One tensor rank's attention: Q/K/V of its heads (GQA repeats its own
    kv heads: its query heads read exactly those), B1 or the ring, and its
    partial sum of the output projection."""
    q, k, v = qkv_proj(h, lp, cfg, positions)
    reps = q.shape[2] // k.shape[2]
    if reps > 1:  # GQA: expand kv heads to match q heads (jnp.repeat)
        k = k.repeat_interleave(reps, dim=2)
        v = v.repeat_interleave(reps, dim=2)
    return attn_out(_attention(q, k, v, cfg, mesh), lp, cfg)


def _block(x, lps, cfg: TransformerConfig, positions, mesh=None):
    """One decoder layer: -> (x, aux), the scanned body of the reference.
    ``lps``: the layer's weights of each tensor rank run here. DTensor
    weights (a mesh) are gathered here, inside the remat region."""
    lps = [_gather_layer(lp) for lp in lps]
    groups = axis_groups(mesh, ("tensor",))
    hs = rank_inputs(rms_norm(x, lps[0]["attn_norm"], cfg.rms_eps), groups,
                     len(lps))
    x = x + region_sum([_attention_part(h, lp, cfg, positions, mesh)
                        for h, lp in zip(hs, lps)], groups)
    h = rms_norm(x, lps[0]["mlp_norm"], cfg.rms_eps)
    down, aux = ffn_block(h, lps, cfg, mesh)
    return x + down, aux


def _layers(stacks, x, cfg: TransformerConfig, positions, mesh=None,
            pipeline=None):
    """The decoder layers over x -> (x, summed aux). ``stacks``: the stacked
    layer weights of each tensor rank run here. On ``pipeline``'s pipeline
    axis (a DeviceMesh or a VirtualMesh) the layers run as GPipe stages,
    and the aux is 0, as the reference drops it there."""
    # any policy but "dots" is "nothing", as in the reference
    kw = ({"context_fn": _DOTS_CONTEXT} if cfg.remat_policy == "dots"
          else {})
    # jax.checkpoint's counterpart; with no gradient to take there is
    # nothing to save (and torch's checkpoint imports torch._dynamo, which
    # a forward-only process never needs)
    remat = cfg.remat and torch.is_grad_enabled() and (
        x.requires_grad
        or any(w.requires_grad for st in stacks for w in st.values()))

    def body(x, lps):
        if remat:
            return checkpoint(_block, x, lps, cfg, positions, mesh,
                              use_reentrant=False, **kw)
        return _block(x, lps, cfg, positions, mesh)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if axis_size(pipeline, "pipeline") > 1:
        x = pipeline_scan(lambda a, lp: body(a, [lp]), x, stacks[0],
                          pipeline, cfg.pipeline_microbatches)
        return x, aux
    local = [{k: w.to_local() for k, w in st.items()
              if is_dtensor(w)} for st in stacks]
    for i in range(cfg.n_layers):
        x, layer_aux = body(x, [layer({"layers": st}, i, loc)
                                for st, loc in zip(stacks, local)])
        aux = aux + layer_aux
    return x, aux


def _model(ranks, tokens, cfg: TransformerConfig, mesh=None, pipeline=None):
    """Embedding, decoder layers and vocabulary projection for the tensor
    ranks run here (``ranks``: their weights, DTensor layer stacks on a
    mesh) -> (their logits [B, T, V/t] fp32, rank order; the summed aux).
    RoPE takes the sequence chunk's global positions."""
    x = _embed([r["embed"] for r in ranks], tokens, cfg, mesh)
    _select_attention(cfg, x.device, mesh)  # refuse what is not ported first
    t = x.shape[1]
    positions = (axis_index(mesh, "sequence") * t
                 + torch.arange(t, device=x.device))
    x, aux = _layers([r["layers"] for r in ranks], x, cfg, positions, mesh,
                     mesh if pipeline is None else pipeline)
    return _logits(ranks, x, cfg, mesh), aux


def _virtual(params: Params, tokens, cfg: TransformerConfig,
             vm: VirtualMesh):
    """The ranks of a virtual ``tensor`` or ``pipeline`` axis in one process,
    from full params -> (logit parts, aux)."""
    if vm.axis == "tensor":
        return _model(tensor_ranks(params, cfg, vm.size), tokens, cfg)
    if vm.axis == "pipeline":
        return _model([params], tokens, cfg, pipeline=vm)
    raise ValueError(f"a virtual mesh for the model is over 'tensor' or "
                     f"'pipeline', not {vm.axis!r}")


def forward(params: Params, tokens, cfg: TransformerConfig, mesh=None,
            return_aux: bool = False):
    """tokens [B, T] int -> logits [B, T, vocab] fp32, on the params' device.

    With ``return_aux=True`` returns (logits, aux), aux being the summed MoE
    load-balance loss (0.0 for the dense FFN and on a pipeline axis). With a
    ``mesh``, params are DTensors (``interop.shard_params``), ``tokens`` the
    global batch (or a DTensor of it), and the logits a DTensor placed by
    ("batch", "seq", "vocab"). With a ``VirtualMesh`` (tensor or pipeline),
    params are the full plain ones and so are the logits."""
    if mesh is None:
        parts, aux = _model([params], tokens, cfg)
        logits = parts[0]
    elif isinstance(mesh, VirtualMesh):
        check_supported(mesh, cfg)
        parts, aux = _virtual(params, tokens, cfg, mesh)
        logits = torch.cat(parts, dim=-1)
    else:
        from torch.distributed.tensor import DTensor

        check_supported(mesh, cfg)
        parts, aux = _forward_local(params, _local_batch(tokens, mesh), cfg,
                                    mesh)
        B, T = tokens.shape
        shape = (B, T, cfg.vocab_size)
        logits = DTensor.from_local(
            parts[0], mesh,
            logical_placements(mesh, ("batch", "seq", "vocab")),
            run_check=False, shape=shape,
            stride=torch.empty(shape, device="meta").stride())
    return (logits, aux) if return_aux else logits


# ---- the meshed forward and loss --------------------------------------------

def _local_batch(x, mesh):
    """This rank's [B_local, T_local] part of a global [B, T] batch array
    (placed by ("batch", "seq")), or a DTensor's local shard."""
    if is_dtensor(x):
        return x.to_local()
    placements = logical_placements(mesh, ("batch", "seq"))
    for d, axes in ((0, BATCH_AXES), (1, ("sequence",))):
        n = math.prod(axis_size(mesh, a) for a in axes)
        if x.shape[d] % n:
            raise ValueError(f"batch dim {d} of {tuple(x.shape)} does not "
                             f"split evenly over {n} ranks ({axes})")
    return local_shard(x, mesh, placements)


def _forward_local(params: Params, tokens, cfg: TransformerConfig, mesh):
    """This rank's logits [B_local, T_local, V/t] fp32 (a one-item list)
    and the summed aux (global), from DTensor params: the embedding and the
    head are gathered once (the token lookup and a tied head share them),
    each layer gathers its own weights."""
    rank = {"embed": gather(params["embed"]),
            "final_norm": gather(params["final_norm"]),
            "layers": params["layers"]}
    if not cfg.tie_embeddings:
        rank["lm_head"] = gather(params["lm_head"])
    return _model([rank], tokens, cfg, mesh)


def _global_mean(local, count, mesh):
    """A rank's mean over its ``count`` tokens -> the global mean's value
    with the gradient of this rank's share of it, local * count / total
    (the shares' gradients, summed over ranks by the params' gathers, are
    the global mean's). On a mesh of one the share is ``local`` exactly."""
    total = psum(count, mesh, TOKEN_AXES)
    share = local * (torch.clamp(count, min=1.0)
                     / torch.clamp(total, min=1.0))
    return share + (psum(share, mesh, TOKEN_AXES) - share).detach()


def loss_fn(params: Params, batch: Dict[str, Any], cfg: TransformerConfig,
            mesh=None):
    """Next-token cross entropy, differentiable (``models/training.py``).
    batch: {"tokens": [B, T]} (targets shifted) or {"inputs": [B, T],
    "targets": [B, T], optional "mask": [B, T]}.

    With a ``mesh`` (DTensor params, the global batch), each rank runs its
    part of the batch; the loss has the global mean's value and this
    rank's share of its gradient (``_global_mean``); the ranks of a model
    axis compute the same loss. The MoE aux is the same global value on
    every rank (``moe.load_balance``), and its gradient is summed over the
    n ranks that hold tokens times those of ``expert`` and ``tensor`` (the
    router's gather and h's ``copy_to``), so each takes 1/n of it. A
    ``VirtualMesh`` runs its ranks on the full params and the whole batch."""
    if "inputs" in batch:
        inputs, targets = batch["inputs"], batch["targets"]
        mask = batch.get("mask")
    else:
        toks = batch["tokens"]
        inputs, targets = toks[:, :-1], toks[:, 1:]
        mask = None
    real = mesh is not None and not isinstance(mesh, VirtualMesh)
    if mesh is None:
        parts, aux = _model([params], inputs, cfg)
    elif not real:
        check_supported(mesh, cfg)
        parts, aux = _virtual(params, inputs, cfg, mesh)
    else:
        check_supported(mesh, cfg)
        inputs, targets = (_local_batch(inputs, mesh),
                           _local_batch(targets, mesh))
        mask = None if mask is None else _local_batch(mask, mesh)
        parts, aux = _forward_local(params, inputs, cfg, mesh)
    nll = _nll(parts, targets, mesh if real else None)
    if mask is not None:
        mask = mask.to(nll.device, torch.float32)
        count = mask.sum()
        loss = (nll * mask).sum() / torch.clamp(count, min=1.0)
    else:
        count = nll.numel()
        loss = nll.mean()
    if real:
        loss = _global_mean(loss, torch.as_tensor(
            count, dtype=torch.float32, device=nll.device), mesh)
    metrics = {"loss": loss, "perplexity": torch.exp(loss)}
    if cfg.moe_experts:
        metrics["moe_aux"] = aux
        weighted = cfg.moe_aux_weight * aux
        n = 1 if not real else math.prod(
            axis_size(mesh, a) for a in TOKEN_AXES + ("expert", "tensor"))
        if n > 1:
            weighted = weighted / n + (weighted * (1 - 1 / n)).detach()
        loss = loss + weighted
        metrics["total_loss"] = loss
    return loss, metrics
