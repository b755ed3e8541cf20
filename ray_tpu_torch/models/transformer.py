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
"""

from __future__ import annotations

import functools
from typing import Any, Dict

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.config import TransformerConfig
from ray_tpu_torch.models.moe import (_silu, init_moe_params, moe_ffn,
                                      moe_param_shapes)
from ray_tpu_torch.ops.flash_attention import flash_attention
from ray_tpu_torch.parallel.ring import reference_attention

Params = Dict[str, Any]

# ---- parameter structure ---------------------------------------------------

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


def layer(params: Params, i: int) -> Params:
    """Layer ``i``'s slice of the stacked ``[L, ...]`` weights (views)."""
    return {k: w[i] for k, w in params["layers"].items()}


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
    if mesh is not None:
        raise NotImplementedError(
            "sharded execution (mesh) is not ported yet: ROADMAP.md, the "
            "parallel layer")
    impl = cfg.attention_impl
    if impl == "auto":
        impl = "pallas" if device.type == "cuda" else "xla"
    if impl == "ring":
        raise NotImplementedError(
            "attention_impl='ring' is not ported yet: ROADMAP.md, the "
            "parallel layer")
    if impl not in ("pallas", "xla"):
        raise ValueError(f"unknown attention_impl {cfg.attention_impl!r}")
    return impl


def _attention(q, k, v, cfg: TransformerConfig):
    if _select_attention(cfg, q.device) == "pallas":
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


def ffn_block(h, lp, cfg: TransformerConfig):
    """SwiGLU (or MoE) FFN -> (down, aux); shared by the forward and
    inference. The aux term (MoE load balance) is 0 for the dense FFN."""
    if cfg.moe_experts:
        return moe_ffn(h, lp, cfg)
    gate = h @ lp["w_gate"].to(cfg.dtype)
    up = h @ lp["w_up"].to(cfg.dtype)
    down = (_silu(gate) * up) @ lp["w_down"].to(cfg.dtype)
    return down, torch.zeros((), dtype=torch.float32, device=h.device)


def lm_head(params: Params, x, cfg: TransformerConfig):
    """Final norm + (tied or separate) vocabulary projection, in fp32."""
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    return x.float() @ head.float()


def embed_tokens(params: Params, tokens, cfg: TransformerConfig):
    # gather, then cast: the same values as casting the table first
    return params["embed"][tokens.to(params["embed"].device)].to(cfg.dtype)


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


def _block(x, lp: Params, cfg: TransformerConfig, positions):
    """One decoder layer: -> (x, aux), the scanned body of the reference."""
    h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
    q, k, v = qkv_proj(h, lp, cfg, positions)
    reps = cfg.n_heads // cfg.kv_heads
    if reps > 1:  # GQA: expand kv heads to match q heads (jnp.repeat)
        k = k.repeat_interleave(reps, dim=2)
        v = v.repeat_interleave(reps, dim=2)
    o = _attention(q, k, v, cfg)
    x = x + attn_out(o, lp, cfg)
    h = rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
    down, aux = ffn_block(h, lp, cfg)
    return x + down, aux


def forward(params: Params, tokens, cfg: TransformerConfig, mesh=None,
            return_aux: bool = False):
    """tokens [B, T] int -> logits [B, T, vocab] fp32, on the params' device.

    With ``return_aux=True`` returns (logits, aux), aux being the summed MoE
    load-balance loss (0.0 for the dense FFN)."""
    x = embed_tokens(params, tokens, cfg)  # [B, T, d]
    _select_attention(cfg, x.device, mesh)  # refuse what is not ported first
    # any policy but "dots" is "nothing", as in the reference
    kw = ({"context_fn": _DOTS_CONTEXT} if cfg.remat_policy == "dots"
          else {})
    positions = torch.arange(x.shape[1], device=x.device)
    # jax.checkpoint's counterpart; without autograd there is nothing to save
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        lp = layer(params, i)
        if remat:
            x, layer_aux = checkpoint(_block, x, lp, cfg, positions,
                                      use_reentrant=False, **kw)
        else:
            x, layer_aux = _block(x, lp, cfg, positions)
        aux = aux + layer_aux
    logits = lm_head(params, x, cfg)
    return (logits, aux) if return_aux else logits


def loss_fn(params: Params, batch: Dict[str, Any], cfg: TransformerConfig,
            mesh=None):
    """Next-token cross entropy, differentiable (``models/training.py``).
    batch: {"tokens": [B, T]} (targets shifted) or {"inputs": [B, T],
    "targets": [B, T], optional "mask": [B, T]}."""
    if "inputs" in batch:
        inputs, targets = batch["inputs"], batch["targets"]
        mask = batch.get("mask")
    else:
        toks = batch["tokens"]
        inputs, targets = toks[:, :-1], toks[:, 1:]
        mask = None
    logits, aux = forward(params, inputs, cfg, mesh, return_aux=True)
    targets = targets.to(logits.device).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.to(logits.device, torch.float32)
        loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    else:
        loss = nll.mean()
    metrics = {"loss": loss, "perplexity": torch.exp(loss)}
    if cfg.moe_experts:
        metrics["moe_aux"] = aux
        loss = loss + cfg.moe_aux_weight * aux
        metrics["total_loss"] = loss
    return loss, metrics
