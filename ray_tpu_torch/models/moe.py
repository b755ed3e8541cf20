"""Mixture-of-Experts FFN: the port of ``ray_tpu/models/moe.py``.

The same function as the reference's: fp32 router and softmax over all E
experts, top-k with the combine weights renormalised to sum to 1 (Mixtral),
per-row expert capacity C = max(1, ceil(T*k/E * capacity_factor)) claimed
in token order, then slot order, overflowing slots dropped (they contribute
zero), SwiGLU experts in ``cfg.dtype``, an fp32 combine, and the Switch
load-balance term E * sum_e frac_e * mean_p_e.

The reference writes dispatch and combine as products with a one-hot
[B, T*k, E, C] slot tensor (static shapes for the TPU's matrix unit). At
llama3-1b width that tensor is 335 MB a layer and each of the two products
344 GFLOP, while every output element has at most one non-zero term in
those sums. ``moe_ffn`` computes the same function from an index: each
kept slot's place in an [E, B*C] expert batch, one gather of the token rows
into it, ``torch.bmm`` per product, and one gather back, times the slot's
weight. ``moe_ffn_dense`` is the literal port of the reference's einsums,
kept for the tests and the card's checks; no forward path calls it.

On a mesh (``moe_layer``): ranks along ``expert`` and ``tensor`` hold the
same tokens. Each routes them all (the router is gathered whole), takes
only the kept slots of its E/ep experts, runs them on its d_ff/t columns,
and the partial outputs are summed over both axes (``region_sum``, fp32).
Ranks along ``sequence`` hold chunks of the same rows, and capacity is
claimed along the whole row: rank s offsets its places in each (row,
expert) by the slots the lower ranks' chunks route there (one all-gather
of [B, E] counts), C comes from the whole row's length, and the Switch
aux's means are taken over every token axis.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist

from ray_tpu_torch.parallel.mesh import (TOKEN_AXES, VirtualMesh,
                                         axis_groups, axis_index, axis_size,
                                         copy_to, psum, region_sum)

Params = Dict[str, Any]
# how the router's DTensor is gathered (parallel.sharding.gather): whole,
# since every expert rank routes every token; its gradient is partial over
# the expert and tensor ranks (each sees the combine weights of its own
# experts' and columns' outputs), so it is summed over them too
ROUTER_GATHER = dict(whole=("expert",),
                     grad_sum=TOKEN_AXES + ("expert", "tensor"))


def moe_param_logical_axes() -> Dict[str, tuple]:
    """Logical axes for one layer-stack of MoE parameters (leading layers
    axis; experts axis sharded over the ``expert`` mesh axis)."""
    return {
        "router": ("layers", "embed", "experts"),
        "w_gate": ("layers", "experts", "embed", "mlp"),
        "w_up": ("layers", "experts", "embed", "mlp"),
        "w_down": ("layers", "experts", "mlp", "embed"),
    }


def _silu(x):
    # jax.nn.silu's own definition, x * (1 / (1 + exp(-x))), one op at a
    # time in x's dtype: in bf16 it rounds where the reference rounds
    # (F.silu rounds once and disagrees with it on ~40% of bf16 inputs)
    return x * torch.reciprocal(1 + torch.exp(-x))


def moe_param_shapes(cfg) -> Params:
    """One layer stack of MoE params: router [L, d, E] and the experts'
    SwiGLU [L, E, ...]."""
    L, d, ff, E = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.moe_experts
    return {"router": (L, d, E), "w_gate": (L, E, d, ff),
            "w_up": (L, E, d, ff), "w_down": (L, E, ff, d)}


def init_moe_params(rng: torch.Generator, cfg, device) -> Params:
    """Random MoE params with the reference's scales (its bits are not
    reproduced: numbers come from ``rng``, on the generator's device)."""
    L, d, ff = cfg.n_layers, cfg.d_model, cfg.d_ff
    in_scale = d ** -0.5
    out_scale = (2 * L) ** -0.5 * d ** -0.5 * (ff / d) ** 0.5
    scales = {"router": in_scale, "w_gate": in_scale, "w_up": in_scale,
              "w_down": out_scale}
    out = {}
    for name, shape in moe_param_shapes(cfg).items():
        x = torch.randn(shape, generator=rng, device=rng.device,
                        dtype=torch.float32) * scales[name]
        out[name] = x.to(device, cfg.param_dtype)
    return out


def capacity(T: int, cfg) -> int:
    """Slots per expert and batch row for a call of length T."""
    return max(1, math.ceil(T * cfg.moe_top_k / cfg.moe_experts
                            * cfg.moe_capacity_factor))


def router_probs(h, router) -> torch.Tensor:
    """h [B, T, d] -> softmax over the experts [B, T, E], in fp32."""
    return torch.softmax(h.float() @ router.float(), dim=-1)


def top_k(probs, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (weights [B, T, k] renormalised to sum to 1, expert ids [B, T, k]),
    largest first. Equal probabilities go to the lower expert id, as
    ``jax.lax.top_k`` breaks ties (``torch.topk`` promises no order there),
    hence a stable descending sort."""
    p, i = torch.sort(probs, dim=-1, descending=True, stable=True)
    p, i = p[..., :k], i[..., :k]
    return p / torch.clamp(p.sum(-1, keepdim=True), min=1e-9), i


def route(h, router, k: int):
    """-> (probs [B, T, E] fp32, weights [B, T, k], expert ids [B, T, k])."""
    probs = router_probs(h, router)
    return (probs, *top_k(probs, k))


def slot_counts(top_i, E: int) -> torch.Tensor:
    """[B, E]: the slots of each row routed to each expert."""
    B = top_i.shape[0]
    return torch.nn.functional.one_hot(top_i.reshape(B, -1), E).sum(dim=1)


def assign_slots(top_i, E: int, C: int, offset=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity per batch row: the k slots of each token, flattened in token
    order then slot order into a stream of S = T*k, claim their expert's
    places first come first served. ``offset`` [B, E]: the places the row's
    earlier tokens (on lower sequence ranks) have claimed. -> (place [B, S]
    of each slot within its expert, kept [B, S] bool: place < C)."""
    B = top_i.shape[0]
    ids = top_i.reshape(B, -1)
    onehot = torch.nn.functional.one_hot(ids, E)              # [B, S, E]
    place = torch.cumsum(onehot, dim=1).gather(-1, ids[..., None])[..., 0] - 1
    if offset is not None:
        place = place + offset.gather(1, ids)
    return place, place < C


def load_balance(probs, top_i, E: int, mesh=None):
    """Switch aux loss: E * sum_e (share of tokens whose top-1 is e) * (mean
    router probability of e); 1.0 at perfect balance. On a mesh whose
    tokens are split (batch rows or sequence chunks), both means are
    global: the per-rank sums are all-reduced over the token axes before
    the product (the probabilities' differentiably), so every rank holds the
    same aux."""
    top1 = torch.nn.functional.one_hot(top_i[..., 0], E).float()
    if not axis_groups(mesh, TOKEN_AXES):
        frac = top1.reshape(-1, E).mean(dim=0)
        mean_p = probs.reshape(-1, E).mean(dim=0)
        return E * (frac * mean_p).sum()
    n = psum(torch.tensor(float(top1.shape[0] * top1.shape[1]),
                          device=probs.device), mesh, TOKEN_AXES)
    frac = psum(top1.reshape(-1, E).sum(dim=0), mesh, TOKEN_AXES) / n
    mean_p = psum(probs.reshape(-1, E).sum(dim=0), mesh, TOKEN_AXES,
                  differentiable=True) / n
    return E * (frac * mean_p).sum()


def expert_partial(h, top_p, top_i, place, kept, lp: Params, C: int,
                   first: int = 0) -> torch.Tensor:
    """One rank's experts, ``first`` to ``first`` + E_l (E_l = the experts
    in ``lp``'s w_gate), on the kept slots routed to them: h [B, T, d] ->
    their part of the output [B, T, d], fp32.

    Dispatch by index: the kept slot s of row b, routed to expert e at
    place c, fills row b*C + c of expert e's batch; empty places, and slots
    of other ranks' experts, read a zero row. Expert e's output row comes
    back to slot s times the slot's weight (fp32), and the k slots of a
    token are summed."""
    B, T, d = h.shape
    k = top_i.shape[-1]
    n_e = lp["w_gate"].shape[0]
    S = T * k
    rows = n_e * B * C
    b = torch.arange(B, device=h.device)[:, None]
    ids = top_i.reshape(B, S) - first
    mine = kept & (ids >= 0) & (ids < n_e)
    # each slot's row in the [E_l*B*C] expert batch; a slot not taken here
    # points at the extra row `rows`, which is zero on the way in and
    # ignored after
    dest = torch.where(mine, (ids * B + b) * C + place, rows)
    token = b * T + torch.arange(S, device=h.device) // k
    source = torch.full((rows + 1,), B * T, dtype=torch.long, device=h.device)
    source.scatter_(0, dest.reshape(-1), token.reshape(-1))
    h_rows = torch.cat([h.reshape(B * T, d), h.new_zeros(1, d)])
    xin = h_rows[source[:rows]].reshape(n_e, B * C, d)
    # each expert's SwiGLU on its B*C rows
    gate = torch.bmm(xin, lp["w_gate"].to(h.dtype))
    up = torch.bmm(xin, lp["w_up"].to(h.dtype))
    out = torch.bmm(_silu(gate) * up, lp["w_down"].to(h.dtype)).reshape(
        rows, d)
    out = torch.cat([out, out.new_zeros(1, d)]).float()
    y = out[dest] * top_p.reshape(B, S, 1)
    return y.reshape(B, T, k, d).sum(dim=2)


def _expert_slice(lp: Params, r: int, n: int) -> Params:
    """Expert rank r of n's weights: its E/n experts, the router whole."""
    return {name: (w if name == "router" else w.chunk(n)[r])
            for name, w in lp.items()}


def moe_layer(h, lp, cfg, mesh=None):
    """One MoE FFN layer on this rank: h [B, T, d] -> (out [B, T, d] in h's
    dtype, aux fp32 scalar, expert ids [B, T, k], kept [B, T*k] bool). lp:
    one layer's {router [d, E], w_gate/w_up [E_l, d, ff_l], w_down [E_l,
    ff_l, d]}, this rank's experts and columns; a list of such dicts is the
    tensor ranks this process runs. ``mesh``: a DeviceMesh (module
    docstring) or a VirtualMesh over ``expert`` or ``sequence``."""
    if isinstance(mesh, VirtualMesh):
        return _moe_virtual(h, lp, cfg, mesh)
    lps = lp if isinstance(lp, list) else [lp]
    B, T, d = h.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    n_seq = axis_size(mesh, "sequence")
    C = capacity(T * n_seq, cfg)
    groups = axis_groups(mesh, ("expert", "tensor"))
    h = copy_to(h, groups)
    probs, top_p, top_i = route(h, lps[0]["router"], k)
    offset = None
    if n_seq > 1:
        counts = [torch.empty((B, E), dtype=torch.long, device=h.device)
                  for _ in range(n_seq)]
        dist.all_gather(counts, slot_counts(top_i, E),
                        group=mesh.get_group("sequence"))
        offset = sum(counts[:axis_index(mesh, "sequence")],
                     torch.zeros_like(counts[0]))
    place, kept = assign_slots(top_i, E, C, offset)
    first = axis_index(mesh, "expert") * (E // axis_size(mesh, "expert"))
    y = region_sum([expert_partial(h, top_p, top_i, place, kept, one, C,
                                   first) for one in lps], groups)
    return y.to(h.dtype), load_balance(probs, top_i, E, mesh), top_i, kept


def _moe_virtual(h, lp: Params, cfg, vm: VirtualMesh):
    """``moe_layer``'s per-rank steps for the ranks of a virtual ``expert``
    or ``sequence`` axis in turn: the all-gather of counts is the list of
    the ranks' counts, the reduce over expert ranks a sum."""
    B, T, d = h.shape
    E, k, n = cfg.moe_experts, cfg.moe_top_k, vm.size
    C = capacity(T, cfg)
    if vm.axis == "expert":
        if E % n:
            raise ValueError(f"moe_experts={E} does not split over "
                             f"expert={n}")
        parts = []
        for r in range(n):
            probs, top_p, top_i = route(h, lp["router"], k)
            place, kept = assign_slots(top_i, E, C)
            parts.append(expert_partial(h, top_p, top_i, place, kept,
                                        _expert_slice(lp, r, n), C,
                                        r * (E // n)))
        y = region_sum(parts, ())
    elif vm.axis == "sequence":
        chunks = h.chunk(n, dim=1)
        routes = [route(c, lp["router"], k) for c in chunks]
        counts = [slot_counts(top_i, E) for _, _, top_i in routes]
        ys, kepts = [], []
        for s, (c, (_, top_p, top_i)) in enumerate(zip(chunks, routes)):
            offset = sum(counts[:s], torch.zeros_like(counts[0]))
            place, kept = assign_slots(top_i, E, C, offset)
            ys.append(expert_partial(c, top_p, top_i, place, kept, lp, C))
            kepts.append(kept)
        y, kept = torch.cat(ys, dim=1), torch.cat(kepts, dim=1)
        probs = torch.cat([r[0] for r in routes], dim=1)
        top_i = torch.cat([r[2] for r in routes], dim=1)
    else:
        raise ValueError(f"a virtual mesh for moe_layer is over 'expert' or "
                         f"'sequence', not {vm.axis!r}")
    return y.to(h.dtype), load_balance(probs, top_i, E), top_i, kept


def moe_ffn(h, lp, cfg, mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One MoE FFN layer: h [B, T, d] -> (out [B, T, d] in h's dtype, aux
    fp32 scalar); ``moe_layer`` without its routing outputs. With a
    ``mesh``, h holds this rank's batch rows and sequence chunk, and the
    aux is global (``load_balance``)."""
    return moe_layer(h, lp, cfg, mesh)[:2]


def moe_ffn_dense(h, lp: Params, cfg):
    """The reference's ``moe_ffn`` op for op: one-hot slot tensor, dispatch
    and combine as einsums. It shares ``router_probs`` with ``moe_ffn`` (the
    reference's einsum and softmax) so that both see the same bits; its
    top-k (k rounds of argmax, which returns the first of equal maxima) and
    capacity are its own. -> (out, aux, expert ids [B, T, k], kept [B, T*k]
    bool), the last two for the checks that hold ``moe_ffn`` against it."""
    B, T, d = h.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    C = capacity(T, cfg)
    dtype = h.dtype
    probs = router_probs(h, lp["router"])
    rest, ids = probs.clone(), []
    for _ in range(k):
        ids.append(rest.argmax(dim=-1))
        rest = rest.scatter(-1, ids[-1][..., None], -1.0)
    top_i = torch.stack(ids, dim=-1)
    top_p = probs.gather(-1, top_i)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    oh = torch.nn.functional.one_hot(top_i, E).float().reshape(B, T * k, E)
    pos = torch.cumsum(oh, dim=1) - 1.0
    in_cap = (pos < C) * oh
    # jax.nn.one_hot is all zeros outside [0, C); torch's refuses such
    # classes, and in_cap is 0 wherever pos is outside
    slot = torch.nn.functional.one_hot(pos.long().clamp(0, C - 1), C) \
        .float() * in_cap[..., None]                           # [B, S, E, C]
    hk = h[:, :, None, :].expand(B, T, k, d).reshape(B, T * k, d)
    xin = torch.einsum("bsec,bsd->ebcd", slot.to(dtype), hk)
    gate = torch.einsum("ebcd,edf->ebcf", xin, lp["w_gate"].to(dtype))
    up = torch.einsum("ebcd,edf->ebcf", xin, lp["w_up"].to(dtype))
    out = torch.einsum("ebcf,efd->ebcd", _silu(gate) * up,
                       lp["w_down"].to(dtype))
    combine = slot * top_p.reshape(B, T * k, 1, 1).float()
    y = torch.einsum("ebcd,bsec->bsd", out.float(), combine)
    y = y.reshape(B, T, k, d).sum(dim=2).to(dtype)
    kept = in_cap.sum(dim=-1) > 0
    return y, load_balance(probs, top_i, E), top_i, kept
