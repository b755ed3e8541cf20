"""Ring attention: context parallelism over the ``sequence`` mesh axis.

Port of ``ray_tpu/parallel/ring.py``. The sequence dimension is split over
the P ranks of the ``sequence`` axis; each rank keeps its query chunk while
the K/V chunks go round the ring by ``batch_isend_irecv`` (the reference's
``ppermute``). Where the reference folds every block into an online-softmax
state in plain jnp, each visited block here is one flash-attention call
(B1 on CUDA, its plain version on the CPU) that yields the block's output
and its log-sum-exp, and the partial results are merged by their LSE:

    lse = logaddexp(lse_a, lse_b),
    O   = e^(lse_a - lse) O_a + e^(lse_b - lse) O_b     (fp32).

With causal attention and T_q = T_k = T/P, rank r's own block (the
diagonal) is causal, the blocks of lower ranks are whole and those of higher
ranks are skipped (every pair is masked there in the reference). The
backward (``_RingAttention``) runs B2 (dQ, and Δ from the merged O) and B3
(dK, dV) on each visited block against the merged O and LSE, so that
P = exp(S - LSE) is the block's share of the global softmax; dQ accumulates
in fp32 on its rank, and the fp32 dK/dV accumulators travel with their K/V
block and are home after one full turn.

``ring_forward_virtual``/``ring_backward_virtual`` run the same block steps
for P ranks in one process, in the order the ring runs them (the checks on
the card hold them against B1-B3 over the whole sequence).
"""

from __future__ import annotations

import importlib
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ray_tpu_torch.parallel.mesh import BATCH_AXES, axis_size

# the module, not the package's re-exported function of the same name
_fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
_NEG_INF = -1e30


def reference_attention(q, k, v, *, causal: bool = True,
                        scale: Optional[float] = None):
    """Unsharded flash-free attention: [B, T, H, D] -> [B, T, H, D]."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        t_q, t_k = q.shape[1], k.shape[1]
        keep = (torch.arange(t_q, device=q.device)[:, None]
                >= torch.arange(t_k, device=q.device)[None, :])
        s = torch.where(keep, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


# ---- one block, one merge ---------------------------------------------------

def block_kind(src: int, rank: int, causal: bool) -> Optional[bool]:
    """How rank ``rank``'s queries meet the K/V chunk of rank ``src``: the
    causal flag of its flash call, or None when it is skipped (all masked)."""
    if not causal:
        return False
    if src == rank:
        return True
    if src < rank:
        return False
    return None


def block_fwd(q3, k3, v3, *, scale: float, causal: bool):
    """One block through B1: [B*H, T/P, D] -> (O in q3's dtype, LSE
    [B*H, 1, T/P] fp32)."""
    return _fa.flash_attention_fwd(q3, k3, v3, scale=scale, causal=causal)


def merge(o_a, lse_a, o_b, lse_b):
    """Two partial results over disjoint key sets -> their union's, in
    fp32: lse = logaddexp(lse_a, lse_b), O = e^(lse_a - lse) O_a +
    e^(lse_b - lse) O_b. O: [B*H, T, D]; LSE: [B*H, 1, T]."""
    lse = torch.logaddexp(lse_a, lse_b)
    w_a = torch.exp(lse_a - lse).transpose(1, 2)
    w_b = torch.exp(lse_b - lse).transpose(1, 2)
    return w_a * o_a.float() + w_b * o_b.float(), lse


def block_bwd(q3, k3, v3, o3, lse, do3, *, scale: float, causal: bool):
    """One block's gradients through B2 then B3, against the merged O and
    LSE: -> (dQ, dK, dV) partials in the inputs' dtypes."""
    dq, delta = _fa.flash_bwd_dq(q3, k3, v3, o3, lse, do3, scale=scale,
                                causal=causal)
    dk, dv = _fa.flash_bwd_dkv(q3, k3, v3, lse, delta, do3, scale=scale,
                              causal=causal)
    return dq, dk, dv


def _fwd_step(acc, q3, k3, v3, src: int, rank: int, *, scale: float,
              causal: bool):
    """Folds K/V chunk ``src`` into rank ``rank``'s (O fp32, LSE) ``acc``
    (None before the first block)."""
    kind = block_kind(src, rank, causal)
    if kind is None:
        return acc
    o_b, lse_b = block_fwd(q3, k3, v3, scale=scale, causal=kind)
    if acc is None:
        return o_b.float(), lse_b
    return merge(acc[0], acc[1], o_b, lse_b)


def _bwd_step(dq, dk, dv, q3, k3, v3, o3, lse, do3, src: int, rank: int, *,
              scale: float, causal: bool) -> None:
    """Adds chunk ``src``'s block gradients for rank ``rank``'s queries into
    the fp32 accumulators dq (rank's) and dk, dv (chunk src's)."""
    kind = block_kind(src, rank, causal)
    if kind is None:
        return
    dq_b, dk_b, dv_b = block_bwd(q3, k3, v3, o3, lse, do3, scale=scale,
                                 causal=kind)
    dq.add_(dq_b)
    dk.add_(dk_b)
    dv.add_(dv_b)


# ---- P ranks in one process ------------------------------------------------

def ring_forward_virtual(q3s: Sequence[torch.Tensor],
                         k3s: Sequence[torch.Tensor],
                         v3s: Sequence[torch.Tensor], *, scale: float,
                         causal: bool):
    """The ring's forward for P = len(q3s) ranks in one process, step by
    step as the ring visits blocks: chunk lists [B*H, T/P, D] -> (O list in
    q's dtype, LSE list [B*H, 1, T/P] fp32)."""
    n = len(q3s)
    acc: List = [None] * n
    for s in range(n):
        for r in range(n):
            src = (r - s) % n
            acc[r] = _fwd_step(acc[r], q3s[r], k3s[src], v3s[src], src, r,
                               scale=scale, causal=causal)
    return ([a[0].to(q3s[0].dtype) for a in acc], [a[1] for a in acc])


def ring_backward_virtual(q3s, k3s, v3s, o3s, lses, do3s, *, scale: float,
                          causal: bool):
    """The ring's backward for P ranks in one process, each accumulator
    taking its terms in the ring's order -> (dQ, dK, dV) chunk lists."""
    n = len(q3s)
    dq = [torch.zeros_like(x, dtype=torch.float32) for x in q3s]
    dk = [torch.zeros_like(x, dtype=torch.float32) for x in k3s]
    dv = [torch.zeros_like(x, dtype=torch.float32) for x in v3s]
    for s in range(n):
        for r in range(n):
            src = (r - s) % n
            _bwd_step(dq[r], dk[src], dv[src], q3s[r], k3s[src], v3s[src],
                      o3s[r], lses[r], do3s[r], src, r, scale=scale,
                      causal=causal)
    return ([x.to(q3s[0].dtype) for x in dq],
            [x.to(k3s[0].dtype) for x in dk],
            [x.to(v3s[0].dtype) for x in dv])


# ---- the ring over a process group -----------------------------------------

def _rotate(tensors, group):
    """Starts sending each tensor to the next rank of ``group`` and
    receiving the previous rank's into fresh buffers -> (requests,
    buffers)."""
    r, n = dist.get_rank(group), dist.get_world_size(group)
    nxt = dist.get_global_rank(group, (r + 1) % n)
    prv = dist.get_global_rank(group, (r - 1) % n)
    bufs = [torch.empty_like(t) for t in tensors]
    ops = ([dist.P2POp(dist.isend, t, nxt, group) for t in tensors]
           + [dist.P2POp(dist.irecv, b, prv, group) for b in bufs])
    return dist.batch_isend_irecv(ops), bufs


def _arrive(pending):
    reqs, bufs = pending
    for req in reqs:
        req.wait()
    return bufs


def _ring_fwd(q3, k3, v3, group, scale: float, causal: bool):
    """This rank's (O in q's dtype, merged LSE fp32); K/V move one rank on
    per step, the next chunk in flight while the current one is computed."""
    if group is None:
        o, lse = _fwd_step(None, q3, k3, v3, 0, 0, scale=scale,
                           causal=causal)
        return o.to(q3.dtype), lse
    r, n = dist.get_rank(group), dist.get_world_size(group)
    acc, kv = None, [k3, v3]
    for s in range(n):
        pending = _rotate(kv, group) if s < n - 1 else None
        acc = _fwd_step(acc, q3, kv[0], kv[1], (r - s) % n, r, scale=scale,
                        causal=causal)
        if pending is not None:
            kv = _arrive(pending)
    return acc[0].to(q3.dtype), acc[1]


def _ring_bwd(q3, k3, v3, o3, lse, do3, group, scale: float, causal: bool):
    """This rank's dQ and, after the accumulators' full turn, the dK, dV
    of its own K/V chunk."""
    dq = torch.zeros_like(q3, dtype=torch.float32)
    dk = torch.zeros_like(k3, dtype=torch.float32)
    dv = torch.zeros_like(v3, dtype=torch.float32)
    if group is None:
        _bwd_step(dq, dk, dv, q3, k3, v3, o3, lse, do3, 0, 0, scale=scale,
                  causal=causal)
    else:
        r, n = dist.get_rank(group), dist.get_world_size(group)
        kv = [k3, v3]
        for s in range(n):
            pending = _rotate(kv, group) if s < n - 1 else None
            _bwd_step(dq, dk, dv, q3, kv[0], kv[1], o3, lse, do3,
                      (r - s) % n, r, scale=scale, causal=causal)
            dk, dv = _arrive(_rotate([dk, dv], group))
            if pending is not None:
                kv = _arrive(pending)
    return dq.to(q3.dtype), dk.to(k3.dtype), dv.to(v3.dtype)


class _RingAttention(torch.autograd.Function):
    """The ring's forward (B1 per block, LSE merge) and backward (B2/B3 per
    block against the merged O and LSE) on local [B*H, T/P, D] chunks."""

    @staticmethod
    def forward(ctx, q3, k3, v3, group, scale, causal):
        o, lse = _ring_fwd(q3, k3, v3, group, scale, causal)
        ctx.save_for_backward(q3, k3, v3, o, lse)
        ctx.group, ctx.scale, ctx.causal = group, scale, causal
        return o

    @staticmethod
    def backward(ctx, do3):
        q3, k3, v3, o, lse = ctx.saved_tensors
        dq, dk, dv = _ring_bwd(q3, k3, v3, o, lse, do3.contiguous(),
                               ctx.group, ctx.scale, ctx.causal)
        return dq, dk, dv, None, None, None


def ring_attention(q, k, v, mesh, *, axis_name: str = "sequence",
                   causal: bool = True, scale: Optional[float] = None,
                   batch_axes=None):
    """Self-attention with the sequence dim sharded over ``axis_name``.

    q, k, v: this rank's shards [B_local, T/P, H, D] (batch rows over
    ``batch_axes``, sequence chunk r of P over ``axis_name``, chunks in
    rank order) -> this rank's output shard, same shape. Degenerates to one
    flash call with no communication when the axis has size 1, so callers
    can use it unconditionally. ``batch_axes`` defaults to every data-like
    axis present in the mesh (slice/data/fsdp); the local shards already
    carry that split, so it only names it. Heads split over ``tensor``
    arrive as this rank's heads (H/t): the ring runs on them, its P2P on
    the ``sequence`` group only."""
    names = mesh.mesh_dim_names or ()
    if batch_axes is None:
        batch_axes = tuple(a for a in BATCH_AXES if a in names)
    missing = [a for a in (*batch_axes, axis_name) if a not in names]
    if missing:
        raise ValueError(f"mesh has no axes {missing} (axes: {names})")
    b, t, h, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    group = (mesh.get_group(axis_name) if axis_size(mesh, axis_name) > 1
             else None)

    def to3(x):
        return x.transpose(1, 2).reshape(b * x.shape[2], x.shape[1],
                                         d).contiguous()

    o3 = _RingAttention.apply(to3(q), to3(k), to3(v), group, scale, causal)
    return o3.reshape(b, h, t, d).transpose(1, 2)
