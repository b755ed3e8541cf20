"""Attention references of the parallel layer.

Port of ``reference_attention`` in ``ray_tpu/parallel/ring.py``: the plain
attention ``forward`` uses on the CPU (``attention_impl="xla"``). Ring
attention itself waits for the parallel-layer slice.
"""

from __future__ import annotations

from typing import Optional

import torch

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


def ring_attention(*args, **kwargs):
    raise NotImplementedError(
        "ring attention is not ported yet (ROADMAP.md, the parallel layer)")
