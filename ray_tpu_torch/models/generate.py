"""Autoregressive generation with a KV cache: the port of
``ray_tpu/models/generate.py``.

The cache is allocated at ``max_len`` up front, one [L, B, S, KV, hd] tensor
each for k and v, and written in place (where JAX returned new buffers).
Keys and values are cached post-RoPE and pre-GQA-expansion; the repeat to
query heads happens inside the attention contraction. Attention here is
the dense masked contraction ``_gqa_attention``, as in the reference: the
flash kernel is for the full-sequence ``forward``.

The engine's meshed path (``models/engine.py``) runs ``_prefill_hidden``
and ``_final_logits`` with a mesh of its ``tensor`` (and ``expert``) axis:
each rank holds its heads, kv heads, d_ff columns and vocabulary rows; the
attention and FFN outputs are summed over the ranks (``reduce_from``) and
the logits gathered whole before sampling.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ray_tpu_torch.models.config import TransformerConfig
from ray_tpu_torch.models.transformer import (Params, attn_out, embed_tokens,
                                              ffn_block, layer, lm_head,
                                              qkv_proj, rms_norm)
from ray_tpu_torch.parallel.mesh import axis_groups, reduce_from

KVCache = Dict[str, object]  # {"k": [L,B,S,KV,hd], "v": ..., "pos": int}

# Large-finite instead of -inf for masked scores: a fully-masked query row
# (a pad position in a left-padded batch) then softmaxes to uniform junk
# instead of NaN, and junk at pad positions is never attended nor read.
_MASKED = torch.finfo(torch.float32).min / 2


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device, kv_heads=None) -> KVCache:
    """``kv_heads``: this rank's, on a tensor mesh (default all)."""
    shape = (cfg.n_layers, batch, max_len, kv_heads or cfg.kv_heads,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "pos": 0}


def _ffn(h, lp, cfg, mesh=None):
    down, _ = ffn_block(h, lp, cfg, mesh)
    return down


def _attn_sum(o, lp, cfg, mesh=None):
    """The output projection of this rank's heads, summed over ``tensor``."""
    return reduce_from(attn_out(o, lp, cfg), axis_groups(mesh, ("tensor",)))


def _gqa_attention(q, k, v, mask):
    """q [B,T,H,hd] vs keys/values [B,S,KV,hd] under a broadcastable mask
    [B,T,1,1,S]. GQA groups q into [KV, reps]: no materialized repeat of k/v."""
    B, T, H, hd = q.shape
    KV = k.shape[2]
    reps = H // KV
    qg = q.reshape(B, T, KV, reps, hd)
    scores = torch.einsum("btkrh,bskh->btkrs", qg.float(),
                          k.float()) * (hd ** -0.5)
    scores = torch.where(mask, scores, torch.full_like(scores, _MASKED))
    probs = torch.softmax(scores, dim=-1)
    o = torch.einsum("btkrs,bskh->btkrh", probs, v.float())
    return o.reshape(B, T, H, hd).to(q.dtype)


def _cached_attention(q, k_cache, v_cache, valid_len, start):
    """Decode attention against the full cache, masking key positions
    outside [start[b], valid_len). ``start`` [B] supports left-padded
    batches (RoPE is relative, so the absolute offset is harmless)."""
    S = k_cache.shape[1]
    kpos = torch.arange(S, device=q.device)[None, None, None, None, :]
    mask = (kpos < valid_len) & (kpos >= start[:, None, None, None, None])
    return _gqa_attention(q, k_cache, v_cache, mask)


def _final_logits(params, x, cfg, mesh=None):
    """Logits over the whole vocabulary: on a tensor mesh each rank's
    vocabulary rows, gathered over the ranks (every rank samples the
    same)."""
    logits = lm_head(params, x, cfg)
    for group in axis_groups(mesh, ("tensor",)):
        every = [torch.empty_like(logits)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(every, logits.contiguous(), group=group)
        logits = torch.cat(every, dim=-1)
    return logits


def _prefill_hidden(params: Params, tokens, cfg: TransformerConfig,
                    max_len: int, start, mesh=None):
    """Prompt pass -> (final hidden states [B,P,d], cache filled at [0, P)).
    Callers project only the positions they need to vocab space. ``mesh``:
    the engine's tensor/expert mesh (this rank's weights in ``params``)."""
    B, P = tokens.shape
    if max_len < P:
        raise ValueError(f"max_len={max_len} < prompt length {P}")
    if not cfg.causal:
        # autoregressive decoding over a bidirectional encoder would
        # silently contradict the forward() the params were trained with
        raise ValueError("generation requires a causal (decoder) config; "
                         "this config has causal=False")
    x = embed_tokens(params, tokens, cfg, mesh)
    dev = x.device
    start = start.to(dev)
    positions = torch.arange(P, device=dev)
    causal = positions[:, None] >= positions[None, :]
    valid = positions[None, :] >= start[:, None]  # [B, S]
    prompt_mask = causal[None, :, None, None, :] & \
        valid[:, None, None, None, :]
    cache = init_cache(cfg, B, max_len, dev,
                       params["layers"]["wk"].shape[2])
    for i in range(cfg.n_layers):
        lp = layer(params, i)
        h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        q, k, v = qkv_proj(h, lp, cfg, positions)
        o = _gqa_attention(q, k, v, prompt_mask)
        x = x + _attn_sum(o, lp, cfg, mesh)
        h = rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
        x = x + _ffn(h, lp, cfg, mesh)
        cache["k"][i, :, :P] = k
        cache["v"][i, :, :P] = v
    cache["pos"] = P
    return x, cache


def _zeros_start(tokens):
    return torch.zeros(tokens.shape[0], dtype=torch.int32,
                       device=tokens.device)


@torch.no_grad()
def prefill(params: Params, tokens, cfg: TransformerConfig, max_len: int,
            start=None) -> Tuple[torch.Tensor, KVCache]:
    """Process the whole prompt [B, P] in one pass; -> (logits [B,P,V],
    cache filled at positions [0, P)). ``start`` [B] marks the first REAL
    token per row of a left-padded batch."""
    if start is None:
        start = _zeros_start(tokens)
    x, cache = _prefill_hidden(params, tokens, cfg, max_len, start)
    return _final_logits(params, x, cfg), cache


@torch.no_grad()
def decode_step(params: Params, cache: KVCache, tokens,
                cfg: TransformerConfig,
                start=None) -> Tuple[torch.Tensor, KVCache]:
    """One token per sequence: tokens [B] at position cache['pos'];
    -> (logits [B, V], cache advanced by one). The k/v tensors are written
    in place and shared with the returned cache."""
    pos = int(cache["pos"])
    k_all, v_all = cache["k"], cache["v"]
    if pos >= k_all.shape[2]:
        raise ValueError(f"cache is full: pos={pos}, max_len={k_all.shape[2]}")
    if start is None:
        start = _zeros_start(tokens)
    x = embed_tokens(params, tokens[:, None], cfg)  # [B, 1, d]
    start = start.to(x.device)
    positions = torch.full((1,), pos, device=x.device)
    for i in range(cfg.n_layers):
        lp = layer(params, i)
        h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        q, k, v = qkv_proj(h, lp, cfg, positions)
        k_all[i, :, pos] = k[:, 0].to(k_all.dtype)
        v_all[i, :, pos] = v[:, 0].to(v_all.dtype)
        o = _cached_attention(q, k_all[i], v_all[i], pos + 1, start)
        x = x + attn_out(o, lp, cfg)
        h = rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
        x = x + _ffn(h, lp, cfg)
    return _final_logits(params, x, cfg)[:, 0], {"k": k_all, "v": v_all,
                                                 "pos": pos + 1}


def sample(logits, greedy: bool, temperature: float,
           rng: Optional[torch.Generator]):
    """Greedy argmax, or a draw from softmax(logits / temperature)."""
    if greedy:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.float() / max(temperature, 1e-6), dim=-1)
    return torch.multinomial(probs, 1, generator=rng)[:, 0]


@torch.no_grad()
def generate(params: Params, prompt, cfg: TransformerConfig, *,
             max_new_tokens: int, max_len: Optional[int] = None,
             temperature: float = 1.0, greedy: bool = True,
             eos_id: int = -1, rng: Optional[torch.Generator] = None,
             start=None):
    """prompt [B, P] -> [B, P + max_new_tokens] on the params' device:
    prefill, then decode steps (greedy or temperature sampling from ``rng``,
    a generator on that device). Sequences that hit ``eos_id`` keep
    emitting eos. ``start`` [B]: first real-token position per row
    (left-padded batches of unequal prompt lengths)."""
    dev = params["embed"].device
    prompt = torch.as_tensor(prompt, device=dev)
    B, P = prompt.shape
    S = max_len or (P + max_new_tokens)
    if S < P + max_new_tokens:
        # an undersized cache cannot hold every position: refuse rather
        # than write past its end
        raise ValueError(
            f"max_len={S} < prompt_len({P}) + max_new_tokens"
            f"({max_new_tokens}); the KV cache must hold every position")
    if start is None:
        start = _zeros_start(prompt)
    if max_new_tokens == 0:
        if not cfg.causal:  # same contract as the nonzero path
            raise ValueError("generation requires a causal (decoder) "
                             "config; this config has causal=False")
        return prompt
    x, cache = _prefill_hidden(params, prompt, cfg, S, start)
    # only the last position's logits seed decoding
    last = _final_logits(params, x[:, -1:], cfg)[:, 0]
    tok = sample(last, greedy, temperature, rng).to(prompt.dtype)
    done = tok == eos_id
    toks = [tok]
    # the final sampled token never pays for a decode step nobody reads
    for _ in range(max_new_tokens - 1):
        logits, cache = decode_step(params, cache, tok, cfg, start)
        tok = sample(logits, greedy, temperature, rng).to(prompt.dtype)
        tok = torch.where(done, torch.full_like(tok, eos_id), tok)
        done = done | (tok == eos_id)
        toks.append(tok)
    return torch.cat([prompt, torch.stack(toks, dim=1)], dim=1)
