"""Operations, bytes and peaks: the yardstick the per-layer metrics divide by.

Model FLOPs count what the inputs need and nothing more: every projection
and the LM head as a matmul (2 FLOPs a multiply-add, 6 with the backward),
not the embedding lookup or the norms, and causal attention over the live
context only. A mixture-of-experts layer counts its top-k experts per token
and its router, not the capacity padding a program may compute.

The flash-attention counts are those of the port's chip checks
(``_pairs``, ``_bound``, ``_flash_bound``, ``_bwd_bounds``): each input
read once, each output written once, QK^T and PV over the pairs the causal
mask keeps.
"""

from __future__ import annotations

from typing import Dict, Tuple

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def _dims(cfg: dict):
    d = cfg["hidden_size"]
    H = cfg["num_attention_heads"]
    KV = cfg.get("num_key_value_heads") or H
    hd = cfg.get("head_dim") or d // H
    return d, H, KV, hd, cfg["intermediate_size"], cfg["vocab_size"]


def _attn_matmul_params(cfg: dict) -> int:
    d, H, KV, hd, _, _ = _dims(cfg)
    return d * H * hd * 2 + d * KV * hd * 2  # q and o, k and v


def matmul_params(cfg: dict) -> int:
    """Parameters a token multiplies by in one forward: the projections of
    every layer (top-k experts and the router where there are experts) and
    the LM head."""
    d, _, _, _, ff, v = _dims(cfg)
    E = cfg.get("num_local_experts") or 0
    ffn = 3 * d * ff * (cfg["num_experts_per_tok"] if E else 1)
    router = d * E
    per_layer = _attn_matmul_params(cfg) + ffn + router
    return cfg["num_hidden_layers"] * per_layer + d * v


def total_params(cfg: dict) -> int:
    """Every parameter held: embedding, layers (all experts), norms, head."""
    d, _, _, _, ff, v = _dims(cfg)
    E = cfg.get("num_local_experts") or 0
    ffn = 3 * d * ff * (E or 1) + d * E
    per_layer = _attn_matmul_params(cfg) + ffn + 2 * d
    head = 0 if cfg.get("tie_word_embeddings") else d * v
    return v * d + cfg["num_hidden_layers"] * per_layer + d + head


def train_flops_per_token(cfg: dict, seq_len: int) -> float:
    """Forward and backward: 6 x the matmul parameters, plus causal
    attention, 6 T d a layer (QK^T and PV over T/2 keys on average, x3)."""
    d = cfg["hidden_size"]
    return (6.0 * matmul_params(cfg)
            + 6.0 * seq_len * d * cfg["num_hidden_layers"])


# ---- flash attention (B1-B3) bounds -----------------------------------------

def _pairs(t: int, t_k: int, causal: bool) -> int:
    """(q, k) pairs the mask keeps: top-left causal keeps min(q + 1, T_k)."""
    if not causal:
        return t * t_k
    full = min(t, t_k)
    return full * (full + 1) // 2 + max(0, t - t_k) * t_k


def bound_s(flops: float, nbytes: float, dtype_name: str
            ) -> Tuple[float, str]:
    """The least time the chip could take, and what bounds it."""
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_mem = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_mem), ("operations" if t_ops >= t_mem else "bytes")


def flash_fwd_bound(bh: int, t: int, t_k: int, d: int, dtype_name: str,
                    causal: bool) -> Tuple[float, str]:
    """One B1 call on [bh, t, d] queries against [bh, t_k, d] keys."""
    flops = 4.0 * d * bh * _pairs(t, t_k, causal)
    elt = 2 if dtype_name == "bfloat16" else 4
    nbytes = elt * d * bh * (2 * t + 2 * t_k) + 4 * bh * t
    return bound_s(flops, nbytes, dtype_name)


def flash_bwd_bounds(bh: int, t: int, t_k: int, d: int, dtype_name: str,
                     causal: bool) -> Dict[str, Tuple[float, str]]:
    """B2 (dQ and Delta) and B3 (dK, dV) of one backward."""
    pairs = _pairs(t, t_k, causal)
    elt = 2 if dtype_name == "bfloat16" else 4
    dq_flops = 6.0 * d * bh * pairs + 2.0 * d * bh * t
    dq_bytes = elt * d * bh * (4 * t + 2 * t_k) + 8 * bh * t
    dkv_flops = 8.0 * d * bh * pairs
    dkv_bytes = elt * d * bh * (2 * t + 4 * t_k) + 8 * bh * t
    return {"flash_bwd_dq": bound_s(dq_flops, dq_bytes, dtype_name),
            "flash_bwd_dkv": bound_s(dkv_flops, dkv_bytes, dtype_name)}
