"""Helpers the per-layer readers share. Each reader is the file named as
its metric, ``read(ctx, res)`` -> the value, or None where the run has
nothing for it to read (the harness then leaves the metric out)."""

from __future__ import annotations

from benchmark import counts


def idle_share(res: dict):
    tr = res.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def tokens_per_substep(res: dict):
    st = res.get("stats")
    if not st or st["decode_steps"] <= 0:
        return None
    return st["tokens_out"] / st["decode_steps"]


def flash_shape(ctx):
    """(B*H, T, T_k, head_dim) of the flash calls of a train step: the
    kernels take K and V with their heads repeated to the query heads."""
    cfg = ctx.config
    H = cfg["num_attention_heads"]
    hd = cfg.get("head_dim") or cfg["hidden_size"] // H
    T = ctx.cell["max_seq_len"]
    return ctx.cell["batch_rows"] * H, T, T, hd


def peak(ctx) -> float:
    return counts.PEAK_FLOPS[ctx.config["torch_dtype"]] * ctx.chips
