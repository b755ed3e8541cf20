"""Model FLOPs of the window's steps (6 x the matmul parameters and causal
attention, per token; ``counts.train_flops_per_token``) over the window
and the cell's chips' bf16 peak, in %."""

from benchmark import counts
from benchmark.metrics._common import peak


def read(ctx, res):
    if res.get("kind") != "train" or not res["steps"]:
        return None
    tokens = sum(s["tokens"] for s in res["steps"]) * ctx.chips
    per = counts.train_flops_per_token(ctx.config, ctx.cell["max_seq_len"])
    return 100.0 * tokens * per / res["window_s"] / peak(ctx)
