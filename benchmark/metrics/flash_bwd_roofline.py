"""B2 and B3 (``csrc/flash_bwd.cu``, ``csrc/flash_bwd_dkv.cu``): the sum of
their bound times at the cell's shapes over the sum of their mean device
times in the trace, in %."""

from benchmark import counts, trace
from benchmark.metrics._common import flash_shape


def read(ctx, res):
    tr = res.get("trace")
    if not tr:
        return None
    n_dq, s_dq = trace.op_stats(tr, "flash_bwd_dq")
    n_kv, s_kv = trace.op_stats(tr, "flash_bwd_dkv")
    if not n_dq or not n_kv or s_dq <= 0 or s_kv <= 0:
        return None
    b = counts.flash_bwd_bounds(*flash_shape(ctx), "bfloat16", True)
    bound = b["flash_bwd_dq"][0] + b["flash_bwd_dkv"][0]
    return 100.0 * bound / (s_dq / n_dq + s_kv / n_kv)
