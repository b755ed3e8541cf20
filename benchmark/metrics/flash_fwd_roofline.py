"""B1 (``csrc/flash_fwd.cu``): its bound time at the cell's shapes over its
mean device time in the trace, in %."""

from benchmark import counts, trace
from benchmark.metrics._common import flash_shape


def read(ctx, res):
    tr = res.get("trace")
    if not tr:
        return None
    n, s = trace.op_stats(tr, "flash_fwd")
    if n == 0 or s <= 0:
        return None
    bound, _ = counts.flash_fwd_bound(*flash_shape(ctx), "bfloat16", True)
    return 100.0 * bound / (s / n)
