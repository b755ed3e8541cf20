"""Share of the traced window in which no device operation ran, in %."""

from benchmark.metrics._common import idle_share


def read(ctx, res):
    return idle_share(res)
