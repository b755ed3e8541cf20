"""Tokens the engine delivered per decode substep over the window: the
change of ``tokens_out`` over the change of ``decode_steps`` in the
replica's ``engine_stats()``, read at the window's two edges."""

from benchmark.metrics._common import tokens_per_substep


def read(ctx, res):
    return tokens_per_substep(res)
