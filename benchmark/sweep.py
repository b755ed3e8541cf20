"""Find an open-loop serving cell's knee once, on the card: one replica,
one process, a series of fixed Poisson rates.

    python3 -m benchmark.sweep --workload <name> --seed <n> --seconds <s> --rates 4,6,8

For each rate: ``warm_seconds`` of arrivals, then ``--seconds`` measured,
then the wait for every request. A line of JSON per rate gives the tails
of the requests due in the window and the backlog: the requests due, the
warm-up's included, that have no first token yet, read each second of
the window, with its least-squares slope in requests a second. The knee is
the highest rate whose backlog does not grow over the window; the cell's
``rate_per_s`` is four fifths of it, written into the cell's file by hand
with the sweep's lines in PERF.md. Not part of the benchmark's runs.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from benchmark import harness, traffic  # noqa: E402
from benchmark.drivers import serve as S  # noqa: E402
from benchmark.drivers import serve_open as O  # noqa: E402


def backlog(recs, t: float) -> int:
    """Requests due by ``t`` without a first token at ``t``."""
    return sum(1 for r in recs if r["due"] <= t
               and (not r["ok"] or r["times"][0] > t))


def slope(ys) -> float:
    """Least-squares slope of ``ys`` read once a second."""
    n = len(ys)
    xm, ym = (n - 1) / 2, sum(ys) / n
    return (sum((x - xm) * (y - ym) for x, y in enumerate(ys))
            / sum((x - xm) ** 2 for x in range(n)))


def main(argv=None, *, device: str = "cuda", overrides=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", required=True)
    a = p.parse_args(argv)
    harness.set_cache_dirs()
    ctx = harness.load_context(a.workload, a.seed, a.seconds, False,
                               T_START, overrides, device=device)
    mix = ctx.mix()
    warm = ctx.cell["warm_seconds"]
    handle = S.deploy(ctx, "sweep")
    print(json.dumps({"ready_s": time.monotonic() - T_START}), flush=True)
    try:
        for k, rate in enumerate(float(r) for r in a.rates.split(",")):
            due = traffic.arrivals(rate, a.seed + k, -warm, a.seconds,
                                   mix["arrivals"])
            lengths = traffic.request_lengths(mix, a.seed + k, len(due))
            prompts = traffic.prompts(mix, ctx.config["vocab_size"],
                                      a.seed + k, lengths)
            recs, t0, marks = O.drive(ctx, handle, due, lengths, prompts,
                                      warm)
            inside = [r for r in recs if t0 <= r["due"] < t0 + a.seconds]
            ttft, tpot, failed = O.latencies(inside)
            st = S.stats_delta(marks["s0"], marks["s1"])
            seen = [backlog(recs, t0 + j)
                    for j in range(int(a.seconds) + 1)]
            print(json.dumps({
                "rate_per_s": rate, "requests": len(inside),
                "failed": failed,
                "ttft_p50_ms": harness.percentile(ttft, 50),
                "ttft_p95_ms": harness.percentile(ttft, 95),
                "tpot_p50_ms": harness.percentile(tpot, 50),
                "tpot_p95_ms": harness.percentile(tpot, 95),
                "backlog_start": seen[0],
                "backlog_third": seen[len(seen) // 3],
                "backlog_end": seen[-1], "backlog_max": max(seen),
                "backlog_slope_per_s": slope(seen),
                "tokens_per_substep": (st["tokens_out"] / st["decode_steps"]
                                       if st["decode_steps"] else None),
                "prefills": st["prefills"]}), flush=True)
    finally:
        S.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
