"""Driver ``serve_open``: independent users, an open loop.

Requests are due on a Poisson schedule at the cell's fixed rate
(``rate_per_s``, four fifths of the knee found once on the card), from
``warm_seconds`` before the window to its end, and each is sent when it
is due whether or not earlier ones have finished. The requests due before
the window warm the replica and are set-up; those due inside it are
measured: time to first token from when each was due, and time per output
token, (last token - first) / (tokens - 1), each request's own. A request
that has not finished ``grace_seconds`` after the window has failed.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor

from benchmark import traffic
from benchmark.drivers import serve as S
from benchmark.harness import Context, percentile


def drive(ctx: Context, handle, due, lengths, prompts, warm: float,
          trace: bool = False):
    """Send each request when it is due (``due`` in seconds from the
    window's start, ``warm`` seconds from now) -> (records, window start,
    the engine's stats at the window's edges and the trace's response)."""
    c = ctx.cell
    gen = handle.options(method_name="generate_timed")
    stats = handle.options(method_name="engine_stats")
    recs = [None] * len(due)
    t0 = time.monotonic() + warm + 0.5
    deadline = t0 + ctx.seconds + c["grace_seconds"]
    marks = {}

    def at(t, key, fn):
        time.sleep(max(0.0, t - time.monotonic()))
        marks[key] = fn()

    watchers = [threading.Thread(target=at, args=(
        t0, "s0", lambda: stats.remote().result(timeout_s=60))),
        threading.Thread(target=at, args=(
            t0 + ctx.seconds, "s1",
            lambda: stats.remote().result(timeout_s=60)))]
    if trace:
        watchers.append(threading.Thread(target=at, args=(
            t0, "prof", lambda: handle.options(
                method_name="profile").remote(c["trace_seconds"]))))
    for w in watchers:
        w.start()

    def one(i):
        recs[i] = S.call(gen, prompts[i], lengths[i][1], deadline)

    with ThreadPoolExecutor(max_workers=c["client_threads"]) as pool:
        futures = []
        for i, d in enumerate(due):
            time.sleep(max(0.0, t0 + d - time.monotonic()))
            futures.append(pool.submit(one, i))
        for f in futures:
            f.result()
    for w in watchers:
        w.join()
    for i, d in enumerate(due):
        recs[i]["due"] = t0 + d
    return recs, t0, marks


def latencies(recs):
    """-> (ttft ms, tpot ms, failed) over ``recs``."""
    ttft, tpot, failed = [], [], 0
    for r in recs:
        if not r["ok"]:
            failed += 1
            continue
        ttft.append((r["times"][0] - r["due"]) * 1e3)
        tpot.append((r["times"][-1] - r["times"][0]) / (len(r["times"]) - 1)
                    * 1e3)
    return ttft, tpot, failed


def run(ctx: Context) -> dict:
    c = ctx.cell
    mix = ctx.mix()
    due = traffic.arrivals(c["rate_per_s"], ctx.seed, -c["warm_seconds"],
                           ctx.seconds, mix["arrivals"])
    lengths = traffic.request_lengths(mix, ctx.seed, len(due))
    prompts = traffic.prompts(mix, ctx.config["vocab_size"], ctx.seed,
                              lengths)
    handle = S.deploy(ctx, "bench")
    try:
        recs, t0, marks = drive(ctx, handle, due, lengths, prompts,
                                c["warm_seconds"], ctx.trace)
        tail = S.finish(ctx, handle, marks.get("prof"))
    finally:
        S.shutdown()
    replica = tail.pop("replica")
    inside = [i for i, d in enumerate(due) if 0 <= d < ctx.seconds]
    measured = [recs[i] for i in inside]
    ttft, tpot, failed = latencies(measured)
    late = [r["t_send"] - r["due"] for r in measured]
    errors = [r["error"] for r in measured if not r["ok"]]
    setup_s = t0 - ctx.t_start
    return {
        "kind": "serve", "requests": measured, "window_s": ctx.seconds,
        "attempted": len(measured), "failed": failed, "setup_s": setup_s,
        "end_to_end": {"ttft_p95_ms": percentile(ttft, 95),
                       "tpot_p95_ms": percentile(tpot, 95)},
        "stats": S.stats_delta(marks["s0"], marks["s1"]),
        "extra": {"replica": replica,
                  "ttft_p50_ms": percentile(ttft, 50),
                  "tpot_p50_ms": percentile(tpot, 50),
                  "generator_late_max_s": max(late) if late else None,
                  "errors": errors[:3],
                  "traffic": traffic.summary([lengths[i] for i in inside])},
        **tail}


def check(ctx: Context, res: dict) -> dict:
    """The served tokens of a sample of the window's finished requests,
    against the plain reference (``serve.check``)."""
    return S.check(ctx, [r for r in res["requests"] if r["ok"]])
