"""Core runtime microbenchmarks.

Ref analog: python/ray/_private/ray_perf.py:93 — the metric names of the
reference's release/release_logs/2.6.1/microbenchmark.json and of the JAX
package's ``ray_tpu.utils.microbenchmark``, unchanged. These are the
runtime's host rates: no GPU is leased. Emits one JSON object, the last
line of stdout.

Run:  python -m ray_tpu_torch.utils.microbenchmark [--quick]
"""

from __future__ import annotations

import json
import sys
import time
from typing import Callable, Dict, List

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.core.context import get_context


def timeit(name: str, fn: Callable[[], int], duration: float = 2.0,
           results: Dict[str, float] = None) -> float:
    """Run fn repeatedly for ~duration seconds; fn returns ops performed."""
    # warmup round
    fn()
    count = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < duration:
        count += fn()
    dt = time.perf_counter() - t0
    rate = count / dt
    if results is not None:
        results[name] = round(rate, 2)
    print(f"  {name}: {rate:,.1f} /s", file=sys.stderr)
    return rate


@ray_tpu_torch.remote
def _noop():
    return None


@ray_tpu_torch.remote
def _noop_arg(x):
    return None


@ray_tpu_torch.remote
class _Actor:
    def noop(self):
        return None


@ray_tpu_torch.remote(max_concurrency=8)
class _AsyncActor:
    def noop(self):
        return None


def main(quick: bool = False):
    dur = 0.5 if quick else 2.0
    ray_tpu_torch.init(num_cpus=4, num_gpus=0, ignore_reinit_error=True)
    results: Dict[str, float] = {}

    # -- tasks ---------------------------------------------------------

    ray_tpu_torch.get(_noop.remote(), timeout=60)  # spin up a worker

    def tasks_sync():
        ray_tpu_torch.get(_noop.remote(), timeout=60)
        return 1

    timeit("single_client_tasks_sync", tasks_sync, dur, results)

    def tasks_async():
        n = 1000  # match the reference harness (ray_perf.py:177)
        ray_tpu_torch.get([_noop.remote() for _ in range(n)], timeout=120)
        return n

    timeit("single_client_tasks_async", tasks_async, dur, results)

    def tasks_async_arg():
        n = 100
        ref = ray_tpu_torch.put(np.zeros(1024, np.uint8))
        ray_tpu_torch.get([_noop_arg.remote(ref) for _ in range(n)],
                          timeout=120)
        return n

    timeit("single_client_tasks_with_arg_async", tasks_async_arg, dur,
           results)

    # -- actors --------------------------------------------------------

    actor = _Actor.remote()
    ray_tpu_torch.get(actor.noop.remote(), timeout=60)

    def actor_sync():
        ray_tpu_torch.get(actor.noop.remote(), timeout=60)
        return 1

    timeit("1_1_actor_calls_sync", actor_sync, dur, results)

    def actor_async():
        n = 1000  # match ray_perf.py:201
        ray_tpu_torch.get([actor.noop.remote() for _ in range(n)],
                          timeout=120)
        return n

    timeit("1_1_actor_calls_async", actor_async, dur, results)

    conc = _AsyncActor.remote()
    ray_tpu_torch.get(conc.noop.remote(), timeout=60)

    def actor_concurrent():
        n = 1000
        ray_tpu_torch.get([conc.noop.remote() for _ in range(n)],
                          timeout=120)
        return n

    timeit("1_1_actor_calls_concurrent", actor_concurrent, dur, results)

    n_actors = 4
    actors = [_Actor.remote() for _ in range(n_actors)]
    ray_tpu_torch.get([a.noop.remote() for a in actors], timeout=60)

    def n_n_async():
        per = 125
        refs = []
        for a in actors:
            refs.extend(a.noop.remote() for _ in range(per))
        ray_tpu_torch.get(refs, timeout=120)
        return per * n_actors

    timeit("n_n_actor_calls_async", n_n_async, dur, results)

    # -- objects -------------------------------------------------------

    small = np.zeros(1024, np.uint8)

    def put_small():
        n = 100
        for _ in range(n):
            ray_tpu_torch.put(small)
        return n

    timeit("single_client_put_calls", put_small, dur, results)

    ref_small = ray_tpu_torch.put(small)

    def get_small():
        n = 100
        for _ in range(n):
            ray_tpu_torch.get(ref_small, timeout=60)
        return n

    timeit("single_client_get_calls", get_small, dur, results)

    def get_small_uncached():
        """Uncached shm-path gets: fresh refs each round, memory-store entry
        evicted so every get walks the plasma path (frame read + pickle
        load), comparable to the reference's plasma single_client_get_calls
        (6,085/s) rather than the in-process cached-ref fast path above."""
        n = 100
        ctx = get_context()
        refs = [ray_tpu_torch.put(small) for _ in range(n)]
        for r in refs:
            e = ctx.memory_store.peek(r.id)
            if e is not None:
                e.value = None  # drop the deserialized cache, keep location
        for r in refs:
            ray_tpu_torch.get(r, timeout=60)
        return n

    timeit("single_client_get_calls_uncached", get_small_uncached, dur,
           results)

    big = np.zeros(100 * 1024 * 1024, np.uint8)  # 100 MiB

    def put_gb():
        ray_tpu_torch.put(big)
        return 1

    rate = timeit("single_client_put_100mb_calls", put_gb, dur, results)
    results["single_client_put_gigabytes"] = round(rate / 10.24, 3)
    print(f"  single_client_put_gigabytes: "
          f"{results['single_client_put_gigabytes']} GiB/s",
          file=sys.stderr)

    # -- placement groups ---------------------------------------------

    def pg_cycle():
        n = 10
        for _ in range(n):
            pg = ray_tpu_torch.placement_group([{"CPU": 1}])
            pg.ready(timeout=30)
            ray_tpu_torch.remove_placement_group(pg)
        return n

    timeit("placement_group_create/removal", pg_cycle, dur, results)

    print(json.dumps(results))
    return results


if __name__ == "__main__":
    try:
        main(quick="--quick" in sys.argv)
    finally:
        ray_tpu_torch.shutdown()
