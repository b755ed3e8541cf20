"""Runs one function on every rank of a fresh ``torch.distributed`` world.

``run_world(fn, n, args, device)`` starts n processes, gives them a process
group (gloo on the CPU, NCCL on the card, one card a rank) through a
``file://`` rendezvous in a temporary directory (no port to pick, so worlds
can run side by side), calls ``fn(rank, *args)`` in each and returns the
ranks' results in rank order. On the CPU each rank runs one intra-op
thread at the lowest scheduling priority (nice 19). A world that does not
finish by its deadline is killed and raises, as does a world in which any
rank raised or died; no rank outlives the call (the fork server they come
from lives as long as the calling process).
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist

# how long a collective may wait for a peer before it fails
COLLECTIVE_TIMEOUT_S = 60.0
# Ranks are forked from one server process that has imported these once
# (multiprocessing's "forkserver", started clean, with no threads), so a
# world of n does not pay n imports of torch: about 5 s of CPU a rank.
_PRELOAD = ["torch", "torch.distributed", "ray_tpu_torch.models",
            "ray_tpu_torch.parallel"]


def _rank_main(rank: int, n: int, init_file: str, device_type: str,
               fn: Callable, args: Sequence, results) -> None:
    try:
        if device_type == "cpu":
            # a CPU world is a test or a rehearsal: its ranks take one
            # thread each and yield the cores to whatever else runs there
            torch.set_num_threads(1)
            os.nice(19)
            backend = "gloo"
        else:
            torch.cuda.set_device(rank)
            backend = "nccl"
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank,
            world_size=n,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        try:
            results.put((rank, True, fn(rank, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(5)


def run_world(fn: Callable, n: int, args: Sequence = (), *,
              device: str = "cuda", timeout: float = 300.0) -> List[Any]:
    """``[fn(0, *args), ..., fn(n - 1, *args)]``, each call in rank r of a
    new world of n processes. ``fn`` must be importable by name (a module's
    top-level function), its arguments and results picklable. Raises
    TimeoutError past ``timeout`` seconds and RuntimeError when a rank
    fails; the world's processes are gone either way."""
    device_type = torch.device(device).type
    if device_type == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"a world of {n} ranks on CUDA needs {n} cards, "
                           f"{torch.cuda.device_count()} present")
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(_PRELOAD)
    results = ctx.Queue()
    deadline = time.monotonic() + timeout
    with tempfile.TemporaryDirectory(prefix="ray_tpu_torch_world_") as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, n, init_file, device_type, fn, args,
                                   results))
                 for r in range(n)]
        try:
            for p in procs:
                p.start()
            out = {}
            while len(out) < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"world of {n} ranks past its {timeout:.0f} s "
                        f"deadline; ranks {sorted(set(range(n)) - set(out))}"
                        f" had not finished")
                try:
                    rank, ok, value = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"ranks {dead} of a world of {n} "
                                           f"died without a result")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of a world of {n} "
                                       f"failed:\n{value}")
                out[rank] = value
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
            return [out[r] for r in range(n)]
        finally:
            _stop(procs)
            results.close()
