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

``World(fn, n, args, device)`` makes the calling process rank 0 of a new
world of n and starts ranks 1..n-1 as long-lived processes that run
``fn(rank, *args)`` until it returns (a tensor-parallel Serve replica's
followers). ``shutdown()`` leaves the group, waits for them and kills what
is left. They also die with the calling process, however it ends: each
asks the kernel for SIGKILL when its parent, the fork server, exits, and
the fork server exits when the calling process does.
"""

from __future__ import annotations

import ctypes
import datetime
import multiprocessing as mp
import os
import queue
import signal
import sys
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


def _join(rank: int, n: int, init_file: str, device_type: str) -> None:
    """Join the world as ``rank``: gloo on the CPU, NCCL on card ``rank``."""
    if device_type == "cpu":
        backend = "gloo"
    else:
        torch.cuda.set_device(rank)
        backend = "nccl"
    dist.init_process_group(
        backend, init_method=f"file://{init_file}", rank=rank, world_size=n,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))


def _yield_cpu() -> None:
    # a CPU world is a test or a rehearsal: its ranks take one thread each
    # and yield the cores to whatever else runs there
    torch.set_num_threads(1)
    os.nice(19)


def _rank_main(rank: int, n: int, init_file: str, device_type: str,
               fn: Callable, args: Sequence, results) -> None:
    try:
        if device_type == "cpu":
            _yield_cpu()
        _join(rank, n, init_file, device_type)
        try:
            results.put((rank, True, fn(rank, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def _follower_main(rank: int, n: int, init_file: str, device_type: str,
                   fn: Callable, args: Sequence) -> None:
    # die with the fork server (PR_SET_PDEATHSIG = 1), which dies with the
    # World's process; if it is already gone, so is that process
    ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)
    if os.getppid() == 1:
        os._exit(1)
    try:
        if device_type == "cpu":
            _yield_cpu()
        _join(rank, n, init_file, device_type)
        try:
            fn(rank, *args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


def _check_cards(n: int, device_type: str) -> None:
    if device_type == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"a world of {n} ranks on CUDA needs {n} cards, "
                           f"{torch.cuda.device_count()} present")


def _forkserver():
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(_PRELOAD)
    return ctx


class World:
    """The calling process as rank 0 of a new world of ``n`` (gloo on the
    CPU, NCCL on the card, rank r on card r), ranks 1..n-1 running
    ``fn(rank, *args)`` in processes of their own until it returns (module
    docstring). ``fn`` must be importable by name, its arguments
    picklable. Raises as ``run_world`` does when there are too few cards;
    a follower that fails prints its traceback and exits, and rank 0
    learns of it at its next collective with it."""

    def __init__(self, fn: Callable, n: int, args: Sequence = (), *,
                 device: str = "cuda"):
        device_type = torch.device(device).type
        _check_cards(n, device_type)
        ctx = _forkserver()
        self._tmp = tempfile.TemporaryDirectory(prefix="ray_tpu_torch_world_")
        init_file = os.path.join(self._tmp.name, "rendezvous")
        self.procs = [ctx.Process(target=_follower_main, daemon=True,
                                  args=(r, n, init_file, device_type, fn,
                                        args))
                      for r in range(1, n)]
        try:
            for p in self.procs:
                p.start()
            _join(0, n, init_file, device_type)
        except BaseException:
            self.shutdown(timeout=0)
            raise

    @property
    def pids(self) -> List[int]:
        """The followers' process ids, rank 1 first."""
        return [p.pid for p in self.procs]

    def shutdown(self, timeout: float = 10.0) -> None:
        """Leave the world, give the followers ``timeout`` seconds to end,
        kill the rest and reap them all."""
        if dist.is_initialized():
            dist.destroy_process_group()
        started = [p for p in self.procs if p.pid is not None]
        deadline = time.monotonic() + timeout
        for p in started:
            p.join(max(0.0, deadline - time.monotonic()))
        _stop(started)
        self._tmp.cleanup()


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
    _check_cards(n, device_type)
    ctx = _forkserver()
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
