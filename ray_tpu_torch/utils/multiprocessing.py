"""multiprocessing.Pool API over the cluster.

Ref parity: ray.util.multiprocessing.Pool
(python/ray/util/multiprocessing/pool.py): a drop-in Pool whose workers are
actors, so `map`/`apply` fan out across the cluster instead of local forks.
Covers apply / apply_async / map / map_async / starmap / imap /
imap_unordered / close / terminate / join and the context-manager protocol.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterable, List, Optional

import ray_tpu_torch

from .actor_pool import ActorPool


class AsyncResult:
    """Ref parity: multiprocessing.pool.AsyncResult."""

    def __init__(self, refs: List[Any], single: bool):
        self._refs = refs
        self._single = single

    def get(self, timeout: Optional[float] = None):
        vals = ray_tpu_torch.get(self._refs, timeout=timeout)
        return vals[0] if self._single else vals

    def wait(self, timeout: Optional[float] = None):
        ray_tpu_torch.wait(self._refs, num_returns=len(self._refs),
                           timeout=timeout)

    def ready(self) -> bool:
        done, _ = ray_tpu_torch.wait(self._refs,
                                     num_returns=len(self._refs), timeout=0)
        return len(done) == len(self._refs)

    def successful(self) -> bool:
        if not self.ready():
            raise ValueError("result is not ready")
        try:
            ray_tpu_torch.get(self._refs, timeout=0)
            return True
        except Exception:  # noqa: BLE001
            return False


class _PoolWorker:
    def __init__(self, initializer=None, initargs=()):
        if initializer is not None:
            initializer(*initargs)

    def run(self, fn, args, kwargs):
        return fn(*args, **(kwargs or {}))

    def run_chunk(self, fn, chunk):
        return [fn(*a) for a in chunk]


class Pool:
    def __init__(self, processes: Optional[int] = None, initializer=None,
                 initargs=(), ray_remote_args: Optional[dict] = None):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        if processes is None:
            processes = max(1, int(
                ray_tpu_torch.cluster_resources().get("CPU", 1)))
        self._processes = processes
        opts = dict(ray_remote_args or {})
        opts.setdefault("num_cpus", 1)
        actor_cls = ray_tpu_torch.remote(**opts)(_PoolWorker)
        self._actors = [actor_cls.remote(initializer, initargs)
                        for _ in range(processes)]
        self._pool = ActorPool(self._actors)
        self._rr = itertools.cycle(range(processes))
        self._closed = False

    # --------------------------------------------------------- apply

    def apply(self, fn: Callable, args=(), kwds=None):
        return self.apply_async(fn, args, kwds).get()

    def apply_async(self, fn: Callable, args=(), kwds=None, callback=None,
                    error_callback=None) -> AsyncResult:
        self._check_open()
        actor = self._actors[next(self._rr)]
        res = AsyncResult([actor.run.remote(fn, list(args), kwds)],
                          single=True)
        if callback is not None or error_callback is not None:
            import threading

            def _notify():
                try:
                    value = res.get()
                except Exception as e:  # noqa: BLE001
                    if error_callback is not None:
                        error_callback(e)
                else:
                    if callback is not None:
                        callback(value)

            threading.Thread(target=_notify, daemon=True).start()
        return res

    # ----------------------------------------------------------- map

    def _chunks(self, iterable: Iterable, chunksize: Optional[int],
                star: bool) -> List[list]:
        items = [tuple(a) if star else (a,) for a in iterable]
        if chunksize is None:
            chunksize = max(1, len(items) // (self._processes * 4) or 1)
        return [items[i:i + chunksize]
                for i in range(0, len(items), chunksize)]

    def _pool_map(self, fn, iterable, chunksize, star: bool):
        """Work-stealing dispatch through the ActorPool: a slow actor
        holds one chunk, not a static 1/N share of them."""
        out: List[Any] = []
        for chunk_res in self._pool.map(
                lambda a, chunk: a.run_chunk.remote(fn, chunk),
                self._chunks(iterable, chunksize, star=star)):
            out.extend(chunk_res)
        return out

    def map(self, fn: Callable, iterable: Iterable, chunksize=None):
        self._check_open()
        return self._pool_map(fn, iterable, chunksize, star=False)

    def map_async(self, fn, iterable, chunksize=None) -> AsyncResult:
        # async variant needs all refs up front, so chunks are assigned
        # round-robin rather than through the work-stealing pool
        self._check_open()
        chunks = self._chunks(iterable, chunksize, star=False)
        refs = [self._actors[next(self._rr)].run_chunk.remote(fn, c)
                for c in chunks]
        return _FlattenResult(refs)

    def starmap(self, fn: Callable, iterable: Iterable, chunksize=None):
        self._check_open()
        return self._pool_map(fn, iterable, chunksize, star=True)

    def imap(self, fn: Callable, iterable: Iterable, chunksize=1):
        self._check_open()
        gen = self._pool.map(
            lambda a, chunk: a.run_chunk.remote(fn, chunk),
            self._chunks(iterable, chunksize, star=False))
        return (item for chunk in gen for item in chunk)

    def imap_unordered(self, fn, iterable, chunksize=1):
        self._check_open()
        gen = self._pool.map_unordered(
            lambda a, chunk: a.run_chunk.remote(fn, chunk),
            self._chunks(iterable, chunksize, star=False))
        return (item for chunk in gen for item in chunk)

    # ------------------------------------------------------ lifecycle

    def _check_open(self):
        if self._closed:
            raise ValueError("Pool is closed")

    def close(self):
        self._closed = True

    def terminate(self):
        self._closed = True
        for a in self._actors:
            ray_tpu_torch.kill(a)
        self._actors = []

    def join(self):
        if not self._closed:
            raise ValueError("join() before close()")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.terminate()


class _FlattenResult(AsyncResult):
    """map chunks return lists; flatten on get."""

    def __init__(self, refs):
        super().__init__(refs, single=False)

    def get(self, timeout: Optional[float] = None):
        out: List[Any] = []
        for chunk in ray_tpu_torch.get(self._refs, timeout=timeout):
            out.extend(chunk)
        return out
