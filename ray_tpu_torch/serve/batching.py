"""``@serve.batch`` — coalesce concurrent single calls into one batch call.

Ref analog: python/ray/serve/batching.py:337 (@serve.batch, asyncio-queue
based). Re-design for threaded replicas: callers land on the replica's
thread pool and block on per-item futures while a dedicated daemon
*drainer* thread (started lazily, exits when idle) slices the queue into
batches of at most ``max_batch_size``, waiting up to
``batch_wait_timeout_s`` for each to fill, and runs the wrapped function
once per batch. This is how an XLA-compiled model replica turns N
concurrent requests into one padded forward pass.
"""

from __future__ import annotations

import concurrent.futures
import functools
import threading
import time
from typing import Any, Callable, Dict, List, Optional

# per-process registry of batchers for plain-function @serve.batch targets
_global_batchers: Dict[Any, "_Batcher"] = {}


class _Batcher:
    """Coalesces concurrent submit() calls into capped batches.

    A lazily started daemon *drainer* thread (not one of the callers — a
    caller-as-leader design either returns early and strands queued items
    or drains forever and never returns under sustained load) slices the
    queue into batches of at most ``max_bs``, waiting up to ``wait_s`` for
    each to fill. Replicas compiled for a padded XLA batch shape must never
    receive oversized batches, so the cap is a hard invariant.
    """

    def __init__(self, max_batch_size: int, batch_wait_timeout_s: float):
        self.max_bs = max_batch_size
        self.wait_s = batch_wait_timeout_s
        self.lock = threading.Lock()
        self.cv = threading.Condition(self.lock)
        self.queue: List = []  # (item, Future, call_batch)
        self.drainer: Optional[threading.Thread] = None  # guarded by lock

    def submit(self, call_batch: Callable[[list], list], item: Any) -> Any:
        fut: concurrent.futures.Future = concurrent.futures.Future()
        with self.lock:
            reentrant = threading.current_thread() is self.drainer
            if not reentrant:
                self.queue.append((item, fut, call_batch))
                if self.drainer is None:
                    t = threading.Thread(
                        target=self._drain, daemon=True, name="serve-batcher")
                    self.drainer = t
                    try:
                        t.start()
                    except BaseException:
                        # Thread exhaustion: reset ownership and fail queued
                        # futures so nothing blocks on a drainer that never
                        # ran.
                        self.drainer = None
                        pending, self.queue = self.queue, []
                        for _, f, _ in pending:
                            if not f.done():
                                f.set_exception(RuntimeError(
                                    "could not start @serve.batch drainer "
                                    "thread"))
                        raise
                else:
                    self.cv.notify()
        if reentrant:
            # Re-entrant call from inside call_batch: enqueueing would
            # deadlock (the drainer would wait on itself), so run the item
            # as its own batch inline, outside the lock.
            results = call_batch([item])
            if results is None or len(results) != 1:
                raise ValueError(
                    "@serve.batch function must return one result per input "
                    f"(1 in, {len(results) if results is not None else 0} "
                    "out)")
            return results[0]
        return fut.result()

    def _drain(self) -> None:
        try:
            while True:
                with self.lock:
                    if not self.queue:
                        # Exit under the lock: the next submit() sees
                        # drainer None and starts a fresh thread.
                        self.drainer = None
                        return
                    deadline = time.monotonic() + self.wait_s
                    while len(self.queue) < self.max_bs:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0 or not self.cv.wait(remaining):
                            break
                    batch = self.queue[:self.max_bs]
                    self.queue = self.queue[self.max_bs:]
                self._run_one(batch)
        except BaseException:
            # Never leave waiters blocked on futures nobody will resolve:
            # fail everything queued, clear ownership so the next submit
            # restarts a drainer, then let the error surface.
            with self.lock:
                self.drainer = None
                pending, self.queue = self.queue, []
            for _, f, _ in pending:
                if not f.done():
                    f.set_exception(
                        RuntimeError("@serve.batch drainer thread died"))
            raise

    def _run_one(self, batch: List) -> None:
        items = [i for i, _, _ in batch]
        call_batch = batch[0][2]
        try:
            results = call_batch(items)
            if results is None or len(results) != len(items):
                raise ValueError(
                    f"@serve.batch function must return one result per "
                    f"input ({len(items)} in, "
                    f"{len(results) if results is not None else 0} out)")
        except BaseException as e:  # noqa: BLE001 — propagate to all callers
            for _, f, _ in batch:
                if not f.done():
                    f.set_exception(e)
            if not isinstance(e, Exception):
                raise  # SystemExit/KeyboardInterrupt: don't swallow
            return
        for (_, f, _), r in zip(batch, results):
            f.set_result(r)


def batch(_func: Optional[Callable] = None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """Decorate a function/method taking a list so single calls batch up.

    The wrapped callable must accept a list of items and return a list of
    results of the same length. Call sites pass ONE item and get ONE result.
    """

    def decorate(fn):
        attr = f"__serve_batcher_{fn.__name__}"

        @functools.wraps(fn)
        def wrapper(*args):
            # Batchers hold locks, so they are created lazily per process
            # and never captured in the closure — the deployment payload is
            # pickled by value and locks don't pickle.
            if len(args) == 2:  # bound method: (self, item)
                self_, item = args
                batcher = getattr(self_, attr, None)
                if batcher is None:
                    # created once under a racy-but-idempotent setattr
                    # (worst case one extra object)
                    batcher = _Batcher(max_batch_size, batch_wait_timeout_s)
                    if not hasattr(self_, attr):
                        setattr(self_, attr, batcher)
                    batcher = getattr(self_, attr)
                return batcher.submit(lambda items: fn(self_, items), item)
            if len(args) == 1:
                batcher = _global_batchers.get(wrapper)
                if batcher is None:
                    batcher = _global_batchers.setdefault(
                        wrapper, _Batcher(max_batch_size,
                                          batch_wait_timeout_s))
                return batcher.submit(lambda items: fn(items), args[0])
            raise TypeError(
                "@serve.batch functions take exactly one item argument")

        wrapper._is_serve_batch = True  # noqa: SLF001
        return wrapper

    if _func is not None:
        return decorate(_func)
    return decorate
