"""Distributed Queue backed by an actor.

Ref parity: ray.util.queue.Queue (python/ray/util/queue.py) — a bounded
FIFO any worker/driver can put/get through a shared actor handle, with
blocking + timeout semantics and the Empty/Full exceptions re-exported.
"""

from __future__ import annotations

import queue as _stdlib_queue
import time
from typing import Any, List, Optional

import ray_tpu_torch

Empty = _stdlib_queue.Empty
Full = _stdlib_queue.Full

_POLL_S = 0.05


class _QueueActor:
    """The queue state lives in one actor; clients poll for blocking ops
    (the reference uses an asyncio actor with awaitable get/put — here
    replicas poll, which bounds added latency at _POLL_S)."""

    def __init__(self, maxsize: int):
        self._q = _stdlib_queue.Queue(maxsize=maxsize)

    def qsize(self) -> int:
        return self._q.qsize()

    def empty(self) -> bool:
        return self._q.empty()

    def full(self) -> bool:
        return self._q.full()

    def put_nowait(self, item) -> bool:
        try:
            self._q.put_nowait(item)
            return True
        except _stdlib_queue.Full:
            return False

    def put_nowait_batch(self, items: List[Any]) -> bool:
        """All-or-nothing (matches the reference's semantics — a partial
        insert would duplicate items when the caller retries the batch)."""
        if self._q.maxsize and \
                self._q.qsize() + len(items) > self._q.maxsize:
            return False
        for it in items:
            self._q.put_nowait(it)
        return True

    def get_nowait(self):
        try:
            return True, self._q.get_nowait()
        except _stdlib_queue.Empty:
            return False, None

    def get_nowait_batch(self, num_items: int):
        out = []
        for _ in range(num_items):
            ok, item = self.get_nowait()
            if not ok:
                break
            out.append(item)
        return out


class Queue:
    def __init__(self, maxsize: int = 0, actor_options: Optional[dict] = None):
        self.maxsize = maxsize
        cls = ray_tpu_torch.remote(**(actor_options or {}))(_QueueActor) \
            if actor_options else ray_tpu_torch.remote(_QueueActor)
        self.actor = cls.remote(maxsize)

    def __getstate__(self):
        return {"maxsize": self.maxsize, "actor": self.actor}

    def __setstate__(self, state):
        self.__dict__.update(state)

    # ------------------------------------------------------------ info

    def qsize(self) -> int:
        return ray_tpu_torch.get(self.actor.qsize.remote())

    def size(self) -> int:
        return self.qsize()

    def empty(self) -> bool:
        return ray_tpu_torch.get(self.actor.empty.remote())

    def full(self) -> bool:
        return ray_tpu_torch.get(self.actor.full.remote())

    # ------------------------------------------------------------- put

    def put(self, item, block: bool = True, timeout: Optional[float] = None):
        if not block:
            if not ray_tpu_torch.get(self.actor.put_nowait.remote(item)):
                raise Full
            return
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if ray_tpu_torch.get(self.actor.put_nowait.remote(item)):
                return
            if deadline is not None and time.monotonic() >= deadline:
                raise Full
            time.sleep(_POLL_S)

    def put_nowait(self, item):
        self.put(item, block=False)

    def put_nowait_batch(self, items: List[Any]):
        items = list(items)
        if not ray_tpu_torch.get(self.actor.put_nowait_batch.remote(items)):
            raise Full(f"{len(items)} items do not fit")

    # ------------------------------------------------------------- get

    def get(self, block: bool = True, timeout: Optional[float] = None):
        if not block:
            ok, item = ray_tpu_torch.get(self.actor.get_nowait.remote())
            if not ok:
                raise Empty
            return item
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            ok, item = ray_tpu_torch.get(self.actor.get_nowait.remote())
            if ok:
                return item
            if deadline is not None and time.monotonic() >= deadline:
                raise Empty
            time.sleep(_POLL_S)

    def get_nowait(self):
        return self.get(block=False)

    def get_nowait_batch(self, num_items: int) -> List[Any]:
        return ray_tpu_torch.get(
            self.actor.get_nowait_batch.remote(num_items))

    def shutdown(self, force: bool = False):
        ray_tpu_torch.kill(self.actor)
