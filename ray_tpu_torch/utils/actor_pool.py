"""ActorPool: multiplex tasks over a fixed set of actor handles.

Ref parity: ray.util.ActorPool (python/ray/util/actor_pool.py) — same
surface: map / map_unordered / submit / get_next / get_next_unordered /
has_next / has_free / push / pop_idle. Submissions beyond the pool size
queue (with their ordering slot assigned up front) until an actor frees,
so ordered and unordered consumption can be freely interleaved.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List

import ray_tpu_torch


class ActorPool:
    def __init__(self, actors: Iterable[Any]):
        self._idle_actors: List[Any] = list(actors)
        if not self._idle_actors:
            raise ValueError("ActorPool needs at least one actor")
        # ref -> (index, actor); actor becomes None once returned to the
        # pool while its (completed) result awaits ordered consumption
        self._future_to_actor = {}
        self._index_to_future = {}      # outstanding index -> ref | None
        self._next_task_index = 0
        self._next_return_index = 0
        self._pending_submits = []      # (fn, value, index)

    # ------------------------------------------------------------- map

    def map(self, fn: Callable, values: Iterable[Any]):
        """Ordered lazy map: yields results in submission order."""
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable, values: Iterable[Any]):
        """Unordered lazy map: yields results as they complete."""
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    # ---------------------------------------------------------- submit

    def submit(self, fn: Callable, value: Any):
        """``fn(actor, value) -> ObjectRef``; queues when the pool is busy."""
        index = self._next_task_index
        self._next_task_index += 1
        if self._idle_actors:
            self._dispatch(self._idle_actors.pop(), fn, value, index)
        else:
            self._index_to_future[index] = None  # reserved, still queued
            self._pending_submits.append((fn, value, index))

    def _dispatch(self, actor, fn, value, index):
        ref = fn(actor, value)
        self._future_to_actor[ref] = (index, actor)
        self._index_to_future[index] = ref

    def _return_actor(self, actor):
        if self._pending_submits:
            fn, value, index = self._pending_submits.pop(0)
            self._dispatch(actor, fn, value, index)
        else:
            self._idle_actors.append(actor)

    # ------------------------------------------------------------- get

    def has_next(self) -> bool:
        return bool(self._index_to_future)

    def has_free(self) -> bool:
        return bool(self._idle_actors) and not self._pending_submits

    def _busy_refs(self) -> List[Any]:
        return [r for r, (_, a) in self._future_to_actor.items()
                if a is not None]

    def get_next(self, timeout=None):
        """Next result in SUBMISSION order (blocks until it completes)."""
        if not self.has_next():
            raise StopIteration("no pending results")
        # skip slots already consumed by get_next_unordered
        while self._next_return_index not in self._index_to_future:
            self._next_return_index += 1
        index = self._next_return_index
        while self._index_to_future[index] is None:
            # still queued behind a busy pool: consume one completion so
            # an actor frees up and the queue advances
            busy = self._busy_refs()
            if not busy:
                raise RuntimeError("queued submission with no busy actor")
            done, _ = ray_tpu_torch.wait(busy, num_returns=1,
                                         timeout=timeout)
            if not done:
                raise TimeoutError("get_next timed out")
            i, actor = self._future_to_actor[done[0]]
            self._future_to_actor[done[0]] = (i, None)
            self._return_actor(actor)
        ref = self._index_to_future.pop(index)
        self._next_return_index = index + 1
        # bookkeeping BEFORE get: a task exception must not strand the
        # completed ref in _future_to_actor (a later get_next_unordered
        # would re-deliver the consumed error) nor leak the actor
        entry = self._future_to_actor.pop(ref, None)
        try:
            return ray_tpu_torch.get(ref, timeout=timeout)
        finally:
            if entry is not None and entry[1] is not None:
                self._return_actor(entry[1])

    def get_next_unordered(self, timeout=None):
        """Next result in COMPLETION order."""
        if not self.has_next():
            raise StopIteration("no pending results")
        if not self._future_to_actor:
            raise RuntimeError("queued submission with no busy actor")
        done, _ = ray_tpu_torch.wait(list(self._future_to_actor),
                                     num_returns=1, timeout=timeout)
        if not done:
            raise TimeoutError("get_next_unordered timed out")
        ref = done[0]
        index, actor = self._future_to_actor.pop(ref)
        self._index_to_future.pop(index, None)
        if actor is not None:
            self._return_actor(actor)
        return ray_tpu_torch.get(ref, timeout=timeout)

    # ----------------------------------------------------- pool mgmt

    def push(self, actor):
        """Add an idle actor to the pool."""
        self._return_actor(actor)

    def pop_idle(self):
        """Remove and return an idle actor, or None if none are idle."""
        return self._idle_actors.pop() if self._idle_actors else None
