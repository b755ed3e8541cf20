"""In-process object store for resolved values and pending futures.

Analog of the reference's ``CoreWorkerMemoryStore``
(src/ray/core_worker/store_provider/memory_store/memory_store.h:43): holds
small/inlined objects and completed results locally so ``get`` on them never
touches the shared-memory store; unresolved ids carry waiter lists.

Waiting is count-based: a ``get`` on N refs registers ONE waiter carrying a
remaining-count on each missing id, and each arriving result decrements the
counts of that id's waiters. The waiting thread wakes exactly once — the
broadcast-and-rescan design this replaced cost O(results x N) rescans per
``get`` and dominated async task throughput at high rates.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from .ids import ObjectID


class _Entry:
    __slots__ = ("ready", "value", "is_error", "in_plasma", "node_idx",
                 "plasma_size")

    def __init__(self):
        self.ready = False
        self.value = None
        self.is_error = False
        self.in_plasma = False
        self.node_idx = -1
        self.plasma_size = 0  # sealed byte count when known (0 = unknown)


class _Waiter:
    __slots__ = ("needed", "event")

    def __init__(self, needed: int):
        self.needed = needed
        self.event = threading.Event()


class MemoryStore:
    def __init__(self):
        # RLock: evicting an entry can decref contained ObjectRefs whose
        # __del__ cascades (remove_local_ref -> borrow release -> evict)
        # back into this store while the lock is held.
        self._lock = threading.RLock()
        self._entries: Dict[ObjectID, _Entry] = {}
        self._callbacks: Dict[ObjectID, List[Callable]] = {}
        self._waiters: Dict[ObjectID, List[_Waiter]] = {}

    def _mark_ready_locked(self, oid: ObjectID):
        """Collect callbacks + satisfied waiters for a now-ready id.

        Caller holds the lock and must fire the returned items outside it.
        """
        cbs = self._callbacks.pop(oid, [])
        fired = []
        for w in self._waiters.pop(oid, ()):
            w.needed -= 1
            if w.needed <= 0:
                fired.append(w)
        return cbs, fired

    def put_value(self, oid: ObjectID, value: Any, is_error: bool = False):
        with self._lock:
            e = self._entries.setdefault(oid, _Entry())
            e.ready = True
            e.value = value
            e.is_error = is_error
            cbs, fired = self._mark_ready_locked(oid)
        for w in fired:
            w.event.set()
        for cb in cbs:
            cb()

    def put_plasma_location(self, oid: ObjectID, node_idx: int,
                            size: int = 0):
        """Record that the value lives in node `node_idx`'s shm store.
        ``size`` (when the caller knows it — the owner's put path does)
        lets the free path decide whether a prompt local arena delete is
        worth its syscall."""
        with self._lock:
            e = self._entries.setdefault(oid, _Entry())
            e.ready = True
            e.in_plasma = True
            e.node_idx = node_idx
            if size > 0:
                e.plasma_size = size
            cbs, fired = self._mark_ready_locked(oid)
        for w in fired:
            w.event.set()
        for cb in cbs:
            cb()

    def contains(self, oid: ObjectID) -> bool:
        with self._lock:
            e = self._entries.get(oid)
            return e is not None and e.ready

    def peek(self, oid: ObjectID) -> Optional[_Entry]:
        with self._lock:
            e = self._entries.get(oid)
            return e if (e and e.ready) else None

    def wait_ready(self, oids: Sequence[ObjectID], num_returns: int,
                   timeout: Optional[float]) -> List[ObjectID]:
        """Block until `num_returns` of `oids` are ready; returns ready list.

        Duplicate ids count once (callers compare against their unique set).
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        uniq = list(dict.fromkeys(oids))
        num_returns = min(num_returns, len(uniq))
        with self._lock:
            missing = [o for o in uniq
                       if not ((e := self._entries.get(o)) and e.ready)]
            n_ready = len(uniq) - len(missing)
            if n_ready >= num_returns:
                ready = [o for o in uniq
                         if (e := self._entries.get(o)) and e.ready]
                return ready[:num_returns]
            w = _Waiter(num_returns - n_ready)
            for o in missing:
                self._waiters.setdefault(o, []).append(w)
        if deadline is None:
            w.event.wait()
        else:
            w.event.wait(max(0.0, deadline - time.monotonic()))
        with self._lock:
            for o in missing:
                lst = self._waiters.get(o)
                if lst is not None:
                    try:
                        lst.remove(w)
                    except ValueError:
                        pass
                    if not lst:
                        del self._waiters[o]
            ready = [o for o in uniq
                     if (e := self._entries.get(o)) and e.ready]
        return ready[:num_returns] if num_returns < len(ready) else ready

    def add_ready_callback(self, oid: ObjectID, cb: Callable):
        fire = False
        with self._lock:
            e = self._entries.get(oid)
            if e is not None and e.ready:
                fire = True
            else:
                self._callbacks.setdefault(oid, []).append(cb)
        if fire:
            cb()

    def evict(self, oid: ObjectID):
        with self._lock:
            self._entries.pop(oid, None)

    def num_entries(self) -> int:
        with self._lock:
            return len(self._entries)
