"""Distributed reference counting for object GC.

Analog of the reference's ``ReferenceCounter``
(src/ray/core_worker/reference_count.h:61, ~1.6k LoC) — the owner of each
object tracks (a) its own process-local Python refs, (b) submitted-task
arguments in flight, and (c) remote borrowers. When all three hit zero the
object is freed from the shared-memory store cluster-wide. Borrowers report
via BORROW_ADD/BORROW_REMOVE control messages (the reference uses the
WaitForRefRemoved pubsub protocol).

Freeing an OWNED object is deferred by a short grace window: BORROW_ADD
from a process that just deserialized the ref (task executor, queue
actor, chained borrower) races the release that drops our last pin on a
DIFFERENT connection, and an immediate free would delete an object a
peer is about to use (the reference closes this by shipping borrow
metadata inside task replies; the grace re-check achieves the same
safety with bounded extra lifetime).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, Optional, Set

from .ids import ObjectID


class _Count:
    __slots__ = ("local", "task_args", "borrowers", "owned", "freed",
                 "ever_shared")

    def __init__(self):
        self.local = 0
        self.task_args = 0
        self.borrowers: Set[str] = set()
        self.owned = False
        self.freed = False
        # ever lent out (task arg / borrower): only shared objects need
        # the grace-deferred free — an object that never left this
        # process cannot have a BORROW_ADD in flight, and deferring its
        # free keeps arena space pinned (put-churn bandwidth collapses)
        self.ever_shared = False

    def total(self) -> int:
        return self.local + self.task_args + len(self.borrowers)


class ReferenceCounter:
    def __init__(self, my_id: str,
                 free_callback: Callable[[ObjectID], None],
                 borrow_release_callback: Callable[[ObjectID, str], None]):
        """free_callback: invoked (owner side) when an owned object's count
        hits zero. borrow_release_callback(oid, owner): invoked (borrower
        side) when our local refs on a borrowed object hit zero."""
        self._my_id = my_id
        # RLock: ObjectRef.__del__ can fire from the GC during an
        # allocation made INSIDE a locked section (observed: _Count()
        # in add_local_ref) and re-enter via remove_local_ref — a plain
        # Lock self-deadlocks the whole process there.
        self._lock = threading.RLock()
        self._counts: Dict[ObjectID, _Count] = {}
        self._free_cb = free_callback
        self._borrow_release_cb = borrow_release_callback
        self._owners: Dict[ObjectID, Optional[str]] = {}
        self._grace_s = 1.0  # in-flight BORROW_ADD window
        # one reaper thread drains the deferred-free queue (a Timer per
        # object would spawn a thread per free — hundreds under data
        # workloads)
        self._deferred: "deque" = deque()  # (deadline, oid)
        self._reaper_wake = threading.Event()
        self._reaper: Optional[threading.Thread] = None

    def _schedule_free(self, oid: ObjectID):
        """Free after the grace window IF the count is still zero (a
        late-arriving borrow resurrects the entry and cancels the free)."""
        self._deferred.append((time.monotonic() + self._grace_s, oid))
        if self._reaper is None:
            with self._lock:
                if self._reaper is None:
                    self._reaper = threading.Thread(
                        target=self._reap_loop, daemon=True,
                        name="ref-reaper")
                    self._reaper.start()
        self._reaper_wake.set()

    def _reap_loop(self):
        while True:
            if not self._deferred:
                self._reaper_wake.wait(timeout=5.0)
                self._reaper_wake.clear()
                continue
            deadline, oid = self._deferred[0]
            delay = deadline - time.monotonic()
            if delay > 0:
                time.sleep(min(delay, 0.2))
                continue
            self._deferred.popleft()
            self._free_if_still_zero(oid)

    def _free_if_still_zero(self, oid: ObjectID):
        to_free = None
        with self._lock:
            c = self._counts.get(oid)
            if c is not None and c.total() <= 0 and c.owned and \
                    not c.freed:
                c.freed = True
                to_free = oid
                self._counts.pop(oid, None)
        if to_free is not None:
            self._free_cb(to_free)

    def add_owned(self, oid: ObjectID):
        with self._lock:
            c = self._counts.setdefault(oid, _Count())
            c.owned = True

    def add_local_ref(self, ref) -> None:
        with self._lock:
            c = self._counts.setdefault(ref.id, _Count())
            c.local += 1
            if not c.owned:
                self._owners[ref.id] = ref.owner

    def remove_local_ref(self, ref) -> None:
        free_now = None
        defer_free = None
        borrow_release = None
        with self._lock:
            c = self._counts.get(ref.id)
            if c is None:
                return
            c.local -= 1
            if c.local <= 0 and c.task_args == 0:
                if c.owned and not c.borrowers and not c.freed:
                    if c.ever_shared:
                        defer_free = ref.id
                    else:  # never left this process: free immediately
                        c.freed = True
                        free_now = ref.id
                        self._counts.pop(ref.id, None)
                elif not c.owned:
                    owner = self._owners.pop(ref.id, None)
                    self._counts.pop(ref.id, None)
                    if owner:
                        borrow_release = (ref.id, owner)
        if free_now is not None:
            self._free_cb(free_now)
        if defer_free is not None:
            self._schedule_free(defer_free)
        if borrow_release is not None:
            self._borrow_release_cb(*borrow_release)

    def add_task_arg(self, oid: ObjectID):
        with self._lock:
            c = self._counts.setdefault(oid, _Count())
            c.task_args += 1
            c.ever_shared = True

    def mark_shared(self, oid: ObjectID):
        """The ref escaped this process by some path other than a task
        arg/borrow registration (e.g. serialized inside a put() object a
        peer may deserialize) — its free must take the grace window."""
        with self._lock:
            c = self._counts.get(oid)
            if c is not None:
                c.ever_shared = True

    def remove_task_arg(self, oid: ObjectID):
        defer_free = None
        with self._lock:
            c = self._counts.get(oid)
            if c is None:
                return
            c.task_args -= 1
            if c.total() <= 0 and c.owned and not c.freed:
                defer_free = oid
        if defer_free is not None:
            self._schedule_free(defer_free)

    # owner side: borrower registration
    def add_borrower(self, oid: ObjectID, borrower: str):
        with self._lock:
            c = self._counts.setdefault(oid, _Count())
            c.owned = True
            c.borrowers.add(borrower)
            c.ever_shared = True

    def remove_borrower(self, oid: ObjectID, borrower: str):
        defer_free = None
        with self._lock:
            c = self._counts.get(oid)
            if c is None:
                return
            c.borrowers.discard(borrower)
            if c.total() <= 0 and c.owned and not c.freed:
                defer_free = oid
        if defer_free is not None:
            self._schedule_free(defer_free)

    def num_tracked(self) -> int:
        with self._lock:
            return len(self._counts)
