"""Sharded object directory: the head's holder-set map off the head lock.

Analog of the reference's ObjectDirectory
(src/ray/object_manager/object_directory.h) — but where r6 kept the map
as a plain dict guarded by the ONE head lock, every ``OBJ_LOCATION_ADD /
REMOVE / LOOKUP``, sealed report, locate, free, and broadcast-planner
holder query serialized against lease granting, PG math, and the event
fold on the head IO loop. This module extends the ``native/sched_core``
precedent of getting per-message hot paths off that lock: entries live
in N independently-locked shards (hash of the ObjectID picks the shard),
so directory traffic contends only with directory traffic for the same
shard — the GCS-vs-raylet split of the reference control plane, applied
to the object plane's metadata.

Invariants preserved from the r6/r9 design:

* per-object mutations (holders / waiters / inprog / serving) happen
  under that object's shard lock — the planner and
  ``_finish_pull_assignment`` share it, so an aborted puller can never
  be handed out as a relay after its failure is known
  (directory-staleness-on-abort guarantee);
* the LOST set (ids whose final copy is gone; owners must reconstruct)
  is a bounded FIFO with its own lock, checked/cleared by the same
  operations that touched it under the head lock before.

The head still owns everything that needs the NODE table (picking live
holder nodes, transfer addresses): those reads are GIL-atomic dict
lookups plus ``alive`` flags, tolerant of the same momentary staleness
the old lock-dropping paths already had.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .ids import ObjectID

# blocked-locate waiter: (connection, request_id)
Waiter = Tuple[object, int]

_LOST_CAP = 65536


@dataclass
class _ObjLoc:
    """Object directory entry (reference: ObjectDirectory,
    src/ray/object_manager/object_directory.h — the full HOLDER SET per
    object, not just the sealing node). ``node_idx`` stays the primary
    location for the single-location paths (locate replies, spill);
    ``holders`` is every node with a sealed copy and always contains
    ``node_idx`` while it is >= 0."""

    node_idx: int = -1
    size: int = 0
    owner: str = ""
    # memory-observatory attribution (stamped by record_sealed): the
    # sealing context's job id (hex), the wall-clock seal time (object
    # age in `ray_tpu memory` / list objects), and an optional reference
    # class tag ("checkpoint" — pipeline checkpoint refs — today;
    # empty = plain sealed object).
    job: str = ""
    sealed_at: float = 0.0
    tag: str = ""
    spilled_path: str = ""
    holders: Set[int] = field(default_factory=set)
    waiters: List[Waiter] = field(default_factory=list)
    # Cooperative broadcast (in-progress locations): nodes the head has
    # told to pull this object whose pull has not completed yet, mapped
    # to their transfer address — the planner may point LATER pullers at
    # them (chunk relay). Entries leave the moment the pull finishes
    # (promoted to ``holders``) or aborts (never handed out again).
    inprog: Dict[int, str] = field(default_factory=dict)
    # Stripe-weighted active downstream pulls per source transfer
    # address (sealed holders and relays alike): a pull striped across
    # k roots charges each 1/k — it only takes ~1/k of each uplink —
    # while a relay-served pull charges its one source a full 1.0. The
    # planner skips sources at the ``broadcast_fanout`` bound, which is
    # what bends N simultaneous pullers into a pipelined tree instead
    # of N streams off one uplink.
    serving: Dict[str, float] = field(default_factory=dict)


class ObjectDirectory:
    """N-sharded ``ObjectID -> _ObjLoc`` map with per-shard locks.

    The mapping surface (``in`` / ``[]`` / ``.get``) is lock-free reads
    of GIL-atomic dict ops — callers that MUTATE an entry or need a
    consistent read-modify-write take ``lock_for(oid)`` first (the same
    discipline the head lock provided, at per-shard granularity).
    """

    def __init__(self, n_shards: int = 16):
        self._n = n_shards
        self._shards: List[Dict[ObjectID, _ObjLoc]] = [
            {} for _ in range(n_shards)]
        self._locks = [threading.RLock() for _ in range(n_shards)]
        # ids sealed once whose last copy is gone (node death / eviction
        # with no spill): locates answer -2 so owners run lineage
        # reconstruction instead of blocking forever. FIFO-bounded — ids
        # whose owner died with the node would otherwise leak.
        self._lost: Dict[ObjectID, None] = {}
        self._lost_lock = threading.Lock()

    # ------------------------------------------------------ mapping surface

    def _shard(self, oid: ObjectID) -> Dict[ObjectID, _ObjLoc]:
        return self._shards[hash(oid) % self._n]

    def lock_for(self, oid: ObjectID) -> threading.RLock:
        return self._locks[hash(oid) % self._n]

    def __contains__(self, oid: ObjectID) -> bool:
        return oid in self._shard(oid)

    def __getitem__(self, oid: ObjectID) -> _ObjLoc:
        return self._shard(oid)[oid]

    def get(self, oid: ObjectID) -> Optional[_ObjLoc]:
        return self._shard(oid).get(oid)

    def __len__(self) -> int:
        return sum(len(s) for s in self._shards)

    def setdefault(self, oid: ObjectID) -> _ObjLoc:
        """Get-or-create under the shard lock (callers usually already
        hold it; RLock makes both call shapes safe)."""
        shard = self._shard(oid)
        loc = shard.get(oid)
        if loc is None:
            with self.lock_for(oid):
                loc = shard.get(oid)
                if loc is None:
                    loc = shard[oid] = _ObjLoc()
        return loc

    def pop(self, oid: ObjectID) -> Optional[_ObjLoc]:
        if oid not in self._shard(oid):  # lock-free miss fast path: the
            return None                  # free flood is mostly inline ids
        with self.lock_for(oid):
            return self._shard(oid).pop(oid, None)

    def values_snapshot(self) -> List[_ObjLoc]:
        """Point-in-time value list (per-shard consistent) for the
        state queries / spill candidate scans."""
        out: List[_ObjLoc] = []
        for shard, lock in zip(self._shards, self._locks):
            with lock:
                out.extend(shard.values())
        return out

    def items_snapshot(self) -> List[Tuple[ObjectID, _ObjLoc]]:
        out: List[Tuple[ObjectID, _ObjLoc]] = []
        for shard, lock in zip(self._shards, self._locks):
            with lock:
                out.extend(shard.items())
        return out

    def listing_rows(self) -> List[dict]:
        """state-API ``objects`` rows, with the mutable holder sets
        copied UNDER the shard locks — iterating a live entry's set
        after the snapshot lock is released can race a concurrent
        holder-add and raise mid-query."""
        rows: List[dict] = []
        now = time.time()
        for shard, lock in zip(self._shards, self._locks):
            with lock:
                for oid, loc in shard.items():
                    if loc.node_idx < 0 and not loc.spilled_path:
                        continue
                    rows.append({
                        "object_id": oid.hex(),
                        "node_idx": loc.node_idx,
                        "size": loc.size, "owner": loc.owner,
                        "job": loc.job, "tag": loc.tag,
                        "age_s": round(now - loc.sealed_at, 3)
                        if loc.sealed_at else 0.0,
                        "spilled": bool(loc.spilled_path),
                        "holders": sorted(loc.holders),
                    })
        return rows

    # ------------------------------------------------------------ LOST set

    def is_lost(self, oid: ObjectID) -> bool:
        return oid in self._lost

    def clear_lost(self, oid: ObjectID):
        if oid not in self._lost:  # lock-free miss fast path
            return
        with self._lost_lock:
            self._lost.pop(oid, None)

    def mark_lost(self, oids: Iterable[ObjectID]) -> List[Waiter]:
        """Drop directory entries whose final copy is gone and remember
        the ids as LOST (bounded FIFO) so later locates fail fast —
        owners react by re-executing the creating task (lineage
        reconstruction; reference: object_recovery_manager.h:41).
        Returns the blocked-locate waiters that must hear the LOST
        sentinel (reply OFF the caller's critical path)."""
        waiters: List[Waiter] = []
        for oid in oids:
            with self.lock_for(oid):
                loc = self._shard(oid).get(oid)
                if loc is not None and (loc.node_idx >= 0
                                        or loc.spilled_path):
                    # the lost-decision and this pop are separate lock
                    # holds now (the old head lock spanned both): a copy
                    # registered in the window (OBJ_LOCATION_ADD /
                    # re-seal racing a node death) means the object is
                    # NOT lost — keep the live entry
                    continue
                loc = self._shard(oid).pop(oid, None)
                if loc is not None:
                    waiters.extend(loc.waiters)
                    loc.waiters.clear()
            with self._lost_lock:
                self._lost[oid] = None
        with self._lost_lock:
            while len(self._lost) > _LOST_CAP:
                self._lost.pop(next(iter(self._lost)))
        return waiters

    # ------------------------------------------------- directory operations

    def record_sealed(self, oid: ObjectID, node_idx: int, size: int,
                      owner: str, job: str = ""
                      ) -> Tuple[int, int, List[Waiter]]:
        """OBJECT_SEALED bookkeeping; returns (node_idx, size, waiters
        to answer with the location)."""
        self.clear_lost(oid)  # a recovered object is found again
        with self.lock_for(oid):
            loc = self.setdefault(oid)
            loc.node_idx = node_idx
            loc.size = size
            loc.owner = owner
            if job:
                loc.job = job
            loc.sealed_at = time.time()
            loc.holders.add(node_idx)
            waiters = list(loc.waiters)
            loc.waiters.clear()
            return node_idx, size, waiters

    def tag_objects(self, oids: Iterable[ObjectID], tag: str):
        """Stamp a reference-class tag (e.g. ``"checkpoint"``) onto
        existing entries — the memory summary's class breakdown keys off
        it. Unknown ids are ignored (the object may have been freed)."""
        for oid in oids:
            with self.lock_for(oid):
                loc = self.get(oid)
                if loc is not None:
                    loc.tag = tag

    def add_location(self, oid: ObjectID, node_idx: int, size: int = 0
                     ) -> Tuple[int, int, List[Waiter]]:
        """A node gained a copy (pull completion / replica creation)."""
        self.clear_lost(oid)
        with self.lock_for(oid):
            loc = self.setdefault(oid)
            loc.holders.add(node_idx)
            if size > 0 and loc.size <= 0:
                loc.size = size
            if loc.node_idx < 0:
                loc.node_idx = node_idx
            waiters: List[Waiter] = []
            if loc.waiters:
                waiters = list(loc.waiters)
                loc.waiters.clear()
            return loc.node_idx, loc.size, waiters

    def remove_locations(self, oids: Iterable[ObjectID], node_idx: int
                         ) -> List[Waiter]:
        """Holder-set removal (arena eviction / local deletion); returns
        the blocked-locate waiters that must hear the LOST sentinel."""
        lost: List[ObjectID] = []
        for oid in oids:
            with self.lock_for(oid):
                loc = self.get(oid)
                # Only act when the node is a recorded holder: an
                # eviction report racing ahead of the sealing worker's
                # OBJECT_SEALED (different head connections —
                # cross-connection order is not guaranteed) must not
                # declare a never-sealed waiter entry LOST. The inverse
                # race (remove lands before the entry even exists,
                # leaving a stale holder once SEALED arrives) is benign:
                # pulls fail over off stale entries per-object.
                if loc is None or node_idx not in loc.holders:
                    continue
                loc.holders.discard(node_idx)
                if loc.node_idx == node_idx:
                    loc.node_idx = min(loc.holders) if loc.holders else -1
                if loc.node_idx < 0 and not loc.spilled_path:
                    # last copy evicted and nothing on disk: the object
                    # is LOST — same outcome as its node dying
                    lost.append(oid)
        return self.mark_lost(lost)

    def purge_node(self, idx: int, dead_addr: str = "") -> List[Waiter]:
        """Node death: drop the node from every holder set, retire its
        in-progress locations and its serving load (it can no longer be
        a relay), promote replicas, and mark sole-copy objects LOST."""
        lost: List[ObjectID] = []
        for shard, lock in zip(self._shards, self._locks):
            with lock:
                for oid, loc in shard.items():
                    loc.holders.discard(idx)
                    loc.inprog.pop(idx, None)
                    if dead_addr:
                        loc.serving.pop(dead_addr, None)
                    if loc.node_idx != idx:
                        continue
                    if loc.holders:
                        loc.node_idx = min(loc.holders)  # promote a replica
                    elif loc.spilled_path:
                        loc.node_idx = -1
                    else:
                        # location-less NOW: mark_lost's recheck (a copy
                        # registered between this hold and the pop keeps
                        # the entry alive) must see it as lost-unless-
                        # something-new-arrived
                        loc.node_idx = -1
                        lost.append(oid)
        return self.mark_lost(lost)

    def locality_scores(self, arg_ids) -> Tuple[Dict[int, int], int]:
        """Per-node bytes of the given args already resident there, plus
        the args' total size (read-only holder-set scan; GIL-atomic dict
        reads — momentary staleness is fine for a placement HINT)."""
        scores: Dict[int, int] = {}
        total = 0
        for ob in dict.fromkeys(arg_ids):  # a dup arg counts once
            loc = self.get(ObjectID(ob))
            if loc is None or loc.size <= 0:
                continue
            total += loc.size
            for h in list(loc.holders):
                scores[h] = scores.get(h, 0) + loc.size
        return scores, total
