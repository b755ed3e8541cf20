"""Python client for the native shared-memory object store.

Wraps ray_tpu_torch/native/shm_store.cc (the plasma analog —
src/ray/object_manager/plasma/client.cc in the reference) via ctypes. The
client maps the segment once; object payloads are read/written through
zero-copy memoryviews over that mapping. Serialization uses pickle protocol 5
with out-of-band buffers so numpy arrays and torch tensors round-trip without extra
copies.
"""

from __future__ import annotations

import ctypes
import mmap
import os
import pickle
import threading
import time
import weakref
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from .ids import ObjectID

_ID_SIZE = 20


class ObjectStoreFullError(Exception):
    pass


class ObjectExistsError(Exception):
    pass


def _load_lib():
    from ray_tpu_torch.native.build import lib_path

    lib = ctypes.CDLL(lib_path("libshm_store.so"))
    lib.shm_store_create.restype = ctypes.c_void_p
    lib.shm_store_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.shm_store_attach.restype = ctypes.c_void_p
    lib.shm_store_attach.argtypes = [ctypes.c_char_p]
    lib.shm_store_detach.argtypes = [ctypes.c_void_p]
    lib.shm_store_destroy.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.shm_store_create_object.restype = ctypes.c_int64
    lib.shm_store_create_object.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64]
    lib.shm_store_seal.restype = ctypes.c_int
    lib.shm_store_seal.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.shm_store_get.restype = ctypes.c_int
    lib.shm_store_get.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64)]
    lib.shm_store_contains.restype = ctypes.c_int
    lib.shm_store_contains.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.shm_store_release.restype = ctypes.c_int
    lib.shm_store_release.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.shm_store_delete.restype = ctypes.c_int
    lib.shm_store_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.shm_store_evict.restype = ctypes.c_int
    lib.shm_store_evict.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_int]
    lib.shm_store_bytes_in_use.restype = ctypes.c_uint64
    lib.shm_store_bytes_in_use.argtypes = [ctypes.c_void_p]
    lib.shm_store_capacity.restype = ctypes.c_uint64
    lib.shm_store_capacity.argtypes = [ctypes.c_void_p]
    lib.shm_store_num_objects.restype = ctypes.c_uint64
    lib.shm_store_num_objects.argtypes = [ctypes.c_void_p]
    lib.shm_store_list.restype = ctypes.c_int
    lib.shm_store_list.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int]
    lib.shm_store_memory_stats.restype = None
    lib.shm_store_memory_stats.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64)]
    return lib


_lib = None
_lib_lock = threading.Lock()


def get_lib():
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                _lib = _load_lib()
    return _lib


class PartialObject:
    """Chunk-availability map for an object whose pull is in progress.

    The cooperative-broadcast relay path (object_transfer.py): while an
    ``ObjectPuller`` streams chunks of an object into a created-but-
    unsealed arena buffer, this same host's ``TransferServer`` may
    already be re-serving those chunks to downstream pullers. The puller
    ``mark()``s each byte range as it lands; a relay ``wait_covered()``s
    the next range it needs and ``read()``s it out. Chunks may land at
    arbitrary offsets (multi-source striped upstream pulls), so
    availability is a set of merged disjoint intervals, not a high-water
    mark.

    Lifecycle: ``open`` while the pull runs; ``sealed`` once the object
    seals (relays switch to the normal pinned read path — the native
    store only evicts sealed *unpinned* objects, and unsealed buffers
    are never evicted at all, so both phases are eviction-safe);
    ``aborted`` when the pull fails (the arena view is dropped under the
    entry lock BEFORE the slot is freed, so an in-flight relay copy can
    never touch recycled arena memory)."""

    __slots__ = ("oid", "size", "meta", "buf", "lock", "_cond", "_avail",
                 "state")

    def __init__(self, oid: ObjectID, buf: memoryview, size: int,
                 meta: bytes):
        self.oid = oid
        self.size = size
        self.meta = meta
        self.buf = buf  # arena view (data + meta); None once finished
        self.lock = threading.Lock()
        self._cond = threading.Condition(self.lock)
        self._avail: List[List[int]] = []  # sorted disjoint [start, end)
        self.state = "open"  # open | sealed | aborted

    # -- puller side ---------------------------------------------------

    def mark(self, start: int, end: int):
        """Record [start, end) as arrived and wake waiting relays."""
        if end <= start:
            return
        with self._cond:
            iv = self._avail
            lo = 0
            while lo < len(iv) and iv[lo][1] < start:
                lo += 1
            hi = lo
            while hi < len(iv) and iv[hi][0] <= end:
                start = min(start, iv[hi][0])
                end = max(end, iv[hi][1])
                hi += 1
            iv[lo:hi] = [[start, end]]
            self._cond.notify_all()

    # -- relay side ----------------------------------------------------

    def _covered(self, start: int, end: int) -> bool:
        # intervals are merged (touching ranges coalesce), so one
        # interval must span the whole query
        if end <= start:
            return True
        for s, e in self._avail:
            if s <= start and e >= end:
                return True
            if s > start:
                return False
        return False

    def wait_covered(self, start: int, end: int,
                     timeout: float) -> str:
        """Block until [start, end) is readable; returns ``"ok"`` (read
        from ``buf``), ``"sealed"`` (read via the store's pinned get),
        ``"aborted"``, or ``"timeout"``."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                if self.state == "sealed":
                    return "sealed"
                if self.state == "aborted":
                    return "aborted"
                if self._covered(start, min(end, self.size)):
                    return "ok"
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cond.wait(remaining):
                    if self.state == "sealed":
                        return "sealed"
                    if self.state == "aborted":
                        return "aborted"
                    if self._covered(start, min(end, self.size)):
                        return "ok"
                    return "timeout"

    def read(self, start: int, end: int) -> Optional[bytes]:
        """Copy [start, end) out of the in-progress buffer; None if the
        pull aborted (buffer gone). The copy happens under the entry
        lock — finish() blocks on it, so the arena slot outlives every
        in-flight read."""
        with self.lock:
            if self.buf is None:
                return None
            return bytes(self.buf[start:end])

    # -- store side ----------------------------------------------------

    def finish(self, sealed: bool):
        with self._cond:
            self.state = "sealed" if sealed else "aborted"
            self.buf = None  # drop the arena view either way: sealed
            self._cond.notify_all()  # readers re-pin via store.get


# The arena mappings of this process's open stores, by base address:
# (size, shm name). ``private_view`` finds a frame's arena through it.
_ARENAS: Dict[int, Tuple[int, str]] = {}


class _PrivateMap(mmap.mmap):
    """A private mapping of part of an arena. ``pinned`` keeps the
    borrow-pinned frame it was made from, and through the borrow-pin
    ledger the arena slot, alive for as long as the mapping is."""

    pinned = None


def private_view(frame: "np.ndarray") -> Optional["np.ndarray"]:
    """A writable uint8 view of ``frame``'s bytes, where ``frame`` lies in
    the arena of one of this process's stores; None where it lies in none
    (or the arena is gone). The view is a private (copy-on-write) mapping
    of the same pages of the arena's file: reads share the arena's pages,
    so nothing is copied, and a write copies only the page it lands on,
    into this mapping alone. Every other reader of the sealed object, in
    this process or another, goes on seeing it unchanged. For consumers
    that cannot be handed read-only memory (torch has no read-only
    tensors)."""
    addr = frame.__array_interface__["data"][0]
    n = frame.nbytes
    for base, (size, name) in list(_ARENAS.items()):
        if base <= addr and addr + n <= base + size:
            off = addr - base
            start = off - off % mmap.ALLOCATIONGRANULARITY
            try:
                fd = os.open(f"/dev/shm/{name}", os.O_RDONLY)
            except OSError:
                return None
            try:
                m = _PrivateMap(fd, off + n - start, flags=mmap.MAP_PRIVATE,
                                prot=mmap.PROT_READ | mmap.PROT_WRITE,
                                offset=start)
            finally:
                os.close(fd)
            m.pinned = frame
            return np.frombuffer(m, dtype=np.uint8, count=n,
                                 offset=off - start)
    return None


class _BorrowEntry:
    """Live zero-copy views of one arena entry: a set of weakrefs to the
    frame-view wrappers handed out by ``get_frames(pin_borrows=True)``,
    plus whether a delete arrived while they were alive."""

    __slots__ = ("refs", "deferred_delete", "nbytes", "deferred_since")

    def __init__(self):
        # list, not set: weakrefs to ndarray views are unhashable
        # (ndarray defines array __eq__); removal is by identity
        self.refs: list = []
        self.deferred_delete = False
        # accounting for memory_stats(): payload bytes the pinned views
        # alias, and when a deferred delete started waiting (monotonic;
        # 0.0 while none is pending) — the deferred-delete-pileup doctor
        # warning ages entries off this stamp
        self.nbytes = 0
        self.deferred_since = 0.0


class ShmObjectStore:
    """One node's shared-memory object store (creator or attacher)."""

    def __init__(self, name: str, capacity: int = 0, create: bool = False):
        self.name = name
        self._cname = name.encode()
        lib = get_lib()
        if create:
            self._h = lib.shm_store_create(self._cname, capacity)
        else:
            self._h = lib.shm_store_attach(self._cname)
        if not self._h:
            raise RuntimeError(
                f"Failed to {'create' if create else 'attach'} shm store {name}")
        self._creator = create
        # Eviction hook: called with the evicted ObjectIDs so the process
        # can report lost copies to the head's object directory
        # (OBJ_LOCATION_REMOVE) — a stale directory entry would otherwise
        # only be discovered by a pull failing over off it.
        self.on_evict: Optional[callable] = None
        # In-progress pull availability (cooperative broadcast): oid ->
        # PartialObject for objects being streamed into unsealed buffers
        # by this process's ObjectPuller, readable by its TransferServer.
        # Aborted entries linger as TOMBSTONES (bounded FIFO) so a
        # relay-marked pull racing the abort fails fast instead of
        # polling the whole serve-wait budget for a buffer that will
        # never come back.
        self._partials: Dict[ObjectID, PartialObject] = {}
        self._aborted: "deque" = deque()
        self._partials_lock = threading.Lock()
        # Borrow-pin ledger (r13 zero-copy device path): consumers of
        # ``get_frames(pin_borrows=True)`` receive out-of-band frames as
        # weakref-able views; while ANY such view (or an array
        # reconstructed over it — numpy's oob unpickling and the
        # device-array rebuild both chain .base to the view) is alive,
        # the ledger holds one extra native pin on the entry, so
        # free/spill/evict can never recycle the arena slot under a
        # live zero-copy alias. A delete() that lands while borrows are
        # live is DEFERRED: it runs when the last view dies (the plasma
        # client's release-on-last-buffer semantics).
        self._borrows: Dict[ObjectID, "_BorrowEntry"] = {}
        self._borrow_lock = threading.Lock()
        # Dead-view processing runs on a dedicated reaper thread, NOT in
        # the weakref callback: callbacks fire from GC on ANY allocation
        # — including allocations made while _borrow_lock is held — and
        # taking the (non-reentrant) lock there would self-deadlock the
        # process. The callback only enqueues (deque.append is atomic)
        # and wakes the reaper; ledger entries stay in the map until the
        # reaper processes them, so a delete() racing the last view's
        # death always finds somewhere to record its deferral.
        self._borrow_reap_q: "deque" = deque()
        self._borrow_reap_wake = threading.Event()
        self._borrow_reap_busy: set = set()  # thread idents mid-release
        self._borrow_reaper: Optional[threading.Thread] = None
        self.borrow_pins_taken = 0
        self.borrow_deferred_deletes = 0
        # Map the segment for data access (metadata is managed by the C side).
        fd = os.open(f"/dev/shm/{name}", os.O_RDWR)
        try:
            self._mmap = mmap.mmap(fd, 0)
        finally:
            os.close(fd)
        probe = np.frombuffer(self._mmap, dtype=np.uint8, count=1)
        self._base = probe.__array_interface__["data"][0]
        del probe
        _ARENAS[self._base] = (len(self._mmap), name)
        self._closed = False
        self._lock = threading.Lock()
        # Populate the arena's tmpfs pages + this process's PTEs in the
        # BACKGROUND, in bounded chunks, for creators AND attachers:
        # lazy faulting costs ~25k minor faults (+ kernel zeroing, for
        # the first toucher) per 100 MiB on first writes — halves
        # measured put bandwidth in whichever process does the writing,
        # usually an attacher. A synchronous whole-arena
        # MADV_POPULATE_WRITE was measured to degrade from 0.2s to ~10s
        # per 512 MiB as populated segments accumulate on the deployment
        # kernel, serializing node registration (many_nodes fell to 0.2
        # nodes/s); chunked + off-thread keeps create/attach O(1).
        threading.Thread(target=self._populate_bg,
                         name=f"shm-populate-{name}",
                         daemon=True).start()

    # Sub-chunk per lock hold: a single madvise of 64 MiB can take ~1s+
    # on the deployment kernel as populated segments accumulate, and
    # close() (node teardown) blocks on this lock — 4 MiB holds keep the
    # worst-case stall in the low milliseconds while costing only ~16x
    # more (cheap) lock round-trips per arena.
    _POPULATE_CHUNK = 4 << 20

    def _populate_bg(self):
        # On kernels without MADV_POPULATE_WRITE this returns immediately
        # and the arena lazy-faults. An explicit page-touch fallback was
        # tried and REJECTED: every attaching process faulting 512 MiB
        # concurrently saturated a small host's cores for ~10 s after
        # init (measured 25x sync-task-latency inflation during the
        # storm), while the free-path's prompt local delete already keeps
        # the large-put cycle on the same warm arena offsets — the
        # steady-state put path never re-faults.
        advice = getattr(mmap, "MADV_POPULATE_WRITE", 23)
        off, total = 0, None
        while True:
            with self._lock:
                if self._closed:
                    return
                try:
                    if total is None:
                        total = len(self._mmap)
                    if off >= total:
                        return
                    n = min(self._POPULATE_CHUNK, total - off)
                    self._mmap.madvise(advice, off, n)
                except (OSError, ValueError):
                    return  # pre-5.14 kernel or racing close: lazy-fault
            off += n

    # -- raw object interface -------------------------------------------------

    def create(self, object_id: ObjectID, data_size: int, meta_size: int = 0
               ) -> memoryview:
        # every native entry point checks _closed: shutdown destroys the
        # C-side handle, and late daemon threads (GC grace timers, event
        # flushers) calling in afterwards would use-after-free it
        if self._closed:
            raise ObjectStoreFullError(f"store {self.name} is closed")
        lib = get_lib()
        off = lib.shm_store_create_object(
            self._h, object_id.binary(), data_size, meta_size)
        if off == -1:
            raise ObjectExistsError(object_id.hex())
        if off == 0:
            # Try eviction, then retry once.
            self.evict(data_size + meta_size)
            off = lib.shm_store_create_object(
                self._h, object_id.binary(), data_size, meta_size)
            if off <= 0:
                raise ObjectStoreFullError(
                    f"store {self.name} full: need {data_size + meta_size}, "
                    f"in use {self.bytes_in_use()}/{self.capacity()}")
        return memoryview(self._mmap)[off:off + data_size + meta_size]

    def seal(self, object_id: ObjectID):
        if self._closed:
            return
        # Finish the partial BEFORE the native seal: an in-flight relay
        # read drains while the entry is still unsealed (unsealed
        # objects are never evicted), so no raw-view copy can overlap
        # the sealed-unpinned window where any thread OR attached
        # process under memory pressure may evict and recycle the slot.
        # Relays that see state=="sealed" re-read through the pinned get
        # path (briefly polling for the native seal to land).
        self._finish_partial(object_id, sealed=True)
        if get_lib().shm_store_seal(self._h, object_id.binary()) != 0:
            raise KeyError(f"seal failed for {object_id.hex()}")

    def get(self, object_id: ObjectID) -> Optional[Tuple[memoryview, memoryview]]:
        """Returns (data, metadata) views, pinning the object; None if absent."""
        if self._closed:
            return None
        out = (ctypes.c_uint64 * 3)()
        rc = get_lib().shm_store_get(self._h, object_id.binary(), out)
        if rc != 0:
            return None
        off, dsize, msize = out[0], out[1], out[2]
        mv = memoryview(self._mmap)
        return mv[off:off + dsize], mv[off + dsize:off + dsize + msize]

    def contains(self, object_id: ObjectID) -> bool:
        if self._closed:
            return False
        return get_lib().shm_store_contains(self._h, object_id.binary()) == 1

    def release(self, object_id: ObjectID):
        if self._closed:
            return
        get_lib().shm_store_release(self._h, object_id.binary())

    def delete(self, object_id: ObjectID) -> bool:
        if self._closed:
            return False
        # An aborted pull (or an explicit free) deletes created-but-
        # unsealed entries; any relay still serving the partial must stop
        # touching the arena view BEFORE the slot is freed for reuse —
        # _finish_partial blocks on in-flight relay reads.
        self._finish_partial(object_id, sealed=False)
        ok = get_lib().shm_store_delete(self._h, object_id.binary()) == 0
        if not ok:
            # pinned — by a reader, or by the borrow ledger's extra pin
            # while zero-copy views are alive. If it's the ledger,
            # DEFER: the delete re-runs when the last view dies, so
            # free/spill racing a live alias pins instead of corrupting.
            # (Entries linger in the map until the reaper thread
            # processes dead views, so this always finds somewhere to
            # record the deferral.)
            retry = False
            with self._borrow_lock:
                entry = self._borrows.get(object_id)
                if entry is not None:
                    if not entry.deferred_delete:
                        entry.deferred_delete = True
                        entry.deferred_since = time.monotonic()
                        self.borrow_deferred_deletes += 1
                else:
                    # no ledger entry: the failing pin may have been the
                    # ledger's, released between the two calls — retry
                    # once so the delete isn't lost to that race
                    retry = True
            if retry:
                ok = get_lib().shm_store_delete(
                    self._h, object_id.binary()) == 0
        return ok

    def evict(self, need: int) -> List[ObjectID]:
        if self._closed:
            return []
        buf = ctypes.create_string_buffer(_ID_SIZE * 256)
        n = get_lib().shm_store_evict(self._h, need, buf, 256)
        evicted = [
            ObjectID(buf.raw[i * _ID_SIZE:(i + 1) * _ID_SIZE]) for i in range(n)
        ]
        if evicted and self.on_evict is not None:
            try:
                self.on_evict(evicted)
            except Exception:  # noqa: BLE001 — directory upkeep must never
                pass           # fail the allocation that triggered eviction
        return evicted

    def bytes_in_use(self) -> int:
        if self._closed:
            return 0
        return get_lib().shm_store_bytes_in_use(self._h)

    def capacity(self) -> int:
        if self._closed:
            return 0
        return get_lib().shm_store_capacity(self._h)

    def num_objects(self) -> int:
        if self._closed:
            return 0
        return get_lib().shm_store_num_objects(self._h)

    def memory_stats(self) -> Dict[str, int]:
        """Arena accounting snapshot — one native call (single lock
        acquisition + table scan) merged with the Python-side borrow
        ledger, cheap enough for the node-telemetry heartbeat. Keys:
        ``capacity`` / ``used_bytes`` (arena blocks incl. headers) /
        ``highwater_bytes`` / ``entries`` / ``sealed_count`` /
        ``sealed_bytes`` (data + frame-size metadata, the arena truth) /
        ``sealed_data_bytes`` (data only — the wire/dir size
        convention, exact vs. the directory's per-object sizes) /
        ``unsealed_count`` / ``unsealed_bytes`` /
        ``pinned_count`` / ``pinned_bytes`` (native reader pins) /
        ``borrow_pinned_count`` / ``borrow_pinned_bytes`` (zero-copy
        views alive in THIS process) / ``deferred_deletes`` (pending) /
        ``deferred_delete_oldest_s`` (age of the oldest one)."""
        if self._closed:
            return {}
        out = (ctypes.c_uint64 * 11)()
        get_lib().shm_store_memory_stats(self._h, out)
        borrow_count = borrow_bytes = 0
        deferred = 0
        oldest = 0.0
        now = time.monotonic()
        with self._borrow_lock:
            for entry in self._borrows.values():
                borrow_count += 1
                borrow_bytes += entry.nbytes
                if entry.deferred_delete:
                    deferred += 1
                    oldest = max(oldest, now - entry.deferred_since)
        return {
            "capacity": int(out[0]),
            "used_bytes": int(out[1]),
            "highwater_bytes": int(out[2]),
            "entries": int(out[3]),
            "sealed_count": int(out[4]),
            "sealed_bytes": int(out[5]),
            "sealed_data_bytes": int(out[10]),
            "unsealed_count": int(out[6]),
            "unsealed_bytes": int(out[7]),
            "pinned_count": int(out[8]),
            "pinned_bytes": int(out[9]),
            "borrow_pinned_count": borrow_count,
            "borrow_pinned_bytes": borrow_bytes,
            "deferred_deletes": deferred,
            "deferred_delete_oldest_s": oldest,
        }

    def list_objects(self, max_objects: int = 8192
                     ) -> List[Tuple[ObjectID, int]]:
        """Sealed objects currently in the arena as ``[(ObjectID,
        data+meta bytes)]`` — the holder report a re-registering node
        agent ships so a restarted head can rebuild its object directory
        from holder truth (the directory is deliberately not WAL'd)."""
        if self._closed:
            return []
        ids = ctypes.create_string_buffer(_ID_SIZE * max_objects)
        sizes = (ctypes.c_uint64 * max_objects)()
        n = get_lib().shm_store_list(self._h, ids, sizes, max_objects)
        return [(ObjectID(ids.raw[i * _ID_SIZE:(i + 1) * _ID_SIZE]),
                 int(sizes[i])) for i in range(n)]

    # -- in-progress pull availability (cooperative broadcast) ---------------

    def begin_partial(self, object_id: ObjectID, buf: memoryview,
                      size: int, meta: bytes) -> PartialObject:
        """Register an in-progress pull's unsealed buffer so this host's
        TransferServer can relay chunks as they arrive. The entry is
        finished automatically by ``seal`` (promoted) or ``delete``
        (aborted) of the same id."""
        part = PartialObject(object_id, buf, size, bytes(meta))
        with self._partials_lock:
            self._partials[object_id] = part
        return part

    def partial(self, object_id: ObjectID) -> Optional[PartialObject]:
        with self._partials_lock:
            return self._partials.get(object_id)

    _ABORT_TOMBSTONES = 256

    def _finish_partial(self, object_id: ObjectID, sealed: bool):
        with self._partials_lock:
            part = self._partials.get(object_id)
            if part is None or part.state == "aborted":
                return  # unknown, or already a tombstone
            if sealed:
                del self._partials[object_id]
            else:
                # leave the aborted entry queryable: a relay request
                # racing the abort gets an immediate "aborted" (->
                # OBJ_PULL_FAIL -> root failover) instead of burning
                # the full appear-wait poll. A re-pull's begin_partial
                # simply overwrites the tombstone.
                self._aborted.append((object_id, part))
                if len(self._aborted) > self._ABORT_TOMBSTONES:
                    old_oid, old_part = self._aborted.popleft()
                    if self._partials.get(old_oid) is old_part:
                        del self._partials[old_oid]
        part.finish(sealed)

    # -- serialized-value interface ------------------------------------------

    @staticmethod
    def sealed_nbytes(frames: List) -> int:
        """The exact payload bytes (data + metadata) put_serialized
        would seal for these frames — what the native entry's
        data_size + meta_size will read, and therefore what the head
        directory must record for per-node byte attribution to agree
        exactly with the store's own memory_stats()."""
        sizes = [len(f) for f in frames]
        return sum(sizes) + len(pickle.dumps(sizes, protocol=5))

    def put_serialized(self, object_id: ObjectID, frames: List) -> int:
        """Serialize-into-store put: reserve the shm object from a cheap
        size pass over the frames, then write the pickle stream and each
        out-of-band buffer straight into the mapped memoryview — frames
        are memoryviews of the source object's memory (serialization.py),
        so every byte moves exactly once, source to arena. Returns the
        sealed object's byte count."""
        sizes = [len(f) for f in frames]
        meta = pickle.dumps(sizes, protocol=5)
        total = sum(sizes)
        buf = self.create(object_id, total, len(meta))
        pos = 0
        for f, n in zip(frames, sizes):
            if n > (1 << 20):
                # numpy's vectorized copy moves ~2x the bytes/s of a Python
                # memoryview slice assignment — this IS the put-bandwidth
                # benchmark for large objects.
                np.copyto(np.frombuffer(buf[pos:pos + n], np.uint8),
                          np.frombuffer(f, np.uint8))
            else:
                buf[pos:pos + n] = f
            pos += n
        buf[total:] = meta
        self.seal(object_id)
        return total + len(meta)

    def put_raw(self, object_id: ObjectID, data: bytes) -> int:
        """Store raw bytes with NO metadata — the cross-language payload
        convention shared with the C++ client (native/ray_tpu_client.h);
        pickled Python objects use put_serialized instead."""
        buf = self.create(object_id, len(data), 0)
        buf[:len(data)] = data
        self.seal(object_id)
        return len(data)

    def get_raw(self, object_id: ObjectID) -> Optional[bytes]:
        """Raw-convention read (copies out + releases the pin)."""
        got = self.get(object_id)
        if got is None:
            return None
        data_v, meta_v = got
        try:
            return bytes(data_v)
        finally:
            del data_v, meta_v, got
            self.release(object_id)

    def get_frames(self, object_id: ObjectID, pin_borrows: bool = False
                   ) -> Optional[List]:
        """Frame views over the sealed entry (pins the object — the
        caller owns one ``release``). With ``pin_borrows``, out-of-band
        frames come back as weakref-able ndarray views registered with
        the borrow ledger: deserialized arrays that alias them (numpy
        oob reconstruction, the device-array rebuild) keep the views —
        and therefore one extra native pin on the entry — alive, so a
        racing free/spill defers instead of recycling the slot under
        the consumer (zero-copy read safety)."""
        got = self.get(object_id)
        if got is None:
            return None
        data, meta = got
        sizes = pickle.loads(bytes(meta))
        frames, pos = [], 0
        for s in sizes:
            frames.append(data[pos:pos + s])
            pos += s
        if pin_borrows and len(frames) > 1:
            wrapped = []
            for f in frames[1:]:
                w = np.frombuffer(f, dtype=np.uint8)
                # READONLY, like the reference plasma client's sealed
                # buffers: consumers alias SHARED arena memory, and an
                # in-place `arr *= 2` must raise, not silently corrupt
                # the object for every other reader (the device rebuild
                # copies on readonly via its dlpack fallback)
                w.setflags(write=False)
                wrapped.append(w)
            self._register_borrows(object_id, wrapped)
            frames = [frames[0]] + wrapped
        return frames

    # -- borrow-pin ledger (zero-copy read safety) ---------------------

    def _register_borrows(self, object_id: ObjectID, views: List):
        """One extra native pin per object-with-borrows, held until the
        last registered view dies (processed by the reaper thread)."""
        if self._closed:
            return
        with self._borrow_lock:
            if self._borrow_reaper is None:
                self._borrow_reaper = threading.Thread(
                    target=self._borrow_reap_loop, daemon=True,
                    name=f"borrow-reap-{self.name}")
                self._borrow_reaper.start()
            entry = self._borrows.get(object_id)
            fresh = entry is None
            if fresh:
                entry = self._borrows[object_id] = _BorrowEntry()
            for v in views:
                entry.refs.append(weakref.ref(
                    v, lambda r, oid=object_id: self._borrow_dead(oid, r)))
            if fresh:
                entry.nbytes = sum(len(v) for v in views)
        if fresh:
            # the ledger's own pin (independent of the caller's read
            # pin): bump the native refcount, drop the views
            out = (ctypes.c_uint64 * 3)()
            if get_lib().shm_store_get(self._h, object_id.binary(),
                                       out) == 0:
                self.borrow_pins_taken += 1
            else:  # entry vanished between get_frames' get and here
                with self._borrow_lock:
                    self._borrows.pop(object_id, None)

    def _borrow_dead(self, object_id: ObjectID, ref):
        """Weakref callback — runs inside GC, possibly on a thread that
        already holds _borrow_lock (callbacks fire on any allocation):
        must not lock or call into the native store. Enqueue only."""
        self._borrow_reap_q.append((object_id, ref))
        self._borrow_reap_wake.set()

    def _borrow_reap_loop(self):
        while not self._closed:
            self._borrow_reap_wake.wait(timeout=5.0)
            self._borrow_reap_wake.clear()
            self._drain_borrow_queue()

    def _drain_borrow_queue(self):
        """Process dead-view notifications: prune the ledger, release
        the pin when the last view of an object dies, and run any
        delete() that was deferred while views were alive. Safe to call
        from any thread (items pop atomically; the ledger mutates under
        its lock) — ``reap_borrows`` shares it with the reaper."""
        me = threading.get_ident()
        while True:
            with self._borrow_lock:
                try:
                    object_id, ref = self._borrow_reap_q.popleft()
                except IndexError:
                    return
                # mark in-progress UNDER the lock that popped the item:
                # reap_borrows must not observe empty-queue-and-idle
                # while another thread is mid-release
                self._borrow_reap_busy.add(me)
            try:
                do_delete = False
                with self._borrow_lock:
                    entry = self._borrows.get(object_id)
                    if entry is None:
                        continue
                    entry.refs = [r for r in entry.refs if r is not ref]
                    if entry.refs:
                        continue
                    del self._borrows[object_id]
                    do_delete = entry.deferred_delete
                if self._closed:
                    return
                self.release(object_id)
                if do_delete:
                    # plain native delete: the entry is sealed (no
                    # partial can exist) and delete() would re-consult
                    # the ledger entry just removed. A transient reader
                    # pin (a get() in flight on another thread) can
                    # fail it — retry briefly; past that, reclamation
                    # falls back to the normal directory-driven
                    # free/eviction paths (same contract as the
                    # owner-free local-delete optimization).
                    for _ in range(5):
                        if get_lib().shm_store_delete(
                                self._h, object_id.binary()) == 0:
                            break
                        time.sleep(0.01)
                        if self._closed:
                            return
            finally:
                with self._borrow_lock:
                    self._borrow_reap_busy.discard(me)

    def reap_borrows(self, timeout: float = 2.0) -> None:
        """Synchronously process every already-dead view's notification
        (the reaper thread normally does this asynchronously) — for
        tests and teardown paths that need deterministic reclamation."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self._drain_borrow_queue()
            with self._borrow_lock:
                if not self._borrow_reap_q and \
                        not self._borrow_reap_busy:
                    return
            time.sleep(0.001)

    def live_borrows(self, object_id: ObjectID) -> int:
        """How many zero-copy views of this entry are still alive."""
        with self._borrow_lock:
            entry = self._borrows.get(object_id)
            if entry is None:
                return 0
            return sum(1 for r in entry.refs if r() is not None)

    def close(self):
        if self._closed:
            return
        # wake + detach any relayed in-progress pulls first: a live
        # partial's arena view would BufferError the munmap below
        with self._partials_lock:
            parts, self._partials = list(self._partials.values()), {}
        for p in parts:
            p.finish(sealed=False)
        # _lock serializes against an in-flight background populate
        # chunk: munmap under a concurrent madvise would be a
        # use-after-free of the mapping
        with self._lock:
            if self._closed:
                return
            self._closed = True
            _ARENAS.pop(self._base, None)
            try:
                self._mmap.close()
            except BufferError:
                pass  # zero-copy views still alive; leave the map
        lib = get_lib()
        if self._creator:
            lib.shm_store_destroy(self._h, self._cname)
        else:
            lib.shm_store_detach(self._h)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
