"""Peer-to-peer chunked object transfer between hosts.

Ref analog: src/ray/object_manager/ — the reference's per-node
ObjectManager serves 5 MiB chunk pulls directly between raylets
(object_manager.proto, pull_manager.cc) so object payloads never transit
the GCS. Same shape here: every host (each node agent, plus the head on
behalf of its in-process nodes) runs a ``TransferServer`` — a dedicated
TCP listener streaming objects out of the local shm arena in ~1 MiB raw
frames — and an ``ObjectPuller`` that connects straight to a peer's
server and writes arriving chunks into the local arena. The head only
brokers *who pulls from whom* (it hands the destination the holder set's
transfer addresses); payload bytes never touch head memory (asserted by
tests via the head's relay-byte counter).

Multi-source striped pulls (the reference's PullManager fan-out): when
the directory reports several holders and the object is large, the
puller opens connections to up to ``pull_max_sources`` of them and
requests disjoint contiguous ranges from each. Every chunk header
carries its absolute offset, so writes route into one arena buffer
regardless of which source they rode in on. A source dying mid-pull
fails only its remaining range: the tail it never delivered is
re-requested from a surviving holder instead of failing the pull.

Wire flow (all frames on a direct peer<->peer connection):
    puller -> server   OBJ_PULL (oid, start, length, wait_s, tag)  one-way
    server -> puller   OBJ_PULL_META (oid, size|-1, meta, tag)     create buffer
    server -> puller   OBJ_PULL_CHUNK (oid, off, tag) + RAW  x N   (atomic pair)
    server -> puller   OBJ_PULL_DONE (oid, start, length, tag)     range complete

``tag`` names the pull attempt (one per leader ``pull()``) and every reply
echoes it: a serve keeps streaming after its pull was aborted, and on the
shared connection its late frames would otherwise reach the NEXT pull of
the same object — a late DONE sealed the new entry before its chunks
arrived (wrong bytes from the second chunk on). Replies whose tag is not
the current pull's are dropped.

Every buffer mutation happens on the puller's single IO thread, in stream
order — META creates the arena buffer before any chunk of that object can
be dispatched, so there is no allocation/arrival race by construction.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from . import protocol as P
from .config import get_config
from .ids import ObjectID
from .object_store import ObjectExistsError, ShmObjectStore


class TransferServer:
    """Serves OBJ_PULL range requests for objects in local shm arenas.

    ``read_fn(oid) -> (data_memoryview, meta_bytes, release_cb) | None``
    abstracts over "one agent store" vs "the head's local node stores".
    ``partial_fn(oid) -> PartialObject | None`` (optional) exposes this
    host's IN-PROGRESS pulls: with it, a pull the head routed at an
    in-progress location streams each chunk as soon as the local puller
    lands it (cooperative pipelined broadcast) instead of failing fast —
    the serving side of the reference PullManager's chunked re-serving.
    """

    def __init__(self, io: P.IOLoop, read_fn: Callable, host: str = "",
                 advertise_ip: str = "", partial_fn: Callable = None):
        self._read_fn = read_fn
        self._partial_fn = partial_fn
        self._listener = P.listen_tcp(host or "0.0.0.0", 0)
        port = self._listener.getsockname()[1]
        ip = advertise_ip or P.local_ip()
        self.addr = f"tcp:{ip}:{port}"
        self._io = io
        # per-chunk pause, settable by tests/chaos tooling to exercise the
        # mid-pull source-failure path deterministically
        self.throttle_s = 0.0
        # Per-HOST egress token bucket: every concurrent serve on this
        # host — all objects, all downstream pullers, root and relay
        # streams alike — drains this one bucket (0 = unlimited).
        # Seeded from ``host_egress_limit_bps``: broadcast_fanout's
        # per-object load accounting cannot stop K concurrent
        # broadcasts of K DIFFERENT objects stacking K x fanout streams
        # on one uplink (the r9 caveat); this bucket caps what actually
        # leaves the NIC no matter how many trees the planner built
        # through this host. Benches/tests also set it directly for
        # shared-uplink emulation.
        self.egress_limit_bps = get_config().host_egress_limit_bps
        self._pace_lock = threading.Lock()
        self._pace_t = 0.0
        # observability: requests served + egress bytes, split by source
        # role — "root" streams a sealed local copy, "relay" re-serves an
        # in-progress pull's chunks as they arrive. Guarded by
        # _stats_lock: serve threads run concurrently and a bare += on
        # the byte counters would lose increments (pull_requests alone
        # is IO-thread-only).
        self.pull_requests = 0
        self.served_root = 0
        self.served_relay = 0
        self.bytes_served = 0
        self.relay_bytes_served = 0
        self._stats_lock = threading.Lock()
        io.add_listener(self._listener, self._on_accept)

    def _on_accept(self, sock, _addr):
        sock.setsockopt(P.socket.IPPROTO_TCP, P.socket.TCP_NODELAY, 1)
        conn = P.Connection(sock, peer="xfer-client")
        self._io.add_connection(conn, self._on_message)

    def _on_message(self, conn: P.Connection, msg):
        if msg[0] != P.OBJ_PULL:
            return
        start = msg[3] if len(msg) > 3 else 0
        length = msg[4] if len(msg) > 4 else -1
        # clamp the peer-supplied wait once at the boundary: it is both
        # the appear-window and the per-chunk relay budget, and a rogue
        # value must not park serve threads forever
        wait_s = min(float(msg[5]), 120.0) if len(msg) > 5 else 0.0
        tag = msg[6] if len(msg) > 6 else None
        self.pull_requests += 1  # sole writer: this IO thread
        # Stream on a side thread: a multi-GiB send must not wedge the IO
        # loop that every other connection on this host shares. Concurrent
        # pulls on one connection are safe: each chunk's header+raw pair is
        # sent atomically (send_with_raw), and the puller writes by the
        # (oid, offset) in each header.
        threading.Thread(target=self._serve_pull,
                         args=(conn, msg[2], start, length, wait_s, tag),
                         daemon=True).start()

    def _pace(self, nbytes: int):
        """Debit the shared egress bucket; sleeps the calling serve
        thread until its chunk's slot on the emulated uplink."""
        if not self.egress_limit_bps:
            return
        with self._pace_lock:
            now = time.monotonic()
            self._pace_t = max(self._pace_t, now) + \
                nbytes / self.egress_limit_bps
            wait = self._pace_t - now
        if wait > 0:
            time.sleep(wait)

    def _lookup(self, oid: ObjectID, wait_s: float):
        """-> (sealed_read | None, partial | None). With ``wait_s`` > 0
        the directory PROMISED this object is headed here (the local
        pull is in flight): poll briefly for the buffer to materialize
        instead of failing fast — a plain pull off a stale directory
        entry (wait_s == 0) keeps the old immediate-failover behavior."""
        got = self._read_fn(oid)
        if got is not None:
            return got, None
        if wait_s <= 0:
            # plain pull (e.g. a stale-directory probe): never serve a
            # partial — chunk-by-chunk dribble behind a slow upstream is
            # strictly worse than the immediate failover to a live
            # sealed holder the META -1 reply triggers
            return None, None
        part = self._partial_fn(oid) if self._partial_fn else None
        if part is not None:
            return None, part
        deadline = time.monotonic() + wait_s
        pause = 0.005
        while time.monotonic() < deadline:
            time.sleep(pause)
            # back off: the promised buffer usually appears within tens
            # of ms, but N waiters polling fast for the full budget
            # would hammer read_fn/partial_fn's locks (on the head,
            # that's the global head lock)
            pause = min(pause * 1.5, 0.1)
            got = self._read_fn(oid)
            if got is not None:
                return got, None
            part = self._partial_fn(oid) if self._partial_fn else None
            if part is not None:
                return None, part
        return None, None

    def _serve_pull(self, conn: P.Connection, oid_bin: bytes,
                    start: int = 0, length: int = -1, wait_s: float = 0.0,
                    tag=None):
        oid = ObjectID(oid_bin)
        try:
            got, part = self._lookup(oid, wait_s)
            if got is None and part is not None and \
                    part.state != "aborted":
                self._serve_partial(conn, oid, oid_bin, part, start,
                                    length, wait_s, tag)
                return
            if got is None:
                # absent — or an aborted-pull tombstone: either way the
                # requester should fail over to another source NOW
                conn.send(P.OBJ_PULL_META, oid_bin, -1, b"", tag)
                return
            data, meta, release = got
            try:
                # META always reports the FULL object size + meta so any
                # one source's reply lets the puller size the arena buffer
                conn.send(P.OBJ_PULL_META, oid_bin, len(data), bytes(meta),
                          tag)
                end = len(data) if length < 0 else min(start + length,
                                                       len(data))
                with self._stats_lock:
                    self.served_root += 1
                self._stream_range(conn, oid_bin, data, start, end,
                                   relay=False, tag=tag)
                # echo the REQUESTED range so the puller can match it even
                # when length was -1 (open-ended)
                conn.send(P.OBJ_PULL_DONE, oid_bin, start, length, tag)
                self._count_serve("root", max(end - start, 0))
            finally:
                release()
        except P.ConnectionLost:
            pass

    def _stream_range(self, conn: P.Connection, oid_bin: bytes, data,
                      start: int, end: int, relay: bool, tag=None):
        """Chunk-stream ``data[start:end]`` — ~1 MiB chunks so each
        typically completes within one receiver recv() buffer, hitting
        feed()'s zero-copy fast path (protocol.py). Sealed-view slices
        ship straight from the shm arena — no serialization copies."""
        cs = min(get_config().object_transfer_chunk_bytes, 1 << 20)
        for off in range(start, end, cs):
            self._send_chunk(conn, oid_bin, off, data[off:off + min(
                cs, end - off)], relay, tag)

    def _send_chunk(self, conn: P.Connection, oid_bin: bytes, off: int,
                    chunk, relay: bool, tag=None):
        """One chunk's egress: throttle, shared-uplink pacing, the
        atomic header+raw pair, byte accounting — the single sequence
        every serve path (sealed stream AND relay) must share."""
        if self.throttle_s:
            time.sleep(self.throttle_s)
        self._pace(len(chunk))
        conn.send_with_raw(P.OBJ_PULL_CHUNK, oid_bin, off, tag, raw=chunk)
        self._count_bytes(len(chunk), relay)

    def _count_bytes(self, n: int, relay: bool):
        with self._stats_lock:
            self.bytes_served += n
            if relay:
                self.relay_bytes_served += n

    def _serve_partial(self, conn: P.Connection, oid: ObjectID,
                       oid_bin: bytes, part, start: int, length: int,
                       wait_s: float, tag=None):
        """Relay an in-progress pull: stream each requested chunk the
        moment the local puller has it. If the local pull seals mid-
        relay, finish from the sealed copy (pinned); if it aborts or
        stalls past the wait budget, hand the UNDELIVERED tail back with
        OBJ_PULL_FAIL so the requester re-pulls it from the root holder
        set (relay-aware failover)."""
        size = part.size
        conn.send(P.OBJ_PULL_META, oid_bin, size, part.meta, tag)
        end = size if length < 0 else min(start + length, size)
        with self._stats_lock:
            self.served_relay += 1
        cs = min(get_config().object_transfer_chunk_bytes, 1 << 20)
        budget = max(wait_s, 1.0)
        off = start
        sealed = False
        while off < end:
            n = min(cs, end - off)
            status = part.wait_covered(off, off + n, budget)
            if status == "sealed":
                sealed = True
                break
            chunk = part.read(off, off + n) if status == "ok" else None
            if chunk is None:
                if part.state == "sealed":
                    # seal landed between wait_covered and read (finish
                    # dropped the buffer): the object is HERE, whole —
                    # switch to the sealed copy, don't fail the range
                    sealed = True
                    break
                # aborted or stalled past the wait budget
                conn.send(P.OBJ_PULL_FAIL, oid_bin, off, tag)
                self._count_serve("relay", max(off - start, 0))
                return
            self._send_chunk(conn, oid_bin, off, chunk, relay=True, tag=tag)
            off += n
        if sealed and off < end:
            # the partial is finished just BEFORE the native seal lands
            # (object_store.seal's eviction-safe ordering), so the
            # pinned read can trail the sealed flag by a moment — poll
            # briefly before declaring the copy gone (evicted)
            got = self._read_fn(oid)
            deadline = time.monotonic() + 2.0
            while got is None and time.monotonic() < deadline:
                time.sleep(0.002)
                got = self._read_fn(oid)
            if got is None:  # sealed copy evicted before we switched over
                conn.send(P.OBJ_PULL_FAIL, oid_bin, off, tag)
                self._count_serve("relay", max(off - start, 0))
                return
            data, _meta, release = got
            try:
                self._stream_range(conn, oid_bin, data, off, end,
                                   relay=True, tag=tag)
            finally:
                release()
        conn.send(P.OBJ_PULL_DONE, oid_bin, start, length, tag)
        self._count_serve("relay", max(end - start, 0))

    def _count_serve(self, role: str, nbytes: int):
        try:
            from ray_tpu_torch.metrics import object_plane_metrics

            m = object_plane_metrics()
            tags = {"role": role}
            m["serves"].inc(1, tags)
            m["serve_bytes"].inc(nbytes, tags)
        except Exception:  # noqa: BLE001 — metrics must never fail a serve
            pass

    def close(self):
        try:
            self._io.remove(self._listener)
            self._listener.close()
        except OSError:
            pass


def send_eviction_report(head_conn, node_idx: int, oids) -> None:
    """One batched one-way OBJ_LOCATION_REMOVE dropping ``node_idx`` from
    the evicted objects' holder sets (best-effort: a missed report just
    means one extra pull failover off a stale directory entry)."""
    oid_bins = [oid.binary() for oid in oids]
    if not oid_bins:
        return
    try:
        head_conn.send(P.OBJ_LOCATION_REMOVE, oid_bins, node_idx)
    except P.ConnectionLost:
        pass


def send_eviction_report_async(head_conn, node_idx: int, oids) -> None:
    """Same, from a short-lived thread: evict() fires inside store.create
    on whatever thread is allocating — the puller IO thread included —
    and must never block there on a head socket write."""
    oids = list(oids)
    threading.Thread(target=send_eviction_report,
                     args=(head_conn, node_idx, oids), daemon=True).start()


class _Range:
    """One contiguous byte range assigned to one source."""

    __slots__ = ("start", "length", "received", "addr", "done")

    def __init__(self, start: int, length: int, addr: str):
        self.start = start
        self.length = length  # -1 = through end (size unknown at request)
        self.received = 0     # chunks per range arrive in order
        self.addr = addr
        self.done = False


class _PullState:
    __slots__ = ("buf", "done", "error", "buf_lock", "size", "ranges",
                 "conns", "addrs", "failed_addrs", "started",
                 "planned_sources", "max_sources", "relay_addrs", "part",
                 "prefetch", "joined", "tag")

    def __init__(self, tag: int = 0):
        # this pull attempt's id, sent with each OBJ_PULL and echoed by
        # every reply: frames of an earlier (aborted) attempt at the same
        # object are told apart by it and dropped
        self.tag = tag
        # speculative-prefetch bookkeeping (r13): ``prefetch`` marks a
        # pull the head fired ahead of demand at lease grant/dispatch;
        # ``joined`` flips when a demand get() attaches to it via the
        # _pending leadership below — a joined prefetch is real work
        # and must no longer be abortable
        self.prefetch = False
        self.joined = False
        self.buf = None
        self.done = threading.Event()
        self.error: Optional[str] = None
        self.size = -1  # full object size, set by the first META
        self.planned_sources = 0  # stripe width at plan time (not failover)
        self.ranges: List[_Range] = []
        self.conns: Dict[P.Connection, str] = {}  # participating sources
        self.addrs: List[str] = []                # every candidate source
        self.failed_addrs: set = set()
        self.started = False
        self.max_sources = 0       # planner-imposed stripe cap (0 = config)
        self.relay_addrs: frozenset = frozenset()  # in-progress sources
        self.part = None  # local chunk-availability map (relay serving)
        # serializes chunk writes + range bookkeeping against the abort
        # path's buf=None + arena delete and against source reassignment —
        # a copy into a freed (and possibly reallocated) arena slot would
        # corrupt another object
        self.buf_lock = threading.Lock()


class ObjectPuller:
    """Pulls objects from peers' TransferServers into a local shm store.

    ``pull`` accepts one address or a holder list; with several holders
    and a known size, disjoint ranges are striped across up to
    ``pull_max_sources`` concurrent connections (PullManager analog).
    """

    def __init__(self, io: P.IOLoop, store: ShmObjectStore):
        self._io = io
        self._store = store
        self._conns: Dict[str, P.Connection] = {}
        self._pending: Dict[ObjectID, _PullState] = {}
        # per-connection (oid, offset) the next RAW frame belongs to —
        # send_with_raw guarantees the raw frame directly follows its header
        self._expect: Dict[P.Connection, Tuple[ObjectID, int, Any]] = {}
        self._lock = threading.Lock()
        self._tags = itertools.count(1)
        # cumulative observability counters (all written on the IO thread
        # or under pull()'s completion path; read by tests/metrics)
        self.bytes_by_source: Dict[str, int] = {}
        self.pulls_completed = 0
        self.multi_source_pulls = 0
        self.source_failovers = 0
        # demand get()s that attached to an in-flight prefetch pull
        # instead of starting cold (the r13 overlap actually observed)
        self.prefetch_joins = 0

    def _peer(self, addr: str) -> P.Connection:
        with self._lock:
            conn = self._conns.get(addr)
            if conn is not None and not conn.closed:
                return conn
        sock = P.connect_addr(addr)
        conn = P.Connection(sock, peer=f"xfer:{addr}")
        conn.on_close = self._on_conn_close
        self._io.add_connection(conn, self._on_message)
        with self._lock:
            self._conns[addr] = conn
        return conn

    def pull(self, oid: ObjectID,
             peer_addr: Union[str, Sequence[str]],
             timeout: float = 120.0, size_hint: int = -1,
             max_sources: int = 0,
             relay_addrs: Sequence[str] = (),
             prefetch: bool = False) -> bool:
        """Blocking: fetch ``oid`` into the local store.

        ``peer_addr`` is one transfer address or the holder list from the
        object directory; ``size_hint`` (the directory's recorded size)
        enables striping without a metadata round trip. ``max_sources``
        caps the stripe width below ``pull_max_sources`` (the head's
        broadcast planner sets 1 so a relay-served pull never also
        stripes the root set — later addrs stay failover-only);
        ``relay_addrs`` marks which candidates are IN-PROGRESS pullers:
        their OBJ_PULLs carry the broadcast serve-wait budget so the
        relay subscribes us to chunk arrival instead of failing fast.
        ``prefetch`` marks a head-speculated pull (fired at lease
        grant/dispatch, ahead of any worker demand): it is abortable via
        ``abort()`` until a demand pull() joins it.
        """
        if self._store.contains(oid):
            return True
        addrs = [peer_addr] if isinstance(peer_addr, str) else \
            [a for a in peer_addr if a]
        addrs = list(dict.fromkeys(addrs))
        if not addrs:
            return False
        if size_hint <= 0:
            # a directory entry can carry size 0 before its true size is
            # learned — that means UNKNOWN, not zero-length (a requested
            # (0, 0) range would stream no bytes yet still seal)
            size_hint = -1
        with self._lock:
            st = self._pending.get(oid)
            if st is not None:
                leader = False
                if not prefetch and not st.joined:
                    # a demand get() attaching to an in-flight pull: if
                    # the leader was speculative, the join makes it real
                    # work (no longer abortable) — THE r13 overlap: the
                    # prefetch ran while dispatch was in flight and the
                    # worker's arg fetch starts warm
                    st.joined = True
                    if st.prefetch:
                        self.prefetch_joins += 1
            else:
                st = self._pending[oid] = _PullState(next(self._tags))
                st.max_sources = max_sources
                st.relay_addrs = frozenset(relay_addrs)
                st.prefetch = prefetch
                leader = True
        if not leader:  # another thread is already pulling this object
            st.done.wait(timeout)
            return st.error is None and self._store.contains(oid)
        t0 = time.monotonic()
        try:
            self._start_pull(st, oid, addrs, size_hint)
            if st.error is None and not st.done.wait(timeout):
                st.error = "pull timed out"
        except P.ConnectionLost as e:
            st.error = str(e)
        finally:
            if st.error is not None and not self._store.contains(oid):
                # never leave a created-but-unsealed entry behind: it would
                # poison every retry (create fails on existing ids) while
                # readers block forever on an object that never seals.
                # buf_lock: an in-flight chunk copy must finish before the
                # arena slot is freed. Delete BEFORE dropping the _pending
                # entry: while we hold it no retry can become leader, so
                # this delete can never land on a retry's fresh buffer
                # (the reclaim in the META handler would otherwise race).
                with st.buf_lock:
                    st.buf = None
                    self._store.delete(oid)
            with self._lock:
                self._pending.pop(oid, None)
            st.done.set()
        ok = st.error is None
        if ok:
            self._record_pull(st, time.monotonic() - t0)
        return ok

    def _send_pull_req(self, conn: P.Connection, st: _PullState,
                       oid: ObjectID, start: int, length: int, addr: str):
        """OBJ_PULL with the serve-wait budget when the target is an
        in-progress relay (it subscribes us to chunk arrival) and the
        old fail-fast zero for sealed holders."""
        wait_s = get_config().broadcast_serve_wait_s \
            if addr in st.relay_addrs else 0.0
        conn.send(P.OBJ_PULL, oid.binary(), start, length, wait_s, st.tag)

    def _start_pull(self, st: _PullState, oid: ObjectID,
                    addrs: List[str], size_hint: int):
        cfg = get_config()
        st.addrs = list(addrs)
        width = min(st.max_sources or cfg.pull_max_sources,
                    cfg.pull_max_sources)
        conns: List[Tuple[P.Connection, str]] = []
        for a in addrs:  # backfill past unreachable holders
            if len(conns) >= max(1, width):
                break
            try:
                conns.append((self._peer(a), a))
            except OSError:
                st.failed_addrs.add(a)
        if not conns:
            st.error = "no reachable sources"
            return
        with st.buf_lock:
            if size_hint >= max(cfg.pull_min_stripe_bytes, 1) and \
                    len(conns) > 1:
                # contiguous stripes, chunk-aligned so server-side chunking
                # stays on chunk boundaries
                cs = min(cfg.object_transfer_chunk_bytes, 1 << 20)
                per = ((size_hint + len(conns) - 1) // len(conns)
                       + cs - 1) // cs * cs
                start = 0
                for conn, addr in conns:
                    if start >= size_hint:
                        break
                    length = min(per, size_hint - start)
                    st.ranges.append(_Range(start, length, addr))
                    st.conns[conn] = addr
                    start += length
            else:
                conn, addr = conns[0]
                st.ranges.append(_Range(0, size_hint if size_hint >= 0
                                        else -1, addr))
                st.conns[conn] = addr
            st.started = True
            st.planned_sources = len({r.addr for r in st.ranges})
            plan = [(c, a, r) for r in st.ranges
                    for c, a in conns if a == r.addr]
        for conn, addr, r in plan:
            try:
                self._send_pull_req(conn, st, oid, r.start, r.length, addr)
            except P.ConnectionLost:
                # the IO loop may not have noticed the death yet — run the
                # failover path ourselves (idempotent with on_close)
                self._handle_conn_failure(conn)

    def _record_pull(self, st: _PullState, latency_s: float):
        # planned stripe width, NOT len({r.addr}): a failover replacement
        # range adds a second addr without the sources ever streaming
        # concurrently — counting it would conflate failover with striping
        n_sources = st.planned_sources or 1
        self.pulls_completed += 1
        if n_sources > 1:
            self.multi_source_pulls += 1
        try:
            from ray_tpu_torch.metrics import object_plane_metrics

            m = object_plane_metrics()
            tags = {"source_count": str(n_sources)}
            m["pulls"].inc(1, tags)
            m["pull_bytes"].inc(max(st.size, 0), tags)
            m["pull_latency"].observe(latency_s)
        except Exception:  # noqa: BLE001 — metrics must never fail a pull
            pass
        # comm-aware timeline (r19): transfers worth analyzing land as
        # retroactive comm.* spans — stamped once at completion so the
        # streaming path itself carries no tracing work. Small control
        # objects stay off the ring (transfer_span_min_bytes); node
        # agents (no CoreContext) no-op inside record_comm_span.
        try:
            if st.size >= get_config().transfer_span_min_bytes:
                from ray_tpu_torch import tracing

                kind = "prefetch" if st.prefetch and not st.joined \
                    else "pull"
                now_m, now_w = time.monotonic(), time.time()
                tracing.record_comm_span(
                    f"{kind}.{n_sources}src", now_w - latency_s, now_w,
                    now_m - latency_s, now_m)
        except Exception:  # noqa: BLE001 — tracing must never fail a pull
            pass

    # ---- everything below runs on the IO thread, in stream order ----

    def _current(self, oid: ObjectID, tag) -> Optional[_PullState]:
        """The pending pull of ``oid`` if a reply tagged ``tag`` belongs
        to it; None for a reply to an earlier, finished attempt."""
        with self._lock:
            st = self._pending.get(oid)
        return st if st is not None and st.tag == tag else None

    def _on_message(self, conn: P.Connection, msg):
        mt = msg[0]
        if mt == P.OBJ_PULL_META:
            oid, size, meta = ObjectID(msg[2]), msg[3], msg[4]
            st = self._current(oid, msg[5] if len(msg) > 5 else None)
            if st is None:
                return
            if size < 0:
                # stale directory entry: this source no longer holds THIS
                # object — fail over this pull's ranges only. The
                # connection itself is healthy and may be mid-stream for
                # other objects; failing those too would poison their
                # source sets.
                self._handle_conn_failure(conn, reason="object not on peer",
                                          only_oid=oid)
                return
            with st.buf_lock:
                if st.size >= 0:
                    return  # another source's META already sized the buffer
                st.size = size
                for r in st.ranges:
                    if r.length < 0:  # open-ended request, now resolvable
                        r.length = size - r.start
                try:
                    st.buf = self._store.create(oid, size, len(meta))
                except ObjectExistsError:
                    if self._store.contains(oid):  # already sealed locally
                        st.done.set()
                        return
                    # unsealed leftover from a failed earlier pull: reclaim
                    self._store.delete(oid)
                    try:
                        st.buf = self._store.create(oid, size, len(meta))
                    except Exception as e:  # noqa: BLE001
                        st.error = f"create failed: {e}"
                        st.done.set()
                        return
                except Exception as e:  # noqa: BLE001 — e.g. store full
                    st.error = f"create failed: {e}"
                    st.done.set()
                    return
                st.buf[size:] = meta
                if size == 0:
                    st.buf = None
                    self._store.seal(oid)
                    st.done.set()
                    return
                # publish the unsealed buffer's availability map so this
                # host's TransferServer can relay chunks as they land
                # (cooperative broadcast); seal/delete of the id finish
                # the entry automatically
                st.part = self._store.begin_partial(oid, st.buf, size,
                                                    bytes(meta))
        elif mt == P.OBJ_PULL_CHUNK:
            self._expect[conn] = (ObjectID(msg[2]), msg[3],
                                  msg[4] if len(msg) > 4 else None)
        elif mt == P.RAW_FRAME:
            exp = self._expect.pop(conn, None)
            if exp is None:
                return
            oid, off, tag = exp
            payload = msg[2]
            st = self._current(oid, tag)
            if st is None:
                return
            n = len(payload)
            with st.buf_lock:
                buf = st.buf
                addr = st.conns.get(conn)
                if buf is not None:
                    # vectorized copy into the arena (~2x a memoryview
                    # slice assignment; this is the receive-side hot
                    # loop). payload may be a memoryview into the recv
                    # buffer (feed()'s zero-copy fast path) — consumed
                    # before returning.
                    np.copyto(
                        np.frombuffer(buf[off:off + n], np.uint8),
                        np.frombuffer(payload, np.uint8))
                    # per-range progress, for resume-after-source-death.
                    # Match by source + containment (ranges are disjoint
                    # per source), NOT just expected-next-offset: at a
                    # stripe boundary the next range's first chunk lands
                    # exactly at start+received of a finished-but-not-DONE
                    # neighbour and must not be credited to it. Chunks
                    # within one range arrive in stream order, so the
                    # received high-water mark only advances on the next
                    # expected offset.
                    if addr is not None:
                        for r in st.ranges:
                            if r.done or r.addr != addr or off < r.start:
                                continue
                            if r.length >= 0 and off >= r.start + r.length:
                                continue
                            if off == r.start + r.received:
                                r.received += n
                            break
                    if st.part is not None:
                        # AFTER the copy: a relay must never stream bytes
                        # the arena doesn't hold yet
                        st.part.mark(off, off + n)
            if addr is not None:
                # sole writer is this IO thread — plain dict update is safe
                self.bytes_by_source[addr] = \
                    self.bytes_by_source.get(addr, 0) + n
        elif mt == P.OBJ_PULL_FAIL:
            # a relay could not complete our range (its own pull aborted
            # or stalled): fail over THIS object's ranges on this
            # connection only — the connection is healthy, and what
            # already arrived stays credited; the undelivered tail is
            # re-requested from the remaining candidates (the root set)
            oid = ObjectID(msg[2])
            if self._current(oid, msg[4] if len(msg) > 4 else None) is None:
                return
            self._handle_conn_failure(conn, reason="relay source aborted",
                                      only_oid=oid)
        elif mt == P.OBJ_PULL_DONE:
            oid = ObjectID(msg[2])
            start = msg[3] if len(msg) > 3 else 0
            st = self._current(oid, msg[5] if len(msg) > 5 else None)
            if st is None:
                return
            with st.buf_lock:
                for r in st.ranges:
                    if not r.done and r.start == start:
                        r.done = True
                        break
                self._maybe_seal(st, oid)

    def _maybe_seal(self, st: _PullState, oid: ObjectID):
        """Seal + wake once every assigned range completed (buf_lock held)."""
        if st.buf is None or not st.started:
            return
        if any(not r.done for r in st.ranges):
            return
        st.buf = None  # drop the arena view before sealing
        try:
            self._store.seal(oid)
        except KeyError:
            st.error = "seal failed"
        st.done.set()

    def abort(self, oid: ObjectID) -> bool:
        """Abort an in-flight PREFETCH pull (head PULL_ABORT: the task
        that speculated it was cancelled / retried elsewhere). Only
        prefetch-flagged pulls no demand get() has joined are honored —
        a pull real work waits on is never killed by stale speculation.
        The woken leader's cleanup path deletes the created-but-unsealed
        arena entry (the r9 abort machinery: partial finished under the
        entry lock, relays handed OBJ_PULL_FAIL, slot freed only after
        in-flight reads drain)."""
        with self._lock:
            # same lock the follower path sets st.joined under: either
            # the join serialized first (we back off) or the abort wins
            # outright — a join can no longer slip between the check
            # and the error write
            st = self._pending.get(oid)
            if st is None or not st.prefetch or st.joined:
                return False
            if st.error is None:
                st.error = "prefetch aborted"
        st.done.set()
        return True

    # ---- source failure / striped-range failover ----

    def _on_conn_close(self, conn: P.Connection):
        """A source died: fail over its in-flight ranges now, not at
        timeout — and drop every per-connection table entry so a recycled
        Connection object can never route a stale chunk."""
        self._expect.pop(conn, None)
        with self._lock:
            for addr, c in list(self._conns.items()):
                if c is conn:
                    del self._conns[addr]
        self._handle_conn_failure(conn)

    def _handle_conn_failure(self, conn: P.Connection,
                             reason: str = "transfer connection lost",
                             only_oid: Optional[ObjectID] = None):
        """``only_oid`` scopes the failover to one pull (stale directory
        entry on a live connection); None means the connection died and
        every pull riding it must reassign."""
        with self._lock:
            stale = [(oid, st) for oid, st in self._pending.items()
                     if conn in st.conns
                     and (only_oid is None or oid == only_oid)]
        if not stale:
            return
        # Reassignment may dial a NEW source (blocking connect) — never on
        # the IO thread, which delivers every other connection's bytes.
        threading.Thread(target=self._failover, args=(conn, stale, reason),
                         daemon=True).start()

    def _failover(self, dead: P.Connection, stale, reason: str):
        for oid, st in stale:
            with st.buf_lock:
                addr_dead = st.conns.pop(dead, None)
                if addr_dead is None:
                    continue  # concurrent failover already handled it
                st.failed_addrs.add(addr_dead)
                # Ranges the dead source fully delivered (only the DONE
                # frame was lost) can close now. Ranges with an undelivered
                # tail stay NOT-done until their replacement range exists:
                # marking them done before the reassignment lands would let
                # a surviving source's OBJ_PULL_DONE seal a partially-
                # written object in the window between lock holds.
                broken: List[_Range] = []
                for r in st.ranges:
                    if r.done or r.addr != addr_dead:
                        continue
                    if r.length >= 0 and r.received >= r.length:
                        r.done = True
                        continue
                    broken.append(r)
                if not broken:
                    # the dead source had finished its share — the pull may
                    # now be complete
                    self._maybe_seal(st, oid)
                    continue
            target = self._pick_failover_source(st)
            if target is None:
                st.error = reason
                st.done.set()
                continue
            tconn, taddr = target
            self.source_failovers += 1
            plan: List[Tuple[int, int]] = []
            with st.buf_lock:
                st.conns[tconn] = taddr
                for r in broken:
                    # freeze the old range at what actually arrived; its
                    # undelivered tail becomes a fresh range on the target
                    # — appended in the SAME lock hold that closes the old
                    # one, so _maybe_seal never sees a gap
                    resume = r.start + r.received
                    remaining = (r.length - r.received) if r.length >= 0 \
                        else -1
                    r.length = r.received
                    r.done = True
                    st.ranges.append(_Range(resume, remaining, taddr))
                    plan.append((resume, remaining))
            try:
                for resume, remaining in plan:
                    self._send_pull_req(tconn, st, oid, resume, remaining,
                                        taddr)
            except P.ConnectionLost:
                self._handle_conn_failure(tconn)

    def _pick_failover_source(self, st: _PullState):
        """A surviving participant, else an untried candidate address."""
        with st.buf_lock:
            for c, a in st.conns.items():
                if not c.closed:
                    return c, a
            candidates = [a for a in st.addrs if a not in st.failed_addrs
                          and a not in st.conns.values()]
        for a in candidates:
            try:
                return self._peer(a), a
            except OSError:
                with st.buf_lock:
                    st.failed_addrs.add(a)
        return None

    def close(self):
        with self._lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for c in conns:
            c.on_close = None
            c.close()
