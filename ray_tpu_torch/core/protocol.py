"""Wire protocol: framed messages over unix-domain sockets.

Analog role: the reference's gRPC services (src/ray/rpc/, 25 protos). On a
TPU pod the control plane is host-to-host over DCN; here we implement the
same message surface over length-prefixed pickled frames on unix/TCP sockets
— a head connection per process (GCS+raylet client) plus direct
worker-to-worker connections for task/actor push (the reference's
CoreWorkerService PushTask, core_worker.proto:415).

Messages are tuples ``(msg_type, request_id, *fields)``. ``request_id`` > 0
means a reply is expected (RPC); 0 means one-way.
"""

from __future__ import annotations

import itertools
import pickle
import select
import socket
import struct
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

# 8-byte length prefix: the top bit marks RAW frames, and pickled frames of
# several GiB (relay fallback of large spilled objects) must still fit.
_LEN = struct.Struct("<Q")

# --- message types ---------------------------------------------------------
# worker <-> head (GCS + raylet services)
REGISTER = 1            # (worker_id_hex, pid, listen_addr, node_idx)
REGISTER_REPLY = 2
LEASE_REQUEST = 3       # (sched_class_key, resources_dict, job_id_hex, strategy)
LEASE_REPLY = 4         # (ok, worker_id_hex, listen_addr, lease_id, err)
RETURN_WORKER = 5       # (lease_id, worker_id_hex)
CREATE_ACTOR = 6        # (actor_spec_bytes)
CREATE_ACTOR_REPLY = 7
GET_ACTOR = 8           # (actor_id_binary)
GET_ACTOR_REPLY = 9     # (state, listen_addr)
KV_PUT = 10             # (ns, key, value, overwrite)
KV_GET = 11             # (ns, key)
KV_DEL = 12
KV_KEYS = 13
SUBSCRIBE = 14          # (channel,)
PUBLISH = 15            # (channel, payload)
OBJECT_SEALED = 16      # (object_id_bin, node_idx, size, owner_hex
#                         [, job_id_hex]) — the trailing job id (memory
#                         observatory) is optional for wire compat with
#                         pre-r20 senders; the handler defaults it to "".
OBJECT_LOCATE = 17      # (object_id_bin)
OBJECT_LOCATE_REPLY = 18  # (node_idx or -1, size, spilled_url)
OBJECT_FREE = 19        # (object_id_bins,)
BORROW_ADD = 20         # (object_id_bin, borrower_hex)
BORROW_REMOVE = 21
CREATE_PG = 22          # (pg_spec_bytes)
CREATE_PG_REPLY = 23
REMOVE_PG = 24
ACTOR_DEAD = 25         # notification (actor_id_bin, err)
KILL_ACTOR = 26         # (actor_id_bin, no_restart)
NODE_INFO = 27          # request cluster node table
NODE_INFO_REPLY = 28
DRAIN_NODE = 29         # (node_idx,) -> ok — graceful drain (r16): the
#                         head excludes the node from lease grants /
#                         placements / prefetch targets, replicates its
#                         sole-copy objects off via the pull machinery,
#                         publishes "node_draining" so workloads migrate
#                         proactively (pipeline stage migration), waits
#                         for in-flight leases up to drain_deadline_s,
#                         then fires the deliberate SHUTDOWN_NODE
#                         removal (drain_forced past the deadline).
#                         Reference: NodeManager::HandleDrainNode, the
#                         autoscaler's planned-scale-down path.
OBJECT_TRANSFER = 30    # (object_id_bin, to_node_idx) - ask head to arrange
OBJECT_CHUNK = 31       # (object_id_bin, chunk_idx, n_chunks, payload)
WORKER_EXIT = 32        # worker announces clean exit
CANCEL_TASK = 33        # (task_id_bin, force)
ERROR_REPLY = 34
TASK_EVENTS = 35        # (events_list,) buffered task state events -> GCS
JOB_SUBMIT = 36
PING = 37
OK = 38

# head <-> node agent (remote-host membership; the reference's raylet
# registration over gRPC, src/ray/gcs/gcs_server gcs_node_manager)
REGISTER_NODE = 39        # (node_resources, store_name, node_ip, session_dir)
REGISTER_NODE_REPLY = 40  # (node_idx, session_name)
SPAWN_WORKER = 41         # head->agent: (worker_id,)
KILL_WORKER = 42          # head->agent: (worker_id,)
AGENT_OBJ_GET = 43        # head->agent: (oid_bin) -> (payload, meta) | error
AGENT_OBJ_PUT = 44        # head->agent: (oid_bin, payload, meta)
AGENT_OBJ_FREE = 45       # head->agent: (oid_bins,)

# worker <-> worker (direct transport)
PUSH_TASK = 50          # (task_spec_bytes, seqno)
TASK_REPLY = 51         # (task_id_bin, status, result_meta, err)  [rpc reply]
STEAL_BACK = 52
PUSH_CANCEL = 53        # (task_id_bin, force)
PUSH_TASK_BATCH = 54    # ([task_specs],) one frame, one pickle, one syscall
TASK_DONE_BATCH = 55    # ([(task_id_bin, status, result_meta, err)],) the
#                         return-side mirror of PUSH_TASK_BATCH: a worker
#                         that finished several tasks between io-loop
#                         ticks acks them all in ONE frame (small inline
#                         returns ride along), collapsing the async
#                         return flood from one pickle + one locked
#                         syscall per task to a handful per drain

# peer-to-peer object transfer (object_transfer.py; the reference's
# ObjectManagerService chunked pull, object_manager.proto:61)
PULL_OBJECT = 56        # head->agent: (oid_bin, [holder_addrs], size[,
#                         max_sources, [relay_addrs]]) -> ok (a single
#                         addr string is accepted for compat).
#                         max_sources caps the stripe width (0 = config
#                         default); relay_addrs marks which of the
#                         holder addrs are IN-PROGRESS pullers serving
#                         partial objects (cooperative broadcast) — the
#                         puller waits for those instead of failing fast
OBJ_PULL = 57           # puller->server, one-way: (oid_bin, start,
#                         length[, wait_s]); length -1 = "through end of
#                         object". Disjoint ranges of one object may be
#                         requested from different holders concurrently
#                         (striped pull, the reference's PullManager
#                         chunk fan-out). wait_s > 0: the server may
#                         serve a PARTIALLY present object, waiting up
#                         to wait_s for it to appear / for each next
#                         chunk to land (relay of an in-progress pull)
OBJ_PULL_CHUNK = 58     # server->puller header: (oid_bin, offset);
#                         the chunk bytes follow as ONE raw frame
OBJ_PULL_DONE = 59      # server->puller: (oid_bin, start, length) — the
#                         requested range has been fully streamed
RAW_FRAME = 60          # synthetic msg type for raw frames: (RAW_FRAME, 0, bytes)
OBJ_PULL_META = 61      # server->puller: (oid_bin, size|-1, meta_bytes)
OBJECT_RECOVERING = 62  # owner->head: ([oid_bins],) lineage re-execution began
RECOVER_OBJECT = 63     # borrower->head->owner: (oid_bin, owner_hex) please
                        # reconstruct — the lineage lives with the owner
STATE_QUERY = 64        # (kind, limit) -> ([rows],) observability state API
SEAL_ABORTED = 65       # owner->head: ([oid_bins],) the creating task failed
                        # permanently — these ids will never seal; fail any
                        # blocked locate waiters instead of hanging them
METRICS_REPORT = 66     # ([(kind, name, desc, meta, tags_key, value)],)
                        # per-process metric deltas -> head aggregate
XLANG_CALL = 67         # (json_bytes,) cross-language frontend (C++ task
                        # submission): {"op": "submit", "function":
                        # "module:qualname", "args": [...]} — the head
                        # executes on behalf of the client and replies
                        # with a RAW frame of JSON {"rid", "status",
                        # "result"|"error"} (raw so non-Python clients
                        # never parse pickle)
OBJ_LOCATION_ADD = 68   # (oid_bin, node_idx, size) a node gained a copy
                        # (pull completion / replica creation) — the head
                        # adds it to the object directory's holder set
                        # (reference: ObjectDirectory location updates,
                        # src/ray/object_manager/object_directory.h)
OBJ_LOCATION_REMOVE = 69  # ([oid_bins], node_idx) a node dropped copies
                        # (eviction/deletion) — remove from holder sets;
                        # batched: one message per eviction sweep
OBJ_LOCATION_LOOKUP = 70  # (oid_bin) -> ([holder_idxs], [transfer_addrs],
                        # size, spilled_url) full holder-set query
CLUSTER_EVENT = 71      # ([(ts, severity, source, node_idx, entity_id,
                        # type, message, extra)], dropped) severity-tagged
                        # cluster events -> head ring buffer (reference:
                        # the GCS cluster event log behind
                        # `ray list cluster-events`); one-way from any
                        # process, mirroring the task-event channel
LEASE_GRANT_BATCH = 73  # head->driver, one-way: ([(rid, worker_id,
                        # listen_addr, lease_id, gpu_ids)],) — the
                        # request-side mirror of TASK_DONE_BATCH: one
                        # batched dispatch pass that granted several of a
                        # driver's queued LEASE_REQUESTs acks them all in
                        # ONE frame (one pickle, one syscall) instead of
                        # a LEASE_REPLY per lease; the driver completes
                        # each rid's blocked call from the batch
SHUTDOWN_NODE = 75      # head->agent, one-way: () — the head is
#                         DELIBERATELY cutting this node loose (cluster
#                         shutdown, eviction): the agent must exit
#                         instead of treating the coming socket close as
#                         a head outage and re-dialing for the whole
#                         reconnect window (reference: an evicted raylet
#                         kills itself on learning of its eviction)
CLIENT_HELLO = 74       # client->head, one-way: (client_id, reattach) —
#                         sent first on every (re)connect of a
#                         reconnecting head channel. The head stamps the
#                         connection with the client's stable id so
#                         retried mutations can be deduped by
#                         (client_id, request_id), and counts reattaches
#                         (reattach=True on every connect after the
#                         first — the GCS-FT analog of a raylet
#                         re-establishing its GCS RPC channel)
PULL_ABORT = 76         # head->agent, one-way: (oid_bin,) — abort the
#                         in-flight PREFETCH pull of this object (its
#                         task was cancelled / retried elsewhere / its
#                         lease died before any worker asked for the
#                         arg). The agent's puller only honors it for
#                         prefetch-flagged pulls no demand get() has
#                         joined — a pull real work is waiting on is
#                         never killed by stale speculation.
PREFETCH_RESULT = 77    # agent->head, one-way: (oid_bin, node_idx, ok)
#                         — a prefetch-flagged pull finished (either
#                         way). The head releases the broadcast-planner
#                         source charges it registered at issue time and
#                         marks the entry done (ok) or drops it.
PREFETCH_HINT = 78      # driver->head, one-way: (lease_id,
#                         [arg_id_bins][, [inline_id_bins]]) —
#                         dispatch-time companion to
#                         the grant-time prefetch: leases are long-lived
#                         and serve many tasks, so when the submitter
#                         pushes a task batch with by-ref args it names
#                         them for the lease's node; the head applies
#                         the same holder check / caps / dedupe and
#                         fires prefetch-flagged PULL_OBJECTs while the
#                         batch is still in flight to the worker. The
#                         optional third field (r16) tags the subset of
#                         the ids that are INLINE-PROMOTED objects, so
#                         the head books their pulls outside the
#                         speculation waste ratio; sent only when
#                         non-empty (common frames stay r15-identical).
PREFETCH_HINT_BATCH = 80  # driver->head, one-way: ([(lease_key,
#                         [arg_id_bins][, [inline_id_bins]])],) — r15
#                         coalesced form of
#                         PREFETCH_HINT: a pipeline/actor hot loop
#                         pushing many small batches with FRESH by-ref
#                         args (per-microbatch activations defeat the
#                         r14 dedupe window — every id is novel) buffers
#                         hints per (lease | actor:<hex>) destination
#                         and the submitter's next wakeup ships ALL
#                         pending destinations in this one frame instead
#                         of one frame per pushed batch. The head
#                         unrolls it through the PREFETCH_HINT path
#                         (same caps / holder checks / dedupe).
OBJECT_WARM = 79        # client->head: (oid_bin, node_idx) — warm an
#                         object onto a node BEFORE any task/actor that
#                         needs it is even placed (r14 serve cold-start:
#                         the controller warms deployment weights at
#                         scale-up decision time so replica construction
#                         finds the bytes local or joins the in-flight
#                         pull). node_idx = -1 warms every alive remote
#                         node missing the object. Rides the r13
#                         prefetch machinery (same caps / pacing /
#                         dedupe / PREFETCH_RESULT accounting) under the
#                         reserved WARM lease, and the pulls register as
#                         in-progress locations, so N concurrent warms
#                         form the r9 cooperative broadcast tree.
#                         Replied (pull count issued) when sent as a
#                         call; also valid one-way.
OBJ_TAG = 81            # client->head, one-way: ([oid_bins], tag) —
#                         stamp a reference-class tag onto directory
#                         entries (memory observatory: "checkpoint" for
#                         pipeline checkpoint refs). Purely advisory
#                         accounting metadata: `ray_tpu memory`'s class
#                         breakdown splits resident bytes by it.
OBJ_PULL_FAIL = 72      # server->puller: (oid_bin, offset) — the server
                        # cannot complete the requested range past
                        # `offset` (its own in-progress pull aborted, or
                        # a promised object never materialized); the
                        # puller fails over ONLY this object's ranges on
                        # this connection to the remaining candidate
                        # sources (the root holder set), crediting what
                        # already arrived

# High bit of the length prefix marks a RAW frame: the payload is
# unpickled bytes (bulk data follows its pickled header message). Sending
# side writes straight from a memoryview (e.g. an shm arena slice) with
# zero serialization copies.
_RAW_BIT = 1 << 63

# Max buffers per sendmsg call. POSIX guarantees IOV_MAX >= 16 and Linux
# gives 1024; staying well below keeps one vectored write's worst-case
# kernel work bounded even when a drain coalesces many queued frames.
_IOV_MAX = 64


class WireStats:
    """Process-wide data/return-plane counters (one instance, ``WIRE``).

    Plain int attributes bumped from the send hot paths — a racy lost
    increment under free-threading is acceptable for observability
    counters; taking a lock per frame is not. Snapshotted by
    ``metrics.wire_metrics_snapshot`` (delta push to the head aggregate)
    and surfaced raw through the head's ``io_loop`` state query.
    """

    __slots__ = ("frames_sent", "sendmsg_calls", "frames_coalesced",
                 "coalesced_flushes", "zero_copy_bytes", "bytes_sent",
                 "task_done_batches", "task_done_batched",
                 "backpressure_hits")

    def __init__(self):
        self.frames_sent = 0        # framed messages handed to the wire
        self.sendmsg_calls = 0      # vectored write syscalls issued
        self.frames_coalesced = 0   # frames that shared a sendmsg with
        #                             at least one other frame
        self.coalesced_flushes = 0  # sendmsg calls carrying > 1 frame
        self.zero_copy_bytes = 0    # raw-frame bytes sent without an
        #                             intermediate copy (send_with_raw)
        self.bytes_sent = 0         # total payload+prefix bytes written
        self.task_done_batches = 0  # TASK_DONE_BATCH frames sent
        self.task_done_batched = 0  # completions that rode those frames
        self.backpressure_hits = 0  # write queue reached its bound

    def snapshot(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}


WIRE = WireStats()

# Optional backpressure notifier: ``cb(peer, queued_frames, queued_bytes)``
# invoked (off the send path, rate-limited per connection) when a
# connection's write queue hits its bound — the runtime wires this to the
# cluster event log so wire saturation shows up on the events page
# instead of failing silently.
_backpressure_cb: Optional[Callable[[str, int, int], None]] = None


def set_backpressure_callback(cb: Optional[Callable[[str, int, int], None]]):
    global _backpressure_cb
    _backpressure_cb = cb


class ConnectionLost(Exception):
    """Raised by writes/calls on a dead connection. ``conn`` identifies
    WHICH connection died — a handler touching several peers needs it to
    tell "my requester vanished" apart from "some third party's socket
    broke mid-fanout" (the latter must not abort the handler)."""

    def __init__(self, msg, conn=None):
        super().__init__(msg)
        self.conn = conn

    def __reduce__(self):
        # conn holds a live socket + locks: unpicklable, and meaningless
        # in another process anyway — error replies ship the message only
        return (ConnectionLost, (str(self),))


class Connection:
    """A framed, thread-safe duplex connection.

    Reads are driven by the owning IOLoop (or a dedicated thread); writes may
    come from any thread. Supports request/reply with blocking ``call``.
    """

    _req_counter = itertools.count(1)

    def __init__(self, sock: socket.socket, peer: str = ""):
        self.sock = sock
        self.peer = peer
        self._wlock = threading.Lock()
        # Coalescing write queue: senders append their frame's buffer list
        # (a GIL-atomic deque op — no lock needed to enqueue), then the
        # sender that wins ``_wlock`` drains EVERYTHING queued in one
        # vectored write. Uncontended sends find the queue holding only
        # their own item and flush immediately — the latency path is
        # unchanged. Items are ``[bufs, nbytes, error, done]``; a sender
        # blocks on ``_wlock`` until its item is marked done (possibly by
        # another sender's drain), preserving synchronous ConnectionLost
        # semantics for every caller.
        self._wq: deque = deque()
        #: the thread that holds ``_wlock`` (None when free): a send that
        #: this thread makes while it drains — from a finalizer the
        #: garbage collector runs mid-drain, e.g. an ObjectRef's __del__
        #: sending its free — only queues, and the drain sends it
        self._wlock_owner: Optional[int] = None
        self._coalesce_max_bytes = 0   # lazily read from config
        self._coalesce_max_frames = 0
        self._backpressure_ts = 0.0
        self._pending: Dict[int, "_Waiter"] = {}
        self._pending_lock = threading.Lock()
        self._rbuf = bytearray()
        self.closed = False
        self.on_close: Optional[Callable[["Connection"], None]] = None
        self._ioloop: Optional["IOLoop"] = None
        self._on_message_cb = None  # set by IOLoop.add_connection
        sock.setblocking(True)

    def is_attached(self) -> bool:
        """True when a send would not park. Plain connections never park
        (a dead socket raises ConnectionLost immediately);
        ReconnectingConnection overrides this with its reattach gate.
        Fire-and-forget senders that must NEVER block on a head outage
        (speculative hints, warm requests, event emits) check this and
        skip the send instead."""
        return True

    # -- send side --

    def send(self, msg_type: int, *fields, request_id: int = 0):
        payload = pickle.dumps((msg_type, request_id, *fields), protocol=5)
        if len(payload) >= _RAW_BIT:
            # the high length bit marks RAW frames — a >=2 GiB pickled
            # frame would be misparsed by the receiver; move such data in
            # chunks (e.g. via the transfer plane) instead
            raise ValueError(
                f"frame too large ({len(payload)} bytes); chunk it")
        # vectored: the length prefix and payload ship as one iovec — no
        # prefix+payload concatenation copy
        self._send_frames((_LEN.pack(len(payload)), payload),
                          _LEN.size + len(payload))

    def send_with_raw(self, msg_type: int, *fields, raw) -> None:
        """Send a pickled header message immediately followed by a RAW
        frame (bytes/memoryview, no pickling) — atomic with respect to
        other senders on this connection, so concurrent streams can never
        interleave between a header and its raw payload. The receiver sees
        the raw frame as ``(RAW_FRAME, 0, bytes)`` right after the header.

        Zero-copy: the raw buffer rides the iovec straight into sendmsg —
        a multi-GiB arena slice is never copied into a Python bytes
        object. Atomicity is structural: the header and raw frame are one
        write-queue item, and a drain never splits an item across
        vectored writes."""
        n = len(raw)
        if n >= _RAW_BIT:
            raise ValueError("raw frame too large")
        header = pickle.dumps((msg_type, 0, *fields), protocol=5)
        WIRE.zero_copy_bytes += n
        self._send_frames(
            (_LEN.pack(len(header)), header, _LEN.pack(n | _RAW_BIT), raw),
            2 * _LEN.size + len(header) + n)

    def _send_frames(self, bufs: tuple, nbytes: int):
        """Queue one frame (or an atomic header+raw frame pair) and flush.

        The append is lock-free; whichever sender holds ``_wlock`` drains
        the whole queue, so under contention frames from concurrent
        senders coalesce into one sendmsg while each sender still
        observes its own frame's outcome synchronously."""
        if self.closed:
            raise ConnectionLost(self.peer, conn=self)
        item = [bufs, nbytes, None, False]
        wq = self._wq
        wq.append(item)
        # bound check honors wire_coalesce_max_frames exactly once a
        # drain has loaded the config; only the first-ever sends on a
        # connection fall back to the compile-time default
        if len(wq) >= (self._coalesce_max_frames or 64):
            self._note_backpressure()
        me = threading.get_ident()
        if self._wlock_owner == me:
            return  # re-entered mid-drain: the drain sends the item
        with self._wlock:
            self._wlock_owner = me
            try:
                if not item[3]:
                    self._drain_wlocked()
                    # a send re-entered mid-drain queued its item after
                    # the drain took the queue
                    while wq:
                        self._drain_wlocked()
            finally:
                self._wlock_owner = None
        err = item[2]
        if err is not None:
            raise err

    def _note_backpressure(self):
        """The wire is saturated — the write queue hit its bound, or a
        single write sat blocked on an undrained socket for seconds.
        Count it and (rate-limited, off the hot path via a short-lived
        thread) tell the cluster event log — wire saturation must be
        observable, not silent."""
        WIRE.backpressure_hits += 1
        now = time.monotonic()
        if now - self._backpressure_ts < 5.0:
            return
        self._backpressure_ts = now
        cb = _backpressure_cb
        if cb is None:
            return
        # count the write in flight too (the stalled-single-sender case
        # has an empty queue — the blocked frame IS the backlog)
        frames = len(self._wq) + 1
        nbytes = sum(it[1] for it in list(self._wq))
        threading.Thread(target=cb, args=(self.peer, frames, nbytes),
                         daemon=True).start()

    def _drain_wlocked(self):
        """Flush every queued item. Caller holds ``_wlock``.

        Items are grouped into vectored writes bounded by the
        ``wire_coalesce_*`` knobs and ``_IOV_MAX``; an item's buffers are
        never split across groups, so a send_with_raw header always
        shares a write with its raw payload."""
        wq = self._wq
        items: List[list] = []
        while wq:
            try:
                items.append(wq.popleft())
            except IndexError:
                break
        if not items:
            return
        if self.closed:
            err = ConnectionLost(self.peer, conn=self)
            for it in items:
                it[2] = err
                it[3] = True
            return
        max_bytes = self._coalesce_max_bytes
        if not max_bytes:
            from .config import get_config

            cfg = get_config()
            max_bytes = self._coalesce_max_bytes = \
                max(1, cfg.wire_coalesce_max_bytes)
            self._coalesce_max_frames = max(1, cfg.wire_coalesce_max_frames)
        max_frames = self._coalesce_max_frames
        try:
            i, n = 0, len(items)
            while i < n:
                bufs: List = list(items[i][0])
                total = items[i][1]
                j = i + 1
                while (j < n and j - i < max_frames
                       and total + items[j][1] <= max_bytes
                       and len(bufs) + len(items[j][0]) <= _IOV_MAX):
                    bufs.extend(items[j][0])
                    total += items[j][1]
                    j += 1
                self._send_all_vectored(bufs)
                WIRE.frames_sent += j - i
                WIRE.bytes_sent += total
                if j - i > 1:
                    WIRE.frames_coalesced += j - i
                    WIRE.coalesced_flushes += 1
                for k in range(i, j):
                    items[k][3] = True
                i = j
        except OSError as e:
            err = ConnectionLost(f"{self.peer}: {e}", conn=self)
            err.__cause__ = e
            for it in items:
                if not it[3]:
                    it[2] = err
                    it[3] = True

    def _send_all_vectored(self, bufs: List, stall_timeout: float = 60.0):
        """sendmsg that survives a non-blocking socket (IOLoop
        registration sets O_NONBLOCK) and partial writes ACROSS iovec
        boundaries: under send-buffer pressure the kernel may accept any
        byte count — fully-sent buffers are dropped from the head of the
        vector and the first partially-sent one is resliced. Caller
        holds ``_wlock``.

        The stall timeout counts time with NO progress (reset on every
        accepted byte). On stall the connection is shut down before
        raising — a partial frame is already on the wire, so any later
        send on this socket would land mid-frame and permanently desync
        the peer."""
        # Fast path: one direct sendmsg of the caller's buffers — no
        # memoryview wrapping (measured ~2x the per-call overhead for
        # small frames). Small control frames virtually always fit the
        # socket buffer whole, so this is THE hot path; any partial or
        # blocked write falls through to the resumable slow path.
        if len(bufs) <= _IOV_MAX:
            want = sum(b.nbytes if type(b) is memoryview else len(b)
                       for b in bufs)
            try:
                sent = self.sock.sendmsg(bufs)
                WIRE.sendmsg_calls += 1
                if sent == want:
                    return
            except (BlockingIOError, InterruptedError):
                sent = 0
        else:
            sent = 0
        mvs: List[memoryview] = []
        for b in bufs:
            m = memoryview(b)
            if m.ndim != 1 or m.itemsize != 1:
                m = m.cast("B")
            if len(m):  # zero-length iovec (empty raw frame) would make
                mvs.append(m)  # the progress loop spin on sendmsg()==0
        idx, total = 0, len(mvs)
        # skip what the first attempt already put on the wire
        while sent and idx < total:
            first = mvs[idx]
            ln = len(first)
            if sent >= ln:
                sent -= ln
                idx += 1
            else:
                mvs[idx] = first[sent:]
                sent = 0
        deadline = time.monotonic() + stall_timeout
        # a write blocked this long is saturation even with a single
        # sender (queue depth never grows past 1 for synchronous
        # senders) — surface it before the 60s stall kill does
        bp_deadline = time.monotonic() + 1.0
        while idx < total:
            try:
                n = self.sock.sendmsg(mvs[idx:idx + _IOV_MAX])
                WIRE.sendmsg_calls += 1
            except BlockingIOError:
                now = time.monotonic()
                if bp_deadline is not None and now > bp_deadline:
                    bp_deadline = None
                    self._note_backpressure()
                if now > deadline:
                    # A partial frame is on the wire; any later send would
                    # land mid-frame and desync the peer. Kill the stream —
                    # the IO loop sees EOF and runs the full close path
                    # (fail pending calls, fire on_close).
                    try:
                        self.sock.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                    raise OSError("send stalled: peer not draining")
                try:
                    select.select([], [self.sock], [], 1.0)
                except (OSError, ValueError) as e:
                    # Connection closed concurrently (fd now -1/invalid):
                    # surface as a normal send failure, not a ValueError
                    # that would escape callers' ConnectionLost handling.
                    raise OSError(f"connection closed during send: {e}")
                continue
            except InterruptedError:
                continue
            if n:
                deadline = time.monotonic() + stall_timeout
            while n and idx < total:
                first = mvs[idx]
                ln = len(first)
                if n >= ln:
                    n -= ln
                    idx += 1
                else:
                    mvs[idx] = first[n:]
                    n = 0

    def call(self, msg_type: int, *fields, timeout: Optional[float] = None):
        """Send a request and block for its reply; returns reply fields."""
        rid = next(self._req_counter)
        w = _Waiter()
        with self._pending_lock:
            self._pending[rid] = w
        try:
            self.send(msg_type, *fields, request_id=rid)
            if not w.event.wait(timeout):
                raise TimeoutError(f"RPC {msg_type} to {self.peer} timed out")
            if w.error is not None:
                raise w.error
            return w.value
        finally:
            with self._pending_lock:
                self._pending.pop(rid, None)

    def reply(self, request_id: int, *fields, msg_type: int = OK):
        self.send(msg_type, *fields, request_id=-request_id)

    def reply_error(self, request_id: int, err: BaseException):
        self.send(ERROR_REPLY, err, request_id=-request_id)

    # -- receive side --

    def feed(self, data: bytes):
        """Feed raw bytes; yields complete messages.

        Fast path: when no partial frame is buffered, frames are parsed
        straight out of ``data`` with zero copies — RAW frame payloads are
        then memoryviews into ``data`` and are only valid until the caller
        finishes iterating the returned list (the transfer plane consumes
        them synchronously).
        """
        hdr = _LEN.size
        msgs = []
        if not self._rbuf:
            src = memoryview(data)
            pos, n = 0, len(src)
            while n - pos >= hdr:
                (ln,) = _LEN.unpack_from(src, pos)
                raw = bool(ln & _RAW_BIT)
                ln &= ~_RAW_BIT
                if n - pos - hdr < ln:
                    break
                payload = src[pos + hdr:pos + hdr + ln]
                msgs.append((RAW_FRAME, 0, payload) if raw
                            else pickle.loads(payload))
                pos += hdr + ln
            if pos < n:
                self._rbuf += src[pos:]
            return msgs
        # slow path: a partial frame spans recv() calls — buffer and copy
        self._rbuf += data
        while True:
            if len(self._rbuf) < hdr:
                break
            (ln,) = _LEN.unpack_from(self._rbuf)
            raw = bool(ln & _RAW_BIT)
            ln &= ~_RAW_BIT
            if len(self._rbuf) < hdr + ln:
                break
            payload = bytes(self._rbuf[hdr:hdr + ln])
            del self._rbuf[:hdr + ln]
            msgs.append((RAW_FRAME, 0, payload) if raw
                        else pickle.loads(payload))
        return msgs

    def complete_reply(self, rid: int, fields: tuple) -> bool:
        """Complete a pending call() as if a normal reply for ``rid``
        arrived — the delivery path for BATCHED replies (e.g.
        LEASE_GRANT_BATCH), where one frame carries many requests'
        results and the receiver fans them out. Returns False when no
        call is waiting (requester gave up)."""
        with self._pending_lock:
            w = self._pending.get(rid)
        if w is None:
            return False
        w.value = tuple(fields)
        w.event.set()
        return True

    def dispatch_reply(self, msg) -> bool:
        """If msg is a reply to a pending call, complete it. Returns True."""
        request_id = msg[1]
        if request_id >= 0:
            return False
        rid = -request_id
        with self._pending_lock:
            w = self._pending.get(rid)
        if w is None:
            return True  # stale reply
        if msg[0] == ERROR_REPLY:
            w.error = msg[2]
        else:
            w.value = msg[2:]
        w.event.set()
        return True

    def _io_eof(self, sock=None):
        """IO loop saw EOF/error on this socket. Plain connections die;
        a ReconnectingConnection overrides this to begin reattachment
        instead of failing its waiters (``sock`` identifies WHICH socket
        died, so a stale EOF from a replaced socket is ignored)."""
        self.close()

    def close(self):
        if self.closed:
            return
        self.closed = True
        # Unregister from the IO loop BEFORE closing the fd — once closed the
        # fd number can be recycled by a new socket.
        if self._ioloop is not None:
            self._ioloop.remove(self.sock)
        try:
            self.sock.close()
        except OSError:
            pass
        with self._pending_lock:
            pending = list(self._pending.values())
            self._pending.clear()
        for w in pending:
            w.error = ConnectionLost(self.peer, conn=self)
            w.event.set()
        if self.on_close:
            try:
                self.on_close(self)
            except Exception:
                pass


class _Waiter:
    __slots__ = ("event", "value", "error")

    def __init__(self):
        self.event = threading.Event()
        self.value = None
        self.error = None


def backoff_delay(attempt: int, base: float = 0.05, cap: float = 2.0,
                  rng=None) -> float:
    """Reconnect backoff schedule: exponential from ``base`` capped at
    ``cap``, with +/-50% jitter so a fleet of agents losing one head
    does not reconnect in lockstep (the reference's
    gcs_rpc_server_reconnect backoff role). ``rng`` is a 0..1 callable
    (tests inject a deterministic one)."""
    import random

    d = min(cap, base * (2.0 ** attempt))
    r = rng() if rng is not None else random.random()
    return d * (0.5 + r)


class ReconnectingConnection(Connection):
    """A head channel that survives the head dying and coming back.

    The GCS-FT client analog: the reference's raylets/workers keep their
    GCS RPC channel alive across a gcs_server restart, retrying for
    ``gcs_rpc_server_reconnect_timeout_s`` before giving up. Here the
    Connection object is PERSISTENT — on socket loss only the socket
    underneath is replaced, so every caller-held reference (and every
    parked ``call()`` waiter in ``_pending``) survives the outage:

    * writes during an outage park (block) until reattach, then retry;
    * in-flight ``call()``s keep their waiters — after reattach their
      requests are re-sent verbatim with the SAME request id, and the
      head's (client_id, request_id) dedupe map keeps a retried
      mutation that already landed from applying twice;
    * ``on_reattach(conn)`` runs on the reconnector thread after the new
      socket registers (and after CLIENT_HELLO), BEFORE parked senders
      resume — the re-registration protocol (REGISTER_NODE with prior
      node id + holder report, driver/worker REGISTER) runs there, so
      nothing races ahead of it;
    * past ``head_reconnect_timeout_s`` of failed attempts the channel
      closes for real: parked senders and waiters get the ordinary
      fail-fast ``ConnectionLost``, and ``on_close`` fires exactly once
      (agents shut down, workers exit — the pre-reconnect semantics).
    """

    def __init__(self, addr: str, *, client_id: str, peer: str = "head",
                 reconnect_timeout_s: Optional[float] = None,
                 on_reattach: Optional[Callable[["Connection"], None]]
                 = None):
        sock = connect_addr(addr)
        super().__init__(sock, peer=peer)
        self.addr = addr
        self.client_id = client_id
        self.on_reattach = on_reattach
        self._timeout_s = reconnect_timeout_s
        self._attached = threading.Event()
        self._attached.set()
        self._final = False
        self._reconnect_lock = threading.Lock()
        self._reconnecting = False
        self._reconnector: Optional[threading.Thread] = None
        self._give_up_at: Optional[float] = None
        # rid -> (msg_type, fields): requests whose reply is still
        # pending, re-sent verbatim after a reattach
        self._inflight_reqs: Dict[int, tuple] = {}
        self._inflight_lock = threading.Lock()
        self.reconnects = 0          # successful reattachments
        self.reconnect_attempts = 0  # dial attempts (incl. failures)
        # identify ourselves so the head can dedupe retried requests
        self.send(CLIENT_HELLO, client_id, False)

    def is_attached(self) -> bool:
        return self._attached.is_set()

    def _reconnect_window_s(self) -> float:
        if self._timeout_s is not None:
            return self._timeout_s
        from .config import get_config

        return get_config().head_reconnect_timeout_s

    # -- send/call overrides -------------------------------------------

    def _wait_attached(self):
        if self._final:
            raise ConnectionLost(
                f"{self.peer}: head unreachable past reconnect window",
                conn=self)
        if self._attached.is_set():
            return
        if threading.current_thread() is self._reconnector:
            return  # re-registration traffic bypasses the gate
        if self._ioloop is not None and \
                threading.current_thread() is self._ioloop._thread:
            # NEVER park the IO loop: it must stay live to deliver the
            # re-registration replies the reattach handshake blocks on.
            # Handlers sending on the head channel during an outage get
            # the ordinary ConnectionLost (they all tolerate it).
            raise ConnectionLost(f"{self.peer}: reconnecting", conn=self)
        while not self._attached.wait(0.5):
            if self._final:
                break
        if self._final:
            raise ConnectionLost(
                f"{self.peer}: head unreachable past reconnect window",
                conn=self)

    def _send_frames(self, bufs: tuple, nbytes: int):
        while True:
            self._wait_attached()
            failed_sock = self.sock
            try:
                return super()._send_frames(bufs, nbytes)
            except ConnectionLost:
                if self._final or self.closed:
                    raise
                if threading.current_thread() is self._reconnector:
                    # a reattach-handshake send failed (head died again
                    # mid-handshake): surface to _reconnect_loop, which
                    # discards the half-attached socket and retries with
                    # backoff — retrying HERE would spin on the same
                    # dead socket forever (_socket_dead no-ops while
                    # _reconnecting is set)
                    raise
                # socket died under us: begin (or join) reattachment and
                # retry the frame on the next socket — a partially-sent
                # frame is harmless, the new head reads a fresh stream
                self._socket_dead(failed_sock)

    def call(self, msg_type: int, *fields,
             timeout: Optional[float] = None):
        """Like Connection.call, but the request is recorded so a
        reattach can replay it (same rid — the head dedupes)."""
        rid = next(self._req_counter)
        w = _Waiter()
        with self._pending_lock:
            self._pending[rid] = w
        with self._inflight_lock:
            self._inflight_reqs[rid] = (msg_type, fields)
        try:
            self.send(msg_type, *fields, request_id=rid)
            if not w.event.wait(timeout):
                raise TimeoutError(
                    f"RPC {msg_type} to {self.peer} timed out")
            if w.error is not None:
                raise w.error
            return w.value
        finally:
            with self._pending_lock:
                self._pending.pop(rid, None)
            with self._inflight_lock:
                self._inflight_reqs.pop(rid, None)

    # -- detach / reattach ---------------------------------------------

    def _io_eof(self, sock=None):
        self._socket_dead(sock)

    def _socket_dead(self, dead_sock=None):
        """The given socket is gone. Start one reconnector; concurrent
        callers (IO-loop EOF racing a failed send) just return — their
        own retry loops block on ``_attached``. A STALE report about an
        already-replaced socket (a late EOF event or a send failure that
        lost the race with a completed reattach) must not kill the new
        healthy socket."""
        with self._reconnect_lock:
            if self._final or self.closed or self._reconnecting:
                return
            if dead_sock is not None and dead_sock is not self.sock:
                return  # stale report about a replaced socket
            self._reconnecting = True
            self._attached.clear()
            if self._give_up_at is None:
                self._give_up_at = (time.monotonic()
                                    + self._reconnect_window_s())
            if self._ioloop is not None:
                self._ioloop.remove(self.sock)
            try:
                self.sock.close()
            except OSError:
                pass
            self._reconnector = threading.Thread(
                target=self._reconnect_loop, daemon=True,
                name=f"reconnect-{self.peer}")
            self._reconnector.start()

    def _reconnect_loop(self):
        attempt = 0
        while not self._final:
            deadline = self._give_up_at
            now = time.monotonic()
            if deadline is not None and now >= deadline:
                self._give_up()
                return
            self.reconnect_attempts += 1
            try:
                budget = 5.0 if deadline is None else \
                    max(0.2, min(5.0, deadline - now))
                sock = connect_addr(self.addr, timeout=budget)
            except OSError:
                time.sleep(backoff_delay(attempt))
                attempt += 1
                continue
            try:
                self._attach(sock)
            except ConnectionLost:
                # head answered then died again mid-handshake: next round
                self._discard_half_attached(sock)
                time.sleep(backoff_delay(attempt))
                attempt += 1
                continue
            except Exception:
                import traceback

                traceback.print_exc()
                self._discard_half_attached(sock)
                time.sleep(backoff_delay(attempt))
                attempt += 1
                continue
            return

    def _discard_half_attached(self, sock: socket.socket):
        """A reattach handshake failed after the socket may already have
        been registered with the IO loop — unregister FIRST (a closed fd
        left in the selector would make the loop spin on EBADF), then
        close."""
        if self._ioloop is not None:
            self._ioloop.remove(sock)
        try:
            sock.close()
        except OSError:
            pass

    def _attach(self, sock: socket.socket):
        """Swap the new socket in, re-register with the IO loop, run the
        re-registration hook, replay in-flight requests, release parked
        senders. Runs on the reconnector thread."""
        self.sock = sock
        self._rbuf = bytearray()
        if self._ioloop is not None and self._on_message_cb is not None:
            self._ioloop.add_connection(self, self._on_message_cb)
        else:
            sock.setblocking(True)
        self.send(CLIENT_HELLO, self.client_id, True)
        if self.on_reattach is not None:
            self.on_reattach(self)
        # replay requests whose replies died with the old head — same
        # rids, so the head's dedupe map absorbs true duplicates
        with self._inflight_lock:
            replay = sorted(self._inflight_reqs.items())
        for rid, (mt, fields) in replay:
            with self._pending_lock:
                if rid not in self._pending:
                    continue  # caller gave up while we were away
            self.send(mt, *fields, request_id=rid)
        self.reconnects += 1
        with self._reconnect_lock:
            self._reconnecting = False
            self._give_up_at = None
        self._attached.set()

    def _give_up(self):
        """Reconnect window expired: fail fast exactly like a plain
        connection dying — waiters get ConnectionLost, on_close fires."""
        with self._reconnect_lock:
            self._final = True
            self._reconnecting = False
        self._attached.set()  # release parked senders into the raise
        super().close()

    def close(self):
        """Deliberate, final close (shutdown paths)."""
        self._final = True
        self._attached.set()
        super().close()


class IOLoop:
    """Single IO thread multiplexing all connections of a process.

    Mirrors the reference's per-process ``instrumented_io_context`` asio loop
    (src/ray/common/asio/instrumented_io_context.h).
    """

    # a handler occupying the IO thread longer than this is logged —
    # the analog of the reference's event-loop lag tracking (every
    # handler on instrumented_io_context is timed; event_stats.h)
    SLOW_HANDLER_S = 0.1

    def __init__(self, name: str = "io"):
        import selectors

        self.name = name
        self.sel = selectors.DefaultSelector()
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._stopped = threading.Event()
        self._wakeup_r, self._wakeup_w = socket.socketpair()
        self._wakeup_r.setblocking(False)
        self.sel.register(self._wakeup_r, 1, ("wakeup", None, None))
        self._started = False
        # loop-lag accounting, exposed via stats(): total busy seconds,
        # handled events, count + worst of slow handler episodes
        self._busy_s = 0.0
        self._events = 0
        self._slow_events = 0
        self._max_handler_s = 0.0
        # self-probe loop lag (probe_lag()/lag_stats()): a timestamped
        # wakeup measures how long a new event waits for this thread —
        # the direct "is the loop off the hot path" gauge (analog:
        # instrumented_io_context's queued-time stats). One probe in
        # flight at a time; samples ring-buffered for the quantiles.
        self._lag_probe_t: Optional[float] = None
        self._lag_samples: deque = deque(maxlen=256)

    def start(self):
        if not self._started:
            self._started = True
            self._thread.start()

    def add_listener(self, sock: socket.socket,
                     on_accept: Callable[[socket.socket, Any], None]):
        sock.setblocking(False)
        with self._lock:
            self.sel.register(sock, 1, ("listen", on_accept, None))
        self._wake()

    def add_connection(self, conn: Connection,
                       on_message: Callable[[Connection, Tuple], None]):
        conn.sock.setblocking(False)
        conn._ioloop = self
        # remembered so a ReconnectingConnection can re-register its
        # replacement socket with the same handler after a reattach
        conn._on_message_cb = on_message
        with self._lock:
            self.sel.register(conn.sock, 1, ("conn", on_message, conn))
        self._wake()

    def remove(self, sock):
        with self._lock:
            try:
                self.sel.unregister(sock)
            except (KeyError, ValueError):
                pass

    def _wake(self):
        try:
            self._wakeup_w.send(b"x")
        except OSError:
            pass

    def _run(self):
        while not self._stopped.is_set():
            try:
                events = self.sel.select(timeout=0.5)
            except OSError:
                continue
            for key, _ in events:
                kind, cb, conn = key.data
                t0 = time.perf_counter()
                if kind == "wakeup":
                    try:
                        self._wakeup_r.recv(4096)
                    except OSError:
                        pass
                    sent = self._lag_probe_t
                    if sent is not None:
                        self._lag_probe_t = None
                        self._lag_samples.append(
                            time.perf_counter() - sent)
                elif kind == "listen":
                    try:
                        client, addr = key.fileobj.accept()
                        if client.family == socket.AF_INET:
                            # connect_addr sets TCP_NODELAY on the dialing
                            # side only; without it here every server->
                            # client reply is at the mercy of Nagle +
                            # delayed-ack interplay on cross-host links
                            try:
                                client.setsockopt(socket.IPPROTO_TCP,
                                                  socket.TCP_NODELAY, 1)
                            except OSError:
                                pass
                        cb(client, addr)
                    except OSError:
                        pass
                elif kind == "conn":
                    self._service_conn(key.fileobj, cb, conn)
                dt = time.perf_counter() - t0
                self._busy_s += dt
                self._events += 1
                if dt > self._max_handler_s:
                    self._max_handler_s = dt
                if dt > self.SLOW_HANDLER_S:
                    # every connection on this loop stalled behind this
                    # handler — the single-threaded-loop failure mode the
                    # reference instruments (instrumented_io_context)
                    self._slow_events += 1
                    import sys

                    print(f"[ray_tpu] io loop '{self.name}' handler "
                          f"({kind}) blocked the loop {dt * 1e3:.0f} ms",
                          file=sys.stderr)

    def stats(self) -> dict:
        """Loop-lag counters (analog: event_stats.h per-handler stats)."""
        return {"events": self._events,
                "busy_s": round(self._busy_s, 3),
                "slow_events": self._slow_events,
                "max_handler_s": round(self._max_handler_s, 4)}

    def probe_lag(self):
        """Launch one loop-lag probe: stamp now, wake the loop, and let
        the wakeup handler record how long the wake waited. No-op while
        a probe is already in flight (a wedged loop then simply keeps
        its worst sample instead of stacking probes)."""
        if self._lag_probe_t is None and self._started:
            self._lag_probe_t = time.perf_counter()
            self._wake()

    def lag_stats(self) -> dict:
        """p50/p99/max of the recent self-probe lag samples, in ms."""
        samples = sorted(self._lag_samples)
        n = len(samples)
        if not n:
            return {"loop_lag_samples": 0, "loop_lag_ms_p50": 0.0,
                    "loop_lag_ms_p99": 0.0, "loop_lag_ms_max": 0.0}
        return {
            "loop_lag_samples": n,
            "loop_lag_ms_p50": round(samples[n // 2] * 1e3, 3),
            "loop_lag_ms_p99": round(
                samples[min(n - 1, (n * 99) // 100)] * 1e3, 3),
            "loop_lag_ms_max": round(samples[-1] * 1e3, 3),
        }

    def _service_conn(self, sock, on_message, conn: Connection):
        try:
            data = sock.recv(1 << 22)
        except BlockingIOError:
            return
        except OSError:
            data = b""
        if not data:
            self.remove(sock)
            conn._io_eof(sock)
            return
        for msg in conn.feed(data):
            if conn.dispatch_reply(msg):
                continue
            try:
                on_message(conn, msg)
            except Exception:
                import traceback

                traceback.print_exc()

    def stop(self):
        self._stopped.set()
        self._wake()
        if self._started:
            self._thread.join(timeout=2)
        try:
            self.sel.close()
        except Exception:
            pass


def listen_unix(path: str) -> socket.socket:
    import os

    try:
        os.unlink(path)
    except FileNotFoundError:
        pass
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.bind(path)
    s.listen(128)
    return s


def listen_tcp(host: str = "0.0.0.0", port: int = 0) -> socket.socket:
    """TCP listener for cross-host membership (DCN control plane)."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind((host, port))
    s.listen(128)
    return s


def local_ip() -> str:
    """Best-effort outward-facing IP (no packets sent; UDP connect only)."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect(("8.8.8.8", 80))
        return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"
    finally:
        s.close()


def connect_addr(addr: str, timeout: float = 10.0) -> socket.socket:
    """addr: 'unix:<path>' or 'tcp:<host>:<port>'."""
    if addr.startswith("unix:"):
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(timeout)
        s.connect(addr[5:])
    else:
        _, host, port = addr.split(":")
        s = socket.create_connection((host, int(port)), timeout=timeout)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    s.settimeout(None)
    return s
