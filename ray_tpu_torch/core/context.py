"""CoreContext — the per-process core-worker runtime.

Analog of the reference's ``CoreWorker`` (src/ray/core_worker/core_worker.h:284
— Put :560, Get :667, Wait :706, SubmitTask :830, CreateActor :851,
SubmitActorTask :897) plus its direct task transport
(transport/direct_task_transport.h:75, direct_actor_task_submitter.h:67).
Every process — driver and workers alike — runs one CoreContext: a single IO
thread multiplexing the head connection (GCS+raylet client) and direct
worker-to-worker connections; an in-process memory store for futures; a
shared-memory store client for large objects; a submitter that leases workers
per scheduling class and pushes tasks directly to them; and (in workers) the
task executor.
"""

from __future__ import annotations

import itertools
import os
import queue as queue_mod
import threading
import time
import traceback
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import protocol as P
from .config import get_config
from .exceptions import (ActorDiedError, ActorUnavailableError, GetTimeoutError,
                         ObjectLostError, RayTaskError, TaskCancelledError,
                         TaskError, WorkerCrashedError)
from .function_manager import FunctionManager
from .ids import ActorID, JobID, ObjectID, TaskID, WorkerID
from .memory_store import MemoryStore
from .object_ref import ObjectRef
from .object_store import ShmObjectStore
from .ref_counter import ReferenceCounter
from .serialization import SerializedValue, deserialize, serialize
from . import events as task_events
from .task_spec import (ARG_REF, ARG_VALUE, SchedulingStrategy, TaskSpec,
                        TaskType)

_context: Optional["CoreContext"] = None
_context_lock = threading.Lock()


def get_context() -> "CoreContext":
    if _context is None:
        raise RuntimeError("ray_tpu_torch not initialized — call ray_tpu_torch.init()")
    return _context


def get_context_if_exists() -> Optional["CoreContext"]:
    return _context


def set_context(ctx: Optional["CoreContext"]):
    global _context
    _context = ctx


class _LeasedWorker:
    __slots__ = ("worker_id", "addr", "lease_id", "conn", "inflight",
                 "idle_since", "gpu_ids", "hinted")

    def __init__(self, worker_id, addr, lease_id, conn, gpu_ids=None):
        self.worker_id = worker_id
        self.addr = addr
        self.lease_id = lease_id
        self.conn = conn
        self.inflight: Dict[TaskID, TaskSpec] = {}
        self.idle_since = time.monotonic()
        self.gpu_ids = gpu_ids
        self.hinted = None  # recently PREFETCH_HINTed arg ids (r14 dedupe)


_HINT_CACHE_MAX = 512


def _filter_hint_ids(hinted: dict, ids, now: float, ttl: float) -> list:
    """PREFETCH_HINT dedupe filter (r14): drop ids hinted for this
    lease/actor within ``ttl`` seconds, stamp the survivors, and keep
    the per-holder cache bounded (expired entries evicted first, then
    oldest-stamped — insertion order tracks stamp order because
    re-stamps delete+reinsert)."""
    fresh = []
    for ab in ids:
        ts = hinted.get(ab)
        if ts is not None and now - ts < ttl:
            continue
        hinted.pop(ab, None)
        hinted[ab] = now
        fresh.append(ab)
    if len(hinted) > _HINT_CACHE_MAX:
        for k in [k for k, ts in hinted.items() if now - ts >= ttl]:
            del hinted[k]
        while len(hinted) > _HINT_CACHE_MAX:
            del hinted[next(iter(hinted))]
    return fresh


class _ClassState:
    __slots__ = ("queue", "workers", "pending_leases", "lease_req_ts")

    def __init__(self):
        self.queue: deque = deque()
        self.workers: List[_LeasedWorker] = []
        self.pending_leases = 0
        self.lease_req_ts = 0.0  # when leases were last requested


class _ActorState:
    __slots__ = ("actor_id", "state", "addr", "conn", "queue", "inflight",
                 "seqno", "lock", "resolving", "death_cause", "connecting",
                 "hinted")

    def __init__(self, actor_id):
        self.connecting = False
        self.actor_id = actor_id
        self.state = "UNKNOWN"
        self.addr = ""
        self.conn: Optional[P.Connection] = None
        self.queue: deque = deque()
        self.inflight: Dict[TaskID, TaskSpec] = {}
        self.seqno = itertools.count()
        self.lock = threading.Lock()
        self.resolving = False
        self.death_cause = ""
        self.hinted = None  # recently PREFETCH_HINTed arg ids (r14 dedupe)


class _InflightTask:
    __slots__ = ("spec", "arg_ids", "retries_left", "contained_holder",
                 "worker")

    def __init__(self, spec, arg_ids, retries_left, contained_holder):
        self.spec = spec
        self.arg_ids = arg_ids
        self.retries_left = retries_left
        self.contained_holder = contained_holder  # keeps ObjectRefs alive
        self.worker: Optional[_LeasedWorker] = None  # set when dispatched


class CoreContext:
    def __init__(self, head_addr: str, session_dir: str, node_idx: int,
                 worker_id: Optional[str] = None, is_driver: bool = False,
                 job_id: Optional[JobID] = None):
        self.head_addr = head_addr
        self.session_dir = session_dir
        self.node_idx = node_idx
        self.is_driver = is_driver
        self.worker_id = worker_id or WorkerID.from_random().hex()
        self.job_id = job_id or JobID.from_int(1)
        # thread-local: threaded actors (max_concurrency > 1) execute tasks
        # concurrently, and put() stamps ObjectIDs with the current task id
        self._task_tls = threading.local()
        self._default_task_id = TaskID.for_driver(self.job_id)
        self._put_index = itertools.count(1)

        self.memory_store = MemoryStore()
        self.ref_counter = ReferenceCounter(
            self.worker_id, self._free_owned_object, self._release_borrow)

        # executor / misc state (must exist before any thread starts)
        self.assigned_gpu_ids: List[int] = []
        self._exported_gpu_ids: Optional[List[int]] = None
        # the devices this process was started with (a worker's GPU ids
        # index them)
        self._spawn_visible_devices = os.environ.get("CUDA_VISIBLE_DEVICES")
        self._exec_queue: "queue_mod.Queue" = queue_mod.Queue()
        # batched task completions (run_executor): per-connection reply
        # buffer shared with the reply-flusher thread
        self._reply_buf: Dict[P.Connection, list] = {}
        self._reply_n = 0
        self._reply_lock = threading.Lock()
        self._reply_event = threading.Event()
        self._actor_instance = None
        self._actor_spec: Optional[TaskSpec] = None
        self._cancelled: set = set()
        self._pinned: set = set()
        self._contained: Dict[ObjectID, list] = {}
        self._free_buf: list = []       # buffered OBJECT_FREE id bins
        # re-entrant: an ObjectRef's __del__, run by the garbage collector
        # inside _flush_frees, frees through it again
        self._free_lock = threading.RLock()
        # Borrow-handoff pins: refs we shipped inside a task RESULT stay
        # pinned here for a grace window, so our BORROW_REMOVE cannot
        # outrun the receiver's BORROW_ADD at the owner (chained borrow
        # handoff, e.g. queue actors relaying refs). The reference closes
        # this with borrow metadata embedded in replies; a TTL pin gives
        # the same practical guarantee.
        self._handoff_pins: deque = deque()
        self._handoff_lock = threading.Lock()
        self._shutdown = False
        self._async_loop = None
        self._actors: Dict[ActorID, _ActorState] = {}
        self._pub_handlers: Dict[str, List] = {}
        self._pub_lock = threading.Lock()
        # job-level runtime_env (init(runtime_env=...)): default for every
        # task/actor submitted by this process unless overridden per-spec
        self.job_runtime_env: Optional[dict] = None

        self.io = P.IOLoop(f"io-{self.worker_id[:6]}")
        # Own listener for direct pushes from peers. On a remote node
        # (RAY_TPU_NODE_IP set by its agent) listen on TCP so workers on
        # other hosts can push tasks directly (the reference's
        # CoreWorkerService over gRPC); same-host clusters use unix sockets.
        node_ip = os.environ.get("RAY_TPU_NODE_IP", "")
        if node_ip:
            self._listener = P.listen_tcp("0.0.0.0", 0)
            port = self._listener.getsockname()[1]
            self.listen_path = ""
            self.listen_addr = f"tcp:{node_ip}:{port}"
        else:
            self.listen_path = os.path.join(
                session_dir, f"w_{self.worker_id[:12]}.sock")
            self.listen_addr = f"unix:{self.listen_path}"
            self._listener = P.listen_unix(self.listen_path)
        self.io.add_listener(self._listener, self._on_accept)

        # Head connection (GCS + raylet client). Reconnecting (GCS-FT
        # analog: workers and drivers keep their GCS channel across a
        # gcs_server restart): on ConnectionLost the channel re-dials
        # with backoff up to head_reconnect_timeout_s, re-registers this
        # process (re-claiming its actor identity if it hosts one),
        # re-subscribes pubsub channels, and replays parked call()s —
        # only past the deadline does on_close fire with the old
        # fail-fast semantics (workers exit; driver calls raise).
        self.head = P.ReconnectingConnection(
            head_addr, client_id=self.worker_id, peer="head",
            on_reattach=self._on_head_reattach)
        self.head.on_close = self._on_head_close
        self.io.add_connection(self.head, self._on_head_message)
        self.io.start()

        reply = self.head.call(P.REGISTER, self.worker_id, os.getpid(),
                               self.listen_addr, node_idx, timeout=30)
        store_name = reply[0]
        self.store = ShmObjectStore(store_name)
        # arena evictions drop this node's copy: tell the object directory
        # so pulls stop being routed at a holder that no longer holds
        # (reference: ObjectDirectory location removal on eviction).
        # Async: evict() fires inside store.create on whatever thread is
        # allocating — including the puller IO thread under its buffer
        # lock — and a blocking socket write there would stall every
        # in-flight transfer on this host.
        self.store.on_evict = self._report_evictions_async
        self._stores_by_node: Dict[int, ShmObjectStore] = {node_idx: self.store}

        self.fn_manager = FunctionManager(self.kv_put, self.kv_get)

        # task-state events -> head ring buffer (state API / `list tasks`)
        self.events = task_events.TaskEventBuffer(
            self.head, self.worker_id, node_idx)
        self.events.start()

        # wire saturation -> cluster event log: a connection's write
        # queue hitting its bound means the socket isn't draining; the
        # events page should show it instead of it failing silently
        # (protocol rate-limits the callback per connection)
        P.set_backpressure_callback(self._on_wire_backpressure)
        # the metrics pusher normally starts with the first Metric object;
        # start it unconditionally so the wire fast-path counters
        # (frames coalesced, batched completions, zero-copy bytes) reach
        # the head aggregate from every process
        from ray_tpu_torch import metrics as _metrics

        _metrics._ensure_pusher()

        # submitter
        self._classes: Dict[tuple, _ClassState] = {}
        self._inflight: Dict[TaskID, _InflightTask] = {}
        self._return_to_task: Dict[ObjectID, TaskID] = {}
        # Lineage cache: plasma-resident task results -> creating TaskSpec,
        # kept past task completion so a lost object can be reconstructed by
        # re-executing its task (reference: lineage pinning in the owner's
        # ReferenceCounter + ObjectRecoveryManager::RecoverObject,
        # object_recovery_manager.h:41). FIFO-capped; put() objects are
        # not reconstructable, matching the reference.
        self._lineage: "OrderedDict[ObjectID, TaskSpec]" = OrderedDict()
        self._recovering: set = set()  # TaskIDs being re-executed
        # borrowed-ref owners, for routing reconstruction requests
        self._known_owners: Dict[ObjectID, str] = {}
        self._dep_unready: set = set()  # actor tasks awaiting arg resolution
        # PREFETCH_HINT accounting (r14): frames actually sent vs arg
        # ids suppressed by the per-lease/per-actor dedupe window;
        # r15 adds coalescing — hints buffer per destination key and
        # flush from the submitter loop as ONE frame, so a pipeline hot
        # loop pushing fresh per-microbatch refs doesn't emit a frame
        # per pushed batch. prefetch_hints_coalesced counts the frames
        # saved (hint batches merged into an already-pending flush).
        self.prefetch_hints_sent = 0
        self.prefetch_hints_suppressed = 0
        self.prefetch_hints_coalesced = 0
        # r16: hint-buffer values are [arg_ids, inline_ids] — the
        # second list tags which ids are INLINE-PROMOTED objects
        # (_promote_if_needed materialized a tiny owner value into the
        # store only so a borrower could fetch it, e.g. a pipeline
        # backward cotangent); the head counts their pulls apart so
        # the prefetch waste-ratio check measures only real
        # speculation. Bounded id memory below.
        self._hint_buf: "OrderedDict[str, list]" = OrderedDict()
        self._hint_lock = threading.Lock()
        self._inline_promoted: "OrderedDict[bytes, None]" = OrderedDict()
        self._sub_lock = threading.RLock()
        self._submit_event = threading.Event()
        self._submitter = threading.Thread(target=self._submitter_loop,
                                           daemon=True, name="submitter")
        self._submitter.start()


    # ================================================== connections / IO

    def _on_accept(self, sock, addr):
        conn = P.Connection(sock, peer="peer-in")
        self.io.add_connection(conn, self._on_peer_message)

    def _on_peer_message(self, conn: P.Connection, msg):
        mt = msg[0]
        if mt == P.PUSH_TASK:
            self._exec_queue.put((msg[2], conn))
        elif mt == P.PUSH_TASK_BATCH:
            for spec in msg[2]:
                self._exec_queue.put((spec, conn))
        elif mt == P.PUSH_CANCEL:
            self._cancelled.add(TaskID(msg[2]))
        elif mt == P.TASK_REPLY:
            self._handle_task_reply(conn, *msg[2:])
        elif mt == P.TASK_DONE_BATCH:
            # one frame, many completions (the return-side mirror of
            # PUSH_TASK_BATCH) — unpickled once, bookkeeping cleared
            # under ONE lock hold, one submitter wakeup for the frame
            self._handle_task_reply_batch(conn, msg[2])

    def _on_head_message(self, conn: P.Connection, msg):
        mt = msg[0]
        if mt == P.PUSH_TASK:
            # actor creation task pushed by the head scheduler
            self._exec_queue.put((msg[2], conn))
        elif mt == P.LEASE_GRANT_BATCH:
            # one batched dispatch pass granted several of our queued
            # lease requests in ONE frame: complete each blocked
            # _request_lease call() with its LEASE_REPLY-shaped fields
            for rid, worker_id, addr, lease_id, gpu_ids in msg[2]:
                if not self.head.complete_reply(
                        rid, (True, worker_id, addr, lease_id, None,
                              gpu_ids)):
                    # requester thread gave up (shutdown): return the
                    # lease so the worker doesn't leak
                    try:
                        self.head.send(P.RETURN_WORKER, lease_id,
                                       worker_id)
                    except P.ConnectionLost:
                        pass
        elif mt == P.PUBLISH:
            channel, payload = msg[2], msg[3]
            with self._pub_lock:
                handlers = list(self._pub_handlers.get(channel, ()))
            from .serialization import loads

            data = loads(payload)
            for h in handlers:
                try:
                    h(data)
                except Exception:
                    traceback.print_exc()
        elif mt == P.BORROW_ADD:
            self.ref_counter.add_borrower(ObjectID(msg[2]), msg[3])
        elif mt == P.BORROW_REMOVE:
            self.ref_counter.remove_borrower(ObjectID(msg[2]), msg[3])
        elif mt == P.RECOVER_OBJECT:
            # a borrower hit a lost object we own — reconstruct off the IO
            # thread (recovery does blocking head calls)
            oid = ObjectID(msg[2])
            threading.Thread(target=self._recover_object, args=(oid,),
                             daemon=True).start()
        elif mt == P.KILL_ACTOR:
            os._exit(0)

    def _on_wire_backpressure(self, peer: str, frames: int, nbytes: int):
        """protocol.set_backpressure_callback target (already off the
        send hot path, on a short-lived thread)."""
        if self._shutdown:
            return
        try:
            sev, src, etype, msg, extra = \
                task_events.wire_backpressure_fields(peer, frames, nbytes)
            task_events.emit_cluster_event(sev, src, etype, msg,
                                           extra=extra)
        except Exception:  # noqa: BLE001 — observability must never wedge
            pass

    def _on_head_close(self, conn):
        # fires only once the reconnecting channel gives up (reconnect
        # window expired) or on deliberate shutdown — transient head
        # loss within head_reconnect_timeout_s never reaches here
        if not self._shutdown and not self.is_driver:
            # head gone — worker exits (reference: raylet death kills workers)
            os._exit(1)

    def _on_head_reattach(self, conn):
        """Reconnector-thread hook: the head channel came back — the
        peer may be a RESTARTED head with empty worker/actor tables.
        Re-register this process (with its actor spec, so a surviving
        actor worker re-claims its identity and named actors keep their
        state), re-subscribe every pubsub channel, and nudge the
        submitter so queued work re-requests leases. Runs BEFORE parked
        senders and replayed call()s resume.

        The node this process lives on may itself still be
        re-registering (its agent races us on an independent channel):
        REGISTER is retried while the head answers "no node"."""
        if self._shutdown:
            return
        aspec = None
        if self._actor_spec is not None:
            from .serialization import dumps as _dumps

            aspec = _dumps(self._actor_spec)
        deadline = time.monotonic() + \
            get_config().head_reconnect_timeout_s
        while True:
            try:
                conn.call(P.REGISTER, self.worker_id, os.getpid(),
                          self.listen_addr, self.node_idx, aspec,
                          timeout=10)
                break
            except P.ConnectionLost:
                raise  # socket died again: the reconnector retries
            except Exception:
                # most likely "no node N" — our agent hasn't finished
                # its own re-registration yet
                if time.monotonic() > deadline or self._shutdown:
                    raise
                time.sleep(0.2)
        with self._pub_lock:
            channels = list(self._pub_handlers)
        for ch in channels:
            conn.send(P.SUBSCRIBE, ch)
        ev = getattr(self, "_submit_event", None)
        if ev is not None:  # a reattach can race __init__'s tail
            ev.set()

    def subscribe(self, channel: str, handler, *, ack: bool = True):
        """``ack=False`` sends the subscription one-way — frames on this
        connection are processed in order, so anything we send AFTER it
        is sequenced behind the registration. The actor-watch hot path
        uses it: a blocking round trip per created actor serializes
        mass actor creation behind a busy head (and the initial-state
        race it would close is already covered by the GET_ACTOR fallback
        in _resolve_actor)."""
        with self._pub_lock:
            first = channel not in self._pub_handlers
            self._pub_handlers.setdefault(channel, []).append(handler)
        if first:
            if ack:
                self.head.call(P.SUBSCRIBE, channel, timeout=30)
            else:
                self.head.send(P.SUBSCRIBE, channel)

    def unsubscribe(self, channel: str, handler) -> None:
        """Remove one handler registered via ``subscribe``. The head
        subscription itself stays (cheap; channels are few and other
        handlers may share it) — this exists so long-lived drivers
        that register per-object handlers (e.g. a Pipeline's drain
        watchers) can drop them at shutdown instead of growing the
        handler list forever."""
        with self._pub_lock:
            lst = self._pub_handlers.get(channel)
            if lst is not None:
                try:
                    lst.remove(handler)
                except ValueError:
                    pass

    def publish(self, channel: str, data):
        from .serialization import dumps

        self.head.send(P.PUBLISH, channel, dumps(data))

    # ================================================== KV

    def kv_put(self, ns, key, value, overwrite=True) -> bool:
        return self.head.call(P.KV_PUT, ns, key, value, overwrite,
                              timeout=30)[0]

    def kv_get(self, ns, key):
        return self.head.call(P.KV_GET, ns, key, timeout=30)[0]

    def kv_del(self, ns, key) -> bool:
        return self.head.call(P.KV_DEL, ns, key, timeout=30)[0]

    def kv_keys(self, ns, prefix="") -> list:
        return self.head.call(P.KV_KEYS, ns, prefix, timeout=30)[0]

    # ================================================== put / get / wait

    @property
    def current_task_id(self):
        return getattr(self._task_tls, "task_id", self._default_task_id)

    @current_task_id.setter
    def current_task_id(self, tid):
        self._task_tls.task_id = tid

    @property
    def current_job_id(self):
        """The job whose code is running on THIS thread: the executing
        task's spec.job_id inside a task/actor method, this context's
        own job otherwise (driver puts). Seal reports stamp it onto
        directory entries for per-job memory attribution."""
        return getattr(self._task_tls, "job_id", None) or self.job_id

    @current_job_id.setter
    def current_job_id(self, jid):
        self._task_tls.job_id = jid

    def put(self, value: Any) -> ObjectRef:
        oid = ObjectID.for_put(self.current_task_id, next(self._put_index))
        sv = serialize(value)
        self.ref_counter.add_owned(oid)
        if sv.contained_refs:
            # Inner refs stay alive at least as long as the outer object is
            # tracked by this owner (simplified containment pinning; the
            # reference tracks contained ids in the outer's metadata).
            # They also count as SHARED: a peer that fetches the outer
            # object deserializes them and its BORROW_ADD may still be in
            # flight when our containment pin drops — the free must take
            # the grace window.
            self._contained[oid] = list(sv.contained_refs)
            for r in sv.contained_refs:
                self.ref_counter.mark_shared(r.id)
        total = self.store.put_serialized(oid, sv.frames)
        # size on the wire is DATA bytes (sv.total_bytes): the whole
        # transfer plane (stripe ranges, pull buffers, relay parts)
        # keys on it; store-exact accounting compares against
        # memory_stats()["sealed_data_bytes"], which counts the same
        self.head.send(P.OBJECT_SEALED, oid.binary(), self.node_idx,
                       sv.total_bytes, self.worker_id,
                       self.current_job_id.hex())
        self.memory_store.put_plasma_location(oid, self.node_idx,
                                              size=total)
        return ObjectRef(oid, self.worker_id)

    def tag_objects(self, refs, tag: str):
        """Stamp a reference-class tag (memory observatory) onto the
        head directory entries behind ``refs`` — e.g. the pipeline
        tags its held checkpoint refs "checkpoint" so `ray_tpu memory`
        can split resident bytes by what is holding them. One-way and
        advisory: unsealed/freed ids are ignored by the head."""
        oid_bins = [(r.id if hasattr(r, "id") else r).binary()
                    for r in refs]
        if not oid_bins:
            return
        try:
            self.head.send(P.OBJ_TAG, oid_bins, tag)
        except P.ConnectionLost:
            pass

    def _report_evictions_async(self, oids: Sequence[ObjectID]):
        """store.on_evict hook: report off-thread so the allocating thread
        (often the puller IO thread) never blocks on a head socket write."""
        from .object_transfer import send_eviction_report_async

        if self._shutdown:
            return
        send_eviction_report_async(self.head, self.node_idx, oids)

    def _report_evictions(self, oids: Sequence[ObjectID]):
        """Synchronous variant — deterministic for tests that must observe
        the directory update before their next head call."""
        from .object_transfer import send_eviction_report

        if self._shutdown:
            return
        send_eviction_report(self.head, self.node_idx, oids)

    def get(self, refs: Sequence[ObjectRef], timeout: Optional[float] = None
            ) -> List[Any]:
        oids = [r.id for r in refs]
        self._ensure_resolution(refs)
        ready = self.memory_store.wait_ready(oids, len(oids), timeout)
        if len(ready) < len(set(oids)):
            raise GetTimeoutError(
                f"get() timed out after {timeout}s; "
                f"{len(set(oids)) - len(ready)} objects pending")
        return [self._resolve_value(oid) for oid in oids]

    def wait(self, refs: Sequence[ObjectRef], num_returns: int,
             timeout: Optional[float], fetch_local: bool = True
             ) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        self._ensure_resolution(refs)
        ready_ids = set(self.memory_store.wait_ready(
            [r.id for r in refs], num_returns, timeout))
        ready, rest = [], []
        for r in refs:
            if r.id in ready_ids and len(ready) < num_returns:
                ready.append(r)
            else:
                rest.append(r)
        return ready, rest

    def as_future(self, ref: ObjectRef):
        import concurrent.futures

        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._ensure_resolution([ref])

        def _cb():
            try:
                fut.set_result(self._resolve_value(ref.id))
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)

        self.memory_store.add_ready_callback(ref.id, _cb)
        return fut

    def _resolve_value(self, oid: ObjectID) -> Any:
        attempts = get_config().object_recovery_max_attempts
        last_err: Optional[Exception] = None
        for attempt in range(attempts + 1):
            e = self.memory_store.peek(oid)
            if e is None:
                # a concurrent _recover_object evicts the entry before the
                # re-executed task reseals it — wait, don't declare lost
                with self._sub_lock:
                    pending = oid in self._return_to_task
                if pending:
                    if not self.memory_store.wait_ready([oid], 1,
                                                        timeout=120):
                        raise GetTimeoutError(
                            f"timed out reconstructing {oid.hex()}")
                    continue
                raise ObjectLostError(oid.hex())
            if e.is_error:
                err = e.value
                if isinstance(err, TaskError):
                    raise RayTaskError(err)
                raise err
            if not e.in_plasma or e.value is not None:
                return e.value
            try:
                e.value = self._fetch_from_plasma(oid, e.node_idx)
                return e.value
            except GetTimeoutError:
                raise
            except Exception as fetch_err:  # noqa: BLE001 — copies lost
                last_err = fetch_err
                if attempt >= attempts:
                    break
                if self._recover_object(oid):
                    if not self.memory_store.wait_ready([oid], 1,
                                                        timeout=120):
                        raise GetTimeoutError(
                            f"timed out reconstructing {oid.hex()}")
                    continue
                owner = self._known_owners.get(oid)
                if not owner or owner == self.worker_id:
                    break
                # borrowed ref: the lineage lives with the owner — ask it
                # to reconstruct, then re-locate (blocking) from scratch
                self.memory_store.evict(oid)
                self._pinned.discard(oid)
                self._background_fetch(oid)
        raise ObjectLostError(
            f"{oid.hex()}: all copies lost and not reconstructable "
            f"({last_err})") from last_err

    def _fetch_from_plasma(self, oid: ObjectID, node_idx: int) -> Any:
        if not self.store.contains(oid):
            # Pull to the local node's store (reference: PullManager). The
            # contains() probe comes FIRST: with locality-aware placement
            # this node is often already a holder even when the locate
            # reply named another node as primary — a local sealed copy
            # means zero transfer RPCs and zero bytes moved.
            self.head.call(P.OBJECT_TRANSFER, oid.binary(), self.node_idx,
                           timeout=120)
        # pin_borrows: out-of-band frames come back as ledger-tracked
        # views, so a value that ALIASES arena memory (numpy oob
        # reconstruction, the r13 device-array rebuild) keeps the entry
        # pinned for its own lifetime — a free/spill racing the live
        # view defers instead of recycling the slot under it
        frames = self.store.get_frames(oid, pin_borrows=True)
        if frames is None:
            raise ObjectLostError(f"{oid.hex()} not in local store")
        self._pinned.add(oid)
        return deserialize(frames)

    def _ensure_resolution(self, refs: Sequence[ObjectRef]):
        """For refs we don't own and aren't already expecting, fetch in the
        background so wait_ready can complete."""
        for r in refs:
            oid = r.id
            if self.memory_store.contains(oid):
                continue
            with self._sub_lock:
                expected = oid in self._return_to_task
            if expected:
                continue
            t = threading.Thread(target=self._background_fetch, args=(oid,),
                                 daemon=True)
            t.start()

    def _background_fetch(self, oid: ObjectID):
        attempts = get_config().object_recovery_max_attempts
        for attempt in range(attempts + 1):
            try:
                node_idx, size, spilled = self.head.call(
                    P.OBJECT_LOCATE, oid.binary(), True, timeout=None)
            except Exception:
                return
            if node_idx != -2:
                self.memory_store.put_plasma_location(oid, node_idx)
                return
            # lost with its node — reconstruct (we own it) or ask the
            # owner, who holds the lineage, to (we borrowed it)
            if self._recover_object(oid):
                return  # re-execution repopulates the entry on reply
            owner = self._known_owners.get(oid)
            if owner and owner != self.worker_id and attempt < attempts:
                try:
                    self.head.send(P.RECOVER_OBJECT, oid.binary(), owner)
                except P.ConnectionLost:
                    break
                # give the owner a beat to clear the LOST marker, then the
                # blocking locate above waits for the re-seal
                time.sleep(0.2 * (attempt + 1))
                continue
            break
        self.memory_store.put_value(
            oid, ObjectLostError(
                f"{oid.hex()}: all copies lost and no lineage"),
            is_error=True)

    def _recover_object(self, oid: ObjectID) -> bool:
        """Lineage reconstruction (reference: ObjectRecoveryManager::
        RecoverObject, object_recovery_manager.h:41): re-execute the task
        that created a lost object, reusing its TaskID so the re-sealed
        results land under the same ObjectIDs consumers already hold.
        Returns False when the object has no retained lineage (e.g. a
        put() object, or evicted from the FIFO lineage cache)."""
        with self._sub_lock:
            spec = self._lineage.get(oid)
            if spec is None:
                return False
            if spec.task_id in self._recovering or \
                    spec.task_id in self._inflight:
                return True  # re-execution already underway
            self._recovering.add(spec.task_id)
        returns = spec.return_ids()
        # Un-mark LOST head-side so consumers' blocking locates queue for
        # the re-seal instead of failing fast.
        try:
            self.head.send(P.OBJECT_RECOVERING,
                           [r.binary() for r in returns])
        except P.ConnectionLost:
            with self._sub_lock:
                self._recovering.discard(spec.task_id)
            return False
        # Recover lost plasma args first (recursive lineage walk): the
        # executing worker's blocking locate then waits for their re-seal.
        # An arg that is lost AND unrecoverable (freed, or lineage evicted)
        # aborts the whole recovery — enqueueing anyway would wedge the
        # executing worker on a locate that can never be answered.
        for enc in spec.args:
            if enc[0] != ARG_REF:
                continue
            aid = ObjectID(enc[1])
            e = self.memory_store.peek(aid)
            if e is not None and not e.in_plasma:
                continue  # inline value still in the in-process store
            try:
                node_idx, _, spilled = self.head.call(
                    P.OBJECT_LOCATE, aid.binary(), False, timeout=30)
            except Exception:  # noqa: BLE001
                continue
            if node_idx == -2 or (node_idx < 0 and not spilled):
                if not self._recover_object(aid):
                    with self._sub_lock:
                        self._recovering.discard(spec.task_id)
                    return False
        # Register the re-execution BEFORE evicting the stale entries:
        # concurrent getters that peek a missing entry check
        # _return_to_task and wait instead of raising ObjectLostError.
        if spec.strategy.kind == "NODE_AFFINITY":
            # the original placement may name a dead node — reconstruction
            # is free to run anywhere
            spec.strategy = SchedulingStrategy()
        inflight = _InflightTask(spec, [], spec.max_retries, [])
        cls = spec.scheduling_class()
        with self._sub_lock:
            self._inflight[spec.task_id] = inflight
            for roid in returns:
                self._return_to_task[roid] = spec.task_id
        for roid in returns:
            self.memory_store.evict(roid)
            self._pinned.discard(roid)
        with self._sub_lock:
            st = self._classes.setdefault(cls, _ClassState())
            st.queue.append(spec)
        self._submit_event.set()
        return True

    # ================================================== GC callbacks

    def _free_owned_object(self, oid: ObjectID):
        if self._shutdown:
            return  # late GC-grace timer; stores/conns are torn down
        self._contained.pop(oid, None)
        with self._sub_lock:
            self._lineage.pop(oid, None)
        entry = self.memory_store.peek(oid)
        # any-node shm residency: freeing promptly lets that arena
        # reclaim; peeking the in-process entry is far cheaper than
        # probing the shm index on every small free
        shm_resident = bool(entry is not None and entry.in_plasma)
        # Large local copies are reclaimed NOW rather than when the head
        # gets around to processing our OBJECT_FREE: under a large-put
        # flood the head lags, bytes_in_use rides the spill threshold,
        # and the head then spills objects that are already free —
        # measured collapsing put bandwidth by an order of magnitude.
        # Size-gated: the native delete costs a ~0.2 ms locked call on
        # the deployment kernel, which for small objects (negligible
        # arena pressure) is pure overhead on the free path. Idempotent
        # with the head's directory-driven delete; a copy pinned by an
        # in-flight transfer just fails the delete and falls back there.
        local_delete = (shm_resident and entry.node_idx == self.node_idx
                        and entry.plasma_size >= (1 << 20))
        self.memory_store.evict(oid)
        if oid in self._pinned:
            self._pinned.discard(oid)
            try:
                self.store.release(oid)
            except Exception:
                pass
        if local_delete:
            try:
                self.store.delete(oid)
            except Exception:
                pass
        # Small (inline / memory-store) objects: buffer the head
        # notification — at high call rates one OBJECT_FREE frame per
        # freed return-ref doubles the driver->head message count
        # (measured in the n_n actor microbench), and for these the
        # message is pure GC accounting. Shm-resident objects flush
        # IMMEDIATELY: delaying their free keeps arena bytes_in_use high
        # and trips the head's spill threshold (measured 4x put-bandwidth
        # collapse with a 0.2 s delay).
        with self._free_lock:
            self._free_buf.append(oid.binary())
            flush = shm_resident or len(self._free_buf) >= 64
        if flush:
            self._flush_frees()

    def _flush_frees(self):
        with self._free_lock:
            batch, self._free_buf = self._free_buf, []
        if not batch:
            return
        try:
            self.head.send(P.OBJECT_FREE, batch)
        except P.ConnectionLost:
            pass

    def _release_borrow(self, oid: ObjectID, owner: str):
        self._known_owners.pop(oid, None)
        self.memory_store.evict(oid)
        if oid in self._pinned:
            self._pinned.discard(oid)
            try:
                self.store.release(oid)
            except Exception:
                pass
        try:
            self.head.send(P.BORROW_REMOVE, oid.binary(), owner,
                           self.worker_id)
        except P.ConnectionLost:
            pass

    def notify_deserialized_ref(self, ref: ObjectRef):
        if ref.owner and ref.owner != self.worker_id:
            self._known_owners[ref.id] = ref.owner
            try:
                self.head.send(P.BORROW_ADD, ref.id.binary(), ref.owner,
                               self.worker_id)
            except P.ConnectionLost:
                pass

    # ================================================== task submission

    def submit_task(self, fn, args, kwargs, *, num_returns=1, resources=None,
                    strategy=None, max_retries=None, retry_exceptions=False,
                    name="", runtime_env=None,
                    prefetch_args=True) -> List[ObjectRef]:
        cfg = get_config()
        fn_id = self.fn_manager.export(fn)
        task_id = TaskID.for_normal_task(self.job_id)
        spec = TaskSpec(
            task_id=task_id, job_id=self.job_id, task_type=TaskType.NORMAL,
            name=name or getattr(fn, "__name__", "task"),
            function_id=fn_id,
            num_returns=num_returns,
            resources=resources if resources is not None else {"CPU": 1},
            strategy=strategy or SchedulingStrategy(),
            max_retries=(cfg.task_max_retries_default
                         if max_retries is None else max_retries),
            retry_exceptions=retry_exceptions,
            owner=self.worker_id,
            runtime_env=runtime_env or self.job_runtime_env,
            prefetch_args=prefetch_args,
            trace_ctx=task_events.submit_trace_ctx(),
        )
        arg_ids, holder = self._encode_args(spec, args, kwargs)
        self.events.record(task_id.hex(), spec.name, task_events.SUBMITTED,
                           trace_id=spec.trace_ctx[0],
                           parent_span_id=spec.trace_ctx[1])
        return self._enqueue_spec(spec, arg_ids, holder)

    def _encode_args(self, spec: TaskSpec, args, kwargs):
        encoded = []
        arg_ids: List[ObjectID] = []
        holder: list = []
        for a in list(args) + list(kwargs.values()):
            if isinstance(a, ObjectRef):
                self._promote_if_needed(a)
                encoded.append((ARG_REF, a.id.binary(), a.owner or
                               self.worker_id))
                arg_ids.append(a.id)
                holder.append(a)
                self.ref_counter.add_task_arg(a.id)
            else:
                sv = serialize(a)
                for r in sv.contained_refs:
                    self._promote_if_needed(r)
                    arg_ids.append(r.id)
                    holder.append(r)
                    self.ref_counter.add_task_arg(r.id)
                encoded.append((ARG_VALUE,
                                [bytes(f) if isinstance(f, memoryview)
                                 else f for f in sv.frames]))
        spec.args = encoded
        spec.kwarg_names = list(kwargs.keys())
        return arg_ids, holder

    def _promote_if_needed(self, ref: ObjectRef):
        """Ensure a ref being lent out is materialized in the shm store so
        borrowers can fetch it (reference: inline-object promotion)."""
        e = self.memory_store.peek(ref.id)
        if e is None or e.in_plasma or e.is_error:
            return
        if (ref.owner or self.worker_id) != self.worker_id:
            return
        sv = serialize(e.value)
        try:
            self.store.put_serialized(ref.id, sv.frames)
        except Exception:
            return
        self.head.send(P.OBJECT_SEALED, ref.id.binary(), self.node_idx,
                       sv.total_bytes, self.worker_id,
                       self.current_job_id.hex())
        e.in_plasma = True
        e.node_idx = self.node_idx
        e.plasma_size = sv.total_bytes
        # remember the id so dispatch-time prefetch hints can tag it:
        # pulls of inline-promoted tiny values are not the speculation
        # the head's waste-ratio accounting should judge (r16)
        with self._hint_lock:
            ip = self._inline_promoted
            ip[ref.id.binary()] = None
            while len(ip) > 4096:
                ip.popitem(last=False)

    def _enqueue_spec(self, spec: TaskSpec, arg_ids, holder) -> List[ObjectRef]:
        refs = [ObjectRef(oid, self.worker_id, _register=False)
                for oid in spec.return_ids()]
        for r in refs:
            self.ref_counter.add_owned(r.id)
            self.ref_counter.add_local_ref(r)
            r._registered = True
        inflight = _InflightTask(spec, arg_ids, spec.max_retries, holder)
        cls = spec.scheduling_class()
        wake = True
        with self._sub_lock:
            self._inflight[spec.task_id] = inflight
            for oid in spec.return_ids():
                self._return_to_task[oid] = spec.task_id
            if not holder:
                # No arg refs → nothing to resolve: queue directly under
                # the same lock acquisition (the high-rate submission path).
                st = self._classes.setdefault(cls, _ClassState())
                # wake the submitter only when the queue was idle: with
                # work already queued the drain loop re-checks the queue
                # under this same lock before sleeping, so it cannot
                # miss this append — and an Event.set() per submit was
                # a measurable lock ping-pong at flood rates
                wake = not st.queue
                st.queue.append(spec)
        if not holder:
            self.events.record(spec.task_id.hex(), spec.name,
                               task_events.PENDING_NODE_ASSIGNMENT)
            if wake:
                self._submit_event.set()
            return refs
        self.events.record(spec.task_id.hex(), spec.name,
                           task_events.PENDING_ARGS_AVAIL)
        self._resolve_then(spec, holder,
                           lambda: self._enqueue_ready(spec, cls))
        return refs

    def _enqueue_ready(self, spec: TaskSpec, cls):
        with self._sub_lock:
            st = self._classes.setdefault(cls, _ClassState())
            st.queue.append(spec)
        self.events.record(spec.task_id.hex(), spec.name,
                           task_events.PENDING_NODE_ASSIGNMENT)
        self._submit_event.set()

    def _resolve_then(self, spec: TaskSpec, holder, on_ready, on_error=None):
        """Submitter-side dependency resolution (the reference's
        LocalDependencyResolver, core_worker/transport/dependency_resolver.h):
        hold the task until every *owned* arg object is ready, propagate an
        upstream error straight to this task's returns, and promote
        inline-only values into the shm store so the executing worker can
        fetch them by location. Borrowed refs resolve via the owner's
        promotion at lend time + head locate."""
        owned: Dict[ObjectID, ObjectRef] = {}
        for ref in holder:
            if (ref.owner or self.worker_id) == self.worker_id:
                owned.setdefault(ref.id, ref)

        def finalize():
            err = None
            for oid, ref in owned.items():
                e = self.memory_store.peek(oid)
                if e is None:
                    continue
                if e.is_error:
                    err = e.value
                    break
                if not e.in_plasma:
                    self._promote_if_needed(ref)
            if err is not None:
                if on_error is not None:
                    on_error(err)
                else:
                    self._complete_task_error(spec, err)
                    self._submit_event.set()
            else:
                on_ready()

        pending = [oid for oid in owned
                   if not self.memory_store.contains(oid)]
        if not pending:
            finalize()
            return
        state = {"n": len(pending)}
        lock = threading.Lock()

        def cb():
            with lock:
                state["n"] -= 1
                done = state["n"] == 0
            if done:
                finalize()

        for oid in pending:
            self.memory_store.add_ready_callback(oid, cb)

    def _submitter_loop(self):
        while not self._shutdown:
            self._submit_event.wait(0.2)
            self._submit_event.clear()
            self._purge_handoff_pins()
            try:
                with self._sub_lock:
                    classes = list(self._classes.items())
                for cls, st in classes:
                    self._drain_class(cls, st)
                self._flush_prefetch_hints()
                self._reap_idle_leases()
                self._flush_frees()
            except Exception:
                traceback.print_exc()

    def _drain_class(self, cls, st: _ClassState):
        """Dispatch queued tasks of one scheduling class.

        Policy (replaces the reference's lease-per-task + spillback cycle,
        direct_task_transport.h:177): aim for one leased worker per queued
        task up to ``max_workers_per_node`` — the head queues ungrantable
        lease requests and `_request_lease` hands back grants that arrive
        after the queue empties. Dispatch fills workers least-loaded-first
        up to an even share ``T`` of the outstanding work, batching each
        worker's refill into ONE framed message (one pickle, one syscall),
        and leaves the remainder queued for leases still in flight — so a
        burst of a few long tasks spreads across workers while a flood of
        tiny tasks still pipelines ``max_tasks_in_flight_per_worker`` deep.
        """
        cfg = get_config()
        # A class that leases GPUs runs one task per leased worker: each
        # lease binds its own devices, and queueing a second GPU task
        # behind the first on one worker serializes work the node had
        # devices to run at once. The even share below cannot prevent
        # that: it counts a pending lease for 1 s, and a worker that takes
        # longer to start (seconds under load) made both tasks of a
        # two-lease burst queue on the first worker.
        cap = 1 if dict(cls[1]).get("GPU", 0) > 0 \
            else cfg.max_tasks_in_flight_per_worker
        to_release: List[_LeasedWorker] = []
        while True:
            with self._sub_lock:
                if not st.queue:
                    break
                total_inflight = sum(len(w.inflight) for w in st.workers)
                demand = len(st.queue) + total_inflight
                wanted = min(
                    min(demand, cfg.max_workers_per_node)
                    - len(st.workers) - st.pending_leases,
                    cfg.max_pending_lease_requests_per_class
                    - st.pending_leases)
                if wanted > 0:
                    st.lease_req_ts = time.monotonic()
                for _ in range(max(0, wanted)):
                    st.pending_leases += 1
                    threading.Thread(
                        target=self._request_lease, args=(cls, st),
                        daemon=True).start()
                if wanted > 0 and not st.workers:
                    # Starved class: give back idle leases held by OTHER
                    # classes now, not after the 2s idle reap — their held
                    # resources are exactly what blocks our lease grants.
                    for ocls, ost in self._classes.items():
                        if ocls == cls or ost.queue:
                            continue
                        keep = []
                        for w in ost.workers:
                            (to_release if not w.inflight
                             else keep).append(w)
                        ost.workers = keep
                worker = None
                n_free = 0
                for w in st.workers:
                    if len(w.inflight) < cap:
                        n_free += 1
                        if worker is None or \
                                len(w.inflight) < len(worker.inflight):
                            worker = w
                if worker is None:
                    break
                # Even share across free workers plus leases that are
                # FRESH (requested < 1s ago): hold work back for workers
                # about to arrive, but a pending lease can be ungrantable
                # forever on a saturated node — once stale, stop counting
                # it, or the share shrinks to ~1 and a small burst
                # serializes into one round-trip per task.
                fresh = (st.pending_leases
                         if time.monotonic() - st.lease_req_ts < 1.0 else 0)
                targets = n_free + fresh
                share = max(1, (demand + targets - 1) // targets)
                slots = min(cap, share) - len(worker.inflight)
                if slots <= 0:
                    break  # all workers at their share; wait for leases
                batch = []
                while st.queue and len(batch) < slots:
                    spec = st.queue.popleft()
                    if spec.task_id in self._cancelled:
                        self._finish_cancelled(spec)
                        continue
                    spec.gpu_ids = worker.gpu_ids
                    worker.inflight[spec.task_id] = spec
                    inf = self._inflight.get(spec.task_id)
                    if inf is not None:
                        inf.worker = worker
                    batch.append(spec)
                worker.idle_since = time.monotonic()
            if not batch:
                continue
            self._send_prefetch_hint(worker, batch, worker.lease_id)
            try:
                if len(batch) == 1:
                    worker.conn.send(P.PUSH_TASK, batch[0], 0)
                else:
                    worker.conn.send(P.PUSH_TASK_BATCH, batch)
                for spec in batch:
                    self.events.record(spec.task_id.hex(), spec.name,
                                       task_events.SUBMITTED_TO_WORKER)
            except P.ConnectionLost:
                self._on_lease_worker_lost(cls, st, worker)
        for w in to_release:
            try:
                self.head.send(P.RETURN_WORKER, w.lease_id, w.worker_id)
            except P.ConnectionLost:
                pass
            w.conn.on_close = None
            w.conn.close()

    def _send_prefetch_hint(self, holder, batch, lease_key: str) -> None:
        """Dispatch-time speculative prefetch (r13): name the pushed
        batch's by-ref args for the executing node so the head can
        start any missing pulls while the batch is still in flight to
        the worker — leases are long-lived, so the grant-time hint
        covers only the first task. One one-way frame per
        batch-with-refs (coalesced by the wire layer); tasks without
        by-ref args (the common case at high rates) pay nothing.

        r14: ``holder`` is whichever object pins the destination — a
        ``_LeasedWorker`` (``lease_key`` = its lease id) or an
        ``_ActorState`` (``lease_key`` = ``actor:<hex>``, resolved to
        the actor's node head-side) — so actor-task hot loops (the
        serve-handle pattern) get dispatch-time prefetch too. Hints
        are DEDUPED per holder across consecutive batches: re-passing
        the same refs on every call (handle payload/weights args)
        would otherwise re-name the same ids to the head once per
        pushed batch, and the head's own dedupe only saves the pull,
        not the frame or the IO-loop wakeup. Each holder remembers the
        arg ids it hinted within ``prefetch_hint_dedupe_ttl_s``; only
        novel (or expired) ids ship. Suppressions are counted in
        ``self.prefetch_hints_suppressed``."""
        cfg = get_config()
        if not cfg.arg_prefetch_enabled:
            return
        # NEVER block dispatch on the head channel: during a head
        # outage a ReconnectingConnection PARKS writes for the whole
        # reconnect window, and this send runs on the submitter thread
        # right before pushing tasks to healthy leased workers — a
        # parked hint would stall all dispatch for the outage, undoing
        # the r12 availability. Speculation just skips the window.
        if not self.head.is_attached():
            return
        ids = list(dict.fromkeys(
            enc[1] for spec in batch
            if getattr(spec, "prefetch_args", True)
            for enc in spec.args if enc[0] == ARG_REF))[:64]
        if not ids:
            return
        if cfg.prefetch_hint_dedupe_ttl_s > 0:
            # _hint_lock: concurrent drains of the same holder (proxy
            # thread pool + resolver ready-callbacks) would otherwise
            # race the dict eviction in _filter_hint_ids.
            with self._hint_lock:
                hinted = holder.hinted
                if hinted is None:
                    hinted = holder.hinted = {}
                ids, n_in = _filter_hint_ids(
                    hinted, ids, time.monotonic(),
                    cfg.prefetch_hint_dedupe_ttl_s), len(ids)
                self.prefetch_hints_suppressed += n_in - len(ids)
            if not ids:
                return
        if cfg.prefetch_hint_coalesce:
            # r15: buffer per destination; the submitter loop's next
            # wakeup flushes EVERYTHING pending as one frame
            # (_flush_prefetch_hints). A batch landing on a key that
            # already has a pending flush merges into it — that is one
            # whole frame saved, counted in prefetch_hints_coalesced.
            with self._hint_lock:
                inline = [ab for ab in ids
                          if ab in self._inline_promoted]
                buf = self._hint_buf.get(lease_key)
                if buf is None:
                    self._hint_buf[lease_key] = [list(ids), inline]
                else:
                    self.prefetch_hints_coalesced += 1
                    seen = set(buf[0])
                    buf[0].extend(ab for ab in ids if ab not in seen)
                    seen = set(buf[1])
                    buf[1].extend(ab for ab in inline
                                  if ab not in seen)
            self._submit_event.set()
            return
        with self._hint_lock:
            self.prefetch_hints_sent += 1
            inline = [ab for ab in ids if ab in self._inline_promoted]
        try:
            # the inline-tag field ships only when non-empty: the
            # common no-inline frame stays byte-identical to r15's
            if inline:
                self.head.send(P.PREFETCH_HINT, lease_key, ids, inline)
            else:
                self.head.send(P.PREFETCH_HINT, lease_key, ids)
        except P.ConnectionLost:
            pass  # speculation only: the demand path still works

    def _flush_prefetch_hints(self):
        """Ship every buffered prefetch hint in ONE frame (r15 hint
        coalescing). Driven by the submitter loop — each submit wakes
        it, so the added latency is one thread wakeup, paid only by
        speculation whose whole point is overlapping multi-ms
        transfers. Single-destination flushes reuse the plain
        PREFETCH_HINT frame so an r14 head decodes them unchanged."""
        with self._hint_lock:
            if not self._hint_buf:
                return
            # entries keep the 2-tuple shape unless a destination has
            # inline-tagged ids (r16) — no-inline frames stay
            # byte-identical to r15's, and r15 heads decode 2-tuples
            entries = [(k, v[0], v[1]) if v[1] else (k, v[0])
                       for k, v in self._hint_buf.items()]
            self._hint_buf.clear()
        if not self.head.is_attached():
            return  # head outage: drop — demand path still works
        try:
            if len(entries) == 1:
                self.head.send(P.PREFETCH_HINT, *entries[0])
            else:
                self.head.send(P.PREFETCH_HINT_BATCH, entries)
        except P.ConnectionLost:
            return  # dropped, not sent
        with self._hint_lock:
            self.prefetch_hints_sent += 1

    def _request_lease(self, cls, st: _ClassState):
        from .serialization import dumps

        sample: Optional[TaskSpec] = None
        with self._sub_lock:
            if st.queue:
                sample = st.queue[0]
        if sample is None:
            with self._sub_lock:
                st.pending_leases -= 1
            return
        # Arg-locality hint: binary ids of the sample task's by-reference
        # args. The head scores feasible nodes by how many of those bytes
        # they already hold (its object directory knows sizes + holder
        # sets) and prefers the best one — the reference ships the same
        # hint via LocalityAwareLeasePolicy on lease requests.
        # deduped: f.remote(x, x) must not double-count x's bytes toward
        # the locality threshold
        arg_ids = list(dict.fromkeys(
            enc[1] for enc in sample.args if enc[0] == ARG_REF))[:32]
        try:
            reply = self.head.call(
                P.LEASE_REQUEST, cls, sample.resources, self.job_id.hex(),
                dumps(sample.strategy), arg_ids, timeout=None)
            ok, worker_id, addr, lease_id, err = reply[:5]
            gpu_ids = reply[5] if len(reply) > 5 else None
        except Exception as e:  # noqa: BLE001
            with self._sub_lock:
                st.pending_leases -= 1
            self._fail_queued(st, e)
            return
        with self._sub_lock:
            still_needed = bool(st.queue)
        if not still_needed:
            # The queue drained while this lease request was in flight at
            # the head (it queues ungrantable requests indefinitely) — hand
            # the worker straight back instead of holding an idle lease.
            with self._sub_lock:
                st.pending_leases -= 1
            try:
                self.head.send(P.RETURN_WORKER, lease_id, worker_id)
            except P.ConnectionLost:
                pass  # shutting down
            return
        try:
            sock = P.connect_addr(addr)
        except OSError as e:
            with self._sub_lock:
                st.pending_leases -= 1
            self.head.send(P.RETURN_WORKER, lease_id, worker_id, True)
            self._submit_event.set()
            return
        conn = P.Connection(sock, peer=f"lease:{worker_id[:8]}")
        lw = _LeasedWorker(worker_id, addr, lease_id, conn, gpu_ids)
        conn.on_close = lambda c, cls=cls, st=st, lw=lw: \
            self._on_lease_worker_lost(cls, st, lw)
        self.io.add_connection(conn, self._on_peer_message)
        with self._sub_lock:
            st.pending_leases -= 1
            st.workers.append(lw)
        self._submit_event.set()

    def _fail_queued(self, st: _ClassState, err: Exception):
        with self._sub_lock:
            specs = list(st.queue)
            st.queue.clear()
        for spec in specs:
            self._complete_task_error(spec, WorkerCrashedError(str(err)))

    def _reap_idle_leases(self):
        now = time.monotonic()
        with self._sub_lock:
            for cls, st in self._classes.items():
                keep = []
                for w in st.workers:
                    if not w.inflight and not st.queue and \
                            now - w.idle_since > 2.0:
                        try:
                            self.head.send(P.RETURN_WORKER, w.lease_id,
                                           w.worker_id)
                        except P.ConnectionLost:
                            pass
                        w.conn.on_close = None
                        w.conn.close()
                    else:
                        keep.append(w)
                st.workers = keep

    def _on_lease_worker_lost(self, cls, st: _ClassState, lw: _LeasedWorker):
        with self._sub_lock:
            if lw in st.workers:
                st.workers.remove(lw)
            lost = list(lw.inflight.values())
            lw.inflight.clear()
        for spec in lost:
            self._maybe_retry(spec, WorkerCrashedError(
                f"worker {lw.worker_id[:8]} died"), count_retry=True)
        self._submit_event.set()

    def _maybe_retry(self, spec: TaskSpec, err: Exception, count_retry: bool):
        with self._sub_lock:
            inf = self._inflight.get(spec.task_id)
            if inf is None:
                return
            # negative retries_left means infinite retries (reference
            # semantics for max_retries=-1, python/ray/remote_function.py)
            if count_retry and inf.retries_left != 0:
                if inf.retries_left > 0:
                    inf.retries_left -= 1
                st = self._classes.setdefault(spec.scheduling_class(),
                                              _ClassState())
                st.queue.append(spec)
                retry = True
            else:
                retry = False
        if retry:
            self._submit_event.set()
        else:
            self._complete_task_error(spec, err)

    def _complete_task_error(self, spec: TaskSpec, err: Exception,
                             state: str = task_events.FAILED):
        # Owner-side terminal stamp: a task can die WITHOUT a worker
        # ever recording FAILED (worker crash with retries exhausted,
        # dep-resolution failure, actor death) — without this the folded
        # timeline wedges at RUNNING and the straggler detector flags a
        # task the caller already received an error for.
        self.events.record(spec.task_id.hex(),
                           spec.name or spec.method_name, state,
                           error=repr(err))
        aborted = []
        for oid in spec.return_ids():
            # don't clobber results that already arrived (e.g. an actor
            # killed right after its last reply was stored)
            if not self.memory_store.contains(oid):
                self.memory_store.put_value(oid, err, is_error=True)
                aborted.append(oid.binary())
        if aborted and spec.task_type == TaskType.NORMAL:
            # borrowers may be blocked in a head-side locate for these
            # returns (esp. after a failed lineage re-execution) — tell
            # the head they will never seal
            try:
                self.head.send(P.SEAL_ABORTED, aborted)
            except P.ConnectionLost:
                pass
        self._finalize_task(spec)

    def _finalize_task(self, spec: TaskSpec):
        with self._sub_lock:
            inf = self._inflight.pop(spec.task_id, None)
            self._recovering.discard(spec.task_id)
            for oid in spec.return_ids():
                self._return_to_task.pop(oid, None)
        if inf is not None:
            for oid in inf.arg_ids:
                self.ref_counter.remove_task_arg(oid)

    def _finish_cancelled(self, spec: TaskSpec):
        self._complete_task_error(spec,
                                  TaskCancelledError(spec.task_id.hex()),
                                  state=task_events.CANCELLED)

    def cancel(self, ref: ObjectRef, force: bool = False):
        with self._sub_lock:
            task_id = self._return_to_task.get(ref.id)
            if task_id is None:
                return
            self._cancelled.add(task_id)
            inf = self._inflight.get(task_id)
            spec = inf.spec if inf else None
            target = None
            if spec is not None:
                st = self._classes.get(spec.scheduling_class())
                if st:
                    if spec in st.queue:
                        st.queue.remove(spec)
                        self._finish_cancelled(spec)
                        return
                    for w in st.workers:
                        if task_id in w.inflight:
                            target = w
                            break
        if target is not None:
            try:
                target.conn.send(P.PUSH_CANCEL, task_id.binary(), force)
            except P.ConnectionLost:
                pass

    # -------------------------------------------------- task replies

    def _handle_task_reply_batch(self, conn, replies):
        """Batched completion handling: the per-reply path cost ~5 lock
        round-trips per task (inflight clear, RETURNED record, result
        store, finalize, submitter wakeup) while the submitting thread
        fought for the same locks — at high completion rates the lock
        convoy between this IO thread and the submit path was a
        measured slice of the e2e task budget. One _sub_lock hold
        clears every reply's dispatch bookkeeping; one _submit_event
        wakeup covers the whole frame."""
        now = time.monotonic()
        normal = []
        other = []
        with self._sub_lock:
            for reply in replies:
                task_id = TaskID(reply[0])
                inf = self._inflight.get(task_id)
                spec = inf.spec if inf else None
                w = inf.worker if inf is not None else None
                if w is not None:
                    w.inflight.pop(task_id, None)
                    w.idle_since = now
                    inf.worker = None
                if spec is None or spec.task_type == TaskType.ACTOR_TASK:
                    other.append((task_id, reply))
                else:
                    normal.append((task_id, spec, reply))
        for task_id, reply in other:
            self._handle_actor_reply(task_id, *reply[1:])
        for task_id, spec, (tb, status, result_meta, err) in normal:
            self.events.record(task_id.hex(), spec.name,
                               task_events.RETURNED)
            if status == "ok":
                self._store_results(spec, result_meta)
                self._finalize_task(spec)
            elif status == "cancelled":
                self._finish_cancelled(spec)
            elif spec.retry_exceptions:
                self._maybe_retry(spec, err, count_retry=True)
            else:
                self._complete_task_error(spec, err)
        self._submit_event.set()

    def _handle_task_reply(self, conn, task_id_bin, status, result_meta, err):
        task_id = TaskID(task_id_bin)
        with self._sub_lock:
            inf = self._inflight.get(task_id)
            spec = inf.spec if inf else None
            # clear from the lease worker that carried it (direct backref —
            # scanning every worker of every class is O(workers) per reply)
            w = inf.worker if inf is not None else None
            if w is not None:
                w.inflight.pop(task_id, None)
                w.idle_since = time.monotonic()
                inf.worker = None
        if spec is None or spec.task_type == TaskType.ACTOR_TASK:
            # Actor replies must ALSO clear the actor state's inflight map,
            # or a completed call lingers there and is replayed (or failed)
            # when the actor restarts.
            self._handle_actor_reply(task_id, status, result_meta, err)
            return
        # result_return / e2e phase endpoint: the reply landed back at
        # the owner (recorded whatever the status — an error "returns"
        # too; retries re-open the timeline from their own dispatch)
        self.events.record(task_id.hex(), spec.name, task_events.RETURNED)
        if status == "ok":
            self._store_results(spec, result_meta)
            self._finalize_task(spec)
        elif status == "cancelled":
            self._finish_cancelled(spec)
        else:
            if spec.retry_exceptions:
                self._maybe_retry(spec, err, count_retry=True)
            else:
                self._complete_task_error(spec, err)
        self._submit_event.set()

    def _store_results(self, spec: TaskSpec, result_meta):
        any_plasma = False
        for oid, entry in zip(spec.return_ids(), result_meta):
            kind = entry[0]
            if kind == "v":
                self.memory_store.put_value(oid, deserialize(entry[1]))
            else:
                self.memory_store.put_plasma_location(oid, entry[1])
                any_plasma = True
        if any_plasma and spec.task_type == TaskType.NORMAL:
            self._record_lineage(spec)

    def _record_lineage(self, spec: TaskSpec):
        cap = get_config().lineage_cache_max_entries
        with self._sub_lock:
            self._recovering.discard(spec.task_id)
            for oid in spec.return_ids():
                self._lineage[oid] = spec
                self._lineage.move_to_end(oid)
            while len(self._lineage) > cap:
                self._lineage.popitem(last=False)

    # ================================================== actor submission

    def create_actor(self, cls, args, kwargs, *, num_cpus=0, resources=None,
                     max_restarts=0, max_concurrency=1, name="",
                     strategy=None, max_task_retries=0,
                     runtime_env=None) -> "ActorID":
        from .serialization import dumps

        fn_id = self.fn_manager.export(cls)
        actor_id = ActorID.of(self.job_id)
        task_id = TaskID.for_actor_task(actor_id)
        res = dict(resources or {})
        if num_cpus:
            res["CPU"] = num_cpus
        spec = TaskSpec(
            task_id=task_id, job_id=self.job_id,
            task_type=TaskType.ACTOR_CREATION,
            name=name, function_id=fn_id,
            class_name=getattr(cls, "__name__", ""),
            resources=res,
            strategy=strategy or SchedulingStrategy(),
            owner=self.worker_id, actor_id=actor_id,
            max_restarts=max_restarts, max_concurrency=max_concurrency,
            max_retries=max_task_retries,
            runtime_env=runtime_env or self.job_runtime_env,
            trace_ctx=task_events.submit_trace_ctx(),
        )
        self._encode_args(spec, args, kwargs)
        self.head.call(P.CREATE_ACTOR, dumps(spec), timeout=60)
        st = _ActorState(actor_id)
        with self._sub_lock:
            self._actors[actor_id] = st
        self._watch_actor(actor_id)
        return actor_id

    def _watch_actor(self, actor_id: ActorID):
        def on_state(data):
            state, addr = data
            self._on_actor_state_change(actor_id, state, addr)

        self.subscribe(f"actor:{actor_id.hex()}", on_state, ack=False)

    def _actor_state(self, actor_id: ActorID) -> _ActorState:
        with self._sub_lock:
            st = self._actors.get(actor_id)
            if st is None:
                st = _ActorState(actor_id)
                self._actors[actor_id] = st
                self._watch_actor(actor_id)
            return st

    def submit_actor_task(self, actor_id: ActorID, method_name: str, args,
                          kwargs, *, num_returns=1, max_retries=0,
                          name: str = "") -> List[ObjectRef]:
        """``name`` overrides the task's observability label (defaults
        to the method name): the func key under which the r10 phase
        histograms, straggler detector and `summary tasks` aggregate
        this call. Pipeline stage actors use it (``stage{k}.fwd``) so
        per-stage bubble/transfer time is separable with no new
        plumbing."""
        st = self._actor_state(actor_id)
        task_id = TaskID.for_actor_task(actor_id)
        spec = TaskSpec(
            task_id=task_id, job_id=self.job_id, task_type=TaskType.ACTOR_TASK,
            name=name or method_name, function_id="",
            method_name=method_name,
            num_returns=num_returns, owner=self.worker_id,
            actor_id=actor_id, max_retries=max_retries,
            trace_ctx=task_events.submit_trace_ctx(),
        )
        arg_ids, holder = self._encode_args(spec, args, kwargs)
        self.events.record(task_id.hex(), spec.name, task_events.SUBMITTED,
                           trace_id=spec.trace_ctx[0],
                           parent_span_id=spec.trace_ctx[1])
        if holder:
            self.events.record(task_id.hex(), spec.name,
                               task_events.PENDING_ARGS_AVAIL)
        refs = [ObjectRef(oid, self.worker_id, _register=False)
                for oid in spec.return_ids()]
        for r in refs:
            self.ref_counter.add_owned(r.id)
            self.ref_counter.add_local_ref(r)
            r._registered = True
        inflight = _InflightTask(spec, arg_ids, max_retries, holder)
        with self._sub_lock:
            self._inflight[spec.task_id] = inflight
            for oid in spec.return_ids():
                self._return_to_task[oid] = spec.task_id
        with st.lock:
            spec.seqno = next(st.seqno)
            st.queue.append(spec)
            self._dep_unready.add(spec.task_id)

        def ready():
            self._dep_unready.discard(spec.task_id)
            # args resolved: the task now waits only for the actor's
            # connection + head-of-line order (its "node assignment")
            self.events.record(task_id.hex(), spec.name,
                               task_events.PENDING_NODE_ASSIGNMENT)
            self._drain_actor(st)

        def failed(err):
            self._dep_unready.discard(spec.task_id)
            with st.lock:
                try:
                    st.queue.remove(spec)
                except ValueError:
                    pass
            self._complete_task_error(spec, err)
            self._drain_actor(st)

        self._resolve_then(spec, holder, ready, failed)
        return refs

    def _drain_actor(self, st: _ActorState):
        with st.lock:
            if st.state == "DEAD":
                dead = list(st.queue)
                st.queue.clear()
            else:
                dead = []
        for spec in dead:
            self._complete_task_error(
                spec, ActorDiedError(st.death_cause or "actor died"))
        if dead:
            return
        with st.lock:
            if st.conn is None:
                if not st.resolving and st.state != "DEAD":
                    st.resolving = True
                    threading.Thread(target=self._resolve_actor, args=(st,),
                                     daemon=True).start()
                return
            to_send = []
            while st.queue:
                # head-of-line gate: actor-task order is by seqno, so a task
                # whose deps are still resolving blocks those behind it
                if st.queue[0].task_id in self._dep_unready:
                    break
                spec = st.queue.popleft()
                st.inflight[spec.task_id] = spec
                to_send.append(spec)
            conn = st.conn
            # one frame, one pickle, one syscall for the whole drain —
            # specs carry their seqno (the r3 PUSH_TASK_BATCH
            # optimization, now on the actor path too). The send happens
            # UNDER st.lock: two concurrent drains pop in order but would
            # otherwise race to the socket, delivering actor tasks out of
            # seqno order (the receiver executes in arrival order).
            try:
                if len(to_send) == 1:
                    conn.send(P.PUSH_TASK, to_send[0], to_send[0].seqno)
                elif to_send:
                    conn.send(P.PUSH_TASK_BATCH, to_send)
                for spec in to_send:
                    self.events.record(spec.task_id.hex(), spec.name,
                                       task_events.SUBMITTED_TO_WORKER)
            except P.ConnectionLost:
                pass  # conn.on_close handles re-resolution
        if to_send:
            # dispatch-time prefetch for ACTOR tasks (r14): the head
            # resolves the actor key to its worker's node. Outside
            # st.lock — speculation must not extend the dispatch
            # critical section, and ordering is irrelevant to it.
            self._send_prefetch_hint(
                st, to_send, "actor:" + st.actor_id.hex())

    def _resolve_actor(self, st: _ActorState):
        try:
            state, addr = self.head.call(P.GET_ACTOR, st.actor_id.binary(),
                                         timeout=None)
        except Exception as e:  # noqa: BLE001
            state, addr = "DEAD", str(e)
        self._on_actor_state_change(st.actor_id, state, addr, resolved=True)

    def _on_actor_state_change(self, actor_id: ActorID, state: str, addr: str,
                               resolved: bool = False):
        st = self._actor_state(actor_id)
        with st.lock:
            st.resolving = False
            if (state == "ALIVE" and st.state == "ALIVE"
                    and st.conn is not None and st.addr == addr):
                return  # duplicate notification (pubsub + resolution race)
            prev_conn = st.conn
            st.conn = None
            # In-flight calls are lost only when we had a live connection
            # that is now invalid, or the actor is gone.
            if prev_conn is not None or state in ("DEAD", "NOT_FOUND",
                                                  "RESTARTING"):
                lost = list(st.inflight.values())
                st.inflight.clear()
            else:
                lost = []
            if state == "ALIVE":
                st.state = "ALIVE"
                st.addr = addr
            elif state in ("DEAD", "NOT_FOUND"):
                st.state = "DEAD"
                st.death_cause = addr
            else:  # RESTARTING
                st.state = "RESTARTING"
        if prev_conn is not None:
            prev_conn.on_close = None
            prev_conn.close()
        # in-flight tasks: retry if allowed, else fail
        for spec in lost:
            if st.state in ("ALIVE", "RESTARTING") and spec.max_retries != 0:
                with st.lock:
                    st.queue.appendleft(spec)
            elif st.state == "DEAD":
                self._complete_task_error(
                    spec, ActorDiedError(st.death_cause or "actor died"))
            else:
                self._complete_task_error(spec, ActorUnavailableError(
                    f"actor {actor_id.hex()} restarting; in-flight call lost"))
        if st.state == "ALIVE":
            with st.lock:
                if st.conn is not None or st.connecting:
                    return
                st.connecting = True
            try:
                sock = P.connect_addr(addr)
            except OSError:
                with st.lock:
                    st.connecting = False
                return
            conn = P.Connection(sock, peer=f"actor:{actor_id.hex()[:8]}")
            conn.on_close = lambda c: self._on_actor_conn_close(st)
            self.io.add_connection(conn, self._on_peer_message)
            with st.lock:
                st.conn = conn
                st.connecting = False
            self._drain_actor(st)
        elif st.state == "DEAD":
            self._drain_actor(st)

    def _on_actor_conn_close(self, st: _ActorState):
        with st.lock:
            st.conn = None
            if st.state != "DEAD" and not st.resolving:
                st.resolving = True
                threading.Thread(target=self._resolve_actor, args=(st,),
                                 daemon=True).start()

    def _handle_actor_reply(self, task_id, status, result_meta, err):
        spec = None
        with self._sub_lock:
            inf = self._inflight.get(task_id)
            if inf is not None:
                spec = inf.spec
        if spec is None:
            return
        st = self._actor_state(spec.actor_id)
        with st.lock:
            st.inflight.pop(task_id, None)
        if spec.task_type == TaskType.ACTOR_TASK:
            self.events.record(task_id.hex(),
                               spec.name or spec.method_name,
                               task_events.RETURNED)
        if status == "ok":
            self._store_results(spec, result_meta)
            self._finalize_task(spec)
        elif status == "cancelled":
            self._finish_cancelled(spec)
        else:
            self._complete_task_error(spec, err)

    def actor_state(self, actor_id: ActorID) -> str:
        """This process's current view of an actor's lifecycle state:
        ``"ALIVE" | "RESTARTING" | "DEAD" | "UNKNOWN"`` (UNKNOWN =
        never watched, or no notification yet). Driven by the head's
        ``actor:<id>`` pubsub — DEAD lands the moment the head marks
        the death, i.e. the same signal that fails pending calls with
        ``ActorDiedError``. The supported death-detection query for
        callers like the pipeline repair planner (do not reach into
        ``_actors`` directly)."""
        with self._sub_lock:
            st = self._actors.get(actor_id)
        return st.state if st is not None else "UNKNOWN"

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True):
        self.head.call(P.KILL_ACTOR, actor_id.binary(), no_restart,
                       timeout=30)

    def get_named_actor(self, name: str) -> Optional[ActorID]:
        state, addr = self.head.call(P.GET_ACTOR, name, timeout=30)
        if state == "NOT_FOUND":
            return None
        # name lookup returns only existence; the id comes via kv
        data = self.kv_get("named_actor", name)
        if data is None:
            return None
        return ActorID(data)

    # ================================================== executor (workers)

    def run_executor(self):
        """Worker main loop: execute pushed tasks until shutdown.

        Actors created with ``max_concurrency > 1`` (the reference's threaded
        actors, core_worker concurrency groups) run their method calls on a
        thread pool of that size; everything else executes inline, in push
        order.
        """
        pool = None
        # Batched completions (TASK_DONE_BATCH, the return-side mirror of
        # PUSH_TASK_BATCH): replies buffer per pushing connection while
        # MORE tasks are already queued, and flush the moment the queue
        # empties (or the batch cap is hit) — so a noop flood acks
        # hundreds of tasks per frame while a lone task's reply is never
        # deferred. A finished result can never be withheld behind a
        # long-running next task either: the reply flusher thread sends
        # anything still buffered ~1 ms after the executor moves on, so
        # the deferral window is bounded by milliseconds, not by the
        # next task's duration.
        batch_cap = get_config().task_done_batch_max
        if batch_cap:
            threading.Thread(target=self._reply_flusher_loop,
                             daemon=True, name="reply-flusher").start()
        while not self._shutdown:
            try:
                item = self._exec_queue.get(timeout=1.0)
            except queue_mod.Empty:
                self._flush_task_replies()  # paranoia: nothing lingers
                continue
            if item is None:
                break
            spec, conn = item
            aspec = self._actor_spec
            if (aspec is not None and aspec.max_concurrency > 1
                    and spec.task_type == TaskType.ACTOR_TASK
                    and spec.method_name != "__ray_terminate__"):
                self._flush_task_replies()
                if pool is None:
                    import concurrent.futures as cf

                    pool = cf.ThreadPoolExecutor(
                        max_workers=aspec.max_concurrency,
                        thread_name_prefix="actor-exec")
                pool.submit(self._execute_safe, spec, conn)
            else:
                if spec.method_name == "__ray_terminate__":
                    # terminate replies inline then os._exit's — anything
                    # still buffered would be lost with the process
                    self._flush_task_replies()
                    if pool is not None:
                        # Drain in-flight pooled tasks before
                        # _graceful_exit's os._exit — otherwise their
                        # callers see 'worker died' instead of results
                        # (same semantics as serial actors, where
                        # terminate queues behind pending tasks).
                        pool.shutdown(wait=True)
                        pool = None
                    self._execute_safe(spec, conn)
                    continue
                reply = self._execute_guarded(spec, conn)
                if reply is None:
                    # inline-replied (actor creation) or crashed — flush
                    # so nothing waits behind a reply that never comes
                    self._flush_task_replies()
                    continue
                if not batch_cap:
                    self._send_task_reply(conn, reply)
                    continue
                with self._reply_lock:
                    self._reply_buf.setdefault(conn, []).append(reply)
                    self._reply_n += 1
                    n = self._reply_n
                if n >= batch_cap or self._exec_queue.empty():
                    self._flush_task_replies()
                else:
                    # more tasks queued: defer — the flusher bounds how
                    # long, in case the next task runs for minutes
                    self._reply_event.set()
        self._flush_task_replies()

    def _reply_flusher_loop(self):
        """Bounds the completion-batching deferral window: the serial
        executor only defers a reply while more tasks are queued; if the
        NEXT task runs long, this thread ships the already-finished
        results ~1 ms later instead of letting them ride out that
        execution (preserving the pre-batching guarantee that a slow
        task never withholds an earlier task's finished result)."""
        while not self._shutdown:
            if not self._reply_event.wait(0.5):
                continue
            time.sleep(0.001)  # let a fast burst accumulate
            self._flush_task_replies()
            with self._reply_lock:
                if not self._reply_n:
                    self._reply_event.clear()

    def _send_task_reply(self, conn: P.Connection, reply):
        try:
            conn.send(P.TASK_REPLY, *reply)
        except P.ConnectionLost:
            pass

    def _flush_task_replies(self):
        """Send buffered completions — one TASK_DONE_BATCH frame per
        connection (plain TASK_REPLY when only one is pending). Called
        from the executor and the reply flusher; the buffer swap under
        the lock makes it safe from both."""
        with self._reply_lock:
            if not self._reply_n:
                return
            pending = self._reply_buf
            self._reply_buf = {}
            self._reply_n = 0
        for conn, replies in pending.items():
            try:
                if len(replies) == 1:
                    conn.send(P.TASK_REPLY, *replies[0])
                else:
                    conn.send(P.TASK_DONE_BATCH, replies)
                    P.WIRE.task_done_batches += 1
                    P.WIRE.task_done_batched += len(replies)
            except P.ConnectionLost:
                pass  # conn.on_close / lease loss handles the fallout

    def _execute_safe(self, spec: TaskSpec, conn: P.Connection):
        """Execute and reply immediately (threaded-actor pool path and
        terminate; the serial executor loop batches instead). Immediate
        replies keep concurrent pooled calls independent — a slow pooled
        task never withholds a finished sibling's result."""
        reply = self._execute_guarded(spec, conn)
        if reply is not None:
            self._send_task_reply(conn, reply)

    def _execute_guarded(self, spec: TaskSpec, conn: P.Connection):
        try:
            return self._execute(spec, conn)
        except P.ConnectionLost:
            pass
        except Exception:
            traceback.print_exc()
        return None

    def _mark_running(self, spec: TaskSpec):
        """Stamp RUNNING once this task's args are materialized (the
        FETCHING_ARGS->RUNNING gap is the arg_fetch phase). Trace ids
        come from the TLS stash _execute set, so the RUNNING event pairs
        with the same span FINISHED closes."""
        info = getattr(self._task_tls, "exec_trace", None)
        label, trace_id, span_id, parent_id = info or (
            spec.name or spec.method_name or spec.function_id, "", "", "")
        self.events.record(spec.task_id.hex(), label, task_events.RUNNING,
                           trace_id=trace_id, span_id=span_id,
                           parent_span_id=parent_id)

    def _decode_args(self, spec: TaskSpec):
        vals = []
        for entry in spec.args:
            if entry[0] == ARG_VALUE:
                v = deserialize(entry[1])
                vals.append(v)
            else:
                ref = ObjectRef(ObjectID(entry[1]), entry[2])
                self.notify_deserialized_ref(ref)
                vals.append(self.get([ref])[0])
        nk = len(spec.kwarg_names)
        if nk:
            pos, kw_vals = vals[:-nk], vals[-nk:]
            kwargs = dict(zip(spec.kwarg_names, kw_vals))
        else:
            pos, kwargs = vals, {}
        return pos, kwargs

    def _execute(self, spec: TaskSpec, conn: P.Connection):
        """Run one task; returns the TASK_REPLY fields (or None when the
        reply was already sent inline — creation/terminate paths).

        The execution is auto-wrapped in a trace span parented to the
        submit site (spec.trace_ctx): the task's RUNNING->FINISHED pair
        IS the span, and the ambient trace context is installed for the
        duration so tracing.span() inside user code nests under it
        (reference: tracing_helper.py _inject_tracing_into_function).

        FETCHING_ARGS is stamped on entry and RUNNING only after the
        by-ref args resolved (_mark_running, called from each
        _decode_args site) — the gap IS the arg_fetch phase, so a task
        stalled pulling a remote arg is distinguishable from one
        executing slowly."""
        label = spec.name or spec.method_name or spec.function_id
        trace_id, parent_id = spec.trace_ctx or ("", "")
        span_id = task_events.new_span_id() if trace_id else ""
        self.events.record(spec.task_id.hex(), label,
                           task_events.FETCHING_ARGS,
                           trace_id=trace_id, span_id=span_id,
                           parent_span_id=parent_id)
        self._task_tls.exec_trace = (label, trace_id, span_id, parent_id)
        prev = task_events.set_trace(
            (trace_id, span_id) if trace_id else None)
        try:
            out = self._execute_inner(spec, conn)
        finally:
            task_events.set_trace(prev)
            self._task_tls.exec_trace = None
        if out is None or out[1] == "ok":
            self.events.record(spec.task_id.hex(), label,
                               task_events.FINISHED,
                               trace_id=trace_id, span_id=span_id,
                               parent_span_id=parent_id)
        else:
            self.events.record(
                spec.task_id.hex(), label,
                task_events.FAILED if out[1] == "error" else out[1].upper(),
                error=repr(out[3]) if out[3] is not None else "",
                trace_id=trace_id, span_id=span_id,
                parent_span_id=parent_id)
        return out

    def _export_gpu_ids(self, gpu_ids):
        """Set ``CUDA_VISIBLE_DEVICES`` to the lease's GPUs ("" for a lease
        without GPUs). Ids index the devices the node counted: where the
        worker started under a ``CUDA_VISIBLE_DEVICES`` list, id i is its
        i-th entry. A process that has initialized CUDA cannot change its
        devices, so the worker keeps the set it exported first and refuses
        a lease of others (the head never hands it one: head._gpu_fit)."""
        ids = list(gpu_ids)
        if self._exported_gpu_ids is not None and \
                self._exported_gpu_ids != ids:
            raise RuntimeError(
                f"this worker exported CUDA_VISIBLE_DEVICES for GPUs "
                f"{self._exported_gpu_ids} and cannot switch to {ids}")
        base = [d.strip() for d in
                (self._spawn_visible_devices or "").split(",") if d.strip()]
        os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(
            base[i] if i < len(base) else str(i) for i in ids)
        self._exported_gpu_ids = ids
        self.assigned_gpu_ids = ids

    def _execute_inner(self, spec: TaskSpec, conn: P.Connection):
        if spec.task_id in self._cancelled:
            return (spec.task_id.binary(), "cancelled", None, None)
        self.current_task_id = spec.task_id
        self.current_job_id = spec.job_id
        try:
            # Export the head-assigned GPUs before user code imports torch
            # (the reference sets CUDA_VISIBLE_DEVICES the same way,
            # worker.py:888); an actor's methods run under its creation
            # lease's GPUs.
            if spec.task_type != TaskType.ACTOR_TASK:
                self._export_gpu_ids(spec.gpu_ids or [])
            if spec.task_type == TaskType.ACTOR_CREATION:
                if spec.runtime_env:
                    # actor env persists for the actor process's lifetime
                    # (the worker is dedicated) — enter without exit
                    from ray_tpu_torch import runtime_env as _renv

                    _renv.applied(self, spec.runtime_env).__enter__()
                cls = self.fn_manager.fetch(spec.function_id)
                args, kwargs = self._decode_args(spec)
                self._mark_running(spec)
                self._actor_instance = cls(*args, **kwargs)
                self._actor_spec = spec
                if spec.name:
                    self.kv_put("named_actor", spec.name,
                                spec.actor_id.binary(), True)
                conn.send(P.TASK_REPLY, spec.task_id.binary(), "ok", [], None)
                return None
            if spec.task_type == TaskType.ACTOR_TASK:
                if self._actor_instance is None:
                    raise RuntimeError("actor not initialized")
                if spec.method_name == "__ray_terminate__":
                    conn.send(P.TASK_REPLY, spec.task_id.binary(), "ok",
                              [("v", [bytes(f) for f in
                                      serialize(None).frames])], None)
                    self._graceful_exit()
                    return None
                fn = getattr(self._actor_instance, spec.method_name)
                args, kwargs = self._decode_args(spec)
                self._mark_running(spec)
                result = self._call(fn, args, kwargs)
            elif spec.runtime_env:
                from ray_tpu_torch import runtime_env as _renv

                fn = self.fn_manager.fetch(spec.function_id)
                args, kwargs = self._decode_args(spec)
                self._mark_running(spec)
                with _renv.applied(self, spec.runtime_env):
                    result = self._call(fn, args, kwargs)
            else:
                fn = self.fn_manager.fetch(spec.function_id)
                args, kwargs = self._decode_args(spec)
                self._mark_running(spec)
                result = self._call(fn, args, kwargs)
        except Exception as e:  # noqa: BLE001
            te = TaskError(repr(e), traceback.format_exc(), e)
            if spec.task_type == TaskType.ACTOR_CREATION:
                try:
                    conn.send(P.TASK_REPLY, spec.task_id.binary(), "error",
                              None, te)
                except P.ConnectionLost:
                    pass
                try:
                    self.head.send(P.ACTOR_DEAD, spec.actor_id.binary(),
                                   repr(e))
                finally:
                    os._exit(1)
            return (spec.task_id.binary(), "error", None, te)
        try:
            result_meta = self._encode_results(spec, result)
        except Exception as e:  # noqa: BLE001 — e.g. unserializable return
            te = TaskError(repr(e), traceback.format_exc(), None)
            return (spec.task_id.binary(), "error", None, te)
        return (spec.task_id.binary(), "ok", result_meta, None)

    def _call(self, fn, args, kwargs):
        import inspect

        result = fn(*args, **kwargs)
        if inspect.iscoroutine(result):
            result = self._run_async(result)
        return result

    def _run_async(self, coro):
        import asyncio

        if self._async_loop is None:
            self._async_loop = asyncio.new_event_loop()
            t = threading.Thread(target=self._async_loop.run_forever,
                                 daemon=True, name="async-actor")
            t.start()
        fut = asyncio.run_coroutine_threadsafe(coro, self._async_loop)
        return fut.result()

    def _encode_results(self, spec: TaskSpec, result):
        cfg = get_config()
        if spec.num_returns == 1:
            results = [result]
        else:
            results = list(result)
            if len(results) != spec.num_returns:
                raise ValueError(
                    f"task declared num_returns={spec.num_returns} but "
                    f"returned {len(results)} values")
        meta = []
        for oid, value in zip(spec.return_ids(), results):
            sv = serialize(value)
            if sv.contained_refs:
                self._pin_for_handoff(sv.contained_refs)
            if sv.total_bytes < cfg.max_inline_object_size and \
                    not sv.contained_refs:
                # out-of-band frames may be memoryviews (PickleBuffer.raw);
                # materialize them — the reply itself is pickled in-band
                meta.append(("v", [bytes(f) if isinstance(f, memoryview)
                                   else f for f in sv.frames]))
            else:
                # contains() guard: lineage reconstruction can re-run a task
                # on a node that still holds the previous copy of its result
                if not self.store.contains(oid):
                    self.store.put_serialized(oid, sv.frames)
                # a call, not a send: the reply reaches the owner on
                # another connection, and the owner pulls the return
                # through the head at once — the head must know the
                # object before the reply leaves
                self.head.call(P.OBJECT_SEALED, oid.binary(), self.node_idx,
                               sv.total_bytes, spec.owner,
                               spec.job_id.hex(), timeout=120)
                meta.append(("p", self.node_idx))
        return meta

    def _pin_for_handoff(self, refs, ttl_s: float = 5.0):
        with self._handoff_lock:
            self._handoff_pins.append((time.monotonic() + ttl_s,
                                       list(refs)))
        self._purge_handoff_pins()

    def _purge_handoff_pins(self):
        """Also driven by the submitter loop's wakeups, so the LAST batch
        of pinned refs releases on time instead of leaking until exit."""
        now = time.monotonic()
        with self._handoff_lock:
            while self._handoff_pins and self._handoff_pins[0][0] < now:
                self._handoff_pins.popleft()

    def _graceful_exit(self):
        self._shutdown = True
        try:
            self.head.send(P.WORKER_EXIT)
        except P.ConnectionLost:
            pass
        os._exit(0)

    # ================================================== lifecycle

    def node_info(self) -> list:
        return self.head.call(P.NODE_INFO, timeout=30)[0]

    def shutdown(self):
        self._flush_frees()  # before _shutdown flips: conns still up
        self._shutdown = True
        self.events.stop()
        self._submit_event.set()
        with self._sub_lock:
            for st in self._classes.values():
                for w in st.workers:
                    try:
                        self.head.send(P.RETURN_WORKER, w.lease_id,
                                       w.worker_id)
                    except P.ConnectionLost:
                        pass
                    w.conn.on_close = None
                    w.conn.close()
        try:
            self.head.close()
        except Exception:
            pass
        agent = getattr(self, "_local_agent", None)
        if agent is not None:  # remote-driver mode: our in-process node
            try:
                agent.shutdown()
            except Exception:
                pass
        self.io.stop()
        try:
            self._listener.close()
            if self.listen_path:
                os.unlink(self.listen_path)
        except OSError:
            pass
        try:
            self.store.close()
        except Exception:
            pass
