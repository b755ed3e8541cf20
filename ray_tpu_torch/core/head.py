"""Head service: GCS-lite control plane + per-node raylet-lite.

Analog of the reference's GCS server (src/ray/gcs/gcs_server/gcs_server.h:78
— node/actor/job/PG/KV/pubsub/health managers) fused with the raylet's local
managers (worker_pool.h:156 WorkerPool, local_task_manager.h dispatch,
local_object_manager.h:41 spilling). On a TPU cluster this is the per-cluster
control plane over DCN; within one host it runs embedded in the driver
process. Virtual multi-node (the reference's ray.cluster_utils.Cluster,
python/ray/cluster_utils.py:99) is first-class: one head can host N logical
nodes, each with its own resource view, worker pool, and shm object store —
the workhorse for scheduling/failover tests without real hosts.

Data plane note: tensor traffic never flows through here — within a slice it
is XLA/ICI inside compiled programs; this plane carries control messages,
small objects, and checkpoint/object logistics only, mirroring how the
reference keeps NCCL traffic out of its object store.
"""

from __future__ import annotations

import itertools
import os
import queue
import statistics
import subprocess
import sys
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from . import events as E
from . import protocol as P
from .protocol import local_ip as _local_ip
from .config import get_config
from .ids import ActorID, ObjectID, PlacementGroupID, _random_bytes
from .obj_directory import ObjectDirectory, _ObjLoc  # noqa: F401 — _ObjLoc
#   re-exported: planner tests and older callers import it from here
from .object_store import ShmObjectStore
from .persistence import HeadStore
from .resources import NodeResources, ResourceSet, detect_node_resources
from .scheduler import ClusterResourceScheduler
from .serialization import dumps, loads
from .task_spec import ARG_REF, PlacementGroupSpec, TaskSpec
from .timeseries import FlightRecorder


@dataclass
class WorkerInfo:
    worker_id: str
    node_idx: int
    pid: int = 0
    listen_addr: str = ""
    conn: Optional[P.Connection] = None
    proc: Optional[subprocess.Popen] = None
    state: str = "starting"  # starting | idle | leased | actor | dead
    sched_class: Optional[tuple] = None
    lease_id: Optional[str] = None
    actor_id: Optional[ActorID] = None
    idle_since: float = 0.0
    spawned_at: float = 0.0
    # the GPU ids the worker exported as CUDA_VISIBLE_DEVICES at its first
    # lease (() for a lease without GPUs); None until then. A process that
    # has initialized CUDA cannot change its devices, so the worker only
    # takes leases of these ids afterwards (_gpu_fit)
    gpu_ids: Optional[tuple] = None


@dataclass
class ActorInfo:
    actor_id: ActorID
    spec: TaskSpec
    state: str = "PENDING"  # PENDING | ALIVE | RESTARTING | DEAD
    listen_addr: str = ""
    worker_id: str = ""
    restarts_used: int = 0
    name: str = ""
    death_cause: str = ""
    pending_get_replies: List[Tuple[P.Connection, int]] = field(default_factory=list)


@dataclass
class PgInfo:
    spec: PlacementGroupSpec
    placement: List[int] = field(default_factory=list)
    # Per-bundle remaining resources (tasks scheduled into a bundle consume
    # from here, not from the node's free pool — the reference's
    # CPU_group_<pgid> shadow-resource mechanism).
    bundle_available: List[ResourceSet] = field(default_factory=list)
    state: str = "PENDING"


@dataclass
class NodeState:
    idx: int
    resources: NodeResources
    store: Optional[ShmObjectStore]  # None for remote nodes (agent owns it)
    store_name: str
    workers: Dict[str, WorkerInfo] = field(default_factory=dict)
    idle_by_class: Dict[tuple, List[str]] = field(default_factory=dict)
    alive: bool = True
    # per-GPU assignment pool (lazily built from the GPU resource total)
    gpu_free: Optional[List[int]] = None
    # remote-node plumbing (multi-host over TCP; the reference's raylet)
    agent_conn: Optional[P.Connection] = None
    node_ip: str = ""
    session_dir: str = ""
    # the host's peer-to-peer object TransferServer (object_transfer.py)
    transfer_addr: str = ""
    # periodic health probing (remote nodes; gcs_health_check_manager.h:39)
    health_failures: int = 0
    last_ping: float = 0.0
    ping_inflight: bool = False
    # graceful drain (r16): set by drain_node() — excluded from lease
    # grants / placements / prefetch targets while its in-flight leases
    # complete and sole-copy objects replicate off; past
    # ``drain_deadline_s`` the removal force-escalates (drain_forced)
    draining: bool = False
    drain_started: float = 0.0     # monotonic, when the drain began
    drain_replicated: bool = False   # last replication pass was clean
    drain_replicating: bool = False  # a replication pass is in flight
    drain_last_pass: float = 0.0     # when the last pass ended
    # RTT-midpoint estimate of (agent monotonic clock - head monotonic
    # clock), sampled at registration and refreshed by every health
    # probe; applied when folding this node's task-event stamps into the
    # head's timebase so cross-node phase math cannot go negative.
    clock_offset_s: float = 0.0
    clock_rtt_s: float = 0.0

    @property
    def is_remote(self) -> bool:
        return self.agent_conn is not None


@dataclass
class _TaskTimeline:
    """Folded per-task lifecycle row (reference: GcsTaskManager's
    per-task state aggregation over task_event_buffer flushes). Events
    arrive out of order across connections; the fold is commutative —
    first stamp per state wins, display state is the highest-ranked one
    seen, and each phase is observed into the histograms exactly once,
    the moment both its endpoints are present."""

    task_id: str
    name: str = ""
    state: str = ""
    worker_id: str = ""
    node_idx: int = -1
    ts: float = 0.0
    error: str = ""
    trace_id: str = ""
    state_ts: Dict[str, float] = field(default_factory=dict)
    # state -> monotonic stamp, already folded into the HEAD's timebase
    # (remote stamps have their node's clock offset subtracted)
    state_mono: Dict[str, float] = field(default_factory=dict)
    observed: Set[str] = field(default_factory=set)  # phases histogrammed
    straggler: bool = False
    straggler_ms: float = 0.0


@dataclass
class _PrefetchState:
    """One speculative arg pull (r13): fired at lease grant or dispatch
    hint, keyed (oid_bin, node_idx). ``charged`` is the broadcast
    planner's source-load registration, released exactly once — by the
    agent's PREFETCH_RESULT or the TTL sweep. ``consumed`` flips when a
    demand fetch for the same (object, node) arrives (the overlap the
    feature exists for); unconsumed in-flight entries at lease teardown
    are aborted and counted wasted."""

    oid_bin: bytes
    node_idx: int
    lease_id: str
    size: int
    ts: float
    charged: list = field(default_factory=list)
    state: str = "inflight"  # inflight | done | aborted
    consumed: bool = False
    # r16: the driver tagged this arg as an INLINE-PROMOTED object (a
    # tiny value materialized into the store only so a borrower could
    # fetch it, e.g. a pipeline backward cotangent) — its pull is
    # counted in the *_inline counters, outside the issued/wasted
    # ratio the doctor waste check judges
    inline: bool = False


# inflight/aborted prefetch entries whose agent never answered (died,
# or the frame was lost) are swept — charges released — after this long;
# completed entries linger briefly so a late demand fetch still counts
# as satisfied-by-prefetch before the record is dropped.
_PREFETCH_SWEEP_S = 180.0
_PREFETCH_DONE_TTL_S = 60.0
# Reserved lease id for OBJECT_WARM prefetches (r14 serve cold-start):
# not a real lease, so the lease-liveness gate is skipped and teardown
# never aborts them — warm entries age out via the normal done-TTL /
# sweep paths instead.
_WARM_LEASE = "__warm__"


# task.phase_ms / task.node_phase_ms bucket bounds (milliseconds): task
# phases span sub-ms dispatch hops to multi-minute training steps.
TASK_PHASE_MS_BOUNDARIES = (1.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                            500.0, 1000.0, 2500.0, 5000.0, 15000.0,
                            60000.0, 300000.0)


def _hist_quantile(bounds, value, q: float) -> float:
    """Estimate the q-quantile of a [bucket counts..., +inf, sum, n]
    histogram row by linear interpolation inside the holding bucket
    (the standard Prometheus histogram_quantile estimator); the +Inf
    bucket clamps to the last finite bound."""
    n = value[-1]
    if n <= 0:
        return 0.0
    target = q * n
    acc, lo = 0.0, 0.0
    for i, b in enumerate(bounds):
        c = value[i]
        if c > 0 and acc + c >= target:
            return lo + (b - lo) * max(0.0, min(1.0, (target - acc) / c))
        acc += c
        lo = b
    return float(bounds[-1])


# Request types whose retried copies the head dedupes by
# (client_id, request_id): the control-plane MUTATIONS a reconnecting
# channel may replay after a reattach. Reads are naturally idempotent
# and lease requests have their own orphan-grant return path.
_DEDUPE_TYPES = frozenset((
    P.KV_PUT, P.KV_DEL, P.CREATE_ACTOR, P.CREATE_PG, P.REMOVE_PG,
    P.KILL_ACTOR,
))
# WAL-durable subset: their dedupe keys persist alongside the mutation,
# so a retry that crosses a head CRASH is re-acked, not re-applied.
_DEDUPE_DURABLE = frozenset((
    P.KV_PUT, P.KV_DEL, P.CREATE_ACTOR, P.CREATE_PG, P.REMOVE_PG,
))
# Generic success acks for WAL-restored dedupe entries (the mutation
# landed before the crash; the original reply's exact content is gone).
_DEDUPE_GENERIC = {
    P.KV_PUT: (P.OK, (True,)),
    P.KV_DEL: (P.OK, (True,)),
    P.CREATE_ACTOR: (P.CREATE_ACTOR_REPLY, (True,)),
    P.CREATE_PG: (P.CREATE_PG_REPLY, ("CREATED",)),
    P.REMOVE_PG: (P.OK, (True,)),
    P.KILL_ACTOR: (P.OK, (True,)),
}
_DEDUPE_CAP = 4096


class _DedupeRecorder:
    """Connection proxy handed to deduped handlers: success replies are
    recorded under the request's (client_id, rid) key — and, for
    durable mutations, a ``("dedupe", ...)`` WAL record rides along —
    before forwarding to the real connection. Error replies are NOT
    recorded (a retry may legitimately succeed)."""

    __slots__ = ("_head", "_conn", "_key", "_mt")

    def __init__(self, head: "Head", conn, key, mt: int):
        self._head = head
        self._conn = conn
        self._key = key
        self._mt = mt

    def __getattr__(self, name):
        return getattr(self._conn, name)

    def reply(self, request_id, *fields, msg_type=P.OK):
        self._head._record_dedupe(self._key, self._mt,
                                  (msg_type, fields))
        self._conn.reply(request_id, *fields, msg_type=msg_type)

    def reply_error(self, request_id, err):
        self._conn.reply_error(request_id, err)


class Head:
    def __init__(self, session_dir: str, session_name: str):
        self.session_dir = session_dir
        self.session_name = session_name
        self.addr = f"unix:{session_dir}/head.sock"
        self.scheduler = ClusterResourceScheduler()
        self.nodes: Dict[int, NodeState] = {}
        self.actors: Dict[ActorID, ActorInfo] = {}
        self.named_actors: Dict[str, ActorID] = {}
        self.pgs: Dict[PlacementGroupID, PgInfo] = {}
        self.kv: Dict[str, Dict[str, bytes]] = {}
        self.subs: Dict[str, Set[P.Connection]] = {}
        # Sharded object directory (obj_directory.py): holder sets,
        # blocked-locate waiters, broadcast in-progress locations — all
        # under per-shard locks, OFF the head lock, so directory traffic
        # never convoys behind lease granting or the event fold.
        self.objects = ObjectDirectory()
        self.leases: Dict[str, Tuple[int, ResourceSet, str, Optional[tuple]]] = {}
        self._lock = threading.RLock()
        # Control-plane lock split (r11): the head lock now guards ONLY
        # the node/worker/lease/actor/PG/kv tables. Observability state
        # has its own locks so a dashboard poll or a metrics merge can
        # never stall a lease grant (ordering, outermost first:
        # _lock -> _timeline_lock -> _metrics_lock; _cev_lock is a leaf).
        self._timeline_lock = threading.RLock()
        self._metrics_lock = threading.RLock()
        self._cev_lock = threading.Lock()
        self._pending_pg: List[PlacementGroupID] = []
        # lease requests waiting for a worker/resources:
        # (conn, request_id, sched_class, request, strategy_bytes, job)
        self._pending_leases: List[tuple] = []
        self.io = P.IOLoop("head-io")
        self._listener = P.listen_unix(f"{session_dir}/head.sock")
        self.io.add_listener(self._listener, self._on_accept)
        self._tcp_listener = None
        self.tcp_addr: str = ""
        self._next_node_idx = 0
        self._driver_conn: Optional[P.Connection] = None
        self._shutdown = False
        # P2P object plane for the head's in-process nodes (lazy, multi-host
        # only): serves local arenas to remote agents and pulls from them.
        self._transfer_server = None
        self._pullers: Dict[int, object] = {}  # local node idx -> ObjectPuller
        # bytes relayed through head memory on the legacy path — the P2P
        # tests assert this stays 0 for host<->host transfers
        self.relay_bytes = 0
        # locality-aware leasing counters (hit = a task landed on a node
        # already holding its args; miss = locality applied but no holder
        # was feasible/available and the hybrid policy decided instead)
        self.locality_hits = 0
        self.locality_misses = 0
        # cooperative-broadcast planner counters (object_plane state row):
        # how many pulls were pointed at a sealed root vs an in-progress
        # relay, and how often every candidate source was already at its
        # broadcast_fanout bound (the planner then reuses the least-
        # loaded root and emits the rate-limited saturation event)
        self.broadcast_root_assignments = 0
        self.broadcast_relay_assignments = 0
        self.broadcast_fanout_saturations = 0
        self._last_saturation_event_ts = 0.0
        # Speculative arg prefetch (r13, the reference PullManager's
        # prefetch role): (oid_bin, node_idx) -> _PrefetchState for
        # pulls fired at lease grant / dispatch hint, ahead of worker
        # demand. Entries hold the broadcast-planner source charges
        # until the agent's PREFETCH_RESULT (or the TTL sweep) releases
        # them; lease teardown aborts unconsumed in-flight entries
        # through PULL_ABORT (counted wasted).
        self._prefetches: Dict[Tuple[bytes, int], _PrefetchState] = {}
        self._prefetch_by_lease: Dict[str, List[Tuple[bytes, int]]] = {}
        # caps pace, they don't drop (the reference PullManager's
        # bounded pull activation): requests denied by the
        # inflight/byte caps queue per node and activate as
        # PREFETCH_RESULTs free slots. Bounded FIFO; entries re-check
        # holders/caps/lease liveness at activation time.
        self._prefetch_pending: Dict[int, "deque"] = {}
        self._prefetch_draining: Set[int] = set()
        self._prefetch_lock = threading.Lock()
        self.prefetch_issued = 0     # speculative pulls fired
        self.prefetch_joined = 0     # demand fetches that overlapped one
        self.prefetch_completed = 0  # pulls that landed their copy
        self.prefetch_wasted = 0     # aborted: task cancelled/retried
        self.prefetch_bytes_issued = 0
        # r16: pulls of INLINE-PROMOTED objects (tiny values an owner
        # materialized into the store only so borrowers could fetch
        # them — e.g. pipeline backward cotangents) are counted apart:
        # they are real pulls but not the speculation the waste-ratio
        # doctor check judges, and on this 2-vCPU class of host they
        # were padding prefetch_issued by one per microbatch
        self.prefetch_issued_inline = 0
        self.prefetch_completed_inline = 0
        self.prefetch_wasted_inline = 0
        # graceful node drain (r16): counters behind the io_loop state
        # row — migrated = leases released off a draining node while it
        # was still alive (work moved, nothing died)
        self.drains_started = 0
        self.drains_completed = 0
        self.drains_forced = 0
        self.drain_migrated_leases = 0
        self.drain_objects_replicated = 0
        # Worker spawner queue (drained by the spawner thread, started in
        # start()): created here so _try_grant can enqueue spawns even on
        # heads that are never start()ed (unit tests drive handlers
        # directly).
        self._spawn_q: "queue.Queue" = queue.Queue()
        # Batched lease dispatch (r11): LEASE_REQUESTs queue here and a
        # dedicated dispatcher thread grants them in ONE pass over node
        # state per tick (one lock hold, strategies pre-parsed), replying
        # per-connection in LEASE_GRANT_BATCH frames. Handlers that free
        # resources just signal the event — the O(pending^2) re-grant
        # loop the IO thread used to run per message (measured 60-190 ms
        # per REGISTER/RETURN_WORKER at burst) is gone.
        self._dispatch_event = threading.Event()
        self._dispatcher: Optional[threading.Thread] = None
        self.lease_grant_batches = 0   # LEASE_GRANT_BATCH frames sent
        self.lease_grants_batched = 0  # grants that rode those frames
        self._lease_seq = itertools.count(1)
        self._lease_prefix = _random_bytes(8).hex()
        # Task-event ring buffer feeding the state API (reference:
        # GcsTaskManager over task_event_buffer.h flushes).
        self.task_events: "deque" = deque(
            maxlen=get_config().task_event_buffer_size)
        self.task_events_dropped = 0
        # Total events ever ingested into the ring — the absolute
        # sequence base for the paged task_events query (r19): ring
        # position i holds sequence (task_events_seq - len(ring) + i).
        self.task_events_seq = 0
        # Flight recorder (r19): periodic() folds the merged metric
        # table into bounded ring-buffer series every
        # timeseries_sample_s (STATE_QUERY "metrics_history" /
        # /api/timeseries read them back).
        self.recorder = FlightRecorder(
            get_config().timeseries_sample_s,
            get_config().timeseries_window_s)
        self._ts_last_sample = 0.0
        # Off-loop event folding (r11): TASK_EVENTS batches from the wire
        # land in this bounded queue and a dedicated fold thread does the
        # timeline/histogram work — the commutative fold makes the move
        # safe, and the IO loop goes back to being a router. Flush-acks
        # (rid > 0) are issued by the fold thread AFTER ingesting the
        # batch, preserving the ordering barrier timeline() relies on.
        # Overflow sheds the batch (observability must never backpressure
        # the control plane) and counts it: fold_queue_drops is surfaced
        # through io_loop state + doctor_warnings().
        self._fold_q: "deque" = deque()
        self._fold_event = threading.Event()
        self._fold_thread: Optional[threading.Thread] = None
        self.fold_queue_drops = 0
        # Folded per-task lifecycle timelines (bounded, FIFO-evicted;
        # reference: GcsTaskManager task aggregation): state_ts /
        # phase_ms for list_tasks, the task.phase_ms{func,phase} +
        # task.node_phase_ms{node,phase} histograms for
        # summarize_tasks()/Prometheus, and the straggler flags.
        self.task_timelines: "OrderedDict[str, _TaskTimeline]" = \
            OrderedDict()
        # node idx -> latest (remote_mono - head_mono) estimate; kept
        # outside NodeState so stamps from already-dead nodes still fold
        self.node_clock_offsets: Dict[int, float] = {}
        self.stragglers_flagged = 0
        self.slow_nodes_flagged = 0
        self._last_slow_node_event: Dict[tuple, float] = {}
        # node idx -> monotonic deadline while the slow_node detector's
        # skew flag is ROUTABLE-AROUND (r14): refreshed on every
        # detection, surfaced as `slow` in the nodes state rows so
        # serve routers can deprioritize the host's replicas. Written
        # under _metrics_lock (the detector holds it); TTL'd reads are
        # GIL-atomic dict gets.
        self._slow_node_until: Dict[int, float] = {}
        # (node, phase) -> cumulative bucket vector at the last detector
        # sweep: the skew check judges the DELTA since then (recent
        # behavior), not the lifetime histogram — a node's early stall
        # would otherwise keep its cumulative p95 skewed, re-stamping
        # the routing flag long after the host recovered.
        self._node_phase_prev: Dict[tuple, list] = {}
        # Structured cluster event log (reference: the GCS event
        # aggregator behind `ray list cluster-events`): severity-tagged
        # records from head-side emitters and any process's
        # CLUSTER_EVENT pushes, bounded with drop counting.
        self.cluster_events: "deque" = deque(
            maxlen=get_config().cluster_event_buffer_size)
        self.cluster_events_dropped = 0
        # last node.* telemetry gauges per node (reporter.py rows),
        # mirrored into list_nodes() rows
        self.node_telemetry: Dict[int, dict] = {}
        self._telemetry = None  # NodeTelemetryReporter, started in start()
        # cluster-merged metrics: (name, tags_key) -> row dict
        self.metrics: Dict[tuple, dict] = {}
        # auto-names for actors created by non-Python frontends
        self._xlang_actor_seq = itertools.count()
        self._log_monitor = None
        # --- head fault tolerance (r12, the GCS-FT analog) ---
        # (client_id, request_id) -> cached success reply for retried
        # mutations: a reconnecting channel replays in-flight requests
        # after reattach with their ORIGINAL rids, and a mutation that
        # already landed must be re-acked, not re-applied. None values
        # are WAL-restored entries ("applied before the crash, reply
        # unknown") answered with the generic per-type ack.
        self._dedupe: "OrderedDict[tuple, Optional[tuple]]" = OrderedDict()
        self._dedupe_lock = threading.Lock()
        self.dedupe_hits = 0
        self.client_reconnects = 0   # CLIENT_HELLO reattach=True count
        self._reconnect_clients: set = set()  # distinct reattaching ids
        self.node_reattaches = 0     # REGISTER_NODE with a prior node id
        self.actor_reclaims = 0      # surviving actor workers re-claimed
        # bootstrap grace window of a restarted head: set below when the
        # WAL shows a previous incarnation; while active, lease granting
        # and the detectors hold so re-registrations can stream in
        self._grace_until = 0.0
        self._grace_reported = False
        self._last_node_reg_ts = time.monotonic()
        # Durable control-plane WAL (reference: GCS Redis store client).
        self._persist: Optional[HeadStore] = None
        self._wal_backlog: List[tuple] = []  # records queued under _lock
        self._restored_actor_specs: List[bytes] = []
        self._restored_pg_specs: List[bytes] = []
        if get_config().head_persistence:
            self._persist = HeadStore(session_dir)
            state = self._persist.restore()
            if state:
                self.kv = {ns: dict(t) for ns, t in state["kv"].items()}
                self._restored_actor_specs = list(state["actors"].values())
                self._restored_pg_specs = list(state["pgs"].values())
                for key in state.get("dedupe", ()):
                    self._dedupe[tuple(key)] = None
                self._grace_until = (time.monotonic()
                                     + get_config().head_restart_grace_s)
                self.emit_event(
                    "WARNING", "head", "head_restarted",
                    f"head restarted from WAL in {session_dir} "
                    f"(holding scheduling up to "
                    f"{get_config().head_restart_grace_s:g}s for "
                    "re-registrations)",
                    extra={"restored_kv_namespaces": len(self.kv),
                           "restored_actors":
                               len(self._restored_actor_specs),
                           "restored_pgs": len(self._restored_pg_specs)})

    def start(self):
        self.io.start()
        # Wire-saturation events from this process's connections land in
        # the ring directly (a CoreContext created later in the same
        # process re-targets the callback at its head connection — same
        # ring either way).
        from .events import wire_backpressure_fields

        def _on_wire_backpressure(peer, frames, nbytes):
            sev, src, etype, msg, extra = \
                wire_backpressure_fields(peer, frames, nbytes)
            self.emit_event(sev, src, etype, msg, extra=extra)

        P.set_backpressure_callback(_on_wire_backpressure)
        # Tail worker log files -> "logs" pubsub channel; drivers mirror
        # them when log_to_driver=True (reference: log_monitor.py:103).
        from .log_monitor import LogMonitor

        self._log_monitor = LogMonitor(
            self.session_dir,
            lambda ch, data: self._publish(ch, dumps(data)))
        self._log_monitor.start()
        # OOM control: kill the newest busy worker under memory pressure
        # (reference: memory_monitor.h:52 + retriable-LIFO kill policy)
        from .memory_monitor import MemoryMonitor

        self._memory_monitor = MemoryMonitor(self)
        self._memory_monitor.start()
        # Housekeeping loop: pending-PG retries and idle-worker reaping
        # must not depend on any client calling in — a placement group
        # that couldn't be placed at creation (resources transiently held
        # by leases) would otherwise stay pending forever.
        self._housekeeper = threading.Thread(
            target=self._housekeeping_loop, daemon=True, name="head-keeper")
        self._housekeeper.start()
        # Physical telemetry for the head host, published per local
        # logical node (reference: reporter_agent.py; remote hosts run
        # their own reporter inside the node agent).
        from .reporter import NodeTelemetryReporter

        def _local_nodes():
            with self._lock:
                return [(n.idx, n.store) for n in self.nodes.values()
                        if n.alive and not n.is_remote]

        self._telemetry = NodeTelemetryReporter(
            lambda batch: self._h_metrics_report(None, 0, batch),
            _local_nodes)
        self._telemetry.start()
        # Straggler detector: periodically compare each RUNNING task's
        # current exec time against its func's completed-exec p95 and
        # per-node phase p95s against the cluster median (reference
        # motivation: one straggler gates every synchronous TPU step).
        if get_config().straggler_detect_period_s > 0:
            self._straggler_thread = threading.Thread(
                target=self._straggler_loop, daemon=True,
                name="head-straggler")
            self._straggler_thread.start()
        # Worker spawner thread: fork+exec of an interpreter costs
        # 20-300 ms of syscalls — measured blocking the head IO loop
        # (and the head lock) for exactly that long per spawn when run
        # inline in a lease handler. _spawn_worker records the starting
        # WorkerInfo synchronously (stampede accounting) and hands the
        # Popen to this thread. (reference: worker_pool.cc forks from
        # the raylet main loop but the raylet is not also the GCS)
        self._spawner = threading.Thread(
            target=self._spawn_loop, daemon=True, name="head-spawner")
        self._spawner.start()
        # Task-event fold thread: folds TASK_EVENTS batches into the
        # timeline table off the IO loop (handlers just enqueue). Started
        # here so unstarted unit-test heads keep folding inline.
        self._fold_thread = threading.Thread(
            target=self._fold_loop, daemon=True, name="head-fold")
        self._fold_thread.start()
        # Lease dispatcher thread: batched grant passes off the IO loop.
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True, name="head-dispatch")
        self._dispatcher.start()
        # Prestart the worker pool (reference: WorkerPool prestart,
        # worker_pool.cc num_prestarted_python_workers): interpreter
        # startup costs O(seconds); forking CPU-count workers now means a
        # first burst of tasks finds idle workers instead of paying the
        # spawn storm mid-workload.
        cfg = get_config()
        if cfg.prestart_workers:
            with self._lock:
                for node in self.nodes.values():
                    if node.is_remote:
                        continue
                    n = int(node.resources.total.to_dict().get("CPU", 0))
                    n = min(n, cfg.max_workers_per_node)
                    for _ in range(n):
                        self._spawn_worker(node, ("prestart",))

    def enable_tcp(self, host: str = "0.0.0.0", port: int = 0,
                   advertise_ip: str = "") -> str:
        """Open the TCP control-plane listener so other hosts can join
        (the reference's gRPC GcsServer port; SURVEY.md §5 DCN plane)."""
        if self.tcp_addr:
            return self.tcp_addr
        self._tcp_listener = P.listen_tcp(host, port)
        bound_port = self._tcp_listener.getsockname()[1]
        ip = advertise_ip or (host if host not in ("0.0.0.0", "") else
                              _local_ip())
        self.tcp_addr = f"tcp:{ip}:{bound_port}"
        self.io.add_listener(self._tcp_listener, self._on_accept)
        # Multi-host session: serve the head's local arenas to peers.
        from .object_transfer import TransferServer

        self._transfer_server = TransferServer(
            self.io, self._read_local_object, advertise_ip=ip,
            partial_fn=self._partial_local_object)
        return self.tcp_addr

    def _read_local_object(self, oid: ObjectID):
        """TransferServer read_fn over every in-process node store: any
        local holder in the directory can serve the pull (primary first)."""
        with self.objects.lock_for(oid):
            loc = self.objects.get(oid)
            if loc is None:
                return None
            nodes = self._holder_nodes(loc)
        for node in nodes:
            if node.store is None:
                continue
            got = node.store.get(oid)
            if got is None:
                continue
            data_v, meta_v = got
            return (data_v, bytes(meta_v),
                    lambda n=node: n.store.release(oid))
        return None

    def _partial_local_object(self, oid: ObjectID):
        """TransferServer partial_fn over every in-process node store:
        an in-progress pull into any head-local arena can relay its
        chunks to downstream pullers (cooperative broadcast)."""
        with self._lock:
            stores = [n.store for n in self.nodes.values()
                      if n.store is not None and n.alive]
        for s in stores:
            part = s.partial(oid)
            if part is not None:
                return part
        return None

    def _puller_for(self, node: NodeState):
        from .object_transfer import ObjectPuller

        p = self._pullers.get(node.idx)
        if p is None:
            p = self._pullers[node.idx] = ObjectPuller(self.io, node.store)
        return p

    # ------------------------------------------------------------- nodes

    def add_node(self, num_cpus=None, num_gpus=None, memory=None,
                 object_store_memory=None, resources=None, labels=None,
                 tpu_topology=None) -> int:
        cfg = get_config()
        with self._lock:
            idx = self._next_node_idx
            self._next_node_idx += 1
        store_name = f"rtpu_{self.session_name}_{idx}"
        cap = object_store_memory or cfg.object_store_memory
        store = ShmObjectStore(store_name, cap, create=True)
        # head-driven writes into this arena (relay _node_store_write,
        # _puller_for pulls) can evict LRU objects: keep the object
        # directory honest for those too. Workers attached to the same
        # arena report their own evictions via context's hook. _lock is
        # an RLock, so firing inside a locked head path is safe.
        store.on_evict = lambda oids, _i=idx: self._on_local_evictions(
            _i, oids)
        nr = detect_node_resources(num_cpus=num_cpus, num_gpus=num_gpus,
                                   memory=memory,
                                   object_store_memory=cap,
                                   resources=resources, labels=labels)
        if tpu_topology is not None:
            nr.tpu = tpu_topology
        node = NodeState(idx=idx, resources=nr, store=store,
                         store_name=store_name)
        with self._lock:
            self.nodes[idx] = node
            self.scheduler.add_node(idx, nr)
            self._last_node_reg_ts = time.monotonic()
        self.emit_event("INFO", "head", "node_registered",
                        f"local node {idx} registered", node_idx=idx,
                        extra={"resources": nr.total.to_dict()})
        self._flush_restored()
        return idx

    def _grace_active(self) -> bool:
        """Restarted head's SCHEDULING holdback: True while lease
        granting and the detectors must wait for re-registrations.
        Lifts at ``head_restart_grace_s``, or EARLY once at least one
        node is registered and no node/worker registration has landed
        for 0.5s (reattaches arrive in a burst — the quiet period marks
        the stream's end, so an embedded restart pays ~0.5s instead of
        the full window). The restored-entity flush holdback
        (``_flush_restored``) deliberately does NOT lift early: a
        surviving actor worker's reclaim may trail the node burst by a
        couple of backoff rounds, and a WAL reschedule racing it would
        fork a fresh actor that shadows the live one."""
        gu = self._grace_until
        if not gu:
            return False
        now = time.monotonic()
        if now >= gu:
            self._grace_until = 0.0
            self._report_grace_end()
            return False
        if self.nodes and now - self._last_node_reg_ts >= 0.5:
            # scheduling resumes early; _grace_until stays set so the
            # restored-entity flush still waits out the full window.
            # No dispatcher kick here: this is routinely observed from
            # INSIDE a dispatch pass (via _try_grant_locked), and the
            # dispatcher's 0.25s tick resumes queued leases anyway.
            self._report_grace_end()
            return False
        return True

    def _report_grace_end(self):
        if self._grace_reported:
            return
        self._grace_reported = True
        self.emit_event(
            "INFO", "head", "head_grace_ended",
            f"restart grace window ended with {len(self.nodes)} nodes "
            f"({self.node_reattaches} reattached); scheduling resumed",
            extra={"nodes": len(self.nodes),
                   "node_reattaches": self.node_reattaches})

    def _flush_restored(self):
        """Reschedule durable entities replayed from a previous head's WAL,
        now that a node exists to place them on (reference: GCS failover
        reschedules detached actors / placement groups from the Redis
        tables — gcs_actor_manager.cc, gcs_placement_group_manager.cc).
        Held back for the FULL restart grace window: a surviving actor
        worker re-claiming its actor must win over a fresh reschedule of
        the same WAL spec (the reclaim empties the spec from the
        restored list, making this a no-op for it)."""
        if self._grace_until and time.monotonic() < self._grace_until:
            return  # periodic() retries once the window expires
        with self._lock:
            pg_specs, self._restored_pg_specs = self._restored_pg_specs, []
            a_specs, self._restored_actor_specs = \
                self._restored_actor_specs, []
        for sb in pg_specs:
            spec: PlacementGroupSpec = loads(sb)
            with self._lock:
                if spec.pg_id in self.pgs:
                    continue
                placement = self.scheduler.place_bundles(spec)
                if placement is None:
                    self.pgs[spec.pg_id] = PgInfo(spec=spec)
                    self._pending_pg.append(spec.pg_id)
                else:
                    self._commit_pg(spec, placement)
        for sb in a_specs:
            spec = loads(sb)
            info = ActorInfo(actor_id=spec.actor_id, spec=spec,
                             name=spec.name or "")
            with self._lock:
                if spec.actor_id in self.actors or (
                        info.name and info.name in self.named_actors):
                    continue
                self.actors[spec.actor_id] = info
                if info.name:
                    self.named_actors[info.name] = spec.actor_id
            self._schedule_actor(info)

    # scheduling class assigned to workers recreated from an agent's
    # re-registration report: they re-enter the idle pool under it when
    # their own REGISTER lands, so the repurpose-across-classes path can
    # lease them again instead of forking fresh interpreters
    REATTACH_CLASS = ("_reattached",)

    def register_remote_node(self, conn: P.Connection, resources,
                             store_name: str, node_ip: str,
                             session_dir: str,
                             transfer_addr: str = "",
                             prior_idx: int = -1, worker_ids=(),
                             holder_report=()) -> int:
        """A node agent on another host joins over TCP (the reference's
        raylet registration with the GCS, gcs_node_manager.cc).

        Re-registration (GCS-FT analog: raylets re-register after a
        gcs_server restart): a reattaching agent sends its PRIOR node
        id, its live worker set, and a full object-store holder report.
        The head keeps (or recreates) the node under the same index,
        recreates the reported workers as ``starting`` entries (each
        flips to a leasable idle worker when its own REGISTER arrives),
        and rebuilds the — deliberately non-WAL'd — object directory
        from holder truth."""
        reattached = False
        with self._lock:
            # Idempotent per connection: a reconnecting agent's reattach
            # hook re-registers AND its original in-flight REGISTER_NODE
            # (no prior idx yet) may be replayed afterwards on the same
            # socket — the second request must return the same node, not
            # mint a ghost entry that double-counts the host's resources.
            prev = getattr(conn, "_registered_node_idx", None)
            if prev is not None:
                existing = self.nodes.get(prev)
                if existing is not None and \
                        existing.store_name == store_name:
                    return prev
            node = None
            if prior_idx >= 0:
                existing = self.nodes.get(prior_idx)
                if existing is not None and \
                        existing.store_name == store_name:
                    # brief socket loss, head never evicted the node:
                    # swap the channel in place
                    node = existing
                    old = node.agent_conn
                    if old is not None and old is not conn:
                        old.on_close = None
                        old.close()
                    node.agent_conn = conn
                    node.alive = True
                    node.health_failures = 0
                    idx = prior_idx
                    reattached = True
                elif existing is None:
                    # restarted head: the table died with it — recreate
                    # the node under its prior index so worker env vars
                    # and directory reports stay coherent
                    idx = prior_idx
                    self._next_node_idx = max(self._next_node_idx,
                                              prior_idx + 1)
                    reattached = True
                # else: index collision with a different store (prior
                # idx recycled) — fall through to a fresh index
            if node is None:
                if not reattached:
                    idx = self._next_node_idx
                    self._next_node_idx += 1
                node = NodeState(idx=idx, resources=resources, store=None,
                                 store_name=store_name, agent_conn=conn,
                                 node_ip=node_ip, session_dir=session_dir,
                                 transfer_addr=transfer_addr)
                self.nodes[idx] = node
                self.scheduler.add_node(idx, resources)
            now = time.monotonic()
            self._last_node_reg_ts = now
            conn._registered_node_idx = idx
            if reattached:
                self.node_reattaches += 1
                for wid in worker_ids:
                    if wid in node.workers:
                        continue
                    node.workers[wid] = WorkerInfo(
                        worker_id=wid, node_idx=idx,
                        sched_class=self.REATTACH_CLASS, spawned_at=now)
        conn.peer = f"agent:node{idx}"
        conn.on_close = lambda c, i=idx: self._on_agent_close(i)
        # holder truth -> object directory (off the head lock: the
        # directory has its own shard locks). Answers any locates that
        # were already parked by reconnected drivers.
        for ob, size in holder_report:
            self._directory_add(ObjectID(ob), idx, int(size))
        if reattached:
            self.emit_event(
                "INFO", "head", "node_reattached",
                f"node {idx} re-registered from {node_ip} "
                f"({len(worker_ids)} live workers, "
                f"{len(holder_report)} held objects reported)",
                node_idx=idx,
                extra={"node_ip": node_ip,
                       "live_workers": len(worker_ids),
                       "held_objects": len(holder_report)})
        else:
            self.emit_event("INFO", "head", "node_registered",
                            f"remote node {idx} joined from {node_ip}",
                            node_idx=idx,
                            extra={"node_ip": node_ip,
                                   "resources":
                                       resources.total.to_dict()})
        self._publish("node_added", dumps(idx))
        self._flush_restored()
        return idx

    def _on_agent_close(self, idx: int):
        """Agent connection lost => the host is gone (failure detection)."""
        if not self._shutdown:
            self.remove_node(idx, kill_workers=True)

    def _h_register_node(self, conn, rid, resources, store_name, node_ip,
                         session_dir, transfer_addr="", prior_idx=-1,
                         worker_ids=(), holder_report=()):
        idx = self.register_remote_node(conn, resources, store_name,
                                        node_ip, session_dir, transfer_addr,
                                        prior_idx=prior_idx,
                                        worker_ids=worker_ids,
                                        holder_report=holder_report)
        conn.reply(rid, idx, self.session_name,
                   msg_type=P.REGISTER_NODE_REPLY)
        # Handshake clock-offset probe: sample (agent_mono - head_mono)
        # NOW rather than waiting for the first health-check period, so
        # the node's very first task events already fold into the head
        # timebase. Off-thread: the agent's PING reply rides this same
        # IO thread.
        node = self.nodes.get(idx)
        if node is not None:
            threading.Thread(target=self._ping_node, args=(node,),
                             daemon=True, name="clock-probe").start()
        self._try_fulfill_pending()

    # --------------------------------------------------- graceful drain

    def drain_node(self, idx: int) -> bool:
        """Begin a GRACEFUL drain (r16; reference: the NodeManager
        ``DrainNode`` RPC the autoscaler uses for planned scale-down —
        node_manager.cc HandleDrainNode — vs the kill path chaos
        exercises). The node is immediately excluded from lease grants,
        placements and prefetch/warm targets (``scheduler.drain_node``
        pulls it from the schedulable set); its sole-copy objects
        replicate off via the existing pull machinery; and once every
        in-flight lease has completed — or ``drain_deadline_s`` passes,
        whichever first — the deliberate r12 ``SHUTDOWN_NODE`` removal
        fires. A ``node_draining`` event + pubsub frame lets workloads
        (the pipeline's stage migration) move their work off BEFORE the
        shutdown instead of eating a crash. Idempotent; False when the
        node is unknown/dead — or the BOOTSTRAP node (idx 0): that is
        the head host's own node, whose arena the driver puts into and
        whose removal the drain would escalate to, bricking the
        cluster from one CLI command (the reference likewise never
        drains the head node)."""
        if idx == 0:
            return False
        with self._lock:
            node = self.nodes.get(idx)
            if node is None or not node.alive:
                return False
            if node.draining:
                return True
            node.draining = True
            node.drain_started = time.monotonic()
            node.drain_replicating = True  # first pass spawns below
            self.scheduler.drain_node(idx)
            self.drains_started += 1
            live_leases = sum(1 for l in self.leases.values()
                              if l[0] == idx)
        # speculative pulls aimed at a departing host are wasted work
        # (and would re-create copies the drain is moving off)
        self._purge_node_prefetches(idx)
        deadline_s = get_config().drain_deadline_s
        self.emit_event(
            "WARNING", "head", "node_draining",
            f"node {idx} draining: {live_leases} in-flight leases, "
            f"deadline {deadline_s:g}s",
            node_idx=idx,
            extra={"live_leases": live_leases,
                   "drain_deadline_s": deadline_s})
        self._publish("node_draining", dumps(idx))
        threading.Thread(target=self._replicate_off_node, args=(idx,),
                         daemon=True, name=f"drain-replicate-{idx}")\
            .start()
        return True

    class _ReplySink:
        """Throwaway conn stand-in for internal reuse of reply-shaped
        helpers (the drain replication pass drives _do_object_transfer
        with no requester to answer)."""

        def __init__(self):
            self.ok = False
            self.err = None

        def reply(self, rid, *fields, **kw):
            self.ok = True

        def reply_error(self, rid, err):
            self.err = err

    def _replicate_off_node(self, idx: int):
        """Drain replication pass: every object whose ONLY arena copy
        lives on the draining node is copied to a surviving node
        through the normal transfer machinery (store-to-store for
        remote targets, arena memcpy for head-local ones), so the
        eventual SHUTDOWN_NODE loses no data. Spilled objects already
        survive on disk. Sets ``drain_replicated`` when done — the
        drain completion check waits for it (up to the deadline)."""
        moved = failed = 0
        aborted = False
        assigned_bytes: Dict[int, int] = {}  # spread across survivors
        # ONE survivor snapshot per pass — re-scanning the node table
        # under the head lock per object would serialize a large drain
        # against the grant path O(objects) times. The per-object
        # failover below tolerates a stale entry (a dying target just
        # fails that transfer; the _check_drains retry re-snapshots).
        with self._lock:
            all_targets = [n for n in self.nodes.values()
                           if n.alive and not n.draining
                           and n.idx != idx
                           and (n.store is not None
                                or n.agent_conn is not None)]
        for oid, loc in self.objects.items_snapshot():
            with self.objects.lock_for(oid):
                sole = self._is_sole_copy(idx, loc)
            if not sole:
                continue
            if not all_targets:
                aborted = True
                break  # nowhere to put copies: deadline escalation
            # least-loaded-first over the bytes THIS pass already
            # assigned (tie -> lowest idx), with the rest as failover —
            # funneling everything at one survivor would fill its
            # arena and fail the replication the drain exists for
            targets = sorted(
                all_targets,
                key=lambda n: (assigned_bytes.get(n.idx, 0), n.idx))
            ok = False
            for dst in targets:
                sink = self._ReplySink()
                try:
                    self._do_object_transfer(sink, 0, oid, loc, dst)
                except Exception:  # noqa: BLE001 — try the next target
                    sink.err = sink.err or True
                if sink.ok:
                    ok = True
                    assigned_bytes[dst.idx] = \
                        assigned_bytes.get(dst.idx, 0) + loc.size
                    break
            if ok:
                moved += 1
                self.drain_objects_replicated += 1
            else:
                failed += 1
        # the clean-finish path requires EVERY sole copy safely moved:
        # an aborted or partly-failed pass leaves the flag unset, so
        # the drain waits out the deadline and escalates with the
        # honest drain_forced WARNING instead of reporting "copies
        # replicated" over silent data loss
        with self._lock:
            node = self.nodes.get(idx)
            if node is not None:
                node.drain_replicating = False
                node.drain_last_pass = time.monotonic()
                if not aborted and failed == 0:
                    node.drain_replicated = True
        if moved or failed:
            self.emit_event(
                "INFO", "head", "node_draining",
                f"node {idx} drain replication: {moved} sole-copy "
                f"objects moved off" + (f", {failed} failed" if failed
                                        else ""),
                node_idx=idx,
                extra={"replicated": moved, "failed": failed})

    @staticmethod
    def _is_sole_copy(idx: int, loc: _ObjLoc) -> bool:
        """The ONE sole-copy predicate drain replication and its
        completion re-scan must agree on (caller holds the object's
        shard lock) — two drifting copies would either finish a drain
        over unreplicated objects or loop passes forever."""
        return (idx in loc.holders and len(loc.holders) == 1
                and not loc.spilled_path and loc.size > 0)

    def _sole_copy_count(self, idx: int) -> int:
        """Objects whose ONLY arena copy lives on node ``idx`` (the
        drain completion check re-verifies this right before removal —
        a lease still running during the replication pass may have
        put() fresh sole copies after the pass scanned)."""
        count = 0
        for oid, loc in self.objects.items_snapshot():
            with self.objects.lock_for(oid):
                if self._is_sole_copy(idx, loc):
                    count += 1
        return count

    def _check_drains(self):
        """Housekeeping: complete or escalate in-progress drains. A
        drain completes — ``node_drained`` + the deliberate removal
        (SHUTDOWN_NODE to the agent) — once the node holds no live
        leases, the replication pass finished clean, AND a final
        sole-copy re-scan comes back empty (objects created on the
        node AFTER the pass re-run it rather than dying with the
        removal); past ``drain_deadline_s`` it force-escalates
        (``drain_forced``) instead of wedging, and surviving work
        rides the normal lineage/retry machinery."""
        deadline_s = get_config().drain_deadline_s
        now = time.monotonic()
        candidates: List[int] = []
        repass: List[int] = []
        force: List[Tuple[int, int, bool]] = []
        with self._lock:
            for node in self.nodes.values():
                if not node.draining or not node.alive:
                    continue
                left = sum(1 for l in self.leases.values()
                           if l[0] == node.idx)
                if now - node.drain_started > deadline_s:
                    force.append((node.idx, left,
                                  node.drain_replicated))
                elif left == 0 and node.drain_replicated \
                        and not node.drain_replicating:
                    candidates.append(node.idx)
                elif not node.drain_replicated \
                        and not node.drain_replicating \
                        and now - node.drain_last_pass > 1.0:
                    # the last pass failed (transient transfer error,
                    # or momentarily no target) — keep retrying inside
                    # the deadline rather than letting one hiccup turn
                    # into a forced escalation
                    node.drain_replicating = True
                    repass.append(node.idx)
        for idx in repass:
            threading.Thread(target=self._replicate_off_node,
                             args=(idx,), daemon=True,
                             name=f"drain-replicate-{idx}").start()
        finish: List[int] = []
        for idx in candidates:
            if self._sole_copy_count(idx) == 0:
                finish.append(idx)
                continue
            # fresh sole copies landed after the replication pass (a
            # then-live lease put() them): run another pass before
            # declaring the drain clean
            with self._lock:
                node = self.nodes.get(idx)
                if node is None or node.drain_replicating:
                    continue
                node.drain_replicated = False
                node.drain_replicating = True
            threading.Thread(target=self._replicate_off_node,
                             args=(idx,), daemon=True,
                             name=f"drain-replicate-{idx}").start()
        for idx in finish:
            self.drains_completed += 1
            self.emit_event(
                "INFO", "head", "node_drained",
                f"node {idx} drained: all leases migrated, copies "
                "replicated; shutting it down",
                node_idx=idx,
                extra={"forced": False,
                       "migrated_leases": self.drain_migrated_leases})
            self._publish("node_drained", dumps(idx))
            self.remove_node(idx)
        for idx, left, replicated in force:
            self.drains_forced += 1
            self.emit_event(
                "WARNING", "head", "drain_forced",
                f"node {idx} drain deadline ({deadline_s:g}s) passed "
                f"with {left} leases still live"
                + ("" if replicated
                   else " and sole-copy replication incomplete")
                + " — force-removing (surviving work retries via "
                "lineage)",
                node_idx=idx,
                extra={"leases_killed": left,
                       "replication_done": replicated,
                       "drain_deadline_s": deadline_s})
            self._publish("node_drained", dumps(idx))
            self.remove_node(idx)

    def remove_node(self, idx: int, kill_workers: bool = True):
        """Node failure (chaos testing / scale-down / agent loss)."""
        with self._lock:
            node = self.nodes.pop(idx, None)
            self.scheduler.remove_node(idx)
        with self._metrics_lock:
            self.node_telemetry.pop(idx, None)
            self._slow_node_until.pop(idx, None)
            for phase in ("dispatch", "arg_fetch"):
                self._node_phase_prev.pop((idx, phase), None)
            # prune the node's telemetry gauges from the merged metric
            # table too — a dead host must not keep exporting
            # fresh-looking node_cpu_percent rows to scrapers forever
            # (match on the reserved {"node": idx} tag shape so user
            # metrics merely named node.* are untouched)
            for key in [k for k, row in self.metrics.items()
                        if k[0].startswith("node.")
                        and row["tags"] == {"node": str(idx)}]:
                del self.metrics[key]
            # ... and its per-node phase histograms: a removed node's
            # frozen dispatch/arg_fetch distribution must not keep
            # feeding the slow_node skew detector (or the exposition)
            for key in [k for k, row in self.metrics.items()
                        if k[0] == "task.node_phase_ms"
                        and row["tags"].get("node") == str(idx)]:
                del self.metrics[key]
        if node is None:
            return
        node.alive = False
        # prefetches aimed at the dead host can never land: drop them
        # and release their source charges (no waste counting — host
        # loss, not task churn)
        self._purge_node_prefetches(idx)
        # a drained node's removal is the PLANNED end of a graceful
        # drain, not a failure — keep severity-based alerting honest
        self.emit_event(
            "INFO" if node.draining else "ERROR", "head", "node_dead",
            f"node {idx} removed"
            + (" after graceful drain" if node.draining else "")
            + (" (agent lost/evicted)"
               if node.is_remote and not node.draining else ""),
            node_idx=idx,
            extra={"is_remote": node.is_remote,
                   "drained": node.draining,
                   "workers_killed": len(node.workers)
                   if kill_workers else 0})
        if kill_workers:
            doomed = list(node.workers.values())
            for w in doomed:
                self._kill_worker_process(w)
            for w in doomed:
                if w.actor_id is not None:
                    # _kill_worker_process pre-marks the worker "dead",
                    # which SUPPRESSES the conn-close death path — so a
                    # node removal used to leave its actors ALIVE with a
                    # dead address and pending callers hung to their
                    # timeout. Route the death explicitly: restartable
                    # actors reschedule elsewhere, the rest go DEAD and
                    # every pending caller gets a prompt ActorDiedError
                    # (the surface the r16 pipeline repair planner
                    # relies on).
                    self._on_actor_worker_death(w.actor_id)
        # objects whose ONLY copy lived on this node are lost: answer any
        # blocked locates with the LOST sentinel (-2) and remember the ids
        # so later locates fail fast — owners react by re-executing the
        # creating task (lineage reconstruction; reference:
        # object_recovery_manager.h:41). Objects with surviving replicas
        # in the directory just fail over to another holder.
        # broadcast bookkeeping for the dead host: it can no longer be a
        # relay (in-progress location) nor serve its assigned downstream
        # pulls — drop both so the planner stops routing at it (its
        # in-flight downstream pullers fail over via connection loss)
        dead_addr = node.transfer_addr if node.is_remote else ""
        self._reply_lost(self.objects.purge_node(idx, dead_addr))
        if node.store is not None:
            node.store.close()
        if node.agent_conn is not None:
            node.agent_conn.on_close = None
            try:
                # deliberate eviction: tell the agent to die now rather
                # than reconnect-and-re-register off the socket close
                node.agent_conn.send(P.SHUTDOWN_NODE)
            except P.ConnectionLost:
                pass  # agent already gone (the usual removal cause)
            node.agent_conn.close()
        self._publish("node_removed", dumps(idx))

    def _kill_worker_process(self, w: WorkerInfo):
        w.state = "dead"
        if w.conn:
            if w.sched_class is not None or w.actor_id is not None:
                # r12: workers hold RECONNECTING head channels — a bare
                # close reads as a head outage and the worker would
                # linger for head_reconnect_timeout_s re-dialing the
                # live head and retrying registration. Send the
                # explicit die-now frame first (the context's
                # KILL_ACTOR handler os._exit(0)s) so deliberate kills
                # stay instant even when no agent/proc handle can
                # deliver a signal (e.g. node removal after its agent
                # died). Never sent to drivers (sched_class None,
                # no actor).
                try:
                    w.conn.send(P.KILL_ACTOR, b"", True)
                except P.ConnectionLost:
                    pass
            w.conn.close()
        if w.proc and w.proc.poll() is None:
            try:
                w.proc.kill()
            except OSError:
                pass
        elif w.proc is None:
            # remote worker: ask its node agent to kill the process
            node = self.nodes.get(w.node_idx)
            if node is not None and node.agent_conn is not None:
                try:
                    node.agent_conn.send(P.KILL_WORKER, w.worker_id)
                except P.ConnectionLost:
                    pass

    # --------------------------------------------------------- accept/IO

    def _on_accept(self, sock, addr):
        conn = P.Connection(sock, peer="incoming")
        conn.on_close = self._on_conn_close
        self.io.add_connection(conn, self._on_message)

    def _on_conn_close(self, conn: P.Connection):
        with self._lock:
            dead = None
            for node in self.nodes.values():
                for w in node.workers.values():
                    if w.conn is conn and w.state != "dead":
                        dead = w
                        break
        if dead is not None:
            self._handle_worker_death(dead)
        for chan_subs in self.subs.values():
            chan_subs.discard(conn)

    def _on_message(self, conn: P.Connection, msg):
        mt, rid = msg[0], msg[1]
        try:
            handler = self._HANDLERS[mt]
        except KeyError:
            if rid > 0:
                conn.reply_error(rid, ValueError(f"unknown msg {mt}"))
            return
        # Request dedupe (GCS-FT analog): a reconnecting channel replays
        # in-flight requests after reattach with their original rids. A
        # mutation that already landed is re-ACKED from the cache (or
        # the generic per-type ack for WAL-restored keys), never
        # re-applied; first-time requests run under a recording proxy.
        target = conn
        if rid > 0 and mt in _DEDUPE_TYPES:
            cid = getattr(conn, "client_id", None)
            if cid is not None:
                key = (cid, rid)
                hit, cached = self._dedupe_lookup(key)
                if hit:
                    self.dedupe_hits += 1
                    if cached is None:
                        cached = _DEDUPE_GENERIC[mt]
                    reply_mt, fields = cached
                    try:
                        conn.send(reply_mt, *fields, request_id=-rid)
                    except P.ConnectionLost:
                        pass
                    return
                target = _DedupeRecorder(self, conn, key, mt)
        try:
            handler(self, target, rid, *msg[2:])
        except P.ConnectionLost as e:
            # Swallow ONLY "the requester itself vanished mid-request"
            # (e.g. a worker killed during a shutdown wave): nobody to
            # answer, and replying would raise on the same dead socket.
            # Anything else — another peer's socket breaking inside a
            # handler's fan-out, or a ConnectionLost UNPICKLED from a
            # remote error reply (``__reduce__`` strips ``conn``, so it
            # arrives with conn=None) — is a real handler failure: the
            # requester is alive and must hear it, not block to its RPC
            # timeout.
            if e.conn is not conn:
                if rid > 0:
                    try:
                        conn.reply_error(rid, e)
                    except P.ConnectionLost:
                        pass
                else:
                    import traceback

                    traceback.print_exc()
        except Exception as e:  # noqa: BLE001
            if rid > 0:
                try:
                    conn.reply_error(rid, e)
                except P.ConnectionLost:
                    pass
            else:
                import traceback

                traceback.print_exc()

    def _dedupe_lookup(self, key):
        """-> (hit, cached_reply_or_None)."""
        with self._dedupe_lock:
            if key in self._dedupe:
                return True, self._dedupe[key]
        return False, None

    def _record_dedupe(self, key, mt: int, reply: tuple):
        with self._dedupe_lock:
            self._dedupe[key] = reply
            while len(self._dedupe) > _DEDUPE_CAP:
                self._dedupe.popitem(last=False)
        if mt in _DEDUPE_DURABLE and self._persist is not None:
            # the dedupe key must survive a crash ALONGSIDE the durable
            # mutation it acks — a retry crossing a restart is then
            # re-acked generically instead of re-applied
            self._enqueue_wal(("dedupe", key[0], key[1]))

    def _h_client_hello(self, conn, rid, client_id, reattach=False):
        """A reconnecting head channel identifies itself (first frame on
        every connect). The id keys the request-dedupe map; reattaches
        are counted for the reconnect-storm doctor warning — alongside
        the DISTINCT reattaching clients, so one clean restart of a
        large cluster (one reattach per client) is distinguishable from
        a flapping head (many reattaches per client)."""
        conn.client_id = client_id
        if reattach:
            self.client_reconnects += 1
            if len(self._reconnect_clients) < 8192:
                self._reconnect_clients.add(client_id)

    # ----------------------------------------------------- worker registry

    def _h_register(self, conn, rid, worker_id, pid, listen_addr, node_idx,
                    actor_spec_bytes=None):
        """Worker/driver registration. ``actor_spec_bytes`` (GCS-FT
        re-registration): a surviving ACTOR worker reconnecting after a
        head restart ships its creation TaskSpec so the restarted head
        rebuilds the actor table from worker truth — the actor keeps its
        state and address instead of being rescheduled from the WAL (the
        reference's gcs_actor_manager rebuilding from reports after
        failover)."""
        reclaim_info = None
        with self._lock:
            node = self.nodes.get(node_idx)
            if node is None:
                conn.reply_error(rid, RuntimeError(f"no node {node_idx}"))
                return
            w = node.workers.get(worker_id)
            if w is None:
                w = WorkerInfo(worker_id=worker_id, node_idx=node_idx)
                node.workers[worker_id] = w
            w.pid = pid
            w.listen_addr = listen_addr
            w.conn = conn
            conn.peer = f"worker:{worker_id[:8]}"
            if self._grace_until:
                # worker re-registrations extend the quiet window the
                # early scheduling lift waits on — they trail their
                # node's burst by a backoff round or two
                self._last_node_reg_ts = time.monotonic()
            stale_duplicate = False
            if actor_spec_bytes is not None:
                reclaim_info = self._reclaim_actor_locked(
                    node, w, actor_spec_bytes)
                if reclaim_info is None:
                    # the actor was already rescheduled onto another
                    # live worker while this one was away: this
                    # surviving instance is a stale duplicate — it must
                    # die, not linger as a second copy of the actor's
                    # state (and not sit in "starting" feeding the
                    # stuck-re-registering doctor warning)
                    stale_duplicate = True
                    w.actor_id = None
            elif w.state == "starting":
                w.state = "idle"
                w.idle_since = time.monotonic()
                if w.sched_class is not None:
                    node.idle_by_class.setdefault(w.sched_class, []).append(
                        worker_id)
        conn.reply(rid, node.store_name,
                   node.session_dir or self.session_dir)
        if stale_duplicate:
            with self._lock:
                # ensure the die-now poison is sent (it is gated off
                # drivers by sched_class/actor_id)
                w.sched_class = w.sched_class or self.REATTACH_CLASS
                self._kill_worker_process(w)
                node.workers.pop(worker_id, None)
            return
        if reclaim_info is not None:
            info, waiters = reclaim_info
            self.emit_event(
                "INFO", "head", "actor_reclaimed",
                f"actor {info.actor_id.hex()[:8]}"
                + (f" '{info.name}'" if info.name else "")
                + f" re-claimed by surviving worker {worker_id[:8]}",
                node_idx=node_idx, entity_id=info.actor_id.hex())
            for wconn, wrid in waiters:
                try:
                    wconn.reply(wrid, "ALIVE", info.listen_addr,
                                msg_type=P.GET_ACTOR_REPLY)
                except P.ConnectionLost:
                    pass
            self._publish(f"actor:{info.actor_id.hex()}",
                          dumps(("ALIVE", info.listen_addr)))
        self._try_fulfill_pending()

    def _reclaim_actor_locked(self, node: NodeState, w: WorkerInfo,
                              actor_spec_bytes: bytes):
        """Rebuild an actor's table entry from its surviving worker's
        re-registration (caller holds the head lock). Returns
        (ActorInfo, pending_get waiters) or None when another live
        worker already owns the actor id."""
        spec: TaskSpec = loads(actor_spec_bytes)
        aid = spec.actor_id
        info = self.actors.get(aid)
        if info is not None and info.state == "ALIVE" and \
                info.worker_id and info.worker_id != w.worker_id:
            # the current owner may live on ANY node (e.g. the WAL
            # reschedule picked a different host after this worker's
            # reattach outlasted the grace window) — checking only this
            # node's table would let the stale instance steal back
            for n in self.nodes.values():
                other = n.workers.get(info.worker_id)
                if other is not None and other.state != "dead":
                    return None  # already rescheduled onto a live worker
        w.state = "actor"
        w.actor_id = aid
        w.sched_class = spec.scheduling_class()
        if info is None:
            info = ActorInfo(actor_id=aid, spec=spec,
                             name=spec.name or "")
            self.actors[aid] = info
        info.state = "ALIVE"
        info.listen_addr = w.listen_addr
        info.worker_id = w.worker_id
        if info.name:
            self.named_actors[info.name] = aid
        waiters = list(info.pending_get_replies)
        info.pending_get_replies.clear()
        # the WAL-restored spec (if any) must not ALSO be rescheduled
        # when the grace window lifts — the reclaim wins
        aid_bin = aid.binary()
        self._restored_actor_specs = [
            sb for sb in self._restored_actor_specs
            if loads(sb).actor_id.binary() != aid_bin]
        # re-anchor resource accounting: the old lease died with the old
        # head — mint a fresh one so the actor's resources are held and
        # released on death like any scheduled actor's (best-effort: an
        # oversubscribed post-restart node just skips the allocation)
        req = ResourceSet(spec.resources)
        if w.lease_id is None:
            if node.resources.is_available(req):
                node.resources.allocate(req)
            else:
                req = ResourceSet({})
            lease_id = f"{self._lease_prefix}{next(self._lease_seq):x}"
            self.leases[lease_id] = (node.idx, req, w.worker_id, None,
                                     None)
            w.lease_id = lease_id
        self.actor_reclaims += 1
        return info, waiters

    def register_driver(self, conn: Optional[P.Connection] = None):
        self._driver_conn = conn

    # ----------------------------------------------------------- leases

    def _h_lease_request(self, conn, rid, sched_class, resources, job_id_hex,
                         strategy_bytes, arg_ids=None):
        """``arg_ids`` — binary ObjectIDs of the sample task's by-reference
        args (the reference ships the same hint with lease requests so the
        raylet can score locality, LocalityAwareLeasePolicy)."""
        self._queue_lease(conn, rid, sched_class, resources, job_id_hex,
                          strategy_bytes, arg_ids)
        self._try_fulfill_pending()

    def _queue_lease(self, conn, rid, sched_class, resources, job_id_hex,
                     strategy_bytes, arg_ids=None):
        # the strategy is parsed ONCE at enqueue — the old per-pass
        # loads() re-parsed every queued request on every dispatch retry
        strategy = loads(strategy_bytes)
        with self._lock:
            self._pending_leases.append(
                (conn, rid, tuple(sched_class), ResourceSet(resources),
                 job_id_hex, strategy_bytes, arg_ids, strategy))

    def _try_fulfill_pending(self):
        """Kick the lease dispatcher (reference:
        ClusterTaskManager::ScheduleAndDispatchTasks). With the
        dispatcher thread running (start()ed heads) this only signals
        it — callers on the IO loop return immediately; unstarted
        unit-test heads run the batched pass inline."""
        d = self._dispatcher
        if d is not None and d.is_alive():
            self._dispatch_event.set()
        else:
            self._dispatch_pass()

    def _dispatch_loop(self):
        while not self._shutdown:
            self._dispatch_event.wait(0.25)
            self._dispatch_event.clear()
            if self._shutdown:
                return
            try:
                self._dispatch_pass()
            except Exception:
                if not self._shutdown:
                    import traceback

                    traceback.print_exc()

    def _dispatch_pass(self):
        """ONE batched grant pass: every pending lease is tried under a
        single head-lock hold, and the grants are replied per-connection
        afterwards — many grants to one driver ride a single
        LEASE_GRANT_BATCH frame (the request-side mirror of r8's
        TASK_DONE_BATCH). Requests that stay ungrantable remain queued;
        anything that frees resources re-signals the dispatcher."""
        by_conn: Dict[P.Connection, list] = {}
        prefetch_jobs: List[tuple] = []
        with self._lock:
            if not self._pending_leases:
                return
            pending = list(self._pending_leases)
            demand: dict = {}
            for item in pending:
                demand[item[2]] = demand.get(item[2], 0) + 1
            # ONE cluster-wide starting-workers scan per pass (the
            # spawn gate reads it per attempt; rescanning nodes x
            # workers per pending lease would put O(pending * workers)
            # back under the head-lock hold)
            spawn_budget = [self._count_starting(time.monotonic())]
            for item in pending:
                (conn, rid, sched_class, request, _job_hex, _sb,
                 arg_ids, strategy) = item
                grant = self._try_grant_locked(
                    sched_class, request, strategy,
                    demand=demand.get(sched_class, 1), arg_ids=arg_ids,
                    spawn_budget=spawn_budget)
                if grant is None:
                    continue
                try:
                    self._pending_leases.remove(item)
                except ValueError:
                    continue
                worker, lease_id = grant
                gpu_ids = self.leases[lease_id][4]
                by_conn.setdefault(conn, []).append(
                    (rid, worker.worker_id, worker.listen_addr, lease_id,
                     gpu_ids))
                if arg_ids:
                    # speculative arg prefetch (r13): issued AFTER the
                    # lock drops, in this same pass, so the pull runs
                    # while the lease reply / driver dispatch / worker
                    # wakeup are still in flight
                    prefetch_jobs.append(
                        (lease_id, worker.node_idx, arg_ids))
        if not by_conn:
            return
        batch_max = get_config().lease_grant_batch_max
        for conn, grants in by_conn.items():
            try:
                if batch_max > 1 and len(grants) > 1:
                    for i in range(0, len(grants), batch_max):
                        chunk = grants[i:i + batch_max]
                        conn.send(P.LEASE_GRANT_BATCH, chunk)
                        self.lease_grant_batches += 1
                        self.lease_grants_batched += len(chunk)
                else:
                    for rid, wid, addr, lease_id, gpu_ids in grants:
                        conn.reply(rid, True, wid, addr, lease_id, None,
                                   gpu_ids, msg_type=P.LEASE_REPLY)
            except P.ConnectionLost:
                # Requester (driver) died while its lease request was
                # queued — undo the grants so the workers and resources
                # return to the pool instead of leaking.
                for _rid, wid, _addr, lease_id, _gpu in grants:
                    self._h_return_worker(conn, 0, lease_id, wid)
        for lease_id, node_idx, arg_ids in prefetch_jobs:
            self._maybe_prefetch_args(lease_id, node_idx, arg_ids)

    def _try_grant(self, sched_class, request: ResourceSet, strategy,
                   demand: int = 1, arg_ids=None
                   ) -> Optional[Tuple[object, str]]:
        with self._lock:
            return self._try_grant_locked(sched_class, request, strategy,
                                          demand=demand, arg_ids=arg_ids)

    def _count_starting(self, now: float) -> int:
        """Cluster-wide count of workers still forking/importing
        (caller holds the lock)."""
        return sum(1 for n in self.nodes.values()
                   for w in n.workers.values()
                   if w.state == "starting" and now - w.spawned_at < 60.0)

    def _try_grant_locked(self, sched_class, request: ResourceSet, strategy,
                          demand: int = 1, arg_ids=None, spawn_budget=None
                          ) -> Optional[Tuple[object, str]]:
        """Try to allocate resources + a worker. Returns (WorkerInfo,
        lease_id) on success, or None (possibly after kicking off a
        worker spawn — the request stays queued and re-tries once the
        worker registers).

        ``spawn_budget`` — one-element list holding the cluster-wide
        count of starting workers, shared across one dispatch pass so
        the gate below reads (and bumps) it instead of rescanning every
        node's worker table per pending lease; None (direct callers,
        e.g. actor scheduling) computes it fresh.

        ``demand`` caps the spawn stampede: if at least that many workers of
        any class are already starting on the node, no new process is forked
        (the round-1 bug was the actor-creation retry timer forking a fresh
        interpreter every 50ms, starving the CPU so *no* worker ever finished
        importing; ref: WorkerPool pending-registration accounting,
        src/ray/raylet/worker_pool.cc).

        ``arg_ids`` (binary ObjectIDs of the sample task's by-ref args)
        turns on locality-aware placement: when those args' directory
        sizes total at least ``locality_min_arg_bytes``, the node already
        holding the most argument bytes is preferred over the hybrid
        policy — the bytes then never move at all (reference:
        LocalityAwareLeasePolicy over the object directory).

        Callers hold the head lock (the RLock re-entry below costs a
        counter bump and keeps direct callers safe)."""
        cfg = get_config()
        if self._grace_active():
            # restarted head, re-registrations still streaming in:
            # granting now would schedule against a half-empty node
            # table — requests stay queued; the dispatcher's 0.25s tick
            # retries until the window lifts
            return None
        with self._lock:
            loc_choice = None
            pg_id = strategy.placement_group_id
            if pg_id is not None:
                node_idx = self._pg_node_for(pg_id, strategy.bundle_index,
                                             request)
                if node_idx is None:
                    return None
            else:
                node_idx = None
                # hit/miss is counted only when the lease is actually
                # granted (below) — a queued lease re-runs this branch on
                # every dispatch retry while its worker spawns, and
                # counting attempts would inflate the placement counters
                # the object_plane endpoint reports by the retry rate
                if (arg_ids and cfg.scheduler_locality_enabled
                        and strategy.kind == "DEFAULT"):
                    scores, total = self.objects.locality_scores(arg_ids)
                    if total >= cfg.locality_min_arg_bytes:
                        node_idx = self.scheduler.best_locality_node(
                            request, scores)
                        loc_choice = "hit" if node_idx is not None \
                            else "miss"
                if node_idx is None:
                    node_idx = self.scheduler.best_node(request, strategy)
                if node_idx is None:
                    return None
            node = self.nodes[node_idx]
            if (pg_id is None and loc_choice is None
                    and strategy.kind == "DEFAULT"
                    and not any(node.idle_by_class.values())):
                # The policy's pick would have to FORK an interpreter
                # (20-300 ms of syscalls plus seconds of imports) while
                # another feasible node already holds a warm idle worker
                # — retarget there (reference analog: the WorkerPool's
                # idle-worker reuse preference). The scale bench measured
                # 16 mid-wave forks with 20 idle workers sitting on
                # unchosen nodes before this.
                alt = self._node_with_idle_worker(sched_class, request)
                if alt is not None:
                    node_idx, node = alt
            # Affinity may target a feasible-but-busy node: stay queued.
            if pg_id is None and not node.resources.is_available(request):
                return None
            # allocate resources
            if pg_id is not None:
                self._pg_allocate(pg_id, strategy.bundle_index, request)
            else:
                node.resources.allocate(request)
            # pooled-entropy lease ids: uuid4 hits os.urandom per call
            # (~34 us on the deployment kernel) and a burst pass mints
            # one per grant ATTEMPT, rolled back or not
            lease_id = f"{self._lease_prefix}{next(self._lease_seq):x}"
            gpu_ids = self._allocate_gpus(node, request)
            pg_binding = pg_id and (pg_id, strategy.bundle_index)
            self.leases[lease_id] = (node_idx, request, "", pg_binding,
                                     gpu_ids)
            # find idle worker of this class
            want = tuple(gpu_ids or ())
            idle = node.idle_by_class.get(sched_class)
            wid = _gpu_fit(node, idle, want)
            if wid is not None:
                idle.remove(wid)
                w = node.workers[wid]
                w.state = "leased"
                w.lease_id = lease_id
                w.gpu_ids = want
                self.leases[lease_id] = (node_idx, request, wid,
                                         pg_binding, gpu_ids)
                self._count_locality(loc_choice)
                return w, lease_id
            # reuse any idle worker (repurpose across scheduling classes)
            for cls, lst in node.idle_by_class.items():
                wid = _gpu_fit(node, lst, want)
                if wid is not None:
                    lst.remove(wid)
                    w = node.workers[wid]
                    w.state = "leased"
                    w.sched_class = sched_class
                    w.lease_id = lease_id
                    w.gpu_ids = want
                    self.leases[lease_id] = (node_idx, request, wid,
                                             pg_binding, gpu_ids)
                    self._count_locality(loc_choice)
                    return w, lease_id
            # spawn a new worker (unless enough are already starting),
            # re-queue the lease until it registers. The gate is bounded
            # by what THIS NODE can actually run concurrently for this
            # request — ``demand`` is the CLASS-wide pending count, and
            # gating on it alone let every node the scheduler touched
            # fork up to ``demand`` interpreters (measured: the worker
            # population grew 15 -> 74 across two identical task waves
            # while throughput halved; reference analog: WorkerPool
            # caps prestarts by available concurrency slots).
            now = time.monotonic()
            starting = sum(1 for w in node.workers.values()
                           if w.state == "starting"
                           and now - w.spawned_at < 60.0)
            req_cpu_fp = request.get_fp("CPU")
            if req_cpu_fp > 0:
                node_cap = max(1, node.resources.total.get_fp("CPU")
                               // req_cpu_fp)
            else:
                node_cap = get_config().max_workers_per_node
            # NOT gated on total live workers: leased workers may belong
            # to long-lived actors of other classes (counting them
            # starved gang creation on busy nodes); bounding STARTING
            # forks per node at its request-concurrency stops the
            # per-node storm. ALSO gated CLUSTER-WIDE at ``demand``:
            # the hybrid policy's randomized pick lands each retry pass
            # on fresh nodes, and the per-node gate alone let a 100-node
            # table fork up to 10 interpreters per pass on
            # never-before-touched nodes until ~100 were importing at
            # once on 2 cores (measured: head loop-lag p99 2.4s during
            # the scale wave from fork+import CPU alone). We never need
            # more forks in flight than ungranted requests exist.
            if spawn_budget is None:
                spawn_budget = [self._count_starting(now)]
            if starting < min(demand, node_cap) and \
                    spawn_budget[0] < demand:
                self._retire_idle_misfit(node)
                if self._spawn_worker(node, sched_class) is not None:
                    spawn_budget[0] += 1
            # roll back allocation; the pending lease will re-acquire
            if pg_id is not None:
                self._pg_release(pg_id, strategy.bundle_index, request)
            else:
                node.resources.release(request)
            self._release_gpus(node, gpu_ids)
            del self.leases[lease_id]
            return None

    def _retire_idle_misfit(self, node: NodeState):
        """At the node's worker cap, retire one idle worker so that a
        lease no idle worker fits can start its own. Every idle worker is
        a misfit here (``_gpu_fit`` took any other): it is bound to other
        GPU ids, which a worker that has initialized CUDA cannot change.
        Without this the lease would wait for the idle reaper
        (``idle_worker_keep_alive_s``). Caller holds the lock."""
        live = sum(1 for w in node.workers.values() if w.state != "dead")
        if live != get_config().max_workers_per_node:
            return  # a spawn goes below the cap; above it (drivers count
            # too) one retirement makes no room
        for lst in node.idle_by_class.values():
            if lst:
                self._kill_worker_process(node.workers.pop(lst.pop(0)))
                return

    def _node_with_idle_worker(self, sched_class, request: ResourceSet
                               ) -> Optional[Tuple[int, NodeState]]:
        """A schedulable node that can take ``request`` right now AND
        already holds an idle worker — exact scheduling class preferred,
        any-class repurpose otherwise. Caller holds the lock."""
        fallback = None
        for idx in self.scheduler.schedulable_nodes():
            n = self.nodes.get(idx)
            if n is None or not n.alive or \
                    not n.resources.is_available(request):
                continue
            if n.idle_by_class.get(sched_class):
                return idx, n
            if fallback is None and any(n.idle_by_class.values()):
                fallback = (idx, n)
        return fallback

    def _count_locality(self, loc_choice: Optional[str]):
        """Locality placement counters, bumped only on a completed grant
        (caller holds the lock)."""
        if loc_choice == "hit":
            self.locality_hits += 1
        elif loc_choice == "miss":
            self.locality_misses += 1

    def _allocate_gpus(self, node: NodeState, request: ResourceSet):
        """Assign specific GPU indices for a GPU lease — the reference's
        CUDA_VISIBLE_DEVICES assignment (worker.py:888 get_gpu_ids,
        resource-instance ids); workers export CUDA_VISIBLE_DEVICES.

        Caller holds the lock (called from _try_grant after allocation).
        """
        n = int(request.to_dict().get("GPU", 0))
        if n <= 0:
            return None
        if node.gpu_free is None:
            total = int(node.resources.total.to_dict().get("GPU", 0))
            node.gpu_free = list(range(total))
        gpus = node.gpu_free[:n]
        del node.gpu_free[:n]
        return gpus

    def _release_gpus(self, node: NodeState, gpu_ids):
        if gpu_ids and node.gpu_free is not None:
            node.gpu_free.extend(gpu_ids)
            node.gpu_free.sort()

    def _spawn_worker(self, node: NodeState, sched_class) -> WorkerInfo:
        """Record the starting worker and hand the fork to the spawner
        thread — callers hold the head lock inside IO handlers, and a
        synchronous fork+exec here measurably stalled the whole control
        plane per spawn."""
        cfg = get_config()
        if len([w for w in node.workers.values() if w.state != "dead"]) >= \
                cfg.max_workers_per_node:
            return None  # type: ignore[return-value]
        worker_id = _random_bytes(16).hex()
        w = WorkerInfo(worker_id=worker_id, node_idx=node.idx,
                       sched_class=sched_class,
                       spawned_at=time.monotonic())
        node.workers[worker_id] = w
        if node.is_remote:
            # delegated fork: the node agent on the remote host Popens the
            # worker (the reference's raylet WorkerPool::StartWorkerProcess)
            try:
                node.agent_conn.send(P.SPAWN_WORKER, worker_id)
            except P.ConnectionLost:
                node.workers.pop(worker_id, None)
                return None  # type: ignore[return-value]
            return w
        self._spawn_q.put((node, w))
        return w

    def _spawn_loop(self):
        while not self._shutdown:
            try:
                item = self._spawn_q.get(timeout=0.5)
            except queue.Empty:
                continue
            node, w = item
            try:
                with self._lock:
                    if w.state != "starting":
                        continue  # killed/cleaned while queued
                self._popen_worker(node, w)
                # TOCTOU: a ghost-sweep/shutdown may have declared this
                # worker dead between the check and the fork — an
                # untracked interpreter would register with no
                # sched_class and pin a worker slot until head shutdown
                with self._lock:
                    if w.state != "starting" and w.proc is not None \
                            and w.proc.poll() is None:
                        try:
                            w.proc.kill()
                        except OSError:
                            pass
            except Exception as e:  # noqa: BLE001 — mark dead, don't die
                with self._lock:
                    w.state = "dead"
                    # drop the record too: persistent fork failure +
                    # the 0.25s lease retry would otherwise grow
                    # node.workers by a dead entry per attempt forever
                    node.workers.pop(w.worker_id, None)
                print(f"[ray_tpu] worker spawn failed: {e!r}",
                      file=sys.stderr)

    def _popen_worker(self, node: NodeState, w: WorkerInfo):
        worker_id = w.worker_id
        env = dict(os.environ)
        # Ship the driver's full sys.path to workers (the reference does the
        # same via its runtime env / worker setup, worker.py): functions and
        # classes pickled *by reference* (module-level defs, e.g. in pytest
        # test modules whose dir pytest inserted into sys.path) must be
        # importable where they execute.
        import ray_tpu_torch

        pkg_parent = os.path.dirname(os.path.dirname(
            os.path.abspath(ray_tpu_torch.__file__)))
        pp = env.get("PYTHONPATH", "")
        entries = [p for p in sys.path if p] + [pkg_parent]
        have = set(pp.split(os.pathsep)) if pp else set()
        add = [p for p in entries if p not in have]
        if add:
            env["PYTHONPATH"] = os.pathsep.join(
                add + ([pp] if pp else []))
        env.update({
            "RAY_TPU_WORKER_ID": worker_id,
            "RAY_TPU_HEAD_ADDR": self.addr,
            "RAY_TPU_NODE_IDX": str(node.idx),
            "RAY_TPU_SESSION_DIR": self.session_dir,
        })
        if node.resources.total.get("GPU") <= 0:
            # Workers on GPU-less logical nodes must not touch a card; on
            # a GPU node each task exports its lease's ids at entry
            # (context.py _export_gpu_ids).
            env["CUDA_VISIBLE_DEVICES"] = ""
        log_dir = os.path.join(self.session_dir, "logs")
        os.makedirs(log_dir, exist_ok=True)
        out = open(os.path.join(log_dir, f"worker-{worker_id[:8]}.out"), "ab")
        w.proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.core.worker_main"],
            env=env, stdout=out, stderr=subprocess.STDOUT,
            start_new_session=True)
        return w

    def _h_return_worker(self, conn, rid, lease_id, worker_id, dispose=False):
        try:
            self._return_worker_inner(lease_id, worker_id, dispose)
        finally:
            # runs even when the lease or its node is already gone
            # (node death raced the return): the lease's unconsumed
            # prefetches are stale speculation either way, and their
            # per-lease records must not accumulate across churn
            self._abort_lease_prefetches(lease_id)

    def _return_worker_inner(self, lease_id, worker_id, dispose):
        with self._lock:
            lease = self.leases.pop(lease_id, None)
            if lease is None:
                return
            node_idx, request, _, pg_binding, gpu_ids = lease
            node = self.nodes.get(node_idx)
            if node is None:
                return
            if node.draining and node.alive:
                # the lease ended while its node drains: work moved off
                # cleanly instead of dying with the shutdown
                self.drain_migrated_leases += 1
            if pg_binding:
                self._pg_release(pg_binding[0], pg_binding[1], request)
            else:
                node.resources.release(request)
            self._release_gpus(node, gpu_ids)
            w = node.workers.get(worker_id)
            if w is not None and w.state == "leased":
                if dispose:
                    self._kill_worker_process(w)
                    node.workers.pop(worker_id, None)
                else:
                    w.state = "idle"
                    w.lease_id = None
                    w.idle_since = time.monotonic()
                    node.idle_by_class.setdefault(w.sched_class, []).append(
                        worker_id)
        self._try_fulfill_pending()
        # freed resources may unblock a pending placement group too
        self._retry_pending_pgs()

    def _handle_worker_death(self, w: WorkerInfo):
        with self._lock:
            # already "dead" => a deliberate kill (_kill_worker_process
            # ran first: kill(), OOM policy); only UNEXPECTED deaths log
            # a worker_died event — deliberate paths log their own
            # (actor_dead, worker_oom_kill), and a duplicate WARNING
            # here would false-alarm severity-based alerting
            unexpected = w.state != "dead"
            w.state = "dead"
            node = self.nodes.get(w.node_idx)
            if node:
                for lst in node.idle_by_class.values():
                    if w.worker_id in lst:
                        lst.remove(w.worker_id)
                if w.lease_id and w.lease_id in self.leases:
                    node_idx, request, _, pg_binding, gpu_ids = \
                        self.leases.pop(w.lease_id)
                    if node.draining and node.alive and not unexpected:
                        # deliberate kill during a drain (e.g. the
                        # pipeline retiring its migrated stage actor):
                        # the lease moved off, nothing failed
                        self.drain_migrated_leases += 1
                    if pg_binding:
                        self._pg_release(pg_binding[0], pg_binding[1], request)
                    else:
                        node.resources.release(request)
                    self._release_gpus(node, gpu_ids)
            actor_id = w.actor_id
        if w.lease_id:
            self._abort_lease_prefetches(w.lease_id)
        if unexpected:
            self.emit_event("WARNING", "head", "worker_died",
                            f"worker {w.worker_id[:8]} died",
                            node_idx=w.node_idx, entity_id=w.worker_id)
        if actor_id is not None:
            self._on_actor_worker_death(actor_id)
        self._publish("worker_failed", dumps(w.worker_id))
        self._try_fulfill_pending()

    # ----------------------------------------------------------- actors

    def _h_create_actor(self, conn, rid, spec_bytes):
        spec: TaskSpec = loads(spec_bytes)
        info = ActorInfo(actor_id=spec.actor_id, spec=spec,
                         name=spec.name or "")
        with self._lock:
            self.actors[spec.actor_id] = info
            if info.name:
                if info.name in self.named_actors:
                    conn.reply_error(rid, ValueError(
                        f"actor name '{info.name}' already taken"))
                    return
                self.named_actors[info.name] = spec.actor_id
        if info.name and self._persist is not None:
            # named == detached: survives head restart (reference: GCS
            # actor table; detached actors rescheduled after failover)
            self._enqueue_wal(("actor", spec_bytes))
        self._schedule_actor(info)
        conn.reply(rid, True, msg_type=P.CREATE_ACTOR_REPLY)

    def _schedule_actor(self, info: ActorInfo):
        """Lease a worker and push the creation task (reference:
        GcsActorScheduler::ScheduleByGcs, gcs_actor_scheduler.cc:60)."""
        spec = info.spec
        request = ResourceSet(spec.resources)
        deadline = time.monotonic() + get_config().actor_creation_timeout_s
        # actors benefit from arg locality too: a big by-ref constructor
        # arg (e.g. sharded weights) anchors the actor next to the bytes
        # (same dedup + 32-arg hint cap as the task lease path)
        arg_ids = list(dict.fromkeys(
            enc[1] for enc in spec.args if enc[0] == ARG_REF))[:32]

        def attempt():
            if self._shutdown:
                return
            grant = self._try_grant(spec.scheduling_class(), request,
                                    spec.strategy, arg_ids=arg_ids)
            if grant is None:
                if time.monotonic() > deadline:
                    self._mark_actor_dead(info, "creation timed out (no "
                                          "feasible node/worker)")
                    return
                t = threading.Timer(0.05, attempt)
                t.daemon = True
                t.start()
                return
            w, lease_id = grant
            with self._lock:
                w.state = "actor"
                w.actor_id = spec.actor_id
                info.worker_id = w.worker_id
                info.listen_addr = w.listen_addr
                gpu_ids = self.leases[lease_id][4]
            try:
                push_spec = loads(dumps(spec))
                push_spec.gpu_ids = gpu_ids
                w.conn.send(P.PUSH_TASK, push_spec, 0)
            except P.ConnectionLost:
                self._on_actor_worker_death(spec.actor_id)
                return
            # ALIVE is announced only once the worker confirms the
            # constructor ran (TASK_REPLY on its registration conn).

        attempt()

    def _h_creation_reply(self, conn, rid, task_id_bin, status, result_meta,
                          err):
        """Actor-creation completion from the actor's worker."""
        with self._lock:
            w = None
            for node in self.nodes.values():
                for cand in node.workers.values():
                    if cand.conn is conn:
                        w = cand
                        break
            if w is None or w.actor_id is None:
                return
            info = self.actors.get(w.actor_id)
            if info is None:
                return
            if status != "ok":
                info.state = "DEAD"
                info.death_cause = f"creation failed: {err}"
                self._release_actor_name(info)
                waiters = list(info.pending_get_replies)
                info.pending_get_replies.clear()
                state, payload = "DEAD", info.death_cause
            else:
                info.state = "ALIVE"
                info.listen_addr = w.listen_addr
                waiters = list(info.pending_get_replies)
                info.pending_get_replies.clear()
                state, payload = "ALIVE", info.listen_addr
        if state == "ALIVE":
            self.emit_event(
                "INFO", "head", "actor_created",
                f"actor {info.spec.class_name or '?'} "
                f"{w.actor_id.hex()[:8]} alive",
                node_idx=w.node_idx, entity_id=w.actor_id.hex())
        else:
            self.emit_event("ERROR", "head", "actor_dead", payload,
                            node_idx=w.node_idx,
                            entity_id=w.actor_id.hex())
        for wconn, wrid in waiters:
            try:
                wconn.reply(wrid, state, payload,
                            msg_type=P.GET_ACTOR_REPLY)
            except P.ConnectionLost:
                pass  # that waiter died; the rest must still hear
        self._publish(f"actor:{w.actor_id.hex()}", dumps((state, payload)))

    def _h_actor_dead(self, conn, rid, actor_id_bin, cause):
        aid = ActorID(actor_id_bin)
        with self._lock:
            info = self.actors.get(aid)
        if info is not None:
            self._mark_actor_dead(info, cause)

    def _on_actor_worker_death(self, actor_id: ActorID):
        waiters: List[Tuple[P.Connection, int]] = []
        with self._lock:
            info = self.actors.get(actor_id)
            if info is None or info.state == "DEAD":
                return
            spec = info.spec
            can_restart = (spec.max_restarts == -1
                           or info.restarts_used < spec.max_restarts)
            if can_restart:
                info.restarts_used += 1
                info.state = "RESTARTING"
            else:
                info.state = "DEAD"
                info.death_cause = "worker died"
                self._release_actor_name(info)
                # GET_ACTOR waiters queued while the actor was
                # PENDING/RESTARTING must hear the death — the pubsub
                # channel alone leaves their blocking calls (and the
                # head-side waiter entries) stranded forever
                waiters = list(info.pending_get_replies)
                info.pending_get_replies.clear()
        for wconn, wrid in waiters:
            try:
                wconn.reply(wrid, "DEAD", info.death_cause,
                            msg_type=P.GET_ACTOR_REPLY)
            except P.ConnectionLost:
                pass  # that waiter died; the rest must still hear
        if info.state == "RESTARTING":
            self.emit_event(
                "WARNING", "head", "actor_restarted",
                f"actor {actor_id.hex()[:8]} restarting "
                f"({info.restarts_used} used)",
                entity_id=actor_id.hex(),
                extra={"restarts_used": info.restarts_used})
            self._publish(f"actor:{actor_id.hex()}", dumps(("RESTARTING", "")))
            self._schedule_actor(info)
        else:
            self.emit_event("ERROR", "head", "actor_dead",
                            f"actor {actor_id.hex()[:8]} dead: "
                            f"{info.death_cause}",
                            entity_id=actor_id.hex())
            self._publish(f"actor:{actor_id.hex()}",
                          dumps(("DEAD", info.death_cause)))

    def _mark_actor_dead(self, info: ActorInfo, cause: str):
        with self._lock:
            info.state = "DEAD"
            info.death_cause = cause
            waiters = list(info.pending_get_replies)
            info.pending_get_replies.clear()
            self._release_actor_name(info)
        self.emit_event("ERROR", "head", "actor_dead",
                        f"actor {info.actor_id.hex()[:8]} dead: {cause}",
                        entity_id=info.actor_id.hex())
        for wconn, wrid in waiters:
            try:
                wconn.reply(wrid, "DEAD", cause,
                            msg_type=P.GET_ACTOR_REPLY)
            except P.ConnectionLost:
                pass  # that waiter died; the rest must still hear
        self._publish(f"actor:{info.actor_id.hex()}", dumps(("DEAD", cause)))

    def _release_actor_name(self, info: ActorInfo):
        """Free a dead actor's name for reuse (head tables + KV mirror).

        The reference's GcsActorManager does the same on actor death
        (gcs_actor_manager.cc RemoveActorNameFromRegistry). Caller holds
        the lock."""
        if info.name and self.named_actors.get(info.name) == info.actor_id:
            del self.named_actors[info.name]
            self.kv.get("named_actor", {}).pop(info.name, None)
            if self._persist is not None:
                # callers hold self._lock — defer the file write (WAL
                # append can compact = read+rewrite+fsync the whole log).
                # The kv_del keeps the restored KV mirror consistent: a
                # restart must not resurrect a handle to a dead actor.
                self._wal_backlog.append(
                    ("actor_gone", info.actor_id.binary()))
                self._wal_backlog.append(
                    ("kv_del", "named_actor", info.name))

    def _h_get_actor(self, conn, rid, actor_id_bin_or_name):
        with self._lock:
            if isinstance(actor_id_bin_or_name, str):
                aid = self.named_actors.get(actor_id_bin_or_name)
                dead = aid is not None and (
                    self.actors.get(aid) is None
                    or self.actors[aid].state == "DEAD")
                if aid is None or dead:
                    conn.reply(rid, "NOT_FOUND", "",
                               msg_type=P.GET_ACTOR_REPLY)
                    return
            else:
                aid = ActorID(actor_id_bin_or_name)
            info = self.actors.get(aid)
            if info is None:
                conn.reply(rid, "NOT_FOUND", "", msg_type=P.GET_ACTOR_REPLY)
                return
            if info.state in ("PENDING", "RESTARTING"):
                info.pending_get_replies.append((conn, rid))
                return
            state, addr = info.state, info.listen_addr
            extra = info.death_cause if state == "DEAD" else ""
        conn.reply(rid, state, addr if state == "ALIVE" else extra,
                   msg_type=P.GET_ACTOR_REPLY,
                   )

    def _h_kill_actor(self, conn, rid, actor_id_bin, no_restart):
        aid = ActorID(actor_id_bin)
        with self._lock:
            info = self.actors.get(aid)
            if info is None:
                if rid > 0:
                    conn.reply(rid, False)
                return
            if no_restart:
                info.spec.max_restarts = 0
                info.state = "DEAD"
                info.death_cause = "killed via kill()"
                self._release_actor_name(info)
            node = self.nodes.get(
                next((n.idx for n in self.nodes.values()
                      if info.worker_id in n.workers), -1))
            w = node.workers.get(info.worker_id) if node else None
        if w is not None:
            self._kill_worker_process(w)
            # Reap synchronously: _kill_worker_process marks the worker dead,
            # which suppresses the conn-close death path — without this the
            # lease (and its CPU/TPU grant) leaks on every kill().
            self._handle_worker_death(w)
            with self._lock:
                node = self.nodes.get(w.node_idx)
                if node is not None:
                    node.workers.pop(w.worker_id, None)
        if no_restart:
            self.emit_event("ERROR", "head", "actor_dead",
                            f"actor {aid.hex()[:8]} killed via kill()",
                            entity_id=aid.hex())
            self._publish(f"actor:{aid.hex()}",
                          dumps(("DEAD", "killed via kill()")))
        if rid > 0:
            conn.reply(rid, True)

    # ------------------------------------------------------ placement groups

    def _h_create_pg(self, conn, rid, spec_bytes):
        spec: PlacementGroupSpec = loads(spec_bytes)
        with self._lock:
            placement = self.scheduler.place_bundles(spec)
            if placement is None:
                feasible = all(
                    any(self.nodes[i].resources.is_feasible(
                        ResourceSet(b.resources))
                        for i in self.scheduler.schedulable_nodes())
                    for b in spec.bundles)
                if not feasible:
                    self.emit_event(
                        "ERROR", "head", "pg_infeasible",
                        f"placement group {spec.pg_id.hex()[:8]} "
                        "infeasible: no node can ever fit some bundle",
                        entity_id=spec.pg_id.hex())
                    # not persisted: the client sees an error, so a restart
                    # must not resurrect a phantom group
                    conn.reply_error(rid, RuntimeError(
                        "placement group infeasible: no node can ever fit "
                        "some bundle"))
                    return
                # retry later when resources free up
                info = PgInfo(spec=spec)
                self.pgs[spec.pg_id] = info
                self._pending_pg.append(spec.pg_id)
                reply = ("PENDING",)
            else:
                self._commit_pg(spec, placement)
                reply = ("CREATED",)
        if self._persist is not None:
            self._enqueue_wal(("pg", spec_bytes))
        conn.reply(rid, *reply, msg_type=P.CREATE_PG_REPLY)

    def _commit_pg(self, spec: PlacementGroupSpec, placement: List[int]):
        """Reserve bundle resources on nodes (2PC prepare+commit collapses to
        one step in-process; reference gcs_placement_group_scheduler.cc)."""
        info = self.pgs.get(spec.pg_id) or PgInfo(spec=spec)
        info.spec = spec
        info.placement = placement
        info.bundle_available = []
        for b, node_idx in zip(spec.bundles, placement):
            rs = ResourceSet(b.resources)
            self.nodes[node_idx].resources.allocate(rs)
            info.bundle_available.append(rs)
        info.state = "CREATED"
        self.pgs[spec.pg_id] = info
        self.emit_event("INFO", "head", "pg_ready",
                        f"placement group {spec.pg_id.hex()[:8]} ready on "
                        f"nodes {placement}",
                        entity_id=spec.pg_id.hex(),
                        extra={"placement": list(placement)})
        # mirror into KV: non-driver processes poll kv_get("pg_state", ...)
        # from PlacementGroup.ready() (api.py _pg_state)
        self.kv.setdefault("pg_state", {})[spec.pg_id.hex()] = b"CREATED"
        self._publish(f"pg:{spec.pg_id.hex()}", dumps("CREATED"))

    def _retry_pending_pgs(self):
        with self._lock:
            pending = list(self._pending_pg)
            for pg_id in pending:
                info = self.pgs.get(pg_id)
                if info is None or info.state != "PENDING":
                    self._pending_pg.remove(pg_id)
                    continue
                placement = self.scheduler.place_bundles(info.spec)
                if placement is not None:
                    self._commit_pg(info.spec, placement)
                    self._pending_pg.remove(pg_id)

    def _h_remove_pg(self, conn, rid, pg_id_bin):
        pg_id = PlacementGroupID(pg_id_bin)
        if self._persist is not None:
            self._enqueue_wal(("pg_gone", pg_id_bin))
        with self._lock:
            self.kv.setdefault("pg_state", {})[pg_id.hex()] = b"REMOVED"
            info = self.pgs.pop(pg_id, None)
            if info and info.state == "CREATED":
                for b, node_idx, avail in zip(info.spec.bundles,
                                              info.placement,
                                              info.bundle_available):
                    node = self.nodes.get(node_idx)
                    if node:
                        # return whatever portion is not currently in use by
                        # leases; in-use portions return on lease release
                        node.resources.release(avail)
        if rid > 0:
            conn.reply(rid, True)
        self._try_fulfill_pending()

    def _pg_node_for(self, pg_id, bundle_index, request) -> Optional[int]:
        info = self.pgs.get(pg_id)
        if info is None or info.state != "CREATED":
            return None
        if bundle_index >= 0:
            if info.bundle_available[bundle_index].covers(request):
                return info.placement[bundle_index]
            return None
        for i, avail in enumerate(info.bundle_available):
            if avail.covers(request):
                return info.placement[i]
        return None

    def _pg_allocate(self, pg_id, bundle_index, request):
        info = self.pgs[pg_id]
        if bundle_index < 0:
            for i, avail in enumerate(info.bundle_available):
                if avail.covers(request):
                    bundle_index = i
                    break
        info.bundle_available[bundle_index] = \
            info.bundle_available[bundle_index].subtract(request)

    def _pg_release(self, pg_id, bundle_index, request):
        info = self.pgs.get(pg_id)
        if info is None:
            return
        if bundle_index < 0:
            bundle_index = 0
        info.bundle_available[bundle_index] = \
            info.bundle_available[bundle_index].add(request)

    def pg_state(self, pg_id: PlacementGroupID) -> str:
        with self._lock:
            info = self.pgs.get(pg_id)
            return info.state if info else "REMOVED"

    def pg_placement(self, pg_id: PlacementGroupID) -> List[int]:
        with self._lock:
            info = self.pgs.get(pg_id)
            return list(info.placement) if info else []

    # ------------------------------------------------------------ KV store

    def _h_kv_put(self, conn, rid, ns, key, value, overwrite):
        with self._lock:
            table = self.kv.setdefault(ns, {})
            if not overwrite and key in table:
                added = False
            else:
                table[key] = value
                added = True
        if added and self._persist is not None:
            self._enqueue_wal(("kv_put", ns, key, value))
        if rid > 0:
            conn.reply(rid, added)

    def _h_kv_get(self, conn, rid, ns, key):
        with self._lock:
            conn.reply(rid, self.kv.get(ns, {}).get(key))

    def _h_kv_del(self, conn, rid, ns, key):
        with self._lock:
            existed = self.kv.get(ns, {}).pop(key, None) is not None
        if existed and self._persist is not None:
            self._enqueue_wal(("kv_del", ns, key))
        if rid > 0:
            conn.reply(rid, existed)

    def _h_kv_keys(self, conn, rid, ns, prefix):
        with self._lock:
            keys = [k for k in self.kv.get(ns, {}) if k.startswith(prefix)]
        conn.reply(rid, keys)

    # ------------------------------------------------------------- pubsub

    def _h_subscribe(self, conn, rid, channel):
        with self._lock:
            self.subs.setdefault(channel, set()).add(conn)
        if rid > 0:
            conn.reply(rid, True)

    def _h_publish(self, conn, rid, channel, payload):
        self._publish(channel, payload)
        if rid > 0:
            conn.reply(rid, True)

    def _publish(self, channel: str, payload: bytes):
        with self._lock:
            targets = list(self.subs.get(channel, ()))
        for c in targets:
            try:
                c.send(P.PUBLISH, channel, payload)
            except P.ConnectionLost:
                with self._lock:
                    self.subs.get(channel, set()).discard(c)

    # ------------------------------------------------- object directory

    def _h_object_sealed(self, conn, rid, oid_bin, node_idx, size, owner,
                         job_id_hex=""):
        oid = ObjectID(oid_bin)
        node_idx, size, waiters = self.objects.record_sealed(
            oid, node_idx, size, owner, job_id_hex)
        for wconn, wrid in waiters:
            try:
                wconn.reply(wrid, node_idx, size, "",
                            msg_type=P.OBJECT_LOCATE_REPLY)
            except P.ConnectionLost:
                pass  # that waiter died; the rest must still hear
        if rid > 0:  # a task's return: its reply waits for this answer
            conn.reply(rid, True)
        self._maybe_spill(node_idx)

    def _h_obj_tag(self, conn, rid, oid_bins, tag):
        """Reference-class tag stamp (one-way; memory observatory)."""
        self.objects.tag_objects([ObjectID(ob) for ob in oid_bins],
                                 str(tag))
        if rid > 0:
            conn.reply(rid, True)

    def _directory_add(self, oid: ObjectID, node_idx: int, size: int = 0):
        """A node gained a copy (pull completion / replica creation)."""
        node_idx, size, waiters = self.objects.add_location(
            oid, node_idx, size)
        for wconn, wrid in waiters:
            try:
                wconn.reply(wrid, node_idx, size, "",
                            msg_type=P.OBJECT_LOCATE_REPLY)
            except P.ConnectionLost:
                pass

    def _h_obj_location_add(self, conn, rid, oid_bin, node_idx, size=0):
        self._directory_add(ObjectID(oid_bin), node_idx, size)
        if rid > 0:
            conn.reply(rid, True)

    def _on_local_evictions(self, node_idx: int, oids):
        """on_evict hook for head-local arenas: same directory upkeep as
        an agent's OBJ_LOCATION_REMOVE report, minus the network hop. The
        bookkeeping is in-memory under the head RLock — safe from any
        locked head path, including the head puller's IO thread — but the
        LOST-waiter replies are blocking socket writes, so they go to a
        side thread rather than stalling whatever triggered the eviction."""
        waiters = self.objects.remove_locations(list(oids), node_idx)
        if waiters:
            threading.Thread(target=self._reply_lost, args=(waiters,),
                             daemon=True).start()

    def _h_obj_location_remove(self, conn, rid, oid_bins, node_idx):
        """A node dropped copies (arena eviction / local deletion) — one
        batched message per eviction sweep."""
        self._reply_lost(self.objects.remove_locations(
            [ObjectID(ob) for ob in oid_bins], node_idx))
        if rid > 0:
            conn.reply(rid, True)

    def _reply_lost(self, waiters):
        """Answer blocked locates with the LOST sentinel (-2)."""
        for wconn, wrid in waiters:
            try:
                wconn.reply(wrid, -2, 0, "", msg_type=P.OBJECT_LOCATE_REPLY)
            except P.ConnectionLost:
                pass

    def _h_obj_location_lookup(self, conn, rid, oid_bin):
        """Full holder-set query: ([holder_idxs], [transfer_addrs], size,
        spilled_url). The lists are PARALLEL — addrs[i] serves holders[i]
        ('' when that holder has no reachable transfer server), so two
        head-local holders both report the head's one TransferServer
        address. A puller dedupes before striping."""
        oid = ObjectID(oid_bin)
        with self.objects.lock_for(oid):
            loc = self.objects.get(oid)
            if loc is None:
                conn.reply(rid, [], [], 0, "")
                return
            nodes = sorted(self._holder_nodes(loc), key=lambda n: n.idx)
            holders = [n.idx for n in nodes]
            addrs = [self._node_transfer_addr(n) for n in nodes]
            size, spilled = loc.size, loc.spilled_path
        conn.reply(rid, holders, addrs, size, spilled)

    def _h_object_locate(self, conn, rid, oid_bin, block):
        oid = ObjectID(oid_bin)
        with self.objects.lock_for(oid):
            loc = self.objects.get(oid)
            if loc is not None and (loc.node_idx >= 0 or loc.spilled_path):
                conn.reply(rid, loc.node_idx, loc.size, loc.spilled_path,
                           msg_type=P.OBJECT_LOCATE_REPLY)
                return
            if self.objects.is_lost(oid):
                # sealed once, then its node died: fail fast so the owner
                # can reconstruct instead of blocking forever
                conn.reply(rid, -2, 0, "", msg_type=P.OBJECT_LOCATE_REPLY)
                return
            if not block:
                conn.reply(rid, -1, 0, "", msg_type=P.OBJECT_LOCATE_REPLY)
                return
            self.objects.setdefault(oid).waiters.append((conn, rid))

    def _h_seal_aborted(self, conn, rid, oid_bins):
        """The creating task failed permanently: these returns will never
        seal. Mark them LOST and answer blocked locates with -2 so
        borrowers surface ObjectLostError instead of hanging (the owner
        holds the actual error in its in-process store)."""
        lost = []
        for ob in oid_bins:
            oid = ObjectID(ob)
            with self.objects.lock_for(oid):
                loc = self.objects.get(oid)
                if loc is not None and (loc.node_idx >= 0 or
                                        loc.spilled_path):
                    continue  # a real copy exists (e.g. partial returns)
                lost.append(oid)
        self._reply_lost(self.objects.mark_lost(lost))

    def _h_object_recovering(self, conn, rid, oid_bins):
        """An owner is re-executing the creating task for these lost
        objects: clear the LOST marker so consumers' blocking locates queue
        as waiters for the re-seal rather than failing fast."""
        for ob in oid_bins:
            self.objects.clear_lost(ObjectID(ob))
        if rid > 0:
            conn.reply(rid, True)

    def _h_object_free(self, conn, rid, oid_bins):
        for ob in oid_bins:
            oid = ObjectID(ob)
            loc = self.objects.pop(oid)
            self.objects.clear_lost(oid)
            if loc is None:
                continue
            if loc.spilled_path:
                try:
                    os.unlink(loc.spilled_path)
                except OSError:
                    pass
            # every holder in the directory drops its copy
            targets = set(loc.holders)
            if loc.node_idx >= 0:
                targets.add(loc.node_idx)
            for idx in targets:
                node = self.nodes.get(idx)
                if node is None or not node.alive:
                    continue
                if node.store is not None:
                    node.store.delete(oid)
                elif node.agent_conn is not None:
                    try:
                        node.agent_conn.send(P.AGENT_OBJ_FREE, [ob])
                    except P.ConnectionLost:
                        pass

    # ---- node-store access that works for local and remote nodes ----

    def _node_store_contains(self, node: NodeState, oid: ObjectID) -> bool:
        if node.store is not None:
            return node.store.contains(oid)
        return False  # remote: let the put be idempotent instead

    def _node_store_read(self, node: NodeState, oid: ObjectID):
        """-> (payload_bytes, meta_bytes) or None."""
        if node.store is not None:
            got = node.store.get(oid)
            if got is None:
                return None
            data_v, meta_v = got
            try:
                return bytes(data_v), bytes(meta_v)
            finally:
                del data_v, meta_v, got
                node.store.release(oid)
        payload, meta = node.agent_conn.call(
            P.AGENT_OBJ_GET, oid.binary(), timeout=120)
        if payload is not None:
            self.relay_bytes += len(payload)
        return None if payload is None else (payload, meta)

    def _node_store_write(self, node: NodeState, oid: ObjectID,
                          payload: bytes, meta: bytes):
        if node.store is not None:
            if node.store.contains(oid):
                return
            cfg = get_config()
            buf = node.store.create(oid, len(payload), len(meta))
            # chunked copy (mirrors 5 MiB transfer chunks)
            cs = cfg.object_transfer_chunk_bytes
            for off in range(0, len(payload), cs):
                buf[off:off + min(cs, len(payload) - off)] = \
                    payload[off:off + cs]
            buf[len(payload):] = meta
            node.store.seal(oid)
        else:
            self.relay_bytes += len(payload)
            node.agent_conn.call(P.AGENT_OBJ_PUT, oid.binary(), payload,
                                 meta, timeout=120)

    def _holder_nodes(self, loc: _ObjLoc, exclude_idx: int = -1
                      ) -> List[NodeState]:
        """Live holder nodes, primary first — THE directory traversal
        every read/transfer path shares (caller holds the lock)."""
        out: List[NodeState] = []
        for idx in dict.fromkeys([loc.node_idx] + sorted(loc.holders)):
            if idx < 0 or idx == exclude_idx:
                continue
            node = self.nodes.get(idx)
            if node is None or not node.alive:
                continue
            out.append(node)
        return out

    def _node_transfer_addr(self, node: NodeState) -> str:
        """The transfer address serving a node's objects — every
        head-local holder is served by the head host's one TransferServer."""
        if node.is_remote:
            return node.transfer_addr or ""
        return self._transfer_server.addr if self._transfer_server else ""

    def _plan_pull_sources(self, oid: ObjectID, loc: _ObjLoc,
                           dst_node: NodeState):
        """Broadcast-aware source planning for ONE brokered pull
        (reference: PullManager source selection over the
        ObjectDirectory's location set, pull_manager.cc — extended with
        the in-progress locations that make a cold one-to-many
        distribution a pipelined tree). Returns ``(addrs, relay_addrs,
        max_sources, charged)`` where ``charged`` is [(addr, weight)];
        the caller MUST pass ``charged`` to ``_finish_pull_assignment``
        when the pull ends, success or not.

        Policy: prefer sealed holders below their ``broadcast_fanout``
        load (striped, the PR1 behavior); with every root saturated,
        hand out ONE in-progress relay under the bound (max_sources=1 so
        the puller never also stripes the saturated roots — they stay in
        the list as failover-only candidates); with everything
        saturated, overload the least-loaded root and note it."""
        cfg = get_config()
        fanout = cfg.broadcast_fanout
        with self.objects.lock_for(oid):
            sealed_addrs = list(dict.fromkeys(
                a for n in self._holder_nodes(loc, exclude_idx=dst_node.idx)
                for a in (self._node_transfer_addr(n),) if a))
            if fanout <= 0 or not sealed_addrs or \
                    loc.size < cfg.pull_min_stripe_bytes:
                # cooperative planning off / object too small to matter:
                # the pre-r9 plan (stripe the full sealed holder set)
                return sealed_addrs, (), 0, []
            dst_addr = self._node_transfer_addr(dst_node)
            load = loc.serving
            relays: Tuple[str, ...] = ()
            free_roots = sorted(
                (a for a in sealed_addrs if load.get(a, 0) < fanout),
                key=lambda a: load.get(a, 0))
            if free_roots:
                chosen = free_roots[:max(1, cfg.pull_max_sources)]
                max_sources = len(chosen)
                # a k-way stripe takes ~1/k of each root's uplink:
                # charge fractionally so ordinary multi-holder striped
                # workloads don't read as broadcast saturation
                weight = 1.0 / len(chosen)
                self.broadcast_root_assignments += 1
            else:
                free_relays = sorted(
                    (a for i, a in loc.inprog.items()
                     if i != dst_node.idx and a and a != dst_addr
                     and a not in sealed_addrs
                     and load.get(a, 0) < fanout
                     and i in self.nodes and self.nodes[i].alive),
                    key=lambda a: load.get(a, 0))
                if free_relays:
                    chosen = [free_relays[0]]
                    relays = (free_relays[0],)
                    max_sources = 1
                    weight = 1.0
                    self.broadcast_relay_assignments += 1
                else:
                    # every source saturated: overload the least-loaded
                    # root rather than queueing (rate-limited event)
                    chosen = [min(sealed_addrs,
                                  key=lambda a: load.get(a, 0))]
                    max_sources = 1
                    weight = 1.0
                    self.broadcast_root_assignments += 1
                    self._note_fanout_saturated(oid, dst_node.idx)
            charged = [(a, weight) for a in chosen]
            for a, w in charged:
                load[a] = load.get(a, 0) + w
            if dst_addr:
                # the requester becomes an in-progress location the
                # moment its pull is brokered — later planner calls may
                # relay off it
                loc.inprog[dst_node.idx] = dst_addr
            # failover tail: every sealed holder not already primary, so
            # a dead or aborting relay re-requests from the root set
            addrs = chosen + [a for a in sealed_addrs if a not in chosen]
            return addrs, relays, max_sources, charged

    def _finish_pull_assignment(self, oid: ObjectID, dst_idx: int,
                                charged):
        """A brokered pull ended (either way): release the source slots
        it charged and retire the requester's in-progress location.
        Shares the object's SHARD lock with the planner, so an
        aborted/failed puller can never be handed out as a source after
        its failure is known (directory-staleness-on-abort guarantee)."""
        if not charged:
            return  # non-cooperative plan: nothing was registered
        with self.objects.lock_for(oid):
            loc = self.objects.get(oid)
            if loc is None:
                return
            loc.inprog.pop(dst_idx, None)
            for a, w in charged:
                n = loc.serving.get(a, 0) - w
                if n > 1e-9:  # float residue from fractional stripes
                    loc.serving[a] = n
                else:
                    loc.serving.pop(a, None)

    def _note_fanout_saturated(self, oid: ObjectID, dst_idx: int):
        """Caller holds the lock. Rate-limited: a hot broadcast can hit
        this once per puller."""
        self.broadcast_fanout_saturations += 1
        now = time.monotonic()
        if now - self._last_saturation_event_ts < 5.0:
            return
        self._last_saturation_event_ts = now
        self.emit_event(
            "WARNING", "head", "broadcast_fanout_saturated",
            f"every source for object {oid.hex()[:16]} is at its "
            f"broadcast_fanout bound ({get_config().broadcast_fanout}); "
            "assigning the least-loaded sealed holder anyway",
            extra={"object_id": oid.hex(), "dst_node": dst_idx,
                   "saturations": self.broadcast_fanout_saturations})

    # ---------------------------------- speculative arg prefetch (r13)

    def _maybe_prefetch_args(self, lease_id: str, node_idx: int,
                             arg_ids, inline_ids=()) -> int:
        """Fire prefetch-flagged PULL_OBJECTs at ``node_idx``'s agent
        for every by-ref arg its directory entry is missing (the
        reference PullManager's prefetch role). Called off the head
        lock — from the dispatch pass right after the lease replies go
        out, and from the driver's dispatch-time PREFETCH_HINT — so the
        pulls overlap the lease reply, driver dispatch and worker
        wakeup; the worker's ``_decode_args`` get() then JOINS the
        in-flight pull via the agent puller's ``_pending`` leadership
        instead of starting cold. Remote nodes only: a head-local
        node's consumers share the head host's arenas, where the demand
        path is an in-memory hop. Returns how many pulls were issued.

        ``inline_ids`` (r16): arg ids the DRIVER tagged as
        inline-promoted — tiny owner values materialized into the store
        only so borrowers can fetch them (``_promote_if_needed``).
        Their pulls still fire (the demand path would fetch them
        anyway) but count in ``prefetch_issued_inline`` /
        ``prefetch_wasted_inline``, so the issued/wasted ratio behind
        ``doctor_warnings()``'s waste check measures only REAL
        speculative pulls."""
        cfg = get_config()
        if not cfg.arg_prefetch_enabled or \
                cfg.arg_prefetch_max_inflight <= 0 or not arg_ids:
            return 0
        with self._lock:
            node = self.nodes.get(node_idx)
            # WARM / actor keys are not real leases: no liveness gate
            # (warm entries age out via the sweep; a dead actor's
            # entries do too — teardown never names these keys)
            synthetic = lease_id == _WARM_LEASE or \
                lease_id.startswith("actor:")
            if node is None or not node.alive or node.draining \
                    or node.agent_conn is None \
                    or (not synthetic and lease_id not in self.leases):
                # draining nodes are never prefetch DESTINATIONS (the
                # copies are moving off); they may still SERVE pulls
                return 0
            conn = node.agent_conn
        issued = 0
        inline_set = {bytes(a) for a in inline_ids}
        for ab in dict.fromkeys(bytes(a) for a in arg_ids):
            oid = ObjectID(ab)
            loc = self.objects.get(oid)
            if loc is None or loc.size <= 0 or loc.spilled_path:
                continue  # unknown size / spilled: demand path handles
            if node_idx in loc.holders or loc.node_idx == node_idx:
                continue  # already local: nothing to overlap
            if loc.size > cfg.arg_prefetch_max_bytes:
                # can NEVER fit under the byte cap: queueing it would
                # churn forever (every drain re-queues it); the demand
                # path handles oversized args
                continue
            key = (ab, node_idx)
            with self._prefetch_lock:
                if key in self._prefetches:
                    continue  # in flight or freshly landed: dedupe
                infl = [p for p in self._prefetches.values()
                        if p.node_idx == node_idx
                        and p.state == "inflight"]
                if len(infl) >= cfg.arg_prefetch_max_inflight or \
                        sum(p.size for p in infl) + loc.size > \
                        cfg.arg_prefetch_max_bytes:
                    # over the caps: QUEUE, don't drop — the next
                    # PREFETCH_RESULT activates it (bounded per node)
                    q = self._prefetch_pending.setdefault(
                        node_idx, deque())
                    if len(q) < 256 and \
                            not any(e[1] == ab for e in q):
                        q.append((lease_id, ab, ab in inline_set))
                    continue
                p = _PrefetchState(oid_bin=ab, node_idx=node_idx,
                                   lease_id=lease_id, size=loc.size,
                                   ts=time.monotonic(),
                                   inline=ab in inline_set)
                self._prefetches[key] = p
                self._prefetch_by_lease.setdefault(
                    lease_id, []).append(key)
            # plan OUTSIDE the prefetch lock (shard locks inside): the
            # cooperative planner charges the chosen sources and lists
            # the destination in-progress, so later pullers of the same
            # object may relay off the prefetching node (r9 tree)
            addrs, relays, max_sources, charged = \
                self._plan_pull_sources(oid, loc, node)
            if not addrs:
                with self._prefetch_lock:
                    self._unlink_prefetch_locked(key, p)
                continue
            released = None
            with self._prefetch_lock:
                if self._prefetches.get(key) is not p:
                    # purged while planning (node died between the two
                    # locks): the entry is gone, so nothing will ever
                    # answer for these charges — release them here
                    released = charged
                else:
                    p.charged = charged
            if released:
                self._finish_pull_assignment(oid, node_idx, released)
                continue
            try:
                conn.send(P.PULL_OBJECT, ab, addrs, loc.size,
                          max_sources, list(relays), True)
            except P.ConnectionLost:
                self._prefetch_finished(ab, node_idx, ok=False)
                continue
            with self._prefetch_lock:
                if p.inline:
                    self.prefetch_issued_inline += 1
                else:
                    self.prefetch_issued += 1
                    self.prefetch_bytes_issued += loc.size
            issued += 1
        return issued

    def _h_prefetch_hint(self, conn, rid, lease_id, arg_bins,
                         inline_bins=()):
        """Driver dispatch-time prefetch (PREFETCH_HINT): leases are
        long-lived and serve many tasks, so grant-time args cover only
        the first — the submitter names each pushed batch's by-ref args
        for the lease's node and the same caps/dedupe apply. r14: keys
        of the form ``actor:<hex>`` name an ACTOR's pushed batch (the
        serve-handle hot loop); the head resolves the actor to its
        worker's node here — the driver only knows the actor's socket
        address, not its node. r16: the optional third field names the
        subset of ``arg_bins`` that are inline-promoted objects (their
        pulls are counted apart from real speculation — absent from
        pre-r16 drivers, which is equivalent to empty)."""
        if isinstance(lease_id, str) and lease_id.startswith("actor:"):
            node_idx = self._actor_node_idx(lease_id[len("actor:"):])
            if node_idx is not None:
                self._maybe_prefetch_args(lease_id, node_idx, arg_bins,
                                          inline_ids=inline_bins)
            return
        with self._lock:
            lease = self.leases.get(lease_id)
        if lease is None:
            return  # lease already returned: nothing to speculate for
        self._maybe_prefetch_args(lease_id, lease[0], arg_bins,
                                  inline_ids=inline_bins)

    def _h_prefetch_hint_batch(self, conn, rid, entries):
        """PREFETCH_HINT_BATCH (r15): one frame carrying every hint a
        driver buffered since its last submitter wakeup — a pipeline
        hot loop's per-microbatch activations arrive as one frame per
        tick instead of one per pushed batch. Each (lease_key, ids[,
        inline_ids]) entry takes the exact single-hint path (actor
        resolution, caps, holder checks, dedupe); 2-tuples from r15
        drivers decode with no inline tags."""
        for entry in entries:
            self._h_prefetch_hint(conn, 0, entry[0], entry[1],
                                  entry[2] if len(entry) > 2 else ())

    def _actor_node_idx(self, actor_hex: str) -> Optional[int]:
        """Node currently hosting an actor's worker (None when the
        actor is dead/unknown/not yet placed)."""
        try:
            aid = ActorID(bytes.fromhex(actor_hex))
        except ValueError:
            return None
        with self._lock:
            actor = self.actors.get(aid)
            if actor is None or actor.state != "ALIVE" or \
                    not actor.worker_id:
                return None
            for node in self.nodes.values():
                if actor.worker_id in node.workers:
                    return node.idx
        return None

    def _h_object_warm(self, conn, rid, oid_bin, node_idx):
        """OBJECT_WARM (r14): warm one object onto node(s) BEFORE any
        consumer exists — the serve controller fires this at scale-up
        decision time so deployment weights are landing (or landed)
        when the new replicas' constructors ask. Rides the r13 prefetch
        machinery under the reserved WARM lease: same per-node
        inflight/byte caps and pacing queue, same PREFETCH_RESULT
        charge accounting, same holder dedupe — and because each warm
        pull registers as an in-progress location, N concurrent warms
        of one object form the r9 cooperative broadcast tree
        (root egress ~2xS, not NxS). node_idx -1 = every alive remote
        node not already holding the object. Replies the number of
        pulls issued when sent as a call."""
        ab = bytes(oid_bin)
        with self._lock:
            if node_idx >= 0:
                node = self.nodes.get(node_idx)
                targets = [node_idx] if node is not None and node.alive \
                    and not node.draining else []
            else:
                targets = [n.idx for n in self.nodes.values()
                           if n.alive and not n.draining
                           and n.agent_conn is not None]
        issued = 0
        for idx in targets:
            issued += self._maybe_prefetch_args(_WARM_LEASE, idx, [ab])
        if rid > 0:
            conn.reply(rid, issued)

    def _h_prefetch_result(self, conn, rid, oid_bin, node_idx, ok):
        self._prefetch_finished(bytes(oid_bin), int(node_idx), bool(ok))

    def _prefetch_finished(self, oid_bin: bytes, node_idx: int,
                           ok: bool):
        """A speculative pull ended (agent PREFETCH_RESULT, send
        failure, or TTL sweep): release the planner charges exactly
        once; successful pulls linger as ``done`` so a late demand
        fetch still reads as satisfied-by-prefetch."""
        key = (oid_bin, node_idx)
        with self._prefetch_lock:
            p = self._prefetches.get(key)
            if p is None or p.state == "done":
                return
            charged, p.charged = p.charged, []
            if ok and p.state == "inflight":
                p.state = "done"
                p.ts = time.monotonic()
                if p.inline:
                    # keep the issued/completed/wasted triple coherent
                    # per class: inline pulls never appear in the real
                    # speculation counters (completed > issued would
                    # otherwise be possible)
                    self.prefetch_completed_inline += 1
                else:
                    self.prefetch_completed += 1
            else:
                self._unlink_prefetch_locked(key, p)
        if charged:
            self._finish_pull_assignment(ObjectID(oid_bin), node_idx,
                                         charged)
        # a result frees an inflight slot: activate queued requests
        self._drain_prefetch_pending(node_idx)

    def _drain_prefetch_pending(self, node_idx: int):
        """Activate cap-queued prefetch requests while slots last (the
        reference PullManager's bounded activation loop). Entries
        re-check holders/caps/lease liveness through the normal issue
        path; one still-over-caps entry re-queues and stops the drain
        until the next slot frees. Reentrancy-guarded per node: an
        issue failure inside the drain reports through
        _prefetch_finished, which calls back here."""
        while True:
            with self._prefetch_lock:
                if node_idx in self._prefetch_draining:
                    return
                q = self._prefetch_pending.get(node_idx)
                if not q:
                    return
                lease_id, ab, inline = q.popleft()
                self._prefetch_draining.add(node_idx)
            try:
                issued = self._maybe_prefetch_args(
                    lease_id, node_idx, [ab],
                    inline_ids=(ab,) if inline else ())
            finally:
                with self._prefetch_lock:
                    self._prefetch_draining.discard(node_idx)
            if issued == 0:
                with self._prefetch_lock:
                    requeued = any(
                        e[1] == ab for e in
                        self._prefetch_pending.get(node_idx, ()))
                if requeued:
                    return  # caps still full: wait for the next slot

    def _abort_lease_prefetches(self, lease_id: str):
        """Lease teardown (worker returned/died, driver gone, task
        cancelled or retried elsewhere): abort this lease's unconsumed
        in-flight prefetches through the r9 abort path and count them
        wasted; satisfied entries just drop their records."""
        aborts: List[_PrefetchState] = []
        with self._prefetch_lock:
            for q in self._prefetch_pending.values():
                # cap-queued requests of the dead lease never activate
                stale = [e for e in q if e[0] == lease_id]
                for e in stale:
                    q.remove(e)
            keys = self._prefetch_by_lease.pop(lease_id, None)
            if not keys:
                return
            for key in keys:
                p = self._prefetches.get(key)
                if p is None:
                    continue
                if p.state == "done":
                    self._prefetches.pop(key, None)  # list popped above
                elif p.state == "inflight" and not p.consumed:
                    p.state = "aborted"
                    if p.inline:
                        self.prefetch_wasted_inline += 1
                    else:
                        self.prefetch_wasted += 1
                    aborts.append(p)
                # consumed in-flight entries: a demand fetch is riding
                # the pull — leave it to finish; PREFETCH_RESULT (or
                # the sweep) releases the charges and drops the entry
        for p in aborts:
            with self._lock:
                node = self.nodes.get(p.node_idx)
                conn = node.agent_conn if node is not None else None
            if conn is not None:
                try:
                    conn.send(P.PULL_ABORT, p.oid_bin)
                except P.ConnectionLost:
                    pass

    def _prefetch_inflight_count(self) -> int:
        with self._prefetch_lock:  # stats poll races insert/pop threads
            return sum(1 for p in self._prefetches.values()
                       if p.state == "inflight")

    def _unlink_prefetch_locked(self, key, p: "_PrefetchState"):
        """Drop an entry AND its per-lease record (caller holds
        _prefetch_lock). Every pop must route through here: a
        long-lived lease issues prefetches for the whole stream of
        tasks it serves, and per-lease key lists pruned only at lease
        teardown would grow for the lease's entire lifetime."""
        self._prefetches.pop(key, None)
        keys = self._prefetch_by_lease.get(p.lease_id)
        if keys is not None:
            if key in keys:
                keys.remove(key)
            if not keys:
                del self._prefetch_by_lease[p.lease_id]

    def _purge_node_prefetches(self, node_idx: int):
        """Node death: drop every prefetch targeted at it (charges on
        surviving sources released; no waste counting — this is host
        loss, not task churn)."""
        dead: List[_PrefetchState] = []
        with self._prefetch_lock:
            self._prefetch_pending.pop(node_idx, None)
            for key in [k for k in self._prefetches
                        if k[1] == node_idx]:
                p = self._prefetches[key]
                if p.charged:
                    dead.append(p)
                self._unlink_prefetch_locked(key, p)
        for p in dead:
            self._finish_pull_assignment(ObjectID(p.oid_bin),
                                         p.node_idx, p.charged)

    def _sweep_prefetches(self):
        """Housekeeping: entries whose agent never answered (died, frame
        lost) release their charges after ``_PREFETCH_SWEEP_S``; done
        records drop after ``_PREFETCH_DONE_TTL_S``."""
        now = time.monotonic()
        expired: List[_PrefetchState] = []
        with self._prefetch_lock:
            for key, p in list(self._prefetches.items()):
                if p.state == "done":
                    if now - p.ts > _PREFETCH_DONE_TTL_S:
                        self._unlink_prefetch_locked(key, p)
                elif now - p.ts > _PREFETCH_SWEEP_S:
                    self._unlink_prefetch_locked(key, p)
                    if p.charged:
                        expired.append(p)
            stalled = [idx for idx, q in self._prefetch_pending.items()
                       if q]
        for p in expired:
            self._finish_pull_assignment(ObjectID(p.oid_bin),
                                         p.node_idx, p.charged)
        for idx in stalled:
            # expired entries freed slots without a PREFETCH_RESULT
            # (that's what expired them) — the drain is the only other
            # activation edge, so run it or queued requests strand
            self._drain_prefetch_pending(idx)

    def _p2p_transfer(self, oid: ObjectID, loc: _ObjLoc,
                      dst_node: NodeState) -> bool:
        """Direct host-to-host pull, sources chosen by the broadcast-
        aware planner; returns False to fall back to relay."""
        with self._prefetch_lock:
            p = self._prefetches.get((oid.binary(), dst_node.idx))
            if p is not None and not p.consumed and \
                    p.state in ("inflight", "done"):
                # the demand fetch arrived while (or just after) the
                # speculative pull ran: the agent-side puller joins the
                # in-flight pull via _pending leadership, or finds the
                # landed copy — either way the arg fetch started warm
                p.consumed = True
                if p.state == "inflight":
                    self.prefetch_joined += 1
        addrs, relays, max_sources, charged = \
            self._plan_pull_sources(oid, loc, dst_node)
        if not addrs:
            return False
        try:
            if dst_node.is_remote:
                # dst agent pulls straight from the holder hosts
                reply = dst_node.agent_conn.call(
                    P.PULL_OBJECT, oid.binary(), addrs, loc.size,
                    max_sources, list(relays), timeout=120)
                ok = bool(reply[0])
            else:
                # dst is a head-local node: the head IS the destination
                # host — pull straight into the local arena.
                ok = bool(self._puller_for(dst_node).pull(
                    oid, addrs, size_hint=loc.size,
                    max_sources=max_sources, relay_addrs=relays))
            if ok:
                self._directory_add(oid, dst_node.idx)
            return ok
        except P.ConnectionLost:
            return False  # dst/agent died: let the relay path try
        except TimeoutError:
            # the agent may STILL be pulling: falling back to the relay
            # path would both funnel the payload through head memory and
            # collide with the in-flight pull's unsealed arena entry.
            # Surface the timeout instead — if the pull lands later the
            # agent's OBJ_LOCATION_ADD records the holder and the
            # requester's retry finds it. (The finally below releases
            # this pull's source charges early in that case; accounting
            # errs toward optimism for the straggler's tail.)
            raise
        finally:
            # after _directory_add: a finishing puller is continuously
            # visible (holder by the time its in-progress entry retires)
            self._finish_pull_assignment(oid, dst_node.idx, charged)

    def _h_object_transfer(self, conn, rid, oid_bin, to_node_idx):
        """Copy an object from its node's arena (or spill file) into
        `to_node_idx`'s arena — the reference's ObjectManager chunked pull
        (object_manager.cc). Within one host this is a memcpy between shm
        arenas; across hosts the payload rides the head<->agent TCP links.

        Remote transfers block on agent RPCs, and agent replies are
        delivered by this same head IO thread — so any transfer touching a
        remote node runs on a side thread (otherwise: deadlock)."""
        oid = ObjectID(oid_bin)
        with self.objects.lock_for(oid):
            loc = self.objects.get(oid)
            any_remote_holder = loc is not None and any(
                self.nodes[h].is_remote for h in loc.holders
                if h in self.nodes)
        if loc is None:
            conn.reply_error(rid, KeyError(f"object {oid.hex()} unknown"))
            return
        dst_node = self.nodes[to_node_idx]
        if dst_node.is_remote or any_remote_holder:
            threading.Thread(
                target=self._do_object_transfer,
                args=(conn, rid, oid, loc, dst_node), daemon=True).start()
            return
        self._do_object_transfer(conn, rid, oid, loc, dst_node)

    def _do_object_transfer(self, conn, rid, oid, loc, dst_node):
        try:
            if self._node_store_contains(dst_node, oid):
                conn.reply(rid, True)
                return
            with self.objects.lock_for(oid):
                any_remote_holder = any(
                    self.nodes[h].is_remote for h in loc.holders
                    if h in self.nodes)
            if not loc.spilled_path and (dst_node.is_remote
                                         or any_remote_holder):
                # Peer-to-peer path: the head only brokers the pull — the
                # payload rides direct host<->host connections, striped
                # across the directory's holder set (reference:
                # ObjectManager chunked pull, never through the GCS).
                if self._p2p_transfer(oid, loc, dst_node):
                    conn.reply(rid, True)
                    return
                # fall through to the relay path on any P2P failure
            if loc.spilled_path:
                with open(loc.spilled_path, "rb") as f:
                    data = f.read()
                # spill file layout: [8B meta_len][meta][payload]
                meta_len = int.from_bytes(data[:8], "little")
                meta = data[8:8 + meta_len]
                payload = data[8 + meta_len:]
            else:
                # relay read from any live holder (primary first)
                with self.objects.lock_for(oid):
                    cand = self._holder_nodes(loc)
                got = None
                for node in cand:
                    # a holder entry can be stale (eviction report lost):
                    # keep trying the remaining holders before giving up
                    got = self._node_store_read(node, oid)
                    if got is not None:
                        break
                if got is None:
                    conn.reply_error(
                        rid, KeyError(f"object {oid.hex()} gone"))
                    return
                payload, meta = got
            self._node_store_write(dst_node, oid, payload, meta)
            self._directory_add(oid, dst_node.idx)
            conn.reply(rid, True)
        except P.ConnectionLost:
            pass
        except Exception as e:  # noqa: BLE001 — surface to the requester
            try:
                conn.reply_error(rid, e)
            except P.ConnectionLost:
                pass

    # --------------------------------------------------------- spilling

    def _maybe_spill(self, node_idx: int):
        """Spill cold sealed objects to disk when the arena crosses the
        threshold (reference: LocalObjectManager::SpillObjects,
        local_object_manager.h:110; FileSystemStorage external_storage.py)."""
        cfg = get_config()
        node = self.nodes.get(node_idx)
        if node is None or node.store is None:
            return  # remote nodes spill locally (agent-side), not via head
        store = node.store
        if store.bytes_in_use() < cfg.object_spilling_threshold * \
                store.capacity():
            return
        spill_dir = cfg.spill_dir or os.path.join(self.session_dir, "spill")
        os.makedirs(spill_dir, exist_ok=True)
        candidates = [
            (oid, loc) for oid, loc in self.objects.items_snapshot()
            if loc.node_idx == node_idx and not loc.spilled_path
        ]
        target = store.capacity() * (cfg.object_spilling_threshold - 0.2)
        spilled_n, spilled_bytes = 0, 0
        for oid, loc in candidates:
            if store.bytes_in_use() <= target:
                break
            got = store.get(oid)
            if got is None:
                continue
            data_v, meta_v = got
            path = os.path.join(spill_dir, oid.hex())
            try:
                with open(path, "wb") as f:
                    f.write(len(meta_v).to_bytes(8, "little"))
                    f.write(meta_v)
                    f.write(data_v)
            finally:
                del data_v, meta_v, got
                store.release(oid)
            with self.objects.lock_for(oid):
                loc.spilled_path = path
                loc.holders.discard(node_idx)
                # another node may still hold a live replica; only fall
                # back to the spill file when no arena copy remains
                loc.node_idx = min(loc.holders) if loc.holders else -1
            store.delete(oid)
            spilled_n += 1
            spilled_bytes += loc.size
        if spilled_n:
            self.emit_event(
                "WARNING", "head", "object_spill",
                f"spilled {spilled_n} objects "
                f"({spilled_bytes} bytes) from node {node_idx} arena",
                node_idx=node_idx,
                extra={"objects": spilled_n, "bytes": spilled_bytes})

    # ------------------------------------------------------------ cluster info

    def _h_metrics_report(self, conn, rid, batch):
        """Merge per-process metric deltas into the cluster aggregate
        (reference: opencensus exporter -> dashboard agent; stats/
        metric.h:103). Counters/histograms arrive as deltas and sum;
        gauges overwrite. Runs under the dedicated metrics lock — merge
        work never convoys a lease grant on the head lock."""
        with self._metrics_lock:
            for kind, name, desc, meta, tags_key, value in batch:
                # reporter telemetry rows are identified by name prefix
                # AND the reserved ("node",) tag-key shape, so user
                # metrics that merely start with "node." are untouched.
                # The arena memory-observatory gauges ride the same
                # heartbeat with the same tag shape — they mirror into
                # node rows too (and flow through the metric table into
                # Prometheus + the flight recorder like any gauge).
                is_node_telemetry = (
                    kind == "gauge" and tuple(meta) == ("node",)
                    and (name.startswith("node.")
                         or name.startswith("object_plane.arena_")))
                if is_node_telemetry:
                    # drop in-flight reports from nodes already removed
                    # — merging them would resurrect a dead host's
                    # gauges post-prune
                    try:
                        if int(tags_key[0]) not in self.nodes:
                            continue
                    except ValueError:
                        pass
                key = (name, tags_key)
                row = self.metrics.get(key)
                if row is None:
                    if kind == "histogram":
                        tag_keys, boundaries = meta
                    else:
                        tag_keys, boundaries = meta, None
                    row = self.metrics[key] = {
                        "name": name, "kind": kind, "description": desc,
                        "tags": dict(zip(tag_keys, tags_key)),
                        "boundaries": boundaries,
                        "value": list(value) if kind == "histogram"
                        else 0.0,
                    }
                    if kind == "histogram":
                        continue
                if kind == "gauge":
                    row["value"] = value
                    # mirror reporter gauges into the per-node telemetry
                    # view list_nodes() rows expose
                    if is_node_telemetry:
                        try:
                            nidx = int(tags_key[0])
                        except ValueError:
                            pass
                        else:
                            self.node_telemetry.setdefault(
                                nidx, {})[name] = value
                elif kind == "counter":
                    row["value"] += value
                else:  # histogram delta: element-wise sum
                    row["value"] = [a + b for a, b in
                                    zip(row["value"], value)]

    def _h_task_events(self, conn, rid, batch, dropped):
        """Workers' task-state transitions land in a bounded ring buffer
        (reference: GcsTaskManager; src/ray/gcs/gcs_server/gcs_task_manager.h).
        A request_id means the sender wants a flush-ack: the reply is
        issued only after ingestion, so a subsequent STATE_QUERY
        observes this batch (tracing.timeline's ordering barrier).
        Every event is ALSO folded into the bounded per-task timeline
        table (state_ts / phase histograms / straggler bookkeeping).

        r11: wire batches are handed to the FOLD THREAD through a
        bounded queue — the fold (dict churn + histogram observes,
        measured ~15 ms per flush batch at burst) no longer runs on the
        IO loop, and the flush-ack is issued by the fold thread AFTER
        ingestion so the ordering barrier holds. Direct calls
        (conn is None — unit tests) and unstarted heads fold inline.
        A full queue sheds the batch with drop accounting: observability
        never backpressures the control plane."""
        ft = self._fold_thread
        if conn is None or ft is None or not ft.is_alive():
            self._ingest_task_events(batch, dropped)
            if rid > 0 and conn is not None:
                conn.reply(rid, True)
            return
        if len(self._fold_q) >= get_config().task_event_fold_queue_max:
            with self._timeline_lock:
                self.task_events_dropped += len(batch) + dropped
            self.fold_queue_drops += 1
            if rid > 0:
                conn.reply(rid, True)  # ack: the batch was consumed (shed)
            return
        self._fold_q.append((batch, dropped, conn, rid))
        self._fold_event.set()

    def _fold_loop(self):
        """Dedicated fold thread: drains TASK_EVENTS batches in arrival
        order, folds them under the timeline lock, then acks sync
        flushes."""
        q = self._fold_q
        while not self._shutdown:
            self._fold_event.wait(0.5)
            self._fold_event.clear()
            while q:
                try:
                    batch, dropped, conn, rid = q.popleft()
                except IndexError:
                    break
                try:
                    self._ingest_task_events(batch, dropped)
                finally:
                    if rid > 0 and conn is not None:
                        try:
                            conn.reply(rid, True)
                        except P.ConnectionLost:
                            pass

    def _ingest_task_events(self, batch, dropped):
        with self._timeline_lock:
            # count HEAD-ring evictions too (the deque drops oldest
            # silently) — the satellite drop counters must cover both
            # the worker buffers and this ring
            overflow = max(0, len(self.task_events) + len(batch)
                           - self.task_events.maxlen)
            self.task_events.extend(batch)
            self.task_events_seq += len(batch)
            self.task_events_dropped += dropped + overflow
            for ev in batch:
                self._fold_task_event(ev)

    # --------------------------------------- task timelines / stragglers

    def _fold_task_event(self, ev):
        """Fold one task-state event into its timeline row (caller holds
        the TIMELINE lock). Tolerates the pre-r10 10-field tuple shape
        (no monotonic stamp: state_ts still fills, phases stay
        unknown)."""
        tid, name, state, wid, nidx, ts = ev[:6]
        rank = E.STATE_RANK.get(state)
        if rank is None:
            return  # span records ride the raw ring only
        err = ev[6] if len(ev) > 6 else ""
        trace_id = ev[7] if len(ev) > 7 else ""
        mono = ev[10] if len(ev) > 10 else None
        # fold the recorder's monotonic stamp into the HEAD timebase
        folded_mono = None if mono is None else \
            mono - self.node_clock_offsets.get(nidx, 0.0)
        row = self.task_timelines.get(tid)
        if row is None:
            cap = get_config().task_timeline_max_entries
            if cap <= 0:
                return  # folding disabled (raw ring still serves)
            while len(self.task_timelines) >= cap:
                self.task_timelines.popitem(last=False)
            row = self.task_timelines[tid] = _TaskTimeline(task_id=tid)
        self.task_timelines.move_to_end(tid)  # newest-activity-first view
        if name:
            row.name = name
        row.ts = max(row.ts, ts)
        # display state ends at the terminal execution states — RETURNED
        # is a phase endpoint, not a TaskStatus (reference parity).
        # Compared against the DISPLAYED state's rank, not row.rank: a
        # RETURNED that outruns its FINISHED (driver flushed first) must
        # not wedge the display at RUNNING. A FINISHED arriving after
        # FAILED/CANCELLED (equal rank) DOES win: a retry that succeeded
        # supersedes the failed attempt, and its stale error clears.
        disp_rank = E.STATE_RANK.get(row.state, -1)
        term_mono = row.state_mono.get(row.state)
        if state == E.RUNNING and row.state in (E.FAILED, E.CANCELLED) \
                and folded_mono is not None \
                and (term_mono is None or folded_mono > term_mono):
            # a RETRY started after a terminal attempt: re-open the
            # timeline from this attempt's RUNNING (fresh stamps, error
            # cleared, terminal/RETURNED stamps dropped so the retry's
            # own completion re-terminates the row and the straggler
            # detector can watch it — including re-flagging, so the
            # first attempt's flag is reset too). Guarded by the
            # monotonic comparison: a STALE first-attempt RUNNING whose
            # flush was outrun by the owner's terminal stamp (events
            # ride different connections) predates it in the folded
            # timebase and must NOT destroy the terminal state — the
            # fold stays commutative. Phases already observed into the
            # histograms stay observed — each task contributes each
            # phase at most once (first attempt wins), which keeps the
            # exec distribution honest without per-attempt tracking.
            row.state = E.RUNNING
            row.error = ""
            row.straggler = False
            row.straggler_ms = 0.0
            row.state_ts[E.RUNNING] = ts
            row.state_mono.pop(E.RUNNING, None)
            for st in (E.FINISHED, E.FAILED, E.CANCELLED, E.RETURNED):
                row.state_ts.pop(st, None)
                row.state_mono.pop(st, None)
        elif state != E.RETURNED and (
                rank > disp_rank
                or (state == E.FINISHED
                    and row.state in (E.FAILED, E.CANCELLED))):
            row.state = state
            if state == E.FINISHED:
                row.error = ""
        if state in (E.FETCHING_ARGS, E.RUNNING, E.FINISHED):
            # the executing worker's identity wins over the submitter's
            row.worker_id, row.node_idx = wid, nidx
        elif state in (E.FAILED, E.CANCELLED) and \
                E.FETCHING_ARGS not in row.state_ts and \
                E.RUNNING not in row.state_ts:
            # owner-side terminal stamps (worker crash, dep failure)
            # must not clobber the identity of the worker that actually
            # ran the task; they only fill it for never-dispatched tasks
            row.worker_id, row.node_idx = wid, nidx
        elif not row.worker_id:
            row.worker_id, row.node_idx = wid, nidx
        if err and row.state != E.FINISHED:
            row.error = err
        if trace_id and not row.trace_id:
            row.trace_id = trace_id
        row.state_ts.setdefault(state, ts)
        if folded_mono is not None and state not in row.state_mono:
            row.state_mono[state] = folded_mono
            self._observe_new_phases(row, state)

    def _observe_new_phases(self, row: _TaskTimeline, new_state: str):
        """Histogram each phase exactly once, the moment both endpoints
        are known (caller holds the timeline lock). Incremental: only
        phases that have ``new_state`` as an endpoint can have newly
        completed — re-deriving ALL six phases per folded event was a
        measurable slice of the fold's hot loop."""
        monos = row.state_mono
        for ph, starts, ends in E.PHASES_TOUCHING.get(new_state, ()):
            if ph in row.observed:
                continue
            a = E._first_stamp(monos, starts)
            b = E._first_stamp(monos, ends)
            if a is None or b is None:
                continue
            ms = max(0.0, (b - a) * 1000.0)
            if ph == "exec" and E.FINISHED not in monos:
                # a FAILED/CANCELLED attempt's exec time must not seed
                # the COMPLETED-exec baseline the straggler detector
                # compares against (5 fast transient failures would arm
                # a ~ms bound that flags every legitimate run). Not
                # marked observed: if a retry re-opens and FINISHES,
                # its exec observes then.
                continue
            row.observed.add(ph)
            self._observe_phase_hist(
                "task.phase_ms",
                "Per-phase task lifecycle latency by function "
                "(sched_wait/dispatch/arg_fetch/exec/result_return/e2e)",
                {"func": row.name, "phase": ph}, ms)
            if ph in ("dispatch", "arg_fetch") and row.node_idx >= 0:
                # the phases that END on the executing node — the
                # slow-node skew detector compares these across nodes
                self._observe_phase_hist(
                    "task.node_phase_ms",
                    "Per-phase task lifecycle latency by executing node",
                    {"node": str(row.node_idx), "phase": ph}, ms)

    def _observe_phase_hist(self, name: str, desc: str, tags: Dict[str, str],
                            value_ms: float):
        """Head-side histogram observation straight into the merged
        metric table (same row schema as _h_metrics_report ingests), so
        the phase histograms ride metrics_summary() / the Prometheus
        exposition (`task_phase_ms_bucket{func=...,phase=...}`) with no
        extra plumbing. Takes the metrics lock itself (callers hold the
        timeline lock — the fixed ordering)."""
        key = (name, tuple(tags.values()))
        with self._metrics_lock:
            row = self.metrics.get(key)
            if row is None:
                row = self.metrics[key] = {
                    "name": name, "kind": "histogram",
                    "description": desc,
                    "tags": dict(tags),
                    "boundaries": list(TASK_PHASE_MS_BOUNDARIES),
                    "value": [0.0] * (len(TASK_PHASE_MS_BOUNDARIES) + 3),
                }
            v = row["value"]
            for i, b in enumerate(TASK_PHASE_MS_BOUNDARIES):
                if value_ms <= b:
                    v[i] += 1
                    break
            else:
                v[len(TASK_PHASE_MS_BOUNDARIES)] += 1
            v[-2] += value_ms
            v[-1] += 1

    def _task_phase_summary(self, funcs=None,
                            include_raw=False) -> Dict[str, dict]:
        """{func: {phase: {count, mean_ms, p50_ms, p95_ms, p99_ms}}}
        from the folded phase histograms (takes the metrics lock).
        ``funcs`` restricts the scan to those func names — the serve
        controller's 1/s SLO-burn poll asks for exactly its replica
        methods, so the reply stays a few rows no matter how many other
        funcs the cluster has run (the summary never rides the per-
        request hot path; it feeds scale decisions). ``include_raw``
        (the phase_summary state query only) adds the raw cumulative
        vectors — the dashboard/CLI task summary reuses this method and
        must not ship ~35-element arrays per row it never reads."""
        out: Dict[str, dict] = {}
        with self._metrics_lock:
            rows = list(self.metrics.items())
        for key, row in rows:
            if key[0] != "task.phase_ms":
                continue
            if funcs is not None and row["tags"]["func"] not in funcs:
                continue
            v, b = row["value"], row["boundaries"]
            n = v[-1]
            if n <= 0:
                continue
            entry = {
                "count": n,
                "mean_ms": v[-2] / n,
                "p50_ms": _hist_quantile(b, v, 0.50),
                "p95_ms": _hist_quantile(b, v, 0.95),
                "p99_ms": _hist_quantile(b, v, 0.99),
            }
            if include_raw:
                # raw cumulative vector ([buckets..., overflow, sum_ms,
                # count]) so pollers can delta successive snapshots
                # into a WINDOWED quantile (the lifetime percentiles
                # above stop moving once history dwarfs the recent
                # past)
                entry["buckets"] = list(v)
                entry["boundaries"] = list(b)
            out.setdefault(row["tags"]["func"], {})[
                row["tags"]["phase"]] = entry
        return out

    def detect_stragglers(self):
        """One detector sweep (the detector thread's body; callable
        directly from tests). A RUNNING task whose current exec time
        exceeds ``straggler_factor`` x its func's completed-exec p95
        (min-sample-gated) is flagged once and emits ONE rate-limited
        ``task_straggler`` cluster event naming task, node and worker;
        per-node dispatch/arg_fetch p95 skew vs the cluster median emits
        ``slow_node`` (>= 30s apart per node+phase)."""
        from . import events as E

        if self._grace_active():
            # a restarted head's timelines/histograms are rebuilding —
            # flagging against half-folded distributions would alarm on
            # every re-registered task
            return
        cfg = get_config()
        now = time.monotonic()
        flagged: List[tuple] = []
        with self._timeline_lock, self._metrics_lock:
            for row in self.task_timelines.values():
                if len(flagged) >= 10:
                    # cap the event volume per sweep; the rest stay
                    # UN-flagged and get their one event on a later
                    # sweep (a mass stall's node-level signal is the
                    # slow_node / node_dead path anyway)
                    break
                if row.straggler or row.state != E.RUNNING:
                    continue
                start = row.state_mono.get(E.RUNNING)
                if start is None:
                    continue
                hist = self.metrics.get(("task.phase_ms",
                                         (row.name, "exec")))
                if hist is None or \
                        hist["value"][-1] < cfg.straggler_min_samples:
                    continue
                v, nb = hist["value"], len(TASK_PHASE_MS_BOUNDARIES)
                if sum(v[:nb]) < 0.95 * v[-1]:
                    # the p95 falls in the +Inf bucket: the upper tail
                    # is unknown (quantile would clamp to the last
                    # finite bound and falsely flag EVERY run of a
                    # func whose normal exec exceeds it) — no robust
                    # bound exists, so don't flag
                    continue
                p95 = _hist_quantile(hist["boundaries"], hist["value"],
                                     0.95)
                bound_ms = max(p95, 1.0) * cfg.straggler_factor
                running_ms = (now - start) * 1000.0
                if running_ms > bound_ms:
                    row.straggler = True
                    row.straggler_ms = running_ms
                    self.stragglers_flagged += 1
                    flagged.append((row.task_id, row.name, row.worker_id,
                                    row.node_idx, running_ms, p95))
            slow_nodes = self._detect_slow_nodes(now)
        # rate limit: the per-task flag means one event per straggler
        # ever, and the sweep loop above caps flags per sweep
        for tid, func, wid, nidx, running_ms, p95 in flagged:
            self.emit_event(
                "WARNING", "head", "task_straggler",
                f"task {tid[:16]} ({func}) running {running_ms:.0f}ms on "
                f"node {nidx}, over {get_config().straggler_factor:g}x "
                f"its p95 exec ({p95:.0f}ms)",
                node_idx=nidx, entity_id=tid,
                extra={"task_id": tid, "func": func, "worker_id": wid,
                       "node_idx": nidx, "running_ms": running_ms,
                       "exec_p95_ms": p95})
        for nidx, phase, p95, med in slow_nodes:
            self.emit_event(
                "WARNING", "head", "slow_node",
                f"node {nidx} {phase} p95 {p95:.0f}ms vs cluster median "
                f"{med:.0f}ms — host-level skew (slow NIC/disk/CPU?)",
                node_idx=nidx,
                extra={"node_idx": nidx, "phase": phase, "p95_ms": p95,
                       "cluster_median_ms": med})

    def _detect_slow_nodes(self, now: float) -> List[tuple]:
        """Per-node phase-skew check (caller holds the lock): a node
        whose dispatch/arg_fetch p95 is ``straggler_factor`` x the
        cluster median (and at least 5ms over it — sub-ms noise never
        alarms) is flagged, rate-limited per (node, phase)."""
        cfg = get_config()
        out: List[tuple] = []
        for phase in ("dispatch", "arg_fetch"):
            p95s: Dict[int, float] = {}
            for key, row in self.metrics.items():
                if key[0] != "task.node_phase_ms" or \
                        row["tags"].get("phase") != phase:
                    continue
                try:
                    nidx = int(row["tags"]["node"])
                except ValueError:
                    continue
                # judge the delta since the last sweep, not the lifetime
                # vector (see _node_phase_prev) — and advance the
                # baseline for EVERY row so every node's window covers
                # the same span regardless of gating below
                cur = row["value"]
                prev = self._node_phase_prev.get((nidx, phase))
                self._node_phase_prev[(nidx, phase)] = list(cur)
                delta = cur if prev is None or len(prev) != len(cur) \
                    else [cur[i] - prev[i] for i in range(len(cur))]
                if delta[-1] < cfg.straggler_min_samples:
                    continue  # too few RECENT samples to judge
                node = self.nodes.get(nidx)
                if node is None or not node.alive:
                    continue  # stale histogram of a removed node
                p95s[nidx] = _hist_quantile(row["boundaries"],
                                            delta, 0.95)
            if len(p95s) < 2:
                continue
            med = statistics.median(p95s.values())
            for nidx, p95 in p95s.items():
                if p95 > med * cfg.straggler_factor and p95 >= med + 5.0:
                    # routing flag refreshes on EVERY detection (the
                    # event below is rate-limited; the flag must not
                    # lapse between throttled events while the skew
                    # persists)
                    if cfg.slow_node_route_ttl_s > 0:
                        self._slow_node_until[nidx] = \
                            now + cfg.slow_node_route_ttl_s
                    last = self._last_slow_node_event.get((nidx, phase),
                                                          -1e18)
                    if now - last < 30.0:
                        continue
                    self._last_slow_node_event[(nidx, phase)] = now
                    self.slow_nodes_flagged += 1
                    out.append((nidx, phase, p95, med))
        return out

    def _straggler_loop(self):
        period = get_config().straggler_detect_period_s
        while not self._shutdown:
            time.sleep(period)
            try:
                self.detect_stragglers()
            except Exception:
                if not self._shutdown:
                    import traceback

                    traceback.print_exc()

    # --------------------------------------------------- cluster events

    def emit_event(self, severity: str, source: str, event_type: str,
                   message: str, node_idx: int = -1, entity_id: str = "",
                   extra: Optional[dict] = None):
        """Head-side cluster event emitter (reference: the GCS writing
        its own node/actor/job transitions into the event log). Safe
        from any locked head path — the event ring has its own leaf
        lock, so emitting never extends a head/shard-lock hold."""
        ev = E.make_cluster_event(severity, source, event_type, message,
                                  node_idx=node_idx, entity_id=entity_id,
                                  extra=extra)
        with self._cev_lock:
            self._append_cluster_event(ev)

    def _append_cluster_event(self, ev: tuple):
        """Ring append with drop accounting (caller holds _cev_lock) —
        the ONE place the overflow counter is maintained, shared by the
        head's own emitters and CLUSTER_EVENT pushes."""
        if len(self.cluster_events) == self.cluster_events.maxlen:
            self.cluster_events_dropped += 1
        self.cluster_events.append(ev)

    def _h_cluster_events(self, conn, rid, batch, dropped=0):
        """CLUSTER_EVENT pushes from node agents / workers / the job
        manager merge into the same ring the head's own emitters use."""
        with self._cev_lock:
            for ev in batch:
                self._append_cluster_event(tuple(ev))
            self.cluster_events_dropped += dropped
        if rid > 0:
            conn.reply(rid, True)

    def _h_state_query(self, conn, rid, kind, limit):
        """Observability state API (reference: python/ray/util/state/api.py
        backed by the GCS aggregator endpoints). Each kind takes ONLY
        the lock that owns its table (head lock for node/actor/PG
        tables, timeline/metrics/event-ring locks for observability
        state, per-shard snapshots for the object directory) — a
        dashboard poll can no longer stall lease granting."""
        if isinstance(kind, str) and kind.startswith("phase_summary"):
            # "phase_summary" or "phase_summary:func1,func2" — the
            # func-scoped per-phase percentile query the serve
            # controller polls for SLO-burn autoscaling (r14)
            _, _, spec = kind.partition(":")
            funcs = frozenset(f for f in spec.split(",") if f) or None
            conn.reply(rid, [self._task_phase_summary(
                funcs, include_raw=True)])
            return
        if isinstance(kind, str) and kind.startswith("metrics_history"):
            # "metrics_history" or "metrics_history:<window_s>:<names>"
            # — flight-recorder readback (r19). window_s empty/0 means
            # the full fine window; names are comma-separated exact
            # keys, prefixes, or fnmatch globs ("collective.*").
            _, _, spec = kind.partition(":")
            win_s, _, names_s = spec.partition(":")
            names = [n for n in names_s.split(",") if n] or None
            window = float(win_s) if win_s else None
            conn.reply(rid, [self.recorder.history(names, window)])
            return
        if isinstance(kind, str) and kind.startswith("task_events_page"):
            # "task_events_page:<cursor>" — chunked raw-event readback
            # (r19). Replaces timeline()'s single
            # STATE_QUERY("task_events", 1_000_000) pull: each page is
            # at most `limit` rows, so a long job's export can never
            # build one huge reply frame on the head's IO path. The
            # cursor is an absolute ingest sequence number; a cursor
            # that has already been evicted from the ring fast-forwards
            # to the oldest retained event (the ring's drop accounting
            # covers the gap).
            _, _, spec = kind.partition(":")
            cursor = int(spec) if spec else 0
            with self._timeline_lock:
                seq = self.task_events_seq
                ring = self.task_events
                oldest = seq - len(ring)
                start = max(cursor, oldest)
                page = list(itertools.islice(
                    ring, start - oldest, start - oldest + max(limit, 1)))
            nxt = start + len(page)
            conn.reply(rid, [{
                "rows": [self._fmt_task_event(ev) for ev in page],
                "next": nxt,
                "done": nxt >= seq,
            }])
            return
        fn = self._STATE_KINDS.get(kind)
        if fn is None:
            conn.reply_error(rid, ValueError(f"unknown kind {kind!r}"))
            return
        rows = fn(self, limit)
        conn.reply(rid, rows[:limit])

    def _sq_nodes(self, limit):
        now = time.monotonic()
        with self._metrics_lock:
            telemetry = {i: dict(t) for i, t in self.node_telemetry.items()}
            slow = {i for i, until in self._slow_node_until.items()
                    if until > now}
        with self._lock:
            return [{
                "node_idx": n.idx, "alive": n.alive,
                "is_remote": n.is_remote, "node_ip": n.node_ip,
                # graceful drain (r16): draining nodes take no new
                # leases/placements/prefetches while their work moves
                # off; drain_age_s > drain_deadline_s means the
                # escalation wedged (doctor_warnings flags it)
                "draining": n.draining,
                "drain_age_s": round(now - n.drain_started, 1)
                if n.draining else 0.0,
                # live slow_node detector flag (r14): the node's
                # dispatch/arg_fetch p95 skewed off the cluster median
                # within the last slow_node_route_ttl_s — serve routers
                # steer traffic away while it is set
                "slow": n.idx in slow,
                "resources_total": n.resources.total.to_dict(),
                "resources_available": n.resources.available.to_dict(),
                # last reporter-agent sample for this node (node.*
                # gauges; empty until the first telemetry period)
                "telemetry": telemetry.get(n.idx, {}),
                # RTT-midpoint (agent_mono - head_mono) estimate used
                # to fold this node's event stamps (0 for local
                # nodes: CLOCK_MONOTONIC is host-wide)
                "clock_offset_s": n.clock_offset_s,
                "clock_rtt_s": n.clock_rtt_s,
            } for n in self.nodes.values()]

    def _sq_workers(self, limit):
        with self._lock:
            return [{
                "worker_id": w.worker_id, "node_idx": n.idx,
                "pid": w.pid, "state": w.state,
                "actor_id": w.actor_id.hex() if w.actor_id else None,
            } for n in self.nodes.values()
                for w in n.workers.values()]

    def _sq_actors(self, limit):
        with self._lock:
            return [{
                "actor_id": a.actor_id.hex(), "state": a.state,
                "name": a.name, "class_name": a.spec.class_name,
                "worker_id": a.worker_id, "restarts": a.restarts_used,
                "death_cause": a.death_cause,
            } for a in self.actors.values()]

    def _sq_placement_groups(self, limit):
        with self._lock:
            return [{
                "pg_id": pid.hex(), "state": info.state,
                "strategy": info.spec.strategy,
                "bundles": [b.resources for b in info.spec.bundles],
                "placement": list(info.placement),
            } for pid, info in self.pgs.items()]

    def _sq_objects(self, limit):
        # holder sets copied under the shard locks (a live set can
        # mutate mid-iteration once the snapshot lock is released)
        return self.objects.listing_rows()

    def _sq_object_plane(self, limit):
        # object data-plane snapshot: directory shape + locality
        # placement counters (pull-side counters arrive via the
        # normal METRICS_REPORT path and land under "metrics")
        live = [loc for loc in self.objects.values_snapshot()
                if loc.node_idx >= 0 or loc.spilled_path]
        return [{
            "directory_objects": len(live),
            "directory_bytes": sum(l.size for l in live),
            "replicated_objects": sum(
                1 for l in live if len(l.holders) > 1),
            "holder_entries": sum(len(l.holders) for l in live),
            "locality_hits": self.locality_hits,
            "locality_misses": self.locality_misses,
            "relay_bytes": self.relay_bytes,
            # cooperative-broadcast planner state: live
            # in-progress locations + cumulative source-role
            # assignment / saturation counters (the per-serve
            # root-vs-relay counters ride the metrics channel
            # as object_plane.serves{role=...})
            "inprog_locations": sum(
                len(l.inprog) for l in live),
            "broadcast_root_assignments":
                self.broadcast_root_assignments,
            "broadcast_relay_assignments":
                self.broadcast_relay_assignments,
            "broadcast_fanout_saturations":
                self.broadcast_fanout_saturations,
            # speculative arg prefetch (r13): issued = speculative
            # pulls fired at lease grant / dispatch hint; joined =
            # demand fetches that overlapped one in flight; wasted =
            # aborted as stale speculation (task cancelled / retried
            # elsewhere before any worker asked) — doctor_warnings()
            # flags a high wasted:issued ratio
            "prefetch_issued": self.prefetch_issued,
            "prefetch_joined": self.prefetch_joined,
            "prefetch_completed": self.prefetch_completed,
            "prefetch_wasted": self.prefetch_wasted,
            "prefetch_bytes_issued": self.prefetch_bytes_issued,
            "prefetch_inflight": self._prefetch_inflight_count(),
            # r16: pulls of driver-tagged inline-promoted objects —
            # real transfers, but not the speculation the waste-ratio
            # doctor check judges (issued/completed/wasted above
            # exclude them)
            "prefetch_issued_inline": self.prefetch_issued_inline,
            "prefetch_completed_inline": self.prefetch_completed_inline,
            "prefetch_wasted_inline": self.prefetch_wasted_inline,
            # r18 host-plane collectives: the cluster-merged
            # collective.* metric rows summarized (ops / bytes by
            # algorithm + hop p95) — the ring's payload bytes move
            # store-to-store, so they show up HERE and in the agents'
            # serve counters, never in relay_bytes or the head
            # server's bytes_served
            "collective": self._collective_summary_locked(),
            # the head host's own transfer server, split by
            # source role (root = sealed copy, relay = re-served
            # in-progress partial); agent-side servers report
            # the same split via object_plane.serves metrics
            "head_server": ({
                "pull_requests":
                    self._transfer_server.pull_requests,
                "served_root": self._transfer_server.served_root,
                "served_relay":
                    self._transfer_server.served_relay,
                "bytes_served":
                    self._transfer_server.bytes_served,
                "relay_bytes_served":
                    self._transfer_server.relay_bytes_served,
            } if self._transfer_server is not None else {}),
        }]

    def _collective_summary_locked(self):
        """Aggregate the merged ``collective.*`` metric rows into the
        object_plane snapshot (r18): per-algorithm tag slices sum into
        ops / bytes_sent / bytes_recv totals plus a per-algorithm
        breakdown, and the merged hop histogram yields hop_p95_s.
        Takes the metrics lock itself (called from _sq_object_plane,
        which holds no locks)."""
        out = {"ops": 0.0, "bytes_sent": 0.0, "bytes_recv": 0.0,
               "hop_p95_s": 0.0, "by_algorithm": {}}
        hop = None
        hop_bounds = None
        with self._metrics_lock:
            rows = [dict(r) for (name, _), r in self.metrics.items()
                    if name.startswith("collective.")]
        for row in rows:
            short = row["name"][len("collective."):]
            alg = row["tags"].get("algorithm", "")
            if row["kind"] == "histogram":
                if short == "hop_s":
                    v = row["value"]
                    if hop is None:
                        hop = list(v)
                        hop_bounds = row["boundaries"]
                    else:
                        hop = [a + b for a, b in zip(hop, v)]
                continue
            if short in ("ops", "bytes_sent", "bytes_recv"):
                out[short] += row["value"]
                if alg:
                    slot = out["by_algorithm"].setdefault(
                        alg, {"ops": 0.0, "bytes_sent": 0.0,
                              "bytes_recv": 0.0})
                    slot[short] += row["value"]
        if hop and hop_bounds:
            out["hop_p95_s"] = round(
                _hist_quantile(hop_bounds, hop, 0.95), 6)
        return out

    # telemetry gauge -> short key in the per-node "arena" block of the
    # memory summary (reported by NodeTelemetryReporter off each store's
    # memory_stats(); absent until the first heartbeat lands)
    _ARENA_TELEMETRY_KEYS = {
        "object_plane.arena_capacity_bytes": "capacity",
        "object_plane.arena_used_bytes": "used_bytes",
        "object_plane.arena_highwater_bytes": "highwater_bytes",
        "object_plane.arena_entries": "entries",
        "object_plane.arena_sealed_bytes": "sealed_bytes",
        "object_plane.arena_sealed_data_bytes": "sealed_data_bytes",
        "object_plane.arena_unsealed_bytes": "unsealed_bytes",
        "object_plane.arena_pinned_bytes": "pinned_bytes",
        "object_plane.arena_borrow_pinned_bytes": "borrow_pinned_bytes",
        "object_plane.arena_deferred_deletes": "deferred_deletes",
        "object_plane.arena_deferred_delete_oldest_s":
            "deferred_delete_oldest_s",
    }

    def _sq_memory_summary(self, limit):
        """Cluster memory rollup (memory observatory): per-node and
        per-job/per-owner resident-byte aggregates off the object
        directory, merged with each node's last arena heartbeat, plus
        the reference-class breakdown and the top-N largest objects.
        Reference: `ray memory` / memory_utils.py's grouped object
        table, served from GCS object tables there, from the sharded
        directory here. Per-node resident bytes count every COPY on
        that node (so they compare exactly against the node store's
        sealed payload bytes); job/owner/total aggregates do too —
        they answer "whose bytes sit in arenas", not "how many
        distinct values exist"."""
        cfg = get_config()
        top_n = max(1, min(int(cfg.memory_summary_top_n),
                           limit if limit > 0 else 1 << 30))
        now = time.time()
        with self._lock:
            live_owners = {w.worker_id
                           for n in self.nodes.values()
                           for w in n.workers.values()}
            node_idxs = sorted(self.nodes)
        with self._metrics_lock:
            telemetry = {i: dict(t)
                         for i, t in self.node_telemetry.items()}
        nodes: Dict[int, dict] = {
            i: {"resident_bytes": 0, "resident_objects": 0,
                "spilled_bytes": 0, "arena": {}} for i in node_idxs}
        jobs: Dict[str, dict] = {}
        owners: Dict[str, dict] = {}
        classes = {"sealed_bytes": 0, "spilled_bytes": 0,
                   "checkpoint_bytes": 0, "prefetch_inflight_bytes": 0,
                   "borrow_pinned_bytes": 0}
        dead_owner = {"objects": 0, "bytes": 0, "owners": set()}
        all_objs: List[dict] = []
        for oid, loc in self.objects.items_snapshot():
            with self.objects.lock_for(oid):
                holders = sorted(loc.holders)
                size, owner, job = loc.size, loc.owner, loc.job
                tag, sealed_at = loc.tag, loc.sealed_at
                spilled = bool(loc.spilled_path)
                inprog = bool(loc.inprog)
            copies = len(holders)
            resident = size * copies
            if not resident and not spilled:
                continue
            for h in holders:
                row = nodes.setdefault(
                    h, {"resident_bytes": 0, "resident_objects": 0,
                        "spilled_bytes": 0, "arena": {}})
                row["resident_bytes"] += size
                row["resident_objects"] += 1
            if spilled:
                classes["spilled_bytes"] += size
            classes["sealed_bytes"] += resident
            if tag == "checkpoint":
                classes["checkpoint_bytes"] += resident
            if inprog:
                classes["prefetch_inflight_bytes"] += size
            jrow = jobs.setdefault(job or "", {
                "resident_bytes": 0, "objects": 0, "per_node": {}})
            jrow["resident_bytes"] += resident
            jrow["objects"] += 1
            for h in holders:
                jrow["per_node"][h] = jrow["per_node"].get(h, 0) + size
            orow = owners.setdefault(owner or "", {
                "resident_bytes": 0, "objects": 0, "live": True})
            orow["resident_bytes"] += resident
            orow["objects"] += 1
            if owner and owner not in live_owners:
                orow["live"] = False
                if resident:
                    dead_owner["objects"] += 1
                    dead_owner["bytes"] += resident
                    dead_owner["owners"].add(owner)
            all_objs.append({
                "object_id": oid.hex(), "size": size,
                "node_idx": holders[0] if holders else -1,
                "holders": holders, "owner": owner, "job": job,
                "tag": tag, "spilled": spilled,
                "age_s": round(now - sealed_at, 3) if sealed_at
                else 0.0,
            })
        for idx, row in nodes.items():
            t = telemetry.get(idx, {})
            row["arena"] = {
                short: t[g] for g, short in
                self._ARENA_TELEMETRY_KEYS.items() if g in t}
            spilled_here = sum(
                o["size"] for o in all_objs
                if o["spilled"] and o["node_idx"] == idx)
            row["spilled_bytes"] = spilled_here
        classes["borrow_pinned_bytes"] = int(sum(
            t.get("object_plane.arena_borrow_pinned_bytes", 0)
            for t in telemetry.values()))
        all_objs.sort(key=lambda o: o["size"], reverse=True)
        dead_owner["owners"] = sorted(dead_owner["owners"])
        return [{
            "nodes": nodes,
            "jobs": jobs,
            "owners": owners,
            "classes": classes,
            "dead_owner": dead_owner,
            "top_objects": all_objs[:top_n],
            "totals": {
                "resident_bytes": sum(
                    n["resident_bytes"] for n in nodes.values()),
                "resident_objects": len(
                    [o for o in all_objs if o["holders"]]),
                "spilled_bytes": classes["spilled_bytes"],
                "prefetch_inflight": self._prefetch_inflight_count(),
            },
        }]

    def _sq_metrics(self, limit):
        # merged client metrics plus the head's own ring-buffer
        # health counters, so silent event drops surface in
        # metrics_summary() / the Prometheus exposition
        with self._metrics_lock:
            rows = list(self.metrics.values())
        return rows + [
            {"name": "head.task_events_dropped",
             "kind": "counter",
             "description": "Task events dropped by bounded "
                            "buffers (worker + head ring)",
             "tags": {}, "boundaries": None,
             "value": float(self.task_events_dropped)},
            {"name": "head.cluster_events_dropped",
             "kind": "counter",
             "description": "Cluster events dropped by the head "
                            "ring buffer",
             "tags": {}, "boundaries": None,
             "value": float(self.cluster_events_dropped)},
            {"name": "object_plane.prefetch_issued",
             "kind": "counter",
             "description": "Speculative arg pulls fired at lease "
                            "grant / dispatch hint (r13)",
             "tags": {}, "boundaries": None,
             "value": float(self.prefetch_issued)},
            {"name": "object_plane.prefetch_joined",
             "kind": "counter",
             "description": "Demand arg fetches that joined an "
                            "in-flight speculative pull",
             "tags": {}, "boundaries": None,
             "value": float(self.prefetch_joined)},
            {"name": "object_plane.prefetch_wasted",
             "kind": "counter",
             "description": "Speculative pulls aborted as stale "
                            "(task cancelled/retried elsewhere)",
             "tags": {}, "boundaries": None,
             "value": float(self.prefetch_wasted)},
            {"name": "head.reconnects",
             "kind": "counter",
             "description": "Head-channel reattachments "
                            "(CLIENT_HELLO with reattach=true) from "
                            "agents/drivers/workers",
             "tags": {}, "boundaries": None,
             "value": float(self.client_reconnects)},
            {"name": "head.node_reattaches",
             "kind": "counter",
             "description": "Node agents that re-registered with a "
                            "prior node id after a head restart or "
                            "socket loss",
             "tags": {}, "boundaries": None,
             "value": float(self.node_reattaches)},
            {"name": "head.actor_reclaims",
             "kind": "counter",
             "description": "Actors re-claimed by surviving workers "
                            "after a head restart",
             "tags": {}, "boundaries": None,
             "value": float(self.actor_reclaims)},
            {"name": "head.request_dedupe_hits",
             "kind": "counter",
             "description": "Retried mutations answered from the "
                            "(client, request-id) dedupe cache "
                            "instead of re-applied",
             "tags": {}, "boundaries": None,
             "value": float(self.dedupe_hits)},
            {"name": "head.drain_migrated_leases",
             "kind": "counter",
             "description": "Leases released off draining nodes while "
                            "still alive (work migrated, not killed)",
             "tags": {}, "boundaries": None,
             "value": float(self.drain_migrated_leases)},
            {"name": "head.drains_completed",
             "kind": "counter",
             "description": "Graceful node drains that finished with "
                            "zero live leases (vs drains_forced)",
             "tags": {}, "boundaries": None,
             "value": float(self.drains_completed)},
        ]

    def _sq_io_loop(self, limit):
        # head event-loop lag (analog: the reference's
        # instrumented_io_context / event_stats.h per-handler
        # timing surfaced through the debug state endpoints) +
        # ring-buffer drop counters: overflow of the bounded
        # event buffers must be detectable, not silent
        now = time.monotonic()
        with self._lock:
            # workers recreated from agent re-registration reports
            # that have not re-REGISTERed themselves yet — nonzero
            # long after a restart means a node is stuck
            # re-registering (doctor_warnings flags it)
            pending = [now - w.spawned_at
                       for n in self.nodes.values()
                       for w in n.workers.values()
                       if w.state == "starting"
                       and w.sched_class == self.REATTACH_CLASS]
        return [dict(loop=self.io.name, **self.io.stats(),
                     **self.io.lag_stats(),
                     task_events_dropped=self.task_events_dropped,
                     cluster_events_dropped=(
                         self.cluster_events_dropped),
                     # off-loop fold-queue health: depth right now +
                     # batches shed because the queue hit its bound
                     fold_queue_depth=len(self._fold_q),
                     fold_queue_drops=self.fold_queue_drops,
                     lease_grant_batches=self.lease_grant_batches,
                     lease_grants_batched=self.lease_grants_batched,
                     # head fault tolerance (r12): channel reattaches,
                     # node/actor re-registrations, retried-mutation
                     # dedupe hits, grace-window state
                     client_reconnects=self.client_reconnects,
                     reconnect_clients=len(self._reconnect_clients),
                     node_reattaches=self.node_reattaches,
                     actor_reclaims=self.actor_reclaims,
                     dedupe_hits=self.dedupe_hits,
                     restart_grace_active=bool(self._grace_until),
                     # graceful node drain (r16)
                     drains_started=self.drains_started,
                     drains_completed=self.drains_completed,
                     drains_forced=self.drains_forced,
                     drain_migrated_leases=self.drain_migrated_leases,
                     drain_objects_replicated=(
                         self.drain_objects_replicated),
                     reattach_pending_workers=len(pending),
                     reattach_oldest_s=round(max(pending, default=0.0),
                                             3),
                     # this process's data/return-plane fast-path
                     # counters (vectored sends, coalesced
                     # flushes, batched completions, zero-copy
                     # raw bytes) — cluster-wide per-process
                     # totals ride the metrics channel instead
                     wire=P.WIRE.snapshot())]

    def _sq_cluster_events(self, limit):
        # most recent `limit` records, oldest first
        with self._cev_lock:
            recent = list(self.cluster_events)[-limit:]
        return [{
            "ts": ts, "severity": sev, "source": src,
            "node_idx": nidx, "entity_id": eid, "type": etype,
            "message": msg, "extra": extra,
        } for (ts, sev, src, nidx, eid, etype, msg, extra) in recent]

    @staticmethod
    def _fmt_task_event(ev):
        # wire tuple -> state-API dict; tolerant of the pre-r10
        # 10-field shape (no monotonic stamp)
        return {
            "task_id": ev[0], "name": ev[1], "state": ev[2],
            "worker_id": ev[3], "node_idx": ev[4], "ts": ev[5],
            "error": ev[6], "trace_id": ev[7], "span_id": ev[8],
            "parent_span_id": ev[9],
            "mono": ev[10] if len(ev) > 10 else None,
        }

    def _sq_task_events(self, limit):
        # raw transition log (timeline/tracing export)
        with self._timeline_lock:
            evs = list(self.task_events)
        return [self._fmt_task_event(ev) for ev in evs]

    def _sq_tasks(self, limit):
        # folded timelines, newest activity first: full state_ts
        # map + derived per-phase latency breakdown per row.
        # Materialize only `limit` rows — building 10k fat dicts
        # per dashboard poll would stall the fold thread.
        rows = []
        with self._timeline_lock:
            for r in reversed(self.task_timelines.values()):
                if len(rows) >= limit:
                    break
                rows.append({
                    "task_id": r.task_id, "name": r.name,
                    "state": r.state, "worker_id": r.worker_id,
                    "node_idx": r.node_idx, "ts": r.ts,
                    "error": r.error, "trace_id": r.trace_id,
                    "state_ts": dict(r.state_ts),
                    "phase_ms": E.derive_phase_ms(r.state_mono),
                    "straggler": r.straggler,
                })
        return rows

    def _sq_task_summary(self, limit):
        # per-func per-phase percentile summary from the folded
        # phase histograms (`ray summary tasks` parity++), plus
        # the (name, state) counts computed HERE — summarizing
        # must not ship every fat timeline row over the RPC
        # just to count states
        counts: Dict[str, Dict[str, int]] = {}
        with self._timeline_lock:
            for r in self.task_timelines.values():
                by_state = counts.setdefault(r.name, {})
                by_state[r.state] = by_state.get(r.state, 0) + 1
            total = len(self.task_timelines)
        return [{
            "phases": self._task_phase_summary(),
            "stragglers_flagged": self.stragglers_flagged,
            "slow_nodes_flagged": self.slow_nodes_flagged,
            "total": total,
            "by_func_name": dict(sorted(counts.items())),
        }]

    def _sq_slow_tasks(self, limit):
        rows = []
        with self._timeline_lock:
            for r in reversed(self.task_timelines.values()):
                if len(rows) >= limit:
                    break
                if not r.straggler:
                    continue
                rows.append({
                    "task_id": r.task_id, "name": r.name,
                    "state": r.state, "worker_id": r.worker_id,
                    "node_idx": r.node_idx,
                    "running_ms_when_flagged": r.straggler_ms,
                    "phase_ms": E.derive_phase_ms(r.state_mono),
                })
        return rows

    _STATE_KINDS = {
        "nodes": _sq_nodes,
        "workers": _sq_workers,
        "actors": _sq_actors,
        "placement_groups": _sq_placement_groups,
        "objects": _sq_objects,
        "object_plane": _sq_object_plane,
        "memory_summary": _sq_memory_summary,
        "metrics": _sq_metrics,
        "io_loop": _sq_io_loop,
        "cluster_events": _sq_cluster_events,
        "task_events": _sq_task_events,
        "tasks": _sq_tasks,
        "task_summary": _sq_task_summary,
        "slow_tasks": _sq_slow_tasks,
    }

    def _h_node_info(self, conn, rid):
        with self._lock:
            infos = [{
                "node_idx": n.idx,
                "alive": n.alive,
                "draining": n.draining,
                "resources_total": n.resources.total.to_dict(),
                "resources_available": n.resources.available.to_dict(),
                "store_name": n.store_name,
                "num_workers": len([w for w in n.workers.values()
                                    if w.state != "dead"]),
                "labels": n.resources.labels,
                "tpu": n.resources.tpu,
            } for n in self.nodes.values()]
        conn.reply(rid, infos, msg_type=P.NODE_INFO_REPLY)

    def _h_drain_node(self, conn, rid, node_idx):
        """DRAIN_NODE (r16): the full graceful-drain protocol — not just
        the scheduler exclusion the pre-r16 handler did. See
        ``drain_node``."""
        ok = self.drain_node(int(node_idx))
        if rid > 0:
            conn.reply(rid, ok)

    def _h_ping(self, conn, rid):
        conn.reply(rid, "pong")

    def _h_worker_exit(self, conn, rid):
        pass  # connection close handles cleanup

    # ------------------------------------------------ cross-language calls

    def _h_xlang_call(self, conn, rid, payload):
        """C++/non-Python frontend task submission (ref analog:
        cpp/src/ray/runtime/task/task_submitter.h:26 + the Ray Client
        proxy pattern, util/client/server/proxier.py — a thin client
        submits by FUNCTION DESCRIPTOR and the Python side executes).

        Request: JSON {"op": "submit", "function": "module:qualname",
        "args": [...], "kwargs": {...}, "options": {...},
        "timeout_s": 300}. The reply is a RAW frame of JSON (never
        pickle) keyed by this request's rid, so a C client only needs to
        frame-skip pickled traffic and parse JSON.
        """
        import json as _json

        req = _json.loads(bytes(payload).decode()
                          if isinstance(payload, (bytes, bytearray,
                                                  memoryview))
                          else payload)

        def run():
            try:
                out = {"rid": rid, "status": "ok",
                       "result": self._xlang_execute(req)}
            except BaseException as e:  # noqa: BLE001 — ship to client
                out = {"rid": rid, "status": "error", "error": repr(e)}
            try:
                conn.send_with_raw(
                    P.OK, rid,
                    raw=_json.dumps(out, default=repr).encode())
            except P.ConnectionLost:
                pass

        # off the IO thread: submission blocks on lease grant + execution
        threading.Thread(target=run, daemon=True, name="xlang").start()

    def _xlang_resolve(self, target: str):
        """'module:qualname' -> the python object, allowlist-checked."""
        import importlib

        mod_name, _, qual = target.partition(":")
        if not qual:
            raise ValueError(
                f"target {target!r} must be 'module:qualname'")
        allowed = get_config().xlang_allowed_prefixes
        if allowed:
            def _matches(p: str) -> bool:
                # module-boundary aware: "myapp" allows myapp and myapp.sub
                # but NOT myapp_evil; "myapp." allows the subtree only
                base = p.rstrip(".")
                return mod_name == base or mod_name.startswith(base + ".")
            prefixes = [p.strip() for p in allowed.split(",") if p.strip()]
            if not any(_matches(p) for p in prefixes):
                raise PermissionError(
                    f"module {mod_name!r} is not in xlang_allowed_prefixes")
        obj = importlib.import_module(mod_name)
        for part in qual.split("."):
            obj = getattr(obj, part)
        return obj

    def _xlang_execute(self, req: dict):
        """Cross-language frontend ops (C++/Java clients; the raw-JSON
        reply path of XLANG_CALL). Ref analog:
        cpp/src/ray/runtime/task/task_submitter.h:26 — normal tasks AND
        actor create/submit/kill from non-Python frontends."""
        import ray_tpu_torch

        op = req.get("op", "submit")
        timeout = float(req.get("timeout_s", 300))
        if op == "cluster":
            with self._lock:
                alive = [n for n in self.nodes.values() if n.alive]
                totals: Dict[str, float] = {}
                for n in alive:
                    for k, v in n.resources.total.to_dict().items():
                        totals[k] = totals.get(k, 0.0) + v
                return {"nodes": len(alive), "resources": totals}
        if op == "submit":
            rf = ray_tpu_torch.remote(self._xlang_resolve(req["function"]))
            opts = req.get("options") or {}
            if opts:
                rf = rf.options(**opts)
            ref = rf.remote(*req.get("args", []),
                            **(req.get("kwargs") or {}))
            return ray_tpu_torch.get(ref, timeout=timeout)
        if op == "actor_create":
            cls = ray_tpu_torch.remote(self._xlang_resolve(req["class"]))
            opts = dict(req.get("options") or {})
            name = opts.pop("name", None) or \
                f"xlang-actor-{next(self._xlang_actor_seq)}"
            cls.options(name=name, **opts).remote(
                *req.get("args", []), **(req.get("kwargs") or {}))
            # the name registers at creation; subsequent actor_calls
            # queue behind __init__ per actor task ordering
            return {"actor": name}
        if op == "actor_call":
            handle = ray_tpu_torch.get_actor(req["actor"])
            method = getattr(handle, req["method"])
            ref = method.remote(*req.get("args", []),
                                **(req.get("kwargs") or {}))
            return ray_tpu_torch.get(ref, timeout=timeout)
        if op == "actor_kill":
            ray_tpu_torch.kill(ray_tpu_torch.get_actor(req["actor"]))
            return {"killed": req["actor"]}
        raise ValueError(f"unknown xlang op {op!r}")

    _HANDLERS = {
        P.REGISTER: _h_register,
        P.LEASE_REQUEST: _h_lease_request,
        P.RETURN_WORKER: _h_return_worker,
        P.CREATE_ACTOR: _h_create_actor,
        P.GET_ACTOR: _h_get_actor,
        P.KILL_ACTOR: _h_kill_actor,
        P.CREATE_PG: _h_create_pg,
        P.REMOVE_PG: _h_remove_pg,
        P.KV_PUT: _h_kv_put,
        P.KV_GET: _h_kv_get,
        P.KV_DEL: _h_kv_del,
        P.KV_KEYS: _h_kv_keys,
        P.SUBSCRIBE: _h_subscribe,
        P.PUBLISH: _h_publish,
        P.OBJECT_SEALED: _h_object_sealed,
        P.OBJ_TAG: _h_obj_tag,
        P.OBJECT_LOCATE: _h_object_locate,
        P.OBJECT_FREE: _h_object_free,
        P.OBJ_LOCATION_ADD: _h_obj_location_add,
        P.OBJ_LOCATION_REMOVE: _h_obj_location_remove,
        P.OBJ_LOCATION_LOOKUP: _h_obj_location_lookup,
        P.OBJECT_RECOVERING: _h_object_recovering,
        P.OBJECT_TRANSFER: _h_object_transfer,
        P.NODE_INFO: _h_node_info,
        P.DRAIN_NODE: _h_drain_node,
        P.PING: _h_ping,
        P.WORKER_EXIT: _h_worker_exit,
        P.TASK_REPLY: _h_creation_reply,
        # workers batch completions toward whichever connection pushed
        # the tasks; nothing head-pushed batches today (creation replies
        # are inline), but a future head-routed task path must not
        # silently drop a batched ack
        P.TASK_DONE_BATCH: lambda self, conn, rid, replies: [
            self._h_creation_reply(conn, 0, *r) for r in replies],
        P.ACTOR_DEAD: _h_actor_dead,
        P.BORROW_ADD: lambda self, conn, rid, oid, owner, borrower:
            self._forward_to_worker(owner, P.BORROW_ADD, oid, borrower),
        P.BORROW_REMOVE: lambda self, conn, rid, oid, owner, borrower:
            self._forward_to_worker(owner, P.BORROW_REMOVE, oid, borrower),
        P.RECOVER_OBJECT: lambda self, conn, rid, oid, owner:
            self._forward_to_worker(owner, P.RECOVER_OBJECT, oid),
        P.REGISTER_NODE: _h_register_node,
        P.CLIENT_HELLO: _h_client_hello,
        P.TASK_EVENTS: _h_task_events,
        P.CLUSTER_EVENT: _h_cluster_events,
        P.STATE_QUERY: _h_state_query,
        P.SEAL_ABORTED: _h_seal_aborted,
        P.METRICS_REPORT: _h_metrics_report,
        P.XLANG_CALL: _h_xlang_call,
        P.PREFETCH_RESULT: _h_prefetch_result,
        P.PREFETCH_HINT: _h_prefetch_hint,
        P.PREFETCH_HINT_BATCH: _h_prefetch_hint_batch,
        P.OBJECT_WARM: _h_object_warm,
    }

    def _forward_to_worker(self, worker_id: str, mt: int, *fields):
        with self._lock:
            for node in self.nodes.values():
                w = node.workers.get(worker_id)
                if w is not None and w.conn is not None:
                    conn = w.conn
                    break
            else:
                return
        try:
            conn.send(mt, *fields)
        except P.ConnectionLost:
            pass

    # ------------------------------------------------------------ lifecycle

    def _enqueue_wal(self, rec: tuple):
        """Queue a durable record; the housekeeping thread does the file
        IO (append can trigger compaction = read+rewrite+fsync of the
        whole log — never on the RPC dispatch thread). Trade-off: a hard
        head crash can lose the last <0.25s of records; shutdown drains."""
        with self._lock:
            self._wal_backlog.append(rec)

    def _health_check(self):
        """Probe remote agents on a period; evict after N consecutive
        failures. Socket-close detection only catches DEAD agents — a
        WEDGED one (process alive, event loop stuck) keeps its socket
        open forever; the probe is what evicts it (reference: 3s period /
        5 failures, gcs_health_check_manager.h:39, ray_config_def.h)."""
        cfg = get_config()
        now = time.monotonic()
        with self._lock:
            targets = [
                n for n in self.nodes.values()
                if n.is_remote and n.alive and not n.ping_inflight
                and now - n.last_ping >= cfg.health_check_period_s
            ]
            for n in targets:
                n.ping_inflight = True
        for node in targets:
            threading.Thread(target=self._ping_node, args=(node,),
                             daemon=True, name="health-probe").start()

    def _ping_node(self, node: NodeState):
        cfg = get_config()
        try:
            t0 = time.monotonic()
            reply = node.agent_conn.call(
                P.PING, timeout=max(cfg.health_check_period_s, 1.0))
            t1 = time.monotonic()
            node.health_failures = 0
            # Heartbeat doubles as the clock-offset sampler: agents reply
            # with their own monotonic clock; the RTT midpoint estimates
            # (agent_mono - head_mono), refreshed every probe so drift
            # stays bounded. Folded task-event stamps from this node have
            # the offset subtracted (phase math in one timebase).
            if len(reply) >= 2 and isinstance(reply[1], (int, float)):
                off = float(reply[1]) - (t0 + t1) / 2.0
                with self._lock:
                    node.clock_offset_s = off
                    node.clock_rtt_s = t1 - t0
                    self.node_clock_offsets[node.idx] = off
        except Exception:  # noqa: BLE001 — timeout or conn error
            node.health_failures += 1
            if node.health_failures >= \
                    cfg.health_check_failure_threshold and node.alive:
                self.remove_node(node.idx)
        finally:
            node.last_ping = time.monotonic()
            node.ping_inflight = False

    def _drain_wal_backlog(self):
        if self._persist is None:
            return
        with self._lock:
            batch, self._wal_backlog = self._wal_backlog, []
        for rec in batch:
            self._persist.append(rec)

    def _housekeeping_loop(self):
        while not self._shutdown:
            time.sleep(0.25)
            try:
                self.periodic()
            except Exception:
                if not self._shutdown:
                    import traceback

                    traceback.print_exc()

    def periodic(self):
        """Housekeeping: PG retries, lease grants, idle worker reaping.
        Driven by the head's own keeper thread (and callable from tests)."""
        self._drain_wal_backlog()
        self._health_check()
        self._retry_pending_pgs()
        self._try_fulfill_pending()
        self._sweep_prefetches()
        self._check_drains()
        # restored actors/PGs held back by the restart grace window are
        # rescheduled here once it lifts (no-op on fresh sessions and
        # after the first post-grace flush)
        if self._restored_actor_specs or self._restored_pg_specs:
            self._flush_restored()
        # Loop-lag sampling: a timestamped self-wakeup measures how long
        # a newly-arrived event waits for the IO thread (the reference's
        # instrumented_io_context event-stats role). Sampled every
        # housekeeping tick; published as head.loop_lag_ms{quantile}
        # gauges so dashboards/scrapers see the control-plane headroom.
        self.io.probe_lag()
        self._publish_loop_lag_gauges()
        cfg = get_config()
        # Flight-recorder sampling (r19): fold the merged metric table
        # (same rows metrics_summary() serves, head built-ins included)
        # into the bounded ring-buffer series. Wall-clock stamps so
        # history aligns with timeline() event timestamps.
        if cfg.timeseries_sample_s > 0:
            wall = time.time()
            if wall - self._ts_last_sample >= cfg.timeseries_sample_s:
                self._ts_last_sample = wall
                self.recorder.sample(self._sq_metrics(1 << 30), wall)
        now = time.monotonic()
        with self._lock:
            # sweep ghost workers: a spawn whose process died (or whose
            # request was lost) before registering would otherwise sit in
            # "starting" forever, looking busy to idle-node accounting
            for node in self.nodes.values():
                for w in list(node.workers.values()):
                    if w.state == "starting" and now - w.spawned_at > \
                            cfg.worker_register_timeout_s:
                        self._kill_worker_process(w)
                        if node.is_remote and node.agent_conn is not None:
                            try:
                                node.agent_conn.send(P.KILL_WORKER,
                                                     w.worker_id)
                            except P.ConnectionLost:
                                pass
                        node.workers.pop(w.worker_id, None)
            for node in self.nodes.values():
                for cls, lst in list(node.idle_by_class.items()):
                    keep = []
                    for wid in lst:
                        w = node.workers[wid]
                        if now - w.idle_since > cfg.idle_worker_keep_alive_s:
                            self._kill_worker_process(w)
                            node.workers.pop(wid, None)
                        else:
                            keep.append(wid)
                    node.idle_by_class[cls] = keep

    @property
    def lost_objects(self):
        """The directory's LOST-id FIFO (read-only view; kept for the
        pre-r11 attribute surface — tests and tooling membership-check
        it)."""
        return self.objects._lost

    def _publish_loop_lag_gauges(self):
        """head.loop_lag_ms{quantile=p50|p99} gauges straight into the
        merged metric table (same direct-write path as the phase
        histograms) — the SCALE bench gate and doctor_warnings() read
        these."""
        lag = self.io.lag_stats()
        if not lag.get("loop_lag_samples"):
            return
        with self._metrics_lock:
            for q in ("p50", "p99"):
                key = ("head.loop_lag_ms", (q,))
                row = self.metrics.get(key)
                if row is None:
                    row = self.metrics[key] = {
                        "name": "head.loop_lag_ms", "kind": "gauge",
                        "description":
                            "Head IO-loop lag (self-probe wakeup wait), "
                            "milliseconds",
                        "tags": {"quantile": q}, "boundaries": None,
                        "value": 0.0,
                    }
                row["value"] = lag[f"loop_lag_ms_{q}"]

    def shutdown(self):
        self._shutdown = True
        self._fold_event.set()
        self._dispatch_event.set()
        if self._log_monitor is not None:
            self._log_monitor.stop()
        if self._telemetry is not None:
            self._telemetry.stop()
        if getattr(self, "_memory_monitor", None) is not None:
            self._memory_monitor.stop()
        with self._lock:
            workers = [w for n in self.nodes.values()
                       for w in n.workers.values()]
        for w in workers:
            self._kill_worker_process(w)
        for w in workers:
            if w.proc is not None:
                try:
                    w.proc.wait(timeout=2)
                except subprocess.TimeoutExpired:
                    pass
        self.io.stop()
        try:
            self._listener.close()
        except OSError:
            pass
        if self._tcp_listener is not None:
            try:
                self._tcp_listener.close()
            except OSError:
                pass
        for n in self.nodes.values():
            try:
                if n.store is not None:
                    n.store.close()
                if n.agent_conn is not None:
                    n.agent_conn.on_close = None
                    try:
                        # cluster shutdown is deliberate: agents exit
                        # now instead of re-dialing the dead head for
                        # the whole reconnect window
                        n.agent_conn.send(P.SHUTDOWN_NODE)
                    except P.ConnectionLost:
                        pass
                    n.agent_conn.close()
            except Exception:
                pass
        self.nodes.clear()
        if self._persist is not None:
            self._drain_wal_backlog()
            self._persist.close()


def _gpu_fit(node: NodeState, wids, want: tuple) -> Optional[str]:
    """The first idle worker in ``wids`` that may take a lease of GPU ids
    ``want``: one not bound yet, or bound to exactly these ids."""
    for wid in wids or ():
        bound = node.workers[wid].gpu_ids
        if bound is None or bound == want:
            return wid
    return None
