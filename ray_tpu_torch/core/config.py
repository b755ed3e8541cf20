"""Runtime configuration knobs, env-overridable.

Analog of the reference's RAY_CONFIG X-macro system
(src/ray/common/ray_config_def.h — 203 ``RAY_CONFIG(type, name, default)``
entries, overridable via ``RAY_<name>`` env vars). We keep the same contract:
every knob has a typed compile-time default and can be overridden with
``RAY_TPU_<NAME>`` in the environment or via ``init(_system_config=...)``.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field, fields

_ENV_PREFIX = "RAY_TPU_"


@dataclass
class Config:
    # --- object store ---
    # Size of the shared-memory object store arena per node, bytes.
    object_store_memory: int = 512 * 1024 * 1024
    # Objects smaller than this are inlined into task replies / in-process
    # store instead of the shm store (reference: max_direct_call_object_size,
    # ray_config_def.h).
    max_inline_object_size: int = 100 * 1024
    # Chunk size for node-to-node object transfer (reference: 5 MiB,
    # ray_config_def.h:348).
    object_transfer_chunk_bytes: int = 5 * 1024 * 1024
    # Spill threshold: fraction of arena used before spilling kicks in.
    object_spilling_threshold: float = 0.8
    spill_dir: str = ""
    # Multi-source striped pulls (reference: PullManager fans chunk
    # requests across every node in the ObjectDirectory's holder set,
    # pull_manager.cc): max concurrent source nodes per pull, and the
    # minimum object size worth splitting across sources at all.
    pull_max_sources: int = 4
    pull_min_stripe_bytes: int = 1 * 1024 * 1024
    # Cooperative pipelined broadcast (one-to-many distribution of one
    # object, e.g. model weights pulled by every gang member at step
    # start). The head's pull planner treats every node it has ALREADY
    # told to pull an object as an *in-progress location*: until that
    # pull completes or aborts, later pullers may be pointed at it, and
    # the in-progress node's TransferServer relays each chunk as soon as
    # it lands locally (partial-object serving) — forming an implicit
    # pipelined tree so a cold N-node broadcast moves ~S bytes off the
    # original holder instead of N x S. ``broadcast_fanout`` bounds how
    # many concurrent downstream pulls any single source (sealed holder
    # OR in-progress relay) is assigned before the planner moves on to
    # the next source; saturating every source falls back to the
    # least-loaded sealed holder (and fires the rate-limited
    # ``broadcast_fanout_saturated`` cluster event). The load accounting
    # is PER OBJECT (one _ObjLoc.serving map each): concurrent
    # broadcasts of K different objects held by one node may still put
    # K x fanout streams on that host's uplink — the bound shapes each
    # object's distribution tree; cap what actually leaves the host
    # with ``host_egress_limit_bps`` (the shared per-host token bucket).
    # 0 disables cooperative planning entirely: every puller stripes
    # across the sealed holder set (the pre-r9 behavior). In-progress
    # locations are
    # removed from the directory the moment their pull completes
    # (promoted to a sealed holder) or fails/aborts (never handed out
    # again; downstream pulls that already hold the address fail over to
    # the sealed root set via OBJ_PULL_FAIL / connection loss).
    broadcast_fanout: int = 2
    # How long a TransferServer waits for a directory-promised object to
    # appear locally (the relay's own pull may not have created the
    # buffer yet) and, once relaying, for each next chunk to arrive,
    # before failing the remaining range back to the requester
    # (OBJ_PULL_FAIL -> requester re-pulls from the root holder set).
    # Only pulls the head marked as relay-served wait at all; a plain
    # pull from a stale directory entry still fails fast.
    broadcast_serve_wait_s: float = 10.0

    # --- wire fast path ---
    # Small-frame coalescing (protocol.Connection): when several threads
    # send on one connection concurrently, queued frames are flushed
    # together in ONE vectored write (socket.sendmsg) by whichever sender
    # holds the write lock — one syscall instead of one per frame. These
    # knobs bound a single coalesced flush; an uncontended send is always
    # flushed immediately (batch of 1), so the idle-connection latency
    # path is unchanged. The queue reaching wire_coalesce_max_frames also
    # fires the wire-backpressure cluster event / counter.
    wire_coalesce_max_bytes: int = 1 * 1024 * 1024
    wire_coalesce_max_frames: int = 64
    # Batched task completions (protocol.TASK_DONE_BATCH, the return-side
    # mirror of PUSH_TASK_BATCH): a worker that finishes several tasks
    # while more are already queued acks them in one frame — at most this
    # many completions per frame. Replies flush whenever the worker's
    # task queue empties (a lone task's reply is never deferred), and a
    # reply-flusher thread ships anything still buffered ~1 ms after the
    # executor moves on, so a long-running next task can never withhold
    # an earlier task's finished result. 0 disables batching (one
    # TASK_REPLY frame per task, the pre-r8 behavior).
    task_done_batch_max: int = 128

    # Host-wide egress token bucket for the peer-to-peer object plane
    # (TransferServer): ALL concurrent serves on one host — every
    # object, every downstream puller, root and relay streams alike —
    # drain one shared bucket of this many bytes/second. This is the
    # host-level companion to ``broadcast_fanout``: the fanout bound
    # shapes each OBJECT's distribution tree, but K concurrent
    # broadcasts of K different objects held by one node could still
    # stack K x fanout streams on that host's uplink — the bucket caps
    # what actually leaves the NIC regardless of how many trees the
    # planner built through it. 0 (default) disables pacing; benches
    # and tests also set ``TransferServer.egress_limit_bps`` directly
    # for uplink emulation.
    host_egress_limit_bps: int = 0

    # --- device path (r13) ---
    # Typed zero-copy serialization for ``torch.Tensor`` (and large
    # non-contiguous ``np.ndarray``): the reducer emits dtype/shape
    # metadata in frame 0 and the tensor payload as an out-of-band
    # buffer VIEW of its contiguous host copy — no in-band pickle copy —
    # so ``put_serialized`` writes the bytes straight into the mapped
    # arena (a CUDA tensor pays one device->host copy first). On the
    # read side ``deserialize`` rebuilds a CPU tensor zero-copy over the
    # arena-backed view and a CUDA tensor with one host->device copy
    # onto the consumer's current device, and plain
    # ndarray consumers alias arena memory outright — the store's
    # borrow-pin ledger keeps the arena slice alive while any such view
    # is (see ``ShmObjectStore.get_frames(pin_borrows=True)``). False
    # restores the pre-r13 in-band pickle path (the A/B control for
    # bench_device_path.py).
    serialization_device_zero_copy: bool = True

    # --- speculative arg prefetch (r13) ---
    # At lease grant — and again at driver dispatch via PREFETCH_HINT,
    # since leases are long-lived and serve many tasks — the head checks
    # the granted node's directory entry against the task's deduped
    # by-ref arg ids and fires a prefetch-flagged PULL_OBJECT at that
    # node's agent for every missing arg, so the pull overlaps the lease
    # reply, driver dispatch and worker wakeup instead of starting cold
    # inside the worker's _decode_args (the reference PullManager's
    # prefetch role; FETCHING_ARGS phase overlap). The worker's get()
    # joins the in-flight pull via the puller's _pending leadership.
    # False disables both the grant-time and hint-driven prefetch (the
    # A/B control).
    arg_prefetch_enabled: bool = True
    # Per-destination-node bound on concurrent prefetch pulls. The caps
    # PACE rather than drop (the reference PullManager's bounded pull
    # activation): requests over the caps queue per node (bounded FIFO,
    # 256) and activate as PREFETCH_RESULTs free slots, re-checking
    # holders/caps/lease liveness at activation. <= 0 disables
    # prefetching entirely.
    arg_prefetch_max_inflight: int = 4
    # Per-destination-node bound on the total bytes of in-flight
    # prefetch pulls; over-cap requests wait in the same pending queue
    # (a misconfigured cap shows up as doctor_warnings()'s prefetch
    # waste-ratio warning or as joins instead of warm hits, not as
    # arena pressure).
    arg_prefetch_max_bytes: int = 256 * 1024 * 1024
    # Dispatch-time PREFETCH_HINT dedupe window (r14): the driver
    # submitter remembers, per leased worker, which by-ref arg ids it
    # hinted in the last this-many seconds and strips them from later
    # hints — an actor-task hot loop that passes the same refs on every
    # call (the serve-handle weights/payload pattern) sends ONE hint per
    # (lease, arg) per window instead of one per pushed batch. The head
    # keeps its own dedupe, so this only saves wire frames + head-loop
    # wakeups; <= 0 restores the hint-per-batch behavior.
    prefetch_hint_dedupe_ttl_s: float = 5.0
    # PREFETCH_HINT coalescing (r15): dedupe catches REPEATED arg ids,
    # but a pipeline hot loop ships FRESH by-ref args every call (each
    # microbatch's activation is a new object) — one hint frame per
    # pushed batch per stage actor. With coalescing on, hints buffer
    # per (lease | actor) destination and the submitter's next wakeup
    # flushes everything pending as ONE PREFETCH_HINT_BATCH frame
    # (destinations ride together; ids hinted to the same destination
    # across consecutive batches merge — counted in the context's
    # ``prefetch_hints_coalesced``). Latency cost is one submitter
    # wakeup (~sub-ms), irrelevant to speculation that exists to
    # overlap a multi-ms transfer. False restores the r14
    # frame-per-batch behavior (the A/B control).
    prefetch_hint_coalesce: bool = True

    # --- MPMD pipeline parallelism (r15) ---
    # Stage-actor placement for ``train.pipeline.Pipeline``:
    # "auto" pins stage k to node (k mod n_alive_nodes) with soft node
    # affinity — one stage per node when the cluster has enough nodes,
    # so activations flow store-to-store over the object plane and each
    # stage's compute overlaps its neighbours' transfers; "spread" uses
    # a SPREAD placement group (the reference's pipeline-stage
    # placement-group idiom) without explicit node pinning; "none"
    # leaves placement to the default hybrid policy (stages may
    # co-locate — correct, but transfer/compute overlap vanishes).
    pipeline_stage_placement: str = "auto"
    # Upper bound on microbatches in flight per ``run_batch``. 0 = the
    # schedule's natural bound: 1F1B is self-limiting at O(stages)
    # in-flight (stage k holds at most S-k live activation contexts)
    # while GPipe keeps all M alive until its backward wave. A positive
    # value runs the batch in WAVES of at most this many microbatches —
    # grads keep accumulating across waves so results are unchanged,
    # each wave boundary drains the pipeline (one extra bubble per
    # wave) — useful to cap arena footprint when running GPipe with
    # many microbatches.
    pipeline_max_inflight_microbatches: int = 0

    # --- data-parallel pipelines (r18) ---
    # Default replica count per pipeline stage for ``train.Pipeline``
    # (the constructor's ``replicas_per_stage=`` overrides). With R > 1
    # the pipeline becomes the MPMD paper's full PP x DP composition:
    # each stage runs as R gang-placed actors, microbatch mb flows
    # through replica (mb mod R) of EVERY stage (activations never
    # cross replicas — R independent 1-wide pipelines share the stage
    # program), and at batch end each stage's replica group runs a
    # bucketed gradient all-reduce over ``ray_tpu_torch.collective`` (ring
    # transport by default), submitted into each replica's task lane
    # right after its last backward so late stages' grad sync overlaps
    # early stages' remaining backward waves. Grads after run_batch
    # equal the 1-replica run (sum of per-replica sums, mean over the
    # global microbatch count).
    pipeline_replicas_per_stage: int = 1
    # Bucket size for the batch-end data-parallel grad all-reduce:
    # consecutive same-dtype gradient leaves are concatenated into
    # ~this-many-byte flat buckets and each bucket is all-reduced
    # separately, so the first buckets' ring hops overlap the later
    # buckets' (and other stages') work and no single collective
    # payload grows with model size. Mirrors the reference DDP /
    # NCCL-group bucketing. Must be identical across replicas (it is,
    # via shared config — the bucket split must line up for the ring's
    # chunk exchange to rendezvous).
    pipeline_grad_bucket_bytes: int = 16 * 1024 * 1024

    # --- elastic pipeline repair (r16) ---
    # Object-plane stage checkpoints: every this-many completed WAVES
    # (see ``pipeline_max_inflight_microbatches`` — with bound 0 the
    # whole batch is one wave) each ``_StageWorker`` snapshots its
    # params + accumulated grads + microbatch count as a by-ref tree
    # (plasma-resident on the stage's node via the r13 typed zero-copy
    # reducer for ``jax.Array`` leaves); the driver holds one ref per
    # stage tagged by wave, replicates sole-copy snapshots off the
    # producing node (so a node kill cannot take the only copy with
    # it), and frees the previous wave's refs eagerly — O(stages)
    # checkpoint footprint, the same discipline as activations. On a
    # stage's node death the gang restores to the latest checkpointed
    # wave and replays ONLY the waves since it (redo bounded by this
    # knob x the wave size). <= 0 disables checkpointing AND the repair
    # path entirely (a stage death fails the batch, the pre-r16
    # behavior).
    pipeline_checkpoint_every_waves: int = 1
    # How many stage-death repairs one ``train.Pipeline`` absorbs
    # before giving up and re-raising the failure to the caller — a
    # node that dies repeatedly (or a cluster with no capacity left to
    # re-place the stage) must not retry forever. Counted per repair
    # event (one event may re-place several co-located stages).
    pipeline_max_repairs: int = 3
    # Graceful node drain (``ray_tpu_torch.drain_node`` / ``DRAIN_NODE``):
    # how long the head waits for a draining node's in-flight leases to
    # complete (and its sole-copy objects to replicate off) before
    # force-escalating to the deliberate r12 ``SHUTDOWN_NODE`` anyway
    # (``drain_forced`` cluster event; surviving work then rides the
    # normal lineage/retry machinery). While draining, the node takes
    # no new leases, placements, or prefetch/warm pulls; holders keep
    # serving so copies replicate off via the existing pull machinery.
    # ``doctor_warnings()`` flags a node stuck draining past this
    # deadline (the escalation itself wedged).
    drain_deadline_s: float = 30.0

    # --- host-plane collectives (r18) ---
    # Default transport family for ray_tpu_torch.collective operations when a
    # call passes transport="auto". "ring" (default): the data plane is
    # the OBJECT PLANE — each rank put()s its chunks into its local
    # arena and peers pull them store-to-store (striped pulls, r13
    # typed zero-copy reducer; neither the coordinator actor nor the
    # driver ever carries payload bytes, counter-asserted in
    # BENCH_dp_r18.json), with sized payloads riding a chunked ring
    # reduce-scatter+allgather (~2·(R-1)/R·nbytes per rank, per-hop
    # pulls warmed ahead of the fold) and small payloads a
    # halving-doubling tree (log2 R hops) on power-of-two worlds.
    # "rendezvous": the pre-r18 auto behavior, preserved verbatim —
    # payloads below 256 KiB funnel inline through the per-group
    # rendezvous actor (whose incremental fold keeps its peak memory at
    # O(1) payloads), larger ones ride the two-round slice exchange.
    # Per-call transport= overrides (transport="rendezvous" forces the
    # pure coordinator funnel — the only data plane with ZERO
    # object-plane involvement, the true escape hatch and the bench's
    # A/B baseline); every rank of one operation must resolve the SAME
    # family (identical config + shapes do).
    collective_transport: str = "ring"
    # Chunk size for the ring/tree collectives' object-plane payloads:
    # each published slice is split into ~this-many-byte arena objects,
    # so a consumer's pull of chunk k+1 (started ahead by the
    # OBJECT_WARM prefetch) overlaps its fold of chunk k, and per-pull
    # latency stays bounded on paced links. Smaller chunks = more
    # overlap but more per-object control traffic (put + directory +
    # pull round-trips); the default suits multi-MiB gradient buckets.
    # Must agree across the ranks of one operation (same config, or the
    # same explicit chunk_bytes= argument).
    collective_ring_chunk_bytes: int = 4 * 1024 * 1024

    # --- serve at scale (r14) ---
    # How long a ``slow_node`` detector flag stays routable-around: the
    # head marks the node slow in its `nodes` state rows for this long
    # after each detection (refreshed while the skew persists), and
    # serve routers deprioritize replicas on flagged nodes (power-of-
    # two-choices falls back to them only when every clean replica is
    # saturated). Longer than the detector's 30s per-(node,phase) event
    # rate limit so a persistently slow host stays flagged between
    # sweeps; <= 0 disables routing flags entirely (events still fire).
    slow_node_route_ttl_s: float = 60.0
    # Serve ingress zero-copy threshold: a handle.remote() positional /
    # keyword arg that is bytes / bytearray / ndarray / jax.Array of at
    # least this many bytes is put() into the object store and passed BY
    # REFERENCE, so the payload rides the r8 vectored zero-copy wire
    # path + r13 arena-backed typed reducer end-to-end (driver arena ->
    # replica arena, no intermediate pickle copies) and the dispatch-
    # time PREFETCH_HINT overlaps the replica's fetch with dispatch.
    # Small args stay inline (a put + directory round-trip costs more
    # than it saves). The default is deliberately high: inline args
    # already ride the r8 zero-copy wire one hop, so by-ref only wins
    # once the payload is large enough to amortize the extra arena hop
    # and per-object control traffic — the ingress A/B in
    # SERVE_BENCH_r14.json measured by-ref LOSING on loopback below
    # ~16 MiB (0.34x rps at 2 MiB, 0.87x at 16 MiB). Lower it (e.g.
    # 512 KiB) when replicas sit behind a paced/real network link or
    # when the same payload fans out to many replicas (broadcast +
    # prefetch regimes, where by-ref wins). <= 0 disables the by-ref
    # conversion (the bench A/B control).
    serve_request_by_ref_min_bytes: int = 16 * 1024 * 1024
    # Serve deployment weights-by-ref threshold: an init arg of
    # ``Deployment.bind(...)`` that is an ndarray / jax.Array / bytes
    # of at least this many bytes — applied PER ARRAY, including
    # elements found inside (nested) list/tuple/dict containers; a
    # container of small shards each below the threshold ships inline
    # even if the container total exceeds it — is put() into the object
    # store ONCE at serve.run() time and
    # replaced by a reference in the replica-spec payload — every
    # replica fetches it through the object plane (cooperative
    # pipelined broadcast under concurrent scale-up: near-constant
    # cold-start in fleet size, root egress ~2xS) instead of unpickling
    # a private copy shipped inside CREATE_ACTOR args. The controller
    # also pre-warms these refs onto nodes at scale-up decision time
    # (OBJECT_WARM). <= 0 disables the conversion; explicit ObjectRef
    # init args are always resolved replica-side regardless.
    serve_weights_by_ref_min_bytes: int = 4 * 1024 * 1024
    # doctor_warnings(): flag a serve deployment whose autoscaler
    # reversed direction (up->down or down->up) more than this many
    # times inside the flap window (60s) — a flapping policy burns
    # cold-starts and kills warm replicas; raise the hysteresis
    # windows/cooldowns instead of living with it.
    serve_flap_warn_reversals: int = 3
    # doctor_warnings(): flag a deployment whose replica cold-start p95
    # exceeds this bound — weights are not riding the broadcast path
    # (missing by-ref init), or scale-ups are queueing behind placement.
    serve_cold_start_p95_warn_s: float = 30.0

    # --- streaming datasets: pipelined shuffle (r17) ---
    # Master switch for the r17 exchange. True (default) runs
    # all-to-all ops as the pipelined object-plane exchange: streamed
    # split admission with holder-locality, the merge fold tree with
    # eager part free, per-partition home placement, arena-fill
    # backpressure and merge-side prefetch hints, with COLUMNAR
    # split/merge kernels for Arrow blocks (routing computed without
    # materializing row dicts; ~5x kernel speedup measured at 1 MiB
    # blocks). False restores the pre-r17 drain-based exchange
    # verbatim (upstream ref drain, row-path kernels, all parts held
    # to their terminal merge) — the bench baseline and the escape
    # hatch should a block shape misbehave under the new kernels.
    data_shuffle_pipelined: bool = True
    # Split-task admission window of the data layer's all-to-all
    # exchange (`data/executor.py`): at most this many split tasks may
    # be submitted-but-incomplete at once, so upstream blocks are
    # consumed as a stream instead of drained wholesale and the store's
    # intermediate part footprint stays O(n_out x (window + fanin))
    # rather than O(n_in x n_out). 0 (default) sizes the window like
    # the map-stage budget: 2 tasks per cluster CPU, min 4.
    data_shuffle_inflight_window: int = 0
    # Arena-fill backpressure high-water fraction: while ANY node's shm
    # object-store fill (the `node.object_store_used_bytes /
    # node.object_store_capacity_bytes` telemetry gauges the head
    # already exports in its node state rows) exceeds this fraction,
    # the exchange pauses split admission — a shuffle working set
    # larger than memory degrades to pacing plus the existing spill
    # path (`object_spilling_threshold`, deliberately above this
    # default so pacing engages BEFORE spilling) instead of OOMing the
    # arena. <= 0 disables the gauge check (window-only admission).
    data_shuffle_store_highwater: float = 0.75
    # Merge-side fold-tree fan-in: each output partition folds every
    # this-many incoming split parts into ONE intermediate block
    # (order-preserving concat; piled-up intermediates fold again), so
    # part refs are freed at fold-submission time instead of every
    # (input, output) part surviving to the terminal merge. A TREE, not
    # an accumulator chain: rows are copied O(log_fanin(n_in)) times
    # and no fold waits on a chain of predecessors. Higher = fewer
    # merge tasks but more parts pending per partition (footprint
    # O(n_out x (fanin + window))); values < 2 are clamped to 2.
    data_shuffle_merge_fanin: int = 8
    # Dispatch-time PREFETCH_HINT / PREFETCH_HINT_BATCH for merge-task
    # args (the per-task `prefetch_args` option): with hints on, the
    # head starts pulling a merge's n_in part objects to its node while
    # earlier merges still compute — wide reads overlap compute, with
    # the r6 striped pulls doing the heavy lifting for multi-holder
    # parts. False submits shuffle merges with `prefetch_args=False`
    # (the bench A/B control; demand fetches still work).
    data_shuffle_prefetch_hints: bool = True

    # --- scheduling ---
    # Hybrid scheduling policy: prefer local node until its utilization
    # exceeds this, then spread (reference: scheduler_spread_threshold).
    scheduler_spread_threshold: float = 0.5
    # Top-k fraction of nodes considered for random tie-breaking
    # (reference: scheduler_top_k_fraction).
    scheduler_top_k_fraction: float = 0.2
    # Max tasks in flight pushed to one worker before backpressure.
    # Pipeline depth per leased worker. Deep enough to hide reply latency at
    # high task rates (the async-task throughput benchmark); the submitter
    # spreads queued tasks evenly across free workers, so coarse-grained
    # workloads still parallelize rather than hoarding one worker's pipeline.
    max_tasks_in_flight_per_worker: int = 40
    # Rate limit on concurrent lease requests per scheduling class (the
    # reference's max_pending_lease_requests_per_scheduling_category): the
    # head queues ungrantable requests, so unbounded requests just churn.
    max_pending_lease_requests_per_class: int = 10
    # Batched lease granting (head dispatcher thread): queued
    # LEASE_REQUESTs are granted in ONE pass over node state per
    # dispatch tick — a single head-lock hold instead of a lock/scan
    # per lease per retry — and a driver granted several leases in one
    # pass is acked with ONE ``LEASE_GRANT_BATCH`` frame carrying up to
    # this many grants (the request-side mirror of r8's
    # TASK_DONE_BATCH). <= 1 disables the batched reply frames (every
    # grant ships as its own LEASE_REPLY; the single-pass dispatch
    # itself is always on).
    lease_grant_batch_max: int = 64
    # Locality-aware leasing (reference: LocalityAwareLeasePolicy +
    # scheduler locality data, locality_aware_lease_policy.h): when a
    # task's by-reference args total at least locality_min_arg_bytes,
    # prefer the feasible node already holding the most argument bytes
    # over the hybrid/spread policies — the bytes then never move.
    scheduler_locality_enabled: bool = True
    locality_min_arg_bytes: int = 100 * 1024

    # --- worker pool ---
    # Max idle workers kept alive per scheduling class.
    idle_worker_keep_alive_s: float = 30.0
    # Fork CPU-count workers at head start so the first task burst finds an
    # idle pool (reference: WorkerPool prestart). Interpreter startup is
    # seconds; paying it mid-workload serializes behind the GIL-bound
    # driver on small hosts.
    prestart_workers: bool = True
    # Hard cap on worker processes per node (we run on few cores).
    max_workers_per_node: int = 16
    # Seconds to wait for a worker process to register before failing.
    worker_register_timeout_s: float = 30.0

    # --- actors ---
    actor_creation_timeout_s: float = 60.0

    # --- health / fault tolerance ---
    # Reference: 3s period, 5 failures (ray_config_def.h:791-797).
    health_check_period_s: float = 3.0
    health_check_failure_threshold: int = 5
    task_max_retries_default: int = 3
    # Owner-side lineage cache: plasma-resident task results whose creating
    # TaskSpec is retained for reconstruction after node loss (reference:
    # lineage_pinning + ObjectRecoveryManager, object_recovery_manager.h:41).
    lineage_cache_max_entries: int = 4096
    # Attempts to re-execute a creating task when recovering a lost object.
    object_recovery_max_attempts: int = 3
    # Durable head WAL (reference: GCS Redis-backed store client —
    # redis_store_client.h). Restores KV / named actors / PGs on restart.
    head_persistence: bool = True
    # Head fault tolerance (reference: GCS FT —
    # gcs_rpc_server_reconnect_timeout_s, ray_config_def.h): how long a
    # node agent / driver / worker keeps retrying its head channel after
    # a ConnectionLost before giving up with the pre-r12 fail-fast error
    # (agents shut down, workers exit, driver calls raise). While
    # reconnecting, writes park and in-flight call()s are replayed after
    # reattach with their original request ids — the head's
    # (client_id, request_id) dedupe map keeps a retried mutation that
    # already landed from applying twice. A head restarted on the same
    # address/session dir within this window is a recoverable event: the
    # cluster re-registers instead of dying.
    head_reconnect_timeout_s: float = 30.0
    # Bootstrap grace window of a RESTARTED head (same session dir => WAL
    # records found): lease granting, restored-actor/PG rescheduling and
    # the straggler/slow-node detectors hold for up to this long while
    # node agents / workers re-register, so the head never schedules
    # against a half-empty node table or double-schedules an actor whose
    # surviving worker is about to reclaim it. The window lifts EARLY
    # once at least one node is present and no new registration has
    # landed for 0.5s (re-registrations arrive in a burst right after
    # the head comes back). Fresh sessions (no WAL records) pay nothing.
    head_restart_grace_s: float = 5.0
    # OOM control (reference: memory_monitor.h:52 — 0.95 threshold,
    # 250ms refresh). refresh <= 0 disables the monitor.
    memory_usage_threshold: float = 0.95
    memory_monitor_refresh_s: float = 0.25

    # --- logging / events ---
    log_dir: str = ""
    task_event_buffer_size: int = 10000
    # Off-loop task-event folding (head fold thread): TASK_EVENTS
    # batches from the wire queue here and a dedicated thread folds
    # them into the timeline table — the head IO loop only routes. At
    # most this many BATCHES may be queued; overflow sheds the batch
    # (counted in ``fold_queue_drops``, surfaced via io_loop state and
    # doctor_warnings()) rather than backpressuring the control plane.
    # Sync flushes (timeline()'s ordering barrier) are acked by the
    # fold thread only after ingestion, so queries still observe them.
    task_event_fold_queue_max: int = 512
    # Folded per-task lifecycle timelines on the head (state_ts /
    # phase_ms rows behind `state.list_tasks`): max tasks retained,
    # FIFO-evicted by last activity. Independent of the raw event ring —
    # a timeline survives ring overflow. <= 0 disables folding entirely
    # (list_tasks goes empty; the raw ring still serves task_events).
    task_timeline_max_entries: int = 10000
    # Straggler detection (head-side detector thread over the folded
    # timelines). A RUNNING task is flagged — once, with one rate-limited
    # `task_straggler` cluster event naming task/node/worker — when its
    # current exec time exceeds `straggler_factor` x the p95 of its
    # func's COMPLETED exec distribution (task.phase_ms{func,exec}
    # histogram). The robust-bound comparison only arms once that
    # distribution holds at least `straggler_min_samples` completions
    # (the min-sample gate: p95 of two data points is noise, and a
    # brand-new func must not alarm on its first long run). The same
    # factor+gate drive the per-node phase-skew check (`slow_node`
    # events when one node's dispatch/arg_fetch p95 is factor x the
    # cluster median and at least 5ms over it).
    straggler_factor: float = 3.0
    straggler_min_samples: int = 5
    # Detector sweep period, seconds; <= 0 disables the detector thread
    # entirely (timelines and histograms still fold — only the
    # task_straggler / slow_node flagging stops).
    straggler_detect_period_s: float = 1.0
    # Head-side ring buffer for the structured cluster event log
    # (reference: the GCS event aggregator behind `ray list
    # cluster-events`). Overflow drops the oldest and counts the drops.
    cluster_event_buffer_size: int = 10000
    # Per-node physical telemetry sampling period (reference:
    # dashboard/modules/reporter/reporter_agent.py, 2.5s). <= 0 disables
    # the reporter thread.
    node_telemetry_period_s: float = 2.0
    # Flight recorder (r19): the head samples its merged metric table
    # every `timeseries_sample_s` seconds into per-series ring buffers —
    # counters folded to per-second rates, gauges as-is, histograms to
    # p50/p95/p99 point estimates. The fine ring keeps the most recent
    # `timeseries_window_s` seconds at full sample resolution; samples
    # that age out are 8:1 downsampled (mean) into a coarse ring
    # covering ~8x the window, so a post-hoc `state.metrics_history()`
    # or `/api/timeseries` query can still see the shape of an hour-old
    # incident at reduced resolution. Memory is bounded per series:
    # window_s/sample_s fine points + window_s/sample_s coarse points.
    # <= 0 sample period disables the recorder entirely.
    timeseries_sample_s: float = 1.0
    timeseries_window_s: float = 300.0
    # --- memory observatory (r20) ---
    # Arena accounting rides the node-telemetry heartbeat above
    # (`node_telemetry_period_s` is the sample cadence): each beat
    # publishes the store's memory_stats() as object_plane.arena_*
    # gauges, which flow into node rows, Prometheus, and the flight
    # recorder. The knobs below tune the derived surfaces only — the
    # accounting itself has no switch of its own (disable telemetry to
    # disable it).
    # Top-N largest-object cap for `ray_tpu memory` /
    # `/api/summary/memory` (reference: ray memory's --num-entries).
    memory_summary_top_n: int = 20
    # doctor: warn when a node's arena_used_bytes grew monotonically
    # (no sample below its predecessor) across the trailing
    # `arena_growth_warn_window_s` seconds of flight-recorder history
    # AND the total growth exceeds `arena_growth_warn_min_frac` of
    # capacity — the signature of a reference leak, as opposed to
    # steady-state churn which dips on every free.
    arena_growth_warn_window_s: float = 120.0
    arena_growth_warn_min_frac: float = 0.05
    # doctor: warn when a node's arena fill (used/capacity) crosses
    # this fraction — next allocation burst likely evicts or OOMs.
    arena_pressure_warn_frac: float = 0.90
    # doctor: warn when a borrow-ledger deferred delete has been stuck
    # behind live zero-copy views for longer than this (a leaked view
    # holds the arena slot forever); <= 0 disables the check.
    borrow_deferred_delete_warn_s: float = 30.0

    # Object-plane transfers (pull/push/prefetch) below this byte size
    # do NOT emit comm.* timeline spans; tiny control-sized objects
    # would otherwise flood the task-event ring with microsecond spans
    # that no overlap analysis cares about. Collective hops always
    # emit spans regardless of size (they are the workload).
    transfer_span_min_bytes: int = 65536

    # --- cross-language gateway ---
    # Comma-separated module-prefix allowlist for XLANG_CALL (the framed
    # JSON task-submission endpoint used by the C++/Java clients). Empty =
    # allow any importable module, matching the trust model of the rest of
    # the protocol: every peer that can reach the head socket can already
    # submit pickled tasks (pickle implies arbitrary code execution), the
    # same cluster-internal trust boundary as the reference's GCS. Set
    # e.g. "myapp.,mylib.jobs" to restrict non-Python clients to known
    # entry points.
    xlang_allowed_prefixes: str = ""

    def __post_init__(self):
        for f in fields(self):
            env = os.environ.get(_ENV_PREFIX + f.name.upper())
            if env is None:
                continue
            if f.type in ("int", int):
                setattr(self, f.name, int(env))
            elif f.type in ("float", float):
                setattr(self, f.name, float(env))
            elif f.type in ("bool", bool):
                setattr(self, f.name, env.lower() in ("1", "true", "yes"))
            else:
                setattr(self, f.name, env)

    def apply_overrides(self, overrides: dict | str | None):
        if not overrides:
            return
        if isinstance(overrides, str):
            overrides = json.loads(overrides)
        for k, v in overrides.items():
            if not hasattr(self, k):
                raise ValueError(f"Unknown config key: {k}")
            setattr(self, k, v)


_config: Config | None = None


def get_config() -> Config:
    global _config
    if _config is None:
        _config = Config()
    return _config


def reset_config():
    """Reset the singleton to defaults (+ env overrides).

    IN PLACE when a singleton already exists (r15): ``init()`` resets the
    config before applying ``_system_config``, and a module that grabbed
    ``get_config()`` BEFORE ``init()`` used to keep an orphaned object —
    its reads went stale and its mutations (e.g. a bench A/B toggling a
    flag) silently never reached the live runtime. Re-initializing the
    existing instance keeps every reference, whenever taken, pointing at
    the one live config."""
    global _config
    if _config is None:
        return
    fresh = Config()
    for f in fields(_config):
        setattr(_config, f.name, getattr(fresh, f.name))


# An AF_UNIX socket path holds at most 107 bytes; the longest one the
# runtime binds is a worker's, "<root>/session_<10 hex>/w_<12 hex>.sock".
_LONGEST_SOCKET = "/session_0123456789/w_0123456789ab.sock"


def runtime_tmp_dir() -> str:
    """Root of the runtime's session and agent directories: under this
    process's temp directory (``TMPDIR``), or under ``/tmp`` where that
    directory's path is too long for the unix sockets a session holds."""
    root = os.path.join(tempfile.gettempdir(), "ray_tpu_torch")
    if len(root) + len(_LONGEST_SOCKET) > 107:
        root = "/tmp/ray_tpu_torch"
    return root
