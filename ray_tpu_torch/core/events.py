"""Task execution events: worker-side buffer -> head ring buffer.

The reference buffers task state transitions in each core worker and
flushes them to the GCS for the observability APIs
(src/ray/core_worker/task_event_buffer.h:199, flush period 1s, bounded
buffer with drop counting; surfaced by `ray list tasks` /
python/ray/util/state/api.py). Same shape here: every CoreContext owns a
TaskEventBuffer; a daemon flusher batches events to the head over the
existing connection (P.TASK_EVENTS), and the head keeps a bounded deque the
state API queries. Overflow drops the oldest events and counts the drops —
observability must never backpressure the task path.

This module also owns the two companions of that channel:

* the ambient TRACE CONTEXT (reference: tracing_helper.py propagating
  OpenTelemetry span context across task submission) — a thread-local
  ``(trace_id, span_id)`` pair that task submission stamps into specs and
  task execution restores, so spans opened inside a remote task nest
  under the submitting span;
* the CLUSTER EVENT emitter (reference: the GCS structured event log
  behind ``ray list cluster-events``) — severity-tagged records any
  process can push to the head's bounded ring buffer.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional, Tuple

from . import protocol as P
from .config import get_config
from .ids import _random_bytes

# task states (reference: src/ray/protobuf/common.proto TaskStatus —
# PENDING_ARGS_AVAIL -> PENDING_NODE_ASSIGNMENT -> SUBMITTED_TO_WORKER ->
# RUNNING -> FINISHED). Each transition is stamped by the component that
# owns it; the head folds the stamps into per-task timelines with a
# per-phase latency breakdown (head.py task_timelines).
SUBMITTED = "SUBMITTED"                        # driver: task created
PENDING_ARGS_AVAIL = "PENDING_ARGS_AVAIL"      # driver: awaiting arg refs
PENDING_NODE_ASSIGNMENT = "PENDING_NODE_ASSIGNMENT"  # driver: queued for a
#                                                worker lease / actor conn
SUBMITTED_TO_WORKER = "SUBMITTED_TO_WORKER"    # driver: pushed to a worker
FETCHING_ARGS = "FETCHING_ARGS"                # worker: resolving by-ref args
RUNNING = "RUNNING"                            # worker: user code entered
FINISHED = "FINISHED"                          # worker: user code returned
FAILED = "FAILED"                              # worker raised, OR the
#                                                owner gave up (retries
#                                                exhausted / worker lost)
CANCELLED = "CANCELLED"                        # task cancelled
RETURNED = "RETURNED"                          # driver: result landed back

# Ordering of the lifecycle for "latest state" folding
# (FINISHED/FAILED/CANCELLED share a rank — all terminal execution
# states; RETURNED ranks past them but is never *displayed* as a task
# state, matching the reference's TaskStatus surface).
STATE_RANK = {
    SUBMITTED: 0,
    PENDING_ARGS_AVAIL: 1,
    PENDING_NODE_ASSIGNMENT: 2,
    SUBMITTED_TO_WORKER: 3,
    FETCHING_ARGS: 4,
    RUNNING: 5,
    FINISHED: 6,
    FAILED: 6,
    CANCELLED: 6,
    RETURNED: 7,
}

# THE phase definition table — the single source of truth shared by the
# head fold, `derive_phase_ms`, and timeline()'s chrome-trace
# sub-slices: (phase, start_states, end_states), first present stamp
# wins in order. Durations come from MONOTONIC stamps carried alongside
# the wall timestamps (wall is display-only); cross-node stamps are
# folded into the head's monotonic timebase via the per-node clock
# offsets before this math runs, and any residual skew clamps at 0 — a
# phase is never negative.
PHASE_BOUNDS = (
    ("sched_wait", (PENDING_NODE_ASSIGNMENT,), (SUBMITTED_TO_WORKER,)),
    ("dispatch", (SUBMITTED_TO_WORKER,), (FETCHING_ARGS,)),
    ("arg_fetch", (FETCHING_ARGS,), (RUNNING,)),
    ("exec", (RUNNING,), (FINISHED, FAILED)),
    ("result_return", (FINISHED, FAILED), (RETURNED,)),
    ("e2e", (SUBMITTED,), (RETURNED,)),
)
TASK_PHASES = tuple(name for name, _, _ in PHASE_BOUNDS)

# state -> the PHASE_BOUNDS entries that have this state as a start or
# an end. The head's fold only re-derives phases a newly-stamped state
# could have completed — deriving ALL six per folded event was a
# measurable slice of the fold thread's hot loop.
PHASES_TOUCHING = {}
for _pb in PHASE_BOUNDS:
    for _st in _pb[1] + _pb[2]:
        PHASES_TOUCHING.setdefault(_st, []).append(_pb)
del _pb, _st


def _first_stamp(stamps: dict, states) -> Optional[float]:
    for s in states:
        v = stamps.get(s)
        if v is not None:
            return v
    return None


def derive_phase_ms(monos: dict) -> dict:
    """Phase durations (ms, clamped >= 0) from a ``state -> monotonic``
    stamp map in ONE timebase. Only phases whose both endpoints are
    present appear — a running task shows sched_wait/dispatch/arg_fetch
    while exec/result_return/e2e fill in as it completes."""
    out = {}
    for name, starts, ends in PHASE_BOUNDS:
        a = _first_stamp(monos, starts)
        b = _first_stamp(monos, ends)
        if a is not None and b is not None:
            out[name] = max(0.0, (b - a) * 1000.0)
    return out

# cluster-event severities (reference: src/ray/protobuf/
# export_event.proto severity levels)
INFO = "INFO"
WARNING = "WARNING"
ERROR = "ERROR"

FLUSH_PERIOD_S = 1.0


# --------------------------------------------------------- trace context
#
# The ambient span context of the CURRENT thread: (trace_id, span_id).
# tracing.span() pushes/pops it; the executor installs the task's span
# for the duration of user code; submission reads it to stamp specs.

_trace_tls = threading.local()


def new_span_id() -> str:
    # pooled entropy, not uuid4: uuid4 hits os.urandom per call (~34 us
    # on the deployment kernel) and a span id is minted PER TASK
    return _random_bytes(8).hex()


def current_trace() -> Optional[Tuple[str, str]]:
    """(trace_id, span_id) of the active span, or None."""
    return getattr(_trace_tls, "ctx", None)


def set_trace(ctx: Optional[Tuple[str, str]]) -> Optional[Tuple[str, str]]:
    """Install an ambient span context; returns the previous one so the
    caller can restore it (executor entry/exit, span scopes)."""
    prev = getattr(_trace_tls, "ctx", None)
    _trace_tls.ctx = ctx
    return prev


def submit_trace_ctx() -> Tuple[str, str]:
    """Trace context to stamp into a task spec at submission: the active
    span's (trace_id, span_id), or a fresh root trace when the submit
    site has no span — every task then belongs to SOME trace, so spans
    opened inside it share one trace_id with the task."""
    ctx = current_trace()
    if ctx is not None:
        return ctx
    return (_random_bytes(16).hex(), "")


class TaskEventBuffer:
    """Owner/executor-side event buffer with periodic batched flush.

    Event tuples are ``(task_id_hex, name, state, worker_id, node_idx,
    ts, error, trace_id, span_id, parent_span_id, mono)`` — trace ids
    carry the cross-process trace tree (empty strings when untraced) and
    ``mono`` is the recorder's ``time.monotonic()``: wall ``ts`` is
    display-only, phase durations are computed from the monotonic stamps
    (folded into the head's timebase via per-node clock offsets).
    """

    def __init__(self, head_conn, worker_id: str, node_idx: int):
        self._head = head_conn
        self._worker_id = worker_id
        self._node_idx = node_idx
        self._max = get_config().task_event_buffer_size
        # deque(maxlen): O(1) drop-oldest when the flusher falls behind.
        # append/popleft are GIL-atomic, so the hot path takes no lock
        # (a mutex here measurably dents the async-task benchmark).
        self._events: "deque" = deque(maxlen=self._max)
        self._dropped = 0  # approximate (see record)
        # serializes drain+send across the periodic flusher and sync
        # flushes — without it a sync flush can find the deque already
        # drained by a preempted flusher whose send hasn't happened yet,
        # ack an empty batch, and break the ordering barrier
        self._flush_lock = threading.Lock()
        self._stop = threading.Event()
        self._flusher: Optional[threading.Thread] = None

    def start(self):
        self._flusher = threading.Thread(target=self._flush_loop,
                                         daemon=True, name="task-events")
        self._flusher.start()

    def record(self, task_id_hex: str, name: str, state: str,
               error: str = "", trace_id: str = "", span_id: str = "",
               parent_span_id: str = "", ts: Optional[float] = None,
               mono: Optional[float] = None):
        # ts/mono default to "now"; retroactive emitters (r19 comm
        # transfer spans, stamped at completion with the measured start)
        # pass both explicitly so the interval lands where it happened
        ev = (task_id_hex, name, state, self._worker_id, self._node_idx,
              time.time() if ts is None else ts, error, trace_id,
              span_id, parent_span_id,
              time.monotonic() if mono is None else mono)
        if len(self._events) == self._max:
            self._dropped += 1  # deque(maxlen) evicts the oldest
        self._events.append(ev)

    def _flush_loop(self):
        while not self._stop.wait(FLUSH_PERIOD_S):
            self.flush()

    def flush(self, sync: bool = False):
        """Push buffered events to the head. ``sync=True`` round-trips
        (the head replies only after ingesting the batch), making the
        flush an ordering barrier: a STATE_QUERY issued afterwards — on
        any connection — observes these events. Used by timeline() in
        place of the old sleep-and-hope."""
        if not self._events and not sync:
            return
        with self._flush_lock:
            batch = []
            try:
                while True:
                    batch.append(self._events.popleft())
            except IndexError:
                pass
            dropped, self._dropped = self._dropped, 0
            try:
                if sync:
                    self._head.call(P.TASK_EVENTS, batch, dropped,
                                    timeout=30)
                else:
                    self._head.send(P.TASK_EVENTS, batch, dropped)
            except P.ConnectionLost:
                pass

    def stop(self):
        self._stop.set()
        self.flush()


# --------------------------------------------------------- cluster events


def make_cluster_event(severity: str, source: str, event_type: str,
                       message: str, *, node_idx: int = -1,
                       entity_id: str = "", extra: Optional[dict] = None
                       ) -> tuple:
    """Wire tuple for one cluster event record."""
    return (time.time(), severity, source, node_idx, entity_id,
            event_type, message, dict(extra or {}))


def wire_backpressure_fields(peer: str, frames: int, nbytes: int) -> tuple:
    """(severity, source, type, message, extra) for a wire-saturation
    event — one source of truth for the two emit paths (a CoreContext
    sending to the head vs the head appending to its own ring)."""
    return ("WARNING", "wire", "wire_backpressure",
            f"write queue to {peer} hit its bound "
            f"({frames} frames / {nbytes} bytes queued)",
            {"peer": peer, "frames": frames, "bytes": nbytes})


def emit_cluster_event(severity: str, source: str, event_type: str,
                       message: str, *, node_idx: Optional[int] = None,
                       entity_id: str = "", extra: Optional[dict] = None):
    """Fire-and-forget a cluster event from any process with a live
    CoreContext (drivers, workers, actors — e.g. the job manager).
    Head-side code appends to the ring buffer directly instead."""
    from .context import get_context_if_exists

    ctx = get_context_if_exists()
    if ctx is None:
        return
    ev = make_cluster_event(
        severity, source, event_type, message,
        node_idx=ctx.node_idx if node_idx is None else node_idx,
        entity_id=entity_id, extra=extra)
    # never block the emitter on a head outage: a ReconnectingConnection
    # parks writes for the whole reconnect window, and this is called
    # from lock-held control paths (e.g. the serve reconcile thread)
    if not ctx.head.is_attached():
        return
    try:
        ctx.head.send(P.CLUSTER_EVENT, [ev], 0)
    except P.ConnectionLost:
        pass
