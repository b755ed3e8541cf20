"""Tracing: chrome-trace timeline export + user span annotations.

Ref parity: ray.timeline() (python/ray/_private/state.py chrome_tracing_dump
— every task becomes a chrome trace event laid out by worker lane) and the
span annotations of ray.util.tracing (tracing_helper.py; the reference
wraps task entry/exit in OpenTelemetry spans AND propagates the caller's
span context inside the task spec, so spans nest across processes). Spans
here ride the same task-event channel the state API uses — no OpenTelemetry
dependency; the produced JSON loads in chrome://tracing / Perfetto.

Cross-task propagation: every span carries ``trace_id`` / ``span_id`` /
``parent_span_id``. Task submission stamps the caller's active span
context into the spec (core/events.py submit_trace_ctx); task execution
wraps user code in a span parented to the submit site; a ``span()``
opened inside a remote task therefore shares the submitter's trace_id
and nests under it — ``timeline()`` exposes the ids via each event's
``args`` so Perfetto (and tests) can reassemble the cross-process tree.
"""

from __future__ import annotations

import json
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

from .core import events as _ev
from .core.ids import _random_bytes
from .core import protocol as P
from .core.context import get_context

SPAN_START = "SPAN_START"
SPAN_END = "SPAN_END"

# Spans whose name starts with this land in timeline() under cat
# "comm" — the communication lanes (collective hops, object-plane
# transfers, pipeline grad all-reduce) the trace analyzer separates
# from compute when computing exposed-comm time.
COMM_PREFIX = "comm."

# Page size for the chunked task-event pull (r19): bounds the head's
# per-reply frame, replacing the old single 1M-row STATE_QUERY.
_PAGE_LIMIT = 50_000


def current_span_context() -> Optional[tuple]:
    """The active (trace_id, span_id) of this thread, if any — the task
    span inside a remote task, or the innermost open span()."""
    return _ev.current_trace()


@contextmanager
def span(name: str):
    """Annotate a code region; it appears as a lane event in timeline().

    Usable in the driver or inside tasks/actors::

        with ray_tpu_torch.tracing.span("preprocess"):
            ...

    Inside a remote task the span nests under the task's auto-span (and
    thus under the submitting span), sharing its trace_id.
    """
    ctx = get_context()
    parent = _ev.current_trace()
    trace_id = parent[0] if parent else _random_bytes(16).hex()
    parent_id = parent[1] if parent else ""
    span_id = _ev.new_span_id()
    ctx.events.record(span_id, name, SPAN_START, trace_id=trace_id,
                      span_id=span_id, parent_span_id=parent_id)
    prev = _ev.set_trace((trace_id, span_id))
    try:
        yield
    finally:
        _ev.set_trace(prev)
        ctx.events.record(span_id, name, SPAN_END, trace_id=trace_id,
                          span_id=span_id, parent_span_id=parent_id)


@contextmanager
def comm_span(name: str):
    """``span()`` for communication intervals: prefixes the name with
    ``comm.`` (so timeline() categorizes it as a comm lane event) and
    NO-OPS outside a CoreContext — collective/transfer internals call
    this from processes (node agents, teardown paths) that may not be
    attached to a cluster, and instrumentation must never be the thing
    that throws."""
    from .core.context import get_context_if_exists

    if get_context_if_exists() is None:
        yield
        return
    with span(COMM_PREFIX + name if not name.startswith(COMM_PREFIX)
              else name):
        yield


def record_comm_span(name: str, start_ts: float, end_ts: float,
                     start_mono: Optional[float] = None,
                     end_mono: Optional[float] = None):
    """Retroactively emit one comm.* SPAN_START/SPAN_END pair for an
    interval measured elsewhere (object-plane pulls stamp spans at
    completion so the fetch path carries zero tracing overhead when the
    transfer is small). No-op outside a CoreContext."""
    from .core.context import get_context_if_exists

    ctx = get_context_if_exists()
    if ctx is None:
        return
    if not name.startswith(COMM_PREFIX):
        name = COMM_PREFIX + name
    parent = _ev.current_trace()
    trace_id = parent[0] if parent else _random_bytes(16).hex()
    parent_id = parent[1] if parent else ""
    span_id = _ev.new_span_id()
    ctx.events.record(span_id, name, SPAN_START, trace_id=trace_id,
                      span_id=span_id, parent_span_id=parent_id,
                      ts=start_ts, mono=start_mono)
    ctx.events.record(span_id, name, SPAN_END, trace_id=trace_id,
                      span_id=span_id, parent_span_id=parent_id,
                      ts=end_ts, mono=end_mono)


def _pull_task_events(ctx) -> List[dict]:
    """Chunked raw-event readback (r19): page through the head's ring
    via task_events_page so no single reply frame carries the whole
    log. Falls back to the unpaged query against a pre-r19 head."""
    rows: List[dict] = []
    cursor = 0
    while True:
        try:
            (reply,) = ctx.head.call(
                P.STATE_QUERY, f"task_events_page:{cursor}",
                _PAGE_LIMIT, timeout=30)
            page = reply[0]
        except Exception:  # noqa: BLE001 — pre-r19 head: unpaged pull
            (rows,) = ctx.head.call(P.STATE_QUERY, "task_events",
                                    1_000_000, timeout=30)
            return rows
        rows.extend(page["rows"])
        cursor = page["next"]
        if page["done"] or not page["rows"]:
            return rows


def timeline(filename: Optional[str] = None) -> List[Dict[str, Any]]:
    """Cluster timeline as chrome-trace events (ref: ray.timeline()).

    Task RUNNING->FINISHED/FAILED pairs and span START->END pairs become
    complete ("X") events; pid = node, tid = worker; args carry the
    trace/span ids for traced events. Spans named ``comm.*`` (collective
    hops, object-plane transfers, pipeline grad all-reduce — r19) get
    cat "comm" so communication intervals lay in the same lanes as the
    compute that should be hiding them (``analyze()`` computes the
    exposed remainder). Every task with lifecycle stamps
    additionally gets per-phase sub-slices (cat "phase": sched_wait /
    dispatch / arg_fetch / exec / result_return) laid in the lane of the
    process that ended the phase — the "where does task time go" view,
    zoomable in Perfetto. Returns the event list; also writes JSON when
    ``filename`` is given."""
    ctx = get_context()
    # flush-ack: the head replies only after ingesting the batch, so the
    # STATE_QUERY below is ordered after ingestion (no sleep, no race —
    # except for OTHER workers' buffers, which flush on their own 1s
    # period as in the reference).
    ctx.events.flush(sync=True)
    rows = _pull_task_events(ctx)
    open_at: Dict[str, dict] = {}
    events: List[Dict[str, Any]] = []
    # per-task first-occurrence of each lifecycle state, for sub-slices
    lifecycle: Dict[str, Dict[str, dict]] = {}
    for r in sorted(rows, key=lambda r: r["ts"]):
        state = r["state"]
        if state in _ev.STATE_RANK:
            lifecycle.setdefault(r["task_id"], {}).setdefault(state, r)
        if state in ("RUNNING", SPAN_START):
            open_at[r["task_id"]] = r
        elif state in ("FINISHED", "FAILED", SPAN_END):
            start = open_at.pop(r["task_id"], None)
            if start is None:
                continue
            args: Dict[str, Any] = {}
            if state == "FAILED":
                args["error"] = r["error"]
            if start.get("trace_id"):
                args["trace_id"] = start["trace_id"]
                args["span_id"] = start["span_id"]
                args["parent_span_id"] = start["parent_span_id"]
            if state == SPAN_END:
                cat = "comm" if r["name"].startswith(COMM_PREFIX) \
                    else "span"
            else:
                cat = "task"
            events.append({
                "name": r["name"],
                "cat": cat,
                "ph": "X",
                "ts": start["ts"] * 1e6,           # chrome wants usec
                "dur": max(r["ts"] - start["ts"], 0) * 1e6,
                "pid": f"node{start['node_idx']}",
                "tid": f"worker:{start['worker_id'][:8]}",
                "args": args,
            })
    # per-phase sub-slices from the shared events.PHASE_BOUNDS table
    # (wall-clock laid out for display; the exact monotonic-clock
    # durations live in list_tasks()'s phase_ms). e2e is skipped — it
    # would just shadow the whole row.
    for tid, states in lifecycle.items():
        for phase, a_states, b_states in _ev.PHASE_BOUNDS:
            if phase == "e2e":
                continue
            a = next((states[s] for s in a_states if s in states), None)
            b = next((states[s] for s in b_states if s in states), None)
            if a is None or b is None:
                continue
            events.append({
                "name": f"{b['name']}:{phase}",
                "cat": "phase",
                "ph": "X",
                "ts": a["ts"] * 1e6,
                "dur": max(b["ts"] - a["ts"], 0) * 1e6,
                # the lane of the process that ENDED the phase (the
                # worker for dispatch/arg_fetch/exec, the driver for
                # sched_wait/result_return)
                "pid": f"node{b['node_idx']}",
                "tid": f"worker:{b['worker_id'][:8]}",
                "args": {"task_id": tid, "phase": phase},
            })
    if filename:
        with open(filename, "w") as f:
            json.dump(events, f)
    return events


def analyze(events: Optional[List[Dict[str, Any]]] = None,
            filename: Optional[str] = None) -> Dict[str, Any]:
    """Comm-aware trace analysis (r19): per-lane utilization,
    exposed-comm time (communication not hidden under compute), per-
    (stage, replica) bubble breakdown and the critical path — computed
    from ``timeline()`` events (pulled fresh when ``events`` is None).
    See :mod:`ray_tpu_torch.trace_analysis` for the full result shape; the
    ``ray_tpu analyze`` CLI renders it."""
    from . import trace_analysis

    if events is None:
        events = timeline()
    report = trace_analysis.analyze(events)
    if filename:
        with open(filename, "w") as f:
            json.dump(report, f, indent=2)
    return report


def dump_flight_record(filename: Optional[str] = None,
                       names: Optional[List[str]] = None,
                       window_s: Optional[float] = None) -> Dict[str, Any]:
    """Flight-recorder snapshot (r19): the head's bounded metric time
    series (``state.metrics_history``), optionally written to JSON so a
    bench can correlate wall-clock trace events with counter movement
    post-hoc (series points are wall-clock stamped, same timebase as
    ``timeline()``'s ``ts``)."""
    from . import state

    record = state.metrics_history(names, window_s)
    if filename:
        with open(filename, "w") as f:
            json.dump(record, f)
    return record
