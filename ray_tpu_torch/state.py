"""Cluster state API: list/summarize live entities from the head tables.

The reference's observability surface `ray.util.state`
(python/ray/util/state/api.py:782 list_tasks / list_actors / list_objects /
list_nodes / list_workers / list_placement_groups, :1009 summarize) queries
the GCS + per-node aggregators over HTTP. Here every table already lives in
the head (GCS-lite), so the API is one STATE_QUERY RPC; task rows come from
the task-event ring buffer workers flush to the head
(src/ray/core_worker/task_event_buffer.h analog in core/events.py).

Each ``list_*`` returns a list of plain dicts (the reference returns typed
rows convertible to dicts); ``filters`` are ``(key, "=", value)`` tuples
matched client-side.
"""

from __future__ import annotations

from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .core import protocol as P
from .core.context import get_context

_DEFAULT_LIMIT = 100


def _query(kind: str, limit: int) -> List[Dict[str, Any]]:
    ctx = get_context()
    (rows,) = ctx.head.call(P.STATE_QUERY, kind, limit, timeout=30)
    return rows


def _apply_filters(rows: List[Dict[str, Any]],
                   filters: Optional[Sequence[Tuple[str, str, Any]]]
                   ) -> List[Dict[str, Any]]:
    if not filters:
        return rows
    for key, op, value in filters:
        if op not in ("=", "=="):
            raise ValueError(f"unsupported filter op {op!r} (only '=')")
        rows = [r for r in rows if str(r.get(key)) == str(value)]
    return rows


def list_nodes(filters=None, limit: int = _DEFAULT_LIMIT):
    """Ref parity: ray.util.state.list_nodes (util/state/api.py:880).
    r16 adds the graceful-drain columns: ``draining`` (the node is
    being drained — excluded from new leases/placements/prefetches
    while its work migrates off) and ``drain_age_s`` (seconds since
    the drain began; past ``drain_deadline_s`` the head force-escalates
    and ``doctor_warnings()`` flags the node if it lingers)."""
    return _apply_filters(_query("nodes", limit), filters)


def list_workers(filters=None, limit: int = _DEFAULT_LIMIT):
    """Ref parity: ray.util.state.list_workers."""
    return _apply_filters(_query("workers", limit), filters)


def list_actors(filters=None, limit: int = _DEFAULT_LIMIT):
    """Ref parity: ray.util.state.list_actors (util/state/api.py:782)."""
    return _apply_filters(_query("actors", limit), filters)


def list_placement_groups(filters=None, limit: int = _DEFAULT_LIMIT):
    """Ref parity: ray.util.state.list_placement_groups."""
    return _apply_filters(_query("placement_groups", limit), filters)


def list_objects(filters=None, limit: int = _DEFAULT_LIMIT):
    """Ref parity: ray.util.state.list_objects (head object directory:
    plasma-resident + spilled objects; in-process inline values are not
    cluster-visible, matching the reference's plasma-only view)."""
    return _apply_filters(_query("objects", limit), filters)


def list_tasks(filters=None, limit: int = _DEFAULT_LIMIT):
    """Ref parity: ray.util.state.list_tasks — one folded timeline row
    per task id, newest activity first. Beyond the reference's columns,
    each row carries ``state_ts`` (state -> wall timestamp of every
    lifecycle transition: SUBMITTED, PENDING_ARGS_AVAIL,
    PENDING_NODE_ASSIGNMENT, SUBMITTED_TO_WORKER, FETCHING_ARGS,
    RUNNING, FINISHED/FAILED, RETURNED), ``phase_ms`` (derived
    sched_wait / dispatch / arg_fetch / exec / result_return / e2e
    durations, computed from monotonic stamps folded through per-node
    clock offsets and clamped >= 0), and ``straggler`` (set by the
    head's detector when the task ran past its func's robust exec
    bound)."""
    return _apply_filters(_query("tasks", limit), filters)


def list_slow_tasks(filters=None, limit: int = _DEFAULT_LIMIT):
    """Tasks the head's straggler detector flagged: each row carries the
    task/node/worker ids, ``running_ms_when_flagged``, and the phase
    breakdown known so far. A flagged task stays listed after it
    (eventually) finishes — filter on ``state`` for live ones."""
    return _apply_filters(_query("slow_tasks", limit), filters)


def list_cluster_events(filters=None, limit: int = 1000):
    """Ref parity: `ray list cluster-events` (util/state/api.py over the
    GCS event aggregator). Rows are severity-tagged structured records —
    ``{ts, severity, source, node_idx, entity_id, type, message, extra}``
    — oldest first; e.g. ``filters=[("severity", "=", "ERROR")]`` or
    ``[("type", "=", "node_dead")]``."""
    return _apply_filters(_query("cluster_events", limit), filters)


def object_plane_stats() -> Dict[str, Any]:
    """Object data-plane snapshot: directory shape (objects, bytes,
    replicated holder entries), locality-placement hit/miss counters, and
    head relay bytes (0 when all cross-host traffic rode the P2P plane)."""
    rows = _query("object_plane", 1)
    return rows[0] if rows else {}


def memory_summary(top_n: int = 0) -> Dict[str, Any]:
    """Cluster memory rollup (memory observatory; ref parity: `ray
    memory` / memory_utils.py's grouped object table + the dashboard
    memory view). Returns ``{nodes, jobs, owners, classes, dead_owner,
    top_objects, totals}``: per-node resident/spilled bytes merged with
    each node's last ``object_plane.arena_*`` heartbeat (store
    memory_stats()), per-job and per-owner resident-byte aggregates,
    the reference-class breakdown (sealed / spilled / checkpoint-held /
    prefetch-in-flight / borrow-pinned), resident bytes whose owner
    worker is dead (orphan refs), and the top-N largest objects with
    age and holder set. ``top_n`` > 0 caps the object list client-side
    (the head already caps at ``memory_summary_top_n``)."""
    rows = _query("memory_summary", 1 << 20)
    out = rows[0] if rows else {}
    if top_n > 0 and out.get("top_objects"):
        out["top_objects"] = out["top_objects"][:top_n]
    return out


def io_loop_stats() -> List[Dict[str, Any]]:
    """Head event-loop health (analog: the reference's
    instrumented_io_context / event_stats.h per-handler timing):
    events handled, busy seconds, slow-handler episodes, worst handler
    time, plus the r11 self-probe loop-lag quantiles
    (``loop_lag_ms_p50/p99/max`` — how long a fresh event waits for the
    IO thread; also published as ``head.loop_lag_ms`` gauges), the
    off-loop fold-queue health (``fold_queue_depth`` /
    ``fold_queue_drops``), the batched-lease counters
    (``lease_grant_batches`` / ``lease_grants_batched``), the head
    ring-buffer drop counters (``task_events_dropped`` /
    ``cluster_events_dropped``) so silent event-buffer overflow is
    detectable, and the head process's wire fast-path counters
    (``wire``); cluster-wide per-process wire totals are the ``wire.*``
    rows in ``metrics_summary()`` instead."""
    return _query("io_loop", 10)


def summarize_tasks(limit: int = 10_000) -> Dict[str, Any]:
    """Ref parity: ray.util.state.summarize_tasks (api.py:1009): count of
    tasks by (name, state) — extended with ``phases``: per-func-name
    p50/p95/p99/mean latency per lifecycle phase (sched_wait / dispatch /
    arg_fetch / exec / result_return / e2e), estimated from the head's
    ``task.phase_ms{func,phase}`` histograms (the `ray summary tasks`
    "where does task time go" answer), plus the detector's cumulative
    straggler / slow-node flag counts. Everything aggregates head-side
    over the full folded-timeline table (one small RPC — no fat rows
    ship just to be counted; ``limit`` is kept for API compatibility)."""
    del limit  # aggregation is head-side over all folded timelines
    summary = _query("task_summary", 1)
    s = summary[0] if summary else {}
    return {
        "total": s.get("total", 0),
        "by_func_name": s.get("by_func_name", {}),
        "phases": s.get("phases", {}),
        "stragglers_flagged": s.get("stragglers_flagged", 0),
        "slow_nodes_flagged": s.get("slow_nodes_flagged", 0),
    }


def phase_summary(funcs: Optional[Sequence[str]] = None
                  ) -> Dict[str, Dict[str, Any]]:
    """Func-scoped per-phase percentile summary — the focused slice of
    ``summarize_tasks()["phases"]`` (r14): ``{func: {phase: {count,
    mean_ms, p50_ms, p95_ms, p99_ms}}}`` for just the named funcs
    (all funcs when None). One small head RPC regardless of how many
    funcs the cluster has run; the serve controller polls this for its
    SLO-burn autoscaling signal (p99 of the replica methods' exec/e2e
    phases) without shipping the whole task summary every tick."""
    kind = "phase_summary"
    if funcs:
        kind += ":" + ",".join(funcs)
    rows = _query(kind, 1)
    return rows[0] if rows else {}


def metrics_history(names: Optional[Sequence[str]] = None,
                    window_s: Optional[float] = None) -> Dict[str, Any]:
    """Flight-recorder readback (r19): bounded time series the head
    sampled from its merged metric table every ``timeseries_sample_s``
    seconds — counters folded to per-second rates, gauges as-is,
    histograms as ``.p50/.p95/.p99`` point-estimate series. Returns
    ``{sample_s, window_s, samples_taken, series: {key: {kind, points:
    [[ts, v], ...], coarse: [[ts, v], ...]}}}`` where ``points`` is the
    fine ring (most recent ``timeseries_window_s`` at sample
    resolution) and ``coarse`` the 8:1 downsampled older tail. Series
    keys are ``name`` or ``name{tag=v,...}``. ``names`` entries may be
    exact keys, metric-name prefixes, or fnmatch globs
    (``["head.loop_lag_ms", "collective.*"]``); ``window_s`` trims the
    fine points to the trailing window. The reference gets this from an
    external Prometheus/Grafana pair scraping the dashboard agent; here
    the recent history is answerable by the head itself."""
    kind = "metrics_history"
    if names or window_s is not None:
        win = "" if window_s is None else repr(float(window_s))
        kind += f":{win}:" + ",".join(names or ())
    rows = _query(kind, 1)
    return rows[0] if rows else {}


def pipeline_stage_summary(prefix: Optional[str] = None
                           ) -> Dict[int, Dict[str, Any]]:
    """Per-pipeline-stage bubble/transfer/compute split (r15), derived
    from the same func-scoped phase histograms as ``phase_summary`` —
    stage actors submit their ops as ``{name_prefix}stage{k}.fwd`` /
    ``.bwd``, so no new head plumbing exists behind this. Returns
    ``{stage_idx: {"fwd": {...}, "bwd": {...}, "bubble_ms_p95",
    "transfer_ms_p95", "exec_ms_p95"}}`` where bubble = sched_wait (the
    stage sat idle waiting for work), transfer = arg_fetch (activation
    pull not hidden under compute) and exec = compute, each the p95 over
    that stage's ops — the per-stage attribution the MPMD paper's
    hand-rolled systems lack.

    ``prefix`` selects one ``Pipeline.name_prefix`` exactly (``""`` for
    unprefixed). Default ``None`` matches any prefix; when several
    pipelines ran under different prefixes, each (stage, op) slot keeps
    the variant with the most completed ops (pass ``prefix=`` to
    disambiguate an A/B explicitly).

    Data-parallel pipelines (r18) submit ops as
    ``{prefix}stage{k}r{rep}.fwd``; those rows land under the stage's
    ``"replicas"`` sub-dict — ``{rep: {"fwd": ..., "bwd": ...,
    "bubble_ms_p95", "transfer_ms_p95", "exec_ms_p95"}}`` — so a DP
    straggler attributes per (stage, replica), while the stage-level
    p95s aggregate over replicas (max: the gang waits for its slowest
    member)."""
    import re

    rows = phase_summary()
    stages: Dict[int, Dict[str, Any]] = {}
    pat = re.compile(r"^(.*?)stage(\d+)(?:r(\d+))?\.(fwd|bwd)$")

    def _n(phases):
        return phases.get("exec", {}).get("count", 0)

    for func, phases in rows.items():
        m = pat.match(func)
        if not m:
            continue
        pfx, k, rep, op = (m.group(1), int(m.group(2)), m.group(3),
                           m.group(4))
        if prefix is not None and pfx != prefix:
            continue
        slot = stages.setdefault(k, {})
        if rep is not None:
            slot = slot.setdefault("replicas", {}).setdefault(
                int(rep), {})
        if op not in slot or _n(phases) > _n(slot[op]):
            slot[op] = phases
    metrics = (("bubble_ms_p95", "sched_wait"),
               ("transfer_ms_p95", "arg_fetch"),
               ("exec_ms_p95", "exec"))

    def _agg(slot):
        for metric, phase in metrics:
            slot[metric] = max(
                (slot[op].get(phase, {}).get("p95_ms", 0.0)
                 for op in ("fwd", "bwd") if op in slot),
                default=0.0)

    for k, d in stages.items():
        reps = d.get("replicas", {})
        for rd in reps.values():
            _agg(rd)
        _agg(d)
        for metric, _ in metrics:
            d[metric] = max([d[metric]] + [rd[metric]
                                           for rd in reps.values()])
    return stages


def data_shuffle_summary() -> Dict[str, Any]:
    """Pipelined-exchange counters: the cluster-merged ``data.shuffle_*``
    metric rows (splits / fold+merge tasks / eagerly-freed part handles /
    arena-backpressure pauses, summed over every driver that ran an
    exchange) plus THIS process's live ``SHUFFLE_STATS`` (same counters,
    driver-local and synchronous — what the footprint tests assert
    against, since metric pushes ride a periodic channel)."""
    from ray_tpu_torch import metrics as _metrics
    from ray_tpu_torch.data.executor import SHUFFLE_STATS

    merged: Dict[str, Any] = {}
    try:
        for row in _metrics.metrics_summary():
            if str(row.get("name", "")).startswith("data.shuffle"):
                merged[row["name"]] = row.get("value", 0.0)
    except Exception:  # noqa: BLE001 — no cluster: local view only
        pass
    return {"cluster": merged, "driver": dict(SHUFFLE_STATS)}


def summarize_actors(limit: int = 10_000) -> Dict[str, Any]:
    rows = list_actors(limit=limit)
    states = Counter(r["state"] for r in rows)
    return {"total": len(rows), "by_state": dict(states)}


def summarize_objects(limit: int = 10_000) -> Dict[str, Any]:
    rows = list_objects(limit=limit)
    return {
        "total": len(rows),
        "total_size_bytes": sum(r.get("size", 0) for r in rows),
        "spilled": sum(1 for r in rows if r.get("spilled")),
    }
