"""Dashboard: HTTP JSON state API + a minimal live HTML overview.

Ref parity: the reference dashboard head (python/ray/dashboard/head.py:81)
serving the REST endpoints its UI and `ray list ...` tooling consume.
Re-design: one stdlib ThreadingHTTPServer in the driver/head process,
reading the same head tables the state API uses — no aiohttp, no separate
agent processes. Endpoints:

    /api/nodes /api/workers /api/actors /api/tasks /api/objects
    /api/placement_groups /api/io_loop
    /api/cluster_events     -> state API rows (JSON)
    /api/cluster            -> resource totals/availability
    /api/jobs               -> submitted jobs (jobs.py)
    /api/metrics            -> merged metric rows (JSON)
    /api/summary/{tasks,actors,objects} -> state summaries
    /api/timeline           -> chrome-trace events (tracing.timeline)
    /api/timeseries         -> flight-recorder series (state.metrics_history)
    /api/serve/applications -> serve deployment status rows
    /metrics                -> Prometheus text exposition
    /                       -> the SPA (dashboard_ui.py; hash-routed
                               nodes/actors/tasks/jobs/metrics/serve/
                               timeline pages, the reference's React
                               client re-done as one vanilla-JS file)

A copy of ``ray_tpu.dashboard`` on the port's runtime. ``doctor()`` boots
its own cluster without GPUs (``num_gpus=0``, as the reference's passes
``num_tpus=0``); the arena sweep matches the port's ``rtpu_*`` arenas.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import ray_tpu_torch
from ray_tpu_torch.dashboard_ui import INDEX_HTML as _INDEX_HTML


class _Handler(BaseHTTPRequestHandler):
    server_version = "ray_tpu_torch-dashboard"

    def log_message(self, *args):  # quiet
        pass

    def _send(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, obj, code: int = 200):
        self._send(code, json.dumps(obj, default=str).encode(),
                   "application/json")

    def do_GET(self):  # noqa: N802 - stdlib API
        from urllib.parse import parse_qs, urlsplit

        from ray_tpu_torch import metrics, state

        split = urlsplit(self.path)
        query = {k: v[-1] for k, v in parse_qs(split.query).items()}
        path = split.path.rstrip("/") or "/"
        try:
            if path == "/":
                self._send(200, _INDEX_HTML.encode(), "text/html")
            elif path == "/api/cluster":
                self._json({
                    "nodes": len(ray_tpu_torch.nodes()),
                    "resources_total": ray_tpu_torch.cluster_resources(),
                    "resources_available": ray_tpu_torch.available_resources(),
                })
            elif path == "/api/jobs":
                from ray_tpu_torch.jobs import JOB_MANAGER_NAME

                try:
                    mgr = ray_tpu_torch.get_actor(JOB_MANAGER_NAME)
                except ValueError:  # manager never created: no jobs yet
                    self._json([])
                else:
                    # a dead/stuck manager surfaces as 500, not as an
                    # empty-but-healthy list
                    self._json(ray_tpu_torch.get(mgr.list.remote(), timeout=10))
            elif path == "/api/metrics":
                self._json(metrics.metrics_summary())
            elif path == "/api/timeline":
                from ray_tpu_torch import tracing

                self._json(tracing.timeline())
            elif path == "/api/timeseries":
                # flight-recorder readback (r19):
                # ?names=head.loop_lag_ms,collective.*&window_s=60
                names = [n for n in
                         query.get("names", "").split(",") if n] or None
                win = query.get("window_s")
                self._json(state.metrics_history(
                    names, float(win) if win else None))
            elif path == "/api/profile":
                # on-demand flamegraph: ?worker_id=...&duration_s=1&hz=100
                # (omit worker_id to profile the driver/head process);
                # ref analog: dashboard/modules/reporter/profile_manager
                from ray_tpu_torch import profiling

                dur = float(query.get("duration_s", 1.0))
                hz = float(query.get("hz", 100.0))
                wid = query.get("worker_id")
                if wid:
                    self._json(profiling.profile_worker(
                        wid, duration_s=dur, hz=hz))
                else:
                    self._json(profiling.profile_self(
                        duration_s=dur, hz=hz))
            elif path.startswith("/api/summary/"):
                kind = path[len("/api/summary/"):]
                fn = {"tasks": state.summarize_tasks,
                      "actors": state.summarize_actors,
                      "objects": state.summarize_objects,
                      # per-pipeline-stage bubble/transfer/exec view
                      # (r15) — same head data as summary/tasks, keyed
                      # stage{k}.fwd/bwd and split per stage; DP runs
                      # (r18, stage{k}r{rep}.*) add a "replicas"
                      # sub-dict per stage so stragglers attribute per
                      # (stage, replica)
                      "pipeline": state.pipeline_stage_summary,
                      # pipelined-exchange counters (r17): cluster
                      # data.shuffle_* metric rows + the driver-local
                      # live SHUFFLE_STATS view
                      "shuffle": state.data_shuffle_summary,
                      # memory observatory (r20): per-node/-job/-owner
                      # resident bytes, arena heartbeats, class
                      # breakdown, top objects — `ray_tpu_torch memory`'s
                      # data, served over HTTP
                      "memory": state.memory_summary}.get(kind)
                if fn is None:
                    self._json({"error": f"unknown summary {kind}"}, 404)
                else:
                    self._json(fn())
            elif path == "/api/serve/applications":
                from ray_tpu_torch import serve

                rows = []
                for app, info in serve.status()["applications"].items():
                    for dn, dep in info.get("deployments", {}).items():
                        running = dep.get("replica_states", {}) \
                            .get("RUNNING", 0)
                        auto = dep.get("autoscaler") or {}
                        cold = auto.get("cold_start") or {}
                        last = auto.get("last_decision") or {}
                        rows.append({
                            "app": app, "deployment": dn,
                            "target_replicas": dep.get("target_replicas"),
                            "running_replicas": running,
                            "version": dep.get("version"),
                            "status": dep.get("status"),
                            # autoscaler introspection (r14): scale
                            # events must be debuggable from the row
                            "autoscaling": auto.get("enabled", False),
                            "desired_replicas": auto.get("desired"),
                            "queue_depth": auto.get("queue_depth", 0),
                            "last_decision":
                                (f"{last.get('direction')} "
                                 f"{last.get('from')}->{last.get('to')}: "
                                 f"{last.get('reason')}")
                                if last else "",
                            "reversals_60s": auto.get("reversals_60s", 0),
                            "cold_start_p50_s": cold.get("p50_s", 0.0),
                            "cold_start_p95_s": cold.get("p95_s", 0.0)})
                self._json(rows)
            elif path == "/metrics":
                self._send(200, metrics.export_prometheus().encode(),
                           "text/plain; version=0.0.4")
            elif path.startswith("/api/"):
                kind = path[len("/api/"):]
                fn = {
                    "nodes": state.list_nodes,
                    "workers": state.list_workers,
                    "actors": state.list_actors,
                    "tasks": state.list_tasks,
                    "objects": state.list_objects,
                    "placement_groups": state.list_placement_groups,
                    # severity-tagged structured cluster event log
                    "cluster_events": state.list_cluster_events,
                    # head event-loop lag (instrumented_io_context analog)
                    "io_loop": lambda limit=10: state.io_loop_stats(),
                    # object directory + locality/pull counters
                    "object_plane":
                        lambda limit=1: state.object_plane_stats(),
                }.get(kind)
                if fn is None:
                    self._json({"error": f"unknown endpoint {path}"}, 404)
                else:
                    self._json(fn(limit=1000))
            else:
                self._json({"error": "not found"}, 404)
        except Exception as e:  # noqa: BLE001 — surface as 500
            self._json({"error": repr(e)}, 500)


class Dashboard:
    def __init__(self, host: str = "127.0.0.1", port: int = 8265):
        self._server = ThreadingHTTPServer((host, port), _Handler)
        self.host, self.port = self._server.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "Dashboard":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="dashboard")
        self._thread.start()
        return self

    def stop(self):
        self._server.shutdown()
        self._server.server_close()


def start_dashboard(host: str = "127.0.0.1", port: int = 8265) -> Dashboard:
    """Start the dashboard against the current runtime; returns the
    handle (``.url``, ``.stop()``). Port 0 picks a free port."""
    if not ray_tpu_torch.is_initialized():
        raise RuntimeError("call ray_tpu_torch.init() before start_dashboard()")
    return Dashboard(host, port).start()


# Every GET the doctor smoke exercises — keep in sync with _Handler.
DOCTOR_ENDPOINTS = (
    "/",
    "/api/cluster", "/api/nodes", "/api/workers", "/api/actors",
    "/api/tasks", "/api/objects", "/api/placement_groups",
    "/api/io_loop", "/api/object_plane", "/api/cluster_events",
    "/api/metrics", "/api/jobs", "/api/timeline", "/api/timeseries",
    "/api/summary/tasks", "/api/summary/actors", "/api/summary/objects",
    "/api/summary/pipeline", "/api/summary/shuffle",
    "/api/summary/memory",
    "/api/serve/applications",
    "/metrics",
)


# Head IO-loop lag p99 above this is a wedged-control-plane signal
# (every lease grant / locate / state query on that host waits at least
# this long for the loop): warn, pointing at the usual culprits.
LOOP_LAG_WARN_MS = 250.0

# Head-channel reattachments above this mean clients are reconnecting
# over and over (a reconnect STORM): the head is flapping — crashing
# repeatedly, or its socket is being cut by something between — rather
# than having restarted once.
RECONNECT_STORM_THRESHOLD = 20

# A worker reported live by a re-registering agent that has not
# re-REGISTERed itself within this long is stuck (wedged interpreter, or
# its node's re-registration is looping): the node is not fully back.
REATTACH_STUCK_S = 15.0

# Speculative arg prefetch (r13): wasted = pulls aborted because their
# task was cancelled / retried elsewhere before any worker asked. Above
# this fraction of issued — over the window since the previous
# doctor_warnings() call, with a minimum sample — speculation is doing
# more harm than good: caps are misconfigured for the workload, or
# retry/cancel churn is re-placing tasks away from their prefetches.
PREFETCH_WASTE_RATIO = 0.5
PREFETCH_WASTE_MIN_ISSUED = 20
# previous poll's cumulative counters, so repeated doctor calls judge
# the WINDOW between them instead of diluting a recent regression in
# the lifetime totals (first call judges the totals)
_prefetch_last = {"issued": 0, "wasted": 0}

# Serve autoscaler flap window (r14): direction reversals inside this
# many seconds are counted against serve_flap_warn_reversals.
SERVE_FLAP_WINDOW_S = 60.0


def orphan_arena_files(shm_dir: str = "/dev/shm") -> list:
    """Arena hygiene (r19, ROADMAP 5c): ``rtpu_*`` files in /dev/shm
    that no live process has mapped — the residue of hard-killed agents
    and crashed sessions; each one pins its full arena size in shared
    memory until someone unlinks it. Detection is by scanning
    ``/proc/*/maps`` for the file path (a mapped arena always shows
    there); a file nobody maps is garbage by definition, whatever
    session named it. Returns ``[(path, size_bytes)]``."""
    import os

    try:
        names = [f for f in os.listdir(shm_dir) if f.startswith("rtpu_")]
    except OSError:
        return []
    if not names:
        return []
    candidates = {f"{shm_dir}/{n}" for n in names}
    try:
        pids = [p for p in os.listdir("/proc") if p.isdigit()]
    except OSError:
        pids = []
    for pid in pids:
        if not candidates:
            break
        try:
            with open(f"/proc/{pid}/maps") as fh:
                txt = fh.read()
        except OSError:  # raced exit / permission — treat as not-mapping
            continue
        candidates = {p for p in candidates if p not in txt}
    out = []
    for path in sorted(candidates):
        try:
            out.append((path, os.path.getsize(path)))
        except OSError:  # unlinked while we scanned
            pass
    return out


def sweep_orphan_arenas(shm_dir: str = "/dev/shm") -> list:
    """Unlink every orphaned arena: a file no live process maps is
    garbage by definition (the residue of a SIGKILL'd head/agent that
    never ran its exit unlink), and each one pins its full size in
    shared memory until someone reclaims it. A booting head calls this
    — the natural janitor, since a hard-killed predecessor on the same
    host is exactly what it replaces. Returns the swept
    ``[(path, size_bytes)]``."""
    import os

    swept = []
    for path, size in orphan_arena_files(shm_dir):
        try:
            os.unlink(path)
            swept.append((path, size))
        except OSError:  # raced another janitor
            pass
    return swept


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0 or unit == "TiB":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024.0
    return f"{n:.1f}TiB"


def _arena_growth_warnings(history: dict, cfg) -> list:
    """Leak detection off the flight recorder (memory observatory),
    factored pure so tests feed crafted history dicts: a node's
    ``object_plane.arena_used_bytes`` series that never dipped across
    the trailing ``arena_growth_warn_window_s`` AND grew by more than
    ``arena_growth_warn_min_frac`` of capacity is the signature of a
    reference leak — steady-state churn frees something eventually, so
    its fill curve dips on every free."""
    warns = []
    series = (history or {}).get("series", {})
    window = cfg.arena_growth_warn_window_s
    if window <= 0:
        return warns
    for key, s in sorted(series.items()):
        base = key.split("{", 1)[0]
        if base != "object_plane.arena_used_bytes":
            continue
        pts = list(s.get("points") or [])
        if pts:
            newest = pts[-1][0]
            pts = [p for p in pts if p[0] >= newest - window]
        if len(pts) < 4 or pts[-1][0] - pts[0][0] < 0.5 * window:
            continue  # not enough history to judge the window
        vals = [p[1] for p in pts]
        if any(b < a for a, b in zip(vals, vals[1:])):
            continue  # dipped at least once: churn, not a leak
        growth = vals[-1] - vals[0]
        cap_pts = (series.get(key.replace(
            "arena_used_bytes", "arena_capacity_bytes")) or {}) \
            .get("points") or []
        cap = cap_pts[-1][1] if cap_pts else 0.0
        if growth <= 0 or (cap > 0 and
                           growth < cfg.arena_growth_warn_min_frac * cap):
            continue
        where = key[key.find("{"):] if "{" in key else key
        warns.append(
            f"arena{where}: used bytes grew monotonically by "
            f"{_fmt_bytes(growth)} over the last "
            f"{pts[-1][0] - pts[0][0]:.0f}s without a single dip — "
            "likely an object-reference leak (refs held in a growing "
            "structure, or returns never freed); `ray_tpu_torch memory "
            "--group-by job` shows whose bytes are accumulating")
    return warns


def _memory_warnings(summary: dict, cfg) -> list:
    """Point-in-time memory health off ``state.memory_summary()``,
    factored pure for deterministic tests: near-highwater arena
    pressure, resident objects whose owner worker is dead (orphan
    refs — nothing will ever free them), and borrow-ledger deferred
    deletes stuck past the TTL (a leaked zero-copy view holding arena
    slots)."""
    warns = []
    for idx, row in sorted((summary or {}).get("nodes", {}).items(),
                           key=lambda kv: str(kv[0])):
        arena = row.get("arena") or {}
        cap = arena.get("capacity", 0)
        used = arena.get("used_bytes", 0)
        if cap and used / cap > cfg.arena_pressure_warn_frac:
            warns.append(
                f"node {idx} arena at {used / cap:.0%} of capacity "
                f"({_fmt_bytes(used)} / {_fmt_bytes(cap)}, > "
                f"{cfg.arena_pressure_warn_frac:.0%}): the next "
                "allocation burst will evict or fail — free objects, "
                "raise object_store_bytes, or spill")
        dd = arena.get("deferred_deletes", 0)
        oldest = arena.get("deferred_delete_oldest_s", 0.0)
        ttl = cfg.borrow_deferred_delete_warn_s
        if dd and ttl > 0 and oldest > ttl:
            warns.append(
                f"node {idx}: {dd:.0f} deferred delete(s) stuck behind "
                f"live zero-copy borrow views for {oldest:.0f}s (> "
                f"{ttl:g}s): a leaked view (held array / dangling "
                "reference) is pinning freed arena slots — the memory "
                "is unreclaimable until the view dies")
    do = (summary or {}).get("dead_owner") or {}
    if do.get("bytes"):
        owners = ", ".join(o[:8] for o in do.get("owners", [])[:5])
        warns.append(
            f"{do['objects']} resident object(s) "
            f"({_fmt_bytes(do['bytes'])}) owned by dead worker(s) "
            f"[{owners}]: orphan refs — their owners exited without "
            "freeing them and nothing will; `ray_tpu_torch memory --group-by "
            "owner` lists them, free them or restart the job")
    return warns


def _serve_warnings(apps_status: dict, cfg) -> list:
    """Serve-at-scale health checks (r14), factored pure so tests can
    feed crafted status dicts: flag an autoscaler that keeps reversing
    direction (flapping burns cold-starts and kills warm replicas —
    raise the hysteresis windows/cooldowns) and a deployment whose
    replica cold-start p95 blew the configured bound (weights are not
    riding the broadcast path, or scale-ups queue behind placement)."""
    warns = []
    for app, info in (apps_status or {}).items():
        for dn, dep in info.get("deployments", {}).items():
            auto = dep.get("autoscaler") or {}
            if auto.get("enabled"):
                rev = auto.get("reversals_60s", 0)
                if rev > cfg.serve_flap_warn_reversals:
                    warns.append(
                        f"serve {app}/{dn}: autoscaler flapping — {rev} "
                        f"direction reversals in the last "
                        f"{SERVE_FLAP_WINDOW_S:.0f}s "
                        f"(> {cfg.serve_flap_warn_reversals}); raise "
                        "upscale/downscale delay windows or cooldowns "
                        "(AutoscalingConfig) — every flap burns a replica "
                        "cold-start")
            # cold-start applies to manual fleets too: a fixed
            # num_replicas deployment missing the weights-by-ref path
            # is exactly the misconfiguration this flags
            cold = auto.get("cold_start") or {}
            p95 = cold.get("p95_s", 0.0)
            if cold.get("count", 0) >= 2 and \
                    p95 > cfg.serve_cold_start_p95_warn_s:
                warns.append(
                    f"serve {app}/{dn}: replica cold-start p95 "
                    f"{p95:.1f}s exceeds "
                    f"{cfg.serve_cold_start_p95_warn_s:g}s — large init "
                    "args may not be riding the weights-by-ref "
                    "broadcast path (serve_weights_by_ref_min_bytes), "
                    "or scale-ups are queueing behind placement")
    return warns


def doctor_warnings() -> list:
    """Health warnings that are not endpoint failures: nonzero
    ``task_events_dropped`` / ``cluster_events_dropped`` mean the
    bounded event buffers overflowed — the task timelines and event log
    are silently missing transitions, which blinds the phase breakdown
    and straggler detector; ``fold_queue_drops`` means whole TASK_EVENTS
    batches were shed before folding (same blindness, different
    buffer); a high ``loop_lag_ms_p99`` means the head IO loop itself
    is not keeping up — every control-plane RPC queues behind it.
    Returns human-readable warning strings (empty on a healthy
    cluster)."""
    from ray_tpu_torch import state

    warns = []
    # arena hygiene (r19): flag leaked /dev/shm arenas FIRST — this
    # check needs no live cluster (orphans matter most when nothing is
    # running and the memory is still pinned)
    orphans = orphan_arena_files()
    if orphans:
        total_mb = sum(sz for _, sz in orphans) / (1024 * 1024)
        names = ", ".join(p for p, _ in orphans[:5])
        more = f" (+{len(orphans) - 5} more)" if len(orphans) > 5 else ""
        warns.append(
            f"{len(orphans)} orphaned arena file(s) in /dev/shm pinning "
            f"{total_mb:.0f} MB: {names}{more} — left by hard-killed "
            "agents/sessions; rm them to release the shared memory")
    try:
        rows = state.io_loop_stats()
    except Exception:  # noqa: BLE001 — no cluster up: nothing to warn on
        return warns
    for row in rows:
        td = row.get("task_events_dropped", 0)
        cd = row.get("cluster_events_dropped", 0)
        fd = row.get("fold_queue_drops", 0)
        lag = row.get("loop_lag_ms_p99", 0.0)
        if td:
            warns.append(
                f"task_events_dropped={td}: task timelines are missing "
                "transitions (phase breakdowns / straggler detection are "
                "unreliable) — raise task_event_buffer_size")
        if cd:
            warns.append(
                f"cluster_events_dropped={cd}: the cluster event log "
                "overflowed and lost records — raise "
                "cluster_event_buffer_size")
        if fd:
            warns.append(
                f"fold_queue_drops={fd}: the head shed whole TASK_EVENTS "
                "batches before folding (timelines are missing tasks) — "
                "raise task_event_fold_queue_max or investigate fold-"
                "thread starvation")
        if lag > LOOP_LAG_WARN_MS:
            warns.append(
                f"loop_lag_ms_p99={lag:.0f}: the head IO loop is behind "
                f"(> {LOOP_LAG_WARN_MS:.0f}ms p99) — every control-plane "
                "RPC queues behind it; look for slow handlers "
                "(slow_events / max_handler_s in io_loop state)")
        rc = row.get("client_reconnects", 0)
        distinct = row.get("reconnect_clients", 0)
        # a STORM is many reattaches PER CLIENT, not a big cluster
        # riding out one clean restart (which costs exactly one
        # reattach per client): require both an absolute floor and a
        # >3x reattach-to-client ratio
        if rc > max(RECONNECT_STORM_THRESHOLD, 3 * max(distinct, 1)):
            warns.append(
                f"client_reconnects={rc} across {distinct} clients: "
                "reconnect storm — head channels are reattaching "
                "repeatedly; the head is flapping or its socket path "
                "is unstable (one clean restart costs one reattach "
                "per client)")
        stuck = row.get("reattach_pending_workers", 0)
        oldest = row.get("reattach_oldest_s", 0.0)
        if stuck and oldest > REATTACH_STUCK_S:
            warns.append(
                f"reattach_pending_workers={stuck} (oldest "
                f"{oldest:.0f}s): a node is stuck re-registering — "
                "workers its agent reported alive never re-REGISTERed "
                "with the restarted head; they will be ghost-swept at "
                "worker_register_timeout_s, check the node's worker "
                "logs")
    try:
        op = state.object_plane_stats()
    except Exception:  # noqa: BLE001
        op = {}
    issued = op.get("prefetch_issued", 0)
    wasted = op.get("prefetch_wasted", 0)
    d_issued = issued - _prefetch_last["issued"]
    d_wasted = wasted - _prefetch_last["wasted"]
    if d_issued < 0 or d_wasted < 0:  # head restarted: counters reset
        d_issued, d_wasted = issued, wasted
    _prefetch_last["issued"], _prefetch_last["wasted"] = issued, wasted
    if d_issued >= PREFETCH_WASTE_MIN_ISSUED and \
            d_wasted > PREFETCH_WASTE_RATIO * d_issued:
        warns.append(
            f"prefetch_wasted={d_wasted} of {d_issued} issued in this "
            f"window (>{PREFETCH_WASTE_RATIO:.0%}): arg prefetch is "
            "mostly stale speculation — task retry/cancel churn is "
            "re-placing work away from its prefetches, or "
            "arg_prefetch_max_bytes/_max_inflight are misconfigured "
            "for the workload")
    # graceful-drain health (r16): a node still `draining` past
    # drain_deadline_s means the force-escalation (drain_forced ->
    # SHUTDOWN_NODE) itself wedged — the head's housekeeping thread is
    # stuck or dead, and the node will neither finish nor be removed
    try:
        from ray_tpu_torch.core.config import get_config as _gc

        deadline_s = _gc().drain_deadline_s
        for n in state.list_nodes():
            age = n.get("drain_age_s", 0.0)
            if n.get("draining") and age > deadline_s + 5.0:
                warns.append(
                    f"node {n.get('node_idx')} stuck draining for "
                    f"{age:.0f}s (> drain_deadline_s="
                    f"{deadline_s:g}s + escalation slack): the "
                    "drain_forced escalation did not fire — head "
                    "housekeeping may be wedged; remove the node "
                    "manually or restart the head")
    except Exception:  # noqa: BLE001 — no cluster up
        pass
    # memory observatory (r20): arena pressure / dead-owner orphans /
    # deferred-delete pileup off the summary, monotone-growth leak
    # detection off the flight recorder
    try:
        from ray_tpu_torch.core.config import get_config as _gc

        cfg = _gc()
        summary = state.memory_summary()
        if summary:
            warns.extend(_memory_warnings(summary, cfg))
        hist = state.metrics_history(
            ["object_plane.arena_used_bytes",
             "object_plane.arena_capacity_bytes"])
        warns.extend(_arena_growth_warnings(hist, cfg))
    except Exception:  # noqa: BLE001 — pre-r20 head / no cluster
        pass
    # serve autoscaler health (r14): reads the controller's status
    # introspection; no serve running (or no controller) warns nothing
    try:
        from ray_tpu_torch import serve
        from ray_tpu_torch.core.config import get_config

        apps = serve.status().get("applications", {})
        if apps:
            warns.extend(_serve_warnings(apps, get_config()))
    except Exception:  # noqa: BLE001 — controller gone mid-query
        pass
    return warns


def doctor(verbose: bool = False) -> list:
    """Dashboard endpoint smoke check (``python -m ray_tpu_torch doctor``):
    boots a 2-node local cluster when no runtime is up, runs a task so
    the tables are non-trivial, then GETs every ``/api/*`` endpoint and
    reports per-endpoint status — anything but a 2xx (500s AND 404s
    from renamed/removed endpoints) is a failure, so endpoints can't
    silently rot. Returns ``[{endpoint, status, ok, error}]``."""
    import urllib.request

    booted = False
    results = []
    dash = None
    try:
        if not ray_tpu_torch.is_initialized():
            booted = True  # set BEFORE init: a partial boot must tear down
            ray_tpu_torch.init(num_cpus=2, num_gpus=0)
            from ray_tpu_torch.core.api import _head

            _head.add_node(num_cpus=1, num_gpus=0)  # a real 2-node cluster
        dash = start_dashboard(port=0)
        # populate task/object/event tables before probing
        @ray_tpu_torch.remote
        def _doctor_probe():
            return 1

        ray_tpu_torch.get([_doctor_probe.remote() for _ in range(2)], timeout=60)
        for ep in DOCTOR_ENDPOINTS:
            row = {"endpoint": ep, "status": 0, "ok": False, "error": ""}
            try:
                with urllib.request.urlopen(dash.url + ep,
                                            timeout=60) as resp:
                    row["status"] = resp.status
                    body = resp.read()
                    row["ok"] = 200 <= resp.status < 300 and bool(body)
            except urllib.error.HTTPError as e:  # non-2xx with a body
                row["status"], row["error"] = e.code, str(e)
            except Exception as e:  # noqa: BLE001 — conn refused etc.
                row["error"] = repr(e)
            if verbose:
                mark = "ok " if row["ok"] else "FAIL"
                print(f"  [{mark}] {row['status'] or '---'} {ep}"
                      + (f"  {row['error']}" if row["error"] else ""))
            results.append(row)
        if verbose:
            # programmatic callers use doctor_warnings() directly; the
            # CLI (doctor verbose=True) surfaces them here
            for warn in doctor_warnings():
                print(f"  [warn] {warn}")
    finally:
        if dash is not None:
            dash.stop()
        if booted:
            ray_tpu_torch.shutdown()
    return results
