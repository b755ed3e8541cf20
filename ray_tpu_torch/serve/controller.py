"""Serve controller: singleton actor reconciling target vs actual state.

Ref analogs: python/ray/serve/controller.py:82 (ServeController),
_private/deployment_state.py:1140 (DeploymentState reconciler),
_private/application_state.py, _private/autoscaling_policy.py:106.

Re-design: one actor, one background reconcile thread, non-blocking
polling of replica ping/metrics futures via ``wait(timeout=0)`` — no
asyncio control loop, no long-poll broker. Routers poll the controller's
monotonically increasing ``routing_version`` and refresh membership on
change (cheap: a version int + a handle list per deployment).

r14 (serve at production scale): the autoscaler fuses queue depth
(router-reported in-flight counts piggybacked on snapshot refreshes +
replica-reported ongoing), the head's per-func phase-histogram p99
(latency SLO burn), and ``node.*`` gauges (downscale veto on hot nodes),
with per-direction hysteresis windows AND cooldowns so it never flaps;
every decision is emitted as a rate-limited ``serve_autoscale`` cluster
event. Deployment weights travel by reference: the controller pre-warms
them onto nodes at scale-up decision time (``OBJECT_WARM`` -> the r13
prefetch machinery), so N concurrent replica cold-starts form the r9
cooperative broadcast tree instead of N root streams. All control-plane
polling (node table, phase summary) is rate-limited to ~1/s inside the
reconcile thread — nothing here rides the per-request hot path.
"""

from __future__ import annotations

import hashlib
import math
import threading
import time
import traceback
from collections import deque
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.core.serialization import dumps

from .config import AutoscalingConfig, DeploymentConfig

CONTROLLER_NAME = "SERVE_CONTROLLER"

STARTING = "STARTING"
RUNNING = "RUNNING"
STOPPING = "STOPPING"

# deployment-level statuses (ref: serve/_private/common.py DeploymentStatus)
DEPLOY_UPDATING = "UPDATING"
DEPLOY_HEALTHY = "HEALTHY"
DEPLOY_UNHEALTHY = "UNHEALTHY"

_TICK_S = 0.05
_MAX_CONSECUTIVE_START_FAILURES = 3
# router-reported queue depths older than this are a dead/idle router's
# leftovers, not live demand
_ROUTER_DEPTH_TTL_S = 3.0
# node-table / phase-summary poll period (the autoscaler's slow signals)
_SIGNAL_POLL_S = 1.0
# min gap between serve_autoscale cluster events per deployment
_DECISION_EVENT_MIN_GAP_S = 0.5
# min gap between weight pre-warm sweeps per deployment
_PREWARM_MIN_GAP_S = 5.0
# the replica entrypoints whose phase histograms feed the SLO signal
_SLO_FUNCS = ("handle_request", "start_stream")
# SLO-burn look-back: p99 is computed over the requests of the last
# window only (delta of the head's cumulative bucket vectors between
# snapshots), not the lifetime distribution — an all-time percentile
# stops moving once history dwarfs the recent past, so a long-lived
# cluster would neither trip on fresh degradation nor recover after a
# bad episode (lifetime p99 stuck over budget pins the fleet at max)
_SLO_WINDOW_S = 30.0


def _windowed_p99(snaps: "deque", now: float) -> Optional[float]:
    """p99 over the requests between the oldest and newest cumulative
    bucket snapshots in ``snaps`` ([(ts, [buckets..., +inf, sum, n],
    boundaries)], window-pruned by the poller). None when the window
    holds no new samples — no signal, not 'healthy'."""
    if len(snaps) < 2:
        return None
    if now - snaps[-1][0] > _SLO_WINDOW_S:
        return None  # newest snapshot predates the window: stale signal
    (_, v0, _), (_, v1, bounds) = snaps[0], snaps[-1]
    if len(v0) != len(v1):
        return None  # boundary config changed between snapshots
    delta = [v1[i] - v0[i] for i in range(len(v1))]
    if delta[-1] <= 0:
        return None
    from ray_tpu_torch.core.head import _hist_quantile
    return _hist_quantile(bounds, delta, 0.99)


def _record_decision(dep: "_DeploymentState", direction: str, frm: int,
                     to: int, reason: str, sig: dict, now: float) -> dict:
    """Stamp a fired scale decision onto the deployment state (module
    level so the policy stays callable with self=None in unit tests)."""
    dep.last_scale_ts = now
    dep.scale_events.append((now, direction))
    decision = {"ts": time.time(), "direction": direction,
                "from": frm, "to": to, "reason": reason,
                "queue_depth": sig.get("queue_depth", 0),
                "p99_ms": sig.get("p99_ms")}
    dep.last_decision = decision
    return decision


class _Replica:
    def __init__(self, replica_id: str, handle, version: str):
        self.replica_id = replica_id
        self.handle = handle
        self.version = version
        self.state = STARTING
        self.started_at = time.monotonic()
        self.ping_ref = None
        self.metrics_ref = None
        self.ongoing = 0
        self.last_seen = time.monotonic()
        self.node_idx = -1


class _DeploymentState:
    def __init__(self, app: str, name: str, payload: bytes,
                 config: DeploymentConfig, version: str,
                 weights_refs: Optional[list] = None):
        self.app = app
        self.name = name
        self.payload = payload
        self.config = config
        self.version = version
        self.replicas: List[_Replica] = []
        self.status = DEPLOY_UPDATING
        self.message = ""
        self.start_failures = 0
        self.next_replica_idx = 0
        # by-ref init args (r14): live ObjectRefs held HERE so the
        # weights outlive the driver that called serve.run() — the
        # payload only carries the (pickled) refs; replicas fetch
        # through the object plane and the controller pre-warms these
        # at scale-up decision time
        self.weights_refs: list = list(weights_refs or [])
        # autoscaling state
        self.autoscale_desired = config.num_replicas
        self._above_since: Optional[float] = None
        self._below_since: Optional[float] = None
        self.last_scale_ts = -1e18
        self.last_decision: Optional[dict] = None
        # (monotonic, direction) of recent scale events — flap detection
        self.scale_events: deque = deque(maxlen=64)
        self._last_event_ts = -1e18
        self._last_prewarm_ts = -1e18
        # router_id -> (monotonic, {replica_id: inflight}) piggybacked
        # on get_routing_snapshot; TTL'd, summed into the queue signal
        self.router_depths: Dict[str, tuple] = {}
        # (monotonic, cold_start_s, fleet_size_at_start) per replica
        # that reached RUNNING — feeds status()/doctor cold-start p50/p95
        self.cold_starts: deque = deque(maxlen=256)
        # (monotonic, fused load) per policy evaluation: the downscale
        # side reads a windowed AVERAGE of these (reference: the
        # look-back averaging in autoscaling_policy) so one transient
        # in-flight spike cannot keep restarting the below-window
        self.load_hist: deque = deque(maxlen=2048)

    # ----- helpers

    def target_replicas(self) -> int:
        if self.config.autoscaling_config is not None:
            return self.autoscale_desired
        return self.config.num_replicas

    def running(self, version: Optional[str] = None) -> List[_Replica]:
        return [r for r in self.replicas
                if r.state == RUNNING and
                (version is None or r.version == version)]

    def queue_depth(self, now: float) -> int:
        """Fused router-reported demand: queued + executing requests
        across every router process, TTL'd so dead routers decay."""
        total = 0
        for key in list(self.router_depths):
            ts, counts = self.router_depths[key]
            if now - ts > _ROUTER_DEPTH_TTL_S:
                del self.router_depths[key]
                continue
            total += sum(counts.values())
        return total

    def cold_start_quantiles(self) -> Dict[str, float]:
        vals = sorted(cs for _, cs, _ in self.cold_starts)
        if not vals:
            return {"count": 0, "p50_s": 0.0, "p95_s": 0.0}

        def pct(p):
            return vals[min(len(vals) - 1, int(p / 100 * len(vals)))]
        return {"count": len(vals), "p50_s": round(pct(50), 3),
                "p95_s": round(pct(95), 3)}

    def reversals(self, now: float, window_s: float = 60.0) -> int:
        """Direction changes among scale events inside the window."""
        dirs = [d for ts, d in self.scale_events if now - ts <= window_s]
        return sum(1 for a, b in zip(dirs, dirs[1:]) if a != b)

    def windowed_load(self, now: float, window_s: float) -> float:
        """Mean fused load over evaluations in the last ``window_s``
        seconds (window 0 degrades to the newest sample)."""
        vals = [ld for ts, ld in self.load_hist if ts >= now - window_s]
        if not vals:
            return float(self.load_hist[-1][1]) if self.load_hist else 0.0
        return sum(vals) / len(vals)


class ServeController:
    """The singleton controller actor (create with max_concurrency >= 4)."""

    def __init__(self):
        self._lock = threading.RLock()
        # app -> {"route_prefix", "ingress", "deployments": {name: state}}
        self._apps: Dict[str, dict] = {}
        self._routing_version = 0
        self._shutdown = False
        # every replica drain ever spawned (scale-downs, rolling updates,
        # deletes) — shutdown_serve must join ALL of them, not just the
        # ones it starts, or an in-flight drain dies with the controller
        # and leaks the replica's worker. Pruned of finished threads as
        # new drains start.
        self._drains: List[threading.Thread] = []
        # slow-signal cache (1/s polls off the reconcile thread): the
        # detector-flagged node set, per-node cpu gauges, and the
        # per-func phase summary for the SLO-burn signal
        self._slow_nodes: frozenset = frozenset()
        self._node_cpu: Dict[int, float] = {}
        self._phases: Dict[str, dict] = {}
        # (func, phase) -> deque[(ts, cumulative buckets, boundaries)]
        # for the windowed SLO p99 (see _windowed_p99)
        self._phase_snaps: Dict[tuple, deque] = {}
        self._last_signal_poll = -1e18
        self._decisions_total = 0
        self._thread = threading.Thread(target=self._control_loop,
                                        daemon=True, name="serve-reconcile")
        self._thread.start()

    # ================================================= declarative API

    def deploy_app(self, app_name: str, route_prefix: Optional[str],
                   ingress: str, deployments: List[dict]):
        """Set the target state for one application (idempotent).

        ``deployments``: [{name, payload, config[, weights_refs]}] —
        payload is the pickled replica spec (callable + init args with
        HandleMarkers; large array init args arrive as ObjectRefs with
        the live refs duplicated in ``weights_refs`` so the controller
        keeps them alive and can pre-warm them).
        """
        with self._lock:
            app = self._apps.setdefault(
                app_name, {"route_prefix": None, "ingress": ingress,
                           "deployments": {}})
            app["route_prefix"] = route_prefix
            app["ingress"] = ingress
            new_names = set()
            for d in deployments:
                name, payload, config = d["name"], d["payload"], d["config"]
                weights = d.get("weights_refs")
                version = config.version or \
                    hashlib.sha1(payload).hexdigest()[:12]
                new_names.add(name)
                cur = app["deployments"].get(name)
                if cur is None:
                    app["deployments"][name] = _DeploymentState(
                        app_name, name, payload, config, version, weights)
                else:
                    cur.payload = payload
                    cur.config = config
                    cur.version = version
                    cur.status = DEPLOY_UPDATING
                    cur.start_failures = 0
                    cur.weights_refs = list(weights or [])
                    if config.autoscaling_config is not None:
                        lo = config.autoscaling_config.min_replicas
                        hi = config.autoscaling_config.max_replicas
                        cur.autoscale_desired = min(
                            max(cur.autoscale_desired, lo), hi)
                    else:
                        cur.autoscale_desired = config.num_replicas
            # deployments removed from the app spec are torn down
            for name in list(app["deployments"]):
                if name not in new_names:
                    self._teardown_deployment(app["deployments"].pop(name))
            self._routing_version += 1
        return True

    def delete_app(self, app_name: str):
        with self._lock:
            app = self._apps.pop(app_name, None)
            if app is None:
                return False
            for dep in app["deployments"].values():
                self._teardown_deployment(dep)
            self._routing_version += 1
        return True

    def shutdown_serve(self):
        with self._lock:
            for name in list(self._apps):
                app = self._apps.pop(name)
                for dep in app["deployments"].values():
                    self._teardown_deployment(dep)
            self._shutdown = True
            self._routing_version += 1
            drains = list(self._drains)
        # The caller kills this controller actor right after this returns,
        # which would orphan any replica whose drain is still in flight —
        # the replica's worker (and lease) then leaks forever. Wait for
        # every replica to actually die before reporting shutdown done.
        for t in drains:
            t.join(timeout=30)
        return True

    def _teardown_deployment(self, dep: _DeploymentState):
        for r in dep.replicas:
            self._stop_replica(dep, r, graceful=True)
        dep.replicas = []

    # ================================================= router-facing API

    def routing_version(self) -> int:
        return self._routing_version

    def get_routing_snapshot(self, app_name: str, deployment: str,
                             router_id: Optional[str] = None,
                             inflight: Optional[dict] = None):
        """(version, [(replica_id, handle, node_idx)],
        max_concurrent_queries, [slow_node_idx]).

        ``router_id``/``inflight`` piggyback the calling router's
        per-replica in-flight counts (its live queue view) into the
        autoscaler's queue-depth signal — the refresh the router makes
        anyway doubles as its metrics report, so the controller stays
        off the per-request path."""
        with self._lock:
            app = self._apps.get(app_name)
            dep = app["deployments"].get(deployment) if app else None
            if dep is None:
                return self._routing_version, [], 1, []
            if router_id is not None:
                dep.router_depths[router_id] = (
                    time.monotonic(), dict(inflight or {}))
            return (self._routing_version,
                    [(r.replica_id, r.handle, r.node_idx)
                     for r in dep.running()],
                    dep.config.max_concurrent_queries,
                    sorted(self._slow_nodes))

    def get_routes(self) -> Dict[str, str]:
        """route_prefix -> app name (for the HTTP proxy)."""
        with self._lock:
            return {app["route_prefix"]: name
                    for name, app in self._apps.items()
                    if app["route_prefix"]}

    def get_ingress(self, app_name: str) -> Optional[str]:
        with self._lock:
            app = self._apps.get(app_name)
            return app["ingress"] if app else None

    def status(self) -> dict:
        now = time.monotonic()
        with self._lock:
            out = {}
            for name, app in self._apps.items():
                deps = {}
                statuses = []
                for dn, dep in app["deployments"].items():
                    counts: Dict[str, int] = {}
                    for r in dep.replicas:
                        counts[r.state] = counts.get(r.state, 0) + 1
                    row = {"status": dep.status,
                           "message": dep.message,
                           "replica_states": counts,
                           "target_replicas": dep.target_replicas(),
                           "version": dep.version}
                    # autoscaler introspection (r14): desired vs
                    # running, the last decision + its reason, queue
                    # depth, recent direction flips, cold-start
                    # percentiles — everything `serve status` / the
                    # dashboard / doctor need to debug a scale event
                    row["autoscaler"] = {
                        "enabled":
                            dep.config.autoscaling_config is not None,
                        "desired": dep.target_replicas(),
                        "running": counts.get(RUNNING, 0),
                        "queue_depth": dep.queue_depth(now),
                        "last_decision": dict(dep.last_decision)
                        if dep.last_decision else None,
                        "reversals_60s": dep.reversals(now),
                        "cold_start": dep.cold_start_quantiles(),
                        "weights_by_ref": len(dep.weights_refs),
                    }
                    deps[dn] = row
                    statuses.append(dep.status)
                if any(s == DEPLOY_UNHEALTHY for s in statuses):
                    app_status = "UNHEALTHY"
                elif all(s == DEPLOY_HEALTHY for s in statuses) and statuses:
                    app_status = "RUNNING"
                else:
                    app_status = "DEPLOYING"
                out[name] = {"status": app_status,
                             "route_prefix": app["route_prefix"],
                             "deployments": deps}
            return out

    # ================================================= reconcile loop

    def _control_loop(self):
        while not self._shutdown:
            try:
                self._poll_signals()
                with self._lock:
                    deps = [dep for app in self._apps.values()
                            for dep in app["deployments"].values()]
                for dep in deps:
                    self._reconcile_deployment(dep)
            except Exception:
                traceback.print_exc()
            time.sleep(_TICK_S)

    def _poll_signals(self):
        """Refresh the slow autoscaling signals (~1/s, reconcile thread
        only): detector-flagged nodes + node.cpu gauges from the nodes
        state rows, and the per-func phase summary (p99) for the SLO
        signal. Failures keep the stale cache — scaling on old signals
        beats crashing the reconciler."""
        now = time.monotonic()
        if now - self._last_signal_poll < _SIGNAL_POLL_S:
            return
        self._last_signal_poll = now
        from ray_tpu_torch import state
        from ray_tpu_torch.core.context import get_context_if_exists

        # never park the reconcile thread on a head outage: a state.*
        # call through a detached ReconnectingConnection blocks for the
        # whole reconnect window (up to head_reconnect_timeout_s), and
        # no replica restart or scale decision would run meanwhile.
        # Keep the stale signal cache instead (same guard as
        # warm_object / emit_cluster_event).
        ctx = get_context_if_exists()
        if ctx is None or not ctx.head.is_attached():
            return

        try:
            slow, cpu = set(), {}
            for n in state.list_nodes():
                if not n.get("alive", True):
                    continue
                if n.get("slow"):
                    slow.add(n["node_idx"])
                c = (n.get("telemetry") or {}).get("node.cpu_percent")
                if c is not None:
                    cpu[n["node_idx"]] = float(c)
            with self._lock:
                self._slow_nodes = frozenset(slow)
                self._node_cpu = cpu
        except Exception:  # noqa: BLE001 — head unreachable: keep stale
            pass
        with self._lock:
            slo_active = any(
                dep.config.autoscaling_config is not None
                and dep.config.autoscaling_config.latency_slo_ms > 0
                for app in self._apps.values()
                for dep in app["deployments"].values())
        if not slo_active:
            return  # nobody reads the phase summary: skip the head RPC
        try:
            self._phases = state.phase_summary(_SLO_FUNCS)
        except Exception:  # noqa: BLE001
            return
        # fold this poll's cumulative bucket vectors into the per-
        # (func, phase) snapshot windows the SLO signal deltas over
        for func, phases in self._phases.items():
            for phase, row in phases.items():
                buckets = row.get("buckets")
                if buckets is None:
                    continue  # pre-r14.1 head: lifetime-only summary
                snaps = self._phase_snaps.setdefault(
                    (func, phase), deque())
                if snaps and (len(snaps[-1][1]) != len(buckets)
                              or buckets[-1] < snaps[-1][1][-1]
                              # polling gap wider than the window (SLO
                              # was disabled for a while): the old
                              # baseline would delta a long-dead
                              # episode into a fresh burn
                              or now - snaps[-1][0] > _SLO_WINDOW_S):
                    snaps.clear()
                snaps.append((now, buckets, row.get("boundaries")))
                # keep one snapshot at/behind the window start as the
                # delta baseline so the window spans _SLO_WINDOW_S
                while len(snaps) > 2 and snaps[1][0] <= now - _SLO_WINDOW_S:
                    snaps.popleft()

    def _reconcile_deployment(self, dep: _DeploymentState):
        with self._lock:
            # The dep was snapshotted outside the lock; shutdown_serve or
            # delete_app may have torn it down in the window. Reconciling a
            # stale dep would resurrect replicas nobody tracks or drains.
            if self._shutdown:
                return
            app = self._apps.get(dep.app)
            if app is None or app["deployments"].get(dep.name) is not dep:
                return
            self._check_starting(dep)
            self._check_health_and_autoscale(dep)
            self._scale(dep)
            self._update_status(dep)

    # ----- phase 1: STARTING -> RUNNING on successful ping

    def _check_starting(self, dep: _DeploymentState):
        for r in list(dep.replicas):
            if r.state != STARTING:
                continue
            if r.ping_ref is None:
                r.ping_ref = r.handle.ping.remote()
            done, _ = ray_tpu_torch.wait([r.ping_ref], num_returns=1, timeout=0,
                                   fetch_local=False)
            if not done:
                if time.monotonic() - r.started_at > \
                        dep.config.health_check_timeout_s:
                    self._replica_failed(
                        dep, r, "replica start timed out")
                continue
            try:
                pong = ray_tpu_torch.get(r.ping_ref, timeout=1)
            except Exception as e:  # noqa: BLE001 — ctor/ping failure
                self._replica_failed(dep, r, repr(e))
                continue
            if isinstance(pong, dict):
                r.node_idx = pong.get("node_idx", -1)
            r.ping_ref = None
            r.state = RUNNING
            dep.start_failures = 0
            now = time.monotonic()
            # cold-start sample: placement + ctor + weights fetch
            dep.cold_starts.append(
                (now, now - r.started_at, len(dep.replicas)))
            self._routing_version += 1

    def _replica_failed(self, dep: _DeploymentState, r: _Replica, msg: str):
        dep.replicas.remove(r)
        try:
            ray_tpu_torch.kill(r.handle)
        except Exception:
            pass
        dep.start_failures += 1
        dep.message = msg
        if dep.start_failures >= _MAX_CONSECUTIVE_START_FAILURES:
            dep.status = DEPLOY_UNHEALTHY

    # ----- phase 2: health checks + autoscaling metrics on RUNNING

    def _check_health_and_autoscale(self, dep: _DeploymentState):
        now = time.monotonic()
        total_ongoing = 0
        n_reporting = 0
        for r in list(dep.replicas):
            if r.state != RUNNING:
                continue
            if r.metrics_ref is None:
                if now - r.last_seen >= dep.config.health_check_period_s:
                    r.metrics_ref = r.handle.metrics.remote()
            else:
                done, _ = ray_tpu_torch.wait([r.metrics_ref], num_returns=1,
                                       timeout=0, fetch_local=False)
                if done:
                    try:
                        m = ray_tpu_torch.get(r.metrics_ref, timeout=1)
                        r.ongoing = m.num_ongoing_requests
                        if getattr(m, "node_idx", -1) >= 0:
                            r.node_idx = m.node_idx
                        r.last_seen = now
                    except Exception as e:  # noqa: BLE001 — replica died
                        dep.replicas.remove(r)
                        dep.message = f"replica died: {e!r}"
                        self._routing_version += 1
                        try:
                            ray_tpu_torch.kill(r.handle)
                        except Exception:
                            pass
                        continue
                    r.metrics_ref = None
                elif now - r.last_seen > dep.config.health_check_timeout_s:
                    dep.replicas.remove(r)
                    dep.message = "replica health check timed out"
                    self._routing_version += 1
                    try:
                        ray_tpu_torch.kill(r.handle)
                    except Exception:
                        pass
                    continue
            total_ongoing += r.ongoing
            n_reporting += 1
        cfg = dep.config.autoscaling_config
        if cfg is not None and n_reporting:
            decision = self._autoscale(
                dep, cfg, total_ongoing, now,
                signals=self._gather_signals(dep, cfg, now))
            if decision is not None:
                self._on_scale_decision(dep, decision, now)

    def _gather_signals(self, dep: _DeploymentState,
                        cfg: AutoscalingConfig, now: float) -> dict:
        """Assemble the fused-signal dict for one policy evaluation
        (caller holds the lock; everything here reads cached polls)."""
        sig = {"queue_depth": dep.queue_depth(now)}
        if cfg.latency_slo_ms > 0:
            p99 = None
            poll_now = self._last_signal_poll
            for func in _SLO_FUNCS:
                snaps = self._phase_snaps.get((func, cfg.slo_phase))
                w = _windowed_p99(snaps, poll_now) if snaps else None
                if w is None:
                    # no windowed delta yet (fresh controller, pre-r14.1
                    # head, or no traffic in the window): fall back to
                    # the lifetime percentile only while the summary has
                    # a single snapshot — beyond that, an empty window
                    # means no recent requests, which is not a burn
                    row = self._phases.get(func, {}).get(cfg.slo_phase)
                    if row and len(snaps or ()) < 2:
                        w = row["p99_ms"]
                if w is not None:
                    p99 = max(p99 or 0.0, w)
            sig["p99_ms"] = p99
        if cfg.downscale_cpu_block_pct > 0:
            cpus = [self._node_cpu.get(r.node_idx)
                    for r in dep.replicas if r.node_idx >= 0]
            cpus = [c for c in cpus if c is not None]
            sig["nodes_hot"] = bool(cpus) and \
                min(cpus) >= cfg.downscale_cpu_block_pct
        return sig

    def _autoscale(self, dep: _DeploymentState, cfg: AutoscalingConfig,
                   total_ongoing: int, now: float,
                   signals: Optional[dict] = None) -> Optional[dict]:
        """One policy evaluation. Pure deployment-state math (no self
        access — unit-testable with self=None): fuses the signals into
        a desired replica count, applies hysteresis windows + per-
        direction cooldowns + min/max clamps, and mutates
        ``dep.autoscale_desired`` when a scale decision fires.
        Returns the decision record (or None).

        Signal asymmetry (reference: look-back averaging in
        autoscaling_policy): the UP side reads the instantaneous fused
        load (react to a surge within one policy period), the DOWN side
        reads the mean load over the last ``downscale_delay_s`` — a
        single transient in-flight spike must not keep restarting the
        below-window and pin a drained fleet at its peak forever."""
        sig = signals or {}
        load = max(total_ongoing, sig.get("queue_depth", 0))
        dep.load_hist.append((now, load))
        target = cfg.target_num_ongoing_requests_per_replica
        desired = math.ceil(cfg.smoothing_factor * load / target)
        reason = (f"load={load} (ongoing={total_ongoing}, "
                  f"queue={sig.get('queue_depth', 0)})")
        p99 = sig.get("p99_ms")
        burning = cfg.latency_slo_ms > 0 and p99 is not None and \
            p99 > cfg.latency_slo_ms
        if burning and dep.autoscale_desired + 1 > desired:
            # SLO burn: latency over budget scales up one step per
            # satisfied upscale window even when concurrency alone
            # would not (slower requests, not more of them)
            desired = dep.autoscale_desired + 1
            reason = (f"slo_burn p99={p99:.0f}ms > "
                      f"{cfg.latency_slo_ms:g}ms ({cfg.slo_phase})")
        desired = min(max(desired, cfg.min_replicas), cfg.max_replicas)
        cur = dep.autoscale_desired
        avg = dep.windowed_load(now, cfg.downscale_delay_s)
        down_to = min(max(math.ceil(cfg.smoothing_factor * avg / target),
                          cfg.min_replicas), cfg.max_replicas)
        if desired > cur:
            dep._below_since = None
            if dep._above_since is None:
                dep._above_since = now
            if now - dep._above_since >= cfg.upscale_delay_s and \
                    now - dep.last_scale_ts >= cfg.upscale_cooldown_s:
                dep.autoscale_desired = desired
                dep._above_since = None
                return _record_decision(dep, "up", cur, desired,
                                        reason, sig, now)
        elif down_to < cur:
            dep._above_since = None
            if sig.get("nodes_hot") or burning:
                # every hosting node pegged (shrinking just moves the
                # queue) or the latency SLO is burning (fewer replicas
                # cannot help it): hold, and restart the downscale
                # window so the veto also delays the eventual shrink
                dep._below_since = None
                return None
            if dep._below_since is None:
                dep._below_since = now
            if now - dep._below_since >= cfg.downscale_delay_s and \
                    now - dep.last_scale_ts >= cfg.downscale_cooldown_s:
                dep.autoscale_desired = down_to
                dep._below_since = None
                reason = (f"avg_load={avg:.1f}/{cfg.downscale_delay_s:g}s"
                          f" (ongoing={total_ongoing}, "
                          f"queue={sig.get('queue_depth', 0)})")
                return _record_decision(dep, "down", cur, down_to,
                                        reason, sig, now)
        else:
            dep._above_since = None
            dep._below_since = None
        return None

    def _on_scale_decision(self, dep: _DeploymentState, decision: dict,
                           now: float):
        """Side effects of a scale decision (caller holds the lock):
        pre-warm the broadcast for scale-ups BEFORE any replica is
        placed, and emit the rate-limited cluster event."""
        self._decisions_total += 1
        if decision["direction"] == "up":
            self._prewarm(dep, now, force=True)
        if now - dep._last_event_ts >= _DECISION_EVENT_MIN_GAP_S:
            dep._last_event_ts = now
            from ray_tpu_torch.core.events import emit_cluster_event

            emit_cluster_event(
                "INFO", "serve", "serve_autoscale",
                f"{dep.app}/{dep.name}: scale {decision['direction']} "
                f"{decision['from']} -> {decision['to']} "
                f"({decision['reason']})",
                entity_id=f"{dep.app}/{dep.name}",
                extra={"app": dep.app, "deployment": dep.name,
                       **{k: v for k, v in decision.items()
                          if k != "ts"}})

    def _prewarm(self, dep: _DeploymentState, now: float,
                 force: bool = False):
        """Ship the deployment's by-ref weights toward every node
        BEFORE new replicas are placed (OBJECT_WARM -> r13 prefetch ->
        r9 broadcast tree): cold-start then finds the bytes local or
        joins the in-flight pull, so N concurrent scale-ups cost ~2xS
        root egress instead of NxS. Fire-and-forget; rate-limited per
        deployment unless forced by a fresh scale-up decision."""
        if not dep.weights_refs:
            return
        if not force and now - dep._last_prewarm_ts < _PREWARM_MIN_GAP_S:
            return
        dep._last_prewarm_ts = now
        for ref in dep.weights_refs:
            try:
                ray_tpu_torch.warm_object(ref)
            except Exception:  # noqa: BLE001 — speculation only
                pass

    # ----- phase 3: converge replica set to target count + version

    def _scale(self, dep: _DeploymentState):
        if dep.status == DEPLOY_UNHEALTHY:
            return
        target = dep.target_replicas()
        current = [r for r in dep.replicas if r.state in (STARTING, RUNNING)]
        new_version = [r for r in current if r.version == dep.version]
        old_version = [r for r in current if r.version != dep.version]

        # rolling update: bring up the new version to target, then retire old
        if len(new_version) < target:
            if target - len(new_version) >= 2:
                # CONCURRENT scale-up (manual redeploy path; autoscaler
                # decisions already pre-warmed at decision time): ship
                # the weights toward the fleet before the actors are
                # even placed. A single new replica skips this — one
                # demand pull off the holder set is already optimal,
                # and warming the whole cluster for it would waste
                # every other node's arena.
                self._prewarm(dep, time.monotonic())
            for _ in range(target - len(new_version)):
                self._start_replica(dep)
        elif old_version and len(dep.running(dep.version)) >= target:
            for r in old_version:
                dep.replicas.remove(r)
                self._stop_replica(dep, r, graceful=True)
            self._routing_version += 1
        elif not old_version and len(new_version) > target:
            # scale down — doom in priority order: non-running first
            # (cheapest to kill), then replicas on detector-flagged
            # slow nodes (shed the degraded host), then newest-started.
            # Ascending sort puts the doomed at the FRONT: non-RUNNING
            # (False) < RUNNING, in-slow (False) < clean, newest
            # (-started_at) smallest.
            slow = self._slow_nodes
            doomed = sorted(
                new_version,
                key=lambda r: (r.state == RUNNING,
                               r.node_idx not in slow, -r.started_at)
            )[:len(new_version) - target]
            running_removed = False
            for r in doomed:
                running_removed |= r.state == RUNNING
                dep.replicas.remove(r)
                self._stop_replica(dep, r, graceful=True)
            if running_removed:
                self._routing_version += 1

    def _start_replica(self, dep: _DeploymentState):
        from .replica import ServeReplica

        opts = dict(dep.config.ray_actor_options)
        replica_id = f"{dep.app}#{dep.name}#{dep.next_replica_idx}"
        dep.next_replica_idx += 1
        actor_cls = ray_tpu_torch.remote(ServeReplica).options(
            num_cpus=opts.get("num_cpus", 0),
            num_gpus=opts.get("num_gpus"),
            resources=opts.get("resources"),
            # queries + ping/metrics/drain must run concurrently
            max_concurrency=dep.config.max_concurrent_queries + 3,
        )
        handle = actor_cls.remote(dep.payload, replica_id)
        dep.replicas.append(_Replica(replica_id, handle, dep.version))

    def _stop_replica(self, dep: _DeploymentState, r: _Replica,
                      graceful: bool) -> threading.Thread:
        r.state = STOPPING

        def _drain(handle=r.handle,
                   timeout=dep.config.graceful_shutdown_timeout_s):
            try:
                if graceful:
                    ray_tpu_torch.get(handle.prepare_shutdown.remote(timeout),
                                timeout=timeout + 5)
            except Exception:
                pass
            try:
                ray_tpu_torch.kill(handle)
            except Exception:
                pass

        t = threading.Thread(target=_drain, daemon=True)
        with self._lock:
            self._drains = [d for d in self._drains if d.is_alive()]
            self._drains.append(t)
        t.start()
        return t

    # ----- phase 4: status rollup

    def _update_status(self, dep: _DeploymentState):
        if dep.status == DEPLOY_UNHEALTHY:
            return
        target = dep.target_replicas()
        if len(dep.running(dep.version)) == target and \
                all(r.state == RUNNING for r in dep.replicas):
            dep.status = DEPLOY_HEALTHY
            dep.message = ""
        else:
            dep.status = DEPLOY_UPDATING


def get_or_create_controller():
    """Find the singleton controller, creating it on first use."""
    try:
        return ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except ValueError:
        pass
    handle = ray_tpu_torch.remote(ServeController).options(
        name=CONTROLLER_NAME, num_cpus=0, max_concurrency=8).remote()
    # wait until the name resolves and the actor answers
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        try:
            ray_tpu_torch.get(handle.routing_version.remote(), timeout=5)
            return handle
        except Exception:
            time.sleep(0.05)
    raise RuntimeError("serve controller failed to start")
