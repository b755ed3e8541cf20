"""The port's Serve at scale: the cases of tests/test_serve_scale.py
(signal-fused autoscaling policy units, the windowed SLO, the weights-by-ref
cache, hint dedupe, slow-node-aware routing, zero-copy ingress), one for
one, on ray_tpu_torch.init(num_cpus=4, num_gpus=0).

test_warm_object_lands_on_remote_node and
test_broadcast_cold_start_bounded_root_egress run on a
ray_tpu_torch.cluster_utils.Cluster with real agent nodes. Waiting for a
module the port does not have yet (ROADMAP A2b): TestDoctorServeWarnings
(3 cases, ``dashboard``)."""

import threading
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import serve
from torch_port_util import deadline
from ray_tpu_torch.core.config import get_config
from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig
from ray_tpu_torch.serve.controller import ServeController, _DeploymentState


@pytest.fixture
def ray_start():
    """A fresh runtime of the port per test (tests/conftest.py's is the
    JAX package's)."""
    info = ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield info
    ray_tpu_torch.shutdown()


def _mkdep(cfg, desired=1):
    dep = _DeploymentState(
        "app", "d", b"", DeploymentConfig(num_replicas=desired,
                                          autoscaling_config=cfg), "v1")
    dep.autoscale_desired = desired
    return dep


def _scale(dep, cfg, load, now, signals=None):
    return ServeController._autoscale(None, dep, cfg, load, now,
                                      signals=signals)


class TestPolicyUnits:
    def test_queue_depth_signal_scales_up(self):
        """Router-reported queue depth drives the fused load even when
        replica-reported ongoing is low (requests queued client-side
        never reach the replica's counter)."""
        cfg = AutoscalingConfig(min_replicas=1, max_replicas=4,
                                target_num_ongoing_requests_per_replica=2,
                                upscale_delay_s=0.0)
        dep = _mkdep(cfg)
        d = _scale(dep, cfg, 0, now=1.0, signals={"queue_depth": 8})
        assert dep.autoscale_desired == 4
        assert d["direction"] == "up" and d["from"] == 1 and d["to"] == 4
        assert "queue=8" in d["reason"]

    def test_queue_depth_ttl_expires_dead_routers(self):
        cfg = AutoscalingConfig()
        dep = _mkdep(cfg)
        dep.router_depths["r1"] = (0.0, {"a": 5})
        dep.router_depths["r2"] = (100.0, {"a": 3})
        assert dep.queue_depth(now=100.5) == 3  # r1 expired and pruned
        assert "r1" not in dep.router_depths

    def test_up_down_thresholds_and_clamps(self):
        cfg = AutoscalingConfig(min_replicas=2, max_replicas=3,
                                target_num_ongoing_requests_per_replica=1,
                                upscale_delay_s=0.0, downscale_delay_s=0.0)
        dep = _mkdep(cfg, desired=2)
        _scale(dep, cfg, 100, now=1.0)
        assert dep.autoscale_desired == 3   # clamped at max
        _scale(dep, cfg, 0, now=2.0)
        assert dep.autoscale_desired == 2   # clamped at min

    def test_hysteresis_window_gates_upscale(self):
        cfg = AutoscalingConfig(target_num_ongoing_requests_per_replica=1,
                                upscale_delay_s=1.0)
        dep = _mkdep(cfg)
        assert _scale(dep, cfg, 8, now=0.0) is None   # window opens
        assert dep.autoscale_desired == 1
        assert _scale(dep, cfg, 8, now=0.5) is None   # still inside
        d = _scale(dep, cfg, 8, now=1.1)              # window satisfied
        assert d is not None and dep.autoscale_desired == 4

    def test_slo_burn_scales_up_without_concurrency(self):
        """p99 over the SLO upscales one step even at load 0 — slower
        requests, not more of them."""
        cfg = AutoscalingConfig(min_replicas=1, max_replicas=4,
                                upscale_delay_s=0.0, latency_slo_ms=100)
        dep = _mkdep(cfg)
        d = _scale(dep, cfg, 0, now=1.0, signals={"p99_ms": 250.0})
        assert dep.autoscale_desired == 2
        assert "slo_burn" in d["reason"]
        # p99 within budget: no burn, and load 0 wants a downscale path
        d2 = _scale(dep, cfg, 0, now=2.0, signals={"p99_ms": 50.0})
        assert d2 is None or d2["direction"] == "down"

    def test_downscale_cooldown_blocks_flap(self):
        """A shrink right after a grow is the flap signature: the
        downscale cooldown (measured from the LAST scale event) holds
        it even when the delay window is satisfied."""
        cfg = AutoscalingConfig(target_num_ongoing_requests_per_replica=1,
                                upscale_delay_s=0.0, downscale_delay_s=0.0,
                                downscale_cooldown_s=10.0)
        dep = _mkdep(cfg)
        _scale(dep, cfg, 4, now=1.0)
        assert dep.autoscale_desired == 4
        _scale(dep, cfg, 0, now=2.0)     # inside cooldown: held
        assert dep.autoscale_desired == 4
        _scale(dep, cfg, 0, now=11.5)    # cooldown passed: shrinks
        assert dep.autoscale_desired == 1

    def test_hot_nodes_veto_downscale(self):
        cfg = AutoscalingConfig(target_num_ongoing_requests_per_replica=1,
                                downscale_delay_s=0.0,
                                downscale_cpu_block_pct=90.0)
        dep = _mkdep(cfg, desired=3)
        assert _scale(dep, cfg, 0, now=1.0,
                      signals={"nodes_hot": True}) is None
        assert dep.autoscale_desired == 3
        assert dep._below_since is None  # veto restarts the window too
        _scale(dep, cfg, 0, now=2.0, signals={"nodes_hot": False})
        assert dep.autoscale_desired == 1

    def test_downscale_reads_windowed_average(self):
        """The DOWN side reads the mean load over downscale_delay_s: a
        single transient in-flight spike neither restarts the
        below-window nor blocks the shrink, and the shrink targets the
        average (reference: look-back averaging), while the UP side
        stays instantaneous."""
        cfg = AutoscalingConfig(min_replicas=1, max_replicas=8,
                                target_num_ongoing_requests_per_replica=1,
                                upscale_delay_s=0.0, downscale_delay_s=4.0)
        dep = _mkdep(cfg, desired=8)
        # drained fleet with one spike mid-window: avg stays ~0
        t, spike_at = 0.0, 2.0
        decision = None
        while t <= 4.2 and decision is None:
            load = 8 if t == spike_at else 0
            decision = _scale(dep, cfg, load, now=t)
            t = round(t + 0.2, 1)
        # the spike alone must NOT have scaled anything up (avg gates
        # down; up is instantaneous but 8 == cur) nor killed the shrink
        assert decision is not None and decision["direction"] == "down"
        assert "avg_load=" in decision["reason"]
        assert dep.autoscale_desired == 1  # ceil(avg~0.4 / 1) clamped
        # instantaneous surge still upscales in ONE evaluation
        d = _scale(dep, cfg, 16, now=t + 0.2)
        assert d["direction"] == "up" and dep.autoscale_desired == 8

    def test_decision_record_and_reversals(self):
        cfg = AutoscalingConfig(target_num_ongoing_requests_per_replica=1,
                                upscale_delay_s=0.0, downscale_delay_s=0.0)
        dep = _mkdep(cfg)
        _scale(dep, cfg, 4, now=1.0)
        _scale(dep, cfg, 0, now=2.0)
        _scale(dep, cfg, 4, now=3.0)
        assert [d for _, d in dep.scale_events] == ["up", "down", "up"]
        assert dep.reversals(now=3.0) == 2
        assert dep.reversals(now=200.0) == 0  # outside the window
        assert dep.last_decision["direction"] == "up"
        assert dep.last_decision["from"] == 1


class TestWindowedSLO:
    """The SLO p99 is computed over the look-back window's requests
    (delta of cumulative bucket snapshots), not the lifetime histogram
    — a bad episode must stop burning once it leaves the window."""

    BOUNDS = [1.0, 10.0, 100.0, 1000.0]

    def test_delta_excludes_history(self):
        from collections import deque

        from ray_tpu_torch.serve.controller import _windowed_p99

        # lifetime: 100 fast + 50 slow (the bad episode) ...
        v0 = [0, 100, 0, 50, 0, 0.0, 150]
        # ... then 100 MORE fast requests land in the window
        v1 = [0, 200, 0, 50, 0, 0.0, 250]
        snaps = deque([(0.0, v0, self.BOUNDS), (10.0, v1, self.BOUNDS)])
        p99 = _windowed_p99(snaps, 10.0)
        assert p99 is not None and p99 <= 10.0  # slow tail aged out

    def test_degradation_inside_window_trips(self):
        from collections import deque

        from ray_tpu_torch.serve.controller import _windowed_p99

        # a long fast history would dilute a lifetime percentile ...
        v0 = [0, 100000, 0, 0, 0, 0.0, 100000]
        # ... but the window holds only the fresh slow requests
        v1 = [0, 100000, 0, 50, 0, 0.0, 100050]
        snaps = deque([(0.0, v0, self.BOUNDS), (10.0, v1, self.BOUNDS)])
        assert _windowed_p99(snaps, 10.0) > 100.0

    def test_no_new_samples_is_no_signal(self):
        from collections import deque

        from ray_tpu_torch.serve.controller import _windowed_p99

        v = [0, 10, 0, 50, 0, 0.0, 60]
        assert _windowed_p99(deque([(0.0, v, self.BOUNDS)]), 0.0) is None
        snaps = deque([(0.0, v, self.BOUNDS), (10.0, list(v), self.BOUNDS)])
        assert _windowed_p99(snaps, 10.0) is None


class TestWeightsRefCache:
    def test_cache_invalidated_across_clusters(self, ray_start):
        """A cached weights ref is only valid inside the cluster that
        minted it: after a shutdown()/init() cycle the digest cache must
        re-put, not hand out a ref into the dead store."""
        from ray_tpu_torch.serve import api as serve_api

        w = np.arange(4096, dtype=np.uint8)
        r1 = serve_api._put_weights(w)
        # same bytes, same cluster: digest hit, same ref (stable version)
        assert serve_api._put_weights(w).id.binary() == r1.id.binary()
        # simulate the ref having been minted under a previous cluster
        serve_api._weights_cache_session = "/tmp/some-dead-session"
        r2 = serve_api._put_weights(w)
        assert r2.id.binary() != r1.id.binary()
        assert serve_api._weights_cache_session == ray_start.ctx.session_dir


class TestHintDedupe:
    def test_filter_suppresses_within_ttl(self):
        from ray_tpu_torch.core.context import _filter_hint_ids

        hinted = {}
        assert _filter_hint_ids(hinted, [b"a", b"b"], 0.0, 5.0) == \
            [b"a", b"b"]
        # the hot-loop case: same refs next batch -> nothing ships
        assert _filter_hint_ids(hinted, [b"a", b"b"], 1.0, 5.0) == []
        # novel id ships alongside suppressed ones
        assert _filter_hint_ids(hinted, [b"a", b"c"], 2.0, 5.0) == [b"c"]
        # after the TTL the id is hintable again
        assert _filter_hint_ids(hinted, [b"a"], 7.5, 5.0) == [b"a"]

    def test_filter_cache_bounded(self):
        from ray_tpu_torch.core.context import _HINT_CACHE_MAX, _filter_hint_ids

        hinted = {}
        ids = [b"%d" % i for i in range(_HINT_CACHE_MAX + 100)]
        _filter_hint_ids(hinted, ids, 0.0, 5.0)
        assert len(hinted) <= _HINT_CACHE_MAX

    def test_actor_hot_loop_suppresses_hints(self, ray_start):
        """The serve-handle pattern: an actor called repeatedly with the
        SAME by-ref arg sends one hint, not one per pushed batch."""
        from ray_tpu_torch.core.context import get_context

        @ray_tpu_torch.remote
        class A:
            def f(self, x):
                return int(x[0])

        a = A.remote()
        big = ray_tpu_torch.put(np.arange(1000, dtype=np.int64))
        ctx = get_context()
        sent0 = ctx.prefetch_hints_sent
        sup0 = ctx.prefetch_hints_suppressed
        for _ in range(6):
            assert ray_tpu_torch.get(a.f.remote(big), timeout=60) == 0
        assert ctx.prefetch_hints_sent - sent0 >= 1
        assert ctx.prefetch_hints_suppressed - sup0 >= 4


class TestSlowNodeRouting:
    def _router(self):
        from ray_tpu_torch.serve.router import Router

        r = Router.__new__(Router)
        r._lock = threading.Lock()
        r._cond = threading.Condition(r._lock)
        r._replicas = [("r0", object(), 0), ("r1", object(), 1)]
        r._slow_nodes = frozenset()
        r._inflight = {}
        r._max_q = 2
        r._model_affinity = {}
        return r

    def test_flagged_node_drained_of_traffic(self):
        r = self._router()
        r._slow_nodes = frozenset({1})
        picks = {r._choose_locked()[0] for _ in range(20)}
        assert picks == {"r0"}  # the slow node's replica gets nothing

    def test_fallback_when_clean_pool_saturated(self):
        r = self._router()
        r._slow_nodes = frozenset({1})
        r._inflight = {"r0": 2}  # clean replica at max_concurrent_queries
        assert r._choose_locked()[0] == "r1"
        r._inflight = {"r0": 2, "r1": 2}
        assert r._choose_locked() is None  # everyone saturated: block

    def test_no_flags_power_of_two_choices(self):
        r = self._router()
        r._inflight = {"r0": 1, "r1": 0}
        # p2c with both candidates visible always picks the less loaded
        assert r._choose_locked()[0] == "r1"


class TestServeIntegration:
    @pytest.fixture
    def serve_rt(self):
        ray_tpu_torch.init(num_cpus=4, num_gpus=0, ignore_reinit_error=True)
        yield
        serve.shutdown()
        ray_tpu_torch.shutdown()

    def test_snapshot_shape_and_queue_depth_report(self, serve_rt):
        @serve.deployment(max_concurrent_queries=4)
        class Slow:
            def __call__(self, x=None):
                time.sleep(0.4)
                return "ok"

        h = serve.run(Slow.bind(), name="depth")
        ctrl = ray_tpu_torch.get_actor("SERVE_CONTROLLER")
        version, replicas, max_q, slow = ray_tpu_torch.get(
            ctrl.get_routing_snapshot.remote("depth", "Slow"), timeout=30)
        assert max_q == 4 and slow == []
        assert len(replicas) == 1
        rid, handle, node_idx = replicas[0]
        assert node_idx == 0  # learned from the replica's ping

        # drive sustained concurrent traffic; the router's snapshot
        # refreshes (one per TTL while assigns keep coming) piggyback
        # its live in-flight counts into the autoscaler signal
        stop = threading.Event()
        errs = []

        def flood():
            while not stop.is_set():
                try:
                    assert h.remote().result(timeout_s=30) == "ok"
                except Exception as e:  # noqa: BLE001
                    errs.append(e)
                    return

        threads = [threading.Thread(target=flood) for _ in range(4)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 15
        depth = 0
        try:
            while time.monotonic() < deadline and depth == 0:
                st = serve.status()["applications"]["depth"]
                depth = st["deployments"]["Slow"][
                    "autoscaler"]["queue_depth"]
                time.sleep(0.05)
        finally:
            stop.set()
            for t in threads:
                t.join(30)
        assert not errs, errs
        assert depth >= 1, "router never reported queue depth"

    def test_autoscale_emits_decision_events(self, serve_rt):
        from ray_tpu_torch import state

        @serve.deployment(
            max_concurrent_queries=4, health_check_period_s=0.1,
            autoscaling_config=dict(
                min_replicas=1, max_replicas=3,
                target_num_ongoing_requests_per_replica=1,
                upscale_delay_s=0.2, downscale_delay_s=0.5))
        class Slow:
            def __call__(self):
                time.sleep(0.3)
                return "ok"

        h = serve.run(Slow.bind(), name="autoev")
        stop = threading.Event()

        def flood():
            while not stop.is_set():
                try:
                    h.remote().result(timeout_s=30)
                except Exception:
                    return

        threads = [threading.Thread(target=flood) for _ in range(8)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 30
        events = []
        try:
            while time.monotonic() < deadline and not events:
                events = state.list_cluster_events(
                    filters=[("type", "=", "serve_autoscale")])
                time.sleep(0.2)
        finally:
            stop.set()
            for t in threads:
                t.join(30)
        assert events, "no serve_autoscale cluster event emitted"
        ex = events[0]["extra"]
        assert ex["app"] == "autoev" and ex["direction"] == "up"
        assert ex["to"] > ex["from"]
        st = serve.status()["applications"]["autoev"]
        auto = st["deployments"]["Slow"]["autoscaler"]
        assert auto["last_decision"] is not None
        assert auto["cold_start"]["count"] >= 1

    def test_large_request_rides_by_ref_and_resolves(self, serve_rt):
        """Zero-copy ingress e2e: a payload over the by-ref threshold is
        converted to an ObjectRef by the handle, fetched by the worker
        runtime as a real task arg, and user code sees the value."""
        from ray_tpu_torch.serve.handle import _to_ref
        from ray_tpu_torch.core.object_ref import ObjectRef

        @serve.deployment
        def total(x):
            return float(np.asarray(x).sum())

        h = serve.run(total.bind(), name="byref")
        cfg = get_config()
        old = cfg.serve_request_by_ref_min_bytes
        cfg.serve_request_by_ref_min_bytes = 64 * 1024
        try:
            payload = np.ones(256 * 1024, dtype=np.float32)  # 1 MiB
            assert isinstance(_to_ref(payload), ObjectRef)
            assert _to_ref(np.ones(4)) is not None and \
                not isinstance(_to_ref(np.ones(4)), ObjectRef)
            assert h.remote(payload).result(timeout_s=60) == \
                float(payload.sum())
            cfg.serve_request_by_ref_min_bytes = 0  # A/B control: inline
            assert h.remote(payload).result(timeout_s=60) == \
                float(payload.sum())
        finally:
            cfg.serve_request_by_ref_min_bytes = old


# ------------------------------------------------- cluster integration


@pytest.fixture
def serve_tcp_cluster():
    """Head with NO schedulable CPUs + real agent nodes: serve replicas
    requesting num_cpus land on the agents, so cold-start actually moves
    weights across hosts."""
    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(initialize_head=True,
                      head_node_args={"num_cpus": 0, "num_gpus": 0})
    handles = []
    yield cluster, handles
    try:
        serve.shutdown()
    except Exception:
        pass
    for h in handles:
        h.terminate()
    cluster.shutdown()


def _wait_for(pred, timeout=60, msg="condition"):
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end:
        if pred():
            return
        time.sleep(0.05)
    raise TimeoutError(f"timed out waiting for {msg}")


@deadline(120)
def test_warm_object_lands_on_remote_node(serve_tcp_cluster):
    import ray_tpu_torch.core.api as core_api

    cluster, handles = serve_tcp_cluster
    r1 = cluster.add_remote_node(num_cpus=1)
    handles.append(r1)
    head = core_api._head

    payload = np.random.default_rng(7).integers(
        0, 255, 4 * 1024 * 1024, dtype=np.uint8)
    ref = ray_tpu_torch.put(payload)
    _wait_for(lambda: ref.id in head.objects, msg="put to register")

    issued = ray_tpu_torch.warm_object(ref, r1.node_idx, wait=True)
    assert issued == 1
    _wait_for(lambda: r1.node_idx in head.objects[ref.id].holders,
              msg="warm pull to land")
    # already a holder: nothing to issue
    assert ray_tpu_torch.warm_object(ref, r1.node_idx, wait=True) == 0
    # prefetch accounting moved (the warm rides the r13 machinery)
    from ray_tpu_torch import state

    op = state.object_plane_stats()
    assert op["prefetch_issued"] >= 1


@deadline(180)
def test_broadcast_cold_start_bounded_root_egress(serve_tcp_cluster):
    """Two replicas cold-start on two remote nodes with weights by ref
    and broadcast_fanout=1: the root (head, holding the driver's put)
    serves exactly ONE stream — the second replica's weights ride the
    first node's relay/holder — and both replicas compute the right
    answer from the shared weights."""
    import ray_tpu_torch.core.api as core_api

    cluster, handles = serve_tcp_cluster
    cfg = get_config()
    old_fanout = cfg.broadcast_fanout
    cfg.broadcast_fanout = 1
    try:
        r1 = cluster.add_remote_node(num_cpus=1)
        r2 = cluster.add_remote_node(num_cpus=1)
        handles.extend([r1, r2])
        head = core_api._head

        weights = np.random.default_rng(3).random(
            1024 * 1024).astype(np.float64)  # 8 MiB > by-ref threshold

        @serve.deployment(num_replicas=2,
                          ray_actor_options={"num_cpus": 1})
        class Model:
            def __init__(self, w):
                self.total = float(np.asarray(w).sum())

            def __call__(self, x=None):
                return self.total

        # snapshot root counters right before deploy (controller boot
        # traffic must not pollute the delta)
        served0 = head._transfer_server.pull_requests
        bytes0 = head._transfer_server.bytes_served

        h = serve.run(Model.bind(weights), name="coldstart",
                      timeout_s=120)
        st = serve.status()["applications"]["coldstart"]
        dep = st["deployments"]["Model"]
        assert dep["replica_states"].get("RUNNING", 0) == 2
        # weights were extracted to a ref (payload stays small) and the
        # controller holds it for pre-warm
        assert dep["autoscaler"]["weights_by_ref"] == 1

        # both replicas answer from the SAME weights object
        vals = {h.remote().result(timeout_s=60) for _ in range(8)}
        assert vals == {float(weights.sum())}

        # THE gate: the root served one stream; the second node's bytes
        # came off the first node (relay or promoted holder), so root
        # egress stays ~S, not 2xS
        served = head._transfer_server.pull_requests - served0
        assert served == 1, f"root served {served} streams, expected 1"
        assert head._transfer_server.bytes_served - bytes0 <= \
            int(1.25 * weights.nbytes)
        # cold-start samples recorded for doctor/status
        assert dep["autoscaler"]["cold_start"]["count"] == 2
    finally:
        cfg.broadcast_fanout = old_fanout
