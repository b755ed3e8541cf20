"""The port's Serve (ray_tpu_torch.serve) on its runtime: the cases of
tests/test_serve.py, one for one, on ray_tpu_torch.init(num_cpus=4,
num_gpus=0). The batched-model case runs a torch model where the JAX
package's runs a jitted JAX one."""

import json
import threading
import time
import urllib.request

import pytest

import ray_tpu_torch
from ray_tpu_torch import serve


@pytest.fixture(scope="module")
def rt():
    info = ray_tpu_torch.init(num_cpus=4, num_gpus=0, ignore_reinit_error=True)
    yield info
    serve.shutdown()
    ray_tpu_torch.shutdown()


@pytest.fixture
def serve_session(rt):
    yield
    serve.shutdown()


@serve.deployment
def double(x):
    return x * 2


@serve.deployment
class Counter:
    def __init__(self, start=0):
        self.n = start

    def __call__(self, inc=1):
        self.n += inc
        return self.n

    def value(self):
        return self.n


class TestBasics:
    def test_function_deployment(self, serve_session):
        h = serve.run(double.bind(), name="fn")
        assert h.remote(21).result(timeout_s=30) == 42

    def test_class_deployment_and_methods(self, serve_session):
        h = serve.run(Counter.bind(10), name="counter")
        assert h.remote(5).result(timeout_s=30) == 15
        assert h.value.remote().result(timeout_s=30) == 15

    def test_status_reports_healthy(self, serve_session):
        serve.run(double.options(name="d2").bind(), name="app2")
        st = serve.status()["applications"]
        assert st["app2"]["status"] == "RUNNING"
        dep = st["app2"]["deployments"]["d2"]
        assert dep["status"] == "HEALTHY"
        assert dep["replica_states"].get("RUNNING") == 1

    def test_delete_app(self, serve_session):
        serve.run(double.options(name="d3").bind(), name="doomed")
        serve.delete("doomed")
        assert "doomed" not in serve.status()["applications"]

    def test_constructor_failure_marks_unhealthy(self, serve_session):
        @serve.deployment(health_check_period_s=0.1)
        class Broken:
            def __init__(self):
                raise RuntimeError("boom-ctor")

            def __call__(self):
                return None

        with pytest.raises((RuntimeError, TimeoutError)):
            serve.run(Broken.bind(), name="broken", timeout_s=30)
        serve.delete("broken")


class TestScaling:
    def test_multiple_replicas_spread_load(self, serve_session):
        @serve.deployment(num_replicas=3)
        class WhoAmI:
            def __init__(self):
                import os
                self.pid = os.getpid()

            def __call__(self):
                return self.pid

        h = serve.run(WhoAmI.bind(), name="who")
        pids = {h.remote().result(timeout_s=30) for _ in range(30)}
        assert len(pids) >= 2  # load crosses replica boundaries

    def test_scale_up_and_down_via_redeploy(self, serve_session):
        d = Counter.options(name="scaler", num_replicas=1)
        serve.run(d.bind(), name="scale-app")

        def replica_count():
            st = serve.status()["applications"]["scale-app"]
            return st["deployments"]["scaler"]["replica_states"].get(
                "RUNNING", 0)

        assert replica_count() == 1
        serve.run(d.options(num_replicas=3).bind(), name="scale-app")
        assert replica_count() == 3
        serve.run(d.options(num_replicas=1).bind(), name="scale-app")
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and replica_count() != 1:
            time.sleep(0.1)
        assert replica_count() == 1

    def test_rolling_upgrade_changes_behavior(self, serve_session):
        @serve.deployment(name="ver")
        def v1(_x=None):
            return "v1"

        @serve.deployment(name="ver")
        def v2(_x=None):
            return "v2"

        h = serve.run(v1.bind(), name="upg")
        assert h.remote().result(timeout_s=30) == "v1"
        h = serve.run(v2.bind(), name="upg")
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            if h.remote().result(timeout_s=30) == "v2":
                break
            time.sleep(0.1)
        assert h.remote().result(timeout_s=30) == "v2"

    def test_replica_death_is_recovered(self, serve_session):
        h = serve.run(Counter.options(
            name="phoenix", health_check_period_s=0.1).bind(),
            name="recover")
        assert h.remote().result(timeout_s=30) == 1
        # find and kill the replica actor through the controller snapshot
        ctrl = ray_tpu_torch.get_actor("SERVE_CONTROLLER")
        _, replicas, _, _ = ray_tpu_torch.get(
            ctrl.get_routing_snapshot.remote("recover", "phoenix"),
            timeout=30)
        ray_tpu_torch.kill(replicas[0][1])
        deadline = time.monotonic() + 30
        ok = False
        while time.monotonic() < deadline:
            try:
                h.remote().result(timeout_s=5)
                ok = True
                break
            except Exception:
                time.sleep(0.2)
        assert ok, "deployment did not recover from replica death"


class TestComposition:
    def test_handle_passed_to_ingress(self, serve_session):
        @serve.deployment
        class Preprocess:
            def __call__(self, x):
                return x + 1

        @serve.deployment
        class Pipeline:
            def __init__(self, pre):
                self.pre = pre

            def __call__(self, x):
                y = self.pre.remote(x).result(timeout_s=30)
                return y * 10

        h = serve.run(Pipeline.bind(Preprocess.bind()), name="pipe")
        assert h.remote(4).result(timeout_s=30) == 50
        st = serve.status()["applications"]["pipe"]["deployments"]
        assert set(st) == {"Pipeline", "Preprocess"}


class TestBatching:
    def test_batch_coalesces_concurrent_calls(self, serve_session):
        @serve.deployment(max_concurrent_queries=16)
        class Batched:
            def __init__(self):
                self.batch_sizes = []

            @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.2)
            def handler(self, items):
                self.batch_sizes.append(len(items))
                return [i * 2 for i in items]

            def __call__(self, x):
                return self.handler(x)

            def sizes(self):
                return self.batch_sizes

        h = serve.run(Batched.bind(), name="batch")
        results = [None] * 12
        threads = []

        def call(i):
            results[i] = h.remote(i).result(timeout_s=30)

        for i in range(12):
            t = threading.Thread(target=call, args=(i,))
            t.start()
            threads.append(t)
        for t in threads:
            t.join(30)
        assert results == [i * 2 for i in range(12)]
        sizes = h.sizes.remote().result(timeout_s=30)
        assert max(sizes) > 1, f"no batching happened: {sizes}"

    def test_batched_torch_model(self, serve_session):
        """A torch model replica serving batched requests (the JAX
        package's test_batched_xla_model)."""
        import numpy as np

        @serve.deployment(max_concurrent_queries=16)
        class TorchModel:
            def __init__(self):
                import torch

                self._w = torch.randn(
                    4, 4, generator=torch.Generator().manual_seed(0))

            @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.1)
            def predict(self, items):
                import numpy as np
                import torch
                batch = torch.from_numpy(np.stack(items))
                out = torch.tanh(batch @ self._w).numpy()
                return [out[i] for i in range(len(items))]

            def __call__(self, x):
                return self.predict(np.asarray(x, dtype=np.float32))

        h = serve.run(TorchModel.bind(), name="torchapp")
        xs = [np.full((4,), i, dtype=np.float32) for i in range(6)]
        outs = [None] * 6
        ts = []
        for i, x in enumerate(xs):
            t = threading.Thread(
                target=lambda i=i, x=x: outs.__setitem__(
                    i, h.remote(x.tolist()).result(timeout_s=60)))
            t.start()
            ts.append(t)
        for t in ts:
            t.join(60)
        for i, o in enumerate(outs):
            assert o is not None and o.shape == (4,)


class TestShutdownReapsReplicas:
    def test_serve_shutdown_releases_all_workers_and_leases(self, rt):
        """Regression: serve.shutdown() used to kill the controller while
        replica drains were still in flight, orphaning replica workers and
        their leases forever; repeated deploy/shutdown cycles then hit
        max_workers_per_node and every later deploy timed out."""
        import ray_tpu_torch.core.api as core_api

        head = core_api._head

        def held():
            with head._lock:
                leases = len(head.leases)
                actors = sum(1 for n in head.nodes.values()
                             for w in n.workers.values()
                             if w.state == "actor")
            return leases, actors

        for _ in range(3):
            @serve.deployment(num_replicas=2)
            def echo(x):
                return x

            h = serve.run(echo.bind(), name="reap")
            assert h.remote(1).result(timeout_s=30) == 1
            serve.shutdown()
        leases, actors = held()
        assert leases == 0, f"{leases} leases leaked after serve.shutdown"
        assert actors == 0, f"{actors} actor workers leaked"


class TestBatcherUnit:
    def test_batch_never_exceeds_max_batch_size(self):
        """Burst submissions must be split into <= max_bs batches (an XLA
        replica compiled for a padded batch shape cannot take oversized
        batches). Regression for the leader queue-swap race."""
        from ray_tpu_torch.serve.batching import _Batcher

        batcher = _Batcher(max_batch_size=4, batch_wait_timeout_s=0.05)
        sizes = []
        sizes_lock = threading.Lock()

        def call_batch(items):
            with sizes_lock:
                sizes.append(len(items))
            time.sleep(0.02)  # widen the window where arrivals pile up
            return [i * 10 for i in items]

        results = [None] * 23
        threads = [
            threading.Thread(
                target=lambda i=i: results.__setitem__(
                    i, batcher.submit(call_batch, i)))
            for i in range(23)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert results == [i * 10 for i in range(23)]
        assert sizes and max(sizes) <= 4, f"oversized batch: {sizes}"

    def test_batch_exception_propagates_to_every_caller(self):
        from ray_tpu_torch.serve.batching import _Batcher

        batcher = _Batcher(max_batch_size=8, batch_wait_timeout_s=0.05)

        def boom(items):
            raise RuntimeError("replica exploded")

        errs = [None] * 3

        def call(i):
            try:
                batcher.submit(boom, i)
            except RuntimeError as e:
                errs[i] = str(e)

        threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert errs == ["replica exploded"] * 3


class TestAutoscalePolicyUnit:
    def test_upscale_episode_resets_downscale_timer(self):
        """Regression: an upscale used to leave a stale ``_below_since`` on
        the deployment (the controller cleared its own attribute instead),
        so a later dip downscaled immediately instead of waiting
        ``downscale_delay_s``."""
        from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig
        from ray_tpu_torch.serve.controller import ServeController, _DeploymentState

        cfg = AutoscalingConfig(
            min_replicas=1, max_replicas=4,
            target_num_ongoing_requests_per_replica=1,
            upscale_delay_s=0.0, downscale_delay_s=1.5)
        dep = _DeploymentState(
            "app", "d", b"", DeploymentConfig(num_replicas=2,
                                              autoscaling_config=cfg), "v1")
        dep.autoscale_desired = 2
        scale = lambda load, now: ServeController._autoscale(  # noqa: E731
            None, dep, cfg, load, now)

        scale(1, now=0.0)      # below target -> starts the downscale timer
        assert dep._below_since == 0.0
        scale(8, now=1.0)      # burst -> upscales (delay 0); timer must reset
        assert dep.autoscale_desired == 4
        assert dep._below_since is None
        scale(1, now=2.0)      # dip right after the upscale episode
        # with the stale timer this would read 2.0 - 0.0 >= 1.5 and
        # shrink; r14 holds even longer — the burst sample is still
        # inside the downscale look-back window, so the averaged signal
        # is not even "below" yet
        assert dep.autoscale_desired == 4
        assert dep._below_since is None
        scale(1, now=3.0)      # burst rolled out of the window: timer arms
        assert dep.autoscale_desired == 4
        assert dep._below_since == 3.0
        scale(1, now=4.0)      # 1.0s below < downscale_delay_s: still held
        assert dep.autoscale_desired == 4
        scale(1, now=4.6)      # sustained 1.6s >= 1.5s -> now it shrinks
        assert dep.autoscale_desired == 1


class TestAutoscaling:
    def test_scales_up_under_load_and_down_when_idle(self, serve_session):
        @serve.deployment(
            max_concurrent_queries=4,
            health_check_period_s=0.1,
            autoscaling_config=dict(
                min_replicas=1, max_replicas=3,
                target_num_ongoing_requests_per_replica=1,
                upscale_delay_s=0.2, downscale_delay_s=0.5))
        class Slow:
            def __call__(self):
                time.sleep(0.3)
                return "ok"

        h = serve.run(Slow.bind(), name="auto")

        def running():
            st = serve.status()["applications"]["auto"]
            return st["deployments"]["Slow"]["replica_states"].get(
                "RUNNING", 0)

        assert running() == 1
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
        scaled_up = False
        while time.monotonic() < deadline:
            if running() >= 2:
                scaled_up = True
                break
            time.sleep(0.1)
        stop.set()
        for t in threads:
            t.join(30)
        assert scaled_up, "never scaled past 1 replica under load"
        deadline = time.monotonic() + 30
        scaled_down = False
        while time.monotonic() < deadline:
            if running() == 1:
                scaled_down = True
                break
            time.sleep(0.2)
        assert scaled_down, "never scaled back down when idle"


class TestHTTP:
    def test_http_ingress_end_to_end(self, serve_session):
        @serve.deployment
        def adder(payload):
            return {"sum": payload["a"] + payload["b"]}

        serve.run(adder.bind(), name="httpapp", route_prefix="/add")
        port = serve.start()
        base = f"http://127.0.0.1:{port}"

        with urllib.request.urlopen(base + "/-/healthz", timeout=10) as r:
            assert json.loads(r.read()) == "ok"
        with urllib.request.urlopen(base + "/-/routes", timeout=10) as r:
            assert json.loads(r.read()) == {"/add": "httpapp"}
        req = urllib.request.Request(
            base + "/add", data=json.dumps({"a": 2, "b": 3}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            assert json.loads(r.read()) == {"sum": 5}
        # unknown path -> 404
        try:
            urllib.request.urlopen(base + "/nope", timeout=10)
            assert False, "expected 404"
        except urllib.error.HTTPError as e:
            assert e.code == 404


class TestProxyBackpressure:
    def test_saturated_proxy_queues_then_503s(self, serve_session):
        """asyncio ingress backpressure (ref: the reference proxy's
        max_ongoing_requests family): beyond max_inflight requests run
        concurrently, max_queued wait, the rest get 503+Retry-After."""
        import threading
        import urllib.error
        import urllib.request

        from ray_tpu_torch.serve.http_proxy import HTTPProxy

        @serve.deployment(max_concurrent_queries=4)
        def slow(payload):
            time.sleep(1.0)
            return "done"

        serve.run(slow.bind(), name="slowapp", route_prefix="/slow")
        proxy = HTTPProxy(max_inflight=2, max_queued=1)
        base = f"http://127.0.0.1:{proxy.port()}"
        codes, retry_afters = [], []
        lock = threading.Lock()

        def hit():
            req = urllib.request.Request(base + "/slow", data=b'"x"')
            try:
                with urllib.request.urlopen(req, timeout=30) as r:
                    with lock:
                        codes.append(r.status)
            except urllib.error.HTTPError as e:
                with lock:
                    codes.append(e.code)
                    if e.code == 503:
                        # collected here, asserted on the MAIN thread —
                        # an assert in a worker thread never fails a test
                        retry_afters.append(e.headers.get("Retry-After"))

        threads = [threading.Thread(target=hit) for _ in range(6)]
        for t in threads:
            t.start()
            time.sleep(0.05)  # deterministic arrival order
        for t in threads:
            t.join(timeout=60)
        proxy.stop()
        # 2 in flight + 1 queued succeed eventually; the overflow 503s
        assert sorted(codes).count(200) == 3, codes
        assert sorted(codes).count(503) == 3, codes
        assert retry_afters == ["1", "1", "1"], retry_afters

    def test_keepalive_connection_reuse(self, serve_session):
        """One HTTP/1.1 connection serves several requests."""
        import http.client

        @serve.deployment
        def echo(payload):
            return payload

        serve.run(echo.bind(), name="echoapp", route_prefix="/echo")
        port = serve.start()
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        try:
            for i in range(5):
                conn.request("POST", "/echo", body=json.dumps(i))
                resp = conn.getresponse()
                assert resp.status == 200
                assert json.loads(resp.read()) == i
        finally:
            conn.close()
