"""The port's ops layer: the cases of tests/test_ops_layer.py (autoscaler,
job submission, dashboard, the GKE node-pool cloud), one for one, on
ray_tpu_torch's runtime with GPU node pools where the reference's are TPU
ones (a fake GKE GPU pool's node declares ``GPU: 1``, a logical GPU on
this CPU), then the ops layer held against the JAX package's: the
autoscaler's launches and terminations on one demand trace, the GKE
cloud's REST requests, and the CLI's commands and options.

Every case that starts a runtime passes ``num_gpus=0`` or declares its
GPUs explicitly; every dashboard listens on ``port=0``.
"""

import argparse
import importlib
import json
import os
import time
import urllib.request
from types import SimpleNamespace

import pytest

import ray_tpu_torch
from ray_tpu_torch.autoscaler import Autoscaler, AutoscalingPolicy, NodeProvider
from torch_port_util import deadline, ray_start  # noqa: F401 (fixture)


class FakeProvider(NodeProvider):
    """Mock provider (ref: test_autoscaler MockProvider)."""

    def __init__(self):
        self.nodes = {}
        self.next = 0
        self.num_cpus = 2

    def create_node(self):
        pid = f"fake-{self.next}"
        self.next += 1
        self.nodes[pid] = True
        return pid

    def terminate_node(self, pid):
        self.nodes.pop(pid, None)

    def non_terminated_nodes(self):
        return list(self.nodes)


class FakeHead:
    def __init__(self):
        import threading

        self._lock = threading.Lock()
        self._pending_leases = []
        self._pending_pg = []
        self.nodes = {}

    def remove_node(self, idx):
        self.nodes.pop(idx, None)


def test_autoscaler_scales_up_on_demand():
    head = FakeHead()
    provider = FakeProvider()
    sc = Autoscaler(head, provider, AutoscalingPolicy(
        max_workers=3, max_launch_batch=2))
    head._pending_leases = [1, 2, 3]  # 3 unsatisfiable leases, 2 cpus/node
    sc.update()
    assert len(provider.non_terminated_nodes()) == 2  # ceil(3/2), batch cap
    sc.update()
    assert len(provider.non_terminated_nodes()) == 3  # capped by max_workers
    sc.update()
    assert len(provider.non_terminated_nodes()) == 3


def test_autoscaler_respects_min_workers():
    sc = Autoscaler(FakeHead(), FakeProvider(), AutoscalingPolicy(
        min_workers=2, max_workers=4))
    sc.update()
    assert len(sc._provider.non_terminated_nodes()) == 2


@deadline(120)
def test_autoscaler_real_node_joins_and_idles_away():
    """Demand -> a REAL node agent launches and registers; idle ->
    terminated (the reference's end-to-end scale-up/down loop)."""
    from ray_tpu_torch.autoscaler import LocalNodeProvider

    # short lease keep-alive: scale-DOWN waits for the driver to return
    # idle leased workers, which it holds 30s by default
    info = ray_tpu_torch.init(num_cpus=1, num_gpus=0, _system_config={
        "idle_worker_keep_alive_s": 1.0})
    try:
        head = info.head
        addr = head.enable_tcp(host="127.0.0.1", advertise_ip="127.0.0.1")
        provider = LocalNodeProvider(addr, num_cpus_per_node=1)
        sc = Autoscaler(head, provider, AutoscalingPolicy(
            max_workers=1, idle_timeout_s=1.5, update_interval_s=0.2))
        sc.start()
        try:
            # saturate the 1-cpu head node, forcing a queued lease
            @ray_tpu_torch.remote
            def hold(t):
                time.sleep(t)
                return 1

            refs = [hold.remote(3.0), hold.remote(3.0)]
            t_end = time.monotonic() + 30
            while time.monotonic() < t_end:
                if len(ray_tpu_torch.nodes()) == 2:
                    break
                time.sleep(0.2)
            assert len(ray_tpu_torch.nodes()) == 2, "no node launched"
            assert ray_tpu_torch.get(refs, timeout=60) == [1, 1]
            # once idle past the timeout, the node is terminated
            t_end = time.monotonic() + 30
            while time.monotonic() < t_end:
                if len(ray_tpu_torch.nodes()) == 1:
                    break
                time.sleep(0.3)
            assert len(ray_tpu_torch.nodes()) == 1, \
                "idle node not terminated"
            assert sc.num_launches >= 1 and sc.num_terminations >= 1
        finally:
            sc.stop()
            for pid in provider.non_terminated_nodes():
                provider.terminate_node(pid)
    finally:
        ray_tpu_torch.shutdown()


@deadline(120)
def test_job_lifecycle(ray_start):
    from ray_tpu_torch.jobs import JobSubmissionClient

    client = JobSubmissionClient()
    job_id = client.submit_job(
        entrypoint="python -c \"print('job says hello')\"",
        metadata={"owner": "test"})
    t_end = time.monotonic() + 60
    while time.monotonic() < t_end:
        if client.get_job_status(job_id) in ("SUCCEEDED", "FAILED"):
            break
        time.sleep(0.2)
    assert client.get_job_status(job_id) == "SUCCEEDED"
    assert "job says hello" in client.get_job_logs(job_id)
    info = client.get_job_info(job_id)
    assert info["metadata"]["owner"] == "test"
    assert any(j["job_id"] == job_id for j in client.list_jobs())

    failing = client.submit_job(entrypoint="python -c 'raise SystemExit(3)'")
    while client.get_job_status(failing) == "RUNNING":
        time.sleep(0.1)
    assert client.get_job_status(failing) == "FAILED"
    assert "exit code 3" in client.get_job_info(failing)["message"]

    stoppable = client.submit_job(entrypoint="sleep 60")
    time.sleep(0.3)
    assert client.stop_job(stoppable)
    assert client.get_job_status(stoppable) == "STOPPED"
    with pytest.raises(Exception):
        client.get_job_status("nonexistent-job")
    assert client.delete_job(stoppable)


@deadline(120)
def test_job_can_attach_to_cluster(ray_start):
    """The entrypoint reaches THIS cluster via the injected address."""
    from ray_tpu_torch.jobs import JobSubmissionClient

    script = (
        "import os, sys; sys.path.insert(0, os.environ['JOB_REPO']);"
        "import ray_tpu_torch;"
        "ray_tpu_torch.init(address=os.environ['RAY_TPU_ADDRESS']);"
        "print('cpus:', ray_tpu_torch.cluster_resources()['CPU'])")
    import ray_tpu_torch as pkg

    repo = os.path.dirname(os.path.dirname(os.path.abspath(pkg.__file__)))
    client = JobSubmissionClient()
    jid = client.submit_job(
        entrypoint=f'python -c "{script}"',
        runtime_env={"env_vars": {"JOB_REPO": repo}})
    out = "".join(client.tail_job_logs(jid))
    assert client.get_job_status(jid) == "SUCCEEDED", out
    assert "cpus: 4.0" in out


@deadline(120)
def test_node_stopped_while_joining_exits_clean():
    """A ``start --address`` node stopped the moment the head registers
    it (as a launcher tearing down right after the cluster came up) runs
    its shutdown: exit code 0 and its arena unlinked. The agent catches
    SIGTERM before it joins; the reference's installs its handler only
    after (ROADMAP C)."""
    import subprocess
    import sys

    info = ray_tpu_torch.init(num_cpus=1, num_gpus=0)
    try:
        head = info.head
        addr = head.enable_tcp(host="127.0.0.1", advertise_ip="127.0.0.1")
        repo = os.path.dirname(os.path.dirname(
            os.path.abspath(ray_tpu_torch.__file__)))
        for _ in range(3):
            before = set(head.nodes)
            proc = subprocess.Popen(
                [sys.executable, "-m", "ray_tpu_torch", "start",
                 "--address", addr, "--num-cpus", "1", "--num-gpus", "0"],
                cwd=repo, stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL)
            t_end = time.monotonic() + 60
            new = []
            while not new and time.monotonic() < t_end:
                new = [i for i in list(head.nodes) if i not in before]
                time.sleep(0.002)
            proc.terminate()
            assert new, "the node never registered"
            arena = f"/dev/shm/{head.nodes[new[0]].store_name}"
            assert proc.wait(timeout=30) == 0
            assert not os.path.exists(arena)
    finally:
        ray_tpu_torch.shutdown()


class RecordingCloud:
    """CloudAPI stub recording scale requests (no processes)."""

    num_cpus = 2

    def __init__(self):
        self.nodes = []
        self.requests = []
        self._next = 0

    def list_nodes(self):
        return list(self.nodes)

    def submit_scale_request(self, req):
        self.requests.append(req)
        for pid in req.workers_to_delete:
            if pid in self.nodes:
                self.nodes.remove(pid)
        while len(self.nodes) > req.desired_num_workers:
            self.nodes.pop()
        while len(self.nodes) < req.desired_num_workers:
            self.nodes.append(f"cloud-{self._next}")
            self._next += 1


def test_batching_provider_coalesces_one_scale_request():
    """N create_node calls in one update -> ONE declarative resize (ref:
    batching_node_provider.py:63 post_process submits once)."""
    from ray_tpu_torch.autoscaler import BatchingNodeProvider

    cloud = RecordingCloud()
    provider = BatchingNodeProvider(cloud)
    head = FakeHead()
    sc = Autoscaler(head, provider, AutoscalingPolicy(
        max_workers=8, max_launch_batch=4))
    head._pending_leases = [1] * 8  # 8 leases, 2 cpus/node -> want 4
    sc.update()
    assert len(cloud.requests) == 1, "creates must coalesce"
    assert cloud.requests[0].desired_num_workers == 4
    assert cloud.list_nodes() == ["cloud-0", "cloud-1", "cloud-2",
                                  "cloud-3"]
    # nothing changed -> no new request
    head._pending_leases = []
    sc._tracked.clear()  # (no head registration in this unit test)
    sc.update()
    assert len(cloud.requests) == 1


def test_batching_provider_delete_names_specific_workers():
    from ray_tpu_torch.autoscaler import BatchingNodeProvider

    cloud = RecordingCloud()
    cloud.nodes = ["cloud-0", "cloud-1", "cloud-2"]
    provider = BatchingNodeProvider(cloud)
    assert provider.non_terminated_nodes() == cloud.nodes
    provider.terminate_node("cloud-1")
    provider.post_process()
    req = cloud.requests[-1]
    assert req.workers_to_delete == ["cloud-1"]
    assert req.desired_num_workers == 2
    assert "cloud-1" not in cloud.list_nodes()


@deadline(150)
def test_fake_gke_gpu_pool_scales_up_and_down():
    """E2E: demand scales a fake GKE GPU node pool up (real node agents
    joining over TCP with a GPU + the accelerator label), idleness
    scales it back down (the reference's TPU-pool case on a pool of
    one-GPU nodes; the GPU here is logical, declared by the agent)."""
    from ray_tpu_torch.autoscaler import BatchingNodeProvider, FakeGkeGpuCloud

    info = ray_tpu_torch.init(num_cpus=1, num_gpus=0, _system_config={
        "idle_worker_keep_alive_s": 1.0})
    cloud = None
    try:
        head = info.head
        addr = head.enable_tcp(host="127.0.0.1", advertise_ip="127.0.0.1")
        cloud = FakeGkeGpuCloud(addr, num_gpus_per_node=1,
                                num_cpus_per_node=1,
                                provision_delay_s=0.2)
        sc = Autoscaler(head, BatchingNodeProvider(cloud),
                        AutoscalingPolicy(max_workers=1,
                                          idle_timeout_s=1.5,
                                          update_interval_s=0.2))
        sc.start()
        try:
            @ray_tpu_torch.remote(num_gpus=1)
            def on_gpu_pool():
                return (os.environ.get("CUDA_VISIBLE_DEVICES", ""),
                        ray_tpu_torch.get_gpu_ids())

            # the head node has no GPU: the lease queues, the pool grows
            ref = on_gpu_pool.remote()
            visible, ids = ray_tpu_torch.get(ref, timeout=90)
            assert (visible, ids) == ("0", [0])  # the pool node's GPU
            nodes = ray_tpu_torch.nodes()
            pool = [n for n in nodes
                    if n["labels"].get("accelerator") == "nvidia-h100-80gb"]
            assert len(pool) == 1
            assert pool[0]["resources_total"].get("GPU") == 1.0
            # idle past the timeout -> ONE shrink request, pool empties
            t_end = time.monotonic() + 40
            while time.monotonic() < t_end:
                if len(cloud.list_nodes()) == 0:
                    break
                time.sleep(0.3)
            assert cloud.list_nodes() == [], "idle pool not scaled down"
            shrink = [r for r in cloud.scale_requests
                      if r.workers_to_delete]
            assert shrink, "scale-down must name the drained worker"
        finally:
            sc.stop()
    finally:
        if cloud is not None:
            cloud.shutdown()
        ray_tpu_torch.shutdown()


@deadline(120)
def test_dashboard_endpoints(ray_start):
    from ray_tpu_torch.dashboard import start_dashboard

    @ray_tpu_torch.remote
    def noop():
        return 1

    ray_tpu_torch.get(noop.remote(), timeout=60)
    dash = start_dashboard(port=0)
    try:
        def fetch(path):
            try:
                with urllib.request.urlopen(dash.url + path,
                                            timeout=10) as r:
                    return r.status, r.read()
            except urllib.error.HTTPError as e:
                return e.code, e.read()

        status, body = fetch("/api/cluster")
        assert status == 200
        assert json.loads(body)["resources_total"]["CPU"] == 4.0
        status, body = fetch("/api/nodes")
        assert json.loads(body)[0]["alive"] is True
        status, body = fetch("/api/actors")
        assert status == 200
        status, body = fetch("/")
        assert status == 200 and b"ray_tpu" in body
        status, body = fetch("/metrics")
        assert status == 200
        status, body = fetch("/api/bogus")
        assert status == 404
    finally:
        dash.stop()


@deadline(120)
def test_dashboard_spa_and_new_endpoints(ray_start):
    """The SPA document + the endpoints its pages read (ref analog:
    dashboard/client/src pages over the REST API)."""
    from ray_tpu_torch.dashboard import start_dashboard

    @ray_tpu_torch.remote
    def noop():
        return 1

    ray_tpu_torch.get([noop.remote() for _ in range(3)], timeout=60)
    dash = start_dashboard(port=0)
    try:
        def fetch(path):
            with urllib.request.urlopen(dash.url + path, timeout=10) as r:
                return r.status, r.read()

        # the SPA document contains every page route + the renderers
        status, body = fetch("/")
        assert status == 200
        for page in (b"overview", b"nodes", b"actors", b"tasks", b"jobs",
                     b"metrics", b"timeline", b"placement_groups",
                     b"serve"):
            assert page in body, f"SPA missing page {page}"
        assert b"tooltip" in body and b"prefers-color-scheme" in body
        assert b"GPU avail / total" in body
        # summaries (task events flush asynchronously -> poll)
        t_end = time.time() + 15
        while True:
            status, body = fetch("/api/summary/tasks")
            summary = json.loads(body)
            assert status == 200
            if summary["total"] >= 3 or time.time() > t_end:
                break
            time.sleep(0.3)
        assert summary["total"] >= 3
        status, body = fetch("/api/summary/actors")
        assert status == 200
        # timeline has complete-span events for the executed tasks
        # (FINISHED events flush asynchronously from workers -> poll)
        t_end = time.time() + 15
        while True:
            status, body = fetch("/api/timeline")
            events = json.loads(body)
            assert status == 200
            if any(e.get("ph") == "X" for e in events) or \
                    time.time() > t_end:
                break
            time.sleep(0.3)
        assert any(e.get("ph") == "X" for e in events)
        # serve page endpoint answers (empty list when serve is down)
        status, body = fetch("/api/serve/applications")
        assert status == 200 and json.loads(body) == []
    finally:
        dash.stop()


class FakeGkeRestApi:
    """In-memory emulation of the Container/Compute REST surface the GKE
    node-pool clouds speak: node-pool get/setSize, operation polling
    (each op needs one poll before DONE), instance-group
    listManagedInstances/deleteInstances. Records every call. ``pool``
    and ``prefix`` name the pool and its instances (the port's GPU pool
    by default; the reference's TPU pool for the parity case)."""

    IG = "https://compute.example/igm/pool-ig"

    def __init__(self, size=0, pool="gpu-pool", prefix="gke-gpu"):
        self.pool, self.prefix = pool, prefix
        self.instances = [f"{prefix}-{i}" for i in range(size)]
        self._next = size
        self.calls = []          # (method, url, body)
        self._ops = {}           # name -> polls remaining
        self._opn = 0

    def _operation(self, compute=False):
        name = f"op-{self._opn}"
        self._opn += 1
        self._ops[name] = 1
        op = {"name": name, "status": "RUNNING"}
        if compute:
            # Compute Engine ops are polled at their selfLink, NOT the
            # Container operations collection (which would 404)
            op["selfLink"] = f"https://compute.example/compute-ops/{name}"
        return op

    def __call__(self, method, url, body, headers):
        self.calls.append((method, url, body))
        assert headers.get("Authorization") == "Bearer test-token"
        if url.endswith(f"/nodePools/{self.pool}") and method == "GET":
            return 200, {"initialNodeCount": len(self.instances),
                         "instanceGroupUrls": [self.IG]}
        if url.endswith(":setSize"):
            n = body["nodeCount"]
            while len(self.instances) > n:
                self.instances.pop()
            while len(self.instances) < n:
                self.instances.append(f"{self.prefix}-{self._next}")
                self._next += 1
            return 200, self._operation()
        if url.endswith("/listManagedInstances"):
            return 200, {"managedInstances": [
                {"instance": f"https://compute.example/instances/{n}",
                 "instanceStatus": "RUNNING"} for n in self.instances]}
        if url.endswith("/deleteInstances"):
            names = [u.rsplit("/", 1)[-1] for u in body["instances"]]
            self.instances = [i for i in self.instances
                              if i not in names]
            return 200, self._operation(compute=True)
        if "/compute-ops/" in url:
            name = url.rsplit("/", 1)[-1]
            if self._ops.get(name, 0) > 0:
                self._ops[name] -= 1
                return 200, {"name": name, "status": "RUNNING"}
            return 200, {"name": name, "status": "DONE"}
        if "/operations/" in url:
            assert "compute" not in url, \
                "compute op polled against the Container collection"
            name = url.rsplit("/", 1)[-1]
            if self._ops.get(name, 0) > 0:
                self._ops[name] -= 1
                return 200, {"name": name, "status": "RUNNING"}
            return 200, {"name": name, "status": "DONE"}
        return 404, {"error": f"unhandled {method} {url}"}


def _gke_cloud(api, cls=None):
    from ray_tpu_torch.autoscaler.gke import GkeGpuNodePoolCloud

    return (cls or GkeGpuNodePoolCloud)(
        "proj", "us-central1-a", "cluster", api.pool,
        transport=api, token_provider=lambda: "test-token",
        poll_interval_s=0.0)


def test_gke_cloud_scale_up_issues_setsize_and_polls():
    """Ref: _private/gcp/node_provider.py:19 — real REST reconcile; the
    only fake part here is the HTTP layer."""
    from ray_tpu_torch.autoscaler import BatchingNodeProvider

    api = FakeGkeRestApi(size=1)
    cloud = _gke_cloud(api)
    provider = BatchingNodeProvider(cloud)
    assert provider.non_terminated_nodes() == ["gke-gpu-0"]
    provider.create_node()
    provider.create_node()
    provider.post_process()
    assert cloud.list_nodes() == ["gke-gpu-0", "gke-gpu-1", "gke-gpu-2"]
    set_sizes = [(m, b) for m, u, b in api.calls if u.endswith(":setSize")]
    assert set_sizes == [("POST", {"nodeCount": 3})]
    # the RUNNING operation was polled to DONE
    assert any("/operations/op-0" in u for _, u, _ in api.calls)


def test_gke_cloud_targeted_delete_uses_instance_group():
    from ray_tpu_torch.autoscaler import BatchingNodeProvider

    api = FakeGkeRestApi(size=3)
    cloud = _gke_cloud(api)
    provider = BatchingNodeProvider(cloud)
    provider.non_terminated_nodes()
    provider.terminate_node("gke-gpu-1")
    provider.post_process()
    deletes = [b for m, u, b in api.calls if u.endswith("/deleteInstances")]
    assert deletes == [{"instances":
                        ["https://compute.example/instances/gke-gpu-1"]}]
    assert cloud.list_nodes() == ["gke-gpu-0", "gke-gpu-2"]


def test_gke_cloud_surfaces_api_errors():
    api = FakeGkeRestApi()
    cloud = _gke_cloud(api)
    cloud._pool_url  # touch for coverage of the url builder

    def failing(method, url, body, headers):
        return 403, {"error": {"message": "permission denied"}}
    cloud.transport = failing
    with pytest.raises(RuntimeError, match="permission denied"):
        cloud.list_nodes()


# ===================================== parity against the JAX package's


class _TraceProvider:
    """A provider recording every create/terminate in order."""

    num_cpus = 2

    def __init__(self):
        self.nodes = []
        self.events = []
        self._next = 0

    def create_node(self):
        pid = f"n{self._next}"
        self._next += 1
        self.nodes.append(pid)
        self.events.append(("create", pid))
        return pid

    def terminate_node(self, pid):
        self.nodes.remove(pid)
        self.events.append(("terminate", pid))

    def non_terminated_nodes(self):
        return list(self.nodes)


def _autoscaler_trace(pkg: str) -> list:
    """One demand trace through ``pkg``'s Autoscaler against a FakeHead
    whose nodes register as the provider launches them (by the launch
    label) and are busy exactly while demand is pending; idle nodes go
    at once (idle_timeout_s=0). Returns the provider's events and the
    counters after each update."""
    mod = importlib.import_module(f"{pkg}.autoscaler")
    label = importlib.import_module(f"{pkg}.autoscaler.autoscaler") \
        .PROVIDER_LABEL
    head, provider = FakeHead(), _TraceProvider()
    sc = mod.Autoscaler(head, provider, mod.AutoscalingPolicy(
        min_workers=1, max_workers=4, max_launch_batch=2,
        idle_timeout_s=0.0))
    registered, next_idx, log = set(), 1, []
    for demand in (0, 3, 5, 5, 1, 0, 0, 2, 0, 0, 7, 0, 0):
        for pid in provider.nodes:
            if pid not in registered:
                registered.add(pid)
                head.nodes[next_idx] = SimpleNamespace(
                    is_remote=True, alive=True, workers={},
                    resources=SimpleNamespace(labels={label: pid}))
                next_idx += 1
        for node in head.nodes.values():
            node.workers = ({"w": SimpleNamespace(state="leased")}
                            if demand else {})
        head._pending_leases = [1] * demand
        provider.events.clear()
        sc.update()
        log.append((demand, list(provider.events), sorted(provider.nodes),
                    sorted(head.nodes), sc.num_launches,
                    sc.num_terminations))
    return log


def test_autoscaler_decisions_match_reference():
    ref = _autoscaler_trace("ray_tpu")
    assert _autoscaler_trace("ray_tpu_torch") == ref
    # the trace exercises launches, the batch and max caps, idle
    # terminations and the min_workers floor
    assert any(e[0] == "terminate" for row in ref for e in row[1])
    assert max(len(row[2]) for row in ref) == 4
    assert min(len(row[2]) for row in ref) == 1


def _gke_session(api, cls) -> list:
    from ray_tpu_torch.autoscaler import BatchingNodeProvider

    cloud = _gke_cloud(api, cls)
    provider = BatchingNodeProvider(cloud)
    provider.non_terminated_nodes()
    provider.create_node()
    provider.create_node()
    provider.post_process()
    nodes = provider.non_terminated_nodes()
    provider.terminate_node(nodes[1])
    provider.post_process()
    provider.non_terminated_nodes()
    return api.calls


def test_gke_rest_requests_match_reference():
    """The port's GPU-pool cloud makes the reference TPU-pool cloud's
    requests, call for call, with only the pool's and its instances'
    names differing."""
    from ray_tpu.autoscaler.gke import GkeTpuNodePoolCloud

    ref = _gke_session(FakeGkeRestApi(size=1, pool="tpu-pool",
                                      prefix="gke-tpu"),
                       GkeTpuNodePoolCloud)
    got = _gke_session(FakeGkeRestApi(size=1), None)

    def renamed(calls):
        return json.loads(json.dumps(calls).replace("gpu-pool", "tpu-pool")
                          .replace("gke-gpu-", "gke-tpu-"))

    assert renamed(got) == json.loads(json.dumps(ref))
    assert any(u.endswith("/deleteInstances") for _, u, _ in got)
    assert sum(u.endswith(":setSize") for _, u, _ in got) == 2


def _cli_surface(parser, path=()):
    """{(subcommand path, option strings, dest): what the action takes}
    over every subcommand, recursively."""
    out = {("defaults",) + path: sorted(
        (k, getattr(v, "__name__", v)) for k, v in parser._defaults.items())}
    for a in parser._actions:
        if isinstance(a, argparse._SubParsersAction):
            for name, sub in a.choices.items():
                out.update(_cli_surface(sub, path + (name,)))
        elif not isinstance(a, argparse._HelpAction):
            out[(path, tuple(a.option_strings), a.dest)] = (
                a.nargs, a.choices, getattr(a.type, "__name__", a.type),
                a.default, a.required, a.help, a.const)
    return out


def test_cli_surface_matches_reference():
    """Every command and option of the reference's CLI, with --num-tpus
    as --num-gpus; the address file's default is the port's own."""
    from ray_tpu import scripts as ref_scripts
    from ray_tpu_torch import scripts

    def mapped(key):
        return tuple(tuple(x.replace("tpus", "gpus") for x in k)
                     if isinstance(k, tuple) else
                     k.replace("tpus", "gpus") for k in key)

    ref = {mapped(k): v for k, v in
           _cli_surface(ref_scripts.build_parser()).items()}
    got = _cli_surface(scripts.build_parser())
    key = ((), ("--address-file",), "address_file")
    assert ref[key][3] == ref_scripts.DEFAULT_ADDRESS_FILE
    assert got[key][3] == scripts.DEFAULT_ADDRESS_FILE
    assert scripts.DEFAULT_ADDRESS_FILE.endswith(
        os.path.join("ray_tpu_torch", "head_address"))
    ref[key] = got[key]
    assert got == ref
    assert ((("start",), ("--num-gpus",), "num_gpus") in got
            and not any("tpu" in str(k) for k in got))
