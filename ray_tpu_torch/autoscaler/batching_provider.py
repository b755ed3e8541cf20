"""Declarative (batching) node provider + GKE-style GPU node pools.

Ref analogs: python/ray/autoscaler/batching_node_provider.py:63
(BatchingNodeProvider — create/terminate coalesce into ONE ScaleRequest
submitted per autoscaler update, the KubeRay pattern of PATCHing a
workerGroup's replica count) and _private/gcp/node_provider.py:19
(GCPTPU — accelerator node pools with accelerator labels).

Re-design: the cloud side is an injectable ``CloudAPI`` with a single
``submit_scale_request`` method. ``FakeGkeGpuCloud`` implements it for
tests and single-host clusters by provisioning "VMs" as local node-agent
processes that join the head over TCP carrying GPU resources + the
accelerator label — the same join path a real GKE pool's pods would take,
including asynchronous provisioning delay. (The reference's
``FakeGkeTpuCloud`` models a TPU pool of 4 chips a node; this one a pool
of one-GPU nodes.)
"""

from __future__ import annotations

import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .autoscaler import PROVIDER_LABEL, NodeProvider


@dataclass
class ScaleRequest:
    """One declarative resize (ref: batching_node_provider.ScaleRequest).

    ``desired_num_workers`` is the target pool size; ``workers_to_delete``
    names nodes the autoscaler chose to drain (cloud must honor the
    specific picks, not just the count — KubeRay's
    workersToDelete field)."""

    desired_num_workers: int = 0
    workers_to_delete: List[str] = field(default_factory=list)


class CloudAPI:
    """What a cloud integration must provide."""

    def list_nodes(self) -> List[str]:
        """Provider ids of non-terminated pool nodes."""
        raise NotImplementedError

    def submit_scale_request(self, req: ScaleRequest):
        raise NotImplementedError


class BatchingNodeProvider(NodeProvider):
    """Coalesces the autoscaler's per-node calls into one ScaleRequest.

    The autoscaler keeps calling ``create_node``/``terminate_node`` like
    any provider; nothing touches the cloud until ``post_process()``
    (invoked once at the end of each autoscaler update), which submits a
    single declarative resize iff something changed — ref
    batching_node_provider.py:63 (same three-method reuse + post_process
    hook).
    """

    declarative = True

    def __init__(self, cloud: CloudAPI):
        self.cloud = cloud
        self.scale_request = ScaleRequest()
        self._changed = False
        self.num_scale_requests = 0

    @property
    def num_cpus(self) -> int:  # demand -> node-count sizing
        return getattr(self.cloud, "num_cpus", 1)

    def non_terminated_nodes(self) -> List[str]:
        nodes = self.cloud.list_nodes()
        # each update cycle starts from observed reality (ref:
        # non_terminated_nodes resets the ScaleRequest)
        self.scale_request = ScaleRequest(desired_num_workers=len(nodes))
        self._changed = False
        return nodes

    def create_node(self) -> str:
        self.scale_request.desired_num_workers += 1
        self._changed = True
        # id is assigned by the cloud when the node materializes; the
        # autoscaler matches it via the PROVIDER_LABEL contract
        return f"pending-{self.scale_request.desired_num_workers}"

    def terminate_node(self, provider_id: str):
        if provider_id.startswith("pending-"):
            self.scale_request.desired_num_workers = max(
                0, self.scale_request.desired_num_workers - 1)
        else:
            self.scale_request.workers_to_delete.append(provider_id)
            self.scale_request.desired_num_workers = max(
                0, self.scale_request.desired_num_workers - 1)
        self._changed = True

    def post_process(self):
        if self._changed:
            self.cloud.submit_scale_request(self.scale_request)
            self.num_scale_requests += 1
            self._changed = False


class FakeGkeGpuCloud(CloudAPI):
    """A fake GKE GPU node pool (ref: the reference's
    FakeMultiNodeProvider test cloud + GCP accelerator node semantics):
    by default a pool of ``a3-highgpu-1g`` nodes, one H100 each, labelled
    ``accelerator=nvidia-h100-80gb`` (GKE's accelerator name).

    ``submit_scale_request`` resizes the pool: grow provisions node-agent
    processes (after ``provision_delay_s``, emulating VM boot) that join
    the head over TCP with ``num_gpus`` GPUs and the accelerator label;
    shrink honors ``workers_to_delete`` first, then trims newest-first.
    """

    def __init__(self, head_tcp_addr: str, *, num_gpus_per_node: int = 1,
                 num_cpus_per_node: int = 4,
                 accelerator: str = "nvidia-h100-80gb",
                 provision_delay_s: float = 0.0):
        import os

        self.addr = head_tcp_addr
        self.num_gpus = num_gpus_per_node
        self.num_cpus = num_cpus_per_node
        self.accelerator = accelerator
        self.provision_delay_s = provision_delay_s
        self._procs: Dict[str, subprocess.Popen] = {}
        self._next = 0
        self._lock = threading.Lock()
        self.scale_requests: List[ScaleRequest] = []
        import ray_tpu_torch as _pkg

        self._pythonpath = os.path.dirname(os.path.dirname(
            os.path.abspath(_pkg.__file__)))

    # ------------------------------------------------------------- CloudAPI

    def list_nodes(self) -> List[str]:
        with self._lock:
            return [pid for pid, p in self._procs.items()
                    if p.poll() is None]

    def submit_scale_request(self, req: ScaleRequest):
        self.scale_requests.append(req)
        threading.Thread(target=self._reconcile, args=(req,),
                         daemon=True, name="fake-gke").start()

    # ------------------------------------------------------------ internals

    def _reconcile(self, req: ScaleRequest):
        if self.provision_delay_s:
            time.sleep(self.provision_delay_s)
        with self._lock:
            for pid in req.workers_to_delete:
                self._kill(pid)
            alive = [pid for pid, p in self._procs.items()
                     if p.poll() is None]
            # trim newest-first beyond the declared size
            while len(alive) > req.desired_num_workers:
                self._kill(alive.pop())
            while len(alive) < req.desired_num_workers:
                alive.append(self._boot())

    def _kill(self, pid: str):
        proc = self._procs.pop(pid, None)
        if proc is not None and proc.poll() is None:
            proc.terminate()

    def _boot(self) -> str:
        import os

        pid = f"gke-{self.accelerator}-{self._next}"
        self._next += 1
        env = dict(os.environ)
        env["PYTHONPATH"] = self._pythonpath + os.pathsep + \
            env.get("PYTHONPATH", "")
        proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.core.node_agent",
             "--address", self.addr,
             "--num-cpus", str(self.num_cpus),
             "--num-gpus", str(self.num_gpus),
             "--label", f"{PROVIDER_LABEL}={pid}",
             "--label", f"accelerator={self.accelerator}"],
            env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.STDOUT, start_new_session=True)
        self._procs[pid] = proc
        return pid

    def shutdown(self):
        with self._lock:
            for pid in list(self._procs):
                self._kill(pid)
