"""GKE GPU node-pool cloud: real Container/Compute REST calls.

Ref analogs: python/ray/autoscaler/_private/gcp/node_provider.py:19
(GCPCompute/GCPTPU split — resource-specific REST clients behind one
provider interface) and the KubeRay path batching_node_provider.py
models (one declarative resize per update).

Re-design: everything cloud-specific lives behind ``CloudAPI``'s two
methods, and everything network-specific behind an injectable
``transport`` callable, so the reconciler logic is fully testable on a
sealed image (tests inject an in-memory GKE emulation; production uses
``RestTransport``). The REST surface used:

  GET  {container}/v1/projects/{p}/locations/{l}/clusters/{c}/nodePools/{np}
       -> {"initialNodeCount", "instanceGroupUrls": [...]}
  POST .../nodePools/{np}:setSize          {"nodeCount": N} -> Operation
  GET  {container}/v1/projects/{p}/locations/{l}/operations/{op}
  POST {ig}/deleteInstances  {"instances": [url, ...]} (targeted drain)
  POST {ig}/listManagedInstances -> {"managedInstances": [...]}

GPU-specific bits ride node-pool config (machine type a3-highgpu-1g
etc. and the accelerator type, e.g. nvidia-h100-80gb), which this module
treats as pre-provisioned pool properties — resizing never changes a
node's GPUs. (The reference's ``GkeTpuNodePoolCloud`` makes the same
calls over a TPU node pool.)
"""

from __future__ import annotations

import json
import time
from typing import Callable, Dict, List, Optional, Tuple

from .batching_provider import CloudAPI, ScaleRequest

# transport(method, url, body_dict_or_None, headers) -> (status, json_dict)
Transport = Callable[[str, str, Optional[dict], Dict[str, str]],
                     Tuple[int, dict]]

CONTAINER_API = "https://container.googleapis.com"


class RestTransport:
    """urllib-based default transport (production path).

    Kept import-light and dependency-free: the sealed test image has no
    google-cloud SDK, and the reference's discovery-client dependency is
    exactly what the injectable-transport design avoids.
    """

    def __init__(self, timeout_s: float = 30.0):
        self.timeout_s = timeout_s

    def __call__(self, method: str, url: str, body: Optional[dict],
                 headers: Dict[str, str]) -> Tuple[int, dict]:
        import urllib.error
        import urllib.request

        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method,
                                     headers={
                                         "Content-Type": "application/json",
                                         **headers})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                payload = r.read()
                return r.status, json.loads(payload) if payload else {}
        except urllib.error.HTTPError as e:
            try:
                return e.code, json.loads(e.read())
            except Exception:
                return e.code, {}


def metadata_token_provider(transport: Optional[Transport] = None
                            ) -> Callable[[], str]:
    """OAuth token from the GCE metadata server (how in-cluster pods and
    VMs authenticate; no SDK needed)."""
    tr = transport or RestTransport()

    def token() -> str:
        status, body = tr(
            "GET",
            "http://metadata.google.internal/computeMetadata/v1/"
            "instance/service-accounts/default/token",
            None, {"Metadata-Flavor": "Google"})
        if status != 200:
            raise RuntimeError(f"metadata token fetch failed: {status}")
        return body["access_token"]
    return token


class GkeGpuNodePoolCloud(CloudAPI):
    """CloudAPI over one GKE GPU node pool.

    ``submit_scale_request`` performs the real reconcile:
      1. targeted drains via the pool's instance group's
         ``deleteInstances`` (KubeRay's workersToDelete semantics — the
         autoscaler's specific picks are honored, not just a count);
      2. ``nodePools:setSize`` to the declared size;
      3. bounded polling of the returned Operations.
    """

    def __init__(self, project: str, location: str, cluster: str,
                 node_pool: str, *,
                 transport: Optional[Transport] = None,
                 token_provider: Optional[Callable[[], str]] = None,
                 api_base: str = CONTAINER_API,
                 operation_timeout_s: float = 600.0,
                 poll_interval_s: float = 2.0):
        self.project, self.location = project, location
        self.cluster, self.node_pool = cluster, node_pool
        self.transport: Transport = transport or RestTransport()
        self._token = token_provider or metadata_token_provider()
        self.api_base = api_base.rstrip("/")
        self.operation_timeout_s = operation_timeout_s
        self.poll_interval_s = poll_interval_s

    # ------------------------------------------------------------ plumbing

    def _call(self, method: str, url: str,
              body: Optional[dict] = None) -> dict:
        status, payload = self.transport(
            method, url, body,
            {"Authorization": f"Bearer {self._token()}"})
        if status // 100 != 2:
            raise RuntimeError(
                f"{method} {url} -> {status}: "
                f"{payload.get('error', payload)}")
        return payload

    @property
    def _pool_url(self) -> str:
        return (f"{self.api_base}/v1/projects/{self.project}/locations/"
                f"{self.location}/clusters/{self.cluster}/nodePools/"
                f"{self.node_pool}")

    def _wait_operation(self, op: dict):
        """Poll an Operation until DONE (bounded). Compute Engine ops
        (returned by instance-group deleteInstances) carry a selfLink and
        must be polled THERE — they do not exist in the Container API's
        operations collection; Container ops are polled by name."""
        name = op.get("name")
        if not name or op.get("status") == "DONE":
            return
        url = op.get("selfLink") or (
            f"{self.api_base}/v1/projects/{self.project}/locations/"
            f"{self.location}/operations/{name}")
        deadline = time.monotonic() + self.operation_timeout_s
        while time.monotonic() < deadline:
            cur = self._call("GET", url)
            if cur.get("status") == "DONE":
                if cur.get("error"):
                    raise RuntimeError(
                        f"operation {name} failed: {cur['error']}")
                return
            time.sleep(self.poll_interval_s)
        raise TimeoutError(f"operation {name} not DONE after "
                           f"{self.operation_timeout_s}s")

    def _instance_groups(self) -> List[str]:
        pool = self._call("GET", self._pool_url)
        return list(pool.get("instanceGroupUrls", []))

    def _managed_instances(self, ig_url: str) -> List[dict]:
        out = self._call("POST", f"{ig_url}/listManagedInstances")
        return list(out.get("managedInstances", []))

    # ------------------------------------------------------------ CloudAPI

    def list_nodes(self) -> List[str]:
        """Non-terminated node names across the pool's instance groups
        (the node name doubles as the PROVIDER_LABEL value kubelet sets)."""
        nodes = []
        for ig in self._instance_groups():
            for inst in self._managed_instances(ig):
                if inst.get("instanceStatus") not in ("STOPPING",
                                                     "TERMINATED"):
                    nodes.append(inst["instance"].rsplit("/", 1)[-1])
        return nodes

    def submit_scale_request(self, req: ScaleRequest):
        if req.workers_to_delete:
            # targeted drain: map node names back to instance URLs per
            # instance group and deleteInstances (resizes the group too)
            wanted = set(req.workers_to_delete)
            for ig in self._instance_groups():
                urls = [inst["instance"]
                        for inst in self._managed_instances(ig)
                        if inst["instance"].rsplit("/", 1)[-1] in wanted]
                if urls:
                    op = self._call("POST", f"{ig}/deleteInstances",
                                    {"instances": urls})
                    self._wait_operation(op)
        op = self._call("POST", f"{self._pool_url}:setSize",
                        {"nodeCount": int(req.desired_num_workers)})
        self._wait_operation(op)
