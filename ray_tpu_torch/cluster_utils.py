"""Virtual multi-node cluster for tests.

Analog of the reference's ``ray.cluster_utils.Cluster``
(python/ray/cluster_utils.py:99, add_node :165): N logical nodes in one
process, each with its own resource view, worker pool, and shm object store,
all hosted by the embedded head. The workhorse for scheduling / placement /
failover tests without real hosts (SURVEY.md §4.2). The port of
``ray_tpu/cluster_utils.py``: nodes declare GPUs (``num_gpus``) where the
reference's declare TPU chips; no TPU topology is carried.
"""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch.core import api


class Cluster:
    def __init__(self, initialize_head: bool = True,
                 head_node_args: Optional[dict] = None):
        self._info = None
        if initialize_head:
            args = dict(head_node_args or {})
            self._info = api.init(**args)

    @property
    def head(self):
        from ray_tpu_torch.core.api import _head

        return _head

    def add_node(self, *, num_cpus: int = 1, num_gpus: int = 0,
                 memory: Optional[int] = None,
                 object_store_memory: Optional[int] = None,
                 resources: Optional[dict] = None,
                 labels: Optional[dict] = None) -> int:
        """Add a logical node; returns its node index. A node's GPUs are
        ids 0..num_gpus-1 of the host's devices, so two logical nodes that
        each declare one GPU lease the same card."""
        return self.head.add_node(
            num_cpus=num_cpus, num_gpus=num_gpus, memory=memory,
            object_store_memory=object_store_memory, resources=resources,
            labels=labels)

    def remove_node(self, node_idx: int):
        """Kill a logical node (workers die, objects on it are lost)."""
        self.head.remove_node(node_idx)

    # ------------------------------------------------ real remote processes

    def enable_tcp(self, host: str = "127.0.0.1") -> str:
        """Open the head's TCP port; returns the tcp: address to join."""
        return self.head.enable_tcp(host=host, advertise_ip=host)

    def add_remote_node(self, *, num_cpus: int = 1, num_gpus: int = 0,
                        object_store_memory: Optional[int] = None,
                        timeout: float = 60.0):
        """Start a real node-agent PROCESS that joins over TCP — exercises
        the full multi-host path (TCP registration, delegated worker fork,
        cross-host object transfer) on one machine. Returns a
        RemoteNodeHandle with .node_idx / .terminate().
        """
        import os
        import subprocess
        import sys
        import time

        addr = self.enable_tcp()
        known = set(self.head.nodes)
        import ray_tpu_torch as _pkg

        pkg_parent = os.path.dirname(os.path.dirname(
            os.path.abspath(_pkg.__file__)))
        env = dict(os.environ)
        env["PYTHONPATH"] = pkg_parent + os.pathsep + \
            env.get("PYTHONPATH", "")
        cmd = [sys.executable, "-m", "ray_tpu_torch.core.node_agent",
               "--address", addr, "--num-cpus", str(num_cpus),
               "--num-gpus", str(num_gpus)]
        if object_store_memory:
            cmd += ["--object-store-memory", str(object_store_memory)]
        proc = subprocess.Popen(cmd, env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            new = set(self.head.nodes) - known
            if new:
                idx = new.pop()
                node = self.head.nodes.get(idx)
                return RemoteNodeHandle(
                    proc, idx, getattr(node, "store_name", ""))
            if proc.poll() is not None:
                out = proc.stdout.read().decode(errors="replace")
                raise RuntimeError(f"node agent died: {out[-2000:]}")
            time.sleep(0.05)
        proc.kill()
        raise TimeoutError("node agent did not register in time")

    def shutdown(self):
        api.shutdown()


class NodeKiller:
    """Randomized fault-injection harness.

    Analog of the reference's chaos ``NodeKillerActor``
    (python/ray/_private/test_utils.py:1386): a background thread that,
    at random intervals, kills a random *non-head* node — logical nodes
    via ``Cluster.remove_node`` and real agent processes via
    ``RemoteNodeHandle.terminate`` — while a workload runs. With
    ``respawn=True`` (the default) each killed logical node is replaced
    by a fresh node with the same CPU/GPU totals, so the cluster keeps
    capacity and a retried/lineage-reconstructed workload should
    converge despite the carnage.

    Usage::

        killer = NodeKiller(cluster, max_kills=3, seed=7)
        killer.start()
        ...run workload with max_retries=-1...
        killer.stop()
        assert killer.kills  # at least one node actually died
    """

    def __init__(self, cluster: Cluster, *,
                 interval_s=(0.2, 0.8), max_kills: int = 3,
                 respawn: bool = True, seed: Optional[int] = None,
                 protect=(0,), remote_handles=()):
        import random

        self._cluster = cluster
        self._interval = interval_s
        self._max_kills = max_kills
        self._respawn = respawn
        self._protect = set(protect)
        self._remote = list(remote_handles)
        self._rng = random.Random(seed)
        self._stop = None
        self._thread = None
        #: [(monotonic_time, node_idx, kind)] for each node actually killed
        self.kills = []
        #: exception that ended the killer thread early, if any
        self.error = None

    def _eligible(self):
        head = self._cluster.head
        logical = [(idx, n) for idx, n in list(head.nodes.items())
                   if idx not in self._protect and not n.is_remote]
        remote = [h for h in self._remote
                  if h.proc.poll() is None and
                  h.node_idx not in self._protect]
        return logical, remote

    def _kill_one(self):
        import time

        logical, remote = self._eligible()
        choices = [("logical", v) for v in logical] + \
                  [("remote", h) for h in remote]
        if not choices:
            return False
        kind, victim = self._rng.choice(choices)
        if kind == "logical":
            idx, node = victim
            total = node.resources.total.to_dict()
            labels = dict(node.resources.labels)
            self._cluster.remove_node(idx)
            self.kills.append((time.monotonic(), idx, "logical"))
            if self._respawn:
                # replacement preserves the victim's FULL resource set —
                # CPU/GPU/memory plus custom resources, so the cluster's
                # capacity holds steady. CPU/GPU pass through unrounded:
                # the resource model is fixed-point, so fractional grants
                # survive respawn.
                custom = {k: v for k, v in total.items()
                          if k not in ("CPU", "GPU", "memory",
                                       "object_store_memory")}
                self._cluster.add_node(
                    num_cpus=total.get("CPU", 0),
                    num_gpus=total.get("GPU", 0),
                    memory=total.get("memory"),
                    object_store_memory=(
                        int(total["object_store_memory"])
                        if "object_store_memory" in total else None),
                    resources=custom or None,
                    labels=labels or None)
        else:
            victim.terminate()
            self.kills.append((time.monotonic(), victim.node_idx, "remote"))
        return True

    def _run(self):
        lo, hi = self._interval
        while not self._stop.is_set() and len(self.kills) < self._max_kills:
            if self._stop.wait(self._rng.uniform(lo, hi)):
                break
            try:
                self._kill_one()
            except Exception as e:
                # a racing cluster shutdown mustn't crash the thread, but
                # record why injection stopped so tests can surface it
                self.error = e
                break

    def start(self):
        import threading

        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="node-killer", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0):
        if self._stop is not None:
            self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)


class RemoteNodeHandle:
    def __init__(self, proc, node_idx: int, store_name: str = ""):
        self.proc = proc
        self.node_idx = node_idx
        #: the agent's /dev/shm arena file name, so terminate() can
        #: sweep it — SIGKILL gives the agent no chance to unlink its
        #: own arena, and each orphan pins object_store_memory bytes of
        #: shared memory until someone removes it
        self.store_name = store_name

    def terminate(self):
        """Kill the agent process (simulates host loss) and sweep its
        leaked /dev/shm arena."""
        if self.proc.poll() is None:
            try:
                self.proc.kill()
            except OSError:
                pass
        self.proc.wait(timeout=10)
        if self.store_name:
            import os

            try:
                os.unlink(f"/dev/shm/{self.store_name}")
            except OSError:
                pass
