"""Autoscaler core loop + node providers.

Ref analogs: python/ray/autoscaler/_private/autoscaler.py:166
(StandardAutoscaler.update: read load metrics -> compute target ->
launch/terminate via NodeProvider), node_provider.py (the provider
interface), resource_demand_scheduler.py (demand -> node count).

The demand signal comes straight from the head: pending lease requests
(queued because no node can grant them) plus infeasible placement
groups. Upscale adds ceil(missing/node_size) nodes up to max_workers;
downscale terminates nodes idle longer than idle_timeout_s. The
LocalNodeProvider launches REAL node-agent processes joining over TCP —
the same join path a cloud provider implementation would drive on VMs.
"""

from __future__ import annotations

import math
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


# node label marking autoscaler-launched nodes (value = provider node id)
PROVIDER_LABEL = "ray_tpu_autoscaler_id"


class NodeProvider:
    """Minimal provider surface (ref: autoscaler/node_provider.py).

    CONTRACT: ``create_node`` must arrange for the launched node agent to
    register with the head carrying the label
    ``PROVIDER_LABEL=<returned id>`` (pass
    ``--label ray_tpu_autoscaler_id=<id>`` to the agent) — the autoscaler
    matches registered nodes to its launches by that label; unlabeled
    nodes are never adopted (so it cannot scale down somebody else's
    node) and therefore never scale down either. The autoscaler logs a
    warning when a launch stays unmatched past the grace period."""

    #: declarative providers (BatchingNodeProvider) return transient ids
    #: from create_node; the autoscaler adopts the materialized nodes by
    #: label instead of tracking the launch ids
    declarative: bool = False

    def create_node(self) -> str:
        """Launch one node; returns a provider node id (see the label
        contract above)."""
        raise NotImplementedError

    def terminate_node(self, provider_id: str):
        raise NotImplementedError

    def non_terminated_nodes(self) -> List[str]:
        raise NotImplementedError


class LocalNodeProvider(NodeProvider):
    """Node agents as local processes (tests / single-host elasticity;
    the multi-host path is identical — agents join the head over TCP)."""

    def __init__(self, head_tcp_addr: str, *, num_cpus_per_node: int = 1,
                 num_gpus_per_node: int = 0):
        import os

        self.addr = head_tcp_addr
        self.num_cpus = num_cpus_per_node
        self.num_gpus = num_gpus_per_node
        self._procs: Dict[str, subprocess.Popen] = {}
        self._next = 0
        import ray_tpu_torch as _pkg

        self._pythonpath = os.path.dirname(os.path.dirname(
            os.path.abspath(_pkg.__file__)))

    def create_node(self) -> str:
        import os

        pid = f"local-{self._next}"
        self._next += 1
        env = dict(os.environ)
        env["PYTHONPATH"] = self._pythonpath + os.pathsep + \
            env.get("PYTHONPATH", "")
        proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.core.node_agent",
             "--address", self.addr, "--num-cpus", str(self.num_cpus),
             "--num-gpus", str(self.num_gpus),
             # the label lets the autoscaler match registered nodes to
             # ITS launches (a remote driver or hand-joined agent must
             # not be adopted and later scaled down)
             "--label", f"{PROVIDER_LABEL}={pid}"],
            env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.STDOUT, start_new_session=True)
        self._procs[pid] = proc
        return pid

    def terminate_node(self, provider_id: str):
        proc = self._procs.pop(provider_id, None)
        if proc is not None and proc.poll() is None:
            proc.terminate()

    def non_terminated_nodes(self) -> List[str]:
        return [pid for pid, p in self._procs.items() if p.poll() is None]


@dataclass
class AutoscalingPolicy:
    """Knobs (ref: cluster-config max_workers / idle_timeout_minutes /
    upscaling_speed)."""

    min_workers: int = 0
    max_workers: int = 4
    idle_timeout_s: float = 60.0
    update_interval_s: float = 1.0
    # launch at most this many nodes per update (ref: upscaling_speed)
    max_launch_batch: int = 2


@dataclass
class _TrackedNode:
    provider_id: str
    node_idx: Optional[int] = None      # filled once it registers
    launched_at: float = field(default_factory=time.monotonic)
    idle_since: Optional[float] = None
    warned: bool = False                # label-contract warning emitted


class Autoscaler:
    """The update loop (ref: StandardAutoscaler.update)."""

    def __init__(self, head, provider: NodeProvider,
                 policy: Optional[AutoscalingPolicy] = None):
        self._head = head
        self._provider = provider
        self.policy = policy or AutoscalingPolicy()
        self._tracked: List[_TrackedNode] = []
        self._known_idxs: set = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.num_launches = 0
        self.num_terminations = 0

    # ------------------------------------------------------------ lifecycle

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="autoscaler")
        self._thread.start()

    def stop(self):
        self._stop.set()

    def _loop(self):
        while not self._stop.wait(self.policy.update_interval_s):
            try:
                self.update()
            except Exception:  # noqa: BLE001 — scaling must not die
                pass

    # --------------------------------------------------------------- update

    def pending_demand(self) -> int:
        """Lease requests the cluster cannot currently grant (the
        reference reads per-raylet resource_load; our head already queues
        exactly the unsatisfiable requests)."""
        with self._head._lock:
            return len(self._head._pending_leases) + \
                len(self._head._pending_pg)

    def update(self):
        # ONE provider poll per update: a declarative provider resets its
        # pending ScaleRequest here (ref: batching_node_provider's
        # non_terminated_nodes contract)
        alive = list(self._provider.non_terminated_nodes())
        declarative = getattr(self._provider, "declarative", False)
        self._reconcile_membership(alive if declarative else None)
        demand = self.pending_demand()
        count = len(alive)
        if demand > 0:
            per_node = max(self._provider_cpus_per_node(), 1)
            want = math.ceil(demand / per_node)
            capacity = self.policy.max_workers - count
            n = min(want, self.policy.max_launch_batch, max(capacity, 0))
            for _ in range(n):
                pid = self._provider.create_node()
                if not declarative:
                    self._tracked.append(_TrackedNode(pid))
                self.num_launches += 1
                count += 1
        else:
            count -= self._scale_down(count)
        # honor min_workers
        for _ in range(max(self.policy.min_workers - count, 0)):
            pid = self._provider.create_node()
            if not declarative:
                self._tracked.append(_TrackedNode(pid))
            self.num_launches += 1
            count += 1
        # declarative providers flush all of the above as ONE request
        post = getattr(self._provider, "post_process", None)
        if post is not None:
            post()

    def _provider_cpus_per_node(self) -> int:
        return getattr(self._provider, "num_cpus", 1)

    def _reconcile_membership(self, provider_ids=None):
        """Match provider nodes to registered head nodes (by the launch
        label — adopting ANY new node would let scale-down evict remote
        drivers or hand-joined agents) + track idleness.

        ``provider_ids`` (declarative providers only): the cloud's
        current node list — ids the cloud materialized that we aren't
        tracking yet are adopted, and tracked ids the cloud no longer
        reports are dropped."""
        if provider_ids is not None:
            tracked_ids = {t.provider_id for t in self._tracked}
            for pid in provider_ids:
                if pid not in tracked_ids:
                    self._tracked.append(_TrackedNode(pid))
            gone = set(tracked_ids) - set(provider_ids)
            for t in list(self._tracked):
                if t.provider_id in gone:
                    self._tracked.remove(t)
                    self._known_idxs.discard(t.node_idx)
        with self._head._lock:
            remote = {idx: n for idx, n in self._head.nodes.items()
                      if n.is_remote and n.alive}
        by_provider_id = {
            n.resources.labels.get(PROVIDER_LABEL): idx
            for idx, n in remote.items()
            if n.resources.labels.get(PROVIDER_LABEL)}
        now_mono = time.monotonic()
        for t in self._tracked:
            if t.node_idx is None:
                idx = by_provider_id.get(t.provider_id)
                if idx is not None and idx not in self._known_idxs:
                    t.node_idx = idx
                    self._known_idxs.add(idx)
                elif now_mono - t.launched_at > 120 and not t.warned:
                    t.warned = True
                    import sys

                    print(
                        f"ray_tpu_torch autoscaler: launch {t.provider_id} "
                        f"has not registered with label {PROVIDER_LABEL}="
                        f"{t.provider_id} after 120s — the provider must "
                        f"pass it or the node can never be scaled down "
                        f"(see NodeProvider docstring)", file=sys.stderr)
        now = time.monotonic()
        for t in self._tracked:
            node = remote.get(t.node_idx)
            if node is None:
                continue
            busy = any(w.state in ("leased", "actor", "starting")
                       for w in node.workers.values())
            if busy:
                t.idle_since = None
            elif t.idle_since is None:
                t.idle_since = now

    def _scale_down(self, alive: int) -> int:
        """Terminate idle tracked nodes; returns how many were removed."""
        now = time.monotonic()
        floor = self.policy.min_workers
        removed = 0
        for t in list(self._tracked):
            if alive <= floor:
                break
            if t.node_idx is None or t.idle_since is None:
                continue
            if now - t.idle_since < self.policy.idle_timeout_s:
                continue
            # drain head-side first, then the provider process
            try:
                self._head.remove_node(t.node_idx)
            except Exception:  # noqa: BLE001
                pass
            self._provider.terminate_node(t.provider_id)
            self._tracked.remove(t)
            self._known_idxs.discard(t.node_idx)
            self.num_terminations += 1
            alive -= 1
            removed += 1
        return removed
