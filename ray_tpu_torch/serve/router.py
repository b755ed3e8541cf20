"""Client-side request router: power-of-two-choices replica selection.

Ref analog: python/ray/serve/_private/router.py:281
(PowerOfTwoChoicesReplicaScheduler) + :985 (Router). Re-design: no asyncio —
a per-process router per deployment tracks its own in-flight count per
replica, picks the less-loaded of two random replicas, and blocks (with
backpressure) when every replica is at ``max_concurrent_queries``. Replica
membership is refreshed from the controller when its ``routing_version``
moves (polled with a small TTL; the reference uses a long-poll broker).

r14 additions:

- **Slow-node awareness**: the routing snapshot carries the set of nodes
  the head's ``slow_node`` detector currently flags; replicas on flagged
  nodes are DEPRIORITIZED — power-of-two-choices runs over the clean
  pool and falls back to flagged replicas only when every clean one is
  at its concurrency bound (degraded capacity still beats a timeout).
- **Queue-depth reporting**: each snapshot refresh piggybacks this
  router's per-replica in-flight counts PLUS the callers currently
  blocked in ``_acquire_replica`` (reserved ``__waiting__`` key) to the
  controller, which fuses them across router processes into the
  autoscaler's queue-depth signal — the replica itself only sees
  requests its executor already started, and slot counts alone saturate
  at capacity, so in-flight + waiters IS the queue. No extra RPC: the
  report rides the refresh the router makes anyway, keeping the
  controller off the per-request hot path.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Dict, FrozenSet, List, Optional, Tuple

import ray_tpu_torch

_REFRESH_TTL_S = 0.25


class Router:
    def __init__(self, app_name: str, deployment: str):
        from ray_tpu_torch.core.ids import _random_bytes

        self.app = app_name
        self.deployment = deployment
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        # (replica_id, handle, node_idx) triples
        self._replicas: List[Tuple[str, object, int]] = []
        self._slow_nodes: FrozenSet[int] = frozenset()
        self._inflight: Dict[str, int] = {}
        # callers blocked in _acquire_replica: demand beyond capacity.
        # Slot-holding counts saturate at n_replicas * max_q, so without
        # this the autoscaler can never see a backlog past capacity
        # (and would happily SHRINK a saturated fleet).
        self._waiting = 0
        self._max_q = 1
        self._version = -1
        self._last_refresh = 0.0
        self._outstanding: Dict[object, str] = {}  # ObjectRef -> replica_id
        self._model_affinity: Dict[str, str] = {}  # model_id -> replica_id
        self._drainer: Optional[threading.Thread] = None
        self._controller = None
        # stable identity for the controller's per-router depth table
        self._router_id = _random_bytes(8).hex()

    # ------------------------------------------------------------ membership

    def _controller_handle(self):
        if self._controller is None:
            from .controller import CONTROLLER_NAME

            self._controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        return self._controller

    def _refresh(self, force: bool = False):
        now = time.monotonic()
        if not force and now - self._last_refresh < _REFRESH_TTL_S:
            return
        self._last_refresh = now
        ctrl = self._controller_handle()
        with self._lock:
            depths = dict(self._inflight)
            if self._waiting:
                # reserved key (replica ids are hex): fused into the
                # controller's queue-depth sum like any replica count
                depths["__waiting__"] = self._waiting
        version, replicas, max_q, slow = ray_tpu_torch.get(
            ctrl.get_routing_snapshot.remote(self.app, self.deployment,
                                             self._router_id, depths),
            timeout=30)
        with self._lock:
            self._slow_nodes = frozenset(slow)
            if version != self._version:
                self._version = version
                self._replicas = replicas
                self._max_q = max(1, max_q)
                known = {rid for rid, _, _ in replicas}
                self._inflight = {rid: self._inflight.get(rid, 0)
                                  for rid in known}
                self._cond.notify_all()

    # ------------------------------------------------------------- dispatch

    def assign(self, method_name: str, args: tuple, kwargs: dict,
               timeout_s: float = 60.0, meta: Optional[dict] = None):
        """Pick a replica (power of two choices) and push the request.

        Returns the resulting ObjectRef. Blocks while all replicas are at
        max_concurrent_queries (client-side backpressure). Positional
        request args ship as REAL task args (``*args`` tail) so by-ref
        payloads ride the zero-copy wire path end-to-end."""
        rid, handle = self._acquire_replica(timeout_s, meta)
        ref = None
        try:
            ref = handle.handle_request.remote(
                method_name, kwargs, meta, *args)
            with self._lock:
                self._outstanding[ref] = rid
                self._ensure_drainer_locked()
            return ref
        finally:
            if ref is None:  # submission itself failed
                self.release(rid)

    def assign_stream(self, method_name: str, args: tuple, kwargs: dict,
                      timeout_s: float = 60.0,
                      meta: Optional[dict] = None):
        """Pick a replica for a STREAMING request. Returns (replica_id,
        actor_handle, stream_id_ref); the caller drives stream_next and
        MUST call release(replica_id) when the stream ends — the slot
        stays held for the stream's whole lifetime."""
        rid, handle = self._acquire_replica(timeout_s, meta)
        try:
            sid_ref = handle.start_stream.remote(
                method_name, kwargs, meta, *args)
        except BaseException:
            self.release(rid)
            raise
        return rid, handle, sid_ref

    def release(self, rid: str):
        with self._lock:
            if rid in self._inflight:
                self._inflight[rid] = max(0, self._inflight[rid] - 1)
            self._cond.notify_all()

    def _acquire_replica(self, timeout_s: float, meta: Optional[dict]):
        self._refresh()
        model_id = (meta or {}).get("multiplexed_model_id", "")
        deadline = time.monotonic() + timeout_s
        waiting = False
        try:
            while True:
                with self._lock:
                    choice = self._choose_locked(model_id)
                    if choice is not None:
                        rid, handle = choice
                        self._inflight[rid] = \
                            self._inflight.get(rid, 0) + 1
                        if model_id:
                            # pin affinity only when the model has no
                            # live holder: a request spilling off a
                            # momentarily saturated holder must not
                            # migrate the model (load/evict ping-pong
                            # under bursts)
                            cur = self._model_affinity.get(model_id)
                            if cur is None or cur not in {
                                    r for r, _, _ in self._replicas}:
                                self._model_affinity[model_id] = rid
                        return rid, handle
                    if not waiting:
                        # blocked past capacity: count this caller into
                        # the queue-depth report (see _waiting)
                        waiting = True
                        self._waiting += 1
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError(
                            f"no replica of {self.app}/{self.deployment} "
                            f"available within {timeout_s}s")
                    self._cond.wait(min(remaining, _REFRESH_TTL_S))
                self._refresh(force=not self._replicas)
        finally:
            if waiting:
                with self._lock:
                    self._waiting -= 1

    def _choose_locked(self, model_id: str = ""
                       ) -> Optional[Tuple[str, object]]:
        if model_id:
            # multiplexing affinity: prefer the replica that already holds
            # the model, unless it is saturated (ref: multiplexed routing
            # in the reference's replica scheduler). The holder rides
            # THROUGH the slow-node filter below — the model is already
            # resident there, and re-loading it on a clean replica costs
            # more than the flagged host's latency (and would scatter the
            # model into the load/evict ping-pong the pin exists to stop)
            want = self._model_affinity.get(model_id)
            if want is not None:
                for rid, h, _n in self._replicas:
                    if rid == want and \
                            self._inflight.get(rid, 0) < self._max_q:
                        return rid, h
        avail = [(rid, h) for rid, h, n in self._replicas
                 if self._inflight.get(rid, 0) < self._max_q
                 and n not in self._slow_nodes]
        if not avail:
            # every clean replica is saturated (or none exist): fall
            # back to replicas on detector-flagged nodes — a slow host
            # still beats refusing the request (the reference likewise
            # soft-deprioritizes rather than hard-drains)
            avail = [(rid, h) for rid, h, _n in self._replicas
                     if self._inflight.get(rid, 0) < self._max_q]
        if not avail:
            return None
        if len(avail) == 1:
            return avail[0]
        a, b = random.sample(avail, 2)
        return a if self._inflight.get(a[0], 0) <= \
            self._inflight.get(b[0], 0) else b

    # ------------------------------------------------------------ drain loop

    def _ensure_drainer_locked(self):
        if self._drainer is None or not self._drainer.is_alive():
            self._drainer = threading.Thread(
                target=self._drain_loop, daemon=True,
                name=f"serve-router-{self.deployment}")
            self._drainer.start()

    def _drain_loop(self):
        """Release in-flight slots as replica replies land."""
        while True:
            with self._lock:
                refs = list(self._outstanding)
            if not refs:
                with self._lock:
                    if not self._outstanding:
                        self._drainer = None
                        return
                continue
            done, _ = ray_tpu_torch.wait(refs, num_returns=1, timeout=0.2,
                                   fetch_local=False)
            if not done:
                continue
            with self._lock:
                for ref in done:
                    rid = self._outstanding.pop(ref, None)
                    if rid is not None and rid in self._inflight:
                        self._inflight[rid] = max(
                            0, self._inflight[rid] - 1)
                self._cond.notify_all()


_routers: Dict[Tuple[str, str], Router] = {}
_routers_lock = threading.Lock()


def get_router(app_name: str, deployment: str) -> Router:
    key = (app_name, deployment)
    with _routers_lock:
        r = _routers.get(key)
        if r is None:
            r = _routers[key] = Router(app_name, deployment)
        return r


def reset_routers():
    """Drop cached routers (test isolation across serve sessions)."""
    with _routers_lock:
        _routers.clear()
