"""Replica actor: hosts one copy of a deployment's callable.

Ref analog: python/ray/serve/_private/replica.py:237 (handle_request) —
re-designed: the replica is a plain ``max_concurrency``-threaded actor
(queries run concurrently on its thread pool; ``@serve.batch`` coalesces
across those threads), and the GPU path is first-class: a deployment whose
``ray_actor_options`` request GPUs constructs its model inside the replica
process with the GPU(s) already assigned (``CUDA_VISIBLE_DEVICES``).
"""

from __future__ import annotations

import threading
import time
from typing import Any

from .config import ReplicaMetrics


class HandleMarker:
    """Placeholder for a DeploymentHandle inside pickled init args."""

    def __init__(self, deployment_name: str, app_name: str):
        self.deployment_name = deployment_name
        self.app_name = app_name


def _resolve_markers(obj, _refs=None):
    """Rehydrate HandleMarkers and fetch by-ref init args.

    Weights-by-ref (r14): large init args are put() into the object
    store ONCE at serve.run() time (or passed as refs by the user) and
    fetched here through the object plane — concurrent replica
    cold-starts ride the cooperative pipelined broadcast tree (r9) and
    the zero-copy typed reducer (r13) instead of each unpickling a
    private copy shipped inside CREATE_ACTOR args. The controller
    pre-warms these refs onto nodes at scale-up decision time, so the
    fetch usually joins an in-flight pull or finds the bytes already
    local. All refs in the tree are fetched in ONE batched get (k
    weight shards overlap their pulls instead of paying k serial
    transfers)."""
    import ray_tpu_torch
    from ray_tpu_torch.core.object_ref import ObjectRef

    from .handle import DeploymentHandle

    if _refs is None:
        # pass 1: collect unique refs, batch-fetch, then substitute
        refs, seen = [], set()

        def collect(o):
            if isinstance(o, ObjectRef):
                if o.id not in seen:
                    seen.add(o.id)
                    refs.append(o)
            elif isinstance(o, (list, tuple)):
                for x in o:
                    collect(x)
            elif isinstance(o, dict):
                for v in o.values():
                    collect(v)
        collect(obj)
        _refs = {}
        if refs:
            for r, v in zip(refs, ray_tpu_torch.get(refs)):
                _refs[r.id] = v
    if isinstance(obj, HandleMarker):
        return DeploymentHandle(obj.deployment_name, obj.app_name)
    if isinstance(obj, ObjectRef):
        return _refs[obj.id]
    if isinstance(obj, (list, tuple)):
        return type(obj)(_resolve_markers(x, _refs) for x in obj)
    if isinstance(obj, dict):
        return {k: _resolve_markers(v, _refs) for k, v in obj.items()}
    return obj


def _resolve_request_refs(args: tuple, kwargs: dict):
    """Shallow by-ref resolution for request payloads: top-level args
    arrive as real task args (the runtime already fetched ARG_REF
    entries zero-copy before dispatch), but refs nested one level down
    — kwargs values and DeploymentResponse composition through
    non-handle paths — still reach the replica as ObjectRefs. Resolve
    those here so user code always sees values. Shallow on purpose: a
    ref buried deeper inside user containers stays a ref, same as task
    semantics. All refs fetch in ONE batched get (overlapped pulls)."""
    import ray_tpu_torch
    from ray_tpu_torch.core.object_ref import ObjectRef

    refs = [a for a in args if isinstance(a, ObjectRef)]
    refs += [v for v in kwargs.values() if isinstance(v, ObjectRef)]
    if not refs:
        return args, kwargs
    vals = iter(ray_tpu_torch.get(refs))
    args = tuple(next(vals) if isinstance(a, ObjectRef) else a
                 for a in args)
    kwargs = {k: next(vals) if isinstance(v, ObjectRef) else v
              for k, v in kwargs.items()}
    return args, kwargs


class ServeReplica:
    """The actor class every replica runs (one per replica)."""

    def __init__(self, payload: bytes, replica_id: str):
        from ray_tpu_torch.core.serialization import loads

        spec = loads(payload)
        self._replica_id = replica_id
        self._is_function = spec["is_function"]
        self._lock = threading.Lock()
        self._ongoing = 0
        self._completed = 0
        self._healthy = True
        self._draining = False
        self._streams = {}      # stream id -> (iterator, meta)
        init_args = _resolve_markers(spec["init_args"])
        init_kwargs = _resolve_markers(spec["init_kwargs"])
        if self._is_function:
            self._callable = spec["func_or_class"]
        else:
            self._callable = spec["func_or_class"](*init_args, **init_kwargs)
        user_config = spec.get("user_config")
        if user_config is not None:
            self.reconfigure(user_config)

    # ------------------------------------------------------------- serving

    def _resolve_fn(self, method_name: str):
        if self._is_function:
            return self._callable
        if method_name == "__call__":
            fn = self._callable
            if not callable(fn):
                raise TypeError(
                    f"deployment class {type(self._callable).__name__} "
                    "has no __call__; call a named method instead")
            return fn
        return getattr(self._callable, method_name)

    def handle_request(self, method_name: str, kwargs: dict,
                       meta: dict = None, *args):
        """One request. Positional request args ride as REAL task args
        (``*args``) rather than nested in a tuple (r14): a large
        payload the handle converted to a by-ref arg is fetched by the
        worker runtime before dispatch — arena-backed zero-copy read,
        dispatch-time prefetch overlap, and the fetch shows up as the
        task's ``arg_fetch`` phase instead of hiding inside exec."""
        from .multiplex import _set_request_model_id

        # count the request BEFORE resolving by-ref payloads: fetching a
        # large kwarg over a slow link can take hundreds of ms, and a
        # replica saturated in fetches must not report idle to the
        # autoscaler's replica-side load signal
        with self._lock:
            self._ongoing += 1
        try:
            args, kwargs = _resolve_request_refs(args, kwargs or {})
            _set_request_model_id(
                (meta or {}).get("multiplexed_model_id", ""))
            try:
                return self._resolve_fn(method_name)(*args, **kwargs)
            finally:
                _set_request_model_id("")
        finally:
            with self._lock:
                self._ongoing -= 1
                self._completed += 1

    # ------------------------------------------------------- streaming

    def start_stream(self, method_name: str, kwargs: dict,
                     meta: dict = None, *args) -> str:
        """Begin a streaming response: run the (generator) callable, park
        its iterator, return a stream id the client drains with
        stream_next (ref: replica.py:339 streaming generator support).
        The stream counts as one ongoing request until it ends.
        Positional args ride as real task args (see handle_request)."""
        from ray_tpu_torch.core.ids import _random_bytes

        from .multiplex import _set_request_model_id

        # count BEFORE resolving by-ref payloads, same invariant as
        # handle_request: a replica saturated fetching large request
        # args must not report idle to the autoscaler's replica signal
        with self._lock:
            self._ongoing += 1
        try:
            args, kwargs = _resolve_request_refs(args, kwargs or {})
            _set_request_model_id(
                (meta or {}).get("multiplexed_model_id", ""))
            try:
                result = self._resolve_fn(method_name)(*args, **kwargs)
            finally:
                _set_request_model_id("")
            it = iter(result)
            sid = _random_bytes(8).hex()  # pooled entropy: per-request
            with self._lock:
                self._streams[sid] = (it, meta or {})
            return sid
        except BaseException:
            with self._lock:
                self._ongoing -= 1
            raise

    def cancel_stream(self, sid: str):
        """Abandoned stream (client gone): drop the parked iterator and
        free its request slot."""
        with self._lock:
            entry = self._streams.pop(sid, None)
            if entry is not None:
                self._ongoing -= 1
                self._completed += 1
        if entry is not None and hasattr(entry[0], "close"):
            try:
                entry[0].close()
            except Exception:  # noqa: BLE001 — generator cleanup
                pass

    def stream_next(self, sid: str, max_items: int = 1):
        """-> (items, done). Pulls up to max_items from the stream.

        Default 1: each chunk ships as soon as the generator produces
        it — a larger batch would delay time-to-first-token by the whole
        batch and time out slow producers. Callers wanting fewer RPCs on
        fast streams can raise max_items."""
        from .multiplex import _set_request_model_id

        with self._lock:
            entry = self._streams.get(sid)
        if entry is None:
            raise KeyError(f"no such stream {sid}")
        it, meta = entry
        items = []
        done = False
        # generator frames execute during next() — the request context
        # must be live HERE, not just in start_stream
        _set_request_model_id(meta.get("multiplexed_model_id", ""))
        try:
            for _ in range(max_items):
                items.append(next(it))
        except StopIteration:
            done = True
        finally:
            _set_request_model_id("")
        if done:
            with self._lock:
                # guard against a concurrent cancel_stream having already
                # released the slot
                if self._streams.pop(sid, None) is not None:
                    self._ongoing -= 1
                    self._completed += 1
        return items, done

    # ---------------------------------------------------------- management

    def reconfigure(self, user_config: Any):
        if not self._is_function and hasattr(self._callable, "reconfigure"):
            self._callable.reconfigure(user_config)

    def ping(self) -> dict:
        """Liveness probe; carries the replica's node placement so the
        controller learns it at the STARTING->RUNNING transition (for
        slow-node-aware routing) instead of a metrics tick later."""
        if not self._is_function and hasattr(self._callable, "check_health"):
            self._callable.check_health()
        return {"node_idx": self._node_idx()}

    @staticmethod
    def _node_idx() -> int:
        from ray_tpu_torch.core.context import get_context_if_exists

        ctx = get_context_if_exists()
        return ctx.node_idx if ctx is not None else -1

    def metrics(self) -> ReplicaMetrics:
        with self._lock:
            return ReplicaMetrics(
                replica_id=self._replica_id,
                num_ongoing_requests=self._ongoing,
                num_completed_requests=self._completed,
                healthy=self._healthy,
                node_idx=self._node_idx())

    def prepare_shutdown(self, timeout_s: float = 5.0) -> bool:
        """Graceful drain: wait for ongoing requests to finish."""
        self._draining = True
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if self._ongoing == 0:
                    return True
            time.sleep(0.02)
        return False
