"""DeploymentHandle — the Python-native way to call a deployment.

Ref analog: python/ray/serve/handle.py:92 (RayServeHandle /
DeploymentHandle). ``handle.remote(...)`` routes through the shared
per-process Router and returns a DeploymentResponse future; responses can
be passed straight into other handle calls (composition) — they convert to
ObjectRefs so the downstream replica fetches the value without a hop
through the caller.
"""

from __future__ import annotations

from typing import Any, Optional

import ray_tpu_torch
from ray_tpu_torch.core.config import get_config
from ray_tpu_torch.core.object_ref import ObjectRef


class DeploymentResponse:
    """Future for one deployment request."""

    def __init__(self, ref: ObjectRef):
        self._ref = ref

    def result(self, timeout_s: Optional[float] = None) -> Any:
        return ray_tpu_torch.get(self._ref, timeout=timeout_s)

    def _to_object_ref(self) -> ObjectRef:
        return self._ref

    def __await__(self):
        return self._ref.__await__()


class DeploymentResponseGenerator:
    """Iterator over a streaming deployment response (ref:
    handle.options(stream=True) -> DeploymentResponseGenerator). Chunks
    are pulled from the serving replica in small batches; the replica's
    concurrency slot is held until the stream is exhausted."""

    def __init__(self, router, rid: str, replica_handle, sid_ref):
        self._router = router
        self._rid = rid
        self._replica = replica_handle
        self._sid_ref = sid_ref
        self._sid: Optional[str] = None
        self._buf: list = []
        self._done = False
        self._released = False

    def __iter__(self):
        return self

    def __next__(self):
        try:
            while not self._buf:
                if self._done:
                    raise StopIteration
                if self._sid is None:
                    self._sid = ray_tpu_torch.get(self._sid_ref, timeout=60)
                items, done = ray_tpu_torch.get(
                    self._replica.stream_next.remote(self._sid),
                    timeout=60)
                self._buf.extend(items)
                if done:
                    self._done = True
                    self._release()
            return self._buf.pop(0)
        except StopIteration:
            raise
        except BaseException:
            # errored streams must not leak the replica's concurrency
            # slot or its parked iterator
            self.close()
            raise

    def _release(self):
        if not self._released:
            self._released = True
            self._router.release(self._rid)

    def close(self):
        """Abandon the stream: free the replica-side iterator + the
        router slot (also runs from __del__, so a consumer that stops
        iterating early — e.g. an HTTP client disconnect — cleans up)."""
        if self._done and self._released:
            return
        self._done = True
        if self._sid is None:
            # start_stream already ran on the replica even if nobody ever
            # pulled a chunk — resolve the id (best effort) or the
            # replica's slot + parked iterator leak forever
            try:
                self._sid = ray_tpu_torch.get(self._sid_ref, timeout=10)
            except Exception:  # noqa: BLE001 — start_stream itself failed
                pass
        if self._sid is not None:
            try:
                self._replica.cancel_stream.remote(self._sid)
            except Exception:  # noqa: BLE001 — replica may be gone
                pass
        self._release()

    def __del__(self):
        try:
            self.close()
        except BaseException:  # noqa: BLE001 — interpreter teardown
            pass


class DeploymentHandle:
    def __init__(self, deployment_name: str, app_name: str = "default",
                 method_name: str = "__call__", stream: bool = False,
                 multiplexed_model_id: str = ""):
        self.deployment_name = deployment_name
        self.app_name = app_name
        self.method_name = method_name
        self.stream = stream
        self.multiplexed_model_id = multiplexed_model_id

    def __getattr__(self, name: str) -> "DeploymentHandle":
        if name.startswith("_"):
            raise AttributeError(name)
        return DeploymentHandle(self.deployment_name, self.app_name, name,
                                self.stream, self.multiplexed_model_id)

    def options(self, *, method_name: Optional[str] = None,
                stream: Optional[bool] = None,
                multiplexed_model_id: Optional[str] = None
                ) -> "DeploymentHandle":
        return DeploymentHandle(
            self.deployment_name, self.app_name,
            method_name or self.method_name,
            self.stream if stream is None else stream,
            self.multiplexed_model_id if multiplexed_model_id is None
            else multiplexed_model_id)

    def _meta(self) -> Optional[dict]:
        if self.multiplexed_model_id:
            return {"multiplexed_model_id": self.multiplexed_model_id}
        return None

    def remote(self, *args, **kwargs):
        from .router import get_router

        args = tuple(_to_ref(a) for a in args)
        kwargs = {k: _to_ref(v) for k, v in kwargs.items()}
        router = get_router(self.app_name, self.deployment_name)
        if self.stream:
            rid, handle, sid_ref = router.assign_stream(
                self.method_name, args, kwargs, meta=self._meta())
            return DeploymentResponseGenerator(router, rid, handle,
                                               sid_ref)
        ref = router.assign(self.method_name, args, kwargs,
                            meta=self._meta())
        return DeploymentResponse(ref)

    def __reduce__(self):
        return (DeploymentHandle,
                (self.deployment_name, self.app_name, self.method_name,
                 self.stream, self.multiplexed_model_id))

    def __repr__(self):
        return (f"DeploymentHandle({self.app_name}/{self.deployment_name}"
                f".{self.method_name})")


def _to_ref(x):
    """Arg normalization for the handle path. DeploymentResponses pass
    as their ObjectRefs (composition: the downstream replica fetches the
    value without a hop through the caller). Large binary payloads —
    bytes / bytearray / anything with an integer ``nbytes`` (ndarray,
    torch.Tensor) — of at least ``serve_request_by_ref_min_bytes`` are
    put() into the object store and passed BY REFERENCE (r14 zero-copy
    ingress): the put writes frames straight into the mapped arena (r8),
    the replica-side fetch is an arena-backed zero-copy read via the
    typed reducer (r13), and the dispatch-time prefetch hint overlaps
    the transfer with dispatch. Positional args ride as real task args
    (router.assign), so the runtime resolves the refs before user code
    runs."""
    if isinstance(x, DeploymentResponse):
        return x._to_object_ref()
    thr = get_config().serve_request_by_ref_min_bytes
    if thr > 0:
        if isinstance(x, (bytes, bytearray)):
            nbytes = len(x)
        else:
            nbytes = getattr(x, "nbytes", None)
        if isinstance(nbytes, int) and nbytes >= thr:
            return ray_tpu_torch.put(x)
    return x
