"""Serve public API: run/status/delete/shutdown + handles + HTTP start.

Ref analogs: python/ray/serve/api.py:437 (serve.run), :243 (@serve
.deployment via deployment.py), serve/controller.py:696 (declarative
deploy_apps). The application graph is walked here: every Application found
in a bound deployment's init args is deployed into the same app and replaced
by a HandleMarker that the replica rehydrates into a DeploymentHandle.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.core.serialization import dumps

from .config import HTTPOptions
from .controller import (
    CONTROLLER_NAME,
    DEPLOY_HEALTHY,
    get_or_create_controller,
)
from .deployment import Application, Deployment
from .handle import DeploymentHandle
from .http_proxy import HTTPProxy, PROXY_NAME

# Weights-by-ref put cache: content digest -> live ObjectRef. A repeat
# serve.run() with the SAME weight bytes (the common redeploy: bump
# num_replicas, tweak a config) reuses the prior ref, so the pickled
# payload — and therefore the sha1-derived deployment version — stays
# stable and the redeploy scales instead of rolling-restarting every
# replica (and the store keeps ONE copy, not one per run). Changed
# bytes change the digest -> new ref -> new version -> rolling update,
# as intended. Bounded: evicted entries just drop this driver's pin
# (the controller still holds refs for live deployments).
_WEIGHTS_CACHE_MAX = 8
_weights_ref_cache: "Dict[str, Any]" = {}
_weights_cache_session: Optional[str] = None  # cluster the refs belong to


def _weights_digest(obj) -> str:
    """Content fingerprint of a large init arg (dtype/shape-aware for
    arrays; hashlib reads the buffer without copying when contiguous). A
    torch tensor hashes as its dtype, shape and raw bytes: numpy has no
    bf16 and cannot read a CUDA tensor, which costs one device-to-host
    copy here. torch is read from ``sys.modules``, never imported: an arg
    cannot be a tensor unless the caller loaded torch."""
    import hashlib
    import sys

    h = hashlib.sha1()
    torch = sys.modules.get("torch")
    if isinstance(obj, (bytes, bytearray)):
        h.update(b"raw")
        h.update(obj)
    elif torch is not None and isinstance(obj, torch.Tensor):
        t = obj.detach().contiguous().reshape(-1).cpu()
        h.update(f"torch:{t.dtype}{tuple(obj.shape)}".encode())
        h.update(memoryview(t.view(torch.uint8).numpy()))
    else:
        import numpy as np

        a = np.ascontiguousarray(np.asarray(obj))
        h.update(f"{a.dtype.str}{a.shape}".encode())
        h.update(memoryview(a).cast("B"))
    return h.hexdigest()


def _put_weights(obj):
    """put() a large init arg through the digest cache (see above)."""
    from ray_tpu_torch.core.context import get_context

    # Cached refs are only valid within the cluster that minted them: a
    # shutdown()/init() cycle in the same process would otherwise hand a
    # redeploy a ref into the dead cluster's object store.
    global _weights_cache_session
    session = get_context().session_dir
    if session != _weights_cache_session:
        _weights_ref_cache.clear()
        _weights_cache_session = session
    dig = _weights_digest(obj)
    ref = _weights_ref_cache.pop(dig, None)  # pop+reinsert = LRU bump
    if ref is None:
        ref = ray_tpu_torch.put(obj)
    _weights_ref_cache[dig] = ref
    while len(_weights_ref_cache) > _WEIGHTS_CACHE_MAX:
        del _weights_ref_cache[next(iter(_weights_ref_cache))]
    return ref


def _collect_app(app: Application) -> List[dict]:
    """Flatten the application graph into replica-spec payloads.

    Weights-by-ref (r14): init args that are large arrays/blobs (an
    integer ``nbytes`` >= ``serve_weights_by_ref_min_bytes``, or
    bytes/bytearray of that size) are put() into the object store ONCE
    here and replaced by their ObjectRef in the payload — replicas
    fetch them through the object plane (cooperative broadcast under
    concurrent cold-starts, zero-copy typed reducer) instead of each
    unpickling a private copy out of CREATE_ACTOR args. Explicit
    ObjectRef init args ride the same path. The live refs are ALSO
    returned per deployment (``weights_refs``) so the controller can
    hold them (outliving this driver's locals) and pre-warm them at
    scale-up decision time."""
    import inspect

    from ray_tpu_torch.core.config import get_config
    from ray_tpu_torch.core.object_ref import ObjectRef

    from .replica import HandleMarker

    out: Dict[str, dict] = {}
    thr = get_config().serve_weights_by_ref_min_bytes

    def mark(obj, app_name: str, weights: list):
        if isinstance(obj, Application):
            visit(obj, app_name)
            return HandleMarker(obj.deployment.name, app_name)
        if isinstance(obj, Deployment):
            raise TypeError(
                f"pass '{obj.name}.bind(...)' (an Application), not the "
                f"bare Deployment, as an init arg")
        if isinstance(obj, ObjectRef):
            weights.append(obj)
            return obj
        if thr > 0:
            if isinstance(obj, (bytes, bytearray)):
                nbytes = len(obj)
            else:
                nbytes = getattr(obj, "nbytes", None)
            if isinstance(nbytes, int) and nbytes >= thr:
                ref = _put_weights(obj)
                weights.append(ref)
                return ref
        if isinstance(obj, (list, tuple)):
            return type(obj)(mark(x, app_name, weights) for x in obj)
        if isinstance(obj, dict):
            return {k: mark(v, app_name, weights)
                    for k, v in obj.items()}
        return obj

    def visit(node: Application, app_name: str):
        dep = node.deployment
        if dep.name in out:
            return
        out[dep.name] = {}  # reserve before recursing (cycle guard)
        weights: list = []
        init_args = tuple(mark(a, app_name, weights)
                          for a in node.init_args)
        init_kwargs = {k: mark(v, app_name, weights)
                       for k, v in node.init_kwargs.items()}
        spec = {
            "func_or_class": dep.func_or_class,
            "is_function": not inspect.isclass(dep.func_or_class),
            "init_args": init_args,
            "init_kwargs": init_kwargs,
            "user_config": dep.config.user_config,
        }
        out[dep.name] = {"name": dep.name, "payload": dumps(spec),
                         "config": dep.config, "weights_refs": weights}

    # app_name resolved by caller; placeholder substituted there
    visit(app, "__APP__")
    return list(out.values())


def run(target: Application, *, name: str = "default",
        route_prefix: Optional[str] = "/", _blocking: bool = True,
        timeout_s: float = 60.0) -> DeploymentHandle:
    """Deploy an application and return a handle to its ingress."""
    if isinstance(target, Deployment):
        target = target.bind()
    if not isinstance(target, Application):
        raise TypeError(f"serve.run expects an Application, got {target}")
    ctrl = get_or_create_controller()

    # markers live inside pickled payloads; rebuild with the real app name
    from ray_tpu_torch.core.serialization import loads

    from .replica import HandleMarker

    def walk(o):
        if isinstance(o, HandleMarker):
            if o.app_name == "__APP__":
                o.app_name = name
            return o
        if isinstance(o, (list, tuple)):
            return type(o)(walk(x) for x in o)
        if isinstance(o, dict):
            return {k: walk(v) for k, v in o.items()}
        return o

    deployments = []
    for d in _collect_app(target):
        spec = loads(d["payload"])
        spec["init_args"] = walk(spec["init_args"])
        spec["init_kwargs"] = walk(spec["init_kwargs"])
        deployments.append({"name": d["name"], "payload": dumps(spec),
                            "config": d["config"],
                            "weights_refs": d.get("weights_refs") or []})

    ray_tpu_torch.get(ctrl.deploy_app.remote(
        name, route_prefix, target.deployment.name, deployments),
        timeout=30)

    from .router import reset_routers

    reset_routers()

    if _blocking:
        _wait_healthy(ctrl, name, timeout_s)
    return DeploymentHandle(target.deployment.name, name)


def _wait_healthy(ctrl, app_name: str, timeout_s: float):
    deadline = time.monotonic() + timeout_s
    last = {}
    while time.monotonic() < deadline:
        last = ray_tpu_torch.get(ctrl.status.remote(), timeout=30)
        app = last.get(app_name, {})
        if app.get("status") == "RUNNING":
            return
        if app.get("status") == "UNHEALTHY":
            msgs = {d: s.get("message") for d, s in
                    app.get("deployments", {}).items()
                    if s.get("status") != DEPLOY_HEALTHY}
            raise RuntimeError(f"app '{app_name}' unhealthy: {msgs}")
        time.sleep(0.05)
    raise TimeoutError(
        f"app '{app_name}' not healthy after {timeout_s}s: {last}")


def status() -> dict:
    try:
        ctrl = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except ValueError:
        return {"applications": {}}
    return {"applications": ray_tpu_torch.get(ctrl.status.remote(), timeout=30)}


def get_app_handle(name: str = "default") -> DeploymentHandle:
    ctrl = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    ingress = ray_tpu_torch.get(ctrl.get_ingress.remote(name), timeout=30)
    if ingress is None:
        raise ValueError(f"no serve application named '{name}'")
    return DeploymentHandle(ingress, name)


def get_deployment_handle(deployment_name: str,
                          app_name: str = "default") -> DeploymentHandle:
    return DeploymentHandle(deployment_name, app_name)


def delete(name: str, _blocking: bool = True):
    try:
        ctrl = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except ValueError:
        return
    ray_tpu_torch.get(ctrl.delete_app.remote(name), timeout=30)
    from .router import reset_routers

    reset_routers()


def _proxy_name(node_idx: int) -> str:
    return PROXY_NAME if node_idx == 0 else f"{PROXY_NAME}_{node_idx}"


def start(http_options: Optional[HTTPOptions] = None) -> int:
    """Start HTTP ingress (idempotent); returns the head proxy's port.

    With ``HTTPOptions(location="EveryNode")`` a proxy actor is pinned to
    EVERY alive node (the reference's per-node proxy fleet,
    serve/_private/http_state.py) — each serves the same route table, so
    an external load balancer can front all of them. ``proxy_ports()``
    lists the fleet."""
    get_or_create_controller()
    http_options = http_options or HTTPOptions()
    if http_options.location == "EveryNode":
        from ray_tpu_torch.core.api import NodeAffinitySchedulingStrategy

        # create the whole fleet first, then collect ports (a blocking
        # get per node would serialize startup at N x actor-boot time)
        proxies = {}
        for node in ray_tpu_torch.nodes():
            if not node.get("alive", True):
                continue
            idx = node["node_idx"]
            name = _proxy_name(idx)
            try:
                proxies[idx] = ray_tpu_torch.get_actor(name)
            except ValueError:
                proxies[idx] = ray_tpu_torch.remote(HTTPProxy).options(
                    name=name, num_cpus=0, max_concurrency=32,
                    scheduling_strategy=NodeAffinitySchedulingStrategy(
                        idx)).remote(
                    http_options.host,
                    http_options.port + idx if http_options.port else 0)
        port_refs = {idx: p.port.remote() for idx, p in proxies.items()}
        ports = {idx: ray_tpu_torch.get(r, timeout=60)
                 for idx, r in port_refs.items()}
        return ports[0]
    try:
        proxy = ray_tpu_torch.get_actor(PROXY_NAME)
    except ValueError:
        proxy = ray_tpu_torch.remote(HTTPProxy).options(
            name=PROXY_NAME, num_cpus=0, max_concurrency=32).remote(
                http_options.host, http_options.port)
    return ray_tpu_torch.get(proxy.port.remote(), timeout=30)


def proxy_ports() -> dict:
    """node_idx -> bound HTTP port for every live proxy actor."""
    out = {}
    for node in ray_tpu_torch.nodes():
        idx = node["node_idx"]
        try:
            proxy = ray_tpu_torch.get_actor(_proxy_name(idx))
        except ValueError:
            continue
        out[idx] = ray_tpu_torch.get(proxy.port.remote(), timeout=30)
    return out


def shutdown():
    """Tear down all applications, the proxies, and the controller."""
    from .grpc_proxy import stop_grpc
    from .router import reset_routers

    try:
        stop_grpc()
    except Exception:
        pass

    proxy_names = [_proxy_name(n["node_idx"]) for n in ray_tpu_torch.nodes()]
    if PROXY_NAME not in proxy_names:
        proxy_names.append(PROXY_NAME)  # head proxy of a shrunken cluster
    for name in proxy_names:
        try:
            proxy = ray_tpu_torch.get_actor(name)
            try:
                ray_tpu_torch.get(proxy.stop.remote(), timeout=10)
            except Exception:
                pass
            ray_tpu_torch.kill(proxy)
        except ValueError:
            pass
    try:
        ctrl = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except ValueError:
        reset_routers()
        return
    try:
        # Generous timeout: shutdown_serve joins every in-flight replica
        # drain (graceful_shutdown_timeout_s each, run concurrently) before
        # returning; killing the controller early would orphan them.
        ray_tpu_torch.get(ctrl.shutdown_serve.remote(), timeout=120)
    except Exception:
        pass
    ray_tpu_torch.kill(ctrl)
    reset_routers()
