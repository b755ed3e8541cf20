"""Public core API: init/shutdown/remote/get/put/wait/kill/cancel.

Analog of python/ray/_private/worker.py (ray.init :1125, ray.get :2440,
ray.put :2569, ray.wait :2632), python/ray/remote_function.py
(RemoteFunction._remote :246) and python/ray/actor.py (ActorClass :384,
ActorHandle :1025) in the reference.
"""

from __future__ import annotations

import atexit
import functools
import inspect
import os
import threading
import time
import uuid
from typing import Any, List, Optional, Sequence, Tuple, Union

from .context import CoreContext, get_context, get_context_if_exists, \
    set_context
from .head import Head
from .ids import ActorID, PlacementGroupID
from .object_ref import ObjectRef
from .task_spec import Bundle, PlacementGroupSpec, SchedulingStrategy

_head: Optional[Head] = None
_init_lock = threading.RLock()


def is_initialized() -> bool:
    return get_context_if_exists() is not None


def init(*, num_cpus: Optional[int] = None, num_gpus: Optional[int] = None,
         object_store_memory: Optional[int] = None, resources: dict = None,
         labels: dict = None, _system_config: dict = None,
         ignore_reinit_error: bool = False, log_to_driver: bool = True,
         namespace: str = "", address: Optional[str] = None,
         session_dir: Optional[str] = None,
         runtime_env: Optional[dict] = None) -> "RuntimeInfo":
    """Start (or connect to) a runtime.

    With no address, starts an embedded head (GCS-lite + one node) in this
    process — the reference's ``ray.init()`` local mode with real worker
    processes. ``address`` may name an existing head socket to attach to
    (multi-driver; the reference's ``ray.init(address=...)``).

    ``session_dir`` pins the session directory. Reusing a previous
    session's directory restores the head's durable control-plane state
    (KV, named actors, placement groups) from its write-ahead log — the
    reference's GCS restart from Redis (gcs fault tolerance docs;
    src/ray/gcs/store_client/).
    """
    global _head
    with _init_lock:
        if is_initialized():
            if ignore_reinit_error:
                return RuntimeInfo(get_context(), _head)
            raise RuntimeError("ray_tpu_torch.init() called twice; use "
                              "ignore_reinit_error=True")
        from .config import get_config, reset_config

        reset_config()
        get_config().apply_overrides(_system_config)
        if address and address.startswith("tcp:"):
            # Remote driver (the reference's Ray Client, python/ray/util/
            # client/ — but as a full peer): an in-process node agent
            # joins the cluster over TCP, giving this host its own object
            # store and worker pool; the driver then runs node-local with
            # no proxying of object ops.
            from .node_agent import NodeAgent

            agent = NodeAgent(address, num_cpus=num_cpus or 0,
                              num_gpus=num_gpus or 0)
            threading.Thread(target=agent.run_forever, daemon=True,
                             name="driver-node-agent").start()
            os.environ["RAY_TPU_NODE_IP"] = agent.node_ip
            try:
                ctx = CoreContext(head_addr=address,
                                  session_dir=agent.session_dir,
                                  node_idx=agent.node_idx, is_driver=True)
            finally:
                os.environ.pop("RAY_TPU_NODE_IP", None)
            ctx._local_agent = agent  # torn down with the context
            set_context(ctx)
            if log_to_driver:
                _mirror_worker_logs(ctx)
            _apply_job_runtime_env(ctx, runtime_env)
            return RuntimeInfo(ctx, None)
        if address:
            session_dir = os.path.dirname(address.replace("unix:", ""))
            ctx = CoreContext(head_addr=address, session_dir=session_dir,
                              node_idx=0, is_driver=True)
            set_context(ctx)
            if log_to_driver:
                _mirror_worker_logs(ctx)
            _apply_job_runtime_env(ctx, runtime_env)
            return RuntimeInfo(ctx, None)
        session_name = uuid.uuid4().hex[:10]
        if session_dir is None:
            from .config import runtime_tmp_dir

            session_dir = os.path.join(runtime_tmp_dir(),
                                       f"session_{session_name}")
        os.makedirs(session_dir, exist_ok=True)
        from ray_tpu_torch import usage_stats as _usage

        _usage.print_usage_stats_notice()
        _usage.record_library_usage("core")
        head = Head(session_dir, session_name)
        head.add_node(num_cpus=num_cpus, num_gpus=num_gpus,
                      object_store_memory=object_store_memory,
                      resources=resources, labels=labels)
        head.start()
        ctx = CoreContext(head_addr=head.addr, session_dir=session_dir,
                          node_idx=0, is_driver=True)
        set_context(ctx)
        if log_to_driver:
            _mirror_worker_logs(ctx)
        _apply_job_runtime_env(ctx, runtime_env)
        _head = head
        atexit.register(shutdown)
        return RuntimeInfo(ctx, head)


def _apply_job_runtime_env(ctx: CoreContext, runtime_env: Optional[dict]):
    """Job-level default env for every task/actor (reference:
    ray.init(runtime_env=...))."""
    if not runtime_env:
        return
    from ray_tpu_torch.runtime_env import upload, validate

    ctx.job_runtime_env = upload(ctx, validate(runtime_env))


def _mirror_worker_logs(ctx: CoreContext):
    """Print worker log lines in the driver, prefixed with their source
    (reference: worker.py print_logs fed by log_monitor.py over pubsub)."""
    import sys as _sys

    def _print(data):
        src = data.get("source", "?")
        for line in data.get("lines", ()):
            print(f"({src}) {line}", file=_sys.stderr)

    ctx.subscribe("logs", _print)


class RuntimeInfo:
    def __init__(self, ctx: CoreContext, head: Optional[Head]):
        self.ctx = ctx
        self.head = head

    @property
    def address(self) -> str:
        return self.ctx.head_addr

    @property
    def session_dir(self) -> str:
        return self.ctx.session_dir


def shutdown():
    global _head
    with _init_lock:
        ctx = get_context_if_exists()
        if ctx is not None:
            try:  # usage report file sink (ref: usage_lib's reporter)
                from ray_tpu_torch import usage_stats as _usage

                _usage.write_report(ctx.session_dir)
            except Exception:
                pass
            try:
                ctx.shutdown()
            finally:
                set_context(None)
        if _head is not None:
            try:
                _head.shutdown()
            finally:
                _head = None
        try:
            atexit.unregister(shutdown)
        except Exception:
            pass


def get(refs: Union[ObjectRef, Sequence[ObjectRef]],
        *, timeout: Optional[float] = None):
    single = isinstance(refs, ObjectRef)
    lst = [refs] if single else list(refs)
    for r in lst:
        if not isinstance(r, ObjectRef):
            raise TypeError(f"get() expects ObjectRef(s), got {type(r)}")
    vals = get_context().get(lst, timeout)
    return vals[0] if single else vals


def put(value: Any) -> ObjectRef:
    if isinstance(value, ObjectRef):
        raise TypeError("put() of an ObjectRef is not allowed")
    return get_context().put(value)


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None, fetch_local: bool = True
         ) -> Tuple[List[ObjectRef], List[ObjectRef]]:
    if isinstance(refs, ObjectRef):
        raise TypeError("wait() expects a list of ObjectRefs")
    if num_returns > len(refs):
        raise ValueError("num_returns exceeds number of refs")
    return get_context().wait(list(refs), num_returns, timeout, fetch_local)


def cancel(ref: ObjectRef, *, force: bool = False):
    get_context().cancel(ref, force)


def kill(actor: "ActorHandle", *, no_restart: bool = True):
    get_context().kill_actor(actor._actor_id, no_restart)


# ============================================================ remote functions


class RemoteFunction:
    def __init__(self, fn, *, num_cpus=None, num_gpus=None, num_returns=1,
                 resources=None, max_retries=None, retry_exceptions=False,
                 scheduling_strategy=None, name=None, runtime_env=None,
                 prefetch_args=True):
        from ray_tpu_torch.runtime_env import validate as _validate_env

        self._fn = fn
        self._num_returns = num_returns
        self._resources = _resource_dict(num_cpus, num_gpus, resources,
                                         default_cpus=1)
        self._max_retries = max_retries
        self._retry_exceptions = retry_exceptions
        self._strategy = scheduling_strategy
        self._name = name or getattr(fn, "__name__", "task")
        self._runtime_env = _validate_env(runtime_env)
        self._uploaded_env = None  # dirs packed/uploaded once, lazily
        # False opts this task's by-ref args out of dispatch-time
        # PREFETCH_HINT speculation (r17; the shuffle's hint A/B knob)
        self._prefetch_args = prefetch_args
        functools.update_wrapper(self, fn)

    def _resolved_env(self):
        if self._runtime_env is None:
            return None
        if self._uploaded_env is None:
            from ray_tpu_torch.runtime_env import upload

            self._uploaded_env = upload(get_context(), self._runtime_env)
        return self._uploaded_env

    def __call__(self, *a, **k):
        raise TypeError(
            f"Remote function '{self._name}' cannot be called directly; use "
            f"'{self._name}.remote()' (or '.func()' to call the plain "
            "function).")

    @property
    def func(self):
        return self._fn

    def remote(self, *args, **kwargs):
        refs = get_context().submit_task(
            self._fn, args, kwargs,
            num_returns=self._num_returns,
            resources=self._resources,
            strategy=_to_strategy(self._strategy),
            max_retries=self._max_retries,
            retry_exceptions=self._retry_exceptions,
            name=self._name,
            runtime_env=self._resolved_env(),
            prefetch_args=self._prefetch_args)
        return refs[0] if self._num_returns == 1 else refs

    def bind(self, *args, **kwargs):
        """Build a lazy DAG node instead of executing (reference:
        ray.dag, dag_node.py:23)."""
        from ray_tpu_torch.dag import FunctionNode

        return FunctionNode(self, args, kwargs)

    def options(self, **opts) -> "RemoteFunction":
        merged = dict(
            num_returns=self._num_returns,
            resources=None, max_retries=self._max_retries,
            retry_exceptions=self._retry_exceptions,
            scheduling_strategy=self._strategy, name=self._name,
            runtime_env=self._runtime_env,
            prefetch_args=self._prefetch_args)
        merged.update(opts)
        rf = RemoteFunction(self._fn, **{k: v for k, v in merged.items()
                                         if k in inspect.signature(
                                             RemoteFunction.__init__
                                         ).parameters})
        if "resources" not in opts and "num_cpus" not in opts \
                and "num_gpus" not in opts:
            rf._resources = self._resources
        return rf


# ============================================================ actors


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str, num_returns=1,
                 task_name: str = ""):
        self._handle = handle
        self._name = name
        self._num_returns = num_returns
        self._task_name = task_name

    def remote(self, *args, **kwargs):
        refs = get_context().submit_actor_task(
            self._handle._actor_id, self._name, args, kwargs,
            num_returns=self._num_returns,
            max_retries=self._handle._max_task_retries,
            name=self._task_name)
        return refs[0] if self._num_returns == 1 else refs

    def options(self, num_returns=1, name: str = "", **_):
        """``name`` relabels the submitted task for observability (the
        func key of phase histograms / `summary tasks` / the straggler
        detector) without changing which method runs — pipeline stages
        submit ``fwd`` as ``stage{k}.fwd`` this way (r15)."""
        return ActorMethod(self._handle, self._name, num_returns,
                           task_name=name)

    def __call__(self, *a, **k):
        raise TypeError(f"Actor method '{self._name}' must be called with "
                        f".remote()")


class ActorHandle:
    def __init__(self, actor_id: ActorID, method_names,
                 max_task_retries: int = 0):
        self._actor_id = actor_id
        self._method_names = set(method_names)
        self._max_task_retries = max_task_retries

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        if self._method_names and name not in self._method_names:
            raise AttributeError(
                f"actor has no method '{name}'")
        return ActorMethod(self, name)

    def __reduce__(self):
        return (ActorHandle,
                (self._actor_id, self._method_names, self._max_task_retries))

    def __repr__(self):
        return f"ActorHandle({self._actor_id.hex()})"


class ActorClass:
    def __init__(self, cls, *, num_cpus=None, num_gpus=None, resources=None,
                 max_restarts=0, max_task_retries=0, max_concurrency=1,
                 name=None, scheduling_strategy=None, lifetime=None,
                 runtime_env=None):
        from ray_tpu_torch.runtime_env import validate as _validate_env

        self._runtime_env = _validate_env(runtime_env)
        self._uploaded_env = None
        self._cls = cls
        self._resources = _resource_dict(num_cpus, num_gpus, resources,
                                         default_cpus=0)
        self._max_restarts = max_restarts
        self._max_task_retries = max_task_retries
        self._max_concurrency = max_concurrency
        self._name = name
        self._strategy = scheduling_strategy
        self._lifetime = lifetime

    def __call__(self, *a, **k):
        raise TypeError(
            f"Actor class {self._cls.__name__} cannot be instantiated "
            f"directly; use {self._cls.__name__}.remote()")

    def remote(self, *args, **kwargs) -> ActorHandle:
        ctx = get_context()
        renv = None
        if self._runtime_env is not None:
            if self._uploaded_env is None:
                from ray_tpu_torch.runtime_env import upload

                self._uploaded_env = upload(ctx, self._runtime_env)
            renv = self._uploaded_env
        actor_id = ctx.create_actor(
            self._cls, args, kwargs,
            resources=self._resources,
            max_restarts=self._max_restarts,
            max_concurrency=self._max_concurrency,
            name=self._name or "",
            strategy=_to_strategy(self._strategy),
            max_task_retries=self._max_task_retries,
            runtime_env=renv)
        return ActorHandle(actor_id, _public_methods(self._cls),
                           self._max_task_retries)

    def bind(self, *args, **kwargs):
        """Build a lazy actor DAG node (reference: ray.dag class_node.py)."""
        from ray_tpu_torch.dag import ClassNode

        return ClassNode(self, args, kwargs)

    def options(self, **opts) -> "ActorClass":
        base = dict(num_cpus=None, num_gpus=None, resources=None,
                    max_restarts=self._max_restarts,
                    max_task_retries=self._max_task_retries,
                    max_concurrency=self._max_concurrency, name=self._name,
                    scheduling_strategy=self._strategy,
                    lifetime=self._lifetime,
                    runtime_env=self._runtime_env)
        base.update(opts)
        ac = ActorClass(self._cls, **base)
        if "resources" not in opts and "num_cpus" not in opts \
                and "num_gpus" not in opts:
            ac._resources = self._resources
        return ac


def _public_methods(cls):
    return [n for n, m in inspect.getmembers(cls)
            if callable(m) and not n.startswith("_")]


def get_actor(name: str) -> ActorHandle:
    aid = get_context().get_named_actor(name)
    if aid is None:
        raise ValueError(f"no actor named '{name}'")
    return ActorHandle(aid, set())


# ============================================================ remote decorator


def remote(*args, **kwargs):
    """``@remote`` / ``@remote(num_cpus=..., num_gpus=...)`` for functions
    and classes (the reference's ``ray.remote``, python/ray/__init__.py)."""

    def decorate(obj):
        if inspect.isclass(obj):
            allowed = ("num_cpus", "num_gpus", "resources", "max_restarts",
                       "max_task_retries", "max_concurrency", "name",
                       "scheduling_strategy", "lifetime", "runtime_env")
            return ActorClass(obj, **{k: v for k, v in kwargs.items()
                                      if k in allowed})
        allowed = ("num_cpus", "num_gpus", "num_returns", "resources",
                   "max_retries", "retry_exceptions", "scheduling_strategy",
                   "name", "runtime_env", "prefetch_args")
        return RemoteFunction(obj, **{k: v for k, v in kwargs.items()
                                      if k in allowed})

    if len(args) == 1 and callable(args[0]) and not kwargs:
        return decorate(args[0])
    if args:
        raise TypeError("@remote takes keyword arguments only")
    return decorate


def _resource_dict(num_cpus, num_gpus, resources, default_cpus):
    res = dict(resources or {})
    res["CPU"] = num_cpus if num_cpus is not None else \
        res.get("CPU", default_cpus)
    if num_gpus is not None:
        res["GPU"] = num_gpus
    return {k: v for k, v in res.items() if v}


def _to_strategy(s) -> SchedulingStrategy:
    if s is None:
        return SchedulingStrategy()
    if isinstance(s, SchedulingStrategy):
        return s
    if isinstance(s, str):
        return SchedulingStrategy(kind=s)
    return s


# ============================================================ placement groups


class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID):
        self.id = pg_id

    def ready(self, timeout: float = 30.0) -> bool:
        ctx = get_context()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            from . import protocol as P

            # poll head state via node info channel (cheap)
            state = _pg_state(self.id)
            if state == "CREATED":
                return True
            if state == "REMOVED":
                return False
            time.sleep(0.02)
        return False

    def wait(self, timeout: float = 30.0) -> bool:
        return self.ready(timeout)

    @property
    def bundle_specs(self):
        return []

    def __reduce__(self):
        return (PlacementGroup, (self.id,))


def _pg_state(pg_id: PlacementGroupID) -> str:
    # The embedded head is in-process for the driver; attached drivers query
    # over the wire via KV (head mirrors state there).
    from .api import _head

    if _head is not None:
        return _head.pg_state(pg_id)
    data = get_context().kv_get("pg_state", pg_id.hex())
    return data.decode() if data else "PENDING"


def placement_group(bundles: List[dict], strategy: str = "PACK",
                    name: str = "") -> PlacementGroup:
    from .serialization import dumps
    from . import protocol as P

    ctx = get_context()
    spec = PlacementGroupSpec(
        pg_id=PlacementGroupID.of(ctx.job_id),
        bundles=[Bundle(resources=b) for b in bundles],
        strategy=strategy, name=name, job_id=ctx.job_id)
    ctx.head.call(P.CREATE_PG, dumps(spec), timeout=60)
    return PlacementGroup(spec.pg_id)


def remove_placement_group(pg: PlacementGroup):
    from . import protocol as P

    get_context().head.call(P.REMOVE_PG, pg.id.binary(), timeout=30)


def placement_group_table(pg: PlacementGroup) -> dict:
    from .api import _head

    if _head is None:
        return {}
    return {
        "state": _head.pg_state(pg.id),
        "placement": _head.pg_placement(pg.id),
    }


class PlacementGroupSchedulingStrategy(SchedulingStrategy):
    def __init__(self, placement_group: PlacementGroup,
                 placement_group_bundle_index: int = -1,
                 placement_group_capture_child_tasks: bool = False):
        super().__init__(
            kind="PLACEMENT_GROUP",
            placement_group_id=placement_group.id,
            bundle_index=placement_group_bundle_index,
            capture_child_tasks=placement_group_capture_child_tasks)


class NodeAffinitySchedulingStrategy(SchedulingStrategy):
    def __init__(self, node_id, soft: bool = False):
        super().__init__(kind="NODE_AFFINITY", node_id=str(node_id),
                         soft=soft)


def get_gpu_ids() -> List[int]:
    """GPU indices assigned to the current task/actor's lease (the
    reference's ``ray.get_gpu_ids()``, worker.py:888), exported to it as
    ``CUDA_VISIBLE_DEVICES``. Empty outside a GPU-resourced task."""
    return list(get_context().assigned_gpu_ids)


def nodes() -> list:
    return get_context().node_info()


def object_locations(ref: ObjectRef) -> dict:
    """Holder set of a plasma-resident object from the head's object
    directory (ref parity: ray.experimental.get_object_locations).
    Returns {"holders": [node_idx, ...], "addrs": [transfer_addr, ...],
    "size": int, "spilled": str}; ``holders`` and ``addrs`` are parallel
    — ``addrs[i]`` is the transfer server serving ``holders[i]`` ('' when
    unreachable), so head-local holders share one address."""
    from . import protocol as P

    holders, addrs, size, spilled = get_context().head.call(
        P.OBJ_LOCATION_LOOKUP, ref.id.binary(), timeout=30)
    return {"holders": holders, "addrs": addrs, "size": size,
            "spilled": spilled}


def warm_object(ref: ObjectRef, node_idx: int = -1, *,
                wait: bool = False) -> int:
    """Warm a plasma-resident object onto node(s) before any consumer
    task/actor is placed (r14; the proactive face of the reference
    PullManager's prefetch role). Fires the head's OBJECT_WARM: every
    targeted node missing the object gets a prefetch-flagged pull
    through the broadcast-aware planner — concurrent warms of one
    object form the r9 cooperative relay tree, and a later consumer's
    get() joins the in-flight pull instead of starting cold. The serve
    controller uses this to ship deployment weights at scale-up
    decision time, before the new replicas even exist.

    ``node_idx`` -1 targets every alive remote node. Fire-and-forget by
    default; ``wait=True`` blocks for the head's ack and returns how
    many pulls were issued (0 = every target already holds it, or
    prefetching is disabled/capped)."""
    from . import protocol as P

    ctx = get_context()
    if wait:
        (issued,) = ctx.head.call(P.OBJECT_WARM, ref.id.binary(),
                                  int(node_idx), timeout=30)
        return int(issued)
    # Never block on a head outage: a ReconnectingConnection PARKS
    # writes for the reconnect window, and fire-and-forget callers (the
    # serve controller decides scale-ups under its reconcile lock) must
    # not stall on speculation. Skipping just loses the warm-up.
    if not ctx.head.is_attached():
        return 0
    try:
        ctx.head.send(P.OBJECT_WARM, ref.id.binary(), int(node_idx))
    except P.ConnectionLost:
        pass  # speculation only: consumers still demand-pull
    return 0


def drain_node(node_idx: int, *, timeout: float = 30.0) -> bool:
    """Begin a GRACEFUL drain of a node (r16; reference: the
    NodeManager ``DrainNode`` RPC behind the autoscaler's planned
    scale-down). The head immediately stops granting leases /
    placements / prefetches onto the node, replicates its sole-copy
    objects to survivors, and publishes ``node_draining`` so running
    workloads (e.g. ``train.Pipeline`` stage migration) move their work
    off; once every in-flight lease completes — or ``drain_deadline_s``
    passes — the node is removed with the deliberate ``SHUTDOWN_NODE``
    (``node_drained`` / ``drain_forced`` cluster events). Returns True
    when the drain was started (or already in progress); False for an
    unknown/dead node or the head's bootstrap node (node 0 — draining
    it would escalate to removing the head host's own arena).
    Non-blocking: poll ``state.list_nodes`` for the ``draining`` flag /
    node removal."""
    from . import protocol as P

    (ok,) = get_context().head.call(P.DRAIN_NODE, int(node_idx),
                                    timeout=timeout)
    return bool(ok)


def cluster_resources() -> dict:
    total: dict = {}
    for n in nodes():
        for k, v in n["resources_total"].items():
            total[k] = total.get(k, 0) + v
    return total


def available_resources() -> dict:
    total: dict = {}
    for n in nodes():
        for k, v in n["resources_available"].items():
            total[k] = total.get(k, 0) + v
    return total
