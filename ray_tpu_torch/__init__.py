"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

The JAX package ``ray_tpu`` stays the reference; this package imports
nothing from it. What is ported so far is the decoder's inference and
training stack with its dense or Mixture-of-Experts FFN (``models``), the
parallel layer (``parallel``: device meshes, logical sharding, ring
attention, tensor, pipeline and expert axes), the entry points
(``entry``: ``entry()`` and ``dryrun_multichip``), the flash-attention
kernels, forward and backward (``ops``), which run as hand-written CUDA on
the card and as their plain PyTorch versions on CPU tensors, and the
runtime core (``core``: tasks, actors and the shared-memory object store,
with GPU leases and torch tensors on the object plane), Serve
(``serve``: deployments, handles, proxies and the LLM deployments on the
port's engine), Train (``train``: ``TorchTrainer`` over a gang of worker
actors in one ``torch.distributed`` group, checkpoints of torch train
state, gang restart, the MPMD pipeline of stage actors) and Tune
(``tune``), with ``collective`` (host-plane collectives between actors)
and ``cluster_utils`` (logical multi-node clusters), and RLlib
(``rllib``: CPU rollout workers, learners on the card, PPO, IMPALA, APPO,
A2C, DQN and the rest of the reference's algorithms), Data (``data``:
datasets of numpy-column blocks, the shuffle exchange, ``streaming_split``
and ``iter_torch_batches`` onto the card), ``dag`` (``.bind()`` graphs),
``workflow`` (durable DAG runs with per-step checkpoints and ``resume``)
``utils`` (``ActorPool``, ``Queue``, the multiprocessing ``Pool``,
joblib, Dask, the core microbenchmark and the Spark shim), and the ops
layer: the CLI (``scripts``; ``python -m ray_tpu_torch``), job
submission (``jobs``), the dashboard and ``doctor`` (``dashboard``,
``dashboard_ui``) and the autoscaler with a GKE GPU node pool
(``autoscaler``).
Entry points of the model stack, RLlib's learners and
``iter_torch_batches`` run on
CUDA unless the caller passes ``device="cpu"``.

Public core API mirrors the reference's (``ray.*``):
    init, shutdown, remote, get, put, wait, kill, cancel, get_actor,
    get_gpu_ids, placement_group, nodes, cluster_resources, ...

Every name loads on first access (PEP 562), so a worker process
(``python -m ray_tpu_torch.core.worker_main``) imports no torch until the
code it runs does.
"""

import importlib

from ray_tpu_torch._version import __version__

_SUBMODULES = ("models", "ops", "parallel", "entry", "interop", "core",
               "serve", "train", "tune", "rllib", "collective", "data",
               "dag", "workflow", "utils", "cluster_utils", "tracing",
               "metrics", "profiling", "runtime_env", "state",
               "trace_analysis", "usage_stats", "jobs", "scripts",
               "dashboard", "dashboard_ui", "autoscaler")

_API = ("ActorClass", "ActorHandle", "NodeAffinitySchedulingStrategy",
        "PlacementGroup", "PlacementGroupSchedulingStrategy",
        "available_resources", "cancel", "cluster_resources", "drain_node",
        "get", "get_actor", "get_gpu_ids", "init", "is_initialized", "kill",
        "nodes", "object_locations", "placement_group",
        "placement_group_table", "put", "remote", "remove_placement_group",
        "shutdown", "wait", "warm_object")
_EXCEPTIONS = ("ActorDiedError", "ActorUnavailableError", "GetTimeoutError",
               "ObjectLostError", "RayTaskError", "TaskCancelledError",
               "WorkerCrashedError")

_LAZY = {
    **{n: ("ray_tpu_torch.core.api", n) for n in _API},
    **{n: ("ray_tpu_torch.core.exceptions", n) for n in _EXCEPTIONS},
    "ObjectRef": ("ray_tpu_torch.core.object_ref", "ObjectRef"),
    "timeline": ("ray_tpu_torch.tracing", "timeline"),
    "params_from_numpy": ("ray_tpu_torch.interop", "params_from_numpy"),
}

__all__ = ["__version__", *_SUBMODULES, *_LAZY]


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f"ray_tpu_torch.{name}")
    if name in _LAZY:
        module, attr = _LAZY[name]
        value = getattr(importlib.import_module(module), attr)
        globals()[name] = value
        return value
    raise AttributeError(f"module 'ray_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
