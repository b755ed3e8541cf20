"""Parameters from the JAX package's pytree, as numpy, into the port.

The port keeps the reference's parameter names and stacked ``[L, ...]``
shapes, so converting is array by array. bf16 needs care: JAX's bf16 arrays
reach numpy with the dtype named ``bfloat16`` (an ``ml_dtypes`` type that
``torch.from_numpy`` refuses). They travel as their raw 16 bits, a uint16
view, and are reinterpreted as ``torch.bfloat16``, without importing
``ml_dtypes``.

``train_state_from_numpy`` carries a whole train state across (step,
params and the Adam moments from inside optax's chain state), so a JAX run
can be resumed in the port.

``shard_params`` and ``shard_state`` place such params, or a whole train
state, on a mesh as DTensors: each rank passes the same global values and
keeps its own shards, so both sides of a parity test start from the same
weights.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.config import TransformerConfig


def tensor_from_numpy(arr, device=None) -> torch.Tensor:
    """One numpy array (bf16 included) -> a tensor with the same values."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        # ascontiguousarray makes a 0-d array 1-d: reshape it back
        bits = np.ascontiguousarray(arr).view(np.uint16).reshape(arr.shape)
        t = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(resolve_device(device))


def params_from_numpy(tree: Dict[str, Any], cfg: TransformerConfig,
                      device=None) -> Dict[str, Any]:
    """The reference's params pytree (nested dicts of numpy arrays) -> the
    port's params: the same names and shapes, on ``device`` (CUDA unless the
    caller asks for the CPU)."""
    from ray_tpu_torch.models.transformer import param_shapes

    dev = resolve_device(device)
    want = param_shapes(cfg)

    def convert(node, shapes, path):
        if set(node) != set(shapes):
            raise ValueError(f"params{path} has keys {sorted(node)}, "
                             f"the config expects {sorted(shapes)}")
        out = {}
        for name, sub in node.items():
            if isinstance(shapes[name], dict):
                out[name] = convert(sub, shapes[name], f"{path}[{name!r}]")
                continue
            t = tensor_from_numpy(sub, dev)
            if tuple(t.shape) != shapes[name]:
                raise ValueError(f"params{path}[{name!r}] has shape "
                                 f"{tuple(t.shape)}, the config expects "
                                 f"{shapes[name]}")
            out[name] = t
        return out

    return convert(tree, want, "")


def _adam_state(node):
    """optax's ``ScaleByAdamState`` (count, mu, nu) inside a chain's state
    (nested tuples, as numpy), found without importing optax; None if
    absent."""
    fields = getattr(node, "_fields", None)
    if fields is not None and {"count", "mu", "nu"} <= set(fields):
        return node._asdict()
    if not isinstance(node, (tuple, list)):
        return None
    for child in node:
        found = _adam_state(child)
        if found is not None:
            return found
    return None


def train_state_from_numpy(state: Dict[str, Any], cfg: TransformerConfig,
                           device=None) -> Dict[str, Any]:
    """The reference's train state as numpy (``{"step", "params",
    "opt_state"}``, the opt state that of its ``make_optimizer``:
    ``chain(clip_by_global_norm, adamw)``) -> the port's
    (``training.TrainState``: ``opt_state`` is ``{"count", "mu", "nu"}``),
    on ``device`` (CUDA unless the caller asks for the CPU). The clip and
    the other links of the chain keep no state the port needs: a schedule's
    count equals Adam's."""
    dev = resolve_device(device)
    adam = _adam_state(state["opt_state"])
    if adam is None:
        raise ValueError("opt_state holds no Adam state (count, mu, nu)")

    def count(x):
        return tensor_from_numpy(np.asarray(x, dtype=np.int32), dev)

    return {"step": count(state["step"]),
            "params": params_from_numpy(state["params"], cfg, dev),
            "opt_state": {"count": count(adam["count"]),
                          "mu": params_from_numpy(adam["mu"], cfg, dev),
                          "nu": params_from_numpy(adam["nu"], cfg, dev)}}


def _place(tree, placements, mesh):
    from ray_tpu_torch.parallel.sharding import distribute

    if isinstance(tree, dict):
        return {k: _place(v, placements[k], mesh) for k, v in tree.items()}
    if tree.dim() == 0:  # the step and count scalars stay plain (replicated)
        return tree
    return distribute(tree, mesh, placements)


def shard_params(mesh, params, cfg: TransformerConfig, rules=None):
    """Params -> DTensors placed by ``param_logical_axes`` on ``mesh`` (the
    layer stacks split over ``pipeline`` when it is above 1).
    ``params`` is the reference's pytree as numpy (through
    ``params_from_numpy``, onto this rank's device) or the port's own
    params; every rank passes the same values."""
    from ray_tpu_torch.models.transformer import placed_logical_axes
    from ray_tpu_torch.parallel.mesh import mesh_device
    from ray_tpu_torch.parallel.sharding import tree_shardings

    leaf = params
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    if not isinstance(leaf, torch.Tensor):
        params = params_from_numpy(params, cfg, mesh_device(mesh))
    return _place(params, tree_shardings(mesh, placed_logical_axes(cfg, mesh),
                                         rules), mesh)


def shard_state(mesh, state, cfg: TransformerConfig, tx, rules=None):
    """A train state ({"step", "params", "opt_state"}, the same on every
    rank) -> the same state with params and moments as DTensors placed by
    ``training.state_shardings``."""
    from ray_tpu_torch.models.training import state_shardings

    return _place(state, state_shardings(cfg, tx, mesh, rules), mesh)
