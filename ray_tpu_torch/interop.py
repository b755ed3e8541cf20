"""Parameters from the JAX package's pytree, as numpy, into the port.

The port keeps the reference's parameter names and stacked ``[L, ...]``
shapes, so converting is array by array. bf16 needs care: JAX's bf16 arrays
reach numpy with the dtype named ``bfloat16`` (an ``ml_dtypes`` type that
``torch.from_numpy`` refuses). They travel as their raw 16 bits, a uint16
view, and are reinterpreted as ``torch.bfloat16``, without importing
``ml_dtypes``.

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
        bits = np.ascontiguousarray(arr).view(np.uint16)
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
