"""Parameters from the JAX package's pytree, as numpy, into the port.

The port keeps the reference's parameter names and stacked ``[L, ...]``
shapes, so converting is array by array. bf16 needs care: JAX's bf16 arrays
reach numpy with the dtype named ``bfloat16`` (an ``ml_dtypes`` type that
``torch.from_numpy`` refuses). They travel as their raw 16 bits, a uint16
view, and are reinterpreted as ``torch.bfloat16``, without importing
``ml_dtypes``.
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
