"""Random weights from the run's seed, made on the device in the type they
are served in.

Each leaf has a generator of its own, seeded from the run's seed and the
leaf's name, so any one leaf can be made again without the others (the
reference does so, and the training check remakes the starting weights
leaf by leaf). The layout is the stacked one the program takes: ``embed``
[V, d], ``layers`` {attn_norm, mlp_norm [L, d]; wq [L, d, H, hd]; wk, wv
[L, d, KV, hd]; wo [L, H, hd, d]; w_gate, w_up [L, d, ff], w_down [L, ff,
d]; with experts router [L, d, E], w_gate, w_up [L, E, d, ff], w_down [L,
E, ff, d]}, ``final_norm`` [d], ``lm_head`` [d, V]. Scales: d^-0.5 on the
inputs' side, (2L)^-0.5 d^-0.5 on the outputs' side of a residual branch
(times (ff/d)^0.5 for the FFN's down projection), norms at 1.
"""

from __future__ import annotations

import zlib
from typing import Dict, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def leaf_specs(cfg: dict) -> Dict[str, Tuple[tuple, float]]:
    """name -> (shape, scale); scale 0 means a norm's gamma (ones). Layer
    leaves are named ``layers/<name>``."""
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    H = cfg["num_attention_heads"]
    KV = cfg.get("num_key_value_heads") or H
    hd = cfg.get("head_dim") or d // H
    ff, V = cfg["intermediate_size"], cfg["vocab_size"]
    E = cfg.get("num_local_experts") or 0
    inp = d ** -0.5
    out = (2 * L) ** -0.5 * d ** -0.5
    specs = {
        "embed": ((V, d), d ** -0.5),
        "layers/attn_norm": ((L, d), 0.0),
        "layers/wq": ((L, d, H, hd), inp),
        "layers/wk": ((L, d, KV, hd), inp),
        "layers/wv": ((L, d, KV, hd), inp),
        "layers/wo": ((L, H, hd, d), out),
        "layers/mlp_norm": ((L, d), 0.0),
    }
    down = out * (ff / d) ** 0.5
    if E:
        specs.update({"layers/router": ((L, d, E), inp),
                      "layers/w_gate": ((L, E, d, ff), inp),
                      "layers/w_up": ((L, E, d, ff), inp),
                      "layers/w_down": ((L, E, ff, d), down)})
    else:
        specs.update({"layers/w_gate": ((L, d, ff), inp),
                      "layers/w_up": ((L, d, ff), inp),
                      "layers/w_down": ((L, ff, d), down)})
    specs["final_norm"] = ((d,), 0.0)
    if not cfg.get("tie_word_embeddings"):
        specs["lm_head"] = ((d, V), inp)
    return specs


def leaf_seed(seed: int, name: str) -> int:
    return (int(seed) * 1_000_003 + zlib.crc32(name.encode())) % (2 ** 63)


def make_leaf(cfg: dict, seed: int, name: str, device) -> torch.Tensor:
    shape, scale = leaf_specs(cfg)[name]
    dtype = DTYPES[cfg["torch_dtype"]]
    if scale == 0.0:
        return torch.ones(shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, name))
    x = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    return x.mul_(scale)


def make_params(cfg: dict, seed: int, device) -> dict:
    """The whole tree, in the program's nesting."""
    params: dict = {"layers": {}}
    for name in leaf_specs(cfg):
        leaf = make_leaf(cfg, seed, name, device)
        if name.startswith("layers/"):
            params["layers"][name.split("/", 1)[1]] = leaf
        else:
            params[name] = leaf
    return params


def leaf_names(cfg: dict):
    return list(leaf_specs(cfg))


def get_leaf(params: dict, name: str) -> torch.Tensor:
    if name.startswith("layers/"):
        return params["layers"][name.split("/", 1)[1]]
    return params[name]
