"""Model catalog: observation/action spec -> encoder + heads.

Ref analog: rllib/models/catalog.py (ModelCatalog.get_model_v2 maps
space + model_config to a network class, with a custom-model registry)
— functional: a catalog entry is a pure ``(init_fn, forward_fn)`` pair
over a params dict of tensors. Built-ins: "mlp" (the default the
gradient algorithms use), "conv" (MinAtar-class plane observations;
kernels kept in the reference's HWIO layout), "gru" (recurrent encoder
for R2D2-style sequence learners).

    init_fn(gen, device=None) -> params
    forward_fn(params, obs[, state]) -> (logits, value[, state])

Custom models register by name, mirroring
``ModelCatalog.register_custom_model``::

    register_custom_model("my_net", my_init, my_forward)
    init, fwd = get_model(spec, {"type": "my_net"})
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .models import (Params, _heads, _mlp, _ortho, _to,
                     forward as _mlp_forward, init_actor_critic)

_CUSTOM: Dict[str, Tuple[Callable, Callable]] = {}


def register_custom_model(name: str, init_fn: Callable,
                          forward_fn: Callable) -> None:
    """Register ``(init_fn(gen, spec, config), forward_fn)`` under
    ``name`` (ref: ModelCatalog.register_custom_model)."""
    _CUSTOM[name] = (init_fn, forward_fn)


class ModelSpec:
    """What the catalog needs to size a model: flat observation dim (or
    plane shape for conv) and the discrete action count."""

    def __init__(self, obs_dim: int, num_actions: int,
                 obs_planes: Optional[Tuple[int, int, int]] = None):
        self.obs_dim = int(obs_dim)
        self.num_actions = int(num_actions)
        # (C, H, W) when observations are flattened feature planes
        # (BreakoutMini: (4, 10, 10) flattened to 400)
        self.obs_planes = obs_planes


def get_model(spec: ModelSpec, model_config: Optional[dict] = None
              ) -> Tuple[Callable[..., Params], Callable]:
    """-> (init_fn, forward_fn) for the configured model type.

    init_fn(gen, device=None) -> params on ``device`` (CUDA unless the
    caller asks for the CPU); forward_fn(params, obs [B, D]) -> (logits
    [B, A], value [B]) for feedforward types; the "gru" type
    returns/consumes a carry state (see gru_forward).
    """
    cfg = dict(model_config or {})
    kind = cfg.get("type", "mlp")
    if kind in _CUSTOM:
        init, fwd = _CUSTOM[kind]
        return (lambda gen, device=None: _to(init(gen, spec, cfg),
                                             device)), fwd
    if kind == "mlp":
        hiddens = tuple(cfg.get("hiddens", (64, 64)))
        return (lambda gen, device=None: init_actor_critic(
            gen, spec.obs_dim, spec.num_actions, hiddens,
            device)), _mlp_forward
    if kind == "conv":
        if spec.obs_planes is None:
            raise ValueError("conv model needs spec.obs_planes=(C, H, W)")
        return _conv_entry(spec, cfg)
    if kind == "gru":
        hidden = int(cfg.get("hidden", 64))
        embed = tuple(cfg.get("hiddens", (64,)))
        return (lambda gen, device=None: init_gru(
            gen, spec.obs_dim, spec.num_actions, hidden, embed,
            device)), gru_forward
    raise ValueError(f"unknown model type {kind!r}; "
                     f"registered: {sorted(_CUSTOM)}")


# ------------------------------------------------------------------- conv


def _conv_entry(spec: ModelSpec, cfg: dict):
    filters = tuple(cfg.get("conv_filters", (16, 32)))
    hiddens = tuple(cfg.get("hiddens", (128,)))
    C, H, W = spec.obs_planes

    def init(gen: torch.Generator, device=None) -> Params:
        params: Params = {}
        cin = C
        for i, cout in enumerate(filters):
            # 3x3 convs, HWIO; He-style scale on the fan-in
            fan_in = cin * 9
            params[f"cw{i}"] = torch.randn(
                (3, 3, cin, cout), generator=gen,
                device=gen.device) * math.sqrt(2.0 / fan_in)
            params[f"cb{i}"] = torch.zeros((cout,))
            cin = cout
        flat = cin * H * W  # SAME padding keeps the plane size
        sizes = [flat, *hiddens]
        for i in range(len(hiddens)):
            params[f"w{i}"] = _ortho(gen, (sizes[i], sizes[i + 1]),
                                     gain=math.sqrt(2.0))
            params[f"b{i}"] = torch.zeros((sizes[i + 1],))
        params["w_pi"] = _ortho(gen, (sizes[-1], spec.num_actions),
                                gain=0.01)
        params["b_pi"] = torch.zeros((spec.num_actions,))
        params["w_v"] = _ortho(gen, (sizes[-1], 1), gain=1.0)
        params["b_v"] = torch.zeros((1,))
        return _to(params, device)

    def fwd(params: Params, obs: torch.Tensor):
        B = obs.shape[0]
        # flat [B, C*H*W] is NCHW already; the kernels are HWIO, so OIHW
        # for conv2d. A 3x3 SAME conv at stride 1 pads 1 on every side.
        x = obs.reshape(B, C, H, W)
        n_conv = sum(1 for k in params if k.startswith("cw"))
        for i in range(n_conv):
            x = F.conv2d(x, params[f"cw{i}"].permute(3, 2, 0, 1),
                         params[f"cb{i}"], padding=1)
            x = torch.relu(x)
        # flatten in the reference's H, W, C order, which w0's rows follow
        return _heads(params,
                      _mlp(params, x.permute(0, 2, 3, 1).reshape(B, -1)))

    return init, fwd


# -------------------------------------------------------------------- gru


def init_gru(gen: torch.Generator, obs_dim: int, num_actions: int,
             hidden: int = 64, embed: Sequence[int] = (64,),
             device=None) -> Params:
    """Embedding MLP -> GRU cell -> (pi, v) heads. The recurrent model
    for R2D2-class sequence learners (ref: rllib's use_lstm wrapper,
    models/torch/recurrent_net.py)."""
    params: Params = {}
    sizes = [obs_dim, *embed]
    for i in range(len(embed)):
        params[f"w{i}"] = _ortho(gen, (sizes[i], sizes[i + 1]),
                                 gain=math.sqrt(2.0))
        params[f"b{i}"] = torch.zeros((sizes[i + 1],))
    E = sizes[-1]
    # fused GRU weights: [E, 3H] input and [H, 3H] recurrent (r, z, n)
    params["gru_wi"] = _ortho(gen, (E, 3 * hidden), gain=1.0)
    params["gru_wh"] = _ortho(gen, (hidden, 3 * hidden), gain=1.0)
    params["gru_b"] = torch.zeros((3 * hidden,))
    params["w_pi"] = _ortho(gen, (hidden, num_actions), gain=0.01)
    params["b_pi"] = torch.zeros((num_actions,))
    params["w_v"] = _ortho(gen, (hidden, 1), gain=1.0)
    params["b_v"] = torch.zeros((1,))
    return _to(params, device)


def gru_cell(params: Params, x: torch.Tensor, h: torch.Tensor
             ) -> torch.Tensor:
    """One GRU step: x [B, E], h [B, H] -> new h [B, H]."""
    H = h.shape[-1]
    gi = x @ params["gru_wi"] + params["gru_b"]
    gh = h @ params["gru_wh"]
    r = torch.sigmoid(gi[:, :H] + gh[:, :H])
    z = torch.sigmoid(gi[:, H:2 * H] + gh[:, H:2 * H])
    n = torch.tanh(gi[:, 2 * H:] + r * gh[:, 2 * H:])
    return (1.0 - z) * n + z * h


def gru_forward(params: Params, obs: torch.Tensor,
                state: Optional[torch.Tensor] = None):
    """obs [B, D] (one step) -> (logits [B, A], value [B], new state).
    ``state`` [B, H] defaults to zeros (episode start)."""
    H = params["gru_wh"].shape[0]
    if state is None:
        state = torch.zeros((obs.shape[0], H), dtype=obs.dtype,
                            device=obs.device)
    h = gru_cell(params, _mlp(params, obs), state)
    return (*_heads(params, h), h)


def gru_unroll(params: Params, obs_seq: torch.Tensor,
               h0: torch.Tensor, reset: Optional[torch.Tensor] = None):
    """Unroll over time, one step at a time (the reference's lax.scan):
    obs_seq [T, B, D], h0 [B, H], reset [T, B] bool (True clears the carry
    BEFORE consuming step t — episode boundaries inside a training
    sequence); -> (logits [T, B, A], values [T, B], h_final [B, H])."""
    h = h0
    logits, values = [], []
    for t in range(obs_seq.shape[0]):
        if reset is not None:
            h = torch.where(reset[t][:, None], torch.zeros_like(h), h)
        h = gru_cell(params, _mlp(params, obs_seq[t]), h)
        lg, v = _heads(params, h)
        logits.append(lg)
        values.append(v)
    return torch.stack(logits), torch.stack(values), h
