"""Policy networks: plain-PyTorch MLP actor-critic.

Ref analog: rllib/models/torch/fcnet.py (FullyConnectedNetwork) +
core/rl_module/rl_module.py:229 — pure functions over a params dict of
tensors (the reference's names and shapes), so a learner's update is a
handful of batched products on the device its params live on.

Inits draw from a ``torch.Generator`` on the CPU and then move to
``device``, so one seed gives the same params on the CPU and on the card.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device

Params = Dict[str, torch.Tensor]


def params_from_numpy(tree, device=None):
    """The reference's numpy params (or weights a learner sent) -> the
    port's: same names and shapes, one copy per leaf, on ``device`` (CUDA
    unless the caller asks for the CPU). Nested dicts (SAC's and TD3's
    nets, Dreamer's ``{"w", "b"}`` layers) keep their nesting; a numpy
    scalar (SAC's ``log_alpha``) becomes a 0-d tensor. Conv kernels stay
    HWIO."""
    dev = resolve_device(device)
    return _from_numpy(tree, dev)


def _from_numpy(tree, dev):
    if isinstance(tree, dict):
        return {k: _from_numpy(v, dev) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(dev)


def to_numpy(params):
    """A snapshot as numpy: copies, never views of tensors that a later
    in-place step would change (CPU tensors share memory with .numpy());
    nested dicts keep their nesting."""
    if isinstance(params, dict):
        return {k: to_numpy(v) for k, v in params.items()}
    return params.detach().to("cpu", copy=True).numpy()


def clone_tree(tree):
    """A copy of every leaf (``jax.tree.map(jnp.copy, ...)``)."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    return tree.detach().clone()


@torch.no_grad()
def polyak_(target, online, tau: float):
    """target <- tau online + (1 - tau) target, leaf by leaf in place (a
    Polyak or EMA target net)."""
    for k in target:
        if isinstance(target[k], dict):
            polyak_(target[k], online[k], tau)
        else:
            target[k].copy_(tau * online[k] + (1.0 - tau) * target[k])


def _to(params: Params, device) -> Params:
    dev = resolve_device(device)
    return {k: v.to(dev) for k, v in params.items()}


def _n_hidden(params: Params) -> int:
    return sum(1 for k in params if k.startswith("w") and k[1:].isdigit())


def _mlp(params: Params, x: torch.Tensor) -> torch.Tensor:
    for i in range(_n_hidden(params)):
        x = torch.tanh(x @ params[f"w{i}"] + params[f"b{i}"])
    return x


def init_actor_critic(gen: torch.Generator, obs_dim: int, num_actions: int,
                      hiddens: Sequence[int] = (64, 64),
                      device=None) -> Params:
    params: Params = {}
    sizes = [obs_dim, *hiddens]
    for i in range(len(hiddens)):
        params[f"w{i}"] = _ortho(gen, (sizes[i], sizes[i + 1]),
                                 gain=math.sqrt(2.0))
        params[f"b{i}"] = torch.zeros((sizes[i + 1],))
    params["w_pi"] = _ortho(gen, (sizes[-1], num_actions), gain=0.01)
    params["b_pi"] = torch.zeros((num_actions,))
    params["w_v"] = _ortho(gen, (sizes[-1], 1), gain=1.0)
    params["b_v"] = torch.zeros((1,))
    return _to(params, device)


def _ortho(gen: torch.Generator, shape, gain: float) -> torch.Tensor:
    """``gain`` times a matrix with orthonormal columns (rows when it is
    wide), from a QR of a normal draw on ``gen``'s device."""
    a = torch.randn(shape, generator=gen, device=gen.device)
    q, r = torch.linalg.qr(a if shape[0] >= shape[1] else a.T)
    q = q * torch.sign(torch.diagonal(r))
    if shape[0] < shape[1]:
        q = q.T
    return gain * q[: shape[0], : shape[1]]


def forward(params: Params, obs: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (logits [B, A], value [B])."""
    return _heads(params, _mlp(params, obs))


def _heads(params: Params, x: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    logits = x @ params["w_pi"] + params["b_pi"]
    value = (x @ params["w_v"] + params["b_v"]).squeeze(-1)
    return logits, value


# ------------------------------------------------- continuous (SAC) nets


def init_gaussian_actor(gen: torch.Generator, obs_dim: int, action_dim: int,
                        hiddens: Sequence[int] = (64, 64),
                        device=None) -> Params:
    """Tanh-squashed diagonal-Gaussian policy trunk + (mean, log_std)
    heads (ref analog: rllib SACTorchModel's policy net,
    rllib/algorithms/sac/sac_torch_model.py — re-done as a pure fn)."""
    params: Params = {}
    sizes = [obs_dim, *hiddens]
    for i in range(len(hiddens)):
        params[f"w{i}"] = _ortho(gen, (sizes[i], sizes[i + 1]),
                                 gain=math.sqrt(2.0))
        params[f"b{i}"] = torch.zeros((sizes[i + 1],))
    params["w_mu"] = _ortho(gen, (sizes[-1], action_dim), gain=0.01)
    params["b_mu"] = torch.zeros((action_dim,))
    params["w_ls"] = _ortho(gen, (sizes[-1], action_dim), gain=0.01)
    params["b_ls"] = torch.zeros((action_dim,))
    return _to(params, device)


def gaussian_forward(params: Params, obs: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (mean [B, A], log_std [B, A]), log_std clamped to a sane range."""
    x = _mlp(params, obs)
    mu = x @ params["w_mu"] + params["b_mu"]
    log_std = torch.clamp(x @ params["w_ls"] + params["b_ls"], -20.0, 2.0)
    return mu, log_std


def squashed_sample(params: Params, obs: torch.Tensor,
                    gen: torch.Generator, scale: float, shift: float = 0.0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reparameterized a = shift + scale*tanh(u), u ~ N(mu, std);
    -> (a, logp) with the tanh change-of-variables correction. For an
    action box [low, high], scale = (high-low)/2 and shift =
    (high+low)/2 (the shift doesn't enter the log-det)."""
    mu, log_std = gaussian_forward(params, obs)
    noise = torch.randn(mu.shape, generator=gen, device=mu.device,
                        dtype=mu.dtype)
    return squashed_from_noise(mu, log_std, noise, scale, shift)


def squashed_from_noise(mu: torch.Tensor, log_std: torch.Tensor,
                        noise: torch.Tensor, scale: float,
                        shift: float = 0.0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``squashed_sample`` on given standard-normal ``noise`` [B, A]."""
    std = torch.exp(log_std)
    u = mu + std * noise
    logp_u = torch.sum(
        -0.5 * ((u - mu) / std) ** 2 - log_std
        - 0.5 * math.log(2.0 * math.pi), dim=-1)
    a = torch.tanh(u)
    # d/du [scale*tanh(u)] = scale*(1-tanh^2): subtract its log per dim
    logp = logp_u - torch.sum(
        torch.log(scale * (1.0 - a ** 2) + 1e-6), dim=-1)
    return shift + scale * a, logp


def init_q_net(gen: torch.Generator, obs_dim: int, action_dim: int,
               hiddens: Sequence[int] = (64, 64), device=None) -> Params:
    """Q(s, a) -> scalar: MLP over the concatenated [obs, action]."""
    params: Params = {}
    sizes = [obs_dim + action_dim, *hiddens]
    for i in range(len(hiddens)):
        params[f"w{i}"] = _ortho(gen, (sizes[i], sizes[i + 1]),
                                 gain=math.sqrt(2.0))
        params[f"b{i}"] = torch.zeros((sizes[i + 1],))
    params["w_q"] = _ortho(gen, (sizes[-1], 1), gain=1.0)
    params["b_q"] = torch.zeros((1,))
    return _to(params, device)


def q_forward(params: Params, obs: torch.Tensor, act: torch.Tensor
              ) -> torch.Tensor:
    x = _mlp(params, torch.cat([obs, act], dim=-1))
    return (x @ params["w_q"] + params["b_q"]).squeeze(-1)


def logp_of(logits: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """log pi(a) of integer ``actions`` [B] (any integer dtype)."""
    logps = torch.log_softmax(logits, dim=-1)
    return torch.gather(logps, 1, actions.long()[:, None]).squeeze(-1)


def entropy_of(logits: torch.Tensor) -> torch.Tensor:
    logps = torch.log_softmax(logits, dim=-1)
    return -torch.sum(torch.exp(logps) * logps, dim=-1)


def seeded(seed: int) -> torch.Generator:
    """The CPU generator an init draws from."""
    return torch.Generator().manual_seed(int(seed))


def gumbel(shape, gen: torch.Generator, device=None) -> torch.Tensor:
    """Standard Gumbel noise -log(E), E ~ Exp(1), drawn on ``gen``."""
    e = torch.empty(shape, device=device or gen.device)
    return -torch.log(e.exponential_(generator=gen))


def categorical_from_gumbel(logits: torch.Tensor, g: torch.Tensor
                            ) -> torch.Tensor:
    """A categorical draw over the last axis on given Gumbel noise:
    ``jax.random.categorical(key, logits)`` is ``argmax(gumbel(key,
    logits.shape) + logits)``, so the same noise gives the same draw."""
    return torch.argmax(g + logits, dim=-1)
