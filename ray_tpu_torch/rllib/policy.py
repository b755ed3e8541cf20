"""TorchPolicy: action computation + weight transport.

Ref analog: rllib/policy/policy.py:177 (compute_actions, get/set_weights);
the counterpart of the reference's JaxPolicy. One sample step (forward +
categorical sample + logp) shared by rollout workers; draws come from the
policy's own ``torch.Generator``, seeded from ``seed``; weights move as
numpy dicts through the object store.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device

from .models import (forward, gaussian_forward, init_actor_critic,
                     init_gaussian_actor, logp_of, params_from_numpy,
                     seeded, squashed_sample, to_numpy)


class TorchPolicy:
    """Discrete actor-critic policy on ``device`` (CUDA unless the caller
    asks for the CPU, as a rollout worker does)."""

    def __init__(self, obs_dim: int, num_actions: int,
                 hiddens=(64, 64), seed: int = 0, device=None):
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.device = resolve_device(device)
        self._gen = torch.Generator(self.device).manual_seed(int(seed))
        self.params = init_actor_critic(seeded(seed), obs_dim, num_actions,
                                        hiddens, self.device)

    def _obs(self, obs) -> torch.Tensor:
        return torch.as_tensor(np.asarray(obs, np.float32),
                               device=self.device)

    @torch.no_grad()
    def compute_actions(self, obs: np.ndarray, explore: bool = True
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray]:
        """-> (actions, logp, vf_preds, logits) as numpy."""
        logits, v = forward(self.params, self._obs(obs))
        if explore:
            a = torch.multinomial(torch.softmax(logits, dim=-1), 1,
                                  generator=self._gen).squeeze(-1)
            lp = logp_of(logits, a)
        else:
            a = torch.argmax(logits, dim=-1)
            lp = torch.zeros_like(v)
            logits = torch.zeros_like(logits)
        return (a.cpu().numpy(), lp.cpu().numpy(), v.cpu().numpy(),
                logits.cpu().numpy())

    @torch.no_grad()
    def greedy(self, obs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """-> (argmax actions, values) as numpy; DQN reads the logits head
        as Q-values."""
        logits, v = forward(self.params, self._obs(obs))
        return torch.argmax(logits, dim=-1).cpu().numpy(), v.cpu().numpy()

    def value(self, obs: np.ndarray) -> np.ndarray:
        return self.greedy(obs)[1]

    def get_weights(self) -> Dict[str, np.ndarray]:
        return to_numpy(self.params)

    def set_weights(self, weights: Dict[str, np.ndarray]):
        self.params = params_from_numpy(weights, self.device)


class SquashedGaussianPolicy:
    """Continuous-action policy: a = scale*tanh(u), u ~ N(mu, std).

    The rollout-side half of SAC (ref analog: the deterministic/stochastic
    action path of rllib/algorithms/sac/sac_torch_policy.py); weights move
    as numpy dicts like TorchPolicy's.
    """

    def __init__(self, obs_dim: int, action_dim: int, action_scale: float,
                 hiddens=(64, 64), seed: int = 0,
                 action_shift: float = 0.0, device=None):
        self.obs_dim = obs_dim
        self.action_dim = action_dim
        self.action_scale = float(action_scale)
        self.action_shift = float(action_shift)
        self.device = resolve_device(device)
        self._gen = torch.Generator(self.device).manual_seed(int(seed))
        self.params = init_gaussian_actor(seeded(seed), obs_dim, action_dim,
                                          hiddens, self.device)

    @torch.no_grad()
    def compute_actions(self, obs: np.ndarray, explore: bool = True
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (actions [B, A], logp [B]) as numpy."""
        obs = torch.as_tensor(np.asarray(obs, np.float32),
                              device=self.device)
        if explore:
            a, lp = squashed_sample(self.params, obs, self._gen,
                                    self.action_scale, self.action_shift)
        else:
            mu, _ = gaussian_forward(self.params, obs)
            a = self.action_shift + self.action_scale * torch.tanh(mu)
            lp = torch.zeros(obs.shape[0], device=self.device)
        return a.cpu().numpy(), lp.cpu().numpy()

    def get_weights(self) -> Dict[str, np.ndarray]:
        return to_numpy(self.params)

    def set_weights(self, weights: Dict[str, np.ndarray]):
        self.params = params_from_numpy(weights, self.device)
