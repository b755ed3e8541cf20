"""Contextual bandits: LinUCB and Linear Thompson Sampling.

Ref analog: rllib/algorithms/bandit/ (BanditLinUCB, BanditLinTS over
bandit_envs_discrete) — per-arm Bayesian linear regression with either a
UCB exploration bonus (Li et al. 2010) or posterior sampling. Re-design:
the per-arm sufficient statistics (A = I + X'X, b = X'r) update and the
arm scores are closed-form numpy on the driver — a bandit "learner" is
a rank-1 update, not an SGD program, so no rollout-worker fleet or XLA
step is warranted. The Algorithm surface (config/step/checkpoint) stays
identical so Tune drives bandits like any other algorithm.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .algorithm import Algorithm, AlgorithmConfig
from .env import make_env


class BanditConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or BanditLinUCB)
        self.env = "ContextualBandit-v0"
        self.steps_per_iter = 256
        self.alpha = 1.0          # UCB exploration width / prior scale
        self.lambda_reg = 1.0     # ridge prior


class _LinearBanditState:
    def __init__(self, num_arms: int, dim: int, lam: float):
        self.A = np.stack([np.eye(dim, dtype=np.float64) * lam
                           for _ in range(num_arms)])
        self.b = np.zeros((num_arms, dim), np.float64)
        self.num_arms, self.dim = num_arms, dim

    def theta(self) -> np.ndarray:
        return np.stack([np.linalg.solve(self.A[k], self.b[k])
                         for k in range(self.num_arms)])

    def update(self, arm: int, x: np.ndarray, r: float):
        self.A[arm] += np.outer(x, x)
        self.b[arm] += r * x


class BanditLinUCB(Algorithm):
    """argmax_k  theta_k.x + alpha * sqrt(x' A_k^-1 x)."""

    _config_cls = BanditConfig

    def setup(self, config):
        cfg = config.get("__algo_config__")
        cfg = cfg.copy() if cfg is not None else self.get_default_config()
        cfg.update_from_dict(
            {k: v for k, v in config.items() if k != "__algo_config__"})
        self.algo_config = cfg
        self.env = make_env(cfg.env)
        self.state = _LinearBanditState(self.env.num_actions,
                                        self.env.observation_dim,
                                        cfg.lambda_reg)
        self._rng = np.random.default_rng(cfg.seed)
        self._obs = self.env.reset(seed=cfg.seed)
        self.cumulative_regret = 0.0
        self.cumulative_reward = 0.0
        self._num_env_steps = 0

    def _choose(self, x: np.ndarray) -> int:
        cfg = self.algo_config
        scores = np.empty(self.state.num_arms)
        for k in range(self.state.num_arms):
            A_inv_x = np.linalg.solve(self.state.A[k], x)
            mean = float(self.state.b[k] @ A_inv_x)
            width = float(np.sqrt(max(x @ A_inv_x, 0.0)))
            scores[k] = mean + cfg.alpha * width
        return int(np.argmax(scores))

    def training_step(self) -> dict:
        cfg = self.algo_config
        regret_this = 0.0
        reward_this = 0.0
        for _ in range(cfg.steps_per_iter):
            x = self._obs.astype(np.float64)
            arm = self._choose(x)
            self._obs, r, _done, info = self.env.step(arm)
            self.state.update(arm, x, r)
            reward_this += r
            regret_this += info.get("regret", 0.0)
        self._num_env_steps += cfg.steps_per_iter
        self.cumulative_regret += regret_this
        self.cumulative_reward += reward_this
        return {
            "reward_mean": reward_this / cfg.steps_per_iter,
            "regret_mean": regret_this / cfg.steps_per_iter,
            "cumulative_regret": self.cumulative_regret,
            "num_env_steps_sampled": self._num_env_steps,
        }

    def step(self) -> dict:
        return self.training_step()

    def save_checkpoint(self):
        return {"A": self.state.A, "b": self.state.b,
                "steps": self._num_env_steps,
                "cum_regret": self.cumulative_regret}

    def load_checkpoint(self, checkpoint):
        if checkpoint:
            self.state.A = checkpoint["A"]
            self.state.b = checkpoint["b"]
            self._num_env_steps = checkpoint["steps"]
            self.cumulative_regret = checkpoint["cum_regret"]

    def cleanup(self):
        pass

    def get_policy_weights(self) -> Dict[str, np.ndarray]:
        return {"theta": self.state.theta()}


class BanditLinTS(BanditLinUCB):
    """Thompson sampling: draw theta_k ~ N(A_k^-1 b_k, alpha^2 A_k^-1),
    play the argmax (ref: BanditLinTS)."""

    def _choose(self, x: np.ndarray) -> int:
        cfg = self.algo_config
        scores = np.empty(self.state.num_arms)
        for k in range(self.state.num_arms):
            A_inv = np.linalg.inv(self.state.A[k])
            mu = A_inv @ self.state.b[k]
            sample = self._rng.multivariate_normal(
                mu, cfg.alpha ** 2 * A_inv)
            scores[k] = sample @ x
        return int(np.argmax(scores))
