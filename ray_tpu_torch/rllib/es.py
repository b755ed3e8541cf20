"""ES: OpenAI-style evolution strategies (Salimans et al. 2017).

Ref analog: rllib/algorithms/es/es.py — perturbation-based black-box
optimization: workers evaluate antithetic weight perturbations
theta ± sigma*eps, the driver combines centered-rank-weighted noise into
a gradient estimate and Adam-steps the master weights. Shared noise is
reconstructed from integer seeds (the reference's SharedNoiseTable
trick), so worker->driver traffic is (seed, return) pairs, never weight
vectors. Evaluation is deterministic argmax over the actor head of the
same MLP the gradient algorithms use, run by CPU worker actors (torch
held to one intra-op thread); the update is numpy Adam on the host, as
in the reference: ES puts nothing on the card.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

import torch

import ray_tpu_torch
from ray_tpu_torch._device import resolve_device

from .algorithm import Algorithm, AlgorithmConfig
from .env import make_env
from .models import forward as ac_forward
from .models import init_actor_critic, seeded, to_numpy


class ESConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or ES)
        self.num_rollout_workers = 2
        self.episodes_per_perturbation = 1
        self.perturbations_per_step = 16  # antithetic pairs
        self.sigma = 0.05
        self.lr = 0.02
        self.l2_coeff = 0.005


def _flatten(weights: Dict[str, np.ndarray]):
    keys = sorted(weights)
    flat = np.concatenate([np.asarray(weights[k]).ravel() for k in keys])
    shapes = [(k, weights[k].shape) for k in keys]
    return flat.astype(np.float32), shapes


def _unflatten(flat: np.ndarray, shapes) -> Dict[str, np.ndarray]:
    out, i = {}, 0
    for k, shp in shapes:
        n = int(np.prod(shp)) if shp else 1
        out[k] = flat[i:i + n].reshape(shp)
        i += n
    return out


def _noise(seed: int, dim: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        dim).astype(np.float32)


@torch.no_grad()
def greedy_action(weights: Dict[str, np.ndarray], obs: np.ndarray) -> int:
    """argmax of the policy head for one observation, on the CPU."""
    params = {k: torch.from_numpy(np.asarray(v)) for k, v in weights.items()}
    logits, _ = ac_forward(params, torch.from_numpy(
        np.asarray(obs, np.float32)[None]))
    return int(torch.argmax(logits[0]))


def centered_ranks(x: np.ndarray) -> np.ndarray:
    """Map returns to [-0.5, 0.5] by rank (the reference's
    compute_centered_ranks — robust to reward scale)."""
    ranks = np.empty(len(x), np.float32)
    ranks[x.argsort()] = np.arange(len(x), dtype=np.float32)
    return ranks / max(len(x) - 1, 1) - 0.5


class ESWorker:
    """Evaluates perturbed policies; stateless between calls except the
    env (fresh episodes each time)."""

    def __init__(self, env_creator, episodes: int, seed: int = 0,
                 hiddens=(64, 64)):
        torch.set_num_threads(1)
        self.env = make_env(env_creator)
        self.episodes = episodes
        self.hiddens = hiddens
        self._eval_seq = seed * 100_000

    def _episode_return(self, weights: Dict[str, np.ndarray]) -> float:
        total = 0.0
        for _ in range(self.episodes):
            self._eval_seq += 1
            obs = self.env.reset(seed=self._eval_seq)
            done = False
            while not done:
                obs, r, done, _ = self.env.step(greedy_action(weights, obs))
                total += r
        return total / self.episodes

    def evaluate(self, flat: np.ndarray, shapes, seeds: List[int],
                 sigma: float):
        """-> [(seed, return_pos, return_neg)] for antithetic pairs."""
        out = []
        for s in seeds:
            eps = _noise(s, flat.size)
            r_pos = self._episode_return(_unflatten(flat + sigma * eps,
                                                    shapes))
            r_neg = self._episode_return(_unflatten(flat - sigma * eps,
                                                    shapes))
            out.append((s, r_pos, r_neg))
        return out

    def episode_metrics(self) -> dict:
        return {"episode_returns": [], "episode_lengths": []}

    def ping(self) -> bool:
        return True


class ES(Algorithm):
    _config_cls = ESConfig
    _worker_cls = ESWorker

    def setup(self, config):
        cfg = config.get("__algo_config__")
        cfg = cfg.copy() if cfg is not None else self.get_default_config()
        cfg.update_from_dict(
            {k: v for k, v in config.items() if k != "__algo_config__"})
        self.algo_config = cfg
        # as every algorithm: no card and no device="cpu" raises before
        # any worker starts (the update itself is numpy on the host)
        resolve_device(cfg.device)
        probe = make_env(cfg.env)
        assert not getattr(probe, "continuous", False), \
            "ES here supports discrete-action envs"
        weights = to_numpy(init_actor_critic(
            seeded(cfg.seed), probe.observation_dim, probe.num_actions,
            cfg.model_hiddens, "cpu"))
        self._flat, self._shapes = _flatten(weights)
        # Adam state (host-side: the parameter vector is tiny and the
        # update is O(dim * perturbations) numpy)
        self._m = np.zeros_like(self._flat)
        self._v = np.zeros_like(self._flat)
        self._t = 0
        worker_cls = ray_tpu_torch.remote(ESWorker)
        self.workers = [
            worker_cls.options(num_cpus=1).remote(
                cfg.env, cfg.episodes_per_perturbation,
                seed=cfg.seed + i, hiddens=cfg.model_hiddens)
            for i in range(cfg.num_rollout_workers)]
        self._seed_seq = cfg.seed * 1_000_003
        self._episode_returns: List[float] = []
        self._num_env_steps = 0

    def training_step(self) -> dict:
        cfg = self.algo_config
        n = cfg.perturbations_per_step
        seeds = [self._seed_seq + i for i in range(n)]
        self._seed_seq += n
        shards = np.array_split(np.asarray(seeds), len(self.workers))
        futs = [w.evaluate.remote(self._flat, self._shapes,
                                  [int(s) for s in shard], cfg.sigma)
                for w, shard in zip(self.workers, shards) if len(shard)]
        results = [r for out in ray_tpu_torch.get(futs, timeout=1200)
                   for r in out]
        rets = np.array([[rp, rn] for (_s, rp, rn) in results], np.float32)
        ranks = centered_ranks(rets.ravel()).reshape(rets.shape)
        grad = np.zeros_like(self._flat)
        for (s, _rp, _rn), (w_pos, w_neg) in zip(results, ranks):
            grad += (w_pos - w_neg) * _noise(s, self._flat.size)
        grad /= (2 * len(results) * cfg.sigma)
        grad -= cfg.l2_coeff * self._flat  # weight decay toward 0
        # Adam ascent on the rank objective
        self._t += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        self._m = b1 * self._m + (1 - b1) * grad
        self._v = b2 * self._v + (1 - b2) * grad * grad
        mh = self._m / (1 - b1 ** self._t)
        vh = self._v / (1 - b2 ** self._t)
        self._flat = self._flat + cfg.lr * mh / (np.sqrt(vh) + eps)
        self._episode_returns = rets.ravel().tolist()
        return {"perturbations": len(results),
                "reward_mean_perturbed": float(rets.mean()),
                "reward_max_perturbed": float(rets.max()),
                "update_norm": float(np.linalg.norm(grad))}

    def step(self) -> dict:
        result = self.training_step()
        # evaluate the CURRENT (unperturbed) policy like the reference's
        # ES reports its eval episodes
        w = _unflatten(self._flat, self._shapes)
        env = make_env(self.algo_config.env)
        rets = []
        for ep in range(3):
            obs = env.reset(seed=50_000 + self.iteration * 10 + ep)
            total, done = 0.0, False
            while not done:
                obs, r, done, _ = env.step(greedy_action(w, obs))
                total += r
            rets.append(total)
        result["episode_reward_mean"] = float(np.mean(rets))
        return result

    def save_checkpoint(self):
        return {"flat": self._flat, "shapes": self._shapes,
                "m": self._m, "v": self._v, "t": self._t}

    def load_checkpoint(self, checkpoint):
        if checkpoint:
            self._flat = checkpoint["flat"]
            self._shapes = checkpoint["shapes"]
            self._m, self._v = checkpoint["m"], checkpoint["v"]
            self._t = checkpoint["t"]

    def get_policy_weights(self) -> dict:
        return _unflatten(self._flat, self._shapes)

    def cleanup(self):
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
