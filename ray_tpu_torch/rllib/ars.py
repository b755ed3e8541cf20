"""ARS: augmented random search (Mania et al. 2018, V1-t).

Ref analog: rllib/algorithms/ars/ars.py — the same antithetic
perturbation machinery as ES but with the two "augmentations": only the
top-k best directions (by max of the pair's returns) contribute to the
update, and the step is scaled by the standard deviation of the selected
returns instead of centered ranks. Workers are the ES evaluation actors
verbatim — the algorithms differ only in how the driver combines
(seed, r+, r-) pairs. Observation normalization (ARS V2) composes via
the connector pipeline's NormalizeObs rather than being baked in. As ES,
ARS's workers are CPU actors and its update is numpy on the host: ARS
puts nothing on the card.
"""

from __future__ import annotations

import numpy as np

import ray_tpu_torch
from ray_tpu_torch._device import resolve_device

from .algorithm import Algorithm
from .es import ESConfig, ESWorker, _flatten, _noise, _unflatten
from .env import make_env
from .models import init_actor_critic, seeded, to_numpy


class ARSConfig(ESConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or ARS)
        self.perturbations_per_step = 16
        self.top_directions = 8      # k best antithetic pairs used
        self.sigma = 0.05
        self.lr = 0.02


class ARS(Algorithm):
    _config_cls = ARSConfig
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
            "ARS here supports discrete-action envs"
        weights = to_numpy(init_actor_critic(
            seeded(cfg.seed), probe.observation_dim, probe.num_actions,
            cfg.model_hiddens, "cpu"))
        self._flat, self._shapes = _flatten(weights)
        worker_cls = ray_tpu_torch.remote(ESWorker)
        self.workers = [
            worker_cls.options(num_cpus=1).remote(
                cfg.env, cfg.episodes_per_perturbation,
                seed=cfg.seed + i, hiddens=cfg.model_hiddens)
            for i in range(cfg.num_rollout_workers)]
        self._seed_seq = cfg.seed * 1_000_003
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
        triples = [t for out in ray_tpu_torch.get(futs, timeout=600)
                   for t in out]
        r_pos = np.asarray([t[1] for t in triples], np.float32)
        r_neg = np.asarray([t[2] for t in triples], np.float32)
        # top-k directions by the better of the pair
        k = min(cfg.top_directions, len(triples))
        order = np.argsort(-np.maximum(r_pos, r_neg))[:k]
        sel = np.asarray([r_pos[order], r_neg[order]])
        sigma_r = float(sel.std()) or 1.0
        grad = np.zeros_like(self._flat)
        for i in order:
            grad += (r_pos[i] - r_neg[i]) * _noise(
                int(triples[i][0]), self._flat.size)
        self._flat = self._flat + cfg.lr / (k * sigma_r) * grad
        return {"episode_reward_mean": float(
                    np.mean(np.concatenate([r_pos, r_neg]))),
                "episode_reward_max": float(
                    np.max(np.concatenate([r_pos, r_neg]))),
                "top_k_reward_mean": float(sel.mean()),
                "reward_std": sigma_r,
                "env_steps_this_iter": 0}

    def step(self) -> dict:
        return self.training_step()

    def get_policy_weights(self) -> dict:
        return _unflatten(self._flat, self._shapes)

    def save_checkpoint(self):
        return {"flat": self._flat, "seed_seq": self._seed_seq}

    def load_checkpoint(self, checkpoint):
        if checkpoint and "flat" in checkpoint:
            self._flat = np.asarray(checkpoint["flat"], np.float32)
            self._seed_seq = int(checkpoint["seed_seq"])

    def cleanup(self):
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
