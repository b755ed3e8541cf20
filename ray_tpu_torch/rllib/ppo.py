"""PPO: synchronous on-policy training.

Ref analog: rllib/algorithms/ppo/ppo.py:394 (PPOConfig) and :420
(training_step): synchronous parallel sampling -> SGD epochs over
minibatches -> weight broadcast.
"""

from __future__ import annotations

import time

import ray_tpu_torch

from .algorithm import Algorithm, AlgorithmConfig
from .learner import PPOLearner
from .sample_batch import concat_samples


class PPOConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or PPO)
        self.clip_param = 0.2
        self.num_sgd_iter = 4
        self.sgd_minibatch_size = 128


class PPO(Algorithm):
    _config_cls = PPOConfig

    def _make_learner_factory(self, cfg, obs_dim, num_actions):
        def make():
            return PPOLearner(
                obs_dim, num_actions, lr=cfg.lr,
                clip_param=cfg.clip_param, vf_coeff=cfg.vf_coeff,
                entropy_coeff=cfg.entropy_coeff, grad_clip=cfg.grad_clip,
                hiddens=cfg.model_hiddens, seed=cfg.seed, device=cfg.device)

        return make

    def training_step(self) -> dict:
        cfg = self.algo_config
        t0 = time.perf_counter()
        # 1. synchronous parallel sampling (ref: rollout_ops.py:21)
        batches = ray_tpu_torch.get(
            [w.sample.remote() for w in self.workers], timeout=600)
        batch = concat_samples(batches)
        self._num_env_steps += batch.count
        t1 = time.perf_counter()
        # 2. SGD epochs over minibatches on the learner
        metrics = self.learners.update(
            batch, num_epochs=cfg.num_sgd_iter,
            minibatch_size=cfg.sgd_minibatch_size,
            seed=self.iteration)
        t2 = time.perf_counter()
        # 3. broadcast new weights to rollout workers
        self._sync_weights()
        metrics["env_steps_this_iter"] = batch.count
        # the iteration's split (the reference RLlib's timer names)
        metrics["timers"] = {
            "sample_time_ms": 1e3 * (t1 - t0),
            "learn_time_ms": 1e3 * (t2 - t1),
            "synch_weights_time_ms": 1e3 * (time.perf_counter() - t2)}
        return metrics
