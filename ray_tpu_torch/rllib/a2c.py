"""A2C: synchronous advantage actor-critic.

Ref analog: rllib/algorithms/a2c/a2c.py (A2CConfig, training_step —
sample synchronously from all workers, ONE gradient step on the joint
batch, broadcast). The learner mirrors PPO's but with the vanilla
policy-gradient loss (no ratio clipping, no SGD epochs); microbatching
is available via ``microbatch_size`` (the reference's A2C
grad-accumulation knob).
"""

from __future__ import annotations

import torch

import ray_tpu_torch

from . import sample_batch as SB
from .algorithm import Algorithm, AlgorithmConfig
from .learner import Learner, _host, normalized
from .models import entropy_of, forward, logp_of
from .sample_batch import SampleBatch, concat_samples


class A2CConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or A2C)
        self.lr = 1e-3
        self.microbatch_size = 0  # 0 = single step on the whole batch


class A2CLearner(Learner):
    """One actor-critic gradient step (loss = -logp * adv +
    vf_coeff * vf_mse - entropy_coeff * entropy)."""

    columns = (SB.OBS, SB.ACTIONS, SB.ADVANTAGES, SB.VALUE_TARGETS)

    def __init__(self, obs_dim: int, num_actions: int, *, lr: float,
                 vf_coeff: float, entropy_coeff: float, grad_clip: float,
                 hiddens=(64, 64), seed: int = 0, device=None):
        super().__init__(obs_dim, num_actions, lr=lr, grad_clip=grad_clip,
                         hiddens=hiddens, seed=seed, device=device)
        self.vf_coeff, self.entropy_coeff = vf_coeff, entropy_coeff

    def loss(self, params, batch):
        logits, values = forward(params, batch[SB.OBS])
        logp = logp_of(logits, batch[SB.ACTIONS])
        adv = normalized(batch[SB.ADVANTAGES])
        pi_loss = -(logp * adv).mean()
        vf_loss = torch.mean((values - batch[SB.VALUE_TARGETS]) ** 2)
        ent = entropy_of(logits).mean()
        total = pi_loss + self.vf_coeff * vf_loss - self.entropy_coeff * ent
        return total, {"policy_loss": pi_loss, "vf_loss": vf_loss,
                       "entropy": ent}

    def update(self, batch: SampleBatch, *, microbatch_size: int = 0,
               **_) -> dict:
        if not (microbatch_size and batch.count > microbatch_size):
            return super().update(batch)
        # grad ACCUMULATION (the reference's A2C microbatch knob): average
        # microbatch grads, then ONE optimizer step (adv normalization
        # stays per-microbatch, as in the reference)
        acc, metric_sums, n = None, {}, 0
        for mb in batch.minibatches(microbatch_size):
            grads, metrics = self._grads(self._batch(mb))
            acc = grads if acc is None else {k: acc[k] + grads[k]
                                             for k in acc}
            for k, v in metrics.items():
                metric_sums[k] = metric_sums.get(k, 0.0) + _host(v)
            n += 1
        self.tx.step_({k: g / n for k, g in acc.items()}, self.opt_state,
                      self.params)
        return {k: v / n for k, v in metric_sums.items()}


class A2C(Algorithm):
    _config_cls = A2CConfig

    def _make_learner_factory(self, cfg, obs_dim, num_actions):
        def make():
            return A2CLearner(obs_dim, num_actions, lr=cfg.lr,
                              vf_coeff=cfg.vf_coeff,
                              entropy_coeff=cfg.entropy_coeff,
                              grad_clip=cfg.grad_clip,
                              hiddens=cfg.model_hiddens, seed=cfg.seed,
                              device=cfg.device)

        return make

    def training_step(self) -> dict:
        cfg = self.algo_config
        batches = ray_tpu_torch.get(
            [w.sample.remote() for w in self.workers], timeout=600)
        batch = concat_samples(batches)
        self._num_env_steps += batch.count
        metrics = self.learners.update(
            batch, microbatch_size=cfg.microbatch_size)
        self._sync_weights()
        metrics["env_steps_this_iter"] = batch.count
        return metrics
