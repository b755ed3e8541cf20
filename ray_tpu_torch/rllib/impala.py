"""IMPALA: asynchronous off-policy training with V-trace correction.

Ref analog: rllib/algorithms/impala/impala.py:552 (async sample queue +
aggregation, :685 training_step). Pipelined: every rollout worker keeps
``num_inflight_per_worker`` sample futures outstanding (rollout latency is
hidden behind the learner), and ``num_aggregation_batches`` completed
rollouts are coalesced into one [T, N_total] batch per learner update —
the reference's aggregation actors exist to feed the learner large
batches the same way; here the concat is driver-side numpy and the update
one learner step, so the card sees few large batches instead of many
small ones. Batches may be several updates stale; V-trace corrects.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

import ray_tpu_torch

from .algorithm import Algorithm, AlgorithmConfig
from .learner import ImpalaLearner
from .sample_batch import SampleBatch


class IMPALAConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or IMPALA)
        self.lr = 5e-4
        self.grad_clip = 40.0
        self.clip_rho = 1.0
        self.clip_c = 1.0
        self.max_updates_per_step = 8
        # pipeline depth: outstanding rollouts per worker
        self.num_inflight_per_worker = 2
        # rollouts merged per learner update (fixed -> stable batch shapes)
        self.num_aggregation_batches = 2


def _concat_time_major(batches: List[SampleBatch]) -> SampleBatch:
    """Merge [T, Ni] rollouts along the env axis -> [T, sum(Ni)]."""
    out = {}
    for k in batches[0]:
        axis = 0 if k == "bootstrap_obs" else 1
        out[k] = np.concatenate([b[k] for b in batches], axis=axis)
    return SampleBatch(out)


class IMPALA(Algorithm):
    _config_cls = IMPALAConfig

    def _make_learner_factory(self, cfg, obs_dim, num_actions):
        def make():
            return ImpalaLearner(
                obs_dim, num_actions, lr=cfg.lr, gamma=cfg.gamma,
                vf_coeff=cfg.vf_coeff, entropy_coeff=cfg.entropy_coeff,
                grad_clip=cfg.grad_clip, clip_rho=cfg.clip_rho,
                clip_c=cfg.clip_c, hiddens=cfg.model_hiddens,
                seed=cfg.seed, device=cfg.device)

        return make

    def setup(self, config):
        super().setup(config)
        cfg = self.algo_config
        # prime the pipeline: K outstanding rollouts per worker
        self._inflight: Dict = {}
        for w in self.workers:
            for _ in range(cfg.num_inflight_per_worker):
                self._inflight[w.sample_time_major.remote()] = w

    def training_step(self) -> dict:
        cfg = self.algo_config
        metrics: dict = {}
        steps = 0
        updates = 0
        agg = max(1, min(cfg.num_aggregation_batches, len(self._inflight)))
        while updates < cfg.max_updates_per_step:
            done, _ = ray_tpu_torch.wait(list(self._inflight),
                                         num_returns=agg, timeout=600)
            if len(done) < agg:
                raise TimeoutError(
                    f"IMPALA: only {len(done)}/{agg} rollouts completed "
                    f"within 600s — rollout workers dead or stalled")
            batches = ray_tpu_torch.get(list(done), timeout=600)
            workers_done = [self._inflight.pop(r) for r in done]
            merged = _concat_time_major(batches)
            # one large update instead of `agg` small ones
            metrics = self.learners.local.update(merged)
            updates += 1
            steps += merged["actions"].size
            # refresh weights once per update round (once per distinct
            # worker), then refill the pipeline slots
            w_ref = ray_tpu_torch.put(self.learners.get_weights())
            for w in dict((id(x), x) for x in workers_done).values():
                w.set_weights.remote(w_ref)
            for w in workers_done:
                self._inflight[w.sample_time_major.remote()] = w
        self._num_env_steps += steps
        metrics["env_steps_this_iter"] = steps
        metrics["updates_this_iter"] = updates
        metrics["aggregation"] = agg
        return metrics
