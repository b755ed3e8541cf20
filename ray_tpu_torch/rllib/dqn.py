"""DQN: off-policy Q-learning with replay, target network, double-Q.

Ref analogs: rllib/algorithms/dqn/dqn.py:38 (DQNConfig: buffer/epsilon/
target-update knobs, training_step :637 — sample rollouts -> store ->
replay-sample -> learn -> update priorities -> sync target) and
dqn_rainbow_learner / torch policy losses. The update (double-Q target,
Huber loss, Adam step, |TD| for priorities) runs on the learner's device;
the replay buffer hands it a contiguous numpy batch
(replay_buffers.py), so the card never sees Python-loop assembly.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

import ray_tpu_torch

from . import sample_batch as SB
from .algorithm import Algorithm, AlgorithmConfig
from .learner import Learner, _host, take
from .models import forward
from .replay_buffers import PrioritizedReplayBuffer, ReplayBuffer
from .sample_batch import SampleBatch, concat_samples


class DQNConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or DQN)
        self.lr = 5e-4
        self.train_batch_size = 64
        self.replay_buffer_capacity = 50_000
        self.prioritized_replay = True
        self.prioritized_replay_alpha = 0.6
        self.prioritized_replay_beta = 0.4
        self.num_steps_sampled_before_learning_starts = 1000
        self.target_network_update_freq = 500   # env steps
        self.epsilon_initial = 1.0
        self.epsilon_final = 0.02
        self.epsilon_timesteps = 10_000
        self.double_q = True
        self.num_updates_per_iter = 32


class DQNLearner(Learner):
    """Online + target Q-nets; one double-DQN update step."""

    columns = (SB.OBS, SB.ACTIONS, SB.REWARDS, SB.DONES, SB.NEXT_OBS,
               "weights")

    def __init__(self, obs_dim: int, num_actions: int, *, lr: float,
                 gamma: float, hiddens=(64, 64), double_q: bool = True,
                 seed: int = 0, device=None):
        # optax.adam(lr): no gradient clip
        super().__init__(obs_dim, num_actions, lr=lr, grad_clip=None,
                         hiddens=hiddens, seed=seed, device=device)
        self.gamma, self.double_q = gamma, double_q
        self.sync_target()

    def loss(self, params, batch):
        q_all, _ = forward(params, batch[SB.OBS])
        q_sel = take(q_all, batch[SB.ACTIONS])
        with torch.no_grad():  # the target is held fixed (stop_gradient)
            q_next_t, _ = forward(self.target_params, batch[SB.NEXT_OBS])
            if self.double_q:
                # action choice by the ONLINE net, value by the target net
                q_next_o, _ = forward(params, batch[SB.NEXT_OBS])
                a_star = torch.argmax(q_next_o, dim=1)
            else:
                a_star = torch.argmax(q_next_t, dim=1)
            q_next = take(q_next_t, a_star)
            not_done = 1.0 - batch[SB.DONES].to(torch.float32)
            target = batch[SB.REWARDS] + self.gamma * not_done * q_next
        td = q_sel - target
        # optax.huber_loss(td, 0, delta=1.0)
        abs_td = torch.abs(td)
        quadratic = torch.clamp(abs_td, max=1.0)
        huber = 0.5 * quadratic ** 2 + (abs_td - quadratic)
        weights = batch.get("weights")
        if weights is not None:
            huber = huber * weights
        return torch.mean(huber), {"td_abs": abs_td}

    def update(self, batch: SampleBatch) -> dict:
        out = self._step(self._batch(batch))
        return {"loss": _host(out["total_loss"]),
                "td_abs": _host(out["td_abs"])}

    def sync_target(self):
        """Hard target copy (ref: target_network_update_freq semantics)."""
        self.target_params = {k: v.clone() for k, v in self.params.items()}

    def set_weights(self, weights: Dict[str, np.ndarray]):
        super().set_weights(weights)
        self.sync_target()


class DQN(Algorithm):
    _config_cls = DQNConfig

    def _make_learner_factory(self, cfg, obs_dim, num_actions):
        def make():
            return DQNLearner(obs_dim, num_actions, lr=cfg.lr,
                              gamma=cfg.gamma, hiddens=cfg.model_hiddens,
                              double_q=cfg.double_q, seed=cfg.seed,
                              device=cfg.device)

        return make

    def setup(self, config):
        super().setup(config)
        cfg = self.algo_config
        buf_cls = (PrioritizedReplayBuffer if cfg.prioritized_replay
                   else ReplayBuffer)
        kw = ({"alpha": cfg.prioritized_replay_alpha}
              if cfg.prioritized_replay else {})
        self.replay = buf_cls(cfg.replay_buffer_capacity,
                              seed=cfg.seed, **kw)
        self._last_target_sync = 0

    def _epsilon(self) -> float:
        cfg = self.algo_config
        frac = min(1.0, self._num_env_steps / max(cfg.epsilon_timesteps, 1))
        return cfg.epsilon_initial + frac * (cfg.epsilon_final
                                             - cfg.epsilon_initial)

    def training_step(self) -> dict:
        cfg = self.algo_config
        eps = self._epsilon()
        batches = ray_tpu_torch.get(
            [w.sample_transitions.remote(eps) for w in self.workers],
            timeout=300)
        fresh = concat_samples(batches)
        self.replay.add(fresh)
        self._num_env_steps += fresh.count

        metrics = {"env_steps_this_iter": fresh.count, "epsilon": eps,
                   "replay_size": len(self.replay)}
        learner = self.learners.local  # DQN updates are local, one device
        if self.replay.num_added >= \
                cfg.num_steps_sampled_before_learning_starts:
            losses = []
            for _ in range(cfg.num_updates_per_iter):
                if cfg.prioritized_replay:
                    sample = self.replay.sample(
                        cfg.train_batch_size,
                        beta=cfg.prioritized_replay_beta)
                else:
                    sample = self.replay.sample(cfg.train_batch_size)
                if sample is None:
                    break
                out = learner.update(sample)
                losses.append(out["loss"])
                self.replay.update_priorities(sample["batch_indexes"],
                                              out["td_abs"])
            if losses:
                metrics["loss"] = float(np.mean(losses))
            # hard target sync every target_network_update_freq env steps
            if self._num_env_steps - self._last_target_sync >= \
                    cfg.target_network_update_freq:
                learner.sync_target()
                self._last_target_sync = self._num_env_steps
            self._sync_weights()
        return metrics
