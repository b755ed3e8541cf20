"""SAC: off-policy maximum-entropy actor-critic for continuous control.

Ref analogs: rllib/algorithms/sac/sac.py:34 (SACConfig: twin-Q, tau,
target-entropy/alpha knobs, training_step via the DQN-style
sample->store->replay->learn loop) and sac_torch_policy.py (actor/critic/
alpha losses). The whole update — twin-critic Bellman regression against
the entropy-regularized target, reparameterized actor step, temperature
(alpha) step, and the Polyak target blend — runs on the learner's device
(the card unless the caller asks for the CPU) over a contiguous replay
batch; rollouts stay CPU actors (ContinuousRolloutWorker).

The reparameterization noise comes from the learner's ``torch.Generator``
and enters the losses as an argument (``critic_loss`` / ``actor_loss``),
so a test can hand both sides the same draws.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch._device import resolve_device

from . import sample_batch as SB
from .algorithm import Algorithm, AlgorithmConfig
from .learner import adam, value_and_grad
from .models import (clone_tree, gaussian_forward, init_gaussian_actor,
                     init_q_net, params_from_numpy, polyak_, q_forward,
                     seeded, squashed_from_noise, to_numpy)
from .replay_buffers import ReplayBuffer
from .rollout_worker import ContinuousRolloutWorker
from .sample_batch import SampleBatch, concat_samples

COLUMNS = (SB.OBS, SB.ACTIONS, SB.REWARDS, SB.DONES, SB.NEXT_OBS)


class SACConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or SAC)
        self.env = "Pendulum-v1"
        self.lr = 3e-4
        self.critic_lr = 3e-4
        self.alpha_lr = 3e-4
        self.train_batch_size = 128
        self.replay_buffer_capacity = 100_000
        self.num_steps_sampled_before_learning_starts = 1000
        self.tau = 0.005                 # Polyak target blend
        self.initial_alpha = 0.2
        self.target_entropy = None       # None -> -action_dim (SAC paper)
        self.num_updates_per_iter = 64
        self.warmup_random_action_prob = 1.0


def to_batch(batch, device) -> Dict[str, torch.Tensor]:
    """The replay columns an off-policy continuous learner reads, on
    ``device`` (dones stay bool)."""
    return {k: torch.as_tensor(np.asarray(batch[k]), device=device)
            for k in COLUMNS}


def critic_loss(qs, actor, tq1, tq2, alpha, batch, noise, gamma: float,
                scale: float, shift: float):
    """Both critics' squared Bellman errors against the entropy-regularized
    twin-min target; ``noise`` [B, A] draws the next action."""
    mu, log_std = gaussian_forward(actor, batch[SB.NEXT_OBS])
    a_next, logp_next = squashed_from_noise(mu, log_std, noise, scale,
                                            shift)
    tq = torch.minimum(q_forward(tq1, batch[SB.NEXT_OBS], a_next),
                       q_forward(tq2, batch[SB.NEXT_OBS], a_next))
    not_done = 1.0 - batch[SB.DONES].to(torch.float32)
    target = (batch[SB.REWARDS] + gamma * not_done * (
        tq - alpha * logp_next)).detach()
    e1 = q_forward(qs["q1"], batch[SB.OBS], batch[SB.ACTIONS]) - target
    e2 = q_forward(qs["q2"], batch[SB.OBS], batch[SB.ACTIONS]) - target
    return torch.mean(e1 ** 2) + torch.mean(e2 ** 2), None


def actor_loss(actor, q1, q2, alpha, batch, noise, scale: float,
               shift: float):
    """-> (mean(alpha logp - min Q), logp); ``noise`` [B, A]."""
    mu, log_std = gaussian_forward(actor, batch[SB.OBS])
    a, logp = squashed_from_noise(mu, log_std, noise, scale, shift)
    q = torch.minimum(q_forward(q1, batch[SB.OBS], a),
                      q_forward(q2, batch[SB.OBS], a))
    return torch.mean(alpha * logp - q), logp


class SACLearner:
    """Actor + twin critics + targets + learnable temperature on one
    device; one update is the critic step, then the actor step on the
    updated critics, then the temperature step on the actor step's logp,
    then the target blend (losses per Haarnoja et al. 2018; three Adams)."""

    def __init__(self, obs_dim: int, action_dim: int, *, actor_lr: float,
                 critic_lr: float, alpha_lr: float, gamma: float,
                 tau: float, action_scale: float, initial_alpha: float,
                 target_entropy: float, hiddens=(64, 64), seed: int = 0,
                 action_shift: float = 0.0, device=None):
        self.device = dev = resolve_device(device)
        gen = seeded(seed)
        self.action_dim = action_dim
        self.state = {
            "actor": init_gaussian_actor(gen, obs_dim, action_dim, hiddens,
                                         dev),
            "q1": init_q_net(gen, obs_dim, action_dim, hiddens, dev),
            "q2": init_q_net(gen, obs_dim, action_dim, hiddens, dev),
            "log_alpha": torch.tensor(float(np.log(initial_alpha)),
                                      device=dev),
        }
        self.state["tq1"] = clone_tree(self.state["q1"])
        self.state["tq2"] = clone_tree(self.state["q2"])
        self.actor_tx, self.critic_tx, self.alpha_tx = (
            adam(actor_lr), adam(critic_lr), adam(alpha_lr))
        self.opt_state = {
            "actor": self.actor_tx.init(self.state["actor"]),
            "critic": self.critic_tx.init(self._critics()),
            "alpha": self.alpha_tx.init(self.state["log_alpha"]),
        }
        self._gen = torch.Generator(dev).manual_seed(int(seed) + 1)
        self.gamma, self.tau = gamma, tau
        self.scale, self.shift = float(action_scale), float(action_shift)
        self.target_entropy = float(target_entropy)

    def _critics(self):
        return {"q1": self.state["q1"], "q2": self.state["q2"]}

    def train_step(self, batch, noise_next, noise) -> tuple:
        """One update on ``batch`` (tensors on the device) with the given
        standard-normal draws for the next action (critic) and the action
        (actor), each [B, A] -> (metrics, grads), the grads each stage
        applied: {"critic": {"q1", "q2"}, "actor", "alpha"}."""
        st = self.state
        alpha = torch.exp(st["log_alpha"])
        closs, _, cgrads = value_and_grad(
            critic_loss, self._critics(), st["actor"], st["tq1"], st["tq2"],
            alpha, batch, noise_next, self.gamma, self.scale, self.shift)
        self.critic_tx.step_(cgrads, self.opt_state["critic"],
                             self._critics())
        # the actor sees the critics after their step
        aloss, logp, agrads = value_and_grad(
            actor_loss, st["actor"], st["q1"], st["q2"], alpha, batch,
            noise, self.scale, self.shift)
        self.actor_tx.step_(agrads, self.opt_state["actor"], st["actor"])
        # temperature: alpha tracks the target entropy on the FRESH logp
        lgrad = -(torch.mean(logp) + self.target_entropy)
        self.alpha_tx.step_(lgrad, self.opt_state["alpha"],
                            st["log_alpha"])
        polyak_(st["tq1"], st["q1"], self.tau)
        polyak_(st["tq2"], st["q2"], self.tau)
        metrics = {"critic_loss": closs, "actor_loss": aloss,
                   "alpha": alpha, "entropy": -torch.mean(logp)}
        return metrics, {"critic": cgrads, "actor": agrads, "alpha": lgrad}

    def draw_noise(self, rows: int):
        shape = (rows, self.action_dim)
        return (torch.randn(shape, generator=self._gen, device=self.device),
                torch.randn(shape, generator=self._gen, device=self.device))

    def update(self, batch: SampleBatch) -> dict:
        dev = to_batch(batch, self.device)
        metrics, _ = self.train_step(
            dev, *self.draw_noise(dev[SB.OBS].shape[0]))
        return {k: float(v) for k, v in metrics.items()}

    # weights contract: workers only need the actor

    def get_weights(self) -> Dict[str, np.ndarray]:
        return to_numpy(self.state["actor"])

    def set_weights(self, weights: Dict[str, np.ndarray]):
        self.state["actor"] = params_from_numpy(weights, self.device)

    def full_state(self) -> dict:
        """Everything resume needs: params/targets/alpha AND the three
        Adam states + the generator's state (restoring without optimizer
        moments would transiently destabilize the alpha update)."""
        return {"state": to_numpy(self.state),
                "opt_state": to_numpy(self.opt_state),
                "rng": self._gen.get_state().numpy().copy()}

    def load_full_state(self, payload: dict):
        if "state" not in payload:  # pre-opt_state checkpoint layout
            self.state = params_from_numpy(payload, self.device)
            return
        self.state = params_from_numpy(payload["state"], self.device)
        self.opt_state = params_from_numpy(payload["opt_state"],
                                           self.device)
        self._gen.set_state(torch.from_numpy(np.asarray(payload["rng"])))


class SAC(Algorithm):
    _config_cls = SACConfig
    _worker_cls = ContinuousRolloutWorker

    def _make_learner_factory(self, cfg, obs_dim, action_dim):
        probe = self._probe_env  # the probe Algorithm.setup already built
        scale = (probe.action_high - probe.action_low) / 2.0
        shift = (probe.action_high + probe.action_low) / 2.0
        tgt_ent = (cfg.target_entropy if cfg.target_entropy is not None
                   else -float(action_dim))

        def make():
            return SACLearner(
                obs_dim, action_dim, actor_lr=cfg.lr,
                critic_lr=cfg.critic_lr, alpha_lr=cfg.alpha_lr,
                gamma=cfg.gamma, tau=cfg.tau, action_scale=scale,
                action_shift=shift, initial_alpha=cfg.initial_alpha,
                target_entropy=tgt_ent, hiddens=cfg.model_hiddens,
                seed=cfg.seed, device=cfg.device)

        return make

    def setup(self, config):
        cfg0 = config.get("__algo_config__")
        # num_learners can arrive on the config object OR as a plain key
        # (the Tune search-space path algorithm.py merges in setup)
        if (cfg0 is not None and getattr(cfg0, "num_learners", 0)) or \
                config.get("num_learners"):
            raise ValueError(
                "SAC uses a single local learner; num_learners > 0 is not "
                "supported")
        super().setup(config)
        cfg = self.algo_config
        self.replay = ReplayBuffer(cfg.replay_buffer_capacity,
                                   seed=cfg.seed)

    def training_step(self) -> dict:
        cfg = self.algo_config
        warming_up = (self.replay.num_added <
                      cfg.num_steps_sampled_before_learning_starts)
        eps = cfg.warmup_random_action_prob if warming_up else 0.0
        batches = ray_tpu_torch.get(
            [w.sample_transitions.remote(eps) for w in self.workers],
            timeout=300)
        fresh = concat_samples(batches)
        self.replay.add(fresh)
        self._num_env_steps += fresh.count

        metrics = {"env_steps_this_iter": fresh.count,
                   "replay_size": len(self.replay)}
        learner = self.learners.local  # SAC updates are local, one device
        if self.replay.num_added >= \
                cfg.num_steps_sampled_before_learning_starts:
            last = {}
            for _ in range(cfg.num_updates_per_iter):
                sample = self.replay.sample(cfg.train_batch_size)
                if sample is None:
                    break
                last = learner.update(sample)
            metrics.update(last)
            self._sync_weights()
        return metrics

    def save_checkpoint(self):
        return {"sac_state": self.learners.local.full_state(),
                "num_env_steps": self._num_env_steps}

    def load_checkpoint(self, checkpoint):
        if checkpoint and "sac_state" in checkpoint:
            self.learners.local.load_full_state(checkpoint["sac_state"])
            self._num_env_steps = checkpoint.get("num_env_steps", 0)
            self._sync_weights()
        else:
            super().load_checkpoint(checkpoint)
