"""TD3 + DDPG: deterministic-policy off-policy continuous control.

Ref analogs: rllib/algorithms/ddpg/ddpg.py (DDPGConfig: actor/critic lr,
tau, target-noise knobs, the DQN-style sample->store->replay->learn
training_step) and rllib/algorithms/td3/td3.py (TD3 = DDPG config preset
with twin_q, policy_delay=2, smoothed target actions — Fujimoto et al.
2018). The critic regression (twin-min smoothed Bellman target) and the
delayed actor ascent each run on the learner's device over a contiguous
replay batch; rollouts stay CPU actors.

The actor reuses the squashed-Gaussian parameter layout (mu head only is
trained) so worker-side weight sync lands in the same
``SquashedGaussianPolicy`` every continuous algorithm here uses — TD3's
exploration is mean action + numpy Gaussian noise, not the policy's own
(untrained) log_std head. The target smoothing noise comes from the
learner's ``torch.Generator`` and enters ``critic_loss`` as an argument.
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
                     seeded, to_numpy)
from .replay_buffers import ReplayBuffer
from .rollout_worker import ContinuousRolloutWorker, _collect_transitions
from .sac import to_batch
from .sample_batch import SampleBatch, concat_samples


class TD3Config(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or TD3)
        self.env = "Pendulum-v1"
        self.lr = 1e-3                   # actor
        self.critic_lr = 1e-3
        self.train_batch_size = 128
        self.replay_buffer_capacity = 100_000
        self.num_steps_sampled_before_learning_starts = 1000
        self.tau = 0.005                 # Polyak target blend
        self.twin_q = True
        self.policy_delay = 2
        self.target_noise = 0.2          # smoothing noise on target action
        self.target_noise_clip = 0.5
        self.explore_noise = 0.1         # rollout-side N(0, s*scale)
        self.num_updates_per_iter = 64
        self.warmup_random_action_prob = 1.0


class DDPGConfig(TD3Config):
    """DDPG = TD3 minus its three fixes (ref: td3.py presets inverted)."""

    def __init__(self, algo_class=None):
        super().__init__(algo_class or DDPG)
        self.twin_q = False
        self.policy_delay = 1
        self.target_noise = 0.0


class TD3Learner:
    """Deterministic actor + (twin) critics + Polyak targets on one
    device: ``critic_step`` every update, ``actor_step`` (which also
    blends the targets) every ``policy_delay`` updates."""

    def __init__(self, obs_dim: int, action_dim: int, *, actor_lr: float,
                 critic_lr: float, gamma: float, tau: float,
                 action_scale, action_shift, twin_q: bool,
                 target_noise: float, target_noise_clip: float,
                 hiddens=(64, 64), seed: int = 0, device=None):
        self.device = dev = resolve_device(device)
        gen = seeded(seed)
        self.twin_q = bool(twin_q)
        self.action_dim = action_dim
        self.state = {
            "actor": init_gaussian_actor(gen, obs_dim, action_dim, hiddens,
                                         dev),
            "q1": init_q_net(gen, obs_dim, action_dim, hiddens, dev),
            "q2": init_q_net(gen, obs_dim, action_dim, hiddens, dev),
        }
        for t, s in (("t_actor", "actor"), ("tq1", "q1"), ("tq2", "q2")):
            self.state[t] = clone_tree(self.state[s])
        self.actor_tx, self.critic_tx = adam(actor_lr), adam(critic_lr)
        self.opt_state = {
            "actor": self.actor_tx.init(self.state["actor"]),
            "critic": self.critic_tx.init(self._critics()),
        }
        self._gen = torch.Generator(dev).manual_seed(int(seed) + 1)
        self.gamma, self.tau = gamma, tau
        self.target_noise = target_noise
        self.target_noise_clip = target_noise_clip
        f32 = dict(dtype=torch.float32, device=dev)
        self.scale = torch.as_tensor(action_scale, **f32)
        self.shift = torch.as_tensor(action_shift, **f32)
        self.lo, self.hi = self.shift - self.scale, self.shift + self.scale

    def _critics(self):
        return {"q1": self.state["q1"], "q2": self.state["q2"]}

    def act(self, actor, obs):
        mu, _ = gaussian_forward(actor, obs)
        return self.shift + self.scale * torch.tanh(mu)

    def critic_loss(self, qs, state, batch, noise):
        """``noise`` [B, A]: the target smoothing draws (unused when
        target_noise is 0)."""
        a_next = self.act(state["t_actor"], batch[SB.NEXT_OBS])
        if self.target_noise > 0.0:
            s = self.scale
            eps = torch.minimum(torch.maximum(
                self.target_noise * s * noise,
                -self.target_noise_clip * s), self.target_noise_clip * s)
            a_next = torch.minimum(torch.maximum(a_next + eps, self.lo),
                                   self.hi)
        tq = q_forward(state["tq1"], batch[SB.NEXT_OBS], a_next)
        if self.twin_q:
            tq = torch.minimum(tq, q_forward(state["tq2"],
                                             batch[SB.NEXT_OBS], a_next))
        not_done = 1.0 - batch[SB.DONES].to(torch.float32)
        target = (batch[SB.REWARDS] + self.gamma * not_done * tq).detach()
        e1 = q_forward(qs["q1"], batch[SB.OBS], batch[SB.ACTIONS]) - target
        loss = torch.mean(e1 ** 2)
        if self.twin_q:
            e2 = q_forward(qs["q2"], batch[SB.OBS],
                           batch[SB.ACTIONS]) - target
            loss = loss + torch.mean(e2 ** 2)
        return loss, None

    def actor_loss(self, actor, state, batch):
        a = self.act(actor, batch[SB.OBS])
        return -torch.mean(q_forward(state["q1"], batch[SB.OBS], a)), None

    def critic_step(self, batch, noise):
        """-> (loss, grads {"q1", "q2"})."""
        loss, _, grads = value_and_grad(self.critic_loss, self._critics(),
                                        self.state, batch, noise)
        self.critic_tx.step_(grads, self.opt_state["critic"],
                             self._critics())
        return loss, grads

    def actor_step(self, batch):
        """The actor on the critics after their step; then the targets
        blend toward the new actor and critics. -> (loss, grads)."""
        st = self.state
        loss, _, grads = value_and_grad(self.actor_loss, st["actor"], st,
                                        batch)
        self.actor_tx.step_(grads, self.opt_state["actor"], st["actor"])
        for t, s in (("t_actor", "actor"), ("tq1", "q1"), ("tq2", "q2")):
            polyak_(st[t], st[s], self.tau)
        return loss, grads

    def update(self, batch: SampleBatch, *, do_actor: bool) -> dict:
        dev = to_batch(batch, self.device)
        noise = None
        if self.target_noise > 0.0:
            noise = torch.randn((dev[SB.OBS].shape[0], self.action_dim),
                                generator=self._gen, device=self.device)
        closs, _ = self.critic_step(dev, noise)
        out = {"critic_loss": float(closs)}
        if do_actor:
            aloss, _ = self.actor_step(dev)
            out["actor_loss"] = float(aloss)
        return out

    def get_weights(self) -> Dict[str, np.ndarray]:
        # worker policies are SquashedGaussianPolicy — same param layout
        return to_numpy(self.state["actor"])

    def set_weights(self, weights):
        self.state["actor"] = params_from_numpy(weights, self.device)

    def full_state(self) -> dict:
        return {"state": to_numpy(self.state),
                "opt_state": to_numpy(self.opt_state),
                "rng": self._gen.get_state().numpy().copy()}

    def load_full_state(self, payload: dict):
        self.state = params_from_numpy(payload["state"], self.device)
        self.opt_state = params_from_numpy(payload["opt_state"],
                                           self.device)
        self._gen.set_state(torch.from_numpy(np.asarray(payload["rng"])))


class TD3RolloutWorker(ContinuousRolloutWorker):
    """Deterministic action + N(0, noise*scale), clipped to bounds
    (ref: DDPG's GaussianNoise exploration, rllib/utils/exploration/
    gaussian_noise.py)."""

    def sample_transitions(self, epsilon: float = 0.0,
                           noise: float = 0.1) -> SampleBatch:
        N, A = self.vec.num_envs, self.vec.action_dim
        env0 = self.vec.envs[0]
        lo, hi = env0.action_low, env0.action_high
        sigma = noise * (hi - lo) / 2.0

        def select(obs):
            if epsilon >= 1.0:  # pure warmup
                return self._rng.uniform(
                    lo, hi, size=(N, A)).astype(np.float32)
            actions, _ = self.policy.compute_actions(obs, explore=False)
            actions = actions + sigma * self._rng.standard_normal(
                (N, A)).astype(np.float32)
            return np.clip(actions, lo, hi).astype(np.float32)

        return _collect_transitions(self.vec, self.rollout_len, select,
                                    (A,), np.float32, self.conn)


class TD3(Algorithm):
    _config_cls = TD3Config
    _worker_cls = TD3RolloutWorker

    def _make_learner_factory(self, cfg, obs_dim, action_dim):
        probe = self._probe_env
        scale = (probe.action_high - probe.action_low) / 2.0
        shift = (probe.action_high + probe.action_low) / 2.0

        def make():
            return TD3Learner(
                obs_dim, action_dim, actor_lr=cfg.lr,
                critic_lr=cfg.critic_lr, gamma=cfg.gamma, tau=cfg.tau,
                action_scale=scale, action_shift=shift,
                twin_q=cfg.twin_q, target_noise=cfg.target_noise,
                target_noise_clip=cfg.target_noise_clip,
                hiddens=cfg.model_hiddens, seed=cfg.seed,
                device=cfg.device)

        return make

    def setup(self, config):
        super().setup(config)
        cfg = self.algo_config
        self.replay = ReplayBuffer(cfg.replay_buffer_capacity,
                                   seed=cfg.seed)
        self._updates = 0

    def training_step(self) -> dict:
        cfg = self.algo_config
        warming_up = (self.replay.num_added <
                      cfg.num_steps_sampled_before_learning_starts)
        eps = cfg.warmup_random_action_prob if warming_up else 0.0
        batches = ray_tpu_torch.get(
            [w.sample_transitions.remote(eps, cfg.explore_noise)
             for w in self.workers], timeout=300)
        fresh = concat_samples(batches)
        self.replay.add(fresh)
        self._num_env_steps += fresh.count

        metrics = {"env_steps_this_iter": fresh.count,
                   "replay_size": len(self.replay)}
        learner = self.learners.local
        if self.replay.num_added >= \
                cfg.num_steps_sampled_before_learning_starts:
            last = {}
            for _ in range(cfg.num_updates_per_iter):
                sample = self.replay.sample(cfg.train_batch_size)
                if sample is None:
                    break
                self._updates += 1
                last = learner.update(
                    sample,
                    do_actor=self._updates % cfg.policy_delay == 0)
            metrics.update(last)
            self._sync_weights()
        return metrics

    def save_checkpoint(self):
        return {"td3_state": self.learners.local.full_state(),
                "num_env_steps": self._num_env_steps,
                "updates": self._updates}

    def load_checkpoint(self, checkpoint):
        if checkpoint and "td3_state" in checkpoint:
            self.learners.local.load_full_state(checkpoint["td3_state"])
            self._num_env_steps = checkpoint.get("num_env_steps", 0)
            self._updates = checkpoint.get("updates", 0)
            self._sync_weights()
        else:
            super().load_checkpoint(checkpoint)


class DDPG(TD3):
    _config_cls = DDPGConfig
