"""Multi-agent RL: shared environments, per-policy batches and learners.

Ref analogs: rllib/env/multi_agent_env.py:32 (MultiAgentEnv — dict-keyed
obs/rewards/dones per agent), rllib/policy/sample_batch.py:1322
(MultiAgentBatch: policy_id -> SampleBatch + env_steps), and the
policy_mapping_fn config (algorithm_config.multi_agent()). One PPO
learner per policy, each on the learner device (the card unless the
caller passes ``device="cpu"``); rollouts collect per-policy trajectories
on CPU actors (a ``TorchPolicy`` per policy id, on the CPU) and GAE them
per agent before shipping.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

import torch

import ray_tpu_torch
from ray_tpu_torch._device import resolve_device

from . import sample_batch as SB
from .sample_batch import SampleBatch, compute_gae, concat_samples


class MultiAgentEnv:
    """All step/reset dicts are keyed by agent id. "__all__" in dones
    ends the episode (reference semantics)."""

    agent_ids: Tuple[str, ...]
    observation_dim: int
    num_actions: int
    max_episode_steps: int = 500

    def reset(self, seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def step(self, actions: Dict[str, int]
             ) -> Tuple[Dict[str, np.ndarray], Dict[str, float],
                        Dict[str, bool], dict]:
        raise NotImplementedError


class MultiAgentBatch:
    """policy_id -> SampleBatch, plus the env-step count the batches were
    collected over (ref: sample_batch.py:1322)."""

    def __init__(self, policy_batches: Dict[str, SampleBatch],
                 env_steps: int):
        self.policy_batches = policy_batches
        self.env_steps = env_steps

    def __getitem__(self, policy_id: str) -> SampleBatch:
        return self.policy_batches[policy_id]

    @property
    def agent_steps(self) -> int:
        return sum(b.count for b in self.policy_batches.values())

    @staticmethod
    def concat(batches: List["MultiAgentBatch"]) -> "MultiAgentBatch":
        pids = {p for b in batches for p in b.policy_batches}
        merged = {
            pid: concat_samples([b.policy_batches[pid] for b in batches
                                 if pid in b.policy_batches])
            for pid in pids
        }
        return MultiAgentBatch(merged, sum(b.env_steps for b in batches))


class MultiAgentRolloutWorker:
    """Steps ONE multi-agent env; each agent acts with its mapped
    policy's weights; per-agent trajectories are GAE-postprocessed and
    grouped by policy (ref: rollout_worker sample + policy_map). Its
    policies run on the CPU, torch held to one intra-op thread (its
    one-CPU lease)."""

    def __init__(self, env_creator, policy_ids: List[str],
                 policy_mapping_fn: Callable[[str], str],
                 rollout_len: int, gamma: float, lam: float,
                 hiddens=(64, 64), seed: int = 0):
        from .policy import TorchPolicy

        torch.set_num_threads(1)
        self.env: MultiAgentEnv = env_creator()
        self.policy_ids = list(policy_ids)
        self.mapping = policy_mapping_fn
        self.rollout_len = rollout_len
        self.gamma, self.lam = gamma, lam
        self.policies = {
            pid: TorchPolicy(self.env.observation_dim,
                             self.env.num_actions, hiddens, seed=seed + i,
                             device="cpu")
            for i, pid in enumerate(self.policy_ids)
        }
        self._obs = self.env.reset(seed)
        self._ep_rewards: Dict[str, float] = {}
        self.completed_returns: List[float] = []

    def sample(self) -> MultiAgentBatch:
        # per-agent trajectory columns, grouped later by policy
        traj: Dict[str, Dict[str, list]] = {
            a: {k: [] for k in ("obs", "act", "rew", "done", "logp", "vf")}
            for a in self.env.agent_ids
        }
        for _ in range(self.rollout_len):
            actions: Dict[str, int] = {}
            for agent, obs in self._obs.items():
                pol = self.policies[self.mapping(agent)]
                a, logp, vf, _ = pol.compute_actions(obs[None, :])
                actions[agent] = int(a[0])
                t = traj[agent]
                t["obs"].append(obs)
                t["act"].append(int(a[0]))
                t["logp"].append(float(logp[0]))
                t["vf"].append(float(vf[0]))
            next_obs, rewards, dones, _ = self.env.step(actions)
            for agent in actions:
                traj[agent]["rew"].append(rewards.get(agent, 0.0))
                traj[agent]["done"].append(bool(dones.get(
                    agent, dones.get("__all__", False))))
                self._ep_rewards[agent] = self._ep_rewards.get(
                    agent, 0.0) + rewards.get(agent, 0.0)
            if dones.get("__all__"):
                self.completed_returns.append(
                    sum(self._ep_rewards.values()))
                self._ep_rewards.clear()
                next_obs = self.env.reset()
            self._obs = next_obs

        by_policy: Dict[str, List[SampleBatch]] = {}
        steps = 0
        for agent, t in traj.items():
            if not t["obs"]:
                continue
            steps = max(steps, len(t["obs"]))
            pol = self.policies[self.mapping(agent)]
            obs = np.asarray(t["obs"], np.float32)
            rew = np.asarray(t["rew"], np.float32)[:, None]
            vf = np.asarray(t["vf"], np.float32)[:, None]
            done = np.asarray(t["done"], np.bool_)[:, None]
            last_v = pol.value(self._obs[agent][None, :]) \
                if agent in self._obs else np.zeros(1, np.float32)
            adv, targets = compute_gae(rew, vf, done, last_v,
                                       self.gamma, self.lam)
            by_policy.setdefault(self.mapping(agent), []).append(
                SampleBatch({
                    SB.OBS: obs,
                    SB.ACTIONS: np.asarray(t["act"], np.int64),
                    SB.REWARDS: rew[:, 0],
                    SB.DONES: done[:, 0],
                    SB.ACTION_LOGP: np.asarray(t["logp"], np.float32),
                    SB.VF_PREDS: vf[:, 0],
                    SB.ADVANTAGES: adv[:, 0],
                    SB.VALUE_TARGETS: targets[:, 0],
                }))
        return MultiAgentBatch(
            {pid: concat_samples(bs) for pid, bs in by_policy.items()},
            env_steps=steps)

    def set_weights(self, weights: Dict[str, dict]):
        for pid, w in weights.items():
            self.policies[pid].set_weights(w)

    def episode_metrics(self) -> dict:
        rets, self.completed_returns = self.completed_returns, []
        return {"episode_returns": rets}


class MultiAgentPPO:
    """One PPO learner per policy; each training step samples from the
    rollout actors and updates every policy with ITS agents' experience
    (ref: algorithms/ppo with config.multi_agent(policies=...,
    policy_mapping_fn=...)). The learners live on ``device``: the card
    unless the caller passes ``device="cpu"``; without a card that raises
    before any worker starts."""

    def __init__(self, env_creator, *, policies: List[str],
                 policy_mapping_fn: Callable[[str], str],
                 num_rollout_workers: int = 2, rollout_len: int = 128,
                 gamma: float = 0.99, lam: float = 0.95, lr: float = 3e-4,
                 hiddens=(64, 64), seed: int = 0, sgd_minibatch: int = 128,
                 num_epochs: int = 4, device=None):
        from .learner import PPOLearner

        self.device = resolve_device(device)
        probe = env_creator()
        self.policy_ids = list(policies)
        self.learners = {
            pid: PPOLearner(probe.observation_dim, probe.num_actions,
                            lr=lr, hiddens=hiddens, seed=seed + i,
                            device=self.device)
            for i, pid in enumerate(self.policy_ids)
        }
        worker_cls = ray_tpu_torch.remote(MultiAgentRolloutWorker)
        self.workers = [
            worker_cls.options(num_cpus=1).remote(
                env_creator, self.policy_ids, policy_mapping_fn,
                rollout_len, gamma, lam, hiddens, seed=seed + 100 * i)
            for i in range(num_rollout_workers)
        ]
        self._minibatch = sgd_minibatch
        self._epochs = num_epochs
        self._episode_returns: List[float] = []
        self.num_env_steps = 0
        self._sync_weights()

    def _sync_weights(self):
        w_ref = ray_tpu_torch.put({pid: ln.get_weights()
                             for pid, ln in self.learners.items()})
        ray_tpu_torch.get([w.set_weights.remote(w_ref)
                           for w in self.workers], timeout=300)

    def train(self) -> dict:
        batches = ray_tpu_torch.get(
            [w.sample.remote() for w in self.workers], timeout=300)
        ma = MultiAgentBatch.concat(batches)
        self.num_env_steps += ma.env_steps  # concat already summed
        metrics: dict = {"env_steps": self.num_env_steps}
        for pid, batch in ma.policy_batches.items():
            out = self.learners[pid].update(
                batch, num_epochs=self._epochs,
                minibatch_size=min(self._minibatch, batch.count))
            metrics[f"{pid}/loss"] = out.get("loss")
        self._sync_weights()
        for m in ray_tpu_torch.get([w.episode_metrics.remote()
                              for w in self.workers], timeout=300):
            self._episode_returns.extend(m["episode_returns"])
        if self._episode_returns:
            metrics["episode_reward_mean"] = float(
                np.mean(self._episode_returns[-50:]))
        return metrics

    def get_weights(self) -> Dict[str, dict]:
        return {pid: ln.get_weights() for pid, ln in self.learners.items()}

    def cleanup(self):
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:  # noqa: BLE001
                pass
