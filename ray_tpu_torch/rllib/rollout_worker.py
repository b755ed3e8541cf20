"""RolloutWorker: CPU actor that steps a VectorEnv and emits SampleBatches.

Ref analog: rllib/evaluation/rollout_worker.py:159 (sample :660) — the
split the reference keeps: rollouts stay on host CPUs as plain actors
(each leases one CPU), with their policy on ``device="cpu"``; only the
learner touches the card. GAE postprocessing runs here so learners
receive ready-to-optimize batches (ref: evaluation/postprocessing.py).

A worker holds torch to one intra-op thread, its one-CPU lease: torch's
default of a thread per core in every worker starves the other actors on
the host.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import sample_batch as SB
from .connectors import ConnectorPipeline
from .env import VectorEnv
from .policy import SquashedGaussianPolicy, TorchPolicy
from .sample_batch import SampleBatch, compute_gae


def _collect_transitions(vec: VectorEnv, rollout_len: int, select_actions,
                         act_shape: tuple, act_dtype,
                         conn: ConnectorPipeline) -> SampleBatch:
    """Shared (s, a, r, s', terminated) collection loop for the
    off-policy paths (DQN's epsilon-greedy and SAC's squashed-Gaussian
    workers differ only in action selection).

    Stores the PRE-reset terminal observation as NEXT_OBS and masks
    DONES to TERMINATED only — a time-limit truncation must still
    bootstrap, or the Bellman target regresses boundary transitions
    toward r alone (the classic timeout-bootstrap bug).
    """
    T, N = rollout_len, vec.num_envs
    D = conn.observation_dim(vec.observation_dim)
    obs_buf = np.zeros((T, N, D), np.float32)
    next_buf = np.zeros((T, N, D), np.float32)
    act_buf = np.zeros((T, N) + act_shape, act_dtype)
    rew_buf = np.zeros((T, N), np.float32)
    done_buf = np.zeros((T, N), np.bool_)

    obs = conn.transform_obs(vec.obs)
    for t in range(T):
        actions = select_actions(obs)
        obs_buf[t] = obs
        act_buf[t] = actions
        _, rewards, dones = vec.step(conn.transform_action(actions))
        # s' is an auxiliary view of (mostly) the same observations the
        # next iteration records — transform it with stats frozen so
        # running normalizers count each observation once
        conn.set_frozen(True)
        next_buf[t] = conn.transform_obs(vec.final_obs)
        conn.set_frozen(False)
        obs = conn.transform_obs(vec.obs)
        rew_buf[t] = rewards
        done_buf[t] = dones & ~vec.truncateds

    flat = lambda x: x.reshape((T * N,) + x.shape[2:])  # noqa: E731
    return SampleBatch({
        SB.OBS: flat(obs_buf),
        SB.ACTIONS: flat(act_buf),
        SB.REWARDS: flat(rew_buf),
        SB.DONES: flat(done_buf),
        SB.NEXT_OBS: flat(next_buf),
    })


class RolloutWorker:
    def __init__(self, env_creator, num_envs: int, rollout_len: int,
                 gamma: float, lam: float, hiddens=(64, 64),
                 seed: int = 0, worker_idx: int = 0, connectors=None):
        torch.set_num_threads(1)
        self.vec = VectorEnv(env_creator, num_envs, seed=seed * 1000 + 17)
        # env <-> policy coupling goes through the connector pipeline
        # (ref: connectors/agent/pipeline.py); a factory arrives here so
        # every worker owns its own (stateful) instance
        self.conn = connectors() if callable(connectors) else \
            (connectors or ConnectorPipeline())
        self.obs_dim = self.conn.observation_dim(self.vec.observation_dim)
        self.policy = TorchPolicy(self.obs_dim,
                                  self.vec.num_actions, hiddens,
                                  seed=seed, device="cpu")
        self.rollout_len = rollout_len
        self.gamma = gamma
        self.lam = lam
        self.worker_idx = worker_idx
        self._eps_seq = 0  # decorrelates sample_transitions RNG per call

    def sample(self) -> SampleBatch:
        """Collect one rollout of [T, N] and flatten to [T*N] with GAE."""
        T, N = self.rollout_len, self.vec.num_envs
        obs_buf = np.zeros((T, N, self.obs_dim), np.float32)
        act_buf = np.zeros((T, N), np.int64)
        rew_buf = np.zeros((T, N), np.float32)
        done_buf = np.zeros((T, N), np.bool_)
        logp_buf = np.zeros((T, N), np.float32)
        vf_buf = np.zeros((T, N), np.float32)
        logits_buf = np.zeros((T, N, self.vec.num_actions), np.float32)

        obs = self.conn.transform_obs(self.vec.obs)
        for t in range(T):
            actions, logp, vf, logits = self.policy.compute_actions(obs)
            obs_buf[t] = obs
            act_buf[t] = actions
            logp_buf[t] = logp
            vf_buf[t] = vf
            logits_buf[t] = logits
            _, rewards, dones = self.vec.step(
                self.conn.transform_action(actions))
            obs = self.conn.transform_obs(self.vec.obs)
            rew_buf[t] = rewards
            done_buf[t] = dones

        last_value = self.policy.value(obs)
        adv, targets = compute_gae(rew_buf, vf_buf, done_buf, last_value,
                                   self.gamma, self.lam)
        flat = lambda x: x.reshape((T * N,) + x.shape[2:])  # noqa: E731
        return SampleBatch({
            SB.OBS: flat(obs_buf),
            SB.ACTIONS: flat(act_buf),
            SB.REWARDS: flat(rew_buf),
            SB.DONES: flat(done_buf),
            SB.ACTION_LOGP: flat(logp_buf),
            SB.VF_PREDS: flat(vf_buf),
            SB.BEHAVIOUR_LOGITS: flat(logits_buf),
            SB.ADVANTAGES: flat(adv),
            SB.VALUE_TARGETS: flat(targets),
        })

    def sample_time_major(self) -> SampleBatch:
        """[T, N]-shaped batch (IMPALA/V-trace needs the time axis)."""
        T, N = self.rollout_len, self.vec.num_envs
        obs_buf = np.zeros((T, N, self.obs_dim), np.float32)
        act_buf = np.zeros((T, N), np.int64)
        rew_buf = np.zeros((T, N), np.float32)
        done_buf = np.zeros((T, N), np.bool_)
        logp_buf = np.zeros((T, N), np.float32)

        obs = self.conn.transform_obs(self.vec.obs)
        for t in range(T):
            actions, logp, _, _ = self.policy.compute_actions(obs)
            obs_buf[t] = obs
            act_buf[t] = actions
            logp_buf[t] = logp
            _, rewards, dones = self.vec.step(
                self.conn.transform_action(actions))
            obs = self.conn.transform_obs(self.vec.obs)
            rew_buf[t] = rewards
            done_buf[t] = dones

        return SampleBatch({
            SB.OBS: obs_buf,
            SB.ACTIONS: act_buf,
            SB.REWARDS: rew_buf,
            SB.DONES: done_buf,
            SB.ACTION_LOGP: logp_buf,
            "bootstrap_obs": obs.copy(),
        })

    def sample_transitions(self, epsilon: float = 0.0) -> SampleBatch:
        """(s, a, r, s', done) tuples with epsilon-greedy exploration —
        the off-policy (DQN) collection path (ref: rollout_worker sample
        with EpsilonGreedy exploration, utils/exploration/epsilon_greedy
        .py). The policy's logits head is read as Q-values."""
        N = self.vec.num_envs
        rng = np.random.default_rng(
            int(epsilon * 1e6) + self.worker_idx * 7919 + self._eps_seq)
        self._eps_seq += 1

        def select(obs):
            actions, _ = self.policy.greedy(obs)
            explore = rng.random(N) < epsilon
            actions[explore] = rng.integers(
                0, self.vec.num_actions, size=int(explore.sum()))
            return actions

        return _collect_transitions(self.vec, self.rollout_len, select,
                                    (), np.int64, self.conn)

    # ---- weight sync / metrics ----

    def set_weights(self, weights: Dict[str, np.ndarray]):
        self.policy.set_weights(weights)

    def get_weights(self) -> Dict[str, np.ndarray]:
        return self.policy.get_weights()

    def episode_metrics(self) -> dict:
        rets, lens = self.vec.pop_episode_metrics()
        return {"episode_returns": rets, "episode_lengths": lens}

    def ping(self) -> bool:
        return True


class ContinuousRolloutWorker:
    """Rollout actor for continuous-action envs (the SAC collection path).

    Same contract as RolloutWorker.sample_transitions, but actions come
    from a SquashedGaussianPolicy; ``epsilon`` is the probability of a
    uniform-random action (warmup exploration before learning starts,
    ref analog: SACConfig num_steps_sampled_before_learning_starts +
    random exploration).
    """

    def __init__(self, env_creator, num_envs: int, rollout_len: int,
                 gamma: float, lam: float, hiddens=(64, 64),
                 seed: int = 0, worker_idx: int = 0, connectors=None):
        torch.set_num_threads(1)
        self.vec = VectorEnv(env_creator, num_envs, seed=seed * 1000 + 17)
        assert self.vec.continuous, "use RolloutWorker for discrete envs"
        self.conn = connectors() if callable(connectors) else \
            (connectors or ConnectorPipeline())
        self._env_creator = env_creator
        env0 = self.vec.envs[0]
        self.policy = SquashedGaussianPolicy(
            self.conn.observation_dim(self.vec.observation_dim),
            self.vec.action_dim,
            action_scale=(env0.action_high - env0.action_low) / 2.0,
            action_shift=(env0.action_high + env0.action_low) / 2.0,
            hiddens=hiddens, seed=seed, device="cpu")
        self.rollout_len = rollout_len
        self.worker_idx = worker_idx
        self._rng = np.random.default_rng(seed * 7919 + 23)

    def sample_transitions(self, epsilon: float = 0.0) -> SampleBatch:
        N, A = self.vec.num_envs, self.vec.action_dim
        env0 = self.vec.envs[0]
        lo, hi = env0.action_low, env0.action_high

        def select(obs):
            if epsilon >= 1.0:  # pure warmup: skip the policy forward
                return self._rng.uniform(
                    lo, hi, size=(N, A)).astype(np.float32)
            actions, _ = self.policy.compute_actions(obs)
            if epsilon > 0.0:
                rand = self._rng.random(N) < epsilon
                if rand.any():
                    actions[rand] = self._rng.uniform(
                        lo, hi,
                        size=(int(rand.sum()), A)).astype(np.float32)
            return actions

        return _collect_transitions(self.vec, self.rollout_len, select,
                                    (A,), np.float32, self.conn)

    def evaluate(self, num_episodes: int = 5, seed: int = 0) -> dict:
        """Deterministic (mean-action) eval on a fresh env from the SAME
        creator the rollouts use (a configured creator must configure the
        eval env identically)."""
        from .env import make_env

        env = make_env(self._env_creator)
        returns = []
        self.conn.set_frozen(True)  # eval must not pollute running stats
        try:
            for ep in range(num_episodes):
                obs = env.reset(seed=10_000 + seed * 100 + ep)
                total, done = 0.0, False
                while not done:
                    pobs = self.conn.transform_obs(obs[None])
                    a, _ = self.policy.compute_actions(pobs, explore=False)
                    a = self.conn.transform_action(a)
                    obs, r, done, _ = env.step(a[0])
                    total += r
                returns.append(total)
        finally:
            self.conn.set_frozen(False)
        return {"mean_return": float(np.mean(returns)), "returns": returns}

    def set_weights(self, weights: Dict[str, np.ndarray]):
        self.policy.set_weights(weights)

    def get_weights(self) -> Dict[str, np.ndarray]:
        return self.policy.get_weights()

    def episode_metrics(self) -> dict:
        rets, lens = self.vec.pop_episode_metrics()
        return {"episode_returns": rets, "episode_lengths": lens}

    def ping(self) -> bool:
        return True
