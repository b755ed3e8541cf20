"""R2D2: recurrent-replay distributed DQN (Kapturowski et al. 2019).

Ref analog: rllib/algorithms/r2d2/r2d2.py (R2D2Config: model.use_lstm,
zero_init_states/burn-in knobs, replay_buffer_config with
storage_unit="sequences") and r2d2_torch_policy.py (burn-in unroll +
h-stored sequence replay). The whole sequence update — burn-in unroll
without grad, train-segment unroll, double Q-learning targets, Huber loss,
Adam — runs on the learner's device (the card unless the caller asks for
the CPU), its time dimension a Python loop over the GRU cell
(``catalog.gru_unroll``); the replay buffer hands it contiguous
[B, T, ...] numpy. Rollout workers are CPU actors that run the GRU on
the CPU.

Simplifications vs the paper, stated: 1-step targets (not n-step),
no distributed prioritization (ApexDQN covers the distributed-replay
axis here), stored-state strategy with in-sequence episode resets.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch._device import resolve_device

from .algorithm import Algorithm, AlgorithmConfig
from .catalog import gru_forward, gru_unroll, init_gru
from .connectors import ConnectorPipeline
from .env import VectorEnv
from .learner import adam, huber, take, value_and_grad
from .models import clone_tree, params_from_numpy, seeded, to_numpy


class R2D2Config(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or R2D2)
        self.lr = 1e-3
        self.train_batch_size = 32        # sequences per update
        self.seq_len = 16                 # trained timesteps per sequence
        self.burn_in = 4                  # unrolled-not-trained prefix
        self.replay_buffer_capacity = 4000   # sequences
        self.num_steps_sampled_before_learning_starts = 1000
        self.target_network_update_freq = 1000  # env steps
        self.epsilon_initial = 1.0
        self.epsilon_final = 0.02
        self.epsilon_timesteps = 10_000
        self.num_updates_per_iter = 16
        self.gru_hidden = 64


class SequenceReplay:
    """Uniform replay over fixed-length sequences.

    Each entry: obs [T, D], actions/rewards/dones [T], reset [T] (True
    where a new episode begins at that step), h0 [H] (the recurrent
    state STORED at collection time, the paper's stored-state strategy).
    """

    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = int(capacity)
        self._data: List[dict] = []
        self._next = 0
        self.num_added = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self._data)

    def add(self, seqs: List[dict]):
        for s in seqs:
            if len(self._data) < self.capacity:
                self._data.append(s)
            else:
                self._data[self._next] = s
                self._next = (self._next + 1) % self.capacity
            self.num_added += 1

    def sample(self, n: int) -> Optional[Dict[str, np.ndarray]]:
        if not self._data:
            return None
        idx = self._rng.integers(0, len(self._data), n)
        keys = self._data[0].keys()
        return {k: np.stack([self._data[i][k] for i in idx])
                for k in keys}


def _q_seq(params, obs, reset, h0):
    """[B, T, ...] -> the time-major unroll -> Q [B, T, A]."""
    logits, _, _ = gru_unroll(params, obs.transpose(0, 1), h0,
                              reset.transpose(0, 1))
    return logits.transpose(0, 1)


class R2D2Learner:
    """Online + target recurrent Q-nets on one device; one sequence
    update a call."""

    columns = ("obs", "actions", "rewards", "dones", "reset", "h0")

    def __init__(self, obs_dim: int, num_actions: int, *, lr: float,
                 gamma: float, burn_in: int, hidden: int = 64,
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.params = init_gru(seeded(seed), obs_dim, num_actions, hidden,
                               device=self.device)
        self.target_params = clone_tree(self.params)
        self.tx = adam(lr)
        self.opt_state = self.tx.init(self.params)
        self.gamma, self.burn_in = gamma, burn_in

    def loss_fn(self, params, target_params, batch):
        burn_in, gamma = self.burn_in, self.gamma
        obs, reset, h0 = batch["obs"], batch["reset"], batch["h0"]
        if burn_in:
            # burn-in: warm the carry without training through it
            with torch.no_grad():
                _, _, h_live = gru_unroll(
                    params, obs[:, :burn_in].transpose(0, 1), h0,
                    reset[:, :burn_in].transpose(0, 1))
                _, _, h_tgt = gru_unroll(
                    target_params, obs[:, :burn_in].transpose(0, 1), h0,
                    reset[:, :burn_in].transpose(0, 1))
            obs = obs[:, burn_in:]
            reset = reset[:, burn_in:]
        else:
            h_live = h_tgt = h0
        acts = batch["actions"][:, burn_in:]
        rews = batch["rewards"][:, burn_in:]
        dones = batch["dones"][:, burn_in:].to(torch.float32)
        q_all = _q_seq(params, obs, reset, h_live)       # [B, T, A]
        q_sel = take(q_all[:, :-1], acts[:, :-1])
        with torch.no_grad():
            q_tgt = _q_seq(target_params, obs, reset, h_tgt)
            # double-Q: online argmax at t+1 (the first maximum, as
            # jnp.argmax), target net's value
            a_star = torch.argmax(q_all[:, 1:], dim=2)
            q_next = take(q_tgt[:, 1:], a_star)
            # a step that ENDS its episode bootstraps nothing; a reset at
            # t+1 means q_next belongs to a different episode — mask both
            valid_next = 1.0 - torch.maximum(
                dones[:, :-1], reset[:, 1:].to(torch.float32))
            target = rews[:, :-1] + gamma * valid_next * q_next
        return huber(q_sel - target).mean(), None

    def train_step(self, batch) -> tuple:
        """One Adam step on ``batch`` (tensors on the device) ->
        (loss, grads)."""
        loss, _, grads = value_and_grad(self.loss_fn, self.params,
                                        self.target_params, batch)
        self.tx.step_(grads, self.opt_state, self.params)
        return loss, grads

    def _batch(self, batch) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(batch[k]), device=self.device)
                for k in self.columns}

    def update(self, batch: Dict[str, np.ndarray]) -> dict:
        loss, _ = self.train_step(self._batch(batch))
        return {"loss": float(loss)}

    def sync_target(self):
        self.target_params = clone_tree(self.params)

    @property
    def local(self) -> "R2D2Learner":
        """Itself: R2D2 puts its one learner where Algorithm keeps its
        learner group, whose ``local`` is the learner."""
        return self

    def get_weights(self) -> Dict[str, np.ndarray]:
        return to_numpy(self.params)

    def set_weights(self, weights):
        self.params = params_from_numpy(weights, self.device)
        self.sync_target()


class R2D2RolloutWorker:
    """Steps a VectorEnv with the recurrent policy on the CPU (carry
    persists across calls, clears on episode end) and emits stored-state
    training sequences of seq_len + burn_in steps. Holds torch to one
    intra-op thread, its one-CPU lease."""

    def __init__(self, env_creator, num_envs: int, seq_len: int,
                 burn_in: int, hidden: int = 64, seed: int = 0,
                 worker_idx: int = 0, connectors=None):
        torch.set_num_threads(1)
        self.vec = VectorEnv(env_creator, num_envs, seed=seed * 1000 + 17)
        self.conn = connectors() if callable(connectors) else \
            (connectors or ConnectorPipeline())
        self.obs_dim = self.conn.observation_dim(self.vec.observation_dim)
        self.seq_len = seq_len
        self.burn_in = burn_in
        self.hidden = hidden
        self.params = init_gru(seeded(seed), self.obs_dim,
                               self.vec.num_actions, hidden, device="cpu")
        self._h = np.zeros((num_envs, hidden), np.float32)
        self._rng = np.random.default_rng(seed * 7919 + 29)
        self._episode_returns: List[float] = []
        self._ep_ret = np.zeros(num_envs, np.float32)

    @torch.no_grad()
    def sample_sequences(self, epsilon: float) -> List[dict]:
        """Collect T = burn_in + seq_len steps and cut one sequence per
        env, h0 = the carry at collection start."""
        T, N = self.burn_in + self.seq_len, self.vec.num_envs
        D = self.obs_dim
        h0 = self._h.copy()
        obs_buf = np.zeros((N, T, D), np.float32)
        act_buf = np.zeros((N, T), np.int64)
        rew_buf = np.zeros((N, T), np.float32)
        done_buf = np.zeros((N, T), np.bool_)
        reset_buf = np.zeros((N, T), np.bool_)

        obs = self.conn.transform_obs(self.vec.obs)
        for t in range(T):
            q, _v, h_new = gru_forward(
                self.params, torch.as_tensor(np.asarray(obs, np.float32)),
                torch.from_numpy(self._h))
            acts = torch.argmax(q, dim=-1).numpy()
            explore = self._rng.random(N) < epsilon
            acts = np.where(
                explore,
                self._rng.integers(0, self.vec.num_actions, N), acts)
            obs_buf[:, t] = obs
            act_buf[:, t] = acts
            _, rewards, dones = self.vec.step(
                self.conn.transform_action(acts))
            obs = self.conn.transform_obs(self.vec.obs)
            rew_buf[:, t] = rewards
            done_buf[:, t] = dones & ~self.vec.truncateds
            # a copy: a CPU tensor's .numpy() is a view, and the
            # episode-boundary clear below writes into the carry
            self._h = h_new.numpy().copy()
            self._ep_ret += rewards
            ended = dones | self.vec.truncateds
            if ended.any():
                # clear the carry at episode boundaries; mark the NEXT
                # step as a reset point inside the sequence
                self._h[ended] = 0.0
                if t + 1 < T:
                    reset_buf[ended, t + 1] = True
                for i in np.nonzero(ended)[0]:
                    self._episode_returns.append(float(self._ep_ret[i]))
                    self._ep_ret[i] = 0.0
        return [{"obs": obs_buf[i], "actions": act_buf[i],
                 "rewards": rew_buf[i], "dones": done_buf[i],
                 "reset": reset_buf[i], "h0": h0[i]}
                for i in range(N)]

    def set_weights(self, weights):
        self.params = params_from_numpy(weights, "cpu")

    def get_weights(self):
        return to_numpy(self.params)

    def episode_metrics(self) -> dict:
        out = {"episode_returns": self._episode_returns,
               "episode_lengths": []}
        self._episode_returns = []
        return out


class R2D2(Algorithm):
    _config_cls = R2D2Config

    def setup(self, config):
        cfg = config.get("__algo_config__")
        cfg = cfg.copy() if cfg is not None else self.get_default_config()
        cfg.update_from_dict(
            {k: v for k, v in config.items() if k != "__algo_config__"})
        self.algo_config = cfg
        # no card and no device="cpu": raise before any worker starts
        resolve_device(cfg.device)
        worker_cls = ray_tpu_torch.remote(R2D2RolloutWorker)
        self.workers = [
            worker_cls.options(num_cpus=1).remote(
                cfg.env, cfg.num_envs_per_worker, cfg.seq_len,
                cfg.burn_in, hidden=cfg.gru_hidden, seed=cfg.seed + i,
                worker_idx=i, connectors=cfg.connectors)
            for i in range(cfg.num_rollout_workers)]
        probe = self._make_probe_env()
        obs_dim = probe.observation_dim
        if cfg.connectors is not None:
            pipe = cfg.connectors() if callable(cfg.connectors) \
                else cfg.connectors
            obs_dim = pipe.observation_dim(obs_dim)
        self.learner = R2D2Learner(
            obs_dim, probe.num_actions, lr=cfg.lr, gamma=cfg.gamma,
            burn_in=cfg.burn_in, hidden=cfg.gru_hidden, seed=cfg.seed,
            device=cfg.device)
        # base-class cleanup()/step() look at self.learners; the single
        # local recurrent learner fills that slot
        self.learners = self.learner
        self.replay = SequenceReplay(cfg.replay_buffer_capacity,
                                     seed=cfg.seed)
        self._episode_returns = collections.deque(maxlen=50)
        self._num_env_steps = 0
        self._last_target_sync = 0
        self._sync_weights()

    def _sync_weights(self):
        w_ref = ray_tpu_torch.put(self.learner.get_weights())
        ray_tpu_torch.get([w.set_weights.remote(w_ref)
                           for w in self.workers], timeout=300)

    def _epsilon(self) -> float:
        cfg = self.algo_config
        frac = min(1.0, self._num_env_steps / max(cfg.epsilon_timesteps, 1))
        return cfg.epsilon_initial + frac * (cfg.epsilon_final
                                             - cfg.epsilon_initial)

    def training_step(self) -> dict:
        cfg = self.algo_config
        eps = self._epsilon()
        seq_lists = ray_tpu_torch.get(
            [w.sample_sequences.remote(eps) for w in self.workers],
            timeout=300)
        n_steps = 0
        for seqs in seq_lists:
            self.replay.add(seqs)
            n_steps += sum(len(s["actions"]) for s in seqs)
        self._num_env_steps += n_steps
        metrics = {"env_steps_this_iter": n_steps, "epsilon": eps,
                   "replay_sequences": len(self.replay)}
        if self._num_env_steps >= \
                cfg.num_steps_sampled_before_learning_starts:
            losses = []
            for _ in range(cfg.num_updates_per_iter):
                batch = self.replay.sample(cfg.train_batch_size)
                if batch is None:
                    break
                losses.append(self.learner.update(batch)["loss"])
            if losses:
                metrics["loss"] = float(np.mean(losses))
            if self._num_env_steps - self._last_target_sync >= \
                    cfg.target_network_update_freq:
                self.learner.sync_target()
                self._last_target_sync = self._num_env_steps
            self._sync_weights()
        return metrics

    def save_checkpoint(self):
        return {"weights": self.learner.get_weights(),
                "num_env_steps": self._num_env_steps}

    def load_checkpoint(self, checkpoint):
        if checkpoint:
            self.learner.set_weights(checkpoint["weights"])
            self._num_env_steps = checkpoint.get("num_env_steps", 0)
            self._sync_weights()

    def get_policy_weights(self) -> dict:
        return self.learner.get_weights()
