"""Offline RL: logged-experience datasets, behavior cloning, discrete CQL.

Ref analogs: rllib/offline/ (JsonWriter/JsonReader over logged
SampleBatches, `input_="dataset"` configs) and the offline algorithms
(rllib/algorithms/bc, rllib/algorithms/cql). Datasets are .npz shards of
column arrays (numpy-native; the JAX package reads and writes the same
files); each learner's update runs on the learner's device (the card
unless the config asks for the CPU); evaluation runs the greedy policy in
a fresh env on the driver, on the CPU as a rollout worker would (no
rollout fleet — offline algorithms never sample).

CQL here is the discrete-action form: the DQN double-Q TD loss plus the
conservative penalty alpha * E[logsumexp_a Q(s,a) - Q(s, a_data)]
(Kumar et al. 2020, eq. 4 with the sampled-action term collapsed to the
closed discrete form).
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device

from . import sample_batch as SB
from .algorithm import Algorithm, AlgorithmConfig
from .env import VectorEnv, make_env
from .learner import adam, huber, take, value_and_grad
from .models import (clone_tree, entropy_of, forward, init_actor_critic,
                     logp_of, params_from_numpy, seeded, to_numpy)
from .sample_batch import SampleBatch, concat_samples

# ---------------------------------------------------------------- dataset IO


def save_batches(path: str, batches: List[SampleBatch]) -> List[str]:
    """Write SampleBatches as .npz shards under ``path``; returns files.

    Ref analog: rllib/offline/json_writer.py (one file per batch; columns
    keyed exactly as SampleBatch keys)."""
    os.makedirs(path, exist_ok=True)
    files = []
    for i, b in enumerate(batches):
        f = os.path.join(path, f"batch-{i:05d}.npz")
        np.savez_compressed(f, **{k: np.asarray(v) for k, v in b.items()})
        files.append(f)
    return files


def load_batches(path: str) -> SampleBatch:
    """Read every shard under ``path`` into one concatenated SampleBatch
    (ref: rllib/offline/json_reader.py)."""
    files = sorted(glob.glob(os.path.join(path, "*.npz")))
    if not files:
        raise FileNotFoundError(f"no .npz shards under {path}")
    batches = []
    for f in files:
        with np.load(f) as z:
            batches.append(SampleBatch({k: z[k] for k in z.files}))
    return concat_samples(batches)


@torch.no_grad()
def _greedy(params, obs: np.ndarray) -> np.ndarray:
    """argmax of the policy head for a [B, D] numpy batch, on the CPU."""
    logits, _ = forward(params, torch.as_tensor(np.asarray(obs,
                                                           np.float32)))
    return torch.argmax(logits, dim=-1).numpy()


def collect_dataset(env_name, path: str, *, num_steps: int = 4096,
                    num_envs: int = 8, epsilon: float = 0.3,
                    weights: Optional[Dict[str, np.ndarray]] = None,
                    hiddens=(64, 64), seed: int = 0) -> List[str]:
    """Roll an epsilon-greedy behavior policy (its forward on the CPU)
    and log (s, a, r, s', done) shards — the offline-RL data-generation
    step (ref: the reference's `rllib train ... --output` logged-experience
    path). Without ``weights`` the policy is ``init_actor_critic`` from
    ``seed``."""
    vec = VectorEnv(env_name, num_envs, seed=seed)
    params = (params_from_numpy(weights, "cpu") if weights is not None
              else init_actor_critic(seeded(seed), vec.observation_dim,
                                     vec.num_actions, hiddens, "cpu"))
    rng = np.random.default_rng(seed)
    T = num_steps // num_envs
    obs_buf = np.zeros((T, num_envs, vec.observation_dim), np.float32)
    act_buf = np.zeros((T, num_envs), np.int64)
    rew_buf = np.zeros((T, num_envs), np.float32)
    done_buf = np.zeros((T, num_envs), np.bool_)
    next_buf = np.zeros((T, num_envs, vec.observation_dim), np.float32)
    obs = vec.obs
    for t in range(T):
        acts = _greedy(params, obs)
        explore = rng.random(num_envs) < epsilon
        acts = np.where(explore,
                        rng.integers(0, vec.num_actions, num_envs), acts)
        obs_buf[t] = obs
        act_buf[t] = acts
        obs, rews, dones = vec.step(acts)
        next_buf[t] = vec.final_obs
        rew_buf[t] = rews
        done_buf[t] = dones & ~vec.truncateds
    flat = lambda x: x.reshape((T * num_envs,) + x.shape[2:])  # noqa: E731
    batch = SampleBatch({SB.OBS: flat(obs_buf), SB.ACTIONS: flat(act_buf),
                         SB.REWARDS: flat(rew_buf),
                         SB.DONES: flat(done_buf),
                         SB.NEXT_OBS: flat(next_buf)})
    return save_batches(path, [batch])


# ------------------------------------------------------------- algorithms


class OfflineConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class)
        self.input_path = ""          # directory of .npz shards
        self.train_batch_size = 256
        self.num_updates_per_iter = 64
        self.evaluation_episodes = 3


class _OfflineAlgorithm(Algorithm):
    """Shared shape: load the dataset once, minibatch-update per step on
    the learner's device, evaluate greedily in a fresh env on the CPU.

    A subclass gives ``columns`` (what its loss reads), ``loss_fn(params,
    batch, *extra)`` and, if its step carries more than params and Adam
    state, ``train_step``."""

    _config_cls = OfflineConfig
    columns = (SB.OBS, SB.ACTIONS, SB.REWARDS, SB.DONES, SB.NEXT_OBS)

    def setup(self, config):
        cfg = config.get("__algo_config__")
        cfg = cfg.copy() if cfg is not None else self.get_default_config()
        cfg.update_from_dict(
            {k: v for k, v in config.items() if k != "__algo_config__"})
        self.algo_config = cfg
        self.device = resolve_device(cfg.device)
        if not cfg.input_path:
            raise ValueError(
                "offline algorithms need config.offline_data(input_path=...)")
        self.dataset = load_batches(cfg.input_path)
        probe = make_env(cfg.env)
        self._obs_dim = probe.observation_dim
        self._num_actions = probe.num_actions
        self._rng = np.random.default_rng(cfg.seed)
        self._num_env_steps = 0  # offline: no env interaction
        self.params = init_actor_critic(
            seeded(cfg.seed), self._obs_dim, self._num_actions,
            cfg.model_hiddens, self.device)
        self.tx = adam(cfg.lr)
        self.opt_state = self.tx.init(self.params)
        self._make_learner(cfg)

    def _make_learner(self, cfg):
        pass

    def _minibatch(self) -> SampleBatch:
        n = self.dataset.count
        idx = self._rng.integers(0, n, self.algo_config.train_batch_size)
        return SampleBatch({k: v[idx] for k, v in self.dataset.items()})

    def to_device(self, batch) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(batch[k]), device=self.device)
                for k in self.columns}

    def loss_fn(self, params, batch):
        raise NotImplementedError

    def train_step(self, batch) -> tuple:
        """One Adam step on ``batch`` (tensors on the device) ->
        (metrics with "total_loss", grads)."""
        loss, metrics, grads = value_and_grad(self.loss_fn, self.params,
                                              batch)
        self.tx.step_(grads, self.opt_state, self.params)
        metrics["total_loss"] = loss
        return metrics, grads

    def training_step(self) -> dict:
        metrics = {}
        for _ in range(self.algo_config.num_updates_per_iter):
            metrics, _ = self.train_step(self.to_device(self._minibatch()))
        return {k: float(v) for k, v in metrics.items()}

    def evaluate_policy(self) -> float:
        env = make_env(self.algo_config.env)
        rets = []
        w = params_from_numpy(self.get_policy_weights(), "cpu")
        for ep in range(self.algo_config.evaluation_episodes):
            obs = env.reset(seed=40_000 + self.iteration * 10 + ep)
            total, done = 0.0, False
            while not done:
                obs, r, done, _ = env.step(int(_greedy(w, obs[None])[0]))
                total += r
            rets.append(total)
        return float(np.mean(rets))

    def step(self) -> dict:
        metrics = self.training_step()
        metrics["episode_reward_mean"] = self.evaluate_policy()
        metrics["dataset_size"] = self.dataset.count
        return metrics

    def get_policy_weights(self):
        return to_numpy(self.params)

    def save_checkpoint(self):
        return {"weights": self.get_policy_weights()}

    def load_checkpoint(self, checkpoint):
        if checkpoint:
            self.params = params_from_numpy(checkpoint["weights"],
                                            self.device)

    def cleanup(self):
        pass


class BCConfig(OfflineConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or BC)

    def offline_data(self, *, input_path: str) -> "BCConfig":
        self.input_path = input_path
        return self


class BC(_OfflineAlgorithm):
    """Behavior cloning: maximize log pi(a_data | s) (ref:
    rllib/algorithms/bc/bc.py — MARWIL with beta=0)."""

    _config_cls = BCConfig
    columns = (SB.OBS, SB.ACTIONS)

    def loss_fn(self, params, batch):
        logits, _ = forward(params, batch[SB.OBS])
        logp = logp_of(logits, batch[SB.ACTIONS])
        ent = entropy_of(logits).mean()
        loss = -logp.mean() - self.algo_config.entropy_coeff * ent
        return loss, {"bc_logp": logp.mean(), "entropy": ent}


class CQLConfig(OfflineConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or CQL)
        self.cql_alpha = 1.0
        self.target_update_every = 8  # learner updates between target syncs
        self.lr = 3e-4

    def offline_data(self, *, input_path: str) -> "CQLConfig":
        self.input_path = input_path
        return self


class CQL(_OfflineAlgorithm):
    """Discrete conservative Q-learning: double-DQN TD loss on logged
    transitions + alpha * (logsumexp_a Q - Q(s, a_data))."""

    _config_cls = CQLConfig

    def _make_learner(self, cfg):
        self.target_params = clone_tree(self.params)
        self._updates = 0

    def loss_fn(self, params, batch):
        gamma, alpha = self.algo_config.gamma, self.algo_config.cql_alpha
        q_all, _ = forward(params, batch[SB.OBS])
        q_data = take(q_all, batch[SB.ACTIONS])
        with torch.no_grad():
            q_next_t, _ = forward(self.target_params, batch[SB.NEXT_OBS])
            q_next_o, _ = forward(params, batch[SB.NEXT_OBS])
            a_star = torch.argmax(q_next_o, dim=1)
            q_next = take(q_next_t, a_star)
            not_done = 1.0 - batch[SB.DONES].to(torch.float32)
            target = batch[SB.REWARDS] + gamma * not_done * q_next
        td = huber(q_data - target).mean()
        # conservative penalty: push down unseen actions' Q
        cql = (torch.logsumexp(q_all, dim=1) - q_data).mean()
        loss = td + alpha * cql
        return loss, {"td_loss": td, "cql_penalty": cql,
                      "q_data_mean": q_data.mean()}

    def training_step(self) -> dict:
        metrics = {}
        for _ in range(self.algo_config.num_updates_per_iter):
            metrics, _ = self.train_step(self.to_device(self._minibatch()))
            self._updates += 1
            if self._updates % self.algo_config.target_update_every == 0:
                self.target_params = clone_tree(self.params)
        return {k: float(v) for k, v in metrics.items()}

    def load_checkpoint(self, checkpoint):
        if checkpoint:
            super().load_checkpoint(checkpoint)
            self.target_params = clone_tree(self.params)


class MARWILConfig(OfflineConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or MARWIL)
        self.beta = 1.0            # 0 => exact BC (ref: marwil.py beta)
        self.vf_coeff = 1.0
        self.ma_adv_momentum = 1e-2  # moving-average advantage norm rate

    def offline_data(self, *, input_path: str) -> "MARWILConfig":
        self.input_path = input_path
        return self


class MARWIL(_OfflineAlgorithm):
    """Monotonic advantage re-weighted imitation learning (Wang et al.
    2018). Ref analog: rllib/algorithms/marwil/marwil.py — BC whose
    log-likelihood is weighted by exp(beta * normalized advantage), with
    a critic supplying the baseline. Advantages here are one-step TD
    residuals r + gamma*V(s') - V(s) against the jointly-trained value
    head (the logged .npz shards carry transitions, not whole episodes,
    so Monte-Carlo returns are not reconstructible), normalized by the
    reference's moving-average-of-squares estimate, which the step
    carries (``ma_adv_sq``, a 0-d tensor on the device).
    """

    _config_cls = MARWILConfig

    def _make_learner(self, cfg):
        # moving average of squared advantages: the exp() weight is
        # exp(beta * adv / sqrt(ma)) so beta stays scale-free
        self.ma_adv_sq = torch.ones((), device=self.device)

    def loss_fn(self, params, batch, ma_adv_sq):
        cfg = self.algo_config
        logits, values = forward(params, batch[SB.OBS])
        _, v_next = forward(params, batch[SB.NEXT_OBS])
        not_done = 1.0 - batch[SB.DONES].to(torch.float32)
        target = (batch[SB.REWARDS] + cfg.gamma * not_done * v_next
                  ).detach()
        adv = target - values
        vf_loss = torch.mean(adv ** 2)
        sg_adv = adv.detach()
        ma = ma_adv_sq + cfg.ma_adv_momentum * (
            torch.mean(sg_adv ** 2) - ma_adv_sq)
        w = torch.exp(torch.clamp(
            cfg.beta * sg_adv / torch.sqrt(ma + 1e-8), -10.0, 10.0))
        logp = logp_of(logits, batch[SB.ACTIONS])
        ent = entropy_of(logits).mean()
        policy_loss = -torch.mean(w * logp)
        loss = (policy_loss + cfg.vf_coeff * vf_loss
                - cfg.entropy_coeff * ent)
        return loss, ({"policy_loss": policy_loss, "vf_loss": vf_loss,
                       "adv_weight_mean": w.mean(), "entropy": ent}, ma)

    def train_step(self, batch) -> tuple:
        loss, (metrics, ma), grads = value_and_grad(
            self.loss_fn, self.params, batch, self.ma_adv_sq)
        self.tx.step_(grads, self.opt_state, self.params)
        self.ma_adv_sq = ma
        metrics["total_loss"] = loss
        return metrics, grads

    def save_checkpoint(self):
        return {"weights": self.get_policy_weights(),
                "ma_adv_sq": float(self.ma_adv_sq)}

    def load_checkpoint(self, checkpoint):
        if checkpoint:
            super().load_checkpoint(checkpoint)
            self.ma_adv_sq = torch.tensor(
                float(checkpoint.get("ma_adv_sq", 1.0)),
                device=self.device)
