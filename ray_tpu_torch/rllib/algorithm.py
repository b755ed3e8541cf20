"""Algorithm + AlgorithmConfig: the RLlib-equivalent driver layer.

Ref analogs: rllib/algorithms/algorithm.py:191 (Algorithm(Trainable),
setup :554, training_step :1402) and algorithm_config.py:118 (fluent
builder). Rollout workers are plain CPU actors; the learner is a local
PyTorch object (or a grad-averaging LearnerGroup) on ``device``: the card
unless the config asks for the CPU (``.resources(device="cpu")``). Run
under Tune, an algorithm whose learner is on the card takes
``resources_per_trial={"CPU": 1, "GPU": 1}``.
"""

from __future__ import annotations

import collections
import copy
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.tune.trainable import Trainable

from .learner import LearnerGroup
from .rollout_worker import RolloutWorker


class AlgorithmConfig:
    """Fluent config (subset of the reference's fields, same shapes)."""

    def __init__(self, algo_class=None):
        self.algo_class = algo_class
        self.env = "CartPole-v1"
        self.num_rollout_workers = 2
        self.num_envs_per_worker = 4
        self.rollout_fragment_length = 64
        self.gamma = 0.99
        self.lambda_ = 0.95
        self.lr = 3e-4
        self.train_batch_size = 512
        self.model_hiddens = (64, 64)
        self.seed = 0
        self.num_learners = 0
        # the learner's device: None is the card (raises without one)
        self.device = None
        self.entropy_coeff = 0.01
        self.vf_coeff = 0.5
        self.grad_clip = 0.5
        # zero-arg factory -> ConnectorPipeline; every rollout worker
        # builds its own stateful instance (ref:
        # connectors/agent/pipeline.py)
        self.connectors = None

    # ---- fluent sections (each returns self, ref: algorithm_config.py) ----

    def environment(self, env=None) -> "AlgorithmConfig":
        if env is not None:
            self.env = env
        return self

    def rollouts(self, *, num_rollout_workers: Optional[int] = None,
                 num_envs_per_worker: Optional[int] = None,
                 rollout_fragment_length: Optional[int] = None,
                 connectors=None) -> "AlgorithmConfig":
        if num_rollout_workers is not None:
            self.num_rollout_workers = num_rollout_workers
        if num_envs_per_worker is not None:
            self.num_envs_per_worker = num_envs_per_worker
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        if connectors is not None:
            self.connectors = connectors
        return self

    def training(self, **kwargs) -> "AlgorithmConfig":
        for key, val in kwargs.items():
            if not hasattr(self, key):
                raise TypeError(f"unknown training option {key!r}")
            setattr(self, key, val)
        return self

    def resources(self, *, num_learners: Optional[int] = None,
                  device=None) -> "AlgorithmConfig":
        if num_learners is not None:
            self.num_learners = num_learners
        if device is not None:
            self.device = device
        return self

    def debugging(self, *, seed: Optional[int] = None) -> "AlgorithmConfig":
        if seed is not None:
            self.seed = seed
        return self

    def copy(self) -> "AlgorithmConfig":
        return copy.deepcopy(self)

    def to_dict(self) -> dict:
        d = {k: v for k, v in self.__dict__.items() if k != "algo_class"}
        return d

    def update_from_dict(self, d: dict) -> "AlgorithmConfig":
        for key, val in d.items():
            if hasattr(self, key):
                setattr(self, key, val)
        return self

    def build(self) -> "Algorithm":
        if self.algo_class is None:
            raise ValueError("config has no algo_class; use PPOConfig() etc")
        return self.algo_class(config={"__algo_config__": self})


class Algorithm(Trainable):
    """Base: owns rollout-worker actors + a learner group; one train()
    iteration = one call of ``training_step()``."""

    _config_cls = AlgorithmConfig
    _worker_cls = RolloutWorker  # SAC swaps in ContinuousRolloutWorker

    @classmethod
    def get_default_config(cls) -> AlgorithmConfig:
        return cls._config_cls(cls)

    # ---- Trainable API ----

    def setup(self, config: Dict[str, Any]):
        cfg = config.get("__algo_config__")
        if cfg is None:
            cfg = self.get_default_config()
        else:
            cfg = cfg.copy()
        # Tune search spaces override individual fields via plain keys
        cfg.update_from_dict(
            {k: v for k, v in config.items() if k != "__algo_config__"})
        self.algo_config = cfg
        # no card and no device="cpu": raise before any worker starts
        resolve_device(cfg.device)
        worker_cls = ray_tpu_torch.remote(self._worker_cls)
        self.workers: List = [
            worker_cls.options(num_cpus=1).remote(
                cfg.env, cfg.num_envs_per_worker,
                cfg.rollout_fragment_length, cfg.gamma, cfg.lambda_,
                cfg.model_hiddens, seed=cfg.seed + i, worker_idx=i,
                connectors=cfg.connectors)
            for i in range(cfg.num_rollout_workers)
        ]
        probe = self._probe_env = self._make_probe_env()
        # continuous envs report action_dim where discrete ones report
        # their action count — the factory knows which it asked for
        act_dim = (probe.action_dim if getattr(probe, "continuous", False)
                   else probe.num_actions)
        obs_dim = probe.observation_dim
        if cfg.connectors is not None:
            # the learner's net must be sized for CONNECTED observations
            # (factory or instance, same contract as RolloutWorker)
            pipe = cfg.connectors() if callable(cfg.connectors) \
                else cfg.connectors
            obs_dim = pipe.observation_dim(obs_dim)
        self.learners = LearnerGroup(
            self._make_learner_factory(cfg, obs_dim, act_dim),
            num_learners=cfg.num_learners)
        self._episode_returns: collections.deque = collections.deque(
            maxlen=50)
        self._num_env_steps = 0
        self._sync_weights()

    def _make_probe_env(self):
        from .env import make_env

        return make_env(self.algo_config.env)

    def _make_learner_factory(self, cfg, obs_dim, num_actions) -> Callable:
        """-> a zero-argument factory of the learner on ``cfg.device``."""
        raise NotImplementedError

    def training_step(self) -> dict:
        raise NotImplementedError

    def step(self) -> dict:
        t0 = time.perf_counter()
        metrics = self.training_step()
        elapsed = time.perf_counter() - t0
        for m in ray_tpu_torch.get(
                [w.episode_metrics.remote() for w in self.workers],
                timeout=300):
            self._episode_returns.extend(m["episode_returns"])
        result = dict(metrics)
        # where the learner runs: its device, and the GPUs this process
        # leased (a Tune trial's; none in a driver)
        result["learner_device"] = str(self.learners.local.device)
        result["gpu_ids"] = ray_tpu_torch.get_gpu_ids()
        result["num_env_steps_sampled"] = self._num_env_steps
        result["env_steps_per_sec"] = (
            metrics.get("env_steps_this_iter", 0) / max(elapsed, 1e-9))
        if self._episode_returns:
            result["episode_reward_mean"] = float(
                np.mean(self._episode_returns))
            result["episode_reward_max"] = float(
                np.max(self._episode_returns))
        return result

    def _sync_weights(self):
        w_ref = ray_tpu_torch.put(self.learners.get_weights())
        ray_tpu_torch.get([w.set_weights.remote(w_ref) for w in self.workers],
                    timeout=300)

    def save_checkpoint(self) -> Any:
        return {"weights": self.learners.get_weights(),
                "num_env_steps": self._num_env_steps}

    def load_checkpoint(self, checkpoint: Any):
        if checkpoint:
            self.learners.set_weights(checkpoint["weights"])
            self._num_env_steps = checkpoint.get("num_env_steps", 0)
            self._sync_weights()

    def cleanup(self):
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        for r in getattr(self.learners, "remotes", []):
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass

    # convenience for direct (non-Tune) use, mirroring the reference
    def get_policy_weights(self) -> dict:
        return self.learners.get_weights()
