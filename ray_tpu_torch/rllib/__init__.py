"""ray_tpu_torch.rllib — reinforcement learning on the port's runtime.

The PyTorch counterpart of the reference's RLlib (rllib/): CPU
rollout-worker actors step native vectorized envs with their policy on the
CPU; learners run forward, backward and Adam on the card (``device=None``,
which raises without CUDA) or, when asked, on the CPU; PPO and A2C are the
synchronous on-policy algorithms, IMPALA and APPO the asynchronous V-trace
ones, DQN the off-policy one with (prioritized) replay. Algorithms are
Tune Trainables, so ``Tuner(PPO, param_space=...)`` works.

    from ray_tpu_torch.rllib import PPOConfig
    algo = PPOConfig().environment("CartPole-v1").build()
    for _ in range(10):
        print(algo.train()["episode_reward_mean"])

This slice has the part every gradient algorithm shares and the five
algorithms built directly on it; Ape-X, SAC, TD3, R2D2, multi-agent,
offline, bandits, ES/ARS, Dreamer and AlphaZero are still to port.
"""

from .a2c import A2C, A2CConfig, A2CLearner
from .algorithm import Algorithm, AlgorithmConfig
from .appo import APPO, APPOConfig, APPOLearner
from .catalog import (ModelSpec, get_model, gru_cell, gru_forward,
                      gru_unroll, init_gru, register_custom_model)
from .connectors import (ClipAction, ClipObs, Connector, ConnectorPipeline,
                         FlattenObs, NormalizeObs, UnsquashAction)
from .dqn import DQN, DQNConfig, DQNLearner
from .env import (BreakoutMini, CartPole, ContextualBandit, Env, Pendulum,
                  VectorEnv, make_env, register_env)
from .impala import IMPALA, IMPALAConfig
from .learner import ImpalaLearner, LearnerGroup, PPOLearner, vtrace
from .models import params_from_numpy
from .policy import SquashedGaussianPolicy, TorchPolicy
from .ppo import PPO, PPOConfig
from .replay_buffers import PrioritizedReplayBuffer, ReplayBuffer
from .rollout_worker import ContinuousRolloutWorker, RolloutWorker
from .sample_batch import SampleBatch, compute_gae, concat_samples

__all__ = [
    "Algorithm", "AlgorithmConfig", "PPO", "PPOConfig", "IMPALA",
    "IMPALAConfig", "APPO", "APPOConfig", "APPOLearner", "A2C",
    "A2CConfig", "A2CLearner", "DQN", "DQNConfig", "DQNLearner",
    "ReplayBuffer", "PrioritizedReplayBuffer", "Env", "CartPole",
    "Pendulum", "BreakoutMini", "ContextualBandit", "VectorEnv",
    "make_env", "register_env", "TorchPolicy", "SquashedGaussianPolicy",
    "RolloutWorker", "ContinuousRolloutWorker", "SampleBatch",
    "concat_samples", "compute_gae", "PPOLearner", "ImpalaLearner",
    "LearnerGroup", "vtrace", "Connector", "ConnectorPipeline",
    "FlattenObs", "NormalizeObs", "ClipObs", "ClipAction",
    "UnsquashAction", "ModelSpec", "get_model", "register_custom_model",
    "init_gru", "gru_cell", "gru_forward", "gru_unroll",
    "params_from_numpy",
]

from ray_tpu_torch.usage_stats import record_library_usage as _rlu
_rlu("rllib")
del _rlu
