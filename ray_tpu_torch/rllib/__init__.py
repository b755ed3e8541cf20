"""ray_tpu_torch.rllib — reinforcement learning on the port's runtime.

The PyTorch counterpart of the reference's RLlib (rllib/): CPU
rollout-worker actors step native vectorized envs with their policy on the
CPU; learners run forward, backward and Adam on the card (``device=None``,
which raises without CUDA) or, when asked, on the CPU; PPO and A2C are the
synchronous on-policy algorithms, IMPALA and APPO the asynchronous V-trace
ones, DQN, Ape-X (sharded replay actors) and R2D2 (recurrent replay) the
off-policy discrete ones, SAC, TD3 and DDPG the continuous ones;
multi-agent PPO, offline BC / CQL / MARWIL, DreamerV3 (a world model)
and AlphaZero (MCTS self-play) complete the set. Bandits (LinUCB, LinTS),
ES and ARS update on the host in numpy and put nothing on the card.
Algorithms are Tune Trainables, so ``Tuner(PPO, param_space=...)`` works.

    from ray_tpu_torch.rllib import PPOConfig
    algo = PPOConfig().environment("CartPole-v1").build()
    for _ in range(10):
        print(algo.train()["episode_reward_mean"])
"""

from .a2c import A2C, A2CConfig, A2CLearner
from .algorithm import Algorithm, AlgorithmConfig
from .alpha_zero import (MCTS, AlphaZero, AlphaZeroConfig,
                         AlphaZeroLearner, TicTacToe)
from .apex_dqn import ApexDQN, ApexDQNConfig, ReplayShard
from .appo import APPO, APPOConfig, APPOLearner
from .ars import ARS, ARSConfig
from .bandits import BanditConfig, BanditLinTS, BanditLinUCB
from .catalog import (ModelSpec, get_model, gru_cell, gru_forward,
                      gru_unroll, init_gru, register_custom_model)
from .connectors import (ClipAction, ClipObs, Connector, ConnectorPipeline,
                         FlattenObs, NormalizeObs, UnsquashAction)
from .dqn import DQN, DQNConfig, DQNLearner
from .dreamer import (DreamerLearner, DreamerV3, DreamerV3Config,
                      SequenceBuffer)
from .env import (BreakoutMini, CartPole, ContextualBandit, Env, Pendulum,
                  VectorEnv, make_env, register_env)
from .es import ES, ESConfig, ESWorker
from .impala import IMPALA, IMPALAConfig
from .learner import ImpalaLearner, LearnerGroup, PPOLearner, vtrace
from .models import params_from_numpy
from .multi_agent import (MultiAgentBatch, MultiAgentEnv, MultiAgentPPO,
                          MultiAgentRolloutWorker)
from .offline import (BC, CQL, MARWIL, BCConfig, CQLConfig, MARWILConfig,
                      collect_dataset, load_batches, save_batches)
from .policy import SquashedGaussianPolicy, TorchPolicy
from .ppo import PPO, PPOConfig
from .r2d2 import (R2D2, R2D2Config, R2D2Learner, R2D2RolloutWorker,
                   SequenceReplay)
from .replay_buffers import PrioritizedReplayBuffer, ReplayBuffer
from .rollout_worker import ContinuousRolloutWorker, RolloutWorker
from .sac import SAC, SACConfig, SACLearner
from .sample_batch import SampleBatch, compute_gae, concat_samples
from .td3 import (DDPG, TD3, DDPGConfig, TD3Config, TD3Learner,
                  TD3RolloutWorker)

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
    "params_from_numpy", "MultiAgentEnv", "MultiAgentBatch",
    "MultiAgentPPO", "MultiAgentRolloutWorker", "SAC", "SACConfig",
    "SACLearner", "ES", "ESConfig", "ESWorker", "BanditLinUCB",
    "BanditLinTS", "BanditConfig", "BC", "BCConfig", "CQL", "CQLConfig",
    "MARWIL", "MARWILConfig", "collect_dataset", "load_batches",
    "save_batches", "ApexDQN", "ApexDQNConfig", "ReplayShard", "TD3",
    "TD3Config", "TD3Learner", "TD3RolloutWorker", "DDPG", "DDPGConfig",
    "ARS", "ARSConfig", "R2D2", "R2D2Config", "R2D2Learner",
    "R2D2RolloutWorker", "SequenceReplay", "AlphaZero", "AlphaZeroConfig",
    "AlphaZeroLearner", "MCTS", "TicTacToe", "DreamerV3",
    "DreamerV3Config", "DreamerLearner", "SequenceBuffer",
]

from ray_tpu_torch.usage_stats import record_library_usage as _rlu
_rlu("rllib")
del _rlu
