"""The port's Ape-X under the reference's tests/test_rllib_connectors.py
(its two Ape-X cases), at their settings and thresholds with the learner
on the CPU (``device="cpu"``) and replay shards as CPU actors.
"""

import pytest
from torch_port_util import deadline, one_torch_thread  # noqa: F401

import ray_tpu_torch


@pytest.fixture(scope="module")
def rt():
    info = ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield info
    ray_tpu_torch.shutdown()


class TestApexDQN:
    @deadline(600)
    def test_apex_learns_cartpole(self, rt):
        from ray_tpu_torch.rllib import ApexDQNConfig

        algo = ApexDQNConfig().environment("CartPole-v1").rollouts(
            num_rollout_workers=2, num_envs_per_worker=4,
            rollout_fragment_length=32,
        ).training(lr=5e-4).resources(device="cpu").debugging(
            seed=0).build()
        best, it = 0.0, 0
        for it in range(1, 151):
            result = algo.train()
            best = max(best, result.get("episode_reward_mean", 0.0))
            if best >= 100.0:
                break
        replay = result.get("replay_size", 0)
        algo.stop()
        print(f"Ape-X best {best} at iteration {it}")
        assert replay > 0, "replay shards never filled"
        assert best >= 100.0, f"ApexDQN failed to learn: best={best}"

    @deadline(120)
    def test_apex_per_worker_epsilon_ladder(self, rt):
        from ray_tpu_torch.rllib import ApexDQNConfig
        from ray_tpu_torch.rllib.apex_dqn import ApexDQN

        algo = ApexDQNConfig().environment("CartPole-v1").rollouts(
            num_rollout_workers=3, num_envs_per_worker=2,
            rollout_fragment_length=8,
        ).resources(device="cpu").debugging(seed=0).build()
        assert isinstance(algo, ApexDQN)
        eps = algo._worker_epsilons()
        assert len(eps) == 3
        assert eps[0] > eps[1] > eps[2] > 0.0, eps
        algo.stop()
