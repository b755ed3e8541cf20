"""The port's RLlib under the reference's tests/test_rllib.py, part 2: the
IMPALA and DQN learning runs (the rest is in tests/test_torch_rllib.py), at
the reference's thresholds with every learner on the CPU.
"""

import numpy as np  # noqa: F401
import pytest
from torch_port_util import deadline, one_torch_thread  # noqa: F401

import ray_tpu_torch


@pytest.fixture(scope="module")
def rt():
    info = ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield info
    ray_tpu_torch.shutdown()


class TestIMPALA:
    @deadline(400)
    def test_impala_learns(self, rt):
        """Async V-trace learner improves on CartPole (smoke threshold)."""
        from ray_tpu_torch.rllib import IMPALAConfig

        algo = IMPALAConfig().environment("CartPole-v1").rollouts(
            num_rollout_workers=2, num_envs_per_worker=4,
            rollout_fragment_length=64,
        ).training(lr=1e-3, entropy_coeff=0.005).resources(
            device="cpu").debugging(seed=0).build()
        best = 0.0
        for _ in range(120):
            result = algo.train()
            best = max(best, result.get("episode_reward_mean", 0.0))
            if best >= 100.0:
                break
        algo.stop()
        assert best >= 100.0, f"IMPALA failed to learn: best={best}"


class TestDQN:
    @deadline(300)
    def test_dqn_learns_stateless_guess(self, rt):
        """Off-policy plumbing end-to-end on the 1-step env: reward 1 iff
        the action matches the obs sign (random play = 0.5)."""
        from ray_tpu_torch.rllib import DQNConfig

        cfg = (DQNConfig().environment("StatelessGuess-v0")
               .rollouts(num_rollout_workers=2, num_envs_per_worker=4,
                         rollout_fragment_length=16)
               .training(train_batch_size=64, num_updates_per_iter=16,
                         num_steps_sampled_before_learning_starts=128,
                         epsilon_timesteps=1500,
                         target_network_update_freq=256, lr=1e-3)
               .resources(device="cpu").debugging(seed=0))
        algo = cfg.build()
        best = 0.0
        for _ in range(30):
            r = algo.train()
            best = max(best, r.get("episode_reward_mean", 0.0))
            if best >= 0.95:
                break
        algo.cleanup()
        assert best >= 0.9, f"DQN failed to learn: best={best}"

    @deadline(120)
    def test_dqn_cartpole_smoke_and_checkpoint(self, rt):
        from ray_tpu_torch.rllib import DQNConfig

        cfg = (DQNConfig().environment("CartPole-v1")
               .rollouts(num_rollout_workers=1, num_envs_per_worker=2,
                         rollout_fragment_length=16)
               .training(num_updates_per_iter=4,
                         num_steps_sampled_before_learning_starts=32)
               .resources(device="cpu").debugging(seed=0))
        algo = cfg.build()
        r = algo.train()
        assert r["epsilon"] > 0.9  # schedule starts near epsilon_initial
        r = algo.train()
        assert "loss" in r and r["replay_size"] > 0
        ckpt = algo.save_checkpoint()
        algo2 = cfg.build()
        algo2.load_checkpoint(ckpt)
        w1 = algo.get_policy_weights()
        w2 = algo2.get_policy_weights()
        import numpy as np

        for k in w1:
            np.testing.assert_allclose(w1[k], w2[k])
        algo.cleanup()
        algo2.cleanup()
