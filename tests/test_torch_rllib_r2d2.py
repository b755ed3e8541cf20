"""The port's R2D2 under the reference's tests/test_rllib_catalog.py (its
two R2D2 cases), at their settings and thresholds with the learner on the
CPU (``device="cpu"``) and the recurrent rollout worker a CPU actor.
"""

import numpy as np
import pytest
from torch_port_util import deadline, one_torch_thread  # noqa: F401

import ray_tpu_torch


@pytest.fixture(scope="module")
def rt():
    info = ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield info
    ray_tpu_torch.shutdown()


class TestR2D2:
    def test_learner_regresses_fixed_target(self):
        from ray_tpu_torch.rllib import R2D2Learner

        l = R2D2Learner(3, 2, lr=1e-2, gamma=0.9, burn_in=2, hidden=8,
                        seed=0, device="cpu")
        rng = np.random.default_rng(0)
        B, T = 16, 10
        batch = {
            "obs": rng.normal(size=(B, T, 3)).astype(np.float32),
            "actions": rng.integers(0, 2, (B, T)),
            "rewards": np.full((B, T), 1.0, np.float32),
            "dones": np.ones((B, T), np.bool_),  # target exactly r
            "reset": np.zeros((B, T), np.bool_),
            "h0": np.zeros((B, 8), np.float32),
        }
        losses = [l.update(batch)["loss"] for _ in range(150)]
        assert losses[-1] < losses[0] * 0.2

    @deadline(600)
    def test_r2d2_learns_cartpole(self, rt):
        """The memoryless-env smoke: with full observability the GRU
        must still reach DQN-class CartPole reward (the reference's
        r2d2 tests use stateless CartPole the same way)."""
        from ray_tpu_torch.rllib import R2D2Config

        algo = (R2D2Config().environment("CartPole-v1")
                .rollouts(num_rollout_workers=1, num_envs_per_worker=8)
                .training(train_batch_size=32, num_updates_per_iter=24,
                          num_steps_sampled_before_learning_starts=500,
                          seq_len=16, burn_in=4, epsilon_timesteps=3000,
                          target_network_update_freq=400)
                .resources(device="cpu").debugging(seed=0)).build()
        best, it = 0.0, 0
        for it in range(1, 101):
            r = algo.train()
            best = max(best, r.get("episode_reward_mean", 0.0))
            if best > 100:
                break
        algo.cleanup()
        print(f"R2D2 best {best} at iteration {it}")
        # random play scores ~20; 100+ demonstrates recurrent Q-learning
        assert best > 100, f"R2D2 failed to learn CartPole: best {best}"
