"""The port's connector pipeline and A2C under the reference's
tests/test_rllib_connectors.py, at its thresholds, with the learner on the
CPU. The Ape-X cases wait for apex_dqn's port.
"""

import numpy as np
import pytest
from torch_port_util import deadline, one_torch_thread  # noqa: F401

import ray_tpu_torch
from ray_tpu_torch.rllib import (ClipAction, ClipObs, ConnectorPipeline,
                                 FlattenObs, NormalizeObs, UnsquashAction)


def _normalize_pipeline():
    """Module-level factory: connector factories ship to worker actors
    by pickle, so lambdas won't do."""
    return ConnectorPipeline([NormalizeObs()])


@pytest.fixture(scope="module")
def rt():
    info = ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield info
    ray_tpu_torch.shutdown()


class TestConnectors:
    def test_flatten_and_dim(self):
        pipe = ConnectorPipeline([FlattenObs((4, 5))])
        obs = np.arange(2 * 4 * 5, dtype=np.float32).reshape(2, 4, 5)
        out = pipe.transform_obs(obs)
        assert out.shape == (2, 20)
        assert pipe.observation_dim(20) == 20

    def test_clip_obs(self):
        pipe = ConnectorPipeline([ClipObs(-1.0, 1.0)])
        out = pipe.transform_obs(np.array([[-5.0, 0.5, 9.0]]))
        assert out.tolist() == [[-1.0, 0.5, 1.0]]

    def test_normalize_converges_to_unit_scale(self):
        rng = np.random.default_rng(0)
        norm = NormalizeObs()
        pipe = ConnectorPipeline([norm])
        for _ in range(50):
            pipe.transform_obs(rng.normal(5.0, 3.0, size=(32, 4)))
        out = pipe.transform_obs(rng.normal(5.0, 3.0, size=(4096, 4)))
        assert abs(float(out.mean())) < 0.1
        assert abs(float(out.std()) - 1.0) < 0.1

    def test_normalize_state_roundtrip(self):
        rng = np.random.default_rng(1)
        a = NormalizeObs()
        for _ in range(10):
            a.transform_obs(rng.normal(2.0, 1.5, size=(16, 3)))
        b = NormalizeObs()
        b.set_state(a.get_state())
        b.frozen = a.frozen = True
        x = rng.normal(2.0, 1.5, size=(8, 3))
        assert np.allclose(a.transform_obs(x), b.transform_obs(x))

    def test_action_leg_applies_right_to_left(self):
        # policy emits [-1, 1]; unsquash to [0, 10] then clip to [0, 8]
        pipe = ConnectorPipeline([ClipAction(0.0, 8.0),
                                  UnsquashAction(0.0, 10.0)])
        acts = pipe.transform_action(np.array([-1.0, 0.0, 1.0]))
        assert acts.tolist() == [0.0, 5.0, 8.0]

    def test_pipeline_in_rollout_worker(self):
        """A NormalizeObs pipeline between env and policy: the worker's
        batches carry CONNECTED observations."""
        from ray_tpu_torch.rllib.rollout_worker import RolloutWorker

        w = RolloutWorker("CartPole-v1", num_envs=2, rollout_len=16,
                          gamma=0.99, lam=0.95, seed=0,
                          connectors=lambda: ConnectorPipeline(
                              [NormalizeObs()]))
        batch = w.sample()
        assert batch["obs"].shape == (32, 4)
        # running normalization keeps magnitudes of the emitted batch
        # around unit scale, far below CartPole's raw position bounds
        assert float(np.abs(batch["obs"]).mean()) < 3.0


class TestA2C:
    @deadline(400)
    def test_a2c_learns_cartpole(self, rt):
        from ray_tpu_torch.rllib import A2CConfig

        algo = A2CConfig().environment("CartPole-v1").rollouts(
            num_rollout_workers=2, num_envs_per_worker=2,
            rollout_fragment_length=32,
        ).training(lr=2e-3, entropy_coeff=0.005,
                   vf_coeff=0.25).resources(device="cpu").debugging(
                       seed=0).build()
        best = 0.0
        for _ in range(500):
            result = algo.train()
            best = max(best, result.get("episode_reward_mean", 0.0))
            if best >= 100.0:
                break
        algo.stop()
        assert best >= 100.0, f"A2C failed to learn: best={best}"

    @deadline(120)
    def test_a2c_with_connectors(self, rt):
        from ray_tpu_torch.rllib import A2CConfig

        algo = A2CConfig().environment("CartPole-v1").rollouts(
            num_rollout_workers=1, num_envs_per_worker=2,
            rollout_fragment_length=32,
            connectors=_normalize_pipeline,
        ).resources(device="cpu").debugging(seed=0).build()
        result = algo.train()
        assert "total_loss" in result
        algo.stop()
