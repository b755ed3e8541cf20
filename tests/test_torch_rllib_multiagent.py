"""The port's multi-agent RL under the reference's tests/test_rllib.py
(its three multi-agent cases), at their settings and thresholds: rollout
workers' policies on the CPU, one PPO learner per policy on
``device="cpu"``.
"""

import pytest
from torch_port_util import deadline, one_torch_thread  # noqa: F401

import ray_tpu_torch


@pytest.fixture(scope="module")
def rt():
    info = ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield info
    ray_tpu_torch.shutdown()


class TestMultiAgent:
    """Analog of the reference's multi-agent tests
    (rllib/env/tests/test_multi_agent_env.py, policy-mapped PPO)."""

    @staticmethod
    def _make_env():
        import numpy as np

        from ray_tpu_torch.rllib.multi_agent import MultiAgentEnv

        class TwoGuess(MultiAgentEnv):
            """Two agents, 1-step episodes: each sees [sign, noise] and
            earns 1.0 for matching its own sign (independent learnable
            tasks; random play averages 0.5 per agent)."""

            agent_ids = ("a0", "a1")
            observation_dim = 2
            num_actions = 2
            max_episode_steps = 1

            def __init__(self):
                self._rng = np.random.default_rng(0)

            def _obs_one(self):
                sign = 1.0 if self._rng.random() < 0.5 else -1.0
                return np.array([sign, self._rng.random()], np.float32)

            def reset(self, seed=None):
                if seed is not None:
                    self._rng = np.random.default_rng(seed)
                self._cur = {a: self._obs_one() for a in self.agent_ids}
                return dict(self._cur)

            def step(self, actions):
                rewards = {}
                for a, act in actions.items():
                    want = 1 if self._cur[a][0] > 0 else 0
                    rewards[a] = 1.0 if act == want else 0.0
                dones = {a: True for a in actions}
                dones["__all__"] = True
                obs = {a: self._obs_one() for a in self.agent_ids}
                self._cur = obs
                return obs, rewards, dones, {}

        return TwoGuess

    @deadline(120)
    def test_multi_agent_batch_grouping(self, rt):
        import numpy as np

        from ray_tpu_torch.rllib.multi_agent import MultiAgentRolloutWorker

        TwoGuess = self._make_env()
        w = MultiAgentRolloutWorker(
            TwoGuess, ["p0", "p1"],
            lambda agent: "p0" if agent == "a0" else "p1",
            rollout_len=16, gamma=0.99, lam=0.95, seed=0)
        ma = w.sample()
        assert set(ma.policy_batches) == {"p0", "p1"}
        assert ma.env_steps == 16
        assert ma.agent_steps == 32  # 2 agents x 16 steps
        for b in ma.policy_batches.values():
            assert b.count == 16
            assert "advantages" in b
        assert np.isfinite(ma["p0"]["advantages"]).all()

    @deadline(300)
    def test_multi_agent_ppo_learns(self, rt):
        from ray_tpu_torch.rllib.multi_agent import MultiAgentPPO

        TwoGuess = self._make_env()
        algo = MultiAgentPPO(
            TwoGuess, policies=["p0", "p1"],
            policy_mapping_fn=lambda agent: "p0" if agent == "a0"
            else "p1",
            num_rollout_workers=2, rollout_len=64, lr=1e-2, seed=0,
            device="cpu")
        best = 0.0
        try:
            for _ in range(25):
                r = algo.train()
                best = max(best, r.get("episode_reward_mean", 0.0))
                if best >= 1.85:
                    break
        finally:
            algo.cleanup()
        # random play totals ~1.0 across the two agents; both policies
        # must have learned their own mapping
        assert best >= 1.7, f"multi-agent PPO failed to learn: {best}"

    def test_multi_agent_batch_concat(self):
        import numpy as np

        from ray_tpu_torch.rllib import SampleBatch
        from ray_tpu_torch.rllib.multi_agent import MultiAgentBatch

        b1 = MultiAgentBatch(
            {"p0": SampleBatch({"obs": np.zeros((3, 2))})}, env_steps=3)
        b2 = MultiAgentBatch(
            {"p0": SampleBatch({"obs": np.ones((2, 2))}),
             "p1": SampleBatch({"obs": np.ones((4, 2))})}, env_steps=4)
        m = MultiAgentBatch.concat([b1, b2])
        assert m.env_steps == 7
        assert m["p0"].count == 5 and m["p1"].count == 4
