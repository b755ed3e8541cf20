"""The port's host-side and offline algorithms under the reference's
tests/test_rllib_breadth.py: ES (its two cases), the bandits (LinUCB and
LinTS) and offline BC / CQL / dataset logging, at its settings and
thresholds. ES and the bandits update in numpy on the host; BC's and CQL's
learners are on ``device="cpu"``.
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


class TestES:
    @deadline(300)
    def test_es_learns_stateless_guess(self, rt):
        """Gradient-free family: ES must solve the 1-step guess env
        (optimal reward 1.0, random 0.5)."""
        from ray_tpu_torch.rllib import ESConfig

        algo = ESConfig().environment("StatelessGuess-v0").rollouts(
            num_rollout_workers=2,
        ).training(sigma=0.1, lr=0.05, model_hiddens=(16,),
                   perturbations_per_step=12,
                   episodes_per_perturbation=8).resources(
                       device="cpu").debugging(seed=0).build()
        best = 0.0
        for _ in range(40):
            result = algo.train()
            best = max(best, result.get("episode_reward_mean", 0.0))
            if best >= 0.95:
                break
        algo.stop()
        assert best >= 0.9, f"ES failed to learn: best={best}"

    @deadline(120)
    def test_es_checkpoint_roundtrip(self, rt):
        from ray_tpu_torch.rllib import ESConfig

        algo = ESConfig().environment("StatelessGuess-v0").rollouts(
            num_rollout_workers=1).training(
                model_hiddens=(8,), perturbations_per_step=4).resources(
                    device="cpu").build()
        algo.train()
        ckpt = algo.save()
        w0 = algo.get_policy_weights()
        algo2 = ESConfig().environment("StatelessGuess-v0").rollouts(
            num_rollout_workers=1).training(
                model_hiddens=(8,), perturbations_per_step=4).resources(
                    device="cpu").build()
        algo2.restore(ckpt)
        w1 = algo2.get_policy_weights()
        for k in w0:
            np.testing.assert_array_equal(w0[k], w1[k])
        algo.stop()
        algo2.stop()


class TestBandits:
    @pytest.mark.parametrize("algo_name", ["linucb", "lints"])
    def test_bandit_regret_shrinks(self, algo_name):
        from ray_tpu_torch.rllib import BanditConfig, BanditLinTS, BanditLinUCB

        cls = BanditLinUCB if algo_name == "linucb" else BanditLinTS
        cfg = BanditConfig(cls)
        cfg.steps_per_iter = 200
        algo = cfg.build()
        first = algo.train()["regret_mean"]
        for _ in range(4):
            last = algo.train()["regret_mean"]
        algo.stop()
        # with a learned linear model per arm the per-step regret must
        # collapse vs the first (exploring) iteration
        assert last < first * 0.5, f"{algo_name}: {first} -> {last}"
        assert last < 0.1


class TestOffline:
    def _expert_dataset(self, tmp_path):
        """Synthetic expert data for StatelessGuess: optimal action is
        determined by the sign feature."""
        from ray_tpu_torch.rllib import SampleBatch, save_batches
        from ray_tpu_torch.rllib import sample_batch as SB_mod

        rng = np.random.default_rng(0)
        n = 2048
        sign = np.where(rng.random(n) < 0.5, 1.0, -1.0)
        obs = np.stack([sign, rng.random(n)], axis=1).astype(np.float32)
        acts = (sign > 0).astype(np.int64)
        batch = SampleBatch({
            SB_mod.OBS: obs,
            SB_mod.ACTIONS: acts,
            SB_mod.REWARDS: np.ones(n, np.float32),
            SB_mod.DONES: np.ones(n, np.bool_),
            SB_mod.NEXT_OBS: obs[::-1].copy(),
        })
        path = str(tmp_path / "expert")
        save_batches(path, [batch])
        return path

    def test_bc_clones_expert(self, tmp_path):
        from ray_tpu_torch.rllib import BCConfig

        path = self._expert_dataset(tmp_path)
        algo = BCConfig().environment("StatelessGuess-v0") \
            .offline_data(input_path=path) \
            .training(lr=1e-2, model_hiddens=(16,)) \
            .resources(device="cpu").build()
        best = 0.0
        for _ in range(10):
            result = algo.train()
            best = max(best, result["episode_reward_mean"])
            if best >= 0.95:
                break
        algo.stop()
        assert best >= 0.9, f"BC failed to clone expert: best={best}"

    def test_cql_learns_from_mixed_data(self, tmp_path):
        """CQL must recover the good policy from 50% expert / 50% random
        logged data (where BC of the mixture would be ~0.75)."""
        from ray_tpu_torch.rllib import CQLConfig, SampleBatch, save_batches
        from ray_tpu_torch.rllib import sample_batch as SB_mod

        rng = np.random.default_rng(1)
        n = 4096
        sign = np.where(rng.random(n) < 0.5, 1.0, -1.0)
        obs = np.stack([sign, rng.random(n)], axis=1).astype(np.float32)
        optimal = (sign > 0).astype(np.int64)
        acts = np.where(rng.random(n) < 0.5, optimal,
                        rng.integers(0, 2, n)).astype(np.int64)
        rewards = (acts == optimal).astype(np.float32)
        batch = SampleBatch({
            SB_mod.OBS: obs, SB_mod.ACTIONS: acts,
            SB_mod.REWARDS: rewards,
            SB_mod.DONES: np.ones(n, np.bool_),
            SB_mod.NEXT_OBS: obs[::-1].copy(),
        })
        path = str(tmp_path / "mixed")
        save_batches(path, [batch])
        algo = CQLConfig().environment("StatelessGuess-v0") \
            .offline_data(input_path=path) \
            .training(lr=1e-2, cql_alpha=0.5, model_hiddens=(16,)) \
            .resources(device="cpu").build()
        best = 0.0
        for _ in range(15):
            result = algo.train()
            best = max(best, result["episode_reward_mean"])
            if best >= 0.95:
                break
        algo.stop()
        assert best >= 0.9, f"CQL failed: best={best}"

    def test_collect_and_load_roundtrip(self, tmp_path):
        from ray_tpu_torch.rllib import collect_dataset, load_batches

        path = str(tmp_path / "logged")
        files = collect_dataset("CartPole-v1", path, num_steps=256,
                                num_envs=4, epsilon=1.0, seed=3)
        assert files
        ds = load_batches(path)
        assert ds.count == 256
        assert set(ds.keys()) >= {"obs", "actions", "rewards", "dones",
                                  "new_obs"}
