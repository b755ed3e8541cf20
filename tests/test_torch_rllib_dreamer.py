"""The port's DreamerV3 under the reference's tests/test_rllib_dreamer.py:
world-model mechanics, imagination, replay and the learning run, at its
settings and thresholds with the learner on the CPU (``device="cpu"``).
The fixed-batch case keeps the reference's non-strict xfail on the CPU;
the learning class keeps its slow marker (chip_smoke.py's phase rllib2
runs the same bar with the learner on the card).
"""

import numpy as np
import pytest
import torch
from torch_port_util import deadline, one_torch_thread  # noqa: F401

from ray_tpu_torch.rllib.dreamer import (DreamerLearner, DreamerV3Config,
                                         SequenceBuffer)


def _fake_batch(rng, B=4, L=16, obs_dim=4, num_actions=2):
    return (rng.normal(size=(B, L, obs_dim)).astype(np.float32),
            rng.integers(0, num_actions, (B, L)),
            rng.normal(size=(B, L)).astype(np.float32),
            np.ones((B, L), np.float32))


class TestWorldModel:
    # The reference's case fails on its CPU build: the tiny fixed-batch
    # world model's TOTAL loss decreases over 20 updates but the
    # reconstruction term plateaus. The mirror's learner is on the CPU, so
    # it keeps the reference's non-strict CPU xfail.
    @pytest.mark.xfail(
        reason="CPU: recon_loss plateaus on the CI-sized fixed batch (the "
               "reference's own non-strict CPU xfail)",
        strict=False)
    def test_losses_decrease_on_fixed_batch(self):
        ln = DreamerLearner(4, 2, deter=32, hidden=32, horizon=5, seed=0,
                            device="cpu")
        obs, act, rew, cont = _fake_batch(np.random.default_rng(0))
        first = ln.update(obs, act, rew, cont)
        for _ in range(20):
            last = ln.update(obs, act, rew, cont)
        assert last["wm_loss"] < first["wm_loss"]
        assert last["recon_loss"] < first["recon_loss"]
        assert np.isfinite(last["critic_loss"])
        assert np.isfinite(last["actor_loss"])

    def test_policy_state_threading(self):
        ln = DreamerLearner(4, 2, deter=32, hidden=32, horizon=5, seed=0,
                            device="cpu")
        pol = ln.init_policy_state()
        actions = set()
        for i in range(10):
            pol, a = ln.act(pol, np.random.default_rng(i).normal(size=4))
            assert 0 <= a < 2
            actions.add(a)
        # untrained stochastic policy explores both actions
        assert len(actions) == 2

    def test_symlog_roundtrip(self):
        from ray_tpu_torch.rllib.dreamer import symexp, symlog

        x = torch.tensor([-100.0, -1.0, 0.0, 0.5, 1000.0])
        np.testing.assert_allclose(symexp(symlog(x)).numpy(), x.numpy(),
                                   rtol=1e-5)


class TestReplay:
    def test_sequence_sampling(self):
        buf = SequenceBuffer(100, 4, seed=0)
        for i in range(60):
            buf.add(np.full(4, i, np.float32), i % 2, float(i), 1.0)
        obs, act, rew, cont = buf.sample(8, 10)
        assert obs.shape == (8, 10, 4) and act.shape == (8, 10)
        # subsequences are contiguous in time
        for b in range(8):
            diffs = np.diff(obs[b, :, 0])
            np.testing.assert_allclose(diffs, 1.0)

    def test_ring_wraparound_stays_contiguous(self):
        """Windows sampled after the ring wraps must be contiguous in
        LOGICAL time — a physical window across the write head would
        stitch the newest steps onto the oldest."""
        buf = SequenceBuffer(32, 1, seed=0)
        for i in range(80):
            buf.add(np.full(1, i, np.float32), 0, 0.0, 1.0)
        assert len(buf) == 32
        obs, _, _, _ = buf.sample(64, 8)
        for b in range(64):
            np.testing.assert_allclose(np.diff(obs[b, :, 0]), 1.0)

    def test_exact_length_buffer_samplable(self):
        buf = SequenceBuffer(64, 1, seed=0)
        for i in range(10):
            buf.add(np.full(1, i, np.float32), 0, 0.0, 1.0)
        obs, _, _, _ = buf.sample(4, 10)  # n == length edge
        np.testing.assert_allclose(obs[0, :, 0], np.arange(10))


@pytest.mark.slow
class TestDreamerLearning:
    @deadline(3600)
    def test_learns_cartpole(self):
        """Reward clearly improves within a CI-sized budget (the
        reference's bar: final > 60 and > early + 20 at iteration 30)."""
        algo = (DreamerV3Config()
                .training(updates_per_iter=16)
                .resources(device="cpu")
                .debugging(seed=1)
                .build())
        early = None
        for i in range(30):
            m = algo.step()
            if i == 4:
                early = m.get("episode_reward_mean", 0.0)
        final = m["episode_reward_mean"]
        assert final > 60, f"no learning: early={early} final={final}"
        assert final > early + 20
