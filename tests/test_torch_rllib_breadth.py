"""The port's RLlib under the reference's tests/test_rllib_breadth.py:
BreakoutMini (the MinAtar-class env) and APPO's learning run, at its
thresholds with the learner on the CPU. ES, the bandits and the offline
algorithms are in tests/test_torch_rllib_offline.py.
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


class TestBreakoutMini:
    def test_playable_and_rewarding(self):
        from ray_tpu_torch.rllib import BreakoutMini

        env = BreakoutMini()
        obs = env.reset(seed=0)
        assert obs.shape == (400,)
        rng = np.random.default_rng(0)
        total, episodes = 0.0, 0
        for _ in range(5):
            done = False
            env.reset(seed=episodes)
            steps = 0
            while not done and steps < 1200:
                obs, r, done, _ = env.step(int(rng.integers(0, 3)))
                total += r
                steps += 1
            episodes += 1
        # random play occasionally breaks bricks but always loses the ball
        assert episodes == 5

    def test_predictive_paddle_scores(self):
        """A hand-coded landing-point predictor (what a trained agent
        learns) must keep rallies going and clear bricks — the env is
        learnable, not a reward desert."""
        from ray_tpu_torch.rllib import BreakoutMini

        def land_x(bx, by, dx, dy, n=10):
            """Project the ball to the paddle row with wall bounces."""
            for _ in range(50):
                if by >= n - 1:
                    return bx
                nx = bx + dx
                if nx < 0 or nx >= n:
                    dx = -dx
                    nx = bx + dx
                if by + dy < 0:
                    dy = 1
                bx, by = nx, by + dy
            return bx

        def run(policy):
            rng = np.random.default_rng(0)
            total = 0.0
            for ep in range(5):
                env = BreakoutMini()
                obs = env.reset(seed=100 + ep)
                done, steps = False, 0
                while not done and steps < 1000:
                    obs, r, done, _ = env.step(policy(obs, rng))
                    total += r
                    steps += 1
            return total

        def predictive(obs, _rng):
            p = obs.reshape(4, 10, 10)
            pad_x = int(np.argmax(p[0][9]))
            by, bx = np.unravel_index(int(np.argmax(p[1])), (10, 10))
            ty, tx = np.unravel_index(int(np.argmax(p[2])), (10, 10))
            dx, dy = int(bx - tx), int(by - ty)
            if dx == 0 and dy == 0:  # first frame: no velocity yet
                target = int(bx)
            else:
                target = land_x(int(bx), int(by), dx, dy or 1)
            return 0 if target in (pad_x, pad_x + 1) else \
                (1 if target < pad_x else 2)

        skilled = run(predictive)
        random_play = run(lambda _o, rng: int(rng.integers(0, 3)))
        # skill must clearly pay (brick bounces make SOME ball losses
        # unavoidable, as in MinAtar — the margin, not a max score, is
        # what "learnable" means here)
        assert skilled >= 8.0, f"predictive policy scored {skilled}"
        assert skilled >= 4 * max(random_play, 1.0), \
            f"skill margin too thin: {skilled} vs random {random_play}"


class TestAPPO:
    @deadline(400)
    def test_appo_learns(self, rt):
        from ray_tpu_torch.rllib import APPOConfig

        algo = APPOConfig().environment("CartPole-v1").rollouts(
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
        assert best >= 100.0, f"APPO failed to learn: best={best}"
