"""Environments: a minimal Env protocol, classic-control tasks, VectorEnv.

Ref analogs: rllib/env/base_env.py + env/vector_env.py (the reference wraps
gym; this image has no gym, so the classic CartPole dynamics are implemented
directly — same physics constants as gym's cartpole.py, which are public
textbook values from Barto, Sutton & Anderson 1983).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np


class Env:
    """Single environment: reset() -> obs; step(a) -> (obs, r, done, info).

    Discrete envs set ``num_actions``; continuous envs set
    ``continuous = True``, ``action_dim``, and ``action_low/high`` (and
    receive a float32 [action_dim] array in step()).
    """

    observation_dim: int
    num_actions: int = 0
    max_episode_steps: int = 1000
    continuous: bool = False
    action_dim: int = 0
    action_low: float = -1.0
    action_high: float = 1.0

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        raise NotImplementedError

    def step(self, action: int) -> Tuple[np.ndarray, float, bool, dict]:
        raise NotImplementedError


class CartPole(Env):
    """Pole balancing; solved threshold 475 (v1 cap 500)."""

    observation_dim = 4
    num_actions = 2
    max_episode_steps = 500

    GRAVITY = 9.8
    MASSCART = 1.0
    MASSPOLE = 0.1
    LENGTH = 0.5  # half pole length
    FORCE_MAG = 10.0
    TAU = 0.02
    THETA_LIMIT = 12 * 2 * math.pi / 360
    X_LIMIT = 2.4

    def __init__(self):
        self._rng = np.random.default_rng(0)
        self._state = np.zeros(4, np.float32)
        self._steps = 0

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._state = self._rng.uniform(-0.05, 0.05, 4).astype(np.float32)
        self._steps = 0
        return self._state.copy()

    def step(self, action: int):
        x, x_dot, theta, theta_dot = self._state
        force = self.FORCE_MAG if action == 1 else -self.FORCE_MAG
        costh, sinth = math.cos(theta), math.sin(theta)
        total_mass = self.MASSCART + self.MASSPOLE
        polemass_length = self.MASSPOLE * self.LENGTH
        temp = (force + polemass_length * theta_dot ** 2 * sinth) / total_mass
        theta_acc = (self.GRAVITY * sinth - costh * temp) / (
            self.LENGTH * (4.0 / 3.0 - self.MASSPOLE * costh ** 2
                           / total_mass))
        x_acc = temp - polemass_length * theta_acc * costh / total_mass
        x += self.TAU * x_dot
        x_dot += self.TAU * x_acc
        theta += self.TAU * theta_dot
        theta_dot += self.TAU * theta_acc
        self._state = np.array([x, x_dot, theta, theta_dot], np.float32)
        self._steps += 1
        fell = bool(abs(x) > self.X_LIMIT or abs(theta) > self.THETA_LIMIT)
        timeout = self._steps >= self.max_episode_steps
        info = {"truncated": True} if (timeout and not fell) else {}
        return self._state.copy(), 1.0, fell or timeout, info


class Pendulum(Env):
    """Torque-controlled pendulum swing-up (continuous actions).

    Same dynamics as gym's pendulum.py (public textbook inverted-pendulum
    physics): obs = [cos th, sin th, th_dot], action = torque in [-2, 2],
    reward = -(th^2 + 0.1 th_dot^2 + 0.001 u^2). Episodes are fixed
    200-step (never "done" early). The continuous-control workhorse for
    SAC (ref analog: rllib's Pendulum-v1 tuned examples).
    """

    observation_dim = 3
    continuous = True
    action_dim = 1
    action_low = -2.0
    action_high = 2.0
    max_episode_steps = 200

    MAX_SPEED = 8.0
    MAX_TORQUE = 2.0
    DT = 0.05
    G = 10.0
    M = 1.0
    L = 1.0

    def __init__(self):
        self._rng = np.random.default_rng(0)
        self._th = 0.0
        self._th_dot = 0.0
        self._steps = 0

    def _obs(self) -> np.ndarray:
        return np.array([math.cos(self._th), math.sin(self._th),
                         self._th_dot], np.float32)

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._th = float(self._rng.uniform(-math.pi, math.pi))
        self._th_dot = float(self._rng.uniform(-1.0, 1.0))
        self._steps = 0
        return self._obs()

    def step(self, action):
        u = float(np.clip(np.asarray(action, np.float32).reshape(-1)[0],
                          -self.MAX_TORQUE, self.MAX_TORQUE))
        th, th_dot = self._th, self._th_dot
        norm_th = ((th + math.pi) % (2 * math.pi)) - math.pi
        cost = norm_th ** 2 + 0.1 * th_dot ** 2 + 0.001 * u ** 2
        th_dot = th_dot + (3.0 * self.G / (2.0 * self.L) * math.sin(th)
                           + 3.0 / (self.M * self.L ** 2) * u) * self.DT
        th_dot = float(np.clip(th_dot, -self.MAX_SPEED, self.MAX_SPEED))
        th = th + th_dot * self.DT
        self._th, self._th_dot = th, th_dot
        self._steps += 1
        # the episode only ever ends by time limit: pure truncation
        done = self._steps >= self.max_episode_steps
        return self._obs(), -cost, done, {"truncated": True} if done else {}


class StatelessGuess(Env):
    """Trivial 1-step bandit-ish env for fast unit tests: reward 1 iff the
    action matches the sign feature of the observation."""

    observation_dim = 2
    num_actions = 2
    max_episode_steps = 1

    def __init__(self):
        self._rng = np.random.default_rng(0)
        self._obs = np.zeros(2, np.float32)

    def reset(self, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        sign = 1.0 if self._rng.random() < 0.5 else -1.0
        self._obs = np.array([sign, self._rng.random()], np.float32)
        return self._obs.copy()

    def step(self, action: int):
        want = 1 if self._obs[0] > 0 else 0
        r = 1.0 if action == want else 0.0
        return self.reset(), r, True, {}


class BreakoutMini(Env):
    """MinAtar-style Breakout on a 10x10 grid (Atari-class benchmark env).

    Ref analog: the reference's RLlib Atari suites (tuned_examples/*atari*)
    run on ALE via gym; this image has neither, so the environment is a
    from-scratch miniature in the spirit of MinAtar (Young & Tian 2019):
    4 feature planes (2-wide paddle, ball, ball trail, bricks) on a
    10x10 board, 3 actions (stay/left/right), +1 per brick, episode ends
    when the ball falls past the paddle. Observation is the flattened
    400-float board — enough spatial structure that linear policies
    plateau, which is what a learner-throughput benchmark needs from
    "Atari-class". (The paddle is 2 cells: brick bounces redirect the
    ball unpredictably, and a 1-cell paddle at ball speed makes some
    rallies geometrically unwinnable.)
    """

    N = 10
    observation_dim = 4 * N * N
    num_actions = 3
    max_episode_steps = 1000

    def __init__(self):
        self._rng = np.random.default_rng(0)
        self.reset()

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        n = self.N
        self._paddle = n // 2
        self._ball_x = int(self._rng.integers(0, n))
        self._ball_y = 3
        self._dx = 1 if self._rng.random() < 0.5 else -1
        self._dy = 1
        self._trail_x, self._trail_y = self._ball_x, self._ball_y
        self._bricks = np.ones((3, n), np.bool_)
        self._steps = 0
        return self._obs()

    def _obs(self) -> np.ndarray:
        n = self.N
        planes = np.zeros((4, n, n), np.float32)
        planes[0, n - 1, self._paddle] = 1.0
        planes[0, n - 1, min(self._paddle + 1, n - 1)] = 1.0
        planes[1, self._ball_y, self._ball_x] = 1.0
        planes[2, self._trail_y, self._trail_x] = 1.0
        planes[3, :3, :] = self._bricks
        return planes.reshape(-1)

    def step(self, action: int):
        n = self.N
        if action == 1:
            self._paddle = max(0, self._paddle - 1)
        elif action == 2:
            self._paddle = min(n - 2, self._paddle + 1)
        self._trail_x, self._trail_y = self._ball_x, self._ball_y
        nx = self._ball_x + self._dx
        ny = self._ball_y + self._dy
        if nx < 0 or nx >= n:  # side wall
            self._dx = -self._dx
            nx = self._ball_x + self._dx
        reward = 0.0
        if ny < 0:  # ceiling
            self._dy = 1
            ny = self._ball_y + self._dy
        if ny < 3 and self._bricks[ny, nx]:  # brick hit
            self._bricks[ny, nx] = False
            reward = 1.0
            self._dy = -self._dy
            ny = self._ball_y + self._dy
        done = False
        if ny == n - 1:  # paddle row (paddle covers 2 cells)
            if nx in (self._paddle, self._paddle + 1):
                self._dy = -1
                ny = self._ball_y + self._dy
            else:
                done = True  # ball lost
        if not self._bricks.any():  # cleared: fresh wall, keep going
            self._bricks[:] = True
        self._ball_x, self._ball_y = nx, ny
        self._steps += 1
        timeout = self._steps >= self.max_episode_steps
        info = {"truncated": True} if (timeout and not done) else {}
        return self._obs(), reward, done or timeout, info


class ContextualBandit(Env):
    """Linear contextual bandit: one-step episodes, K arms whose expected
    reward is a fixed hidden linear function of the context.

    Ref analog: rllib/env/wrappers + the bandit envs under
    rllib/examples/env/bandit_envs_discrete.py — redesigned minimal: the
    env owns hidden arm vectors theta_k; reward = theta_k . x + noise;
    ``best_mean`` is exposed so tests measure regret exactly.
    """

    CONTEXT_DIM = 8
    NUM_ARMS = 5
    observation_dim = CONTEXT_DIM
    num_actions = NUM_ARMS
    max_episode_steps = 1

    def __init__(self):
        self._rng = np.random.default_rng(0)
        theta_rng = np.random.default_rng(1234)  # fixed task
        self.theta = theta_rng.normal(
            size=(self.NUM_ARMS, self.CONTEXT_DIM)).astype(np.float32)
        self.theta /= np.linalg.norm(self.theta, axis=1, keepdims=True)
        self.noise = 0.1
        self._ctx = np.zeros(self.CONTEXT_DIM, np.float32)

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._ctx = self._rng.normal(
            size=self.CONTEXT_DIM).astype(np.float32)
        self._ctx /= max(np.linalg.norm(self._ctx), 1e-8)
        return self._ctx.copy()

    def means(self) -> np.ndarray:
        return self.theta @ self._ctx

    def step(self, action: int):
        means = self.means()
        r = float(means[action] + self._rng.normal() * self.noise)
        info = {"regret": float(means.max() - means[action])}
        return self.reset(), r, True, info


_REGISTRY: Dict[str, Callable[[], Env]] = {
    "CartPole-v1": CartPole,
    "Pendulum-v1": Pendulum,
    "StatelessGuess-v0": StatelessGuess,
    "Breakout-Mini-v0": BreakoutMini,
    "ContextualBandit-v0": ContextualBandit,
}


def register_env(name: str, creator: Callable[[], Env]):
    """Custom env registration (ref: rllib tune.register_env)."""
    _REGISTRY[name] = creator


def make_env(name_or_creator) -> Env:
    if callable(name_or_creator):
        return name_or_creator()
    try:
        return _REGISTRY[name_or_creator]()
    except KeyError:
        raise KeyError(
            f"unknown env {name_or_creator!r}; registered: "
            f"{sorted(_REGISTRY)}") from None


class VectorEnv:
    """N env copies stepped together with auto-reset on done.

    Ref analog: rllib/env/vector_env.py:37 (_VectorizedGymEnv); completed
    episode returns/lengths are surfaced for metrics.
    """

    def __init__(self, creator, num_envs: int, seed: int = 0):
        self.envs: List[Env] = [make_env(creator) for _ in range(num_envs)]
        self.num_envs = num_envs
        self.obs = np.stack([e.reset(seed + i)
                             for i, e in enumerate(self.envs)])
        self._ep_rew = np.zeros(num_envs, np.float64)
        self._ep_len = np.zeros(num_envs, np.int64)
        self.episode_returns: List[float] = []
        self.episode_lengths: List[int] = []
        # per-step truncation view (time-limit "done"s that must still
        # bootstrap, ref: postprocessing's TimeLimit handling) and the
        # PRE-reset terminal observation for done envs
        self.truncateds = np.zeros(num_envs, np.bool_)
        self.final_obs = self.obs.copy()

    @property
    def observation_dim(self) -> int:
        return self.envs[0].observation_dim

    @property
    def num_actions(self) -> int:
        return self.envs[0].num_actions

    @property
    def continuous(self) -> bool:
        return self.envs[0].continuous

    @property
    def action_dim(self) -> int:
        return self.envs[0].action_dim

    def step(self, actions: np.ndarray):
        """-> (next_obs [N,D], rewards [N], dones [N]).

        ``actions`` is int [N] for discrete envs, float32 [N, action_dim]
        for continuous ones.
        """
        cont = self.continuous
        obs_out = np.empty_like(self.obs)
        rews = np.zeros(self.num_envs, np.float32)
        dones = np.zeros(self.num_envs, np.bool_)
        self.truncateds = np.zeros(self.num_envs, np.bool_)
        for i, env in enumerate(self.envs):
            o, r, d, info = env.step(
                np.asarray(actions[i], np.float32) if cont
                else int(actions[i]))
            self._ep_rew[i] += r
            self._ep_len[i] += 1
            self.final_obs[i] = o
            if d:
                self.truncateds[i] = bool(info.get("truncated", False))
                self.episode_returns.append(float(self._ep_rew[i]))
                self.episode_lengths.append(int(self._ep_len[i]))
                self._ep_rew[i] = 0.0
                self._ep_len[i] = 0
                o = env.reset()
            obs_out[i] = o
            rews[i] = r
            dones[i] = d
        self.obs = obs_out
        return obs_out.copy(), rews, dones

    def pop_episode_metrics(self) -> Tuple[List[float], List[int]]:
        rets, lens = self.episode_returns, self.episode_lengths
        self.episode_returns, self.episode_lengths = [], []
        return rets, lens
