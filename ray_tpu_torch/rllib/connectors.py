"""Observation/action connector pipeline.

Ref analogs: rllib/connectors/agent/pipeline.py (AgentConnectorPipeline
— composable transforms between env and policy) and
connectors/action/pipeline.py. Re-design, lite: connectors are plain
objects with vectorized numpy transforms ([N, ...] batches from the
VectorEnv), a pipeline composes them, and RolloutWorker applies the
pipeline on both legs (obs: env -> policy; action: policy -> env) so
env/model coupling stops being hand-rolled per algorithm. State that
must ship with weights (e.g. running normalization moments) round-trips
through get_state/set_state.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class Connector:
    """One transform. Obs connectors see [N, ...] observation batches;
    action connectors see [N, ...] action batches."""

    def transform_obs(self, obs: np.ndarray) -> np.ndarray:
        return obs

    def transform_action(self, actions: np.ndarray) -> np.ndarray:
        return actions

    def observation_dim(self, dim: int) -> int:
        """Output obs dim given input dim (policy sizing)."""
        return dim

    def get_state(self) -> dict:
        return {}

    def set_state(self, state: dict):
        pass


class FlattenObs(Connector):
    """[N, ...] -> [N, prod(...)] (image/grid envs -> MLP policies)."""

    def __init__(self, input_shape: Sequence[int]):
        self.input_shape = tuple(input_shape)

    def transform_obs(self, obs: np.ndarray) -> np.ndarray:
        return obs.reshape(obs.shape[0], -1)

    def observation_dim(self, dim: int) -> int:
        return int(np.prod(self.input_shape))


class ClipObs(Connector):
    def __init__(self, low: float = -10.0, high: float = 10.0):
        self.low, self.high = float(low), float(high)

    def transform_obs(self, obs: np.ndarray) -> np.ndarray:
        return np.clip(obs, self.low, self.high)


class NormalizeObs(Connector):
    """Running mean/std normalization (Welford over batches).

    ``frozen`` stops stat updates (evaluation). Stats are WORKER-LOCAL
    (each rollout worker normalizes from its own stream, the common
    mean-std-filter deployment); get_state/set_state exist so callers
    that need cross-worker or checkpoint consistency can move the
    moments explicitly. Ref analog: connectors/agent/mean_std_filter.py.
    """

    def __init__(self, eps: float = 1e-8):
        self.count = 0.0
        self.mean: Optional[np.ndarray] = None
        self.m2: Optional[np.ndarray] = None
        self.eps = eps
        self.frozen = False

    def transform_obs(self, obs: np.ndarray) -> np.ndarray:
        obs = np.asarray(obs, np.float64)
        if not self.frozen:
            if self.mean is None:
                self.mean = np.zeros(obs.shape[1:], np.float64)
                self.m2 = np.zeros(obs.shape[1:], np.float64)
            n = obs.shape[0]
            batch_mean = obs.mean(axis=0)
            batch_m2 = ((obs - batch_mean) ** 2).sum(axis=0)
            delta = batch_mean - self.mean
            tot = self.count + n
            self.mean = self.mean + delta * n / tot
            self.m2 = self.m2 + batch_m2 + delta ** 2 * self.count * n / tot
            self.count = tot
        if self.mean is None or self.count < 2:
            return obs.astype(np.float32)
        std = np.sqrt(self.m2 / max(self.count - 1, 1.0)) + self.eps
        return ((obs - self.mean) / std).astype(np.float32)

    def get_state(self) -> dict:
        return {"count": self.count,
                "mean": None if self.mean is None else self.mean.copy(),
                "m2": None if self.m2 is None else self.m2.copy()}

    def set_state(self, state: dict):
        self.count = state["count"]
        self.mean = state["mean"]
        self.m2 = state["m2"]


class ClipAction(Connector):
    """Clamp continuous actions into the env's bounds (ref:
    connectors/action/clip.py)."""

    def __init__(self, low: float, high: float):
        self.low, self.high = float(low), float(high)

    def transform_action(self, actions: np.ndarray) -> np.ndarray:
        return np.clip(actions, self.low, self.high)


class UnsquashAction(Connector):
    """tanh-squashed policy output in [-1, 1] -> env bounds [low, high]."""

    def __init__(self, low: float, high: float):
        self.low, self.high = float(low), float(high)

    def transform_action(self, actions: np.ndarray) -> np.ndarray:
        return self.low + (np.asarray(actions) + 1.0) * 0.5 * \
            (self.high - self.low)


class ConnectorPipeline(Connector):
    """Ordered composition; obs transforms apply left-to-right, action
    transforms right-to-left (innermost closest to the policy), the
    pipeline.py convention."""

    def __init__(self, connectors: Sequence[Connector] = ()):
        self.connectors: List[Connector] = list(connectors)

    def append(self, c: Connector) -> "ConnectorPipeline":
        self.connectors.append(c)
        return self

    def transform_obs(self, obs: np.ndarray) -> np.ndarray:
        for c in self.connectors:
            obs = c.transform_obs(obs)
        return obs

    def transform_action(self, actions: np.ndarray) -> np.ndarray:
        for c in reversed(self.connectors):
            actions = c.transform_action(actions)
        return actions

    def observation_dim(self, dim: int) -> int:
        for c in self.connectors:
            dim = c.observation_dim(dim)
        return dim

    def get_state(self) -> List[dict]:
        return [c.get_state() for c in self.connectors]

    def set_state(self, states: List[dict]):
        for c, s in zip(self.connectors, states):
            c.set_state(s)

    def set_frozen(self, flag: bool):
        """Stop/resume stat updates on every stateful member (eval, or
        transforming auxiliary arrays like s' that must not be counted
        twice)."""
        for c in self.connectors:
            if hasattr(c, "frozen"):
                c.frozen = flag
