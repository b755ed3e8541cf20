"""AlphaZero: self-play MCTS + policy/value network (Silver et al. 2017).

Ref analog: rllib/algorithms/alpha_zero/ — MCTS-guided self-play on a
perfect-information game, training a shared policy+value net on
(state, mcts_policy, outcome) tuples. Self-play workers are CPU actors
evaluating leaves with a NUMPY forward of the tiny net (single-position
MCTS evals are latency-bound — a launch per node would be dominated by
dispatch), while the learner's update (policy cross-entropy + value MSE
+ L2, Adam) runs in PyTorch on the learner's device: the card unless the
caller asks for the CPU. Weights cross the object plane as numpy dicts,
like every other algorithm here; the net starts from
``np.random.default_rng(seed)``, so the seed alone fixes it.

The built-in game is TicTacToe (canonical two-plane board encoding from
the side-to-move's perspective) — the smallest game whose optimal play
is learnable in a CI-sized test, mirroring how the reference's
alpha_zero tests use toy envs (cartpole-with-MCTS) rather than Go.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

import torch

import ray_tpu_torch
from ray_tpu_torch._device import resolve_device

from .algorithm import Algorithm, AlgorithmConfig
from .learner import adam, value_and_grad
from .models import params_from_numpy, to_numpy

# ---------------------------------------------------------------- game


class TicTacToe:
    """Perfect-information 2-player game with the canonical interface
    MCTS needs: state is a length-9 int8 vector in {-1, 0, +1} from the
    perspective of the player to move (+1 = own stones)."""

    num_actions = 9
    observation_dim = 18  # two planes: own stones, opponent stones

    _LINES = ((0, 1, 2), (3, 4, 5), (6, 7, 8), (0, 3, 6), (1, 4, 7),
              (2, 5, 8), (0, 4, 8), (2, 4, 6))

    @staticmethod
    def initial() -> np.ndarray:
        return np.zeros(9, np.int8)

    @staticmethod
    def legal(state: np.ndarray) -> np.ndarray:
        return state == 0

    @staticmethod
    def step(state: np.ndarray, action: int) -> np.ndarray:
        """Apply own move, then flip perspective to the next player."""
        nxt = state.copy()
        nxt[action] = 1
        return -nxt

    @classmethod
    def outcome(cls, state: np.ndarray) -> Optional[float]:
        """Terminal value FROM THE PERSPECTIVE OF THE PLAYER TO MOVE:
        -1 if the previous move won (opponent stones, -1 here, line up),
        0 for a draw, None if the game continues."""
        for a, b, c in cls._LINES:
            s = int(state[a]) + int(state[b]) + int(state[c])
            if s == -3:
                return -1.0
        if not (state == 0).any():
            return 0.0
        return None

    @staticmethod
    def encode(state: np.ndarray) -> np.ndarray:
        return np.concatenate([(state == 1), (state == -1)]).astype(
            np.float32)


_GAMES = {"tictactoe": TicTacToe}

# ------------------------------------------------------------- network


def _init_net(rng: np.random.Generator, obs_dim: int, num_actions: int,
              hiddens: Tuple[int, ...]) -> Dict[str, np.ndarray]:
    w, sizes = {}, (obs_dim,) + tuple(hiddens)
    for i in range(len(hiddens)):
        fan_in = sizes[i]
        w[f"w{i}"] = rng.normal(
            0, math.sqrt(2.0 / fan_in), (sizes[i], sizes[i + 1])
        ).astype(np.float32)
        w[f"b{i}"] = np.zeros(sizes[i + 1], np.float32)
    h = hiddens[-1]
    w["wp"] = rng.normal(0, 0.01, (h, num_actions)).astype(np.float32)
    w["bp"] = np.zeros(num_actions, np.float32)
    w["wv"] = rng.normal(0, 0.01, (h, 1)).astype(np.float32)
    w["bv"] = np.zeros(1, np.float32)
    w["__n_hidden__"] = np.int64(len(hiddens))
    return w


def _np_forward(w: Dict[str, np.ndarray], obs: np.ndarray
                ) -> Tuple[np.ndarray, float]:
    """Numpy policy/value forward for single-position MCTS leaf evals."""
    h = obs
    for i in range(int(w["__n_hidden__"])):
        h = np.maximum(h @ w[f"w{i}"] + w[f"b{i}"], 0.0)
    logits = h @ w["wp"] + w["bp"]
    logits = logits - logits.max()
    p = np.exp(logits)
    p /= p.sum()
    v = float(np.tanh(h @ w["wv"] + w["bv"])[0])
    return p, v


# ---------------------------------------------------------------- MCTS


class MCTS:
    """PUCT search over the game tree; values are always from the
    perspective of the node's player-to-move (negamax backup)."""

    def __init__(self, game, weights, *, sims: int = 64, c_puct: float = 1.5,
                 dirichlet_alpha: float = 0.6, noise_frac: float = 0.25,
                 rng: Optional[np.random.Generator] = None):
        self.game = game
        self.w = weights
        self.sims = sims
        self.c = c_puct
        self.alpha = dirichlet_alpha
        self.noise_frac = noise_frac
        self.rng = rng or np.random.default_rng()

    def policy(self, state: np.ndarray, temperature: float = 1.0
               ) -> np.ndarray:
        """Run sims; return the visit-count policy at the root."""
        root = _Node(prior=1.0)
        self._expand(root, state)
        if root.children:  # root exploration noise (self-play diversity)
            noise = self.rng.dirichlet(
                [self.alpha] * len(root.children))
            for i, ch in enumerate(root.children.values()):
                ch.prior = (1 - self.noise_frac) * ch.prior \
                    + self.noise_frac * noise[i]
        for _ in range(self.sims):
            self._simulate(root, state)
        counts = np.zeros(self.game.num_actions, np.float32)
        for a, ch in root.children.items():
            counts[a] = ch.visits
        if temperature < 1e-3:
            out = np.zeros_like(counts)
            out[int(counts.argmax())] = 1.0
            return out
        counts = counts ** (1.0 / temperature)
        return counts / counts.sum()

    def _expand(self, node: "_Node", state: np.ndarray) -> float:
        term = self.game.outcome(state)
        if term is not None:
            node.terminal = term
            return term
        p, v = _np_forward(self.w, self.game.encode(state))
        legal = self.game.legal(state)
        p = p * legal
        total = p.sum()
        p = p / total if total > 1e-8 else legal / legal.sum()
        for a in np.flatnonzero(legal):
            node.children[int(a)] = _Node(prior=float(p[a]))
        return v

    def _simulate(self, node: "_Node", state: np.ndarray) -> float:
        """One descent; returns the value from ``state``'s perspective."""
        if node.terminal is not None:
            node.visits += 1
            node.value_sum += node.terminal
            return node.terminal
        if not node.children:  # leaf: expand + evaluate
            v = self._expand(node, state)
            node.visits += 1
            node.value_sum += v
            return v
        sqrt_n = math.sqrt(node.visits)
        best, best_score = None, -1e9
        for a, ch in node.children.items():
            q = (ch.value_sum / ch.visits) if ch.visits else 0.0
            # child value is from the OPPONENT's perspective
            score = -q + self.c * ch.prior * sqrt_n / (1 + ch.visits)
            if score > best_score:
                best, best_score = a, score
        child = node.children[best]
        v = -self._simulate(child, self.game.step(state, best))
        node.visits += 1
        node.value_sum += v
        return v


class _Node:
    __slots__ = ("prior", "visits", "value_sum", "children", "terminal")

    def __init__(self, prior: float):
        self.prior = prior
        self.visits = 0
        self.value_sum = 0.0
        self.children: Dict[int, _Node] = {}
        self.terminal: Optional[float] = None


# ------------------------------------------------------------ learner


class AlphaZeroLearner:
    """Policy-CE + value-MSE + L2 Adam update on one device."""

    def __init__(self, obs_dim: int, num_actions: int,
                 hiddens=(64, 64), lr=1e-2, l2=1e-4, seed=0, device=None):
        self.device = resolve_device(device)
        self.num_actions = num_actions
        self._np = _init_net(np.random.default_rng(seed), obs_dim,
                             num_actions, tuple(hiddens))
        self._n_hidden = int(self._np.pop("__n_hidden__"))
        self._opt = adam(lr)
        params = params_from_numpy(self._np, self.device)
        self._state = (params, self._opt.init(params))
        self.l2 = l2

    def loss_fn(self, params, obs, pi, z):
        h = obs
        for i in range(self._n_hidden):
            h = torch.relu(h @ params[f"w{i}"] + params[f"b{i}"])
        logits = h @ params["wp"] + params["bp"]
        v = torch.tanh(h @ params["wv"] + params["bv"])[:, 0]
        logp = torch.log_softmax(logits, dim=-1)
        policy_loss = -torch.mean(torch.sum(pi * logp, dim=-1))
        value_loss = torch.mean((v - z) ** 2)
        # every leaf whose name starts with "w": the heads' wp and wv too
        l2_loss = sum(torch.sum(params[k] ** 2) for k in sorted(params)
                      if k.startswith("w"))
        return policy_loss + value_loss + self.l2 * l2_loss, (
            policy_loss, value_loss)

    def train_step(self, obs, pi, z) -> tuple:
        """One Adam step on tensors on the device -> (metrics, grads)."""
        params, opt_state = self._state
        loss, (pl, vl), grads = value_and_grad(self.loss_fn, params, obs,
                                               pi, z)
        self._opt.step_(grads, opt_state, params)
        return {"total_loss": loss, "policy_loss": pl,
                "value_loss": vl}, grads

    def update(self, obs: np.ndarray, pi: np.ndarray, z: np.ndarray
               ) -> dict:
        dev = self.device
        metrics, _ = self.train_step(
            *(torch.as_tensor(np.asarray(x, np.float32), device=dev)
              for x in (obs, pi, z)))
        return {k: float(v) for k, v in metrics.items()}

    def get_weights(self) -> Dict[str, np.ndarray]:
        w = to_numpy(self._state[0])
        w["__n_hidden__"] = np.int64(self._n_hidden)
        return w


# ------------------------------------------------------ self-play actor


class SelfPlayWorker:
    """Plays G games of MCTS self-play per call; returns training
    tuples (encoded_state, mcts_policy, outcome_for_player_to_move)."""

    def __init__(self, game_name: str, sims: int, temperature_moves: int,
                 seed: int = 0):
        self.game = _GAMES[game_name]
        self.sims = sims
        self.temp_moves = temperature_moves
        self.rng = np.random.default_rng(seed)
        self.weights: Optional[dict] = None
        torch.set_num_threads(1)

    def set_weights(self, w: dict):
        self.weights = dict(w)

    def get_weights(self) -> Optional[dict]:
        return self.weights

    def play(self, num_games: int) -> Tuple[np.ndarray, np.ndarray,
                                            np.ndarray, dict]:
        game = self.game
        all_obs: List[np.ndarray] = []
        all_pi: List[np.ndarray] = []
        all_z: List[float] = []
        lengths = []
        for _ in range(num_games):
            mcts = MCTS(game, self.weights, sims=self.sims, rng=self.rng)
            state = game.initial()
            trajectory = []  # (obs, pi) per ply, perspective-local
            move = 0
            while True:
                term = game.outcome(state)
                if term is not None:
                    # walk back: term is from the CURRENT player-to-move's
                    # perspective; alternate signs up the trajectory
                    z = term
                    for obs, pi in reversed(trajectory):
                        z = -z
                        all_obs.append(obs)
                        all_pi.append(pi)
                        all_z.append(z)
                    lengths.append(move)
                    break
                temp = 1.0 if move < self.temp_moves else 1e-4
                pi = mcts.policy(state, temperature=temp)
                trajectory.append((game.encode(state), pi))
                action = int(self.rng.choice(game.num_actions, p=pi))
                state = game.step(state, action)
                move += 1
        return (np.stack(all_obs), np.stack(all_pi),
                np.asarray(all_z, np.float32),
                {"games": num_games,
                 "mean_length": float(np.mean(lengths))})


# ---------------------------------------------------------- algorithm


class AlphaZeroConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or AlphaZero)
        self.game = "tictactoe"
        self.num_rollout_workers = 2
        self.mcts_sims = 48
        self.games_per_worker = 8
        self.temperature_moves = 4
        self.train_epochs = 4
        self.batch_size = 256
        self.model_hiddens = (64, 64)
        self.lr = 1e-2
        self.replay_capacity = 8192


class AlphaZero(Algorithm):
    _config_cls = AlphaZeroConfig

    def setup(self, config: dict):
        cfg = config.get("__algo_config__") or self.get_default_config()
        cfg = cfg.copy()
        cfg.update_from_dict(
            {k: v for k, v in config.items() if k != "__algo_config__"})
        self.algo_config = cfg
        # no card and no device="cpu": raise before any worker starts
        resolve_device(cfg.device)
        game = _GAMES[cfg.game]
        self.learner = AlphaZeroLearner(
            game.observation_dim, game.num_actions,
            hiddens=tuple(cfg.model_hiddens), lr=cfg.lr, seed=cfg.seed,
            device=cfg.device)
        worker_cls = ray_tpu_torch.remote(SelfPlayWorker)
        self.workers = [
            worker_cls.options(num_cpus=1).remote(
                cfg.game, cfg.mcts_sims, cfg.temperature_moves,
                seed=cfg.seed + 1 + i)
            for i in range(cfg.num_rollout_workers)]
        self._replay: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self._replay_size = 0
        self._rng = np.random.default_rng(cfg.seed)
        self._num_env_steps = 0
        self._sync_weights()

    def _sync_weights(self):
        w_ref = ray_tpu_torch.put(self.learner.get_weights())
        ray_tpu_torch.get([w.set_weights.remote(w_ref) for w in self.workers],
                    timeout=300)

    def training_step(self) -> dict:
        cfg = self.algo_config
        outs = ray_tpu_torch.get(
            [w.play.remote(cfg.games_per_worker) for w in self.workers],
            timeout=600)
        games = 0
        for obs, pi, z, info in outs:
            self._replay.append((obs, pi, z))
            self._replay_size += len(z)
            self._num_env_steps += len(z)
            games += info["games"]
        while self._replay_size > cfg.replay_capacity and \
                len(self._replay) > 1:
            old = self._replay.pop(0)
            self._replay_size -= len(old[2])
        obs = np.concatenate([o for o, _, _ in self._replay])
        pi = np.concatenate([p for _, p, _ in self._replay])
        z = np.concatenate([zz for _, _, zz in self._replay])
        metrics: dict = {}
        n = len(z)
        for _ in range(cfg.train_epochs):
            idx = self._rng.permutation(n)[:cfg.batch_size]
            metrics = self.learner.update(obs[idx], pi[idx], z[idx])
        self._sync_weights()
        metrics.update(games_this_iter=games, replay_size=n,
                       env_steps_this_iter=n)
        return metrics

    def step(self) -> dict:
        metrics = self.training_step()
        metrics["num_env_steps_sampled"] = self._num_env_steps
        return metrics

    def save_checkpoint(self):
        return {"weights": self.learner.get_weights(),
                "num_env_steps": self._num_env_steps}

    def load_checkpoint(self, checkpoint):
        if checkpoint:
            w = dict(checkpoint["weights"])
            n_hidden = int(w.pop("__n_hidden__"))
            params = params_from_numpy(w, self.learner.device)
            self.learner._n_hidden = n_hidden
            self.learner._state = (params,
                                   self.learner._opt.init(params))
            self._num_env_steps = checkpoint.get("num_env_steps", 0)
            self._sync_weights()

    def cleanup(self):
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass

    # -------- evaluation helper (greedy MCTS move for play/eval) --------

    def compute_single_action(self, state: np.ndarray,
                              sims: Optional[int] = None) -> int:
        game = _GAMES[self.algo_config.game]
        mcts = MCTS(game, self.learner.get_weights(),
                    sims=sims or self.algo_config.mcts_sims,
                    noise_frac=0.0, rng=self._rng)
        return int(mcts.policy(state, temperature=1e-4).argmax())
