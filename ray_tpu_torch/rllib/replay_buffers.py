"""Replay buffers: uniform ring + proportional prioritized.

Ref analogs: rllib/utils/replay_buffers/replay_buffer.py:71 (ReplayBuffer:
add/sample/len, ring storage) and prioritized_replay_buffer.py:19
(PrioritizedReplayBuffer: proportional sampling with importance weights,
alpha/beta annealing). Re-designed storage: instead of a deque of episode
objects, columns are preallocated numpy arrays (SampleBatch columns), so
sample() is one vectorized gather that feeds the learner without
Python-loop assembly — the learner wants one contiguous batch.
The priority tree is a flat numpy segment tree (O(log n) updates,
vectorized prefix-sum sampling).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .sample_batch import SampleBatch


class ReplayBuffer:
    """Uniform-sampling ring buffer over SampleBatch columns."""

    def __init__(self, capacity: int = 100_000, seed: int = 0):
        self.capacity = int(capacity)
        self._cols: Dict[str, np.ndarray] = {}
        self._next = 0
        self._size = 0
        self._rng = np.random.default_rng(seed)
        self._num_added = 0

    def __len__(self) -> int:
        return self._size

    @property
    def num_added(self) -> int:
        return self._num_added

    def _ensure_storage(self, batch: SampleBatch):
        for k, v in batch.items():
            if k not in self._cols:
                v = np.asarray(v)
                self._cols[k] = np.zeros((self.capacity,) + v.shape[1:],
                                         v.dtype)

    def add(self, batch: SampleBatch):
        """Append a batch of transitions (vectorized ring write)."""
        n = batch.count
        if n == 0:
            return
        self._ensure_storage(batch)
        idx = (self._next + np.arange(n)) % self.capacity
        for k, v in batch.items():
            self._cols[k][idx] = np.asarray(v)[:n]
        self._next = int((self._next + n) % self.capacity)
        self._size = int(min(self._size + n, self.capacity))
        self._num_added += n
        return idx

    def sample(self, num_items: int) -> Optional[SampleBatch]:
        if self._size == 0:
            return None
        idx = self._rng.integers(0, self._size, size=num_items)
        out = SampleBatch({k: c[idx] for k, c in self._cols.items()})
        out["batch_indexes"] = idx
        return out

    def update_priorities(self, idx, priorities):  # uniform: no-op
        pass

    def stats(self) -> dict:
        return {"size": self._size, "num_added": self._num_added,
                "capacity": self.capacity}


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritized replay (alpha exponent, beta IS weights).

    Priorities live in a flat binary-indexed segment tree so sampling N
    items is N vectorized descents (ref: utils/replay_buffers/
    prioritized_replay_buffer.py + execution/segment_tree.py)."""

    def __init__(self, capacity: int = 100_000, *, alpha: float = 0.6,
                 seed: int = 0):
        super().__init__(capacity, seed)
        if alpha <= 0:
            raise ValueError("alpha must be positive")
        self._alpha = alpha
        # full binary tree over `capacity` leaves, 1-indexed internal nodes
        self._tree_size = 1
        while self._tree_size < self.capacity:
            self._tree_size *= 2
        self._sum_tree = np.zeros(2 * self._tree_size, np.float64)
        self._max_priority = 1.0

    # ------------------------------------------------------ tree ops

    def _set_priorities(self, idx: np.ndarray, prios: np.ndarray):
        if len(idx) == 0:
            return
        pos = idx + self._tree_size
        self._sum_tree[pos] = prios
        # propagate sums up, one vectorized recompute per level; stop at
        # the root (pos==1) — capacity==1 puts leaves AT the root, where
        # there is nothing to propagate
        pos = np.unique(pos // 2)
        while len(pos) and pos[-1] >= 1:
            pos = pos[pos >= 1]
            self._sum_tree[pos] = (self._sum_tree[2 * pos]
                                   + self._sum_tree[2 * pos + 1])
            if pos[0] == 1 and len(pos) == 1:
                break
            pos = np.unique(pos // 2)

    def _sample_indices(self, n: int) -> np.ndarray:
        total = self._sum_tree[1]
        # stratified prefix targets (lower variance than iid uniforms)
        seg = total / n
        targets = (np.arange(n) + self._rng.random(n)) * seg
        pos = np.ones(n, np.int64)
        while pos[0] < self._tree_size:
            left = 2 * pos
            left_sum = self._sum_tree[left]
            go_right = targets > left_sum
            targets = np.where(go_right, targets - left_sum, targets)
            pos = np.where(go_right, left + 1, left)
        return pos - self._tree_size

    # ----------------------------------------------------- buffer API

    def add(self, batch: SampleBatch):
        n = batch.count
        if n == 0:
            return
        idx = super().add(batch)
        self._set_priorities(
            np.asarray(idx),
            np.full(len(idx), self._max_priority ** self._alpha))
        return idx

    def sample(self, num_items: int, beta: float = 0.4
               ) -> Optional[SampleBatch]:
        if self._size == 0 or self._sum_tree[1] <= 0:
            return None
        idx = np.minimum(self._sample_indices(num_items), self._size - 1)
        out = SampleBatch({k: c[idx] for k, c in self._cols.items()})
        out["batch_indexes"] = idx
        # importance-sampling weights, normalized by the max weight
        probs = self._sum_tree[idx + self._tree_size] / self._sum_tree[1]
        weights = (self._size * np.maximum(probs, 1e-12)) ** (-beta)
        out["weights"] = (weights / weights.max()).astype(np.float32)
        return out

    def update_priorities(self, idx, priorities):
        prios = np.maximum(np.asarray(priorities, np.float64), 1e-6)
        self._max_priority = max(self._max_priority, float(prios.max()))
        self._set_priorities(np.asarray(idx, np.int64),
                             prios ** self._alpha)
