"""SampleBatch: the dict-of-arrays currency between rollouts and learners.

Ref analog: rllib/policy/sample_batch.py:98 (SampleBatch) — re-designed as a
thin numpy container with exactly the operations the learner needs:
concat, shuffle, minibatch iteration. Column names match the reference's.
"""

from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np

OBS = "obs"
NEXT_OBS = "new_obs"
ACTIONS = "actions"
REWARDS = "rewards"
DONES = "dones"
ACTION_LOGP = "action_logp"
VF_PREDS = "vf_preds"
ADVANTAGES = "advantages"
VALUE_TARGETS = "value_targets"
BEHAVIOUR_LOGITS = "behaviour_logits"


class SampleBatch(dict):
    @property
    def count(self) -> int:
        for v in self.values():
            return len(v)
        return 0

    def shuffle(self, rng: np.random.Generator) -> "SampleBatch":
        perm = rng.permutation(self.count)
        return SampleBatch({k: v[perm] for k, v in self.items()})

    def minibatches(self, size: int) -> Iterator["SampleBatch"]:
        n = self.count
        for start in range(0, n - size + 1, size):
            yield SampleBatch({k: v[start:start + size]
                               for k, v in self.items()})

    def slice(self, start: int, end: int) -> "SampleBatch":
        return SampleBatch({k: v[start:end] for k, v in self.items()})


def concat_samples(batches: List[SampleBatch]) -> SampleBatch:
    keys = batches[0].keys()
    return SampleBatch({k: np.concatenate([b[k] for b in batches])
                        for k in keys})


def compute_gae(rewards: np.ndarray, values: np.ndarray, dones: np.ndarray,
                last_value: np.ndarray, gamma: float, lam: float):
    """Generalized Advantage Estimation over [T, N] rollout arrays.

    Ref analog: rllib/evaluation/postprocessing.py compute_advantages —
    computed on the rollout worker so the learner sees ready advantages.
    Returns (advantages [T,N], value_targets [T,N]).
    """
    T = rewards.shape[0]
    adv = np.zeros_like(rewards)
    last_gae = np.zeros_like(last_value)
    next_value = last_value
    for t in range(T - 1, -1, -1):
        nonterminal = 1.0 - dones[t].astype(np.float32)
        delta = rewards[t] + gamma * next_value * nonterminal - values[t]
        last_gae = delta + gamma * lam * nonterminal * last_gae
        adv[t] = last_gae
        next_value = values[t]
    return adv, adv + values
