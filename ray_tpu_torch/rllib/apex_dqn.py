"""Ape-X DQN: distributed prioritized replay as sharded replay ACTORS.

Ref analog: rllib/algorithms/apex_dqn/apex_dqn.py (ApexDQN — rollout
workers push samples into ReplayActor shards, the learner pulls batches
and pushes priority updates back asynchronously, target net syncs on an
env-step cadence). Re-design on this runtime: replay shards are plain
``@remote`` actors wrapping PrioritizedReplayBuffer; the transfer of
fresh sample batches rides the OBJECT PLANE (the worker's batch object
ref is passed to the shard actor, which resolves it store-to-store —
the driver never copies the data), and the learner stays local, on the card
unless the config asks for the CPU, like DQN's (the Ape-X split of
concerns: actors explore, shards remember, one learner burns FLOPs).
Replay shards are CPU actors with numpy storage; ``Algorithm.setup``
resolves the learner's device before any actor starts.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

import ray_tpu_torch

from .algorithm import Algorithm
from .dqn import DQN, DQNConfig
from .replay_buffers import PrioritizedReplayBuffer
from .sample_batch import SampleBatch


class ApexDQNConfig(DQNConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or ApexDQN)
        self.num_replay_shards = 2
        # per-worker exploration: worker i uses eps_i = base ** (1 + i/N)
        # (the Ape-X constant-per-actor epsilon ladder), instead of one
        # global annealed epsilon
        self.per_worker_epsilon_base = 0.4


class ReplayShard:
    """One replay shard actor: add / sample / update_priorities.

    Samples are returned WITH their shard-local indexes; the learner
    routes priority updates back to the shard each batch came from."""

    def __init__(self, capacity: int, alpha: float, seed: int = 0):
        torch.set_num_threads(1)  # a CPU actor on half a CPU's lease
        self.buf = PrioritizedReplayBuffer(capacity, alpha=alpha,
                                           seed=seed)

    def add(self, batch: SampleBatch) -> int:
        # `batch` arrives as a resolved object-plane ref (the rollout
        # worker produced it; this actor pulled it store-to-store)
        self.buf.add(batch)
        return len(self.buf)

    def size(self) -> int:
        return len(self.buf)

    def sample(self, n: int, beta: float):
        return self.buf.sample(n, beta=beta)

    def update_priorities(self, idx, prios):
        self.buf.update_priorities(np.asarray(idx), np.asarray(prios))

    def num_added(self) -> int:
        return self.buf.num_added

    def stats(self) -> dict:
        return self.buf.stats()

    def priority_stats(self) -> dict:
        """The largest priority seen and the priority tree's total: 1.0
        and the size until the learner's |TD| priorities arrive."""
        return {"max_priority": float(self.buf._max_priority),
                "total": float(self.buf._sum_tree[1]),
                "size": len(self.buf)}


class ApexDQN(DQN):
    _config_cls = ApexDQNConfig

    def setup(self, config):
        Algorithm.setup(self, config)  # skip DQN's local-buffer setup
        cfg = self.algo_config
        shard_cls = ray_tpu_torch.remote(ReplayShard)
        self.replay_shards: List = [
            shard_cls.options(num_cpus=0.5).remote(
                max(1, cfg.replay_buffer_capacity
                    // cfg.num_replay_shards),
                cfg.prioritized_replay_alpha, seed=cfg.seed + 101 * i)
            for i in range(cfg.num_replay_shards)
        ]
        self._last_target_sync = 0
        self._shard_rr = 0  # round-robin push cursor
        self._rng = np.random.default_rng(cfg.seed + 7)

    def _worker_epsilons(self) -> List[float]:
        cfg = self.algo_config
        n = max(len(self.workers), 1)
        return [cfg.per_worker_epsilon_base ** (1 + i / max(n - 1, 1) * 7)
                for i in range(n)]

    def training_step(self) -> dict:
        cfg = self.algo_config
        # 1. parallel exploration with per-worker epsilons; each worker's
        #    batch ref is handed STRAIGHT to a replay shard (object-plane
        #    transfer, no driver copy)
        eps = self._worker_epsilons()
        sample_refs = [w.sample_transitions.remote(e)
                       for w, e in zip(self.workers, eps)]
        add_refs = []
        for ref in sample_refs:
            shard = self.replay_shards[self._shard_rr
                                       % len(self.replay_shards)]
            self._shard_rr += 1
            add_refs.append(shard.add.remote(ref))
        ray_tpu_torch.get(add_refs, timeout=300)  # barrier: all pushes landed
        # one consistent size sample per shard (summing per-push returns
        # would double-count shards pushed more than once this iter)
        sizes = ray_tpu_torch.get(
            [s.size.remote() for s in self.replay_shards], timeout=60)
        steps = cfg.rollout_fragment_length * cfg.num_envs_per_worker \
            * len(self.workers)
        self._num_env_steps += steps
        metrics = {"env_steps_this_iter": steps,
                   "replay_size": int(sum(sizes)),
                   "worker_epsilons": [round(e, 4) for e in eps]}

        added = sum(ray_tpu_torch.get(
            [s.num_added.remote() for s in self.replay_shards],
            timeout=60))
        learner = self.learners.local
        if added >= cfg.num_steps_sampled_before_learning_starts:
            losses = []
            for _ in range(cfg.num_updates_per_iter):
                # 2. pull a batch from a random shard, learn, route |TD|
                #    priorities back to THAT shard (async — the next pull
                #    overlaps the update)
                shard = self.replay_shards[
                    int(self._rng.integers(len(self.replay_shards)))]
                sample = ray_tpu_torch.get(
                    shard.sample.remote(cfg.train_batch_size,
                                        cfg.prioritized_replay_beta),
                    timeout=60)
                if sample is None:
                    break
                out = learner.update(sample)
                losses.append(out["loss"])
                shard.update_priorities.remote(
                    sample["batch_indexes"], out["td_abs"])
            if losses:
                metrics["loss"] = float(np.mean(losses))
            if self._num_env_steps - self._last_target_sync >= \
                    cfg.target_network_update_freq:
                learner.sync_target()
                self._last_target_sync = self._num_env_steps
            self._sync_weights()
        return metrics
