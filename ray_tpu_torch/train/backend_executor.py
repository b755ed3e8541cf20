"""BackendExecutor: drives the worker gang through a training run.

Ref analog: train/_internal/backend_executor.py:47 (start :106,
start_training :345) — spawns the WorkerGroup, runs the backend's rendezvous
(a torch.distributed process group), installs per-rank sessions, and
streams back reported results round by round.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train.backend import BackendConfig, TorchConfig
from ray_tpu_torch.train.session import TrainContext
from ray_tpu_torch.train.worker_group import WorkerGroup


class TrainingWorkerError(RuntimeError):
    """A worker failed mid-training; carries the underlying cause."""


class BackendExecutor:
    def __init__(self, backend_config: Optional[BackendConfig],
                 num_workers: int,
                 resources_per_worker: Dict[str, float],
                 placement_strategy: str = "PACK"):
        self._backend_config = backend_config or TorchConfig()
        self._backend = self._backend_config.backend_cls()
        self._num_workers = num_workers
        self._resources = resources_per_worker
        self._strategy = placement_strategy
        self.worker_group: Optional[WorkerGroup] = None

    def start(self):
        self.worker_group = WorkerGroup(self._num_workers, self._resources,
                                        self._strategy)
        self._backend.on_start(self.worker_group, self._backend_config)

    def start_training(self, train_fn: Callable, config: Dict[str, Any],
                       checkpoint=None, dataset_shards=None,
                       experiment_name: str = "", trial_id: str = ""):
        assert self.worker_group is not None, "call start() first"
        self._done_ranks = set()
        n = self._num_workers
        refs = []
        for rank, w in enumerate(self.worker_group.workers):
            ctx = TrainContext(
                world_rank=rank, world_size=n, local_rank=0,
                local_world_size=1, node_rank=rank,
                experiment_name=experiment_name, trial_id=trial_id,
                coordinator_address=getattr(self._backend,
                                            "coordinator_address", ""))
            shard = None
            if dataset_shards is not None:
                shard = {name: shards[rank]
                         for name, shards in dataset_shards.items()}
            refs.append(w.init_session.remote(
                train_fn, config, ctx, checkpoint, shard))
        ray_tpu_torch.get(refs)
        self._backend.on_training_start(self.worker_group,
                                        self._backend_config)
        ray_tpu_torch.get([w.start_training.remote()
                           for w in self.worker_group.workers])

    def next_results(self) -> Optional[List[Any]]:
        """One round: the next result from every still-running worker
        (lock-step, like the reference's TrainingIterator). None once all
        workers are done. Workers that already returned their 'done'
        sentinel are not polled again (their queues are empty — polling
        would block forever on uneven loop lengths)."""
        assert self.worker_group is not None
        if not hasattr(self, "_done_ranks"):
            self._done_ranks = set()
        live = [(rank, w)
                for rank, w in enumerate(self.worker_group.workers)
                if rank not in self._done_ranks]
        if not live:
            return None
        try:
            results = ray_tpu_torch.get([w.get_next.remote()
                                         for _, w in live])
        except Exception as e:  # worker raised or died
            raise TrainingWorkerError(str(e)) from e
        reports = []
        for (rank, _), (kind, payload) in zip(live, results):
            if kind == "done":
                self._done_ranks.add(rank)
            else:
                reports.append(payload)
        if not reports:
            return None if len(self._done_ranks) == self._num_workers \
                else self.next_results()
        return reports

    def shutdown(self):
        if self.worker_group is not None:
            self._backend.on_shutdown(self.worker_group,
                                      self._backend_config)
            self.worker_group.shutdown()
            self.worker_group = None
