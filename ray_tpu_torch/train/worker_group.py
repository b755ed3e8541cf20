"""WorkerGroup: the gang of train-worker actors.

Ref analog: train/_internal/worker_group.py:101 — one actor per worker,
placed in the ScalingConfig's placement group so the gang is co-scheduled
(gang semantics; SURVEY.md §2.3 placement groups). A worker that leases
GPUs sees only its own cards (``CUDA_VISIBLE_DEVICES``).
"""

from __future__ import annotations

import socket
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train.session import (
    TrainContext,
    TrainSession,
    _set_session,
)


class RayTrainWorker:
    """Actor hosting one training process."""

    def __init__(self):
        self._session: Optional[TrainSession] = None

    # environment probes used by the backend for rendezvous
    def get_address(self) -> str:
        return socket.gethostbyname(socket.gethostname())

    def find_free_port(self) -> int:
        with socket.socket() as s:
            s.bind(("", 0))
            return s.getsockname()[1]

    def set_env(self, env: Dict[str, str]):
        import os

        os.environ.update(env)

    def execute(self, fn: Callable, *args, **kwargs):
        """Run an arbitrary function in the worker process."""
        return fn(*args, **kwargs)

    def init_session(self, train_fn, config, context: TrainContext,
                     checkpoint=None, dataset_shard=None):
        self._session = TrainSession(train_fn, config, context,
                                     checkpoint=checkpoint,
                                     dataset_shard=dataset_shard)
        _set_session(self._session)

    def start_training(self):
        assert self._session is not None
        self._session.start()

    def get_next(self, timeout: Optional[float] = None):
        """Returns the next ("report"|"done"|"error", payload) tuple.

        Errors are re-raised here so the driver's `ray.get` surfaces them
        with the worker's traceback.
        """
        kind, payload = self._session.next_result(timeout=timeout)
        if kind == "error":
            raise payload
        return kind, payload


class WorkerGroup:
    def __init__(self, num_workers: int, resources_per_worker: Dict[str, float],
                 placement_strategy: str = "PACK",
                 pg_timeout_s: float = 600.0):
        self.num_workers = num_workers
        self.resources_per_worker = dict(resources_per_worker)
        bundles = [dict(resources_per_worker) for _ in range(num_workers)]
        self._pg = ray_tpu_torch.placement_group(
            bundles, strategy=placement_strategy)
        if not self._pg.ready(timeout=pg_timeout_s):
            try:
                ray_tpu_torch.remove_placement_group(self._pg)
            except Exception:
                pass
            raise TimeoutError(
                f"placement group for {num_workers}x{resources_per_worker} "
                f"not ready after {pg_timeout_s}s (cluster busy or gang "
                "infeasible)")
        cpus = resources_per_worker.get("CPU", 1)
        extra = {k: v for k, v in resources_per_worker.items()
                 if k not in ("CPU", "GPU")}
        actor_cls = ray_tpu_torch.remote(RayTrainWorker)
        self.workers = [
            actor_cls.options(
                num_cpus=cpus,
                num_gpus=resources_per_worker.get("GPU", 0),
                resources=extra or None,
                scheduling_strategy=(
                    ray_tpu_torch.PlacementGroupSchedulingStrategy(
                        placement_group=self._pg,
                        placement_group_bundle_index=i)),
            ).remote()
            for i in range(num_workers)
        ]

    def execute(self, fn: Callable, *args, **kwargs) -> List[Any]:
        """Run fn on every worker; blocks for all results."""
        return ray_tpu_torch.get([w.execute.remote(fn, *args, **kwargs)
                                  for w in self.workers])

    def execute_async(self, fn: Callable, *args, **kwargs):
        return [w.execute.remote(fn, *args, **kwargs) for w in self.workers]

    def foreach_worker(self, method: str, *args, **kwargs) -> List[Any]:
        return ray_tpu_torch.get([getattr(w, method).remote(*args, **kwargs)
                                  for w in self.workers])

    def shutdown(self):
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        try:
            ray_tpu_torch.remove_placement_group(self._pg)
        except Exception:
            pass
        self.workers = []
