"""Training backends: per-framework rendezvous hooks.

Ref analog: train/backend.py + train/torch/config.py:70 — the workers
rendezvous in one ``torch.distributed`` process group: NCCL when they
lease GPUs, gloo otherwise. Inside the loop, ``parallel.make_mesh(...)``
builds its DeviceMesh on that group.
"""

from __future__ import annotations

import dataclasses
import datetime

from ray_tpu_torch.train.worker_group import WorkerGroup


@dataclasses.dataclass
class BackendConfig:
    @property
    def backend_cls(self):
        return Backend


class Backend:
    def on_start(self, worker_group: WorkerGroup, backend_config):
        pass

    def on_training_start(self, worker_group: WorkerGroup, backend_config):
        pass

    def on_shutdown(self, worker_group: WorkerGroup, backend_config):
        pass


@dataclasses.dataclass
class TorchConfig(BackendConfig):
    """``torch.distributed`` rendezvous, with nothing to set: a gang of
    more than one worker joins one process group, NCCL when the workers
    lease GPUs and gloo otherwise. There is no fallback: a group that
    fails to start fails the run. A single worker runs plain
    single-process torch, and ``make_mesh`` starts a world of one there.
    """

    @property
    def backend_cls(self):
        return _TorchBackend


# the process group's collective timeout
_GROUP_TIMEOUT_S = 1800.0
# how long the shutdown hook waits for a worker to leave its group before
# the gang is killed anyway (a peer stuck in a collective never returns)
_SHUTDOWN_WAIT_S = 60.0


def _setup_gpu():
    """A GPU worker's first call: its lease shows it exactly its own card
    as cuda:0 (``CUDA_VISIBLE_DEVICES``), so every rank uses device 0."""
    import os

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            "a GPU train worker sees no CUDA device (CUDA_VISIBLE_DEVICES="
            f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r})")
    torch.cuda.set_device(0)


def _init_torch_distributed(backend: str, init_method: str, world_size: int,
                            rank: int):
    import torch.distributed as dist

    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=_GROUP_TIMEOUT_S))
    return True


def _torch_shutdown():
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


class _TorchBackend(Backend):
    def on_start(self, worker_group: WorkerGroup, backend_config: TorchConfig):
        import ray_tpu_torch

        n = worker_group.num_workers
        gpu = worker_group.resources_per_worker.get("GPU", 0) > 0
        if gpu:
            worker_group.execute(_setup_gpu)
        if n == 1:
            return
        backend = "nccl" if gpu else "gloo"
        w0 = worker_group.workers[0]
        addr = ray_tpu_torch.get([w0.get_address.remote()])[0]
        port = ray_tpu_torch.get([w0.find_free_port.remote()])[0]
        self.coordinator_address = f"{addr}:{port}"
        ray_tpu_torch.get([
            w.execute.remote(_init_torch_distributed, backend,
                             f"tcp://{self.coordinator_address}", n, i)
            for i, w in enumerate(worker_group.workers)
        ])
        self.distributed = True

    def on_shutdown(self, worker_group: WorkerGroup, backend_config):
        if not getattr(self, "distributed", False):
            return
        import ray_tpu_torch

        try:
            ray_tpu_torch.get(worker_group.execute_async(_torch_shutdown),
                              timeout=_SHUTDOWN_WAIT_S)
        except Exception:
            pass  # a dead or stuck worker: the gang is killed next
