"""Trainers: BaseTrainer / DataParallelTrainer / TorchTrainer.

Ref analogs: train/base_trainer.py:77 (fit :598), data_parallel_trainer.py:61
(training_loop :482), torch/torch_trainer.py:16. Re-designed: ``fit()``
drives the gang directly (the reference detours through a single-trial Tune
run); Tune integration is the explicit ``as_trainable()`` hook instead.
The Torch backend (backend.py) rendezvouses the gang in one
``torch.distributed`` process group, on which the loop's meshes build.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.train.backend import BackendConfig, TorchConfig
from ray_tpu_torch.train.backend_executor import (
    BackendExecutor,
    TrainingWorkerError,
)
from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager
from ray_tpu_torch.train.config import (
    CheckpointConfig,
    FailureConfig,
    Result,
    RunConfig,
    ScalingConfig,
)


class BaseTrainer:
    def __init__(self, *, scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None,
                 datasets: Optional[Dict[str, Any]] = None):
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.resume_from_checkpoint = resume_from_checkpoint
        self.datasets = datasets or {}

    def fit(self) -> Result:
        raise NotImplementedError

    def _tune_resources(self) -> Dict[str, float]:
        """Trial-actor resources when run under Tune.

        The trial actor is only a coordinator — the gang's CPUs/GPUs are
        reserved by the inner placement group. Reserving the summed gang
        resources here too would double-book them and deadlock any cluster
        sized exactly to the gang (the normal case on a GPU node).
        """
        return {"CPU": 0.0}


class DataParallelTrainer(BaseTrainer):
    """Run one train function on every worker of the gang.

    ``train_loop_per_worker(config)`` executes on each worker actor with a
    live session (``ray_tpu_torch.train.report`` etc.); results stream
    back per round; a worker failure gang-restarts from the latest checkpoint
    (FailureConfig.max_failures), matching the reference's recovery model
    (SURVEY.md §5 — Train jobs gang-restart, not rescale).
    """

    _backend_config_cls = TorchConfig

    def __init__(self, train_loop_per_worker: Callable = None, *,
                 train_loop_config: Optional[Dict[str, Any]] = None,
                 backend_config: Optional[BackendConfig] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None,
                 datasets: Optional[Dict[str, Any]] = None):
        super().__init__(scaling_config=scaling_config,
                         run_config=run_config,
                         resume_from_checkpoint=resume_from_checkpoint,
                         datasets=datasets)
        if train_loop_per_worker is None:
            raise ValueError("train_loop_per_worker is required")
        self._train_fn = train_loop_per_worker
        self._train_config = train_loop_config or {}
        self._backend_config = backend_config or self._backend_config_cls()
        # optional hook called with (metrics, checkpoint) after every round
        # (used by as_trainable to stream results to Tune while fit runs)
        self._on_round: Optional[Callable] = None

    # ------------------------------------------------------------------ fit

    def _experiment_dir(self) -> str:
        name = self.run_config.name or getattr(
            self._train_fn, "__name__", "train")
        return os.path.join(self.run_config.resolved_storage_path(), name)

    def _split_datasets(self, num_workers: int):
        if not self.datasets:
            return None
        shards: Dict[str, list] = {}
        for name, ds in self.datasets.items():
            if hasattr(ds, "streaming_split"):
                shards[name] = ds.streaming_split(num_workers)
            elif hasattr(ds, "split"):
                shards[name] = ds.split(num_workers)
            else:
                shards[name] = [ds] * num_workers
        return shards

    def fit(self) -> Result:
        """Runs the loop on the gang to its end, gang-restarting on a
        worker failure. The layer's own costs are spans in
        ``tracing.timeline()``: ``train.executor_start`` (placement, worker
        start, rendezvous), ``train.checkpoint_register`` (a reported
        checkpoint written to the run's directory) and
        ``train.executor_shutdown``."""
        import ray_tpu_torch
        from ray_tpu_torch.tracing import span

        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        sc = self.scaling_config
        rc = self.run_config
        cc = rc.checkpoint_config or CheckpointConfig()
        fc = rc.failure_config or FailureConfig()
        exp_dir = self._experiment_dir()
        manager = CheckpointManager(
            os.path.join(exp_dir, "checkpoints"),
            num_to_keep=cc.num_to_keep,
            score_attribute=cc.checkpoint_score_attribute,
            score_order=cc.checkpoint_score_order)
        failures = 0
        checkpoint = self.resume_from_checkpoint
        history: list = []
        last_metrics: Dict[str, Any] = {}
        error: Optional[BaseException] = None
        while True:
            executor = BackendExecutor(
                self._backend_config, sc.num_workers, sc.bundle(),
                sc.placement_strategy)
            try:
                with span("train.executor_start"):
                    executor.start()
                executor.start_training(
                    self._train_fn, self._train_config,
                    checkpoint=checkpoint,
                    dataset_shards=self._split_datasets(sc.num_workers),
                    experiment_name=rc.name or "train")
                while True:
                    round_results = executor.next_results()
                    if round_results is None:
                        break
                    rank0 = round_results[0]
                    metrics = dict(rank0.get("metrics", {}))
                    ckpt = rank0.get("checkpoint")
                    if ckpt is not None:
                        if not isinstance(ckpt, Checkpoint):
                            ckpt = Checkpoint.from_dict(
                                ckpt if isinstance(ckpt, dict)
                                else {"data": ckpt})
                        with span("train.checkpoint_register"):
                            tracked = manager.register(ckpt, metrics)
                        checkpoint = tracked.checkpoint
                    last_metrics = metrics
                    history.append(metrics)
                    if self._on_round is not None:
                        self._on_round(metrics, checkpoint)
                error = None
                break
            except TrainingWorkerError as e:
                failures += 1
                if fc.max_failures != -1 and failures > fc.max_failures:
                    error = e
                    break
                # gang restart from the latest persisted checkpoint
                latest = manager.latest
                checkpoint = latest.checkpoint if latest else \
                    self.resume_from_checkpoint
            finally:
                with span("train.executor_shutdown"):
                    executor.shutdown()
        best = manager.best
        return Result(
            metrics=last_metrics,
            checkpoint=(best.checkpoint if best else checkpoint),
            path=exp_dir,
            error=error,
            metrics_history=history)

    # ------------------------------------------------------- tune interface

    def as_trainable(self) -> type:
        """Wrap this trainer for Tune: each trial deep-copies the trainer,
        merges the trial config into train_loop_config, and streams metrics
        to the Tune controller *as each round completes* (so schedulers like
        ASHA can stop trials while they are still training — ref:
        base_trainer.py:862 as_trainable)."""
        import copy
        import queue as _queue
        import threading

        from ray_tpu_torch import tune as _tune

        trainer = self

        def _trial_fn(config):
            t = copy.deepcopy(trainer)
            t._train_config = {**t._train_config, **config}
            q: "_queue.Queue" = _queue.Queue()
            t._on_round = lambda metrics, ckpt: q.put(("round", metrics))
            box: dict = {}

            def _run():
                try:
                    box["result"] = t.fit()
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    box["error"] = e
                q.put(("end", None))

            threading.Thread(target=_run, daemon=True,
                             name="trainer_fit").start()
            while True:
                kind, metrics = q.get()
                if kind == "end":
                    break
                _tune.report(metrics)
            if "error" in box:
                raise box["error"]
            result = box["result"]
            if result.error is not None:
                raise result.error
            _tune.report(dict(result.metrics),
                         checkpoint=result.checkpoint)

        _trial_fn.__name__ = self.run_config.name or "trainer"
        _trial_fn._tune_resources = self._tune_resources  # type: ignore
        return _trial_fn


class TorchTrainer(DataParallelTrainer):
    """Data/model-parallel PyTorch over a gang of workers (ref:
    torch/torch_trainer.py:16).

    Workers of a gang of more than one join one ``torch.distributed``
    process group (NCCL when they lease GPUs, each seeing its own card as
    cuda:0); inside the loop users build a DeviceMesh on it with
    ``ray_tpu_torch.parallel.make_mesh`` and run the meshed train step.
    """

    _backend_config_cls = TorchConfig
