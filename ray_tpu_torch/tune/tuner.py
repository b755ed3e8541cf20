"""Tuner: the experiment-level entry point.

Ref analogs: python/ray/tune/tuner.py:59 (Tuner.fit :337) and
python/ray/tune/tune.py:293 (tune.run). ``Tuner(trainable, param_space=...,
tune_config=TuneConfig(...), run_config=RunConfig(...)).fit()``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Union

import ray_tpu_torch
from ray_tpu_torch.train.config import RunConfig

from .execution import TuneController
from .result_grid import ResultGrid
from .search import BasicVariantGenerator, Searcher
from .trainable import FunctionTrainable, Trainable


@dataclasses.dataclass
class TuneConfig:
    """Ref analog: python/ray/tune/tune_config.py."""

    metric: Optional[str] = None
    mode: str = "max"
    num_samples: int = 1
    max_concurrent_trials: int = 0
    search_alg: Optional[Searcher] = None
    scheduler: Any = None
    time_budget_s: Optional[float] = None
    seed: Optional[int] = None
    checkpoint_frequency: int = 0
    max_failures: int = 0
    resources_per_trial: Optional[Dict[str, float]] = None


class Tuner:
    def __init__(self, trainable: Union[type, Callable],
                 *, param_space: Optional[Dict[str, Any]] = None,
                 tune_config: Optional[TuneConfig] = None,
                 run_config: Optional[RunConfig] = None):
        self._tc = tune_config or TuneConfig()
        self._rc = run_config or RunConfig()
        self._space = param_space or {}
        self._trainable = self._as_trainable_cls(trainable)
        # Trainers (train.BaseTrainer) carry their own resource needs.
        if hasattr(trainable, "_tune_resources"):
            self._tc.resources_per_trial = trainable._tune_resources()

    @staticmethod
    def _as_trainable_cls(trainable) -> type:
        if isinstance(trainable, type) and issubclass(trainable, Trainable):
            return trainable
        if callable(trainable):
            return FunctionTrainable.wrap(trainable)
        raise TypeError(f"not a trainable: {trainable!r}")

    def fit(self) -> ResultGrid:
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        tc = self._tc
        searcher = tc.search_alg or BasicVariantGenerator(
            self._space, num_samples=tc.num_samples, seed=tc.seed,
            metric=tc.metric, mode=tc.mode)
        # PBT needs periodic checkpoints to exploit from.
        ckpt_freq = tc.checkpoint_frequency
        from .schedulers import PopulationBasedTraining

        if isinstance(tc.scheduler, PopulationBasedTraining) and not \
                ckpt_freq:
            ckpt_freq = tc.scheduler.interval
        controller = TuneController(
            self._trainable,
            searcher=searcher,
            scheduler=tc.scheduler,
            metric=tc.metric,
            mode=tc.mode,
            max_concurrent=tc.max_concurrent_trials,
            num_samples=tc.num_samples if tc.search_alg is not None else 0,
            resources_per_trial=tc.resources_per_trial,
            stop=getattr(self._rc, "stop", None),
            max_failures=tc.max_failures,
            checkpoint_frequency=ckpt_freq,
            storage_path=self._rc.storage_path,
            experiment_name=self._rc.name or "experiment",
            time_budget_s=tc.time_budget_s,
        )
        controller.run()
        return ResultGrid(controller.trials, metric=tc.metric, mode=tc.mode)


def run(trainable, *, config: Optional[Dict[str, Any]] = None,
        num_samples: int = 1, metric: Optional[str] = None,
        mode: str = "max", scheduler=None, search_alg=None, stop=None,
        max_concurrent_trials: int = 0, storage_path: Optional[str] = None,
        name: Optional[str] = None, resources_per_trial=None,
        **_ignored) -> ResultGrid:
    """Functional entry point (ref: tune/tune.py:293 tune.run)."""
    rc = RunConfig(name=name, storage_path=storage_path)
    rc.stop = stop  # type: ignore[attr-defined]
    return Tuner(
        trainable,
        param_space=config,
        tune_config=TuneConfig(
            metric=metric, mode=mode, num_samples=num_samples,
            scheduler=scheduler, search_alg=search_alg,
            max_concurrent_trials=max_concurrent_trials,
            resources_per_trial=resources_per_trial),
        run_config=rc,
    ).fit()
