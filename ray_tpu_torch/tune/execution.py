"""TuneController: the experiment event loop.

Ref analog: python/ray/tune/execution/tune_controller.py:80 — an event-driven
loop that seats trials on actors, pumps ``train()`` results, applies
scheduler decisions, and checkpoints experiment state. Re-designed around
``wait()`` over in-flight train futures instead of the reference's
actor-manager event system (one trial = one actor here; the runtime already
multiplexes actors over worker processes).
"""

from __future__ import annotations

import json
import os
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.core.object_ref import ObjectRef

from . import schedulers as S
from .trial import (ERROR, PAUSED, PENDING, RUNNING, TERMINATED, Trial)
from .trainable import FunctionTrainable, Trainable


class _TrialRunner:
    """Driver-side handle pairing a Trial with its live actor."""

    def __init__(self, trial: Trial, actor, train_future=None):
        self.trial = trial
        self.actor = actor
        self.future: Optional[ObjectRef] = train_future
        self.failures = 0


class TuneController:
    def __init__(self, trainable_cls: type, *, searcher, scheduler=None,
                 metric: Optional[str] = None, mode: str = "max",
                 max_concurrent: int = 0, resources_per_trial=None,
                 stop=None, max_failures: int = 0,
                 checkpoint_frequency: int = 0,
                 storage_path: Optional[str] = None,
                 experiment_name: str = "experiment",
                 time_budget_s: Optional[float] = None,
                 num_samples: int = 0,
                 trial_executor_kwargs=None):
        self._cls = trainable_cls
        self._searcher = searcher
        self._scheduler = scheduler or S.FIFOScheduler(metric=metric,
                                                      mode=mode)
        if self._scheduler.metric is None:
            self._scheduler.metric = metric
        self.metric, self.mode = metric, mode
        self._resources = dict(resources_per_trial or {"CPU": 1})
        self._stop_criteria = stop
        self._max_failures = max_failures
        self._ckpt_freq = checkpoint_frequency
        self._time_budget = time_budget_s
        self.trials: List[Trial] = []
        self._runners: Dict[str, _TrialRunner] = {}
        self._max_concurrent = max_concurrent or self._default_concurrency()
        # bounds suggestion-based searchers (TPE etc.) that never return
        # None on their own; 0 = unbounded (pre-expanded searchers exhaust)
        self._num_samples = num_samples
        self._exhausted = False
        self._storage = storage_path
        self._name = experiment_name
        if self._storage:
            os.makedirs(self._exp_dir(), exist_ok=True)

    def _exp_dir(self) -> str:
        return os.path.join(self._storage, self._name)

    def _default_concurrency(self) -> int:
        try:
            cpus = ray_tpu_torch.cluster_resources().get("CPU", 1)
            need = max(1.0, self._resources.get("CPU", 1))
            return max(1, int(cpus / need))
        except Exception:
            return 4

    # ------------------------------------------------------------- lifecycle

    def _make_actor(self, trial: Trial):
        actor_cls = ray_tpu_torch.remote(self._cls)
        cfg = dict(trial.config)
        if trial.checkpoint is not None and issubclass(self._cls,
                                                      FunctionTrainable):
            # trial.checkpoint holds save()'s {'iteration','payload'}
            # wrapper; the user-facing tune.get_checkpoint() must see the
            # payload they reported, not the wrapper
            ckpt = _maybe_get(trial.checkpoint)
            if isinstance(ckpt, dict) and set(ckpt) == {"iteration",
                                                        "payload"}:
                ckpt = ckpt["payload"]
            cfg["__checkpoint__"] = ckpt
        handle = actor_cls.options(
            num_cpus=self._resources.get("CPU", 1),
            num_gpus=self._resources.get("GPU", 0) or None,
            resources={k: v for k, v in self._resources.items()
                       if k not in ("CPU", "GPU")} or None,
        ).remote(cfg)
        if trial.checkpoint is not None and not issubclass(
                self._cls, FunctionTrainable):
            ray_tpu_torch.get(handle.restore.remote(
                _maybe_get(trial.checkpoint)))
        return handle

    def _start_trial(self, trial: Trial):
        actor = self._make_actor(trial)
        runner = _TrialRunner(trial, actor)
        runner.future = actor.train.remote()
        trial.status = RUNNING
        self._runners[trial.trial_id] = runner

    def _stop_trial(self, trial: Trial, status: str, error: str = None):
        runner = self._runners.pop(trial.trial_id, None)
        if runner is not None:
            try:
                runner.actor.stop.remote()
            except Exception:
                pass
            try:
                ray_tpu_torch.kill(runner.actor)
            except Exception:
                pass
        trial.status = status
        trial.error = error
        self._searcher.on_trial_complete(trial.trial_id, trial.last_result,
                                         error=status == ERROR)
        self._scheduler.on_trial_complete(self.trials, trial)

    # ------------------------------------------------------------- main loop

    def _fill_trials(self):
        while len(self._runners) < self._max_concurrent:
            # Resume paused trials whenever a slot frees, regardless of
            # searcher exhaustion — gating this on `not _exhausted` livelocks
            # custom PAUSE-ing schedulers once the searcher runs dry
            # (round-1 ADVICE, medium).
            paused = [t for t in self.trials if t.status == PAUSED]
            if paused:
                trial = paused[0]
                self._start_trial(trial)
                continue
            if self._exhausted:
                break
            if self._num_samples and len(self.trials) >= self._num_samples:
                self._exhausted = True
                break
            tid = f"t{len(self.trials):05d}"
            cfg = self._searcher.suggest(tid)
            if cfg is None:
                self._exhausted = True
                break
            trial = Trial(config=cfg, trial_id=tid)
            self.trials.append(trial)
            self._start_trial(trial)

    def _should_stop_trial(self, trial: Trial, result: dict) -> bool:
        if result.get("done"):
            return True
        crit = self._stop_criteria
        if crit is None:
            return False
        if callable(crit):
            return bool(crit(trial.trial_id, result))
        for key, bound in crit.items():
            if key in result:
                if key == "training_iteration" or self.mode == "max":
                    if result[key] >= bound:
                        return True
                elif result[key] <= bound:
                    return True
        return False

    def _maybe_checkpoint(self, runner: _TrialRunner):
        trial = runner.trial
        if self._ckpt_freq and trial.iteration > 0 and \
                trial.iteration % self._ckpt_freq == 0 and \
                trial.iteration > trial.checkpoint_iter:
            # resolve eagerly: a pending save ref would be lost if this
            # actor is later killed (stop/exploit) before executing it
            trial.checkpoint = ray_tpu_torch.get(runner.actor.save.remote())
            trial.checkpoint_iter = trial.iteration

    def _handle_result(self, runner: _TrialRunner, result: dict):
        trial = runner.trial
        trial.last_result = result
        trial.metric_history.append(result)
        trial.iteration = result.get("training_iteration",
                                     trial.iteration + 1)
        self._maybe_checkpoint(runner)
        if self._should_stop_trial(trial, result):
            self._stop_trial(trial, TERMINATED)
            return
        try:
            decision = S.CONTINUE if self._scheduler.metric is None else \
                self._scheduler.on_result(self.trials, trial, result)
        except KeyError:
            decision = S.CONTINUE
        if decision == S.STOP:
            self._stop_trial(trial, TERMINATED)
        elif decision == S.PAUSE:
            trial.checkpoint = _maybe_get(runner.actor.save.remote())
            trial.checkpoint_iter = trial.iteration
            self._runners.pop(trial.trial_id, None)
            try:
                ray_tpu_torch.kill(runner.actor)
            except Exception:
                pass
            trial.status = PAUSED
        elif decision == S.UPDATE:
            # PBT exploit/explore: try in-place reset, else restart actor
            # from the donor checkpoint already placed on the trial record.
            ok = False
            try:
                ok = ray_tpu_torch.get(
                    runner.actor.reset.remote(trial.config))
            except Exception:
                ok = False
            if ok:
                try:
                    ray_tpu_torch.get(runner.actor.restore.remote(
                        _maybe_get(trial.checkpoint)))
                except Exception:
                    ok = False
            if not ok:
                old = self._runners.pop(trial.trial_id)
                try:
                    ray_tpu_torch.kill(old.actor)
                except Exception:
                    pass
                self._start_trial(trial)
            else:
                runner.future = runner.actor.train.remote()
        else:
            runner.future = runner.actor.train.remote()

    def _handle_error(self, runner: _TrialRunner, err: BaseException):
        trial = runner.trial
        runner.failures += 1
        if runner.failures <= self._max_failures:
            self._runners.pop(trial.trial_id, None)
            try:
                ray_tpu_torch.kill(runner.actor)
            except Exception:
                pass
            self._start_trial(trial)
            self._runners[trial.trial_id].failures = runner.failures
        else:
            self._stop_trial(trial, ERROR, error="".join(
                traceback.format_exception_only(type(err), err)).strip())

    def step(self) -> bool:
        """One pump of the loop. Returns False when the experiment is over."""
        self._fill_trials()
        futures = {r.future: r for r in self._runners.values()
                   if r.future is not None}
        if not futures:
            return any(t.status == PAUSED for t in self.trials)
        ready, _ = ray_tpu_torch.wait(list(futures), num_returns=1,
                                      timeout=30.0)
        for ref in ready:
            runner = futures[ref]
            runner.future = None
            try:
                result = ray_tpu_torch.get(ref)
            except BaseException as e:  # noqa: BLE001 — trial failure path
                self._handle_error(runner, e)
                continue
            self._handle_result(runner, result)
        return True

    def run(self, callbacks: Optional[List[Callable]] = None):
        start = time.time()
        while self.step():
            if self._time_budget and time.time() - start > self._time_budget:
                for t in list(self.trials):
                    if not t.is_finished():
                        self._stop_trial(t, TERMINATED)
                break
            if self._storage:
                self._save_experiment_state()
            for cb in callbacks or []:
                cb(self)
        # resolve any checkpoint refs so results outlive shutdown
        for t in self.trials:
            t.checkpoint = _maybe_get(t.checkpoint)
        if self._storage:
            self._save_experiment_state()

    # -------------------------------------------------------------- persist

    def _save_experiment_state(self):
        state = {
            "name": self._name,
            "trials": [t.public_state() for t in self.trials],
            "timestamp": time.time(),
        }
        path = os.path.join(self._exp_dir(), "experiment_state.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f, default=str)
        os.replace(tmp, path)


def _maybe_get(v):
    return ray_tpu_torch.get(v) if isinstance(v, ObjectRef) else v
