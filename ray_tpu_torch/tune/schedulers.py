"""Trial schedulers: FIFO, ASHA, HyperBand, median-stopping, PBT.

Ref analogs: python/ray/tune/schedulers/trial_scheduler.py (decision enum),
async_hyperband.py:19 (ASHA brackets/rungs), hyperband.py,
median_stopping_rule.py, pbt.py:219 (exploit/explore). Re-designed around a
single ``on_result(trials, trial, result) -> decision`` hook; PBT signals a
config+checkpoint swap via the ``UPDATE`` decision after mutating the trial
record in place.
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional

from .trial import RUNNING, TERMINATED, Trial

CONTINUE = "CONTINUE"
STOP = "STOP"
PAUSE = "PAUSE"
UPDATE = "UPDATE"  # config/checkpoint changed; controller must re-seat actor


class TrialScheduler:
    def __init__(self, metric: Optional[str] = None, mode: str = "max",
                 time_attr: str = "training_iteration"):
        if mode not in ("max", "min"):
            raise ValueError("mode must be 'max' or 'min'")
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr

    def _score(self, result: Dict[str, Any]) -> float:
        v = result.get(self.metric)
        if v is None:
            raise KeyError(f"result missing scheduler metric "
                           f"'{self.metric}'")
        return float(v) if self.mode == "max" else -float(v)

    def on_result(self, trials: List[Trial], trial: Trial,
                  result: Dict[str, Any]) -> str:
        return CONTINUE

    def on_trial_complete(self, trials: List[Trial], trial: Trial):
        pass


class FIFOScheduler(TrialScheduler):
    """Run every trial to completion (ref: trial_scheduler.py FIFOScheduler)."""


class AsyncHyperBandScheduler(TrialScheduler):
    """ASHA (ref: schedulers/async_hyperband.py:19).

    Rungs at grace_period * reduction_factor^k; a trial reaching a rung
    stops unless its score is in the top 1/reduction_factor of everything
    recorded at that rung (async — no waiting for full brackets).
    """

    def __init__(self, metric=None, mode="max",
                 time_attr="training_iteration", grace_period: int = 1,
                 max_t: int = 100, reduction_factor: float = 4,
                 brackets: int = 1):
        super().__init__(metric, mode, time_attr)
        self.grace_period = grace_period
        self.max_t = max_t
        self.rf = reduction_factor
        # rung milestones, smallest first, per bracket
        self._brackets: List[Dict[float, List[float]]] = []
        for s in range(brackets):
            rungs = {}
            t = grace_period * (self.rf ** s)
            while t < max_t:
                rungs[t] = []
                t *= self.rf
            self._brackets.append(rungs)
        self._rr = 0

    def _bracket_for(self, trial: Trial) -> Dict[float, List[float]]:
        idx = trial.scheduler_data.get("bracket")
        if idx is None:
            idx = self._rr % len(self._brackets)
            self._rr += 1
            trial.scheduler_data["bracket"] = idx
        return self._brackets[idx]

    def on_result(self, trials, trial, result) -> str:
        t = result.get(self.time_attr, trial.iteration)
        if t >= self.max_t:
            return STOP
        rungs = self._bracket_for(trial)
        score = self._score(result)
        decision = CONTINUE
        for milestone in sorted(rungs, reverse=True):
            if t < milestone:
                continue
            passed = trial.scheduler_data.setdefault("rungs_passed", set())
            if milestone in passed:
                break
            passed.add(milestone)
            recorded = rungs[milestone]
            recorded.append(score)
            if len(recorded) >= self.rf:
                cutoff_rank = max(1, int(len(recorded) / self.rf))
                cutoff = sorted(recorded, reverse=True)[cutoff_rank - 1]
                if score < cutoff:
                    decision = STOP
            break
        return decision


# The reference exposes HyperBand both sync and async; ASHA is the
# recommended implementation (async_hyperband.py docstring) — alias it.
HyperBandScheduler = AsyncHyperBandScheduler
ASHAScheduler = AsyncHyperBandScheduler


class MedianStoppingRule(TrialScheduler):
    """Stop a trial whose running-best is below the median of other trials'
    running means at the same step (ref: median_stopping_rule.py)."""

    def __init__(self, metric=None, mode="max",
                 time_attr="training_iteration", grace_period: int = 1,
                 min_samples_required: int = 3):
        super().__init__(metric, mode, time_attr)
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        self._means: Dict[str, List[float]] = {}

    def on_result(self, trials, trial, result) -> str:
        t = result.get(self.time_attr, trial.iteration)
        score = self._score(result)
        hist = self._means.setdefault(trial.trial_id, [])
        hist.append(score)
        if t < self.grace_period:
            return CONTINUE
        other_means = [sum(h) / len(h) for tid, h in self._means.items()
                       if tid != trial.trial_id and h]
        if len(other_means) < self.min_samples:
            return CONTINUE
        median = sorted(other_means)[len(other_means) // 2]
        best = max(hist)
        return STOP if best < median else CONTINUE


class PopulationBasedTraining(TrialScheduler):
    """PBT (ref: schedulers/pbt.py:219).

    Every ``perturbation_interval`` steps, a bottom-quantile trial clones a
    top-quantile trial's checkpoint (exploit) and perturbs hyperparameters
    (explore). The swap is communicated by mutating the trial record
    (config + checkpoint) and returning UPDATE; the controller re-seats the
    actor (reset_config or restart+restore).
    """

    def __init__(self, metric=None, mode="max",
                 time_attr="training_iteration",
                 perturbation_interval: int = 5,
                 hyperparam_mutations: Dict[str, Any] = None,
                 quantile_fraction: float = 0.25,
                 resample_probability: float = 0.25,
                 seed: Optional[int] = None):
        super().__init__(metric, mode, time_attr)
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.resample_p = resample_probability
        self._rng = random.Random(seed)

    def _explore(self, config: Dict[str, Any]) -> Dict[str, Any]:
        from .search import Domain

        new = dict(config)
        for key, spec in self.mutations.items():
            cur = new.get(key)
            resample = cur is None or self._rng.random() < self.resample_p
            if isinstance(spec, Domain):
                if resample:
                    new[key] = spec.sample(self._rng)
                elif isinstance(cur, (int, float)):
                    new[key] = cur * self._rng.choice([0.8, 1.2])
            elif isinstance(spec, list):
                if resample or cur not in spec:
                    new[key] = self._rng.choice(spec)
                else:
                    i = spec.index(cur)
                    j = min(len(spec) - 1, max(0, i + self._rng.choice(
                        [-1, 1])))
                    new[key] = spec[j]
            elif callable(spec):
                new[key] = spec()
            if isinstance(new.get(key), float) and isinstance(cur, int):
                new[key] = int(new[key])
        return new

    def on_result(self, trials, trial, result) -> str:
        t = result.get(self.time_attr, trial.iteration)
        last = trial.scheduler_data.get("last_perturb", 0)
        if t - last < self.interval:
            return CONTINUE
        trial.scheduler_data["last_perturb"] = t
        active = [tr for tr in trials
                  if tr.status == RUNNING and self.metric in tr.last_result]
        if len(active) < 2:
            return CONTINUE
        ranked = sorted(
            active, key=lambda tr: self._score(tr.last_result), reverse=True)
        k = max(1, int(len(ranked) * self.quantile))
        top, bottom = ranked[:k], ranked[-k:]
        if trial not in bottom or trial in top:
            return CONTINUE
        donor = self._rng.choice(top)
        if donor.checkpoint is None:
            return CONTINUE
        trial.config = self._explore(donor.config)
        trial.checkpoint = donor.checkpoint
        trial.checkpoint_iter = donor.checkpoint_iter
        return UPDATE
