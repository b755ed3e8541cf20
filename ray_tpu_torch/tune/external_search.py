"""External-optimizer searcher adapters.

Ref analog: tune/search/optuna/optuna_search.py (and the hyperopt/
bayesopt/BOHB siblings) — thin adapters that translate Tune's search
space + ask/tell protocol onto an external optimizer. This image is
sealed, so the adapter hard-gates on importability with a clear error
naming the native alternative (``TPESearcher`` implements the same
TPE algorithm class with no dependency); the translation layer itself
is fully unit-testable against a fake module.

Only Optuna is adapted: its ask-and-tell API is a documented, stable
protocol. hyperopt's equivalent requires reaching into Trials
internals, which is not worth maintaining against a library this image
cannot even install.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from .search import (Categorical, Domain, Float, GridSearch, Integer,
                     SampleFrom, Searcher, _set_path, _split_space)


class OptunaSearch(Searcher):
    """Adapter onto an optuna ``Study`` via ask/tell.

    Space leaves map to distributions: ``Float`` -> suggest_float
    (log-scaled when the domain is loguniform; quantized via step),
    ``Integer`` -> suggest_int, ``Categorical``/``GridSearch`` ->
    suggest_categorical. ``sample_from`` is rejected (same as the
    reference's OptunaSearch, which cannot express callables).
    """

    def __init__(self, space: Dict[str, Any], *, metric: str = "reward",
                 mode: str = "max", seed: Optional[int] = None,
                 sampler=None, study=None):
        super().__init__(metric=metric, mode=mode)
        try:
            import optuna
        except ImportError as e:
            raise ImportError(
                "OptunaSearch requires the 'optuna' package, which is "
                "not available on this sealed image; use the native "
                "TPESearcher (same TPE algorithm class, no external "
                "dependency) or pre-bake optuna into the image."
            ) from e
        self._optuna = optuna
        self._leaves = []
        for path, dom in _split_space(space):
            if isinstance(dom, SampleFrom):
                raise ValueError(
                    "OptunaSearch does not support sample_from")
            self._leaves.append((path, dom))
        if study is None:
            if sampler is None:
                sampler = optuna.samplers.TPESampler(seed=seed)
            study = optuna.create_study(
                direction="maximize" if mode == "max" else "minimize",
                sampler=sampler)
        self._study = study
        self._trials: Dict[str, Any] = {}  # tune trial_id -> optuna trial

    @staticmethod
    def _param_name(path) -> str:
        return ".".join(path)

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        ot = self._study.ask()
        cfg: Dict[str, Any] = {}
        for path, dom in self._leaves:
            name = self._param_name(path)
            if isinstance(dom, Float):
                log = bool(getattr(dom, "log", False))
                # optuna rejects step together with log; log wins
                step = None if log else getattr(dom, "q", None)
                val = ot.suggest_float(name, dom.lower, dom.upper,
                                       log=log, step=step)
            elif isinstance(dom, Integer):
                # our Integer upper is EXCLUSIVE (randrange); optuna's
                # high is inclusive
                val = ot.suggest_int(
                    name, dom.lower, dom.upper - 1,
                    step=getattr(dom, "q", None) or 1)
            elif isinstance(dom, (Categorical, GridSearch)):
                values = (dom.categories if isinstance(dom, Categorical)
                          else dom.values)
                val = ot.suggest_categorical(name, list(values))
            elif isinstance(dom, Domain):
                raise TypeError(f"unsupported domain {type(dom).__name__}")
            else:
                val = dom  # constant leaf passes through unchanged
            _set_path(cfg, path, val)
        self._trials[trial_id] = ot
        return cfg

    def on_trial_complete(self, trial_id: str,
                          result: Optional[dict] = None,
                          error: bool = False):
        ot = self._trials.pop(trial_id, None)
        if ot is None:
            return
        if error or not result or self.metric not in result:
            state = self._optuna.trial.TrialState.FAIL
            self._study.tell(ot, state=state)
            return
        self._study.tell(ot, float(result[self.metric]))
