"""Trainable: the unit a trial actor runs.

Ref analogs: python/ray/tune/trainable/trainable.py:75 (class API —
setup/step/save_checkpoint/load_checkpoint) and
trainable/function_trainable.py (function API: the user function runs on
its own thread and emits results via ``tune.report``); re-designed so both
share one ``train()`` contract the controller polls remotely.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Optional

RESULT_DONE = "__trial_done__"


class Trainable:
    """Class API. Subclass and override setup/step (+ optional
    save_checkpoint/load_checkpoint for PBT/pause support)."""

    def __init__(self, config: Dict[str, Any] = None):
        self.config = dict(config or {})
        self.iteration = 0
        self.setup(self.config)

    # -- override points --

    def setup(self, config: Dict[str, Any]):
        pass

    def step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def save_checkpoint(self) -> Any:
        """Return a picklable checkpoint payload."""
        return None

    def load_checkpoint(self, checkpoint: Any):
        pass

    def reset_config(self, new_config: Dict[str, Any]) -> bool:
        """Hot-swap config (PBT exploit). Return True if handled in place."""
        return False

    def cleanup(self):
        pass

    # -- controller-facing (invoked as actor methods) --

    def train(self) -> Dict[str, Any]:
        result = self.step()
        if not isinstance(result, dict):
            raise TypeError("step() must return a metrics dict")
        self.iteration += 1
        result.setdefault("training_iteration", self.iteration)
        return result

    def save(self) -> Any:
        return {"iteration": self.iteration,
                "payload": self.save_checkpoint()}

    def restore(self, checkpoint: Any):
        self.iteration = checkpoint.get("iteration", 0)
        self.load_checkpoint(checkpoint.get("payload"))

    def reset(self, new_config: Dict[str, Any]) -> bool:
        ok = self.reset_config(new_config)
        if ok:
            self.config = dict(new_config)
        return ok

    def stop(self):
        self.cleanup()


class FunctionTrainable(Trainable):
    """Wraps ``def train_fn(config)`` using ``ray_tpu_torch.tune.report(...)``.

    The function runs on a daemon thread; ``train()`` blocks on its next
    report. A checkpoint passed to report() is retained for save().
    """

    _fn: Optional[Callable] = None  # bound by wrap()

    def setup(self, config):
        self._queue: "queue.Queue" = queue.Queue(maxsize=16)
        self._ckpt = config.pop("__checkpoint__", None)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="tune_fn")
        self._started = False
        self._done = False

    def _run(self):
        from . import session as tune_session

        tune_session._set_reporter(self._report, self._ckpt)
        try:
            out = type(self)._fn(self.config)
            self._queue.put((RESULT_DONE, out if isinstance(out, dict)
                             else {}))
        except BaseException as e:  # noqa: BLE001 — surfaced via train()
            self._queue.put(("__error__", e))

    def _report(self, metrics: Dict[str, Any], checkpoint=None):
        if checkpoint is not None:
            self._latest_ckpt = checkpoint
        self._last_metrics = dict(metrics)
        self._queue.put(("report", dict(metrics)))

    def step(self):
        if not self._started:
            self._thread.start()
            self._started = True
        if self._done:
            return {"done": True}
        kind, payload = self._queue.get()
        if kind == "__error__":
            raise payload
        if kind == RESULT_DONE:
            self._done = True
            # the function finished: surface the last reported metrics so
            # they survive as the trial's final result
            payload = {**getattr(self, "_last_metrics", {}), **payload,
                       "done": True}
        return payload

    def train(self):
        result = self.step()
        if result.get("done"):
            # the terminal pump is not a training iteration
            result.setdefault("training_iteration", self.iteration)
            return result
        self.iteration += 1
        result.setdefault("training_iteration", self.iteration)
        return result

    def save_checkpoint(self):
        return getattr(self, "_latest_ckpt", None)

    def load_checkpoint(self, checkpoint):
        self._ckpt = checkpoint

    @classmethod
    def wrap(cls, fn: Callable) -> type:
        return type(f"func_{getattr(fn, '__name__', 'trainable')}",
                    (cls,), {"_fn": staticmethod(fn)})


def with_parameters(trainable, **params):
    """Bind large constant objects outside the config dict
    (ref: tune/trainable/util.py with_parameters)."""
    if isinstance(trainable, type) and issubclass(trainable, Trainable):
        class _Bound(trainable):  # type: ignore[misc, valid-type]
            def setup(self, config):
                cfg = dict(config)
                cfg.update(params)
                super().setup(cfg)

        _Bound.__name__ = trainable.__name__
        return _Bound

    def fn(config):
        return trainable(config, **params)

    fn.__name__ = getattr(trainable, "__name__", "trainable")
    return fn
