"""Model multiplexing: many models share one replica pool.

Ref parity: ray.serve.multiplexed (python/ray/serve/multiplex.py
_ModelMultiplexWrapper + api.py multiplexed/get_multiplexed_model_id):
a replica lazy-loads models by id with LRU eviction, requests carry
``multiplexed_model_id`` through ``handle.options(...)``, and routing
prefers replicas that already hold the model (client-side affinity cache
here; the reference pushes replica model sets through its long-poll
broker). The payoff is the reference's: N small models share one
GPU-holding replica instead of each pinning a GPU.
"""

from __future__ import annotations

import functools
import threading
from collections import OrderedDict
from typing import Any, Callable, Optional

_request_ctx = threading.local()


def get_multiplexed_model_id() -> str:
    """Inside a replica: the model id of the CURRENT request (ref:
    serve.get_multiplexed_model_id)."""
    return getattr(_request_ctx, "model_id", "")


def _set_request_model_id(model_id: str):
    _request_ctx.model_id = model_id


class _ModelMultiplexWrapper:
    """LRU model cache living on the replica (one per decorated loader)."""

    def __init__(self, load_fn: Callable, self_obj: Optional[Any],
                 max_models: int):
        self._load_fn = load_fn
        self._self = self_obj
        self._max = max_models
        self._lock = threading.Lock()
        self._models: "OrderedDict[str, Any]" = OrderedDict()
        self._loading: dict = {}  # model_id -> Event (single-flight load)

    def load_model(self, model_id: str) -> Any:
        while True:
            with self._lock:
                if model_id in self._models:
                    self._models.move_to_end(model_id)
                    return self._models[model_id]
                ev = self._loading.get(model_id)
                if ev is None:
                    ev = self._loading[model_id] = threading.Event()
                    i_load = True
                else:
                    i_load = False
            if not i_load:
                ev.wait()
                continue  # loaded (or failed) — re-check the cache
            try:
                model = self._load_fn(self._self, model_id) \
                    if self._self is not None else self._load_fn(model_id)
                with self._lock:
                    self._models[model_id] = model
                    while len(self._models) > self._max:
                        old_id, old = self._models.popitem(last=False)
                        self._unload(old)
                return model
            finally:
                with self._lock:
                    self._loading.pop(model_id, None)
                ev.set()

    @staticmethod
    def _unload(model):
        """Evicted models get a chance to free accelerator memory
        (ref: __del__-based release in multiplex.py)."""
        for attr in ("__serve_multiplex_unload__", "unload"):
            fn = getattr(model, attr, None)
            if callable(fn):
                try:
                    fn()
                except Exception:  # noqa: BLE001 — eviction best-effort
                    pass
                return

    def loaded_model_ids(self):
        with self._lock:
            return list(self._models)


def multiplexed(max_num_models_per_replica: int = 3):
    """Decorator on a replica's model-loader method (ref:
    serve.multiplexed)::

        @serve.deployment
        class Multi:
            @serve.multiplexed(max_num_models_per_replica=2)
            def get_model(self, model_id: str):
                return load_from_store(model_id)

            def __call__(self, x):
                model = self.get_model(serve.get_multiplexed_model_id())
                return model(x)
    """
    if max_num_models_per_replica <= 0:
        raise ValueError("max_num_models_per_replica must be positive")

    def decorate(fn: Callable):
        # the wrapper lives on the replica INSTANCE (or on the function
        # object for plain loaders) — closure state would make the
        # deployment class unpicklable
        attr = f"__serve_mux_{fn.__name__}"

        @functools.wraps(fn)
        def method(self_or_id, maybe_id=None):
            if maybe_id is None:  # plain function loader
                holder, self_obj, model_id = method, None, self_or_id
            else:
                holder, self_obj, model_id = \
                    self_or_id, self_or_id, maybe_id
            w = holder.__dict__.get(attr)
            if w is None:
                w = holder.__dict__.setdefault(
                    attr, _ModelMultiplexWrapper(
                        fn, self_obj, max_num_models_per_replica))
            return w.load_model(model_id)

        method.__serve_multiplexed__ = True
        return method

    return decorate
