"""Worker-side training session (ref: train/_internal/session.py:96).

Runs the user's train loop on a dedicated thread inside the worker actor and
shuttles `session.report(...)` results back to the driver through a queue the
actor drains from `get_next()` calls.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Dict, Optional


@dataclasses.dataclass
class TrainContext:
    world_rank: int = 0
    world_size: int = 1
    local_rank: int = 0
    local_world_size: int = 1
    node_rank: int = 0
    experiment_name: str = ""
    trial_id: str = ""
    coordinator_address: str = ""


class _Finished:
    def __init__(self, result=None, error=None):
        self.result = result
        self.error = error


class TrainSession:
    """One per worker process; owns the user-loop thread."""

    def __init__(self, train_fn, config: Dict[str, Any],
                 context: TrainContext, checkpoint=None, dataset_shard=None):
        self._train_fn = train_fn
        self._config = config or {}
        self.context = context
        self._checkpoint = checkpoint
        self._dataset_shards = dataset_shard or {}
        self._queue: "queue.Queue" = queue.Queue(maxsize=64)
        self._thread: Optional[threading.Thread] = None

    # -- driver-facing (called by the worker actor) --

    def start(self):
        def run():
            try:
                import inspect

                sig = inspect.signature(self._train_fn)
                if len(sig.parameters) == 0:
                    out = self._train_fn()
                else:
                    out = self._train_fn(self._config)
                self._queue.put(_Finished(result=out))
            except BaseException as e:  # noqa: BLE001 — forwarded to driver
                self._queue.put(_Finished(error=e))

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="train_loop")
        self._thread.start()

    def next_result(self, timeout: Optional[float] = None):
        """Blocks for the next report; returns ("report", payload) |
        ("done", result) | ("error", exc)."""
        item = self._queue.get(timeout=timeout)
        if isinstance(item, _Finished):
            if item.error is not None:
                return ("error", item.error)
            return ("done", item.result)
        return ("report", item)

    # -- user-facing (called from inside the train loop) --

    def report(self, metrics: Dict[str, Any], checkpoint=None):
        self._queue.put({"metrics": dict(metrics), "checkpoint": checkpoint})

    def get_checkpoint(self):
        return self._checkpoint

    def get_dataset_shard(self, name: str = "train"):
        return self._dataset_shards.get(name)


_session: Optional[TrainSession] = None
_session_lock = threading.Lock()


def _set_session(s: Optional[TrainSession]):
    global _session
    with _session_lock:
        _session = s


def _get_session() -> Optional[TrainSession]:
    return _session


# ---- public `ray_tpu_torch.train.session`-style API --------------------

def report(metrics: Dict[str, Any], checkpoint=None):
    s = _get_session()
    if s is None:
        raise RuntimeError("session.report() called outside a train session")
    s.report(metrics, checkpoint)


def get_checkpoint():
    s = _get_session()
    return s.get_checkpoint() if s else None


def get_context() -> TrainContext:
    s = _get_session()
    return s.context if s else TrainContext()


def get_dataset_shard(name: str = "train"):
    s = _get_session()
    return s.get_dataset_shard(name) if s else None


def get_world_rank() -> int:
    return get_context().world_rank


def get_world_size() -> int:
    return get_context().world_size


def get_local_rank() -> int:
    return get_context().local_rank
