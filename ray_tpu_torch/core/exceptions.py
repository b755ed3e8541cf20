"""User-visible exceptions (analog of python/ray/exceptions.py)."""

from __future__ import annotations


class RayTpuError(Exception):
    pass


class TaskError(RayTpuError):
    """Wraps an exception raised inside a remote task; re-raised on get()."""

    def __init__(self, cause_repr: str, traceback_str: str, cause=None):
        self.cause_repr = cause_repr
        self.traceback_str = traceback_str
        self.cause = cause
        super().__init__(f"task failed: {cause_repr}\n{traceback_str}")

    def __reduce__(self):
        import pickle

        cause = self.cause
        try:
            pickle.dumps(cause)
        except Exception:
            cause = None
        return (TaskError, (self.cause_repr, self.traceback_str, cause))

    def as_instance(self):
        if isinstance(self.cause, BaseException):
            return RayTaskError(self)
        return self


class RayTaskError(RayTpuError):
    def __init__(self, task_error: TaskError):
        self.task_error = task_error
        super().__init__(str(task_error))

    @property
    def cause(self):
        return self.task_error.cause

    def __reduce__(self):
        return (RayTaskError, (self.task_error,))


class WorkerCrashedError(RayTpuError):
    pass


class ActorDiedError(RayTpuError):
    pass


class ActorUnavailableError(RayTpuError):
    pass


class ObjectLostError(RayTpuError):
    pass


class GetTimeoutError(RayTpuError, TimeoutError):
    pass


class TaskCancelledError(RayTpuError):
    pass


class PlacementGroupError(RayTpuError):
    pass
