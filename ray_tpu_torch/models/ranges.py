"""Named ranges of the model code and the serving engine for
``torch.profiler``: a ``record_function`` range while a profiler session
is on, else a shared no-op context. ``record_function`` alone costs 8-11
us to enter and leave even when nothing records it, and the engine
enters ~130 ranges a decode chunk."""

from contextlib import nullcontext

import torch.autograd.profiler as _profiler
from torch.profiler import record_function

_NO_RANGE = nullcontext()


def profiled(name: str):
    """``with profiled("attn"): ...``: the range ``name`` in a profile."""
    if _profiler._is_profiler_enabled:
        return record_function(name)
    return _NO_RANGE
