"""Worker-side tune session: ``tune.report`` / ``tune.get_checkpoint``.

Ref analog: python/ray/tune's `session` (air/session.py) as used from inside
function trainables.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional

_local = threading.local()


def _set_reporter(reporter: Callable, checkpoint: Any = None):
    _local.reporter = reporter
    _local.checkpoint = checkpoint


def report(metrics: Dict[str, Any], *, checkpoint: Any = None):
    rep = getattr(_local, "reporter", None)
    if rep is None:
        raise RuntimeError("tune.report() called outside a tune session")
    rep(metrics, checkpoint)


def get_checkpoint() -> Optional[Any]:
    return getattr(_local, "checkpoint", None)
