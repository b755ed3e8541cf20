"""Trial state record (ref analog: python/ray/tune/experiment/trial.py)."""

from __future__ import annotations

import dataclasses
import time
import uuid
from typing import Any, Dict, List, Optional

PENDING = "PENDING"
RUNNING = "RUNNING"
PAUSED = "PAUSED"
TERMINATED = "TERMINATED"
ERROR = "ERROR"


@dataclasses.dataclass
class Trial:
    config: Dict[str, Any]
    trial_id: str = dataclasses.field(
        default_factory=lambda: uuid.uuid4().hex[:8])
    status: str = PENDING
    last_result: Dict[str, Any] = dataclasses.field(default_factory=dict)
    metric_history: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)
    iteration: int = 0
    error: Optional[str] = None
    checkpoint: Any = None           # latest in-memory checkpoint payload
    checkpoint_iter: int = 0
    start_time: float = dataclasses.field(default_factory=time.time)
    # scheduler scratch (e.g. ASHA bracket/rung assignment)
    scheduler_data: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def metric_value(self, metric: str):
        return self.last_result.get(metric)

    def is_finished(self) -> bool:
        return self.status in (TERMINATED, ERROR)

    def public_state(self) -> dict:
        return {
            "trial_id": self.trial_id,
            "config": self.config,
            "status": self.status,
            "iteration": self.iteration,
            "last_result": self.last_result,
            "error": self.error,
        }
