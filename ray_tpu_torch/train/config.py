"""Train/AIR-style configuration dataclasses.

Mirrors the reference's air/config.py (ScalingConfig/RunConfig/
CheckpointConfig/FailureConfig — SURVEY.md §2.4) with the reference's GPU
resource semantics: a worker is one training process, `gpus_per_worker`
counts the cards it leases (`CUDA_VISIBLE_DEVICES` shows it those alone),
and the placement group is the gang.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, List, Optional


@dataclasses.dataclass
class ScalingConfig:
    """How many workers (hosts) and what each one holds.

    Ref analog: python/ray/air/config.py ScalingConfig (num_workers,
    use_gpu, resources_per_worker).
    """

    num_workers: int = 1
    use_gpu: bool = False
    gpus_per_worker: Optional[int] = None
    cpus_per_worker: Optional[int] = None
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"

    def bundle(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker or {})
        res.setdefault("CPU", self.cpus_per_worker
                       if self.cpus_per_worker is not None else 1)
        if self.use_gpu or self.gpus_per_worker:
            res.setdefault("GPU", self.gpus_per_worker or 1)
        return res

    def bundles(self) -> List[Dict[str, float]]:
        return [self.bundle() for _ in range(self.num_workers)]


@dataclasses.dataclass
class CheckpointConfig:
    """Ref analog: air/config.py CheckpointConfig (top-K retention)."""

    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"  # or "min"

    def __post_init__(self):
        if self.checkpoint_score_order not in ("max", "min"):
            raise ValueError("checkpoint_score_order must be 'max' or 'min'")


@dataclasses.dataclass
class FailureConfig:
    """Gang-restart policy (ref: air/config.py FailureConfig).

    max_failures: total tolerated worker-group failures; -1 = unlimited.
    """

    max_failures: int = 0


@dataclasses.dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: Optional[FailureConfig] = None
    checkpoint_config: Optional[CheckpointConfig] = None
    # Tune stop criteria: dict (metric bounds / training_iteration) or
    # callable(trial_id, result) -> bool (ref: air/config.py RunConfig.stop)
    stop: Optional[Any] = None
    verbose: int = 1

    def resolved_storage_path(self) -> str:
        return self.storage_path or os.path.expanduser(
            "~/ray_tpu_torch_results")


@dataclasses.dataclass
class Result:
    """What `Trainer.fit` returns (ref: air/result.py)."""

    metrics: Dict[str, Any]
    checkpoint: Optional[Any]  # train.Checkpoint
    path: Optional[str] = None
    error: Optional[BaseException] = None
    metrics_history: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)

    @property
    def best_checkpoints(self):
        return getattr(self, "_best_checkpoints", [])
