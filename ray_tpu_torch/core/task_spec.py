"""Task specifications — the unit shipped from submitter to executor.

Analog of the reference's ``TaskSpecification`` (src/ray/common/task/
task_spec.h:244) and ``SchedulingClassDescriptor`` (:75). A spec carries the
function descriptor (pointer into the function table exported to the head
KV), serialized args (inline values or object references), resource demands,
retry policy, and scheduling strategy. Actor creation and actor-call tasks
are the same type with extra fields, as in the reference.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .ids import ActorID, JobID, ObjectID, PlacementGroupID, TaskID


class TaskType(enum.IntEnum):
    NORMAL = 0
    ACTOR_CREATION = 1
    ACTOR_TASK = 2


# Argument encodings inside a spec.
ARG_VALUE = 0   # ("v", frames)            — inline serialized value
ARG_REF = 1     # ("r", id_bytes, owner)   — pass by reference


@dataclass
class SchedulingStrategy:
    """DEFAULT / SPREAD / node-affinity / placement-group strategies
    (python/ray/util/scheduling_strategies.py:15,41,135 in the reference)."""

    kind: str = "DEFAULT"  # DEFAULT | SPREAD | NODE_AFFINITY | PLACEMENT_GROUP
    node_id: Optional[str] = None
    soft: bool = False
    placement_group_id: Optional[PlacementGroupID] = None
    bundle_index: int = -1
    capture_child_tasks: bool = False


@dataclass
class TaskSpec:
    task_id: TaskID
    job_id: JobID
    task_type: TaskType
    name: str
    function_id: str                       # key into head KV function table
    args: List[Tuple] = field(default_factory=list)
    kwarg_names: List[str] = field(default_factory=list)  # trailing args are kwargs
    num_returns: int = 1
    resources: Dict[str, float] = field(default_factory=dict)
    strategy: SchedulingStrategy = field(default_factory=SchedulingStrategy)
    max_retries: int = 0
    retry_exceptions: bool = False
    owner: str = ""                        # worker id hex of the submitter
    # actor fields
    actor_id: Optional[ActorID] = None
    class_name: str = ""                   # actor class, for observability
    method_name: str = ""
    seqno: int = 0
    max_restarts: int = 0
    max_concurrency: int = 1
    # options
    runtime_env: Optional[dict] = None
    # Dispatch-time speculative prefetch opt-out (r17): False excludes
    # this task's by-ref args from PREFETCH_HINT frames (grant-time
    # prefetch and demand fetches are unaffected). The data layer's
    # shuffle uses it as its hint A/B control
    # (`data_shuffle_prefetch_hints`).
    prefetch_args: bool = True
    # caller's active span context, (trace_id, parent_span_id), stamped at
    # submission so the executing worker parents its task span under the
    # submit site (reference: tracing_helper.py injecting the OpenTelemetry
    # context into the task spec's serialized runtime context)
    trace_ctx: Optional[Tuple[str, str]] = None
    # GPU assignment stamped by the head at lease grant (the reference's
    # CUDA_VISIBLE_DEVICES resource-instance ids; exported to the task as
    # CUDA_VISIBLE_DEVICES)
    gpu_ids: Optional[List[int]] = None

    def return_ids(self) -> List[ObjectID]:
        return [ObjectID.for_return(self.task_id, i + 1)
                for i in range(self.num_returns)]

    def scheduling_class(self) -> tuple:
        """Tasks with equal scheduling class can reuse each other's leased
        workers (reference: SchedulingClassDescriptor, task_spec.h:75)."""
        return (
            self.function_id if self.task_type == TaskType.NORMAL else self.task_id.hex(),
            tuple(sorted(self.resources.items())),
            self.strategy.kind,
            self.strategy.node_id,
            self.strategy.placement_group_id.hex()
            if self.strategy.placement_group_id else None,
            self.strategy.bundle_index,
        )


@dataclass
class Bundle:
    resources: Dict[str, float]


@dataclass
class PlacementGroupSpec:
    pg_id: PlacementGroupID
    bundles: List[Bundle]
    strategy: str = "PACK"  # PACK | SPREAD | STRICT_PACK | STRICT_SPREAD
    name: str = ""
    job_id: Optional[JobID] = None
