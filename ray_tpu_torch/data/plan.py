"""Lazy logical plan for Datasets.

Ref analogs: python/ray/data/_internal/logical/ (operators + plan) and
_internal/plan.py:82 (ExecutionPlan). A plan is a linear chain of logical
ops (sources at the head); the executor fuses adjacent one-to-one ops into
single tasks (the reference's OperatorFusionRule) and runs barrier ops
(shuffle/sort/groupby) as two-phase task graphs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple


@dataclasses.dataclass
class LogicalOp:
    name: str


@dataclasses.dataclass
class Read(LogicalOp):
    datasource: Any
    parallelism: int = -1


@dataclasses.dataclass
class InputData(LogicalOp):
    """Pre-existing block refs (from_blocks / materialized data)."""

    block_refs: List[Any] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class MapBlocks(LogicalOp):
    """One-to-one block transform; fusable.

    kind: 'map_batches' | 'map' | 'filter' | 'flat_map' | 'add_column' |
          'drop_columns' | 'select_columns'
    """

    kind: str = "map_batches"
    fn: Callable = None
    fn_constructor_args: Optional[tuple] = None
    batch_size: Optional[int] = None
    batch_format: str = "numpy"
    compute: Any = None          # None => tasks; ActorPoolStrategy => actors
    fn_args: tuple = ()
    fn_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class AllToAll(LogicalOp):
    """Barrier op: 'repartition' | 'random_shuffle' | 'sort' | 'groupby'."""

    kind: str = "repartition"
    options: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Limit(LogicalOp):
    n: int = 0


@dataclasses.dataclass
class Union(LogicalOp):
    others: List["Plan"] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Zip(LogicalOp):
    other: "Plan" = None


class ActorPoolStrategy:
    """compute= strategy for map_batches over a pool of reusable actors
    (ref: data/_internal/compute.py ActorPoolStrategy)."""

    def __init__(self, size: int = 2, min_size: int = None,
                 max_size: int = None, num_cpus: float = 1):
        self.size = size if max_size is None else max_size
        self.num_cpus = num_cpus


class Plan:
    def __init__(self, ops: List[LogicalOp]):
        self.ops = ops

    def with_op(self, op: LogicalOp) -> "Plan":
        return Plan(self.ops + [op])

    def __repr__(self):
        return " -> ".join(op.name for op in self.ops)
