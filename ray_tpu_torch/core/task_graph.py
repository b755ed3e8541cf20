"""Generic ref-gated task-graph executor (r17).

Extracted from ``train/pipeline.py``'s r15 ``run_batch`` walk so the
same execution discipline serves BOTH pipeline schedules and the data
layer's shuffle DAGs (ROADMAP item 5: "the refactor that earns a
generic task-graph-with-by-ref-edges executor"). The model:

- **nodes submit, the object plane executes.** A node's ``fn`` fires a
  remote call and returns its ``ObjectRef`` (or list of refs for
  ``num_returns > 1``); a node is *submittable* the moment every
  dependency has been SUBMITTED — not completed — because the ref IS
  the edge: the consuming task's arg fetch waits on the object plane,
  not on the driver. The driver only orders submissions.
- **lanes = intra-actor program order.** Nodes sharing a ``lane``
  submit in add order (per-actor task seqno order is the stage's local
  program in the pipeline; a shuffle keeps its splits in upstream
  order the same way). The walk round-robins lanes, draining each as
  far as dep gating allows — exactly r15's ``_run_wave`` loop.
- **eager handle drop.** Every produced ref is dropped the moment its
  LAST registered consumer has been submitted (the consumer's task-arg
  refcount keeps the object alive until that task completes, then the
  owner free reclaims the store copy promptly). Multi-return nodes
  free per PORT: ``deps=[(key, j)]`` consumes only return ``j``, so a
  shuffle merge releases its column of split parts without waiting for
  the other columns' consumers. ``keep=True`` exempts terminal outputs.

Static graphs call ``run()`` (wedge-checked, returns kept values);
dynamic graphs — a shuffle discovering upstream blocks as they arrive —
interleave ``add()`` with ``pump()`` and finish with ``run()``.
"""

from __future__ import annotations

import itertools
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, Hashable, Optional, \
    Sequence, Tuple, Union

class Port:
    """Dep spec consuming a single return of a multi-return node:
    ``Port(key, j)`` resolves to ``value_of(key)[j]`` and is
    ref-counted (and eagerly freed) per PORT, not per node — explicit
    so tuple-shaped node keys stay unambiguous."""

    __slots__ = ("key", "index")

    def __init__(self, key: Hashable, index: int):
        self.key = key
        self.index = index


DepSpec = Union[Hashable, Port]


class TaskNode:
    """One submission: ``fn(*dep_values)`` fires the remote call and
    returns the node's value (an ``ObjectRef``, a list of refs for
    multi-return tasks, or any placeholder). ``deps`` name upstream
    node keys — or ``Port(key, j)`` to consume a single return of a
    multi-return node. ``keep=True`` marks a terminal output whose
    handle survives the walk (everything else is dropped eagerly)."""

    __slots__ = ("key", "fn", "deps", "lane", "keep")

    def __init__(self, key: Hashable, fn: Callable[..., Any],
                 deps: Sequence[DepSpec] = (),
                 lane: Optional[Hashable] = None, keep: bool = False):
        self.key = key
        self.fn = fn
        self.deps = tuple(deps)
        self.lane = lane
        self.keep = keep


def _ports(dep: DepSpec) -> Tuple[Hashable, Optional[int]]:
    if isinstance(dep, Port):
        return dep.key, dep.index
    return dep, None


class TaskGraphExecutor:
    """Submission-order walk with by-ref edges and eager handle drop.

    Not thread-safe: one driver thread builds and pumps the graph (the
    pipeline's wave loop; the shuffle's streaming admission loop)."""

    def __init__(self):
        self._lanes: "OrderedDict[Hashable, deque]" = OrderedDict()
        self._vals: Dict[Hashable, Any] = {}
        self._keep: Dict[Hashable, Any] = {}
        self._keys: set = set()  # every key ever added (dup guard)
        self._submitted: set = set()
        self._pending = 0
        # (key, port|None) -> remaining registered consumers; freeing
        # fires on the decrement to zero, so a port registered before
        # its consumer exists (incremental graphs) never frees early
        self._consumers: Dict[Tuple[Hashable, Optional[int]], int] = {}
        # key -> count of PORT slots already freed (None'd): the whole
        # entry drops only once every slot is — a port whose consumer
        # is added LATER (incremental graphs fold lazily) must find its
        # ref still held, however many sibling ports released first
        self._freed_ports: Dict[Hashable, int] = {}
        self._anon = itertools.count()

    # ------------------------------------------------------- building

    def add(self, node: TaskNode) -> None:
        if node.key in self._keys:
            raise ValueError(f"duplicate task-graph key {node.key!r}")
        self._keys.add(node.key)
        for dep in node.deps:
            slot = _ports(dep)
            self._consumers[slot] = self._consumers.get(slot, 0) + 1
        lane = node.lane if node.lane is not None \
            else ("_anon", next(self._anon))
        self._lanes.setdefault(lane, deque()).append(node)
        self._pending += 1

    def add_value(self, key: Hashable, value: Any,
                  keep: bool = False) -> None:
        """Register an externally produced value (e.g. an upstream
        block ref) as an already-submitted node, subject to the same
        eager drop when its consumers submit."""
        if key in self._keys:
            raise ValueError(f"duplicate task-graph key {key!r}")
        self._keys.add(key)
        self._submitted.add(key)
        self._vals[key] = value
        if keep:
            self._keep[key] = value

    # ------------------------------------------------------- querying

    def pending(self) -> int:
        return self._pending

    def kept(self) -> Dict[Hashable, Any]:
        return dict(self._keep)

    def value(self, key: Hashable) -> Any:
        """Current stored value of a submitted node (ports already
        released by consumers read as None slots); None if unknown or
        fully dropped. For completion probes — holding a peeked ref
        delays its eager free for as long as the caller keeps it."""
        return self._vals.get(key)

    # ------------------------------------------------------- the walk

    def _submittable(self, node: TaskNode) -> bool:
        return all(_ports(d)[0] in self._submitted for d in node.deps)

    def _resolve(self, dep: DepSpec) -> Any:
        key, port = _ports(dep)
        val = self._vals.get(key)
        if port is None:
            return val
        return None if val is None else val[port]

    def _release(self, dep: DepSpec) -> None:
        key, port = _ports(dep)
        slot = (key, port)
        n = self._consumers.get(slot, 0) - 1
        if n > 0:
            self._consumers[slot] = n
            return
        self._consumers.pop(slot, None)
        if key in self._keep:
            return
        if port is None:
            self._vals.pop(key, None)
            return
        val = self._vals.get(key)
        if not (isinstance(val, list) and 0 <= port < len(val)):
            return
        val[port] = None  # this column's handle drops now
        freed = self._freed_ports.get(key, 0) + 1
        if freed >= len(val) and (key, None) not in self._consumers:
            self._freed_ports.pop(key, None)
            self._vals.pop(key, None)
        else:
            self._freed_ports[key] = freed

    def _submit(self, node: TaskNode) -> None:
        args = [self._resolve(d) for d in node.deps]
        value = node.fn(*args)
        del args
        self._submitted.add(node.key)
        self._pending -= 1
        res = list(value) if isinstance(value, (list, tuple)) else value
        self._vals[node.key] = res
        if node.keep:
            self._keep[node.key] = res
        # eager drop of the deps' handles — AFTER fn ran, so the
        # consumer task's arg refcount already pins the objects
        for dep in node.deps:
            self._release(dep)

    def pump(self) -> int:
        """Submit everything currently submittable (lane-ordered).
        Returns the number of submissions; 0 means the walk is blocked
        on nodes not yet added (dynamic graphs) or done."""
        total = 0
        while True:
            progressed = False
            for lane in list(self._lanes):
                q = self._lanes[lane]
                while q and self._submittable(q[0]):
                    self._submit(q.popleft())
                    progressed = True
                    total += 1
                if not q:
                    del self._lanes[lane]
            if not progressed:
                return total

    def run(self) -> Dict[Hashable, Any]:
        """Pump to completion; raises if the remaining graph cannot
        make progress (a dependency cycle or a dep never added — the
        r15 'pipeline submission wedged' guard, generalized). Returns
        the kept values and drops every internal handle."""
        self.pump()
        if self._pending:
            stuck = [n.key for q in self._lanes.values() for n in q]
            raise RuntimeError(
                f"task graph submission wedged; {self._pending} nodes "
                f"blocked (first few: {stuck[:5]})")
        self._vals.clear()
        self._consumers.clear()
        self._freed_ports.clear()
        kept, self._keep = self._keep, {}
        return kept
