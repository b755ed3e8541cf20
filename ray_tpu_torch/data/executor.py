"""Streaming executor: runs a logical plan as a pipelined task graph.

Ref analog: python/ray/data/_internal/execution/streaming_executor.py:49 —
a pull-based operator pipeline with bounded in-flight work. Re-designed at
block granularity: adjacent one-to-one ops are fused into a single remote
task per block (OperatorFusionRule analog); a block flows to its fused
transform as soon as its upstream task finishes (no stage barrier).

All-to-all ops (repartition/shuffle/sort/groupby) run as an **object-
plane-native pipelined exchange** (r17; the reference's push-based
shuffle, push_based_shuffle.py) on the shared task-graph executor
extracted from ``train/pipeline.py``:

- split tasks are submitted as upstream blocks ARRIVE (no ``list(gen)``
  drain), placed with soft locality on each block's holder node, and
  admission-gated by an in-flight window plus arena-fill backpressure
  from the per-node store gauges the head already exports;
- each output partition folds its incoming parts into a running
  accumulator every ``data_shuffle_merge_fanin`` parts and the terminal
  merge fires as soon as the partition's last part is submitted — every
  ``(input, output)`` part handle is dropped at merge-SUBMISSION time
  (eager free), so the store's intermediate footprint is
  O(n_out x (window + fanin)), not O(n_in x n_out);
- merge args ride dispatch-time PREFETCH_HINT / PREFETCH_HINT_BATCH
  (``data_shuffle_prefetch_hints``), so a merge's wide n_in-part pull
  overlaps earlier merges' compute, with the r6 striped pulls serving
  multi-holder reads.
"""

from __future__ import annotations

import itertools
import random
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch.core.object_ref import ObjectRef

from .block import BlockAccessor, batch_to_block, build_block
from .plan import (ActorPoolStrategy, AllToAll, InputData, Limit, MapBlocks,
                   Plan, Read, Union, Zip)

def _inflight_budget() -> int:
    """Per-stage submitted-but-unconsumed window (streaming backpressure).

    Resource-aware, like the reference's streaming executor budgets
    (streaming_executor_state.py): 2 tasks per cluster CPU keeps every
    core busy while one block per core is in flight downstream, instead
    of a hard-coded constant. Overridable via RAY_TPU_DATA_INFLIGHT."""
    import os

    override = os.environ.get("RAY_TPU_DATA_INFLIGHT")
    if override:
        return max(1, int(override))
    try:
        cpus = ray_tpu_torch.cluster_resources().get("CPU", 4)
    except Exception:  # noqa: BLE001 — not initialized yet
        cpus = 4
    return max(4, int(2 * cpus))


# ------------------------------------------------------------ fused mapper


def _apply_one(op: MapBlocks, block, block_idx: int = 0):
    acc = BlockAccessor(block)
    kind, fn = op.kind, op.fn
    if kind == "random_sample":
        # Per-block RNG seeded by (seed, block index): deterministic,
        # independent across blocks, and insensitive to row content (a
        # content hash would correlate duplicate rows — round-2 review).
        fraction, seed = fn
        rng = random.Random((seed, block_idx))
        return build_block([r for r in acc.iter_rows()
                            if rng.random() < fraction])
    if kind == "map_batches":
        out_blocks = []
        n = acc.num_rows()
        bs = op.batch_size or n or 1
        for start in range(0, max(n, 1), bs):
            if n == 0:
                break
            sub = BlockAccessor(acc.slice(start, min(start + bs, n)))
            batch = sub.to_batch(op.batch_format)
            res = fn(batch, *op.fn_args, **op.fn_kwargs)
            out_blocks.append(batch_to_block(res))
        return BlockAccessor.concat(out_blocks) if out_blocks else \
            build_block([])
    if kind == "map":
        return build_block([fn(r) for r in acc.iter_rows()])
    if kind == "filter":
        return build_block([r for r in acc.iter_rows() if fn(r)])
    if kind == "flat_map":
        out = []
        for r in acc.iter_rows():
            out.extend(fn(r))
        return build_block(out)
    if kind == "add_column":
        name, col_fn = fn
        rows = []
        for r in acc.iter_rows():
            r = dict(r)
            r[name] = col_fn(r)
            rows.append(r)
        return build_block(rows)
    if kind == "drop_columns":
        return build_block([{k: v for k, v in r.items() if k not in fn}
                            for r in acc.iter_rows()])
    if kind == "select_columns":
        return build_block([{k: r[k] for k in fn}
                            for r in acc.iter_rows()])
    raise ValueError(f"unknown map kind {kind}")


def _run_fused(ops: List[MapBlocks], block, block_idx: int = 0):
    for op in ops:
        op = _instantiate(op)
        block = _apply_one(op, block, block_idx)
    return block


def _instantiate(op: MapBlocks) -> MapBlocks:
    """Callable-class UDFs are constructed once per task here (actor pools
    construct once per actor instead)."""
    fn = op.fn
    if isinstance(fn, type):
        import dataclasses as _dc

        fn = fn(*(op.fn_constructor_args or ()))
        op = _dc.replace(op, fn=fn)
    return op


class _PoolWorker:
    """Actor for ActorPoolStrategy: holds the constructed UDF."""

    def __init__(self, ops_payload: bytes):
        from ray_tpu_torch.core.serialization import loads

        ops = loads(ops_payload)
        self._ops = [_instantiate(op) for op in ops]

    def apply(self, block, block_idx: int = 0):
        for op in self._ops:
            block = _apply_one(op, block, block_idx)
        return block


# -------------------------------------------------------------- all-to-all


def _split_for_partition(block, n: int, kind: str, seed, key):
    """Phase 1 of a two-phase exchange: split one block into n parts.

    Numpy-column blocks route COLUMNAR: only the routing values are
    materialized as python scalars — partition assignment uses the
    exact row-path recipes (same RNG call sequence, same bound
    comparisons, same `_det_hash` over ``tolist()`` scalars), then each
    part is an order-preserving take of row indices on every column —
    so output rows are identical to the row path while tensor columns
    stay ``[n, *row_shape]`` arrays, and no per-row dicts are built."""
    acc = BlockAccessor(block)
    assign = _routing(acc, n, kind, seed, key)
    if assign is None:
        return _split_rows(block, n, kind, seed, key)
    import numpy as np

    idx_all = np.asarray(assign, dtype=np.int64)
    return tuple(acc.take_rows(np.nonzero(idx_all == j)[0].tolist())
                 for j in range(n))


def _split_rows(block, n: int, kind: str, seed, key):
    """Row-path split: the pre-r17 kernel (kept verbatim — the
    columnar fallback AND the legacy drain exchange's kernel, so the
    bench baseline is byte-faithful to the pre-change executor)."""
    acc = BlockAccessor(block)
    rows = acc.to_pylist()
    parts: List[List[Any]] = [[] for _ in range(n)]
    if kind == "repartition":
        for i, r in enumerate(rows):
            parts[i % n].append(r)
    elif kind == "random_shuffle":
        rng = random.Random(seed)
        for r in rows:
            parts[rng.randrange(n)].append(r)
    elif kind == "sort":
        boundaries = key  # (sort_key, boundaries)
        sort_key, bounds = boundaries
        for r in rows:
            v = _key_of(r, sort_key)
            idx = sum(1 for b in bounds if v > b)
            parts[idx].append(r)
    elif kind == "groupby":
        for r in rows:
            parts[_det_hash(_key_of(r, key)) % n].append(r)
    else:
        raise ValueError(kind)
    return tuple(build_block(p) for p in parts)


def _routing(acc: BlockAccessor, n: int, kind: str, seed, key
             ) -> Optional[List[int]]:
    """Per-row partition assignment without materializing rows; None
    falls back to the row path (simple blocks, callable keys, tensor
    key columns)."""
    if not acc.is_columnar:
        return None
    nrows = acc.num_rows()
    if kind == "repartition":
        return [i % n for i in range(nrows)]
    if kind == "random_shuffle":
        rng = random.Random(seed)
        return [rng.randrange(n) for _ in range(nrows)]
    if kind == "sort":
        import bisect

        sort_key, bounds = key
        vals = acc.key_column(sort_key)
        if vals is None:
            return None
        # == the row path's `sum(1 for b in bounds if v > b)`:
        # bounds are sorted, so the count of strictly-smaller bounds
        # is the left insertion point
        return [bisect.bisect_left(bounds, v) for v in vals]
    if kind == "groupby":
        vals = acc.key_column(key)
        if vals is None:
            return None
        return [_det_hash(v) % n for v in vals]
    raise ValueError(kind)


def _det_hash(value) -> int:
    """Deterministic cross-process hash for exchange partitioning.

    Python's builtin hash() is salted per process (PYTHONHASHSEED), so two
    workers would route the same key to different partitions — silently
    duplicating groups (round-1 ADVICE, high). crc32 over the pickled key is
    stable across interpreters for the plain-data keys groupby supports.
    """
    import pickle
    import zlib

    return zlib.crc32(pickle.dumps(value, protocol=4))


def _key_of(row, key):
    if callable(key):
        return key(row)
    if isinstance(row, dict):
        return row[key]
    return row


def _merge_parts(kind, key, seed, descending, *parts):
    """Terminal merge of one output partition. Parts arrive in INPUT
    order (fold intermediates count as their range's head), so the
    concatenated row order — and therefore the seeded shuffle / stable
    sort below — is identical whether the parts were folded through
    ``_concat_parts`` trees or merged in one task (the pre-r17
    drain-based exchange): row-identical output either way.

    Numpy-column parts stay COLUMNAR: concat is one ``np.concatenate``
    a column, the seeded shuffle applies the identical Fisher-Yates
    permutation to row INDICES (``random.Random(seed).shuffle`` is
    positional — the permutation doesn't depend on row content), and
    the sort orders indices by the key column with Python's stable sort
    (same comparisons, same tie order as sorting the row dicts)."""
    merged = BlockAccessor.concat(list(parts))
    acc = BlockAccessor(merged)
    if kind == "random_shuffle":
        perm = list(range(acc.num_rows()))
        random.Random(seed).shuffle(perm)
        return acc.take_rows(perm)
    if kind == "sort":
        vals = acc.key_column(key) if acc.is_columnar else (
            None if callable(key) else
            [_key_of(r, key) for r in acc.iter_rows()])
        if vals is None:  # callable key / tensor column: row path
            rows = acc.to_pylist()
            rows.sort(key=lambda r: _key_of(r, key),
                      reverse=descending)
            return build_block(rows)
        order = sorted(range(len(vals)), key=vals.__getitem__,
                       reverse=descending)
        return acc.take_rows(order)
    return merged


def _merge_rows(kind, key, seed, descending, *parts):
    """Row-path merge: the pre-r17 kernel, verbatim (legacy exchange /
    bench baseline)."""
    rows: List[Any] = []
    for p in parts:
        rows.extend(BlockAccessor(p).to_pylist())
    if kind == "random_shuffle":
        random.Random(seed).shuffle(rows)
    elif kind == "sort":
        rows.sort(key=lambda r: _key_of(r, key), reverse=descending)
    return build_block(rows)


def _concat_parts(*parts):
    """Order-preserving fold step of the merge tree: pure concat —
    the kind-specific transform (seeded shuffle / sort) runs ONCE in
    the terminal ``_merge_parts``, so folding cannot change rows."""
    return BlockAccessor.concat(list(parts))


def _sample_keys(block, key, k: int):
    acc = BlockAccessor(block)
    rows = acc.to_pylist()
    rng = random.Random(0)
    picks = rows if len(rows) <= k else rng.sample(rows, k)
    return [_key_of(r, key) for r in picks]


# ------------------------------------------- exchange telemetry (r17)

#: Driver-side cumulative counters of the pipelined exchange —
#: mirrored into the cluster metric table as ``data.shuffle_*`` rows
#: per exchange (see ``_push_shuffle_metrics``); tests and benches read
#: this dict directly for single-process determinism.
SHUFFLE_STATS: Dict[str, int] = {
    "exchanges": 0,           # completed all-to-all exchanges
    "splits": 0,              # split tasks submitted
    "merges": 0,              # fold + terminal merge tasks submitted
    "parts_freed_eagerly": 0,  # part handles dropped at merge submission
    "backpressure_pauses": 0,  # admission pauses on arena-fill gauges
    "inflight_peak": 0,       # peak submitted-but-incomplete splits
}

_shuffle_metrics = None


def _push_shuffle_metrics(delta: Dict[str, int]) -> None:
    """Fold one exchange's deltas into the cluster metric table
    (``data.shuffle_*`` counters -> metrics_summary / /api/metrics /
    Prometheus). Lazy: metric objects registered on first exchange."""
    global _shuffle_metrics
    try:
        if _shuffle_metrics is None:
            from ray_tpu_torch.metrics import Counter

            _shuffle_metrics = {
                "exchanges": Counter(
                    "data.shuffle_exchanges",
                    "All-to-all exchanges run by the pipelined "
                    "shuffle (r17)"),
                "splits": Counter(
                    "data.shuffle_splits",
                    "Split tasks submitted by the pipelined exchange"),
                "merges": Counter(
                    "data.shuffle_merges",
                    "Fold + terminal merge tasks submitted"),
                "parts_freed_eagerly": Counter(
                    "data.shuffle_parts_freed",
                    "Intermediate part handles dropped at "
                    "merge-submission time (eager free)"),
                "backpressure_pauses": Counter(
                    "data.shuffle_backpressure_pauses",
                    "Split-admission pauses from per-node arena-fill "
                    "gauges (data_shuffle_store_highwater)"),
            }
        for k, m in _shuffle_metrics.items():
            if delta.get(k):
                m.inc(delta[k])
    except Exception:  # noqa: BLE001 — telemetry must never fail a job
        pass


_fill_cache = {"ts": 0.0, "fill": 0.0}


def _max_store_fill() -> float:
    """Worst per-node shm-store fill fraction, from the reporter gauges
    the head mirrors into its STATE-API node rows (``telemetry`` rides
    ``state.list_nodes``, NOT the slimmer ``ray_tpu_torch.nodes()`` reply).
    Cached 0.2s — admission runs per split, the head RPC must not."""
    now = time.monotonic()
    if now - _fill_cache["ts"] < 0.2:
        return _fill_cache["fill"]
    worst = 0.0
    try:
        from ray_tpu_torch.state import list_nodes

        for n in list_nodes():
            t = n.get("telemetry") or {}
            used = t.get("node.object_store_used_bytes", 0.0)
            cap = t.get("node.object_store_capacity_bytes", 0.0)
            if cap:
                worst = max(worst, used / cap)
    except Exception:  # noqa: BLE001 — head outage: don't throttle
        worst = 0.0
    _fill_cache["ts"] = now
    _fill_cache["fill"] = worst
    return worst


def _holder_affinity(ref):
    """Soft node affinity on a block's plasma holder (split locality:
    the split reads the whole block — running it where the bytes live
    moves nothing). None when the location is unknown or inline."""
    from ray_tpu_torch.core.api import NodeAffinitySchedulingStrategy
    from ray_tpu_torch.core.context import get_context_if_exists

    ctx = get_context_if_exists()
    if ctx is None:
        return None
    e = ctx.memory_store.peek(ref.id)
    if e is None or not e.in_plasma or e.node_idx < 0:
        return None
    return NodeAffinitySchedulingStrategy(e.node_idx, soft=True)


# --------------------------------------------------------------- executor


def _stream_stage(remote_fn, arg_iter):
    """Consumer-paced submission: keep at most the budget's worth of
    tasks submitted ahead of what downstream has pulled. Downstream map
    tasks wait on their input objects through the object plane, so block
    A can be in stage 3 while block B is still being read."""
    budget = _inflight_budget()
    pending: "deque" = deque()
    for args in arg_iter:
        pending.append(remote_fn.remote(*args))
        if len(pending) >= budget:
            yield pending.popleft()
    while pending:
        yield pending.popleft()


class StreamingExecutor:
    def __init__(self, plan: Plan):
        self.plan = plan

    # stage compilation: group the linear op chain into
    # [source] [fused maps | barrier | limit | union | zip]*
    def execute(self) -> List[ObjectRef]:
        return list(self.execute_streaming())

    def execute_streaming(self):
        """Lazy block-ref generator: map stages submit one task per block
        pulled by the consumer (window = _inflight_budget()), so a slow
        consumer pauses submission instead of the whole dataset
        materializing (ref: streaming_executor.py pull-based operators).
        All-to-all ops consume their upstream as a stream too (r17):
        splits submit as blocks arrive under the admission window, so
        upstream pacing survives into the exchange. Only ops that need
        the full ref LIST up front (zip; sort's boundary sampling;
        exchanges without an explicit ``num_blocks``, whose default
        partition count IS the input count) collect refs first — still
        submission-only, never a materialization barrier."""
        ops = self.plan.ops
        assert ops, "empty plan"
        gen = self._stream_source(ops[0])
        i = 1
        while i < len(ops):
            op = ops[i]
            if isinstance(op, MapBlocks):
                fused = []
                while i < len(ops) and isinstance(ops[i], MapBlocks) and \
                        ops[i].compute is None:
                    fused.append(ops[i])
                    i += 1
                if fused:
                    gen = self._stream_fused_maps(fused, gen)
                    continue
                # actor-pool stage (not fused with task stages):
                # streams refs as they are submitted; each actor is
                # retired when its last block completes (r17)
                gen = self._stream_actor_pool(op, gen)
                i += 1
            elif isinstance(op, AllToAll):
                # pipelined exchange: consumes the upstream STREAM —
                # split submission is admission-gated, not drained
                gen = iter(self._run_all_to_all(op, gen))
                i += 1
            elif isinstance(op, Limit):
                gen = iter(self._run_limit(op, list(gen)))
                i += 1
            elif isinstance(op, Union):
                gen = itertools.chain(
                    gen, *(StreamingExecutor(other).execute_streaming()
                           for other in op.others))
                i += 1
            elif isinstance(op, Zip):
                gen = iter(self._run_zip(op, list(gen)))
                i += 1
            else:
                raise ValueError(f"unexpected op {op}")
        yield from gen

    # ------------------------------------------------------------- stages

    def _stream_source(self, op):
        if isinstance(op, InputData):
            yield from list(op.block_refs)
            return
        assert isinstance(op, Read)
        parallelism = op.parallelism if op.parallelism > 0 else \
            max(2, int(ray_tpu_torch.cluster_resources().get("CPU", 2)))
        tasks = op.datasource.get_read_tasks(parallelism)
        read = ray_tpu_torch.remote(lambda t: t())
        yield from _stream_stage(read, ((t,) for t in tasks))

    def _stream_fused_maps(self, fused: List[MapBlocks], gen):
        run = ray_tpu_torch.remote(_run_fused)
        return _stream_stage(
            run, ((fused, r, i) for i, r in enumerate(gen)))

    def _stream_actor_pool(self, op: MapBlocks, gen):
        """ActorPoolStrategy stage as a STREAM (r17): refs yield as
        they are submitted (consumer-paced, like ``_stream_stage``) —
        downstream stages chain off the futures instead of barriering
        on the whole output list — and each actor is retired by a
        per-actor waiter the moment its LAST block completes (results
        must outlive the pool, but the stream must not wait for it).
        Actors spawn lazily, so a short stream never builds the full
        pool."""
        from ray_tpu_torch.core.serialization import dumps

        strategy: ActorPoolStrategy = op.compute
        import dataclasses as _dc

        payload = dumps([_dc.replace(op, compute=None)])
        pool_cls = ray_tpu_torch.remote(_PoolWorker)
        size = max(1, strategy.size)
        actors: List[Any] = []
        per_actor: List[List[Any]] = []

        def retire(actor, refs):
            # wait for EVERY outstanding block, however slow the UDF —
            # the pre-r17 pool waited unboundedly too, and killing a
            # busy actor fails blocks a consumer already owns. An actor
            # death resolves its pending refs to errors, so this loop
            # always terminates.
            try:
                while refs:
                    _, refs = ray_tpu_torch.wait(
                        refs, num_returns=len(refs), timeout=600,
                        fetch_local=False)
            except Exception:  # noqa: BLE001 — kill regardless
                pass
            try:
                ray_tpu_torch.kill(actor)
            except Exception:  # noqa: BLE001 — already gone
                pass

        budget = _inflight_budget()
        pending: deque = deque()
        try:
            for i, r in enumerate(gen):
                a = i % size
                if a >= len(actors):
                    actors.append(pool_cls.options(
                        num_cpus=strategy.num_cpus).remote(payload))
                    per_actor.append([])
                ref = actors[a].apply.remote(r, i)
                per_actor[a].append(ref)
                pending.append(ref)
                if len(pending) >= budget:
                    yield pending.popleft()
            while pending:
                yield pending.popleft()
        finally:
            # runs on exhaustion AND on abandonment (downstream limit /
            # partial take closing the generator): every spawned actor
            # gets its waiter, so the pool never leaks
            for actor, refs in zip(actors, per_actor):
                threading.Thread(target=retire, args=(actor, list(refs)),
                                 daemon=True,
                                 name="actor-pool-retire").start()

    def _run_all_to_all(self, op: AllToAll, gen) -> List[ObjectRef]:
        kind = op.options.get("kind", op.kind)
        key = op.options.get("key")
        seed = op.options.get("seed")
        descending = op.options.get("descending", False)
        n_out = op.options.get("num_blocks")
        if n_out is None or kind == "sort":
            # the default partition count IS the input count, and sort
            # needs every block for boundary sampling: collect the REF
            # stream (submission-only — blocks keep materializing in
            # parallel; no value is fetched here)
            refs = list(gen)
            if not refs:
                return refs
            gen = iter(refs)
            n_out = n_out or max(1, len(refs))
        if kind == "sort":
            # phase 0: sample range boundaries (ref: data sort_op sampling)
            sampler = ray_tpu_torch.remote(_sample_keys)
            samples = ray_tpu_torch.get(
                [sampler.remote(r, key, 20) for r in refs], timeout=600)
            flat = sorted(x for s in samples for x in s)
            if not flat:
                return refs
            step = max(1, len(flat) // n_out)
            bounds = flat[step::step][:n_out - 1]
            part_key = (key, bounds)
        else:
            part_key = key
        from ray_tpu_torch.core.config import get_config

        if not get_config().data_shuffle_pipelined:
            return self._drain_exchange(kind, n_out, key, part_key,
                                        seed, descending, gen)
        return self._pipelined_exchange(kind, n_out, key, part_key,
                                        seed, descending, gen)

    def _drain_exchange(self, kind: str, n_out: int, key, part_key,
                        seed, descending, ref_iter) -> List[ObjectRef]:
        """The pre-r17 exchange, preserved verbatim behind
        ``data_shuffle_pipelined=False``: drain the upstream ref
        stream, submit every split at once (no admission gating, no
        placement), hold all n_in x n_out parts to their terminal
        merges, row-path kernels. The bench baseline and the escape
        hatch for block shapes the columnar kernels mishandle."""
        refs = list(ref_iter)
        splitter = ray_tpu_torch.remote(_split_rows).options(
            num_returns=n_out)
        parts_by_input = []
        for i, r in enumerate(refs):
            s = seed if seed is None else seed + i
            res = splitter.remote(r, n_out, kind, s, part_key)
            parts_by_input.append(res if isinstance(res, list)
                                  else [res])
        merge = ray_tpu_torch.remote(_merge_rows)
        out = []
        for j in range(n_out):
            ins = [parts[j] for parts in parts_by_input]
            out.append(merge.remote(kind, key, seed, descending, *ins))
        if kind == "sort" and descending:
            out.reverse()
        return out

    def _pipelined_exchange(self, kind: str, n_out: int, key, part_key,
                            seed, descending, ref_iter
                            ) -> List[ObjectRef]:
        """The r17 streaming exchange (module docstring has the full
        picture). Built on ``core/task_graph.py``: split/fold/merge are
        TaskNodes; the executor's eager handle drop IS the footprint
        bound — every ``(input, output)`` part port is released the
        moment its fold/merge consumer is submitted."""
        from ray_tpu_torch.core.config import get_config
        from ray_tpu_torch.core.task_graph import Port, TaskGraphExecutor, \
            TaskNode

        from ray_tpu_torch.core.api import NodeAffinitySchedulingStrategy

        cfg = get_config()
        window = cfg.data_shuffle_inflight_window or _inflight_budget()
        fanin = max(2, cfg.data_shuffle_merge_fanin)
        hints = bool(cfg.data_shuffle_prefetch_hints)
        splitter = ray_tpu_torch.remote(_split_for_partition)
        # every partition gets a HOME node: its folds and terminal
        # merge run there (soft affinity), so each part crosses the
        # wire at most ONCE — split node -> home — instead of hopping
        # part -> fold node -> merge node (the reference pins its
        # push-based merge tasks to the reducer's node the same way)
        try:
            alive = sorted(n["node_idx"] for n in ray_tpu_torch.nodes()
                           if n.get("alive") and not n.get("draining"))
        except Exception:  # noqa: BLE001 — default placement
            alive = []
        homes = [alive[j % len(alive)] if len(alive) > 1 else None
                 for j in range(n_out)]

        def merge_fn(base, j, zero_cpu=False):
            # merge-side wide pulls ride dispatch-time prefetch hints
            # (the per-task opt-out is the bench's A/B control)
            opts = {"prefetch_args": hints}
            if zero_cpu:
                # folds are memory-bound concats racing a CPU-saturated
                # upstream: a CPU:1 fold gets soft-affinity-DIVERTED
                # off its home while maps hold the cores, and every
                # diverted fold moves its partition's bytes across the
                # wire twice (part -> fold node -> home). CPU:0 keeps
                # home placement feasible under load, so bytes cross
                # at most once.
                opts["num_cpus"] = 0
            if homes[j] is not None:
                opts["scheduling_strategy"] = \
                    NodeAffinitySchedulingStrategy(homes[j], soft=True)
            return base.options(**opts)

        fold = ray_tpu_torch.remote(_concat_parts)
        merge = ray_tpu_torch.remote(_merge_parts)
        g = TaskGraphExecutor()
        #: per output partition: dep specs in INPUT order — raw split
        #: parts and fold INTERMEDIATES (each standing for its input
        #: range at the range's chronological position, so terminal row
        #: order is identical to the drain-based exchange). Folding is
        #: a TREE, not an accumulator chain: every ``fanin`` raw parts
        #: fold into one intermediate (freeing the parts), and piled-up
        #: intermediates fold again — O(log_fanin) copies per row where
        #: a running accumulator would re-copy the partition per fold,
        #: and no fold ever waits on a long chain of predecessors.
        pending: List[List[Any]] = [[] for _ in range(n_out)]
        folded: List[List[Any]] = [[] for _ in range(n_out)]
        fold_seq = [0] * n_out
        #: sentinel part-0 refs of submitted splits (completion probes
        #: for the admission window; the held handle delays at most
        #: `window` part frees by the window's depth)
        inflight: deque = deque()
        d = {k: 0 for k in SHUFFLE_STATS}  # this exchange's deltas

        def add_fold(j: int, deps: List[Any]) -> None:
            node_key = ("fold", j, fold_seq[j])
            fold_seq[j] += 1

            def fn(*parts):
                return merge_fn(fold, j, zero_cpu=True).remote(*parts)

            g.add(TaskNode(node_key, fn, deps, lane=("merge", j)))
            d["merges"] += 1
            d["parts_freed_eagerly"] += len(deps)
            folded[j].append(node_key)
            if len(folded[j]) >= fanin:
                deeper, folded[j] = folded[j], []
                add_fold(j, deeper)

        n_in = 0
        for i, r in enumerate(ref_iter):
            n_in += 1
            self._admit(inflight, window, cfg, d)
            strat = _holder_affinity(r)
            s = seed if seed is None else seed + i

            def mk_split(strat=strat, s=s):
                def fn(block_ref):
                    sp = splitter.options(
                        num_returns=n_out,
                        scheduling_strategy=strat) if strat is not None \
                        else splitter.options(num_returns=n_out)
                    res = sp.remote(block_ref, n_out, kind, s, part_key)
                    return res if isinstance(res, list) else [res]

                return fn

            g.add_value(("in", i), r)
            g.add(TaskNode(("split", i), mk_split(), [("in", i)],
                           lane="split"))
            del r  # the executor's copy is the only driver handle now
            g.pump()
            d["splits"] += 1
            parts = g.value(("split", i))
            if parts and parts[0] is not None:
                inflight.append(parts[0])
            d["inflight_peak"] = max(d["inflight_peak"], len(inflight))
            for j in range(n_out):
                pending[j].append(Port(("split", i), j))
                if len(pending[j]) >= fanin:
                    deps, pending[j] = pending[j], []
                    add_fold(j, deps)
            g.pump()
        if n_in == 0:
            return []
        out_keys = []
        for j in range(n_out):
            # intermediates cover the oldest input ranges, raw tail
            # parts the newest: concatenation order stays the input
            # order, so the terminal transform sees identical rows
            deps = folded[j] + pending[j]
            folded[j], pending[j] = [], []

            def mk_merge(j=j):
                def fn(*parts):
                    return merge_fn(merge, j).remote(
                        kind, key, seed, descending, *parts)

                return fn

            # the terminal merge submits the moment its deps are — all
            # of partition j's parts exist by now, so run() fires every
            # merge immediately and drops the remaining part handles
            g.add(TaskNode(("out", j), mk_merge(), deps,
                           lane=("merge", j), keep=True))
            d["merges"] += 1
            d["parts_freed_eagerly"] += len(deps)
            out_keys.append(("out", j))
        kept = g.run()
        inflight.clear()
        out = [kept[k] for k in out_keys]
        if kind == "sort" and descending:
            # range partitions are ascending; descending output reverses
            # the partition order (rows within each are already descending)
            out.reverse()
        d["exchanges"] = 1
        for k, v in d.items():
            if k == "inflight_peak":
                SHUFFLE_STATS[k] = max(SHUFFLE_STATS[k], v)
            else:
                SHUFFLE_STATS[k] += v
        _push_shuffle_metrics(d)
        return out

    def _admit(self, inflight: deque, window: int, cfg, d) -> None:
        """Split-admission gate: (1) at most ``window`` splits
        submitted-but-incomplete; (2) while any node's store fill
        exceeds ``data_shuffle_store_highwater``, pause — in-flight
        merges keep freeing parts, so fill drains; past a 120s safety
        deadline admission proceeds anyway and the ordinary spill path
        absorbs the overflow (pacing must degrade, never deadlock)."""
        def compact(block_for: int = 0, timeout: float = 0.5) -> None:
            """Drop completed sentinels (optionally blocking for
            ``block_for`` of them first); FIFO order is preserved."""
            if not inflight:
                return
            if block_for:
                ray_tpu_torch.wait(list(inflight), num_returns=block_for,
                                   timeout=timeout, fetch_local=False)
            _, rest = ray_tpu_torch.wait(list(inflight),
                                         num_returns=len(inflight),
                                         timeout=0, fetch_local=False)
            inflight.clear()
            inflight.extend(rest)

        compact()
        if len(inflight) >= window:
            compact(block_for=len(inflight) - window + 1, timeout=600)
        high = cfg.data_shuffle_store_highwater
        if high <= 0:
            return
        deadline = None
        while _max_store_fill() > high:
            d["backpressure_pauses"] += 1
            now = time.monotonic()
            if deadline is None:
                deadline = now + 120.0
            elif now > deadline:
                break
            if inflight:
                compact(block_for=1)
            else:
                time.sleep(0.05)

    def _run_limit(self, op: Limit, refs: List[ObjectRef]) -> List[ObjectRef]:
        # one batched get for EVERY block's row count up front (r17) —
        # the per-block blocking get serialized the prefix walk into
        # one round trip per block
        counter = ray_tpu_torch.remote(
            lambda b: BlockAccessor(b).num_rows())
        counts = ray_tpu_torch.get([counter.remote(r) for r in refs],
                                   timeout=600) if refs else []
        slicer = ray_tpu_torch.remote(
            lambda b, n: BlockAccessor(b).slice(0, n))
        remaining = op.n
        out: List[ObjectRef] = []
        for r, cnt in zip(refs, counts):
            if remaining <= 0:
                break
            if cnt <= remaining:
                out.append(r)
                remaining -= cnt
            else:
                out.append(slicer.remote(r, remaining))
                remaining = 0
        return out

    def _run_zip(self, op: Zip, refs: List[ObjectRef]) -> List[ObjectRef]:
        other_refs = StreamingExecutor(op.other).execute()

        def zip_all(n_left, *blocks):
            # n_left is passed explicitly: the two sides may have different
            # block counts, so halving len(blocks) mis-assigns blocks
            # (round-1 ADVICE, medium).
            left = BlockAccessor(BlockAccessor.concat(
                list(blocks[:n_left]))).to_pylist()
            right = BlockAccessor(BlockAccessor.concat(
                list(blocks[n_left:]))).to_pylist()
            if len(left) != len(right):
                raise ValueError(
                    f"zip: datasets have different counts "
                    f"({len(left)} vs {len(right)})")
            out = []
            for a, b in zip(left, right):
                row = dict(a) if isinstance(a, dict) else {"left": a}
                if isinstance(b, dict):
                    for k, v in b.items():
                        row[k if k not in row else f"{k}_1"] = v
                else:
                    row["right"] = b
                out.append(row)
            return build_block(out)

        z = ray_tpu_torch.remote(zip_all)
        return [z.remote(len(refs), *refs, *other_refs)]


def execute_plan(plan: Plan) -> List[ObjectRef]:
    return StreamingExecutor(plan).execute()
