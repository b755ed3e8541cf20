"""Dataset: the lazy distributed data abstraction.

Ref analog: python/ray/data/dataset.py:174 (map_batches :387, split :1222,
iter_batches :3407, materialize :4601). Transforms append to a lazy logical
plan (plan.py); execution happens on consumption via the block-granular
streaming executor (executor.py). Blocks are numpy columns (block.py);
``to_pandas`` and ``to_arrow_refs`` convert at the edge.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Union

import ray_tpu_torch

from .block import BlockAccessor, build_block
from .executor import execute_plan
from .grouped import GroupedData
from .iterator import DataIterator
from .plan import (ActorPoolStrategy, AllToAll, InputData, Limit, MapBlocks,
                   Plan, Read, Union as UnionOp, Zip)


class _QueueRefStream:
    """Picklable one-shot block-ref source draining a Queue actor (the
    streaming_split consumer end; None is the end-of-stream sentinel)."""

    def __init__(self, q):
        self._q = q
        self._exhausted = False

    def __iter__(self):
        if self._exhausted:
            raise RuntimeError(
                "this streaming_split iterator is one-shot and already "
                "drained — call streaming_split again for another epoch")
        while True:
            item = self._q.get(timeout=600)
            if item is None or (isinstance(item, tuple) and
                                item[0] == "__stream_error__"):
                self._exhausted = True
                try:
                    self._q.shutdown()
                except Exception:  # noqa: BLE001 — already gone
                    pass
                if item is not None:
                    raise RuntimeError(
                        f"streaming_split execution failed: {item[1]}")
                return
            yield item[0]  # [ref] wrapping, see streaming_split pump


def _plan_from_refs(refs: List[Any]) -> Plan:
    return Plan([InputData(name="input_data", block_refs=list(refs))])


class Dataset:
    def __init__(self, plan: Plan):
        self._plan = plan
        self._cached_refs: Optional[List[Any]] = None

    # ------------------------------------------------------------ plumbing

    def _with_op(self, op) -> "Dataset":
        return Dataset(self._plan.with_op(op))

    def _with_all_to_all(self, kind: str, **options) -> "Dataset":
        options["kind"] = kind
        return self._with_op(AllToAll(name=kind, kind=kind, options=options))

    def _refs(self) -> List[Any]:
        if self._cached_refs is None:
            self._cached_refs = execute_plan(self._plan)
        return self._cached_refs

    # ---------------------------------------------------------- transforms

    def map_batches(self, fn: Callable, *, batch_size: Optional[int] = None,
                    batch_format: str = "numpy", compute=None,
                    fn_args: tuple = (), fn_kwargs: Optional[dict] = None,
                    fn_constructor_args: Optional[tuple] = None,
                    num_cpus: float = None, **_ignored) -> "Dataset":
        if compute is not None and not isinstance(compute, ActorPoolStrategy):
            raise TypeError("compute must be an ActorPoolStrategy")
        return self._with_op(MapBlocks(
            name=f"map_batches({getattr(fn, '__name__', type(fn).__name__)})",
            kind="map_batches", fn=fn, batch_size=batch_size,
            batch_format=batch_format, compute=compute, fn_args=fn_args,
            fn_kwargs=fn_kwargs or {},
            fn_constructor_args=fn_constructor_args))

    def map(self, fn: Callable) -> "Dataset":
        return self._with_op(MapBlocks(name="map", kind="map", fn=fn))

    def filter(self, fn: Callable) -> "Dataset":
        return self._with_op(MapBlocks(name="filter", kind="filter", fn=fn))

    def flat_map(self, fn: Callable) -> "Dataset":
        return self._with_op(MapBlocks(name="flat_map", kind="flat_map",
                                       fn=fn))

    def add_column(self, name: str, fn: Callable) -> "Dataset":
        return self._with_op(MapBlocks(name=f"add_column({name})",
                                       kind="add_column", fn=(name, fn)))

    def drop_columns(self, cols: List[str]) -> "Dataset":
        return self._with_op(MapBlocks(name="drop_columns",
                                       kind="drop_columns", fn=list(cols)))

    def select_columns(self, cols: List[str]) -> "Dataset":
        return self._with_op(MapBlocks(name="select_columns",
                                       kind="select_columns",
                                       fn=list(cols)))

    def repartition(self, num_blocks: int) -> "Dataset":
        return self._with_all_to_all("repartition", num_blocks=num_blocks)

    def random_shuffle(self, *, seed: Optional[int] = None,
                       num_blocks: Optional[int] = None) -> "Dataset":
        """Global random shuffle via the pipelined exchange.
        ``num_blocks`` sets the output partition count (ref parity:
        ``Dataset.random_shuffle(num_blocks=...)``); default keeps the
        input block count. Fewer, larger partitions mean fewer
        (input x output) exchange parts — worth setting when the input
        is many small blocks."""
        return self._with_all_to_all("random_shuffle",
                                     num_blocks=num_blocks,
                                     seed=seed if seed is not None
                                     else int(time.time() * 1000) & 0xffff)

    def sort(self, key: Union[str, Callable], descending: bool = False
             ) -> "Dataset":
        return self._with_all_to_all("sort", key=key, descending=descending)

    def groupby(self, key: str) -> GroupedData:
        return GroupedData(self, key)

    def limit(self, n: int) -> "Dataset":
        return self._with_op(Limit(name=f"limit({n})", n=n))

    def union(self, *others: "Dataset") -> "Dataset":
        return self._with_op(UnionOp(name="union",
                                     others=[o._plan for o in others]))

    def zip(self, other: "Dataset") -> "Dataset":
        return self._with_op(Zip(name="zip", other=other._plan))

    def random_sample(self, fraction: float,
                      *, seed: Optional[int] = None) -> "Dataset":
        # Executed as a dedicated block op seeded by (seed, block index):
        # a per-task Random(seed) would replay the identical sequence in
        # every block (the closure is re-unpickled per worker), correlating
        # draws across blocks (round-1 ADVICE, low).
        rng_seed = seed if seed is not None else int(time.time())
        return self._with_op(MapBlocks(
            name=f"random_sample({fraction})", kind="random_sample",
            fn=(fraction, rng_seed)))

    # --------------------------------------------------------- consumption

    def materialize(self) -> "Dataset":
        """Execute the plan now; the result holds concrete block refs
        (ref: dataset.py:4601)."""
        return Dataset(_plan_from_refs(self._refs()))

    def count(self) -> int:
        counter = ray_tpu_torch.remote(
            lambda b: BlockAccessor(b).num_rows())
        return sum(ray_tpu_torch.get(
            [counter.remote(r) for r in self._refs()], timeout=600))

    def take(self, n: int = 20) -> List[Any]:
        out: List[Any] = []
        for ref in self._refs():
            block = ray_tpu_torch.get(ref, timeout=600)
            for row in BlockAccessor(block).iter_rows():
                out.append(row)
                if len(out) >= n:
                    return out
        return out

    def take_all(self) -> List[Any]:
        out: List[Any] = []
        for ref in self._refs():
            out.extend(BlockAccessor(
                ray_tpu_torch.get(ref, timeout=600)).iter_rows())
        return out

    def show(self, n: int = 20):
        for row in self.take(n):
            print(row)

    def schema(self):
        for ref in self._refs():
            acc = BlockAccessor(ray_tpu_torch.get(ref, timeout=600))
            if acc.num_rows():
                return acc.schema()
        return None

    def columns(self) -> Optional[List[str]]:
        s = self.schema()
        return list(s.names) if hasattr(s, "names") else None

    def num_blocks(self) -> int:
        return len(self._refs())

    def size_bytes(self) -> int:
        sizer = ray_tpu_torch.remote(
            lambda b: BlockAccessor(b).size_bytes())
        return sum(ray_tpu_torch.get(
            [sizer.remote(r) for r in self._refs()], timeout=600))

    def sum(self, col: str):
        vals = self._column_reduce(col, "sum")
        return sum(vals)

    def min(self, col: str):
        return min(self._column_reduce(col, "min"))

    def max(self, col: str):
        return max(self._column_reduce(col, "max"))

    def mean(self, col: str):
        pairs = self._column_reduce(col, "mean")
        total = sum(p[0] for p in pairs)
        return sum(p[1] for p in pairs) / total if total else None

    def std(self, col: str) -> float:
        import numpy as np

        rows = [r[col] for r in self.take_all()]
        return float(np.std(rows, ddof=1)) if len(rows) > 1 else 0.0

    def _column_reduce(self, col: str, kind: str) -> List[Any]:
        def partial(block):
            acc = BlockAccessor(block)
            vals = [r[col] for r in acc.iter_rows()]
            if not vals:
                return None
            if kind == "sum":
                return sum(vals)
            if kind == "min":
                return min(vals)
            if kind == "max":
                return max(vals)
            if kind == "mean":
                return (len(vals), sum(vals))
            raise ValueError(kind)

        task = ray_tpu_torch.remote(partial)
        out = ray_tpu_torch.get([task.remote(r) for r in self._refs()],
                                timeout=600)
        vals = [v for v in out if v is not None]
        if not vals:
            raise ValueError(f"no rows with column {col}")
        return vals

    def unique(self, col: str) -> List[Any]:
        return sorted({r[col] for r in self.take_all()})

    # ---------------------------------------------------------- iteration

    def iter_rows(self) -> Iterator[Any]:
        return self.iterator().iter_rows()

    def iter_batches(self, **kw) -> Iterator[Any]:
        return self.iterator().iter_batches(**kw)

    def iter_torch_batches(self, **kw) -> Iterator[Any]:
        """Batches as torch tensors on a device, CUDA by default
        (``DataIterator.iter_torch_batches``)."""
        return self.iterator().iter_torch_batches(**kw)

    def iterator(self) -> DataIterator:
        return DataIterator(self._refs())

    def to_pandas(self):
        from .block import _require

        pd = _require("pandas")
        dfs = [BlockAccessor(ray_tpu_torch.get(r, timeout=600)).to_pandas()
               for r in self._refs()]
        dfs = [d for d in dfs if len(d)]
        return pd.concat(dfs, ignore_index=True) if dfs else pd.DataFrame()

    def to_arrow_refs(self) -> List[Any]:
        """Refs of the blocks as pyarrow.Tables, converted in tasks."""
        from .block import _require

        _require("pyarrow")
        to_arrow = ray_tpu_torch.remote(
            lambda b: BlockAccessor(b).to_arrow())
        return [to_arrow.remote(r) for r in self._refs()]

    # ------------------------------------------------------------ splitting

    def split(self, n: int, *, equal: bool = False) -> List["Dataset"]:
        """Split into n datasets (ref: dataset.py:1222). equal=True slices
        blocks at exact row boundaries so shard sizes differ by at most 1
        (the reference's _split_at_indices)."""
        refs = self._refs()
        if not equal and len(refs) >= n:
            shards: List[List[Any]] = [[] for _ in range(n)]
            for i, r in enumerate(refs):
                shards[i % n].append(r)
            return [Dataset(_plan_from_refs(s)) for s in shards]
        counter = ray_tpu_torch.remote(
            lambda b: BlockAccessor(b).num_rows())
        counts = ray_tpu_torch.get([counter.remote(r) for r in refs],
                                   timeout=600)
        total = sum(counts)
        base, extra = divmod(total, n)
        targets = [base + (1 if i < extra else 0) for i in range(n)]
        slicer = ray_tpu_torch.remote(
            lambda b, s, e: BlockAccessor(b).slice(s, e))
        shard_refs: List[List[Any]] = [[] for _ in range(n)]
        shard_i, need = 0, targets[0] if n else 0
        for ref, cnt in zip(refs, counts):
            offset = 0
            while offset < cnt and shard_i < n:
                take = min(need, cnt - offset)
                if take == cnt and offset == 0:
                    shard_refs[shard_i].append(ref)  # whole block, no task
                elif take > 0:
                    shard_refs[shard_i].append(
                        slicer.remote(ref, offset, offset + take))
                offset += take
                need -= take
                while need == 0 and shard_i < n - 1:
                    shard_i += 1
                    need = targets[shard_i]
                if need == 0:
                    break
        return [Dataset(_plan_from_refs(s)) for s in shard_refs]

    def streaming_split(self, n: int, *, equal: bool = True,
                        locality_hints=None) -> List[DataIterator]:
        """Per-consumer iterators over ONE shared streaming execution
        (ref: streaming_split + output_splitter.py:19): blocks are dealt
        round-robin to n bounded per-consumer queues as they are
        produced; a lagging consumer's full queue pauses the pump, which
        pauses upstream task submission (backpressure all the way to the
        source) instead of materializing the dataset. One-shot: iterate
        each split once per execution (call again for another epoch).

        If the plan was already executed (cached refs), the cached blocks
        are dealt instead — same consumer API, no re-execution.

        The per-consumer queues are Queue ACTORS, so the returned
        iterators are picklable and consumable from Train worker
        processes (the driver-side pump thread feeds them).

        ``equal=True`` deals whole ROUNDS of n blocks and drops a trailing
        partial round, so every consumer receives the same block count
        (the reference's equal splits may likewise drop tail rows to
        equalize; row counts still vary with block sizes).
        ``locality_hints`` is accepted for API parity and ignored — the
        queues live with the driver, not on consumer nodes."""
        import threading

        from ray_tpu_torch.utils.queue import Queue

        from .executor import StreamingExecutor

        if self._cached_refs is not None:
            gen = iter(self._cached_refs)
        else:
            gen = StreamingExecutor(self._plan).execute_streaming()
        queues: List[Queue] = [Queue(maxsize=4) for _ in range(n)]

        def pump():
            # wrapped [ref]: a bare ObjectRef argument would be resolved
            # to its value on the queue actor; the list stores the REF
            error = None
            try:
                if equal:
                    rounds = 0
                    round_buf = []
                    for ref in gen:
                        round_buf.append(ref)
                        if len(round_buf) == n:
                            for q, r in zip(queues, round_buf):
                                q.put([r], timeout=None)
                            round_buf.clear()
                            rounds += 1
                    if round_buf and rounds == 0:
                        # fewer blocks than consumers: equality is
                        # impossible, but dropping 100% of the data
                        # would be worse — deal what exists
                        for q, r in zip(queues, round_buf):
                            q.put([r], timeout=None)
                    # otherwise the trailing partial round is dropped
                    # (see docstring)
                else:
                    for i, ref in enumerate(gen):
                        queues[i % n].put([ref], timeout=None)
            except BaseException as e:  # noqa: BLE001 — surface downstream
                error = e
            finally:
                for q in queues:
                    try:
                        # error sentinel re-raises at every consumer — a
                        # silent clean end would truncate the dataset
                        q.put(("__stream_error__", repr(error))
                              if error is not None else None)
                    except Exception:  # noqa: BLE001 — consumer gone
                        pass

        threading.Thread(target=pump, daemon=True,
                         name="streaming-split-pump").start()
        return [DataIterator(_QueueRefStream(q), name=f"split_{i}")
                for i, q in enumerate(queues)]

    def train_test_split(self, test_size: float, *,
                         shuffle: bool = False,
                         seed: Optional[int] = None):
        ds = self.random_shuffle(seed=seed) if shuffle else self
        rows = ds.take_all()
        k = int(len(rows) * (1 - test_size))
        return tuple(Dataset(_plan_from_refs(
            [ray_tpu_torch.put(build_block(part))]))
            for part in (rows[:k], rows[k:]))

    # -------------------------------------------------------------- output

    def write_parquet(self, path: str):
        self._write(path, "parquet")

    def write_csv(self, path: str):
        self._write(path, "csv")

    def write_json(self, path: str):
        self._write(path, "json")

    def _write(self, path: str, fmt: str):
        from .datasource import write_block_to_file

        os.makedirs(path, exist_ok=True)
        ext = {"parquet": ".parquet", "csv": ".csv", "json": ".json"}[fmt]

        def write_one(block, out_path):
            write_block_to_file(block, out_path, fmt)
            return out_path

        task = ray_tpu_torch.remote(write_one)
        refs = self._refs()
        ray_tpu_torch.get(
            [task.remote(r, os.path.join(path, f"part_{i:05d}{ext}"))
             for i, r in enumerate(refs)], timeout=600)

    def stats(self) -> str:
        return f"Dataset(plan: {self._plan!r}, " \
               f"{'materialized' if self._cached_refs else 'lazy'})"

    def __repr__(self):
        return f"Dataset({self._plan!r})"
