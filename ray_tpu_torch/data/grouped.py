"""GroupedData: aggregations after Dataset.groupby.

Ref analog: python/ray/data/grouped_data.py (GroupedData, AggregateFn).
Hash-partition exchange happens in the executor; per-partition aggregation
runs here as a fused map stage over the partitioned blocks.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .block import BlockAccessor, build_block


class AggregateFn:
    def __init__(self, init: Callable, accumulate: Callable,
                 finalize: Callable = None, name: str = "agg"):
        self.init = init
        self.accumulate = accumulate
        self.finalize = finalize or (lambda acc: acc)
        self.name = name


def _std_agg(col):
    # Welford accumulators (count, mean, M2)
    return AggregateFn(
        init=lambda: (0, 0.0, 0.0),
        accumulate=lambda acc, r: _welford(acc, float(r[col])),
        finalize=lambda acc: float(np.sqrt(acc[2] / (acc[0] - 1)))
        if acc[0] > 1 else 0.0,
        name=f"std({col})")


def _welford(acc, x):
    n, mean, m2 = acc
    n += 1
    d = x - mean
    mean += d / n
    m2 += d * (x - mean)
    return (n, mean, m2)


def _col_agg(col: Optional[str], kind: str) -> AggregateFn:
    def val(r):
        if col is None:
            return r if not isinstance(r, dict) else next(iter(r.values()))
        return r[col]

    if kind == "count":
        return AggregateFn(lambda: 0, lambda a, r: a + 1,
                           name="count()")
    if kind == "sum":
        return AggregateFn(lambda: 0, lambda a, r: a + val(r),
                           name=f"sum({col})")
    if kind == "min":
        return AggregateFn(lambda: None,
                           lambda a, r: val(r) if a is None
                           else min(a, val(r)),
                           name=f"min({col})")
    if kind == "max":
        return AggregateFn(lambda: None,
                           lambda a, r: val(r) if a is None
                           else max(a, val(r)),
                           name=f"max({col})")
    if kind == "mean":
        return AggregateFn(
            lambda: (0, 0.0),
            lambda a, r: (a[0] + 1, a[1] + val(r)),
            lambda a: a[1] / a[0] if a[0] else None,
            name=f"mean({col})")
    if kind == "std":
        return _std_agg(col)
    raise ValueError(kind)


def _aggregate_partition(block, key, aggs: List[AggregateFn]):
    """Runs on one hash partition: all rows of a group are co-located."""
    acc = BlockAccessor(block)
    groups: Dict[Any, list] = {}
    for r in acc.iter_rows():
        k = r[key] if isinstance(r, dict) else r
        groups.setdefault(k, []).append(r)
    out = []
    for k in sorted(groups, key=lambda x: (x is None, x)):
        row = {key: k} if key else {}
        for agg in aggs:
            a = agg.init()
            for r in groups[k]:
                a = agg.accumulate(a, r)
            row[agg.name] = agg.finalize(a)
        out.append(row)
    return build_block(out)


def _map_groups_partition(block, key, fn, batch_format):
    acc = BlockAccessor(block)
    groups: Dict[Any, list] = {}
    for r in acc.iter_rows():
        k = r[key] if isinstance(r, dict) else r
        groups.setdefault(k, []).append(r)
    outs = []
    for k in sorted(groups, key=lambda x: (x is None, x)):
        sub = BlockAccessor(build_block(groups[k]))
        res = fn(sub.to_batch(batch_format))
        from .block import batch_to_block

        outs.append(batch_to_block(res))
    return BlockAccessor.concat(outs) if outs else build_block([])


class GroupedData:
    def __init__(self, dataset, key: str):
        self._ds = dataset
        self._key = key

    def _agg(self, aggs: List[AggregateFn]):
        from .plan import MapBlocks

        ds = self._ds._with_all_to_all("groupby", key=self._key)
        return ds._with_op(MapBlocks(
            name="aggregate", kind="map_batches",
            fn=_PartitionAggregator(self._key, aggs),
            batch_format="native"))

    def aggregate(self, *aggs: AggregateFn):
        return self._agg(list(aggs))

    def count(self):
        return self._agg([_col_agg(None, "count")])

    def sum(self, col: str):
        return self._agg([_col_agg(col, "sum")])

    def min(self, col: str):
        return self._agg([_col_agg(col, "min")])

    def max(self, col: str):
        return self._agg([_col_agg(col, "max")])

    def mean(self, col: str):
        return self._agg([_col_agg(col, "mean")])

    def std(self, col: str):
        return self._agg([_col_agg(col, "std")])

    def map_groups(self, fn, *, batch_format: str = "native"):
        from .plan import MapBlocks

        ds = self._ds._with_all_to_all("groupby", key=self._key)
        key = self._key
        return ds._with_op(MapBlocks(
            name="map_groups", kind="map_batches",
            fn=_PartitionGroupMapper(key, fn, batch_format),
            batch_format="native"))


class _PartitionGroupMapper:
    """Whole-block UDF: regroups a partition's rows then applies fn."""

    def __init__(self, key, fn, batch_format):
        self.key, self.fn, self.batch_format = key, fn, batch_format

    def __call__(self, batch):
        # batch arrives in 'native' format; rebuild a block from it
        from .block import batch_to_block

        block = batch_to_block(batch) if not isinstance(batch, list) \
            else build_block(batch)
        return BlockAccessor(
            _map_groups_partition(block, self.key, self.fn,
                                  self.batch_format)).to_batch("native")


class _PartitionAggregator:
    def __init__(self, key, aggs):
        self.key, self.aggs = key, aggs

    def __call__(self, batch):
        from .block import batch_to_block

        block = batch_to_block(batch) if not isinstance(batch, list) \
            else build_block(batch)
        return BlockAccessor(
            _aggregate_partition(block, self.key, self.aggs)
        ).to_batch("native")
