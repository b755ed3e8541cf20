"""Read API: dataset constructors (ref: python/ray/data/read_api.py:294)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import numpy as np

import ray_tpu_torch

from .block import from_arrow as _block_from_arrow
from .block import from_numpy, from_pandas
from .dataset import Dataset, _plan_from_refs
from .datasource import (
    BinaryDatasource,
    CSVDatasource,
    Datasource,
    ItemsDatasource,
    JSONDatasource,
    NumpyDatasource,
    ParquetDatasource,
    RangeDatasource,
    TextDatasource,
)
from .plan import Plan, Read


def _read(ds: Datasource, parallelism: int = -1) -> Dataset:
    return Dataset(Plan([Read(name=f"read_{ds.name}", datasource=ds,
                              parallelism=parallelism)]))


def range(n: int, *, parallelism: int = -1) -> Dataset:  # noqa: A001
    return _read(RangeDatasource(n), parallelism)


def range_tensor(n: int, *, shape=(1,), parallelism: int = -1) -> Dataset:
    ds = range(n, parallelism=parallelism)
    import numpy as _np

    return ds.map_batches(
        lambda b: {"data": _np.stack(
            [_np.full(shape, i, dtype=_np.int64) for i in b["id"]])
            if len(b["id"]) else _np.zeros((0,) + tuple(shape))},
        batch_format="numpy")


def from_items(items: List[Any], *, parallelism: int = -1) -> Dataset:
    return _read(ItemsDatasource(items), parallelism)


def from_pandas_df(dfs) -> Dataset:
    if not isinstance(dfs, list):
        dfs = [dfs]
    refs = [ray_tpu_torch.put(from_pandas(df)) for df in dfs]
    return Dataset(_plan_from_refs(refs))


def from_numpy_arrays(arrays, column: str = "data") -> Dataset:
    """One block per item: an ndarray becomes the column ``column``, a
    dict of equal-length arrays the block's columns as given."""
    if not isinstance(arrays, list):
        arrays = [arrays]
    refs = [ray_tpu_torch.put(from_numpy(
        a if isinstance(a, dict) else {column: a})) for a in arrays]
    return Dataset(_plan_from_refs(refs))


def from_arrow(tables) -> Dataset:
    """pyarrow.Tables -> one numpy-column block each."""
    if not isinstance(tables, list):
        tables = [tables]
    return Dataset(_plan_from_refs(
        [ray_tpu_torch.put(_block_from_arrow(t)) for t in tables]))


def from_blocks(block_refs: List[Any]) -> Dataset:
    return Dataset(_plan_from_refs(block_refs))


def read_parquet(paths, *, columns: Optional[List[str]] = None,
                 parallelism: int = -1) -> Dataset:
    return _read(ParquetDatasource(paths, columns=columns), parallelism)


def read_csv(paths, *, parallelism: int = -1) -> Dataset:
    return _read(CSVDatasource(paths), parallelism)


def read_json(paths, *, parallelism: int = -1) -> Dataset:
    return _read(JSONDatasource(paths), parallelism)


def read_numpy(paths, *, parallelism: int = -1) -> Dataset:
    return _read(NumpyDatasource(paths), parallelism)


def read_text(paths, *, parallelism: int = -1) -> Dataset:
    return _read(TextDatasource(paths), parallelism)


def read_binary_files(paths, *, parallelism: int = -1) -> Dataset:
    return _read(BinaryDatasource(paths), parallelism)


def read_images(paths, *, size=None, mode=None,
                parallelism: int = -1) -> Dataset:
    """Image files -> rows {"image": HxWxC uint8, "path"} (ref:
    read_api.read_images; size=(H, W) resizes, mode converts e.g. RGB)."""
    from .datasource import ImageDatasource

    return _read(ImageDatasource(paths, size=size, mode=mode), parallelism)


def read_tfrecords(paths, *, parallelism: int = -1) -> Dataset:
    """tf.train.Example TFRecords -> one column per feature (ref:
    read_api.read_tfrecords; no-TF codec)."""
    from .datasource import TFRecordDatasource

    return _read(TFRecordDatasource(paths), parallelism)


def read_webdataset(paths, *, parallelism: int = -1) -> Dataset:
    """WebDataset .tar shards -> one row per sample key (ref:
    read_api.read_webdataset)."""
    from .datasource import WebDatasetDatasource

    return _read(WebDatasetDatasource(paths), parallelism)


def read_datasource(datasource: Datasource, *, parallelism: int = -1
                    ) -> Dataset:
    return _read(datasource, parallelism)
