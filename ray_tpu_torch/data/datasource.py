"""Datasources: lazily-evaluated read tasks.

Ref analogs: python/ray/data/datasource/ (Datasource/ReadTask) and
read_api.py:294. A Datasource yields ReadTasks — zero-arg callables, each
producing one block — which the executor runs as remote tasks.

Every source gives numpy-column blocks. Parquet and CSV read through
pyarrow, images through PIL, each imported where it is used (ImportError
naming the package when it is missing); numpy, text, binary, JSON,
TFRecord and WebDataset (without image members) need neither.
"""

from __future__ import annotations

import glob as _glob
import os
from typing import Any, Callable, Dict, Iterable, List, Optional, Union

import numpy as np

from .block import Block, _require, build_block, from_arrow, from_numpy

ReadTask = Callable[[], Block]


class Datasource:
    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        raise NotImplementedError

    def estimate_inmemory_size(self) -> Optional[int]:
        return None

    @property
    def name(self) -> str:
        return type(self).__name__


class RangeDatasource(Datasource):
    def __init__(self, n: int, column: str = "id"):
        self.n = n
        self.column = column

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        parallelism = max(1, min(parallelism, self.n or 1))
        chunk = -(-self.n // parallelism)
        tasks = []
        col = self.column
        for start in range(0, self.n, chunk):
            end = min(start + chunk, self.n)

            def task(start=start, end=end):
                return from_numpy({col: np.arange(start, end)})

            tasks.append(task)
        return tasks or [lambda: build_block([])]


class ItemsDatasource(Datasource):
    def __init__(self, items: List[Any]):
        self.items = list(items)

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        n = len(self.items)
        parallelism = max(1, min(parallelism, n or 1))
        chunk = -(-n // parallelism) if n else 1
        tasks = []
        for start in range(0, n, chunk):
            part = self.items[start:start + chunk]
            tasks.append(lambda part=part: build_block(part))
        return tasks or [lambda: build_block([])]


def _expand_paths(paths: Union[str, List[str]], suffix) -> List[str]:
    """``suffix`` may be one extension or a tuple of alternatives
    (image datasources match several)."""
    suffixes = (suffix,) if isinstance(suffix, str) else tuple(suffix)
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            hits: List[str] = []
            for sfx in suffixes:
                hits.extend(_glob.glob(os.path.join(p, f"*{sfx}")))
            out.extend(sorted(set(hits)))
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(_glob.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no files found for {paths}")
    return out


class FileDatasource(Datasource):
    """One read task per file (parallelism capped at #files)."""

    suffix = ""
    #: the edge package every file of this source needs, imported at
    #: construction so that a missing one fails on the driver, at once
    requires: Optional[str] = None

    def __init__(self, paths: Union[str, List[str]], **options):
        if self.requires:
            _require(self.requires)
        self.paths = _expand_paths(paths, self.suffix)
        self.options = options

    def read_file(self, path: str) -> Block:
        raise NotImplementedError

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        return [lambda p=p: self.read_file(p) for p in self.paths]


class ParquetDatasource(FileDatasource):
    suffix = ".parquet"
    requires = "pyarrow.parquet"

    def read_file(self, path: str) -> Block:
        pq = _require("pyarrow.parquet")

        return from_arrow(pq.read_table(
            path, columns=self.options.get("columns")))


class CSVDatasource(FileDatasource):
    suffix = ".csv"
    requires = "pyarrow.csv"

    def read_file(self, path: str) -> Block:
        pa_csv = _require("pyarrow.csv")

        return from_arrow(pa_csv.read_csv(path))


class JSONDatasource(FileDatasource):
    suffix = ".json"

    def read_file(self, path: str) -> Block:
        import json

        with open(path) as f:
            text = f.read().strip()
        try:
            data = json.loads(text)
            if isinstance(data, dict):
                data = [data]
        except json.JSONDecodeError:  # JSONL
            data = [json.loads(line) for line in text.splitlines() if line]
        return build_block(data)


class NumpyDatasource(FileDatasource):
    suffix = ".npy"

    def read_file(self, path: str) -> Block:
        return from_numpy({self.options.get("column", "data"):
                           np.load(path)})


class BinaryDatasource(FileDatasource):
    def read_file(self, path: str) -> Block:
        with open(path, "rb") as f:
            return build_block([{"bytes": f.read(), "path": path}])


class TextDatasource(FileDatasource):
    suffix = ".txt"

    def read_file(self, path: str) -> Block:
        with open(path) as f:
            return build_block([{"text": line.rstrip("\n")} for line in f])


class ImageDatasource(FileDatasource):
    """Image files -> rows {"image": HxWxC uint8, "path"} (ref:
    python/ray/data/datasource/image_datasource.py — same size/mode
    options and extension filter; decoding via PIL)."""

    suffix = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".webp")
    requires = "PIL.Image"

    def read_file(self, path: str) -> Block:
        Image = _require("PIL.Image")

        img = Image.open(path)
        mode = self.options.get("mode")
        if mode:
            img = img.convert(mode)
        size = self.options.get("size")
        if size:
            img = img.resize((size[1], size[0]))  # PIL wants (W, H)
        arr = np.asarray(img)
        return build_block([{"image": arr, "path": path}])


class TFRecordDatasource(FileDatasource):
    """TFRecord files of tf.train.Example -> one column per feature
    (ref: tfrecords_datasource.py; no-TF codec in data/tfrecord.py).
    Scalar-per-row features are unwrapped from their length-1 lists."""

    suffix = ".tfrecords"

    def read_file(self, path: str) -> Block:
        from .tfrecord import decode_example, read_records

        rows = []
        for payload in read_records(path):
            ex = decode_example(payload)
            row = {}
            for name, vals in ex.items():
                row[name] = vals[0] if len(vals) == 1 else list(vals)
            rows.append(row)
        return build_block(rows)


class WebDatasetDatasource(FileDatasource):
    """.tar shards of basename-grouped samples (webdataset layout:
    `key.jpg`, `key.cls`, `key.json` -> one row per key with a column
    per extension). Ref: python/ray/data/datasource/webdataset_datasource
    .py — same grouping rule, stdlib tarfile instead of the wds library.
    """

    suffix = ".tar"

    _DECODERS = {
        "cls": lambda b: int(b.decode()),
        "txt": lambda b: b.decode(),
        "json": lambda b: __import__("json").loads(b.decode()),
    }

    def read_file(self, path: str) -> Block:
        import tarfile

        samples: Dict[str, Dict[str, Any]] = {}
        order: List[str] = []
        with tarfile.open(path) as tar:
            for member in tar:
                if not member.isfile():
                    continue
                base = os.path.basename(member.name)
                key, _, ext = base.partition(".")
                raw = tar.extractfile(member).read()
                dec = self._DECODERS.get(ext)
                if dec is not None:
                    value: Any = dec(raw)
                elif ext in ("jpg", "jpeg", "png"):
                    import io

                    Image = _require("PIL.Image")
                    value = np.asarray(Image.open(io.BytesIO(raw)))
                else:
                    value = raw
                if key not in samples:
                    samples[key] = {"__key__": key}
                    order.append(key)
                samples[key][ext] = value
        return build_block([samples[k] for k in order])


# ------------------------------------------------------------------ writers


def write_block_to_file(block: Block, path: str, file_format: str):
    from .block import BlockAccessor

    acc = BlockAccessor(block)
    if file_format == "parquet":
        pq = _require("pyarrow.parquet")

        pq.write_table(acc.to_arrow(), path)
    elif file_format == "csv":
        pa_csv = _require("pyarrow.csv")

        pa_csv.write_csv(acc.to_arrow(), path)
    elif file_format == "json":
        import json

        with open(path, "w") as f:
            for row in acc.iter_rows():
                f.write(json.dumps(
                    {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                     for k, v in row.items()}) + "\n")
    else:
        raise ValueError(f"unknown write format {file_format}")
