"""Blocks: the unit of data movement in ray_tpu_torch.data.

Ref analogs: python/ray/data/block.py (BlockAccessor) and
_internal/simple_block.py. A block is either a tabular block (a dict of
equal-length numpy columns) or a plain Python list (a simple block of
arbitrary objects). Blocks live in the object store; tasks move block
refs, not data.

A column is one ndarray whose first dimension is the row. A tensor column
keeps each row's shape as its trailing dimensions (``[n, 2049]`` for
rows of 2049 tokens), so a batch of it is a slice, and the natural input
of ``torch.from_numpy``. Columns of Python objects (strings, bytes,
lists, dicts, values mixed with None) are ``object`` arrays. Arrow and
pandas appear only at the edges (``from_arrow``, ``to_arrow``,
``from_pandas``, ``to_pandas``); each imports its package where it is
used, so a host without them runs every other path.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, Iterator, List, Optional, Union

import numpy as np

Block = Union[Dict[str, np.ndarray], List[Any]]


def _require(package: str):
    """Import an edge package, or raise ImportError naming it."""
    import importlib

    try:
        return importlib.import_module(package)
    except ImportError as e:
        raise ImportError(
            f"{package} is needed for this operation and is not "
            f"installed; the numpy-column path needs no {package}") from e


def is_columnar(block) -> bool:
    return isinstance(block, dict)


def _object_column(values: List[Any]) -> np.ndarray:
    col = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        col[i] = v
    return col


def _column(values: List[Any]) -> np.ndarray:
    """One column from one cell per row. Cells that are arrays of one
    shape and dtype stack into a tensor column; Python bools, ints and
    floats become bool / int64 / float64 (ints and floats together:
    float64, as Arrow infers double); numpy scalars of one dtype keep it;
    anything else is an ``object`` column holding the cells as given."""
    first = values[0]
    if isinstance(first, np.ndarray) and first.ndim > 0:
        if all(isinstance(v, np.ndarray) and v.shape == first.shape
               and v.dtype == first.dtype for v in values):
            return np.stack(values)
        return _object_column(values)
    kinds = {type(v) for v in values}
    if kinds == {bool}:
        return np.asarray(values, dtype=bool)
    if kinds <= {int, float}:
        if kinds == {int}:
            try:
                return np.asarray(values, dtype=np.int64)
            except OverflowError:
                return _object_column(values)
        return np.asarray(values, dtype=np.float64)
    if len(kinds) == 1 and isinstance(first, (np.number, np.bool_)):
        return np.asarray(values, dtype=first.dtype)
    return _object_column(values)


def build_block(rows: List[Any]) -> Block:
    """Rows of dicts with one key set -> numpy columns; anything else ->
    simple block."""
    if not rows or not all(isinstance(r, dict) for r in rows):
        return list(rows)
    if not rows[0] or any(r.keys() != rows[0].keys() for r in rows):
        return list(rows)
    return {k: _column([r[k] for r in rows]) for k in rows[0]}


def from_numpy(data: Union[np.ndarray, Dict[str, np.ndarray]]) -> Block:
    if isinstance(data, np.ndarray):
        data = {"data": data}
    cols = {}
    for name, arr in data.items():
        arr = np.asarray(arr)
        if arr.ndim == 0:
            raise ValueError(f"column {name!r} is a scalar, not one value "
                             f"per row")
        cols[name] = arr
    if len({len(c) for c in cols.values()}) > 1:
        raise ValueError("columns of one block differ in length: "
                         f"{ {k: len(c) for k, c in cols.items()} }")
    return cols


def from_arrow(table) -> Block:
    """A pyarrow.Table -> numpy columns. The reference's tensor encoding
    (a fixed-size-list column beside ``__shape__<name>``) becomes a tensor
    column; list, struct, string and nullable columns become ``object``
    columns of their Python values."""
    pa = _require("pyarrow")
    cols = {}
    names = table.column_names
    n = table.num_rows
    for name in names:
        if name.startswith("__shape__"):
            continue
        col = table.column(name)
        shape_col = f"__shape__{name}"
        if shape_col in names and n:
            shape = tuple(table.column(shape_col)[0].as_py())
            flat = col.combine_chunks().flatten().to_numpy(
                zero_copy_only=False)
            cols[name] = flat.reshape((n,) + shape)
        elif (pa.types.is_integer(col.type) or pa.types.is_floating(col.type)
              or pa.types.is_boolean(col.type)) and col.null_count == 0:
            cols[name] = col.to_numpy()
        else:
            cols[name] = _object_column(col.to_pylist())
    return cols


def from_pandas(df) -> Block:
    return {str(c): _pandas_column(df[c]) for c in df.columns}


def _pandas_column(series) -> np.ndarray:
    arr = series.to_numpy()
    if arr.dtype == object and len(arr) and all(
            isinstance(v, np.ndarray) for v in arr):
        return _column(list(arr))
    return arr


class Schema:
    """Column names and, per column, the dtype and the row shape (the
    counterpart of a pyarrow.Schema; ``names`` as there)."""

    def __init__(self, block: Dict[str, np.ndarray]):
        self.names = list(block)
        self.types = [(str(c.dtype), tuple(c.shape[1:]))
                      for c in block.values()]

    def __eq__(self, other):
        return isinstance(other, Schema) and \
            (self.names, self.types) == (other.names, other.types)

    def __repr__(self):
        return "Schema(" + ", ".join(
            f"{n}: {t}{list(s) if s else ''}"
            for n, (t, s) in zip(self.names, self.types)) + ")"


class BlockAccessor:
    """Uniform view over either block representation."""

    def __init__(self, block: Block):
        self._block = block
        self._columnar = is_columnar(block)

    @property
    def block(self) -> Block:
        return self._block

    @property
    def is_columnar(self) -> bool:
        return self._columnar

    def key_column(self, name) -> Optional[List[Any]]:
        """Python scalars of one plain (non-tensor) column, or None when
        the block/column can't serve it columnar. Values are EXACTLY what
        the row path's ``row[name]`` yields (``tolist()`` Python scalars,
        never numpy scalars): the exchange's cross-process ``_det_hash``
        routing depends on that."""
        if not self._columnar or not isinstance(name, str):
            return None
        col = self._block.get(name)
        if col is None or col.ndim != 1:
            return None
        return col.tolist()

    def num_rows(self) -> int:
        if self._columnar:
            return len(next(iter(self._block.values()))) if self._block \
                else 0
        return len(self._block)

    def size_bytes(self) -> int:
        if self._columnar:
            total = 0
            for col in self._block.values():
                total += col.nbytes
                if col.dtype == object:
                    total += sum(sys.getsizeof(v) for v in col)
            return total
        return sum(sys.getsizeof(r) for r in self._block)

    def schema(self):
        if self._columnar:
            return Schema(self._block)
        if self._block:
            first = self._block[0]
            return type(first).__name__
        return None

    # ----------------------------------------------------------- conversion

    def iter_rows(self) -> Iterator[Any]:
        if self._columnar:
            names = list(self._block)
            # 1-d columns as Python scalars (tolist), tensor columns as
            # one ndarray a row
            cols = [c.tolist() if c.ndim == 1 else c
                    for c in self._block.values()]
            for i in range(self.num_rows()):
                yield {n: c[i] for n, c in zip(names, cols)}
        else:
            yield from self._block

    def to_pylist(self) -> List[Any]:
        return list(self.iter_rows())

    def to_pandas(self):
        pd = _require("pandas")

        if self._columnar:
            return pd.DataFrame({
                k: (list(c) if c.ndim > 1 else c)
                for k, c in self._block.items()})
        if self._block and isinstance(self._block[0], dict):
            return pd.DataFrame(self._block)
        return pd.DataFrame({"value": self._block})

    def to_numpy(self, columns: Optional[List[str]] = None
                 ) -> Dict[str, np.ndarray]:
        if self._columnar:
            return {k: self._block[k] for k in (columns or self._block)}
        rows = self.to_pylist()
        if rows and isinstance(rows[0], dict):
            keys = columns or list(rows[0])
            return {k: np.asarray([r[k] for r in rows]) for k in keys}
        return {"value": np.asarray(rows)}

    def to_arrow(self):
        """A pyarrow.Table in the reference's encoding (a tensor column as
        a fixed-size list beside ``__shape__<name>``)."""
        pa = _require("pyarrow")
        block = self._block if self._columnar else \
            build_block(self.to_pylist())
        if not isinstance(block, dict):
            return pa.Table.from_pylist(block)
        cols = {}
        for name, c in block.items():
            if c.ndim > 1:
                flat = c.reshape(len(c), -1)
                cols[name] = pa.FixedSizeListArray.from_arrays(
                    pa.array(flat.ravel()), flat.shape[1])
                cols[f"__shape__{name}"] = pa.array(
                    [list(c.shape[1:])] * len(c))
            elif c.dtype == object:
                cols[name] = pa.array(c.tolist())
            else:
                cols[name] = pa.array(c)
        return pa.Table.from_pydict(cols)

    def to_batch(self, batch_format: str):
        if batch_format in ("numpy", "np"):
            return self.to_numpy()
        if batch_format == "pandas":
            return self.to_pandas()
        if batch_format in ("pyarrow", "arrow"):
            return self.to_arrow()
        if batch_format in ("default", "native"):
            return self.to_numpy() if self._columnar else self._block
        raise ValueError(f"unknown batch_format '{batch_format}'")

    # ------------------------------------------------------------- slicing

    def slice(self, start: int, end: int) -> Block:
        if self._columnar:
            return {k: c[start:end] for k, c in self._block.items()}
        return self._block[start:end]

    def take_rows(self, indices: List[int]) -> Block:
        if self._columnar:
            idx = np.asarray(indices, dtype=np.int64)
            return {k: c[idx] for k, c in self._block.items()}
        return [self._block[i] for i in indices]

    @staticmethod
    def concat(blocks: List[Block]) -> Block:
        if not blocks:
            return []
        if all(is_columnar(b) for b in blocks):
            tables = [b for b in blocks if BlockAccessor(b).num_rows()]
            if not tables:
                return blocks[0]
            names = list(tables[0])
            if all(list(t) == names for t in tables):
                try:
                    return {k: np.concatenate([t[k] for t in tables])
                            for k in names}
                except (ValueError, TypeError):  # row shapes differ
                    pass
        rows: List[Any] = []
        for b in blocks:
            rows.extend(BlockAccessor(b).to_pylist())
        return rows


def batch_to_block(batch: Any) -> Block:
    """Normalize a user map_batches return value into a block."""
    if isinstance(batch, dict):
        return from_numpy(batch)
    if isinstance(batch, list):
        return build_block(batch)
    module = type(batch).__module__.split(".")[0]
    if module == "pyarrow" and type(batch).__name__ == "Table":
        return from_arrow(batch)
    if module == "pandas" and type(batch).__name__ == "DataFrame":
        return from_pandas(batch)
    raise TypeError(
        f"map_batches must return dict[str, np.ndarray] | pd.DataFrame | "
        f"pyarrow.Table | list, got {type(batch)}")
