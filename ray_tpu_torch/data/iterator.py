"""DataIterator: per-consumer streaming view of a Dataset shard.

Ref analog: python/ray/data/iterator.py (DataIterator.iter_batches) and
_internal/iterator/stream_split_iterator.py (Train ingest shards). Blocks
are fetched lazily one at a time; batches are re-chunked to batch_size
across block boundaries. ``iter_torch_batches`` places each batch on a
device (CUDA unless the caller asks for the CPU), optionally as DTensors
on a mesh: the counterpart of the reference's ``iter_jax_batches``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional

import numpy as np

import ray_tpu_torch

from .block import BlockAccessor, is_columnar


class DataIterator:
    def __init__(self, block_refs, name: str = "shard"):
        # a list (re-iterable, multi-epoch) or any iterable of refs (the
        # one-shot, picklable streaming_split consumer streams); iter()
        # is taken lazily per iter_* call, never at construction
        self._refs = block_refs
        self._name = name

    def _blocks(self) -> Iterator[Any]:
        for ref in self._refs:
            yield ray_tpu_torch.get(ref, timeout=600)

    def iter_rows(self) -> Iterator[Any]:
        for block in self._blocks():
            yield from BlockAccessor(block).iter_rows()

    def iter_batches(self, *, batch_size: int = 256,
                     batch_format: str = "numpy",
                     drop_last: bool = False,
                     local_shuffle_buffer_size: Optional[int] = None,
                     seed: Optional[int] = None) -> Iterator[Any]:
        """Re-chunk rows into batches of exactly batch_size (except possibly
        the last). With local_shuffle_buffer_size, rows pass through a
        shuffle buffer first (ref: iter_batches local shuffle). Without
        one, numpy-column blocks are cut as column slices across block
        boundaries (the same rows in the same order as the row path;
        columns keep their dtypes)."""
        if not local_shuffle_buffer_size:
            yield from self._iter_column_batches(batch_size, batch_format,
                                                 drop_last)
            return
        rng = np.random.default_rng(seed)
        buf: List[Any] = []
        shuffle_n = local_shuffle_buffer_size
        threshold = batch_size + shuffle_n

        def emit_ready():
            while len(buf) >= threshold:
                idx = rng.choice(len(buf), size=batch_size, replace=False)
                idx_set = set(int(i) for i in idx)
                batch = [buf[i] for i in idx_set]
                rest = [r for i, r in enumerate(buf) if i not in idx_set]
                buf[:] = rest
                yield _rows_to_batch(batch, batch_format)

        for block in self._blocks():
            buf.extend(BlockAccessor(block).iter_rows())
            yield from emit_ready()
        while buf and (len(buf) >= batch_size or not drop_last):
            batch, buf = buf[:batch_size], buf[batch_size:]
            yield _rows_to_batch(batch, batch_format)

    def _iter_column_batches(self, batch_size: int, batch_format: str,
                             drop_last: bool) -> Iterator[Any]:
        """Pending pieces (blocks or their tails) are cut into batches of
        ``batch_size`` rows: one slice when a batch lies in one piece,
        else the pieces joined (``BlockAccessor.concat``: by column when
        they share their columns, else as rows)."""
        pieces: List[Any] = []
        held = 0

        def take(n: int):
            nonlocal held
            out = []
            while n:
                acc = BlockAccessor(pieces[0])
                rows = acc.num_rows()
                if rows <= n:
                    out.append(pieces.pop(0))
                    n -= rows
                    held -= rows
                else:
                    out.append(acc.slice(0, n))
                    pieces[0] = acc.slice(n, rows)
                    held -= n
                    n = 0
            if len(out) == 1:
                return out[0]
            return BlockAccessor.concat(out)

        def emit(block):
            acc = BlockAccessor(block)
            if not is_columnar(block):
                # the row path's block of these rows, as iter_batches
                # builds it from rows
                return _rows_to_batch(acc.to_pylist(), batch_format)
            return acc.to_batch(batch_format)

        for block in self._blocks():
            rows = BlockAccessor(block).num_rows()
            if not rows:
                continue
            pieces.append(block)
            held += rows
            while held >= batch_size:
                yield emit(take(batch_size))
        if held and not drop_last:
            yield emit(take(held))

    def iter_torch_batches(self, *, batch_size: int = 256, device=None,
                           dtype=None, sharding=None,
                           **kw) -> Iterator[Dict[str, Any]]:
        """Numpy batches as torch tensors on ``device``: CUDA unless the
        caller passes ``device="cpu"`` (``_device.resolve_device``, which
        raises at this call, before any batch is taken, when CUDA is meant
        but absent). ``dtype`` casts the floating columns. ``sharding=(mesh,
        placements)`` makes every column a DTensor on the mesh
        (``parallel.sharding.distribute``: each rank keeps its shard), as
        the reference's ``jax.device_put(v, NamedSharding)``.

        A CUDA copy goes through pinned host memory from PyTorch's pinned
        allocator and is issued non-blocking on the current stream; the
        allocator keeps each staging buffer until the copy's event has
        passed, so the next batch never refills a buffer in flight."""
        import torch

        from ray_tpu_torch._device import resolve_device

        if sharding is not None:
            mesh, placements = sharding
            dev = resolve_device(mesh.device_type if device is None
                                 else device)
        else:
            dev = resolve_device(device)
        if dtype is not None and not isinstance(dtype, torch.dtype):
            dtype = torch.from_numpy(np.empty(0, dtype=dtype)).dtype
        batches = self.iter_batches(batch_size=batch_size,
                                    batch_format="numpy", **kw)
        return _torch_batches(batches, dev, dtype, sharding)

    def materialize(self):
        from .dataset import Dataset, _plan_from_refs

        return Dataset(_plan_from_refs(list(self._refs)))

    def stats(self) -> str:
        if isinstance(self._refs, list):
            return f"DataIterator({self._name}, {len(self._refs)} blocks)"
        return f"DataIterator({self._name}, streaming)"


def _torch_batches(batches, dev, dtype, sharding):
    for batch in batches:
        out = {k: _to_device(k, v, dev) for k, v in batch.items()}
        if dtype is not None:
            out = {k: t.to(dtype) if t.is_floating_point() else t
                   for k, t in out.items()}
        if sharding is not None:
            from ray_tpu_torch.parallel.sharding import distribute

            mesh, placements = sharding
            out = {k: distribute(t, mesh, placements)
                   for k, t in out.items()}
        yield out


def _to_device(name: str, v: np.ndarray, dev):
    import torch

    if v.dtype.kind not in "biuf":
        raise TypeError(f"column {name!r} of dtype {v.dtype} has no torch "
                        f"counterpart")
    if dev.type == "cpu":
        # a copy: the batch may be a read-only view of the object store
        return torch.from_numpy(np.array(v))
    staged = torch.empty(v.shape, pin_memory=True,
                         dtype=torch.from_numpy(np.empty(0, v.dtype)).dtype)
    np.copyto(staged.numpy(), v, casting="no")
    return staged.to(dev, non_blocking=True)


def _rows_to_batch(rows: List[Any], batch_format: str):
    from .block import build_block

    return BlockAccessor(build_block(rows)).to_batch(batch_format)
