"""Checkpoints: dict/dir duality + top-K retention.

Ref analogs: air/checkpoint.py (dict<->directory Checkpoint) and
train/_internal/checkpoint_manager.py (top-K by score). A tree of tensors
(a train state: nested dicts, ``models.training.tree_leaves`` order) is
stored as a flat .npz of its leaves plus its structure as JSON (nested dicts
of leaf indices, and each leaf's torch dtype), so a checkpoint of sharded or
CUDA tensors round-trips through host memory with no torch object pickled.
A dtype numpy lacks (bf16) is written as the unsigned integers of its size
and read back as itself, bit for bit.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# the object plane's integer views of a dtype numpy lacks, by element size
from ray_tpu_torch.core.serialization import (_NP_UINT_OF_SIZE,
                                              _TORCH_INT_OF_SIZE)

_METADATA = "ckpt_meta.json"
_PAYLOAD = "payload.pkl"
_PYTREE_NPZ = "pytree_leaves.npz"
_PYTREE_DEF = "pytree_def.json"


def _flatten(tree, leaves: list):
    """``tree`` -> its structure (the same dicts, each leaf replaced by its
    index in ``leaves``), appending the leaves in ``tree_leaves`` order
    (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in tree:
            if not isinstance(k, str):
                raise TypeError(f"checkpoint tree keys must be str, got "
                                f"{k!r}")
        return {k: _flatten(tree[k], leaves) for k in sorted(tree)}
    leaves.append(tree)
    return len(leaves) - 1


def _unflatten(structure, leaves: list):
    if isinstance(structure, dict):
        return {k: _unflatten(v, leaves) for k, v in structure.items()}
    return leaves[structure]


def _host_leaf(x):
    """A leaf as a CPU tensor of its own (never an alias of live state). A
    DTensor is gathered whole first: ``full_tensor()`` is a collective, so
    every rank of the gang must take part."""
    import torch

    if hasattr(x, "full_tensor"):
        x = x.full_tensor()
    if not isinstance(x, torch.Tensor):
        return torch.from_numpy(np.array(x))
    return x.detach().to("cpu", copy=True)


def _to_numpy(t) -> Tuple[np.ndarray, str]:
    """A CPU tensor -> (array over its bytes, torch dtype name)."""
    import torch

    name = str(t.dtype).removeprefix("torch.")
    try:
        return t.numpy(), name
    except TypeError:  # a dtype numpy lacks: its bits as unsigned ints
        size = t.element_size()
        bits = t.view(getattr(torch, _TORCH_INT_OF_SIZE[size])).numpy()
        return bits.view(_NP_UINT_OF_SIZE[size]), name


def _from_numpy(a: np.ndarray, name: str):
    """Inverse of ``_to_numpy``."""
    import torch

    dtype = getattr(torch, name)
    if a.dtype.kind == "u" and a.dtype.itemsize > 1 and \
            str(a.dtype) != name:
        a = a.view(f"i{a.dtype.itemsize}")  # torch converts signed ints
    t = torch.from_numpy(a)
    return t if t.dtype == dtype else t.view(dtype)


class Checkpoint:
    """Immutable handle on a checkpoint, backed by a dict or a directory."""

    def __init__(self, *, _dict: Optional[Dict[str, Any]] = None,
                 _path: Optional[str] = None):
        self._dict = _dict
        self._path = _path

    # -- constructors --

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Checkpoint":
        return cls(_dict=dict(data))

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(_path=str(path))

    @classmethod
    def from_pytree(cls, tree: Any, **extra) -> "Checkpoint":
        """Store a tree of tensors (params, optimizer state: nested dicts
        with str keys) as CPU copies of its leaves. DTensor leaves are
        gathered whole, a collective: call it on every rank of the gang
        (the trainer keeps rank 0's)."""
        leaves: list = []
        structure = _flatten(tree, leaves)
        return cls(_dict={"__pytree_leaves__": [_host_leaf(x)
                                                for x in leaves],
                          "__pytree_def__": structure, **extra})

    # -- accessors --

    def to_dict(self) -> Dict[str, Any]:
        if self._dict is not None:
            return dict(self._dict)
        data = {}
        payload = os.path.join(self._path, _PAYLOAD)
        if os.path.exists(payload):
            with open(payload, "rb") as f:
                data.update(pickle.load(f))
        npz = os.path.join(self._path, _PYTREE_NPZ)
        if os.path.exists(npz):
            with open(os.path.join(self._path, _PYTREE_DEF)) as f:
                meta = json.load(f)
            with np.load(npz, allow_pickle=False) as z:
                leaves = [_from_numpy(z[f"leaf_{i}"], name)
                          for i, name in enumerate(meta["dtypes"])]
            data["__pytree_def__"] = meta["structure"]
            data["__pytree_leaves__"] = leaves
        return data

    def to_pytree(self, device=None) -> Tuple[Any, Dict[str, Any]]:
        """-> (tree, the checkpoint's other entries). The tree's leaves
        are tensors of the caller's own, on the CPU or on ``device``, with
        the stored dtypes and shapes, bit for bit."""
        data = self.to_dict()
        leaves = data.pop("__pytree_leaves__")
        structure = data.pop("__pytree_def__")
        if self._dict is not None or device is not None:
            leaves = [x.to(device or "cpu", copy=self._dict is not None)
                      for x in leaves]
        return _unflatten(structure, leaves), data

    def to_directory(self, path: Optional[str] = None) -> str:
        if path is None:
            path = tempfile.mkdtemp(prefix="ray_tpu_torch_ckpt_")
        os.makedirs(path, exist_ok=True)
        if self._path is not None:
            if os.path.abspath(self._path) != os.path.abspath(path):
                shutil.copytree(self._path, path, dirs_exist_ok=True)
            return path
        data = dict(self._dict)
        leaves = data.pop("__pytree_leaves__", None)
        treedef = data.pop("__pytree_def__", None)
        if leaves is not None:
            pairs = [_to_numpy(x) for x in leaves]
            np.savez(os.path.join(path, _PYTREE_NPZ),
                     **{f"leaf_{i}": a for i, (a, _) in enumerate(pairs)})
            with open(os.path.join(path, _PYTREE_DEF), "w") as f:
                json.dump({"structure": treedef,
                           "dtypes": [name for _, name in pairs]}, f)
        with open(os.path.join(path, _PAYLOAD), "wb") as f:
            pickle.dump(data, f)
        with open(os.path.join(path, _METADATA), "w") as f:
            json.dump({"created_at": time.time()}, f)
        return path

    @property
    def path(self) -> Optional[str]:
        return self._path

    def __repr__(self):
        src = self._path if self._path else f"dict[{len(self._dict or {})}]"
        return f"Checkpoint({src})"


class _TrackedCheckpoint:
    def __init__(self, checkpoint: Checkpoint, metrics: Dict[str, Any],
                 index: int, path: Optional[str]):
        self.checkpoint = checkpoint
        self.metrics = metrics
        self.index = index
        self.path = path


class CheckpointManager:
    """Persists reported checkpoints under `root`, keeps top-K by score."""

    def __init__(self, root: str, num_to_keep: Optional[int] = None,
                 score_attribute: Optional[str] = None,
                 score_order: str = "max"):
        self.root = root
        self.num_to_keep = num_to_keep
        self.score_attribute = score_attribute
        self.score_order = score_order
        self._tracked: List[_TrackedCheckpoint] = []
        self._counter = 0
        os.makedirs(root, exist_ok=True)

    def register(self, checkpoint: Checkpoint,
                 metrics: Dict[str, Any]) -> _TrackedCheckpoint:
        idx = self._counter
        self._counter += 1
        path = os.path.join(self.root, f"checkpoint_{idx:06d}")
        checkpoint.to_directory(path)
        tracked = _TrackedCheckpoint(Checkpoint.from_directory(path), metrics,
                                     idx, path)
        self._tracked.append(tracked)
        self._evict()
        return tracked

    def _score(self, t: _TrackedCheckpoint) -> float:
        if not self.score_attribute:
            return float(t.index)  # keep most recent
        v = float(t.metrics.get(self.score_attribute, float("-inf")))
        return v if self.score_order == "max" else -v

    def _evict(self):
        if self.num_to_keep is None or len(self._tracked) <= self.num_to_keep:
            return
        self._tracked.sort(key=self._score, reverse=True)
        for victim in self._tracked[self.num_to_keep:]:
            if victim.path and os.path.exists(victim.path):
                shutil.rmtree(victim.path, ignore_errors=True)
        self._tracked = self._tracked[:self.num_to_keep]

    @property
    def best(self) -> Optional[_TrackedCheckpoint]:
        if not self._tracked:
            return None
        return max(self._tracked, key=self._score)

    @property
    def latest(self) -> Optional[_TrackedCheckpoint]:
        if not self._tracked:
            return None
        return max(self._tracked, key=lambda t: t.index)

    @property
    def checkpoints(self) -> List[_TrackedCheckpoint]:
        return sorted(self._tracked, key=lambda t: t.index)
