"""Serialization: pickle protocol 5 with out-of-band buffers.

Analog of python/ray/_private/serialization.py in the reference (pickle5 +
zero-copy buffer support + custom reducers). We rely on stock pickle (3.12)
plus, where it is installed, cloudpickle for closures/lambdas in function
descriptors. Without cloudpickle, functions and classes pickle by
reference (module and name), and a lambda, a closure or an object of
``__main__`` raises a ``TypeError`` that names cloudpickle. ObjectRefs
embedded in values are collected during serialization so the borrower
protocol can register them with their owners.
"""

from __future__ import annotations

import io
import os
import pickle
import sys
import types
import warnings
from typing import Any, List

import numpy as np

try:
    import cloudpickle
except ImportError:
    cloudpickle = None


class SerializedValue:
    """A value serialized into frames: frame 0 is the pickle stream, frames
    1..n are out-of-band buffers (e.g. numpy array payloads).

    Frames may be memoryviews (frame 0 is the BytesIO's exported buffer,
    out-of-band frames are ``PickleBuffer.raw()`` views of the source
    object's memory) — nothing is flattened to bytes at serialize time,
    so a consumer that writes frames straight into a mapped destination
    (``ShmObjectStore.put_serialized``) moves each byte exactly once.
    Consumers that embed frames in a pickled message must materialize
    them (``bytes(f)``) first."""

    __slots__ = ("frames", "contained_refs")

    def __init__(self, frames: List[bytes], contained_refs: List[Any]):
        self.frames = frames
        self.contained_refs = contained_refs

    @property
    def total_bytes(self) -> int:
        return sum(len(f) for f in self.frames)


_ref_cls = None  # lazy: object_ref imports back into core modules


# ------------------------------------------- device-array fast path (r13)
#
# The plasma-analog zero-copy path for tensors: a torch.Tensor pickles
# IN-BAND by default (its reduction copies the storage's bytes into the
# pickle stream — a full extra traversal of the payload before the arena
# copy even starts). The typed reducer below instead emits dtype/shape
# metadata in frame 0 and the payload as an out-of-band PickleBuffer VIEW
# of the tensor's contiguous host memory (the tensor's own storage for a
# contiguous CPU tensor; for a CUDA tensor the one unavoidable
# device->host copy), so put_serialized moves each byte exactly once,
# source to arena.

# non-contiguous ndarrays below this stay on the stock (in-band) path:
# the contiguity normalization is a copy, only worth skipping the
# in-band stream copy for payloads that dominate serialize time
_NDARRAY_OOB_MIN_BYTES = 1 << 20

# the integer types a tensor whose dtype numpy lacks (bfloat16, the
# float8s) is viewed as, by element size: torch's view for the host copy,
# numpy's for the payload's frame-0 dtype
_TORCH_INT_OF_SIZE = {1: "uint8", 2: "int16", 4: "int32", 8: "int64"}
_NP_UINT_OF_SIZE = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


def _rebuild_tensor(torch_dtype, np_dtype, shape, device, requires_grad,
                    parameter, buf):
    """Inverse of the tensor reducer. A CPU tensor comes back zero-copy
    over an arena-backed out-of-band buffer, through a private
    (copy-on-write) mapping of the arena's pages (``private_view``): the
    mapping keeps the buffer — and through the borrow-pin ledger the
    arena slice — alive for as long as the tensor aliases it, and an
    in-place write to the tensor changes this tensor alone, never the
    sealed object other readers see. A read-only buffer from elsewhere
    (an inline value's bytes) is copied; a writable one is the caller's
    and is aliased. A CUDA tensor comes back on the consumer's current
    CUDA device with one host->device copy; a consumer that sees no
    CUDA device raises."""
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA tensor arrived in a process that sees no CUDA device "
            f"(CUDA_VISIBLE_DEVICES="
            f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r}); request a GPU "
            "for the task or actor (num_gpus=...) or send the tensor's "
            ".cpu() copy")
    flat = np.frombuffer(buf, dtype=np.uint8)
    if device == "cpu" and not flat.flags.writeable:
        from .object_store import private_view

        priv = private_view(flat)
        flat = priv if priv is not None else flat.copy()
    arr = flat.view(np_dtype).reshape(shape)
    dtype = getattr(torch, torch_dtype)
    if arr.dtype.kind == "u" and arr.dtype.itemsize > 1:
        # a dtype numpy lacks, shipped as unsigned ints: re-view as the
        # signed type of that size, which every torch converts
        arr = arr.view(f"i{arr.dtype.itemsize}")
    if device == "cuda":
        with warnings.catch_warnings():
            # the read-only host view is only read, by the one copy
            # to the card below
            warnings.simplefilter("ignore", UserWarning)
            t = torch.from_numpy(arr)
    else:
        t = torch.from_numpy(arr)
    if t.dtype != dtype:
        t = t.view(dtype)
    if device == "cuda":
        t = t.to(torch.device("cuda", torch.cuda.current_device()))
    if parameter:
        return torch.nn.Parameter(t, requires_grad=requires_grad)
    if requires_grad:
        t.requires_grad_(True)
    return t


def _rebuild_host_array(dtype, shape, f_order, buf):
    return np.frombuffer(buf, dtype=dtype).reshape(
        shape, order="F" if f_order else "C")


def _payload_buffer(host: "np.ndarray") -> pickle.PickleBuffer:
    """Zero-copy byte view of a contiguous array's memory. Exported as
    flat uint8: dtypes outside the buffer-protocol spec carry their type
    in frame 0's dtype arg instead, and the rebuild's np.frombuffer
    interprets raw bytes under any registered dtype."""
    f_order = host.flags.f_contiguous and not host.flags.c_contiguous
    flat = host.reshape(-1, order="F" if f_order else "C")
    return pickle.PickleBuffer(flat.view(np.uint8))


def _tensor_reduce(torch, obj):
    """The reducer for a dense CPU or CUDA tensor; None (the default,
    in-band path) for anything else: sparse, quantized, meta or other
    devices, empty, or a non-leaf that requires grad."""
    if (obj.layout != torch.strided or obj.is_quantized
            or obj.device.type not in ("cpu", "cuda") or obj.numel() == 0
            or (obj.requires_grad and not obj.is_leaf)):
        return None
    t = obj.detach().resolve_conj().resolve_neg()
    device = t.device.type
    t = t.contiguous()
    if device == "cuda":
        t = t.cpu()  # the one device->host copy
    name = str(t.dtype).removeprefix("torch.")
    try:
        host = t.numpy()
    except TypeError:  # a dtype numpy lacks: ship its bits
        size = t.element_size()
        host = t.view(getattr(torch, _TORCH_INT_OF_SIZE[size])).numpy() \
            .view(_NP_UINT_OF_SIZE[size])
    return (_rebuild_tensor,
            (name, host.dtype.str, tuple(t.shape), device,
             bool(obj.requires_grad), type(obj) is torch.nn.Parameter,
             _payload_buffer(host)))


def _device_reduce(obj):
    """Typed reducer for tensors (and large non-contiguous host arrays);
    None delegates to the default pickling path. Gated by
    ``serialization_device_zero_copy`` (the bench A/B control). torch is
    read from ``sys.modules``, never imported: a process that has not
    imported it holds no tensor."""
    from .config import get_config

    if not get_config().serialization_device_zero_copy:
        return None
    torch_mod = sys.modules.get("torch")
    # only an object of a torch type can be a tensor: while another thread
    # imports torch, its module is in sys.modules without its attributes
    if torch_mod is not None and \
            type(obj).__module__.partition(".")[0] == "torch" and type(
                obj) in (torch_mod.Tensor, torch_mod.nn.Parameter):
        try:
            return _tensor_reduce(torch_mod, obj)
        except (TypeError, RuntimeError, KeyError):
            return None  # exotic dtypes: the default path still works
    if type(obj) is np.ndarray and obj.nbytes >= _NDARRAY_OOB_MIN_BYTES \
            and not (obj.flags.c_contiguous or obj.flags.f_contiguous):
        # stock pickle5 already ships contiguous ndarrays out-of-band;
        # strided views would go IN-BAND via tobytes() — normalize once
        # and ship the contiguous copy out-of-band instead
        try:
            host = np.ascontiguousarray(obj)
            return (_rebuild_host_array,
                    (host.dtype, host.shape, False,
                     _payload_buffer(host)))
        except Exception:  # noqa: BLE001
            return None
    return None


def _by_reference_check(obj):
    """Without cloudpickle a function or class pickles by reference, which
    only works where the consumer can import it: refuse the ones it
    cannot (lambdas, closures, nested and ``__main__`` definitions)."""
    if isinstance(obj, (types.FunctionType, type)) and (
            getattr(obj, "__module__", None) == "__main__"
            or "<" in getattr(obj, "__qualname__", "")):
        raise TypeError(
            f"cannot serialize {obj!r} without cloudpickle: functions "
            f"and classes pickle by reference here, and a lambda, a "
            f"closure or a definition in __main__ has no importable "
            f"name; define it at the top level of an importable module "
            f"or install cloudpickle")


_BasePickler = cloudpickle.CloudPickler if cloudpickle is not None \
    else pickle.Pickler


class _RefCollectingPickler(_BasePickler):
    """Module-level pickler subclass: defining this class INSIDE
    serialize() (the old shape) cost ~20 us of class creation per call
    — the dominant cost of serializing a small task result."""

    def __init__(self, file, buffer_callback, contained_refs):
        super().__init__(file, protocol=5,
                         buffer_callback=buffer_callback)
        self._contained_refs = contained_refs

    def persistent_id(self, obj):
        return None

    def reducer_override(self, obj):
        if isinstance(obj, _ref_cls):
            self._contained_refs.append(obj)
            return (_ref_cls._deserialize, (obj.id.binary(), obj.owner))
        r = _device_reduce(obj)
        if r is not None:
            return r
        if cloudpickle is None:
            _by_reference_check(obj)
            return NotImplemented
        # delegate (NOT NotImplemented): cloudpickle's own
        # reducer_override is what pickles closures/lambdas by value
        return super().reducer_override(obj)


class _ByReferencePickler(pickle.Pickler):
    """``dumps`` without cloudpickle: stock pickling plus the check."""

    def reducer_override(self, obj):
        _by_reference_check(obj)
        return NotImplemented


# Types that can never contain an ObjectRef or need out-of-band
# buffers: stock-pickled in one shot, skipping the BytesIO +
# CloudPickler machinery entirely (a no-op task's `return 0` is THE
# common small result at high task rates).
_SCALAR_TYPES = (type(None), bool, int, float)


def serialize(value: Any) -> SerializedValue:
    t = type(value)
    if t in _SCALAR_TYPES or (t is bytes or t is str) and len(value) < 8192:
        return SerializedValue([pickle.dumps(value, protocol=5)], [])
    global _ref_cls
    if _ref_cls is None:
        from .object_ref import ObjectRef as _ref_cls_  # noqa: N813

        _ref_cls = _ref_cls_
    buffers: List[pickle.PickleBuffer] = []
    contained_refs: List[Any] = []
    sio = io.BytesIO()
    p = _RefCollectingPickler(sio, buffers.append, contained_refs)
    p.dump(value)
    # getbuffer(), not getvalue(): the pickle stream stays a zero-copy
    # view of the BytesIO's internal buffer. For in-band-heavy values
    # (bytes/str payloads) getvalue() was a full second traversal of the
    # data before the store copy even started.
    frames = [sio.getbuffer()]
    for b in buffers:
        frames.append(b.raw())
    return SerializedValue(frames, contained_refs)


def deserialize(frames: List) -> Any:
    return pickle.loads(frames[0], buffers=frames[1:])


def dumps(value: Any) -> bytes:
    """One-shot in-band serialization (for control messages)."""
    if cloudpickle is not None:
        return cloudpickle.dumps(value, protocol=5)
    sio = io.BytesIO()
    _ByReferencePickler(sio, protocol=5).dump(value)
    return sio.getvalue()


def loads(data: bytes) -> Any:
    return pickle.loads(data)
