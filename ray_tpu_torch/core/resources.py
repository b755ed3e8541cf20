"""Resource model: fixed-point resource vectors and per-node accounting.

Analog of the reference's scheduling resource model
(src/ray/common/scheduling/cluster_resource_data.h — ``ResourceRequest``,
``TaskResourceInstances``, ``NodeResources``; fixed_point.h). Resources are
fixed-point (1/10000 granularity) so fractional accelerators account exactly.

``GPU`` is the accelerator resource here: a node counts its NVIDIA GPUs
without initializing CUDA (``_detect_gpus``), and the head hands each GPU
lease specific device ids that the worker exports as
``CUDA_VISIBLE_DEVICES``. The reference's GPU handling lives in
python/ray/_private/resource_spec.py:303 and src/ray/common/scheduling/*.
The TPU resource and topology labels stay in the model (the scheduler's
topology-aware order reads them) but nothing here detects a TPU.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional

GRANULARITY = 10000

CPU = "CPU"
GPU = "GPU"
TPU = "TPU"
MEMORY = "memory"
OBJECT_STORE_MEMORY = "object_store_memory"

PREDEFINED = (CPU, GPU, TPU, MEMORY, OBJECT_STORE_MEMORY)


def _to_fp(v: float) -> int:
    return round(v * GRANULARITY)


def _from_fp(v: int) -> float:
    return v / GRANULARITY


class ResourceSet:
    """An immutable-ish map of resource name -> fixed-point quantity."""

    __slots__ = ("_fp",)

    def __init__(self, resources: Optional[Dict[str, float]] = None, _fp=None):
        if _fp is not None:
            self._fp = _fp
        else:
            self._fp = {}
            if resources:
                for k, v in resources.items():
                    if v < 0:
                        raise ValueError(f"Negative resource {k}={v}")
                    fp = _to_fp(v)
                    if fp:
                        self._fp[k] = fp

    def get(self, name: str) -> float:
        return _from_fp(self._fp.get(name, 0))

    def get_fp(self, name: str) -> int:
        return self._fp.get(name, 0)

    def names(self) -> Iterable[str]:
        return self._fp.keys()

    def is_empty(self) -> bool:
        return not self._fp

    def to_dict(self) -> Dict[str, float]:
        return {k: _from_fp(v) for k, v in self._fp.items()}

    def covers(self, request: "ResourceSet") -> bool:
        """True if self has at least the quantities in `request`."""
        for k, v in request._fp.items():
            if self._fp.get(k, 0) < v:
                return False
        return True

    def add(self, other: "ResourceSet") -> "ResourceSet":
        fp = dict(self._fp)
        for k, v in other._fp.items():
            fp[k] = fp.get(k, 0) + v
        return ResourceSet(_fp=fp)

    def subtract(self, other: "ResourceSet") -> "ResourceSet":
        fp = dict(self._fp)
        for k, v in other._fp.items():
            nv = fp.get(k, 0) - v
            if nv < 0:
                raise ValueError(f"Resource {k} would go negative")
            if nv:
                fp[k] = nv
            else:
                fp.pop(k, None)
        return ResourceSet(_fp=fp)

    def scaled(self, factor: float) -> "ResourceSet":
        return ResourceSet(_fp={k: round(v * factor) for k, v in self._fp.items()})

    def __eq__(self, other):
        return isinstance(other, ResourceSet) and self._fp == other._fp

    def __repr__(self):
        return f"ResourceSet({self.to_dict()})"


@dataclass
class TpuTopology:
    """TPU topology attached to a node.

    ``coords`` is this host's position in the slice's host grid; ``chips``
    the number of chips local to the host. STRICT_PACK bundle scheduling uses
    these to pick hosts forming a contiguous ICI sub-torus.
    """

    accelerator_type: str = ""  # e.g. "v5p-64"
    slice_name: str = ""
    worker_index: int = 0
    num_workers: int = 1
    chips_per_host: int = 4
    coords: tuple = (0, 0, 0)

    @property
    def generation(self) -> str:
        return self.accelerator_type.split("-")[0] if self.accelerator_type else ""


@dataclass
class NodeResources:
    """Total and available resources on one node, plus labels.

    ``version`` increments on every availability change; the native
    scheduler core uses it to re-sync only dirty nodes before a
    placement decision."""

    node_id: object = None
    total: ResourceSet = field(default_factory=ResourceSet)
    available: ResourceSet = field(default_factory=ResourceSet)
    labels: Dict[str, str] = field(default_factory=dict)
    tpu: Optional[TpuTopology] = None
    version: int = 0
    # change listeners (native scheduler dirty tracking); excluded from
    # pickling — a node's resources cross the wire at registration
    listeners: list = field(default_factory=list, repr=False,
                            compare=False)

    def __getstate__(self):
        state = dict(self.__dict__)
        state["listeners"] = []
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)

    def is_feasible(self, request: ResourceSet) -> bool:
        return self.total.covers(request)

    def is_available(self, request: ResourceSet) -> bool:
        return self.available.covers(request)

    def allocate(self, request: ResourceSet):
        self.available = self.available.subtract(request)
        self.version += 1
        for cb in self.listeners:
            cb()

    def release(self, request: ResourceSet):
        # Validate BEFORE assigning: a double-release must not leave the
        # inflated availability behind (with version/listeners skipped,
        # the native scheduler table would silently disagree too).
        released = self.available.add(request)
        for k in released.names():
            if released.get_fp(k) > self.total.get_fp(k):
                raise ValueError(f"Released more {k} than total on node")
        self.available = released
        self.version += 1
        for cb in self.listeners:
            cb()

    def utilization(self) -> float:
        """Max utilization across critical resources — drives hybrid policy."""
        util = 0.0
        for k in (CPU, GPU, TPU, MEMORY):
            tot = self.total.get_fp(k)
            if tot:
                util = max(util, 1.0 - self.available.get_fp(k) / tot)
        return util


def detect_node_resources(num_cpus=None, num_gpus=None, memory=None,
                          object_store_memory=None, resources=None,
                          labels=None) -> NodeResources:
    """Autodetect this host's resources (analog of resource_spec.py).

    GPU detection: ``_detect_gpus``, which initializes no CUDA context and
    imports no torch; an explicit ``num_gpus`` wins.
    """
    import os

    res = dict(resources or {})
    if num_cpus is None:
        num_cpus = os.cpu_count() or 1
    res[CPU] = num_cpus
    if num_gpus is None:
        num_gpus = _detect_gpus()
    if num_gpus:
        res[GPU] = num_gpus
    if memory is None:
        try:
            with open("/proc/meminfo") as f:
                for line in f:
                    if line.startswith("MemAvailable"):
                        memory = int(line.split()[1]) * 1024 // 2
                        break
        except OSError:
            memory = 4 * 1024 * 1024 * 1024
    res[MEMORY] = memory
    if object_store_memory is not None:
        res[OBJECT_STORE_MEMORY] = object_store_memory
    rs = ResourceSet(res)
    return NodeResources(total=rs, available=rs, labels=dict(labels or {}))


_NVIDIA_PROC_GPUS = "/proc/driver/nvidia/gpus"


def _detect_gpus() -> int:
    """Count this host's NVIDIA GPUs WITHOUT initializing CUDA or importing
    torch (a CUDA context made here would pin the driver process to the
    devices it saw, and ``torch`` costs seconds to import), in order:
    ``CUDA_VISIBLE_DEVICES`` if set (entries up to the first invalid one,
    as CUDA reads it), the driver's ``/proc/driver/nvidia/gpus/`` entries,
    ``nvidia-smi -L``, else 0."""
    import os
    import subprocess

    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None:
        n = 0
        for entry in visible.split(","):
            entry = entry.strip()
            if not entry or entry.lstrip("-").isdigit() and int(entry) < 0:
                break
            n += 1
        return n
    try:
        return len(os.listdir(_NVIDIA_PROC_GPUS))
    except OSError:
        pass
    try:
        out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return 0
    if out.returncode != 0:
        return 0
    return sum(1 for line in out.stdout.splitlines()
               if line.startswith("GPU "))
