"""Builds the port's CUDA sources with ``nvcc`` at first use and loads them.

Each ``csrc/<name>.cu`` becomes ``.build/ray_tpu_torch/lib<name>-<hash>.so``
in the checkout, keyed by the content hash of the source and the shared
headers (``csrc/*.cuh``), so an edited source is rebuilt and an unchanged
one is loaded as it is. ``build_all`` starts one ``nvcc`` per source at
once. The libraries expose plain C functions (no PyTorch headers, which
would cost minutes of ``nvcc`` per build) and are bound with ``ctypes``.

Nothing here runs at import: only a wrapper handed a CUDA tensor, or a
direct ``load()`` or ``build_all()``, reaches ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / ".build" / "ray_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()  # guards _locks
_locks: Dict[str, threading.Lock] = {}  # one per source
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    return sorted(p.stem for p in _CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from source and need the CUDA toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha256((_CSRC / f"{name}.cu").read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _compile(name: str, out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stdout}")
    out.with_suffix(".log").write_text(proc.stdout)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def build_log(name: str) -> str:
    """nvcc's output for the current build of ``csrc/<name>.cu``: ptxas'
    registers, shared memory and spills of each kernel."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _kernel_name(mangled: str) -> str:
    """``name<N>`` of a mangled ``[ns::]name<int N>`` (its last nested
    name, each prefixed by its length, and its template argument), else
    the mangled name itself."""
    pos, name = 3, None
    while mangled.startswith("_ZN"):
        digits = re.match(r"\d+", mangled[pos:])
        if not digits:
            break
        pos += digits.end()
        name = mangled[pos:pos + int(digits.group())]
        pos += int(digits.group())
    arg = re.match(r"I[Li]+(\d+)E", mangled[pos:])
    return f"{name}<{arg.group(1)}>" if name and arg else mangled


def ptxas_report(log: str) -> List[dict]:
    """Per kernel of a ``build_log``: its name (``flash_fwd_sm90_kernel<64>``
    for the mangled one), registers, static shared memory, stack frame and
    spill bytes, and ptxas' warnings about it (an ignored ``setmaxnreg``, a
    serialised ``wgmma``)."""
    kernels: List[dict] = []
    cur: dict = {}
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) "
                      r"'?(\w+)'?", line)
        if m:
            mangled = m.group(1)
            if not cur or cur["mangled"] != mangled:
                cur = {"kernel": _kernel_name(mangled),
                       "mangled": mangled, "registers": None, "smem_bytes": 0,
                       "stack_bytes": None, "spill_stores": None,
                       "spill_loads": None, "warnings": []}
                kernels.append(cur)
            continue
        if not cur:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur["stack_bytes"], cur["spill_stores"], cur["spill_loads"] = (
                int(x) for x in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["smem_bytes"] = int(s.group(1)) if s else 0
        if "warning" in line.lower() or "performance" in line.lower():
            cur["warnings"].append(line.strip())
    for k in kernels:
        del k["mangled"]
    return kernels


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.
    Builds of different sources may run at once; one source builds once."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name not in _libs:
            out = _target(name)
            if not out.exists():
                _compile(name, out)
            _libs[name] = ctypes.CDLL(str(out))
        return _libs[name]


def build_all() -> Dict[str, float]:
    """Loads every source, one thread each, so every ``nvcc`` that has to
    run starts at once; -> seconds each load took (its build, where one
    ran). Raises if any build fails."""
    def timed_load(name: str) -> float:
        t0 = time.perf_counter()
        load(name)
        return time.perf_counter() - t0

    names = sources()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(timed_load, names)))
