"""Build the native components into .build/ray_tpu_torch/native/lib*.so.

Invoked at first use (``ray_tpu_torch.core.object_store`` and
``core.scheduler`` call ``lib_path`` when they first load a library), never
at import, and by `python -m ray_tpu_torch.native.build` explicitly. Each
library is keyed by the content hash of its sources and flags, so an edited
source is rebuilt and an unchanged one is loaded as it is; nothing is
written into the package directory. Uses g++ directly — the only
dependencies are pthreads and librt.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), ".build",
                         "ray_tpu_torch", "native")

TARGETS = {
    "libshm_store.so": ["shm_store.cc"],
    "libsched_core.so": ["sched_core.cc"],
}

CXXFLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17", "-Wall"]
LDFLAGS = ["-lpthread", "-lrt"]


def _target(lib: str) -> str:
    h = hashlib.sha256()
    for s in TARGETS[lib]:
        with open(os.path.join(_DIR, s), "rb") as f:
            h.update(f.read())
    h.update(" ".join(CXXFLAGS + LDFLAGS).encode())
    stem = lib[:-len(".so")]
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")


def build(force: bool = False) -> None:
    for lib in TARGETS:
        _build_one(lib, force)


def _build_one(lib: str, force: bool = False) -> str:
    out = _target(lib)
    if not force and os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    srcs = [os.path.join(_DIR, s) for s in TARGETS[lib]]
    subprocess.run(["g++", *CXXFLAGS, "-o", tmp, *srcs, *LDFLAGS],
                   check=True, cwd=_DIR)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def lib_path(name: str) -> str:
    return _build_one(name)


if __name__ == "__main__":
    build(force="--force" in sys.argv)
    print("native libs built in", BUILD_DIR)
