"""Build the native components into .build/ray_tpu_torch/native/.

The libraries (``lib*.so``) are built at first use
(``ray_tpu_torch.core.object_store`` and ``core.scheduler`` call
``lib_path`` when they first load one), never at import; the executables
(``BINARIES``: the C++ task-submission frontend and the data plane's
example) by ``build_binary``, and the sanitizer-instrumented test
binaries by ``build_sanitized``. `python -m ray_tpu_torch.native.build`
builds the libraries and the executables. Each output is keyed by the
content hash of its sources and flags (and of the library it links), so
an edited source is rebuilt and an unchanged one is used as it is;
nothing is written into the package directory. Uses g++ directly — the
only dependencies are pthreads and librt.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), ".build",
                         "ray_tpu_torch", "native")
JAVA_SOURCE = os.path.join(os.path.dirname(_DIR), "java", "RayTpuClient.java")
JAVA_BUILD_DIR = os.path.join(os.path.dirname(BUILD_DIR), "java")

TARGETS = {
    "libshm_store.so": ["shm_store.cc"],
    "libsched_core.so": ["sched_core.cc"],
}

# standalone executables: the C++ task-submission frontend, and the native
# data plane's example over ray_tpu_client.h (hashed with its header)
BINARIES = {
    "task_client": ["task_client.cc"],
    "client_example": ["client_example.cc", "ray_tpu_client.h"],
}
# executables that link one of TARGETS
_LINKS = {"client_example": "libshm_store.so"}

CXXFLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17", "-Wall"]
BINFLAGS = ["-O2", "-std=c++17", "-Wall"]
LDFLAGS = ["-lpthread", "-lrt"]


def _hashed(stem: str, sources, flags, suffix: str = "") -> str:
    """The output path of ``stem`` for these sources and flags."""
    h = hashlib.sha256()
    for s in sources:
        with open(os.path.join(_DIR, s), "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}{suffix}")


def _compile(out: str, sources, flags, libs, force: bool = False) -> str:
    """``g++ flags -o out <the .cc files of sources> libs``, unless ``out``
    exists."""
    if not force and os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    srcs = [os.path.join(_DIR, s) for s in sources if s.endswith(".cc")]
    subprocess.run(["g++", *flags, "-o", tmp, *srcs, *libs], check=True,
                   cwd=_DIR)
    os.replace(tmp, out)  # atomic: a concurrent user sees all or nothing
    return out


def build(force: bool = False) -> None:
    for lib in TARGETS:
        _build_one(lib, force)


def _build_one(lib: str, force: bool = False) -> str:
    out = _hashed(lib[:-len(".so")], TARGETS[lib], CXXFLAGS + LDFLAGS, ".so")
    return _compile(out, TARGETS[lib], CXXFLAGS, LDFLAGS, force)


def lib_path(name: str) -> str:
    return _build_one(name)


def build_binary(name: str, force: bool = False) -> str:
    """Compile one executable of BINARIES; returns its path. One that links
    a library links the exact file ``lib_path`` returns (its name carries
    the library's hash, so a rebuilt library rebuilds the executable),
    found beside it at run time through ``$ORIGIN``."""
    link = []
    lib = _LINKS.get(name)
    if lib is not None:
        link = [f"-L{BUILD_DIR}", f"-l:{os.path.basename(lib_path(lib))}",
                "-Wl,-rpath,$ORIGIN"]
    out = _hashed(name, BINARIES[name], BINFLAGS + link + LDFLAGS)
    return _compile(out, BINARIES[name], BINFLAGS, link + LDFLAGS, force)


def build_sanitized(sources, out_name: str, sanitizer: str) -> str:
    """Compile an instrumented test binary (ref: .bazelrc asan/tsan
    configs); ``sanitizer`` is "thread" or "address". Returns its path.
    Sanitized binaries link the C++ sources directly (no .so) so the
    instrumentation covers everything."""
    flags = ["-O1", "-g", "-std=c++17", f"-fsanitize={sanitizer}",
             "-fno-omit-frame-pointer"]
    out = _hashed(out_name, sources, flags + LDFLAGS)
    return _compile(out, sources, flags, LDFLAGS)


def build_java() -> str:
    """``javac`` the Java frontend (``ray_tpu_torch/java``) into
    .build/ray_tpu_torch/java/<hash>/, keyed by its source; returns the
    class directory (``java -cp <it> RayTpuClient ...``). Needs a JDK."""
    with open(JAVA_SOURCE, "rb") as f:
        out = os.path.join(JAVA_BUILD_DIR,
                           hashlib.sha256(f.read()).hexdigest()[:16])
    if os.path.exists(os.path.join(out, "RayTpuClient.class")):
        return out
    tmp = f"{out}.{os.getpid()}.tmp"
    os.makedirs(tmp, exist_ok=True)
    subprocess.run(["javac", "-d", tmp, JAVA_SOURCE], check=True)
    try:
        os.replace(tmp, out)
    except OSError:  # a concurrent build got there first
        shutil.rmtree(tmp, ignore_errors=True)
    return out


if __name__ == "__main__":
    force = "--force" in sys.argv
    build(force=force)
    for name in BINARIES:
        print(name, build_binary(name, force=force))
    if shutil.which("javac"):
        print("RayTpuClient", build_java())
    print("native libs and binaries built in", BUILD_DIR)
