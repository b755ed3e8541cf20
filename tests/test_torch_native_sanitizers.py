"""Sanitizer-instrumented stress tests of the port's native store.

The port's mirror of ``tests/test_native_sanitizers.py``, built from the
port's own sources (``ray_tpu_torch/native/store_stress_test.cc`` and
``shm_store.cc``) through its ``native/build.py`` ``build_sanitized``,
into ``.build/ray_tpu_torch/native/``: 8 threads and an eviction thread
hammer one arena under ThreadSanitizer and AddressSanitizer, which abort
non-zero on any finding.
"""

import os
import subprocess

import pytest

from ray_tpu_torch.native.build import build_sanitized


def _toolchain_has(sanitizer: str) -> bool:
    probe = subprocess.run(
        ["g++", f"-fsanitize={sanitizer}", "-x", "c++", "-", "-o",
         "/dev/null"],
        input=b"int main(){return 0;}", capture_output=True)
    return probe.returncode == 0


@pytest.mark.slow
@pytest.mark.parametrize("sanitizer", ["thread", "address"])
def test_store_stress_under_sanitizer(sanitizer):
    if not _toolchain_has(sanitizer):
        pytest.skip(f"toolchain lacks -fsanitize={sanitizer}")
    binary = build_sanitized(
        ["store_stress_test.cc", "shm_store.cc"],
        f"store_stress_{sanitizer}", sanitizer)
    # an arena of this run's own, so that overlapping runs do not unlink
    # each other's
    arena = (f"rtpu_torch_stress_{sanitizer}_{os.getpid()}_"
             f"{os.urandom(4).hex()}")
    proc = subprocess.run([binary, arena], capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, (
        f"{sanitizer} sanitizer reported:\n{proc.stdout}\n{proc.stderr}")
    assert "ok used=" in proc.stdout
