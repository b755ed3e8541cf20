"""The port's runtime on the card: GPU detection, a num_gpus=1 actor and
CUDA tensors through the object plane between processes.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_runtime_gpu.py

Its remote functions and the actor class are module-level definitions, so
they pickle by reference with or without cloudpickle.
"""

import os
import subprocess
import time

import pytest
import torch

import ray_tpu_torch

pytestmark = pytest.mark.gpu

_WORKER_PROBE = "ray_tpu_torch[.]core[.]worker_main"


@pytest.fixture(scope="module")
def cuda_rt():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    info = ray_tpu_torch.init(num_cpus=2, object_store_memory=2 << 30,
                              log_to_driver=False)
    yield info
    ray_tpu_torch.shutdown()


def _bf16(numel, seed, device="cuda"):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(numel, generator=g, device=device,
                       dtype=torch.bfloat16)


def _row_sums(t):
    """Exact integer sums of the bits of 64 slices, in order."""
    return t.view(torch.int16).reshape(64, -1).sum(
        dim=1, dtype=torch.int64).tolist()


def _receive(refs):
    t = ray_tpu_torch.get(refs[0], timeout=120)
    return (t.device.type, str(t.dtype), ray_tpu_torch.get_gpu_ids(),
            os.environ.get("CUDA_VISIBLE_DEVICES"), _row_sums(t))


def _echo_doubled(t):
    return t * 2


class _GpuActor:
    def view(self):
        return (ray_tpu_torch.get_gpu_ids(),
                os.environ.get("CUDA_VISIBLE_DEVICES"),
                torch.cuda.device_count(), torch.cuda.current_device())

    def make(self, numel, seed):
        return _bf16(numel, seed)


def test_cards_are_detected(cuda_rt):
    out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                         text=True, timeout=60, check=True)
    cards = sum(1 for line in out.stdout.splitlines()
                if line.startswith("GPU "))
    assert ray_tpu_torch.cluster_resources()["GPU"] == cards


def test_cuda_tensor_crosses_processes(cuda_rt):
    x = _bf16(32 << 20, seed=1)  # 64 MiB
    ref = ray_tpu_torch.put(x)
    task = ray_tpu_torch.remote(num_gpus=1, num_cpus=0)(_receive)
    device, dtype, ids, env, sums = ray_tpu_torch.get(task.remote([ref]),
                                                      timeout=120)
    assert (device, dtype) == ("cuda", "torch.bfloat16")
    assert ids == [0] and env == "0"
    assert sums == _row_sums(x)
    doubled = ray_tpu_torch.remote(num_gpus=1, num_cpus=0)(_echo_doubled)
    back = ray_tpu_torch.get(doubled.remote(ref), timeout=120)
    assert back.is_cuda and back.dtype == torch.bfloat16
    assert torch.equal(back, x * 2)


def test_gpu_actor_sees_one_card_and_returns_cuda_tensors(cuda_rt):
    actor = ray_tpu_torch.remote(num_gpus=1)(_GpuActor).remote()
    ids, env, count, current = ray_tpu_torch.get(actor.view.remote(),
                                                 timeout=120)
    assert ids == [0] and env == "0" and count == 1 and current == 0
    got = ray_tpu_torch.get(actor.make.remote(8 << 20, 7), timeout=120)
    assert got.is_cuda and torch.equal(got, _bf16(8 << 20, 7))
    ray_tpu_torch.kill(actor)


def test_shutdown_leaves_no_worker(cuda_rt):
    ray_tpu_torch.shutdown()
    for _ in range(100):
        left = subprocess.run(["pgrep", "-f", _WORKER_PROBE],
                              capture_output=True, text=True).stdout.split()
        if not left:
            break
        time.sleep(0.1)
    assert not left, left
