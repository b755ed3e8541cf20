"""The port's Data onto the card: ``iter_torch_batches`` with no device (its
default, CUDA), with a dtype, and with ``sharding=`` on an NCCL mesh of one,
each over 200 back-to-back batches held bit for bit against the numpy rows.
The copies go from pinned host memory, non-blocking; the card is kept busy
between batches, so the host runs ahead of the copies and a staging buffer
refilled too early would show here as a wrong batch.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_data_gpu.py
"""

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import data

pytestmark = pytest.mark.gpu

_ROWS, _BLOCKS, _BATCH = 1600, 16, 8  # 200 batches


@pytest.fixture(scope="module")
def runtime():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield
    ray_tpu_torch.shutdown()


def _dataset():
    rng = np.random.default_rng(0)
    per = _ROWS // _BLOCKS
    arrays = [{"id": np.arange(i * per, (i + 1) * per, dtype=np.int64),
               "x": rng.standard_normal((per, 64)).astype(np.float32),
               "tok": rng.integers(0, 128256, (per, 33)).astype(np.int32)}
              for i in range(_BLOCKS)]
    return data.from_numpy(arrays).random_shuffle(seed=3).materialize()


def _numpy_batches(ds):
    return list(ds.iter_batches(batch_size=_BATCH, batch_format="numpy"))


def _tensor(a):
    return torch.from_numpy(np.array(a))  # a copy: `a` may be read-only


def _hold(got, want):
    """Every batch equal bit for bit, after the whole run."""
    torch.cuda.synchronize()
    assert len(got) == len(want) == _ROWS // _BATCH
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k, t in g.items():
            assert torch.equal(t.cpu(), _tensor(w[k])), k


def test_default_device_is_cuda_bitwise(runtime):
    ds = _dataset()
    want = _numpy_batches(ds)
    got = []
    for b in ds.iter_torch_batches(batch_size=_BATCH):
        assert all(t.device == torch.device("cuda", 0) for t in b.values())
        got.append(b)
        torch.cuda._sleep(200_000)  # the card lags, the host runs ahead
    assert {k: t.dtype for k, t in got[0].items()} == {
        "id": torch.int64, "x": torch.float32, "tok": torch.int32}
    _hold(got, want)


def test_dtype_casts_floating_columns(runtime):
    ds = _dataset()
    want = _numpy_batches(ds)
    got = list(ds.iter_torch_batches(batch_size=_BATCH,
                                     dtype=torch.bfloat16))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g["x"].dtype == torch.bfloat16
        assert torch.equal(g["x"].cpu(), _tensor(w["x"]).to(torch.bfloat16))
        assert torch.equal(g["tok"].cpu(), _tensor(w["tok"]))
    assert len(got) == len(want)


def test_sharding_on_a_mesh_of_one(runtime):
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    from ray_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(fsdp=1, device="cuda")
    try:
        ds = _dataset()
        want = _numpy_batches(ds)
        got = []
        for b in ds.iter_torch_batches(
                batch_size=_BATCH,
                sharding=(mesh, [Shard(0)] * mesh.ndim)):
            assert all(isinstance(t, DTensor) for t in b.values())
            got.append({k: t.to_local() for k, t in b.items()})
            torch.cuda._sleep(200_000)
        _hold(got, want)
    finally:
        dist.destroy_process_group()
