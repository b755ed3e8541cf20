"""The port's Train library on the card: a TorchTrainer whose num_gpus=1
worker trains a small bf16 decoder through B1/B2/B3, and checkpoints of
CUDA train state.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_train_gpu.py

The train loop is a module-level function, so it pickles by reference.
"""

import importlib
import os
import subprocess
import time

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import train

pytestmark = pytest.mark.gpu

_WORKER_PROBE = "ray_tpu_torch[.]core[.]worker_main"
_SEED, _STEPS, _CKPT_STEP, _FAIL_STEP = 0, 4, 2, 3
# remat "nothing": each layer's forward and its recompute through B1, one B2
# and one B3 a layer
_LAUNCHES = {"flash_fwd": 4, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}


def _config():
    """Two layers of a decoder the kernels take (head_dim 64), bf16."""
    from ray_tpu_torch.models.config import TransformerConfig

    return TransformerConfig(vocab_size=1024, d_model=256, n_layers=2,
                             n_heads=4, n_kv_heads=2, d_ff=512,
                             max_seq_len=256, param_dtype=torch.bfloat16,
                             remat=True)


def _batch(cfg):
    g = torch.Generator(device="cuda").manual_seed(_SEED + 3)
    toks = torch.randint(0, cfg.vocab_size, (2, 257), generator=g,
                         device="cuda", dtype=torch.int32)
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}


def _checksums(tree):
    from ray_tpu_torch.models.training import tree_leaves

    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return [x.reshape(-1).view(ints[x.element_size()]).sum(
        dtype=torch.int64).item() for x in tree_leaves(tree)]


def _fresh_state(cfg, tx):
    from ray_tpu_torch.models import transformer as T

    params = T.init_params(torch.Generator(device="cuda").manual_seed(_SEED),
                           cfg, device="cuda")
    return {"step": torch.zeros((), dtype=torch.int32, device="cuda"),
            "params": params, "opt_state": tx.init(params)}


def _loop(config):
    """Steps up to _STEPS, the state as a checkpoint at _CKPT_STEP, a
    failure after _FAIL_STEP's report on the first attempt; the restart
    resumes from the checkpoint on the card."""
    from ray_tpu_torch.models import training as TR

    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    cfg = _config()
    tx = TR.make_optimizer(1e-3, mu_dtype=torch.bfloat16)
    restored = train.get_checkpoint()
    if restored is None:
        state = _fresh_state(cfg, tx)
    else:
        state, _ = restored.to_pytree(device="cuda")
    step = TR.make_train_step(cfg, tx)
    batch = _batch(cfg)
    lease = {"gpu_ids": ray_tpu_torch.get_gpu_ids(),
             "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
             "device_count": torch.cuda.device_count(),
             "current_device": torch.cuda.current_device()}
    for i in range(int(state["step"]) + 1, _STEPS + 1):
        fa.launches = fa.launches_dq = fa.launches_dkv = 0
        _, m = step(state, batch)
        metrics = {"step": i, "loss": m["loss"].item(), "lease": lease,
                   "restart": restored is not None,
                   "launches": {"flash_fwd": fa.launches,
                                "flash_bwd_dq": fa.launches_dq,
                                "flash_bwd_dkv": fa.launches_dkv}}
        ckpt = None
        if i == _CKPT_STEP:
            metrics["checksums"] = _checksums(state)
            ckpt = train.Checkpoint.from_pytree(state)
        train.report(metrics, checkpoint=ckpt)
        if i == _FAIL_STEP and not os.path.exists(config["marker"]):
            open(config["marker"], "w").close()
            raise RuntimeError("injected worker failure")


def _workers_left():
    out = subprocess.run(["pgrep", "-f", _WORKER_PROBE], capture_output=True,
                         text=True)
    return out.stdout.split()


def test_trainer_worker_trains_through_the_kernels(tmp_path):
    from ray_tpu_torch.models import training as TR

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ray_tpu_torch.init(num_cpus=2, object_store_memory=2 << 30,
                       log_to_driver=False)
    try:
        result = train.TorchTrainer(
            _loop, train_loop_config={"marker": str(tmp_path / "failed")},
            scaling_config=train.ScalingConfig(num_workers=1, use_gpu=True),
            run_config=train.RunConfig(
                name="gpu", storage_path=str(tmp_path),
                checkpoint_config=train.CheckpointConfig(num_to_keep=1),
                failure_config=train.FailureConfig(max_failures=1))).fit()
    finally:
        ray_tpu_torch.shutdown()
    for _ in range(100):
        if not _workers_left():
            break
        time.sleep(0.1)
    assert _workers_left() == []
    assert result.error is None
    hist = result.metrics_history
    assert [m["step"] for m in hist] == [1, 2, 3, 3, 4]
    for m in hist:
        assert m["lease"] == {"gpu_ids": [0], "device_count": 1,
                              "current_device": 0,
                              "cuda_visible_devices":
                                  m["lease"]["cuda_visible_devices"]}
        assert len(m["lease"]["cuda_visible_devices"].split(",")) == 1
        assert m["launches"] == _LAUNCHES

    # the driver's own steps on the card from the same seed
    cfg = _config()
    tx = TR.make_optimizer(1e-3, mu_dtype=torch.bfloat16)
    state = _fresh_state(cfg, tx)
    step = TR.make_train_step(cfg, tx)
    want = [step(state, _batch(cfg))[1]["loss"].item()
            for _ in range(_STEPS)]
    got = [m["loss"] for m in hist if not m["restart"]] + \
        [m["loss"] for m in hist if m["restart"]][1:]
    again = [m["loss"] for m in hist if m["restart"]][0]
    assert got == pytest.approx(want, rel=1e-6, abs=0)
    assert again == pytest.approx(got[_FAIL_STEP - 1], rel=1e-6, abs=0)

    # the kept checkpoint is the step-2 state, bit for bit, on the card
    tree, _ = result.checkpoint.to_pytree(device="cuda")
    sums = next(m["checksums"] for m in hist if "checksums" in m)
    assert _checksums(tree) == sums
    assert tree["params"]["embed"].device.type == "cuda"
    assert tree["params"]["embed"].dtype == torch.bfloat16
    assert tree["opt_state"]["mu"]["embed"].dtype == torch.bfloat16
    assert int(tree["step"]) == _CKPT_STEP


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.int32])
def test_cuda_state_round_trips_through_a_directory(tmp_path, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(3, 5, generator=g, device="cuda") * 100
    tree = {"w": x.to(dtype), "s": torch.tensor(7, device="cuda",
                                                dtype=dtype)}
    path = train.Checkpoint.from_pytree(tree, note="n").to_directory(
        str(tmp_path / "c"))
    out, extra = train.Checkpoint.from_directory(path).to_pytree(
        device="cuda")
    assert extra == {"note": "n"}
    for k in tree:
        assert out[k].device.type == "cuda" and out[k].dtype == dtype
        assert torch.equal(out[k], tree[k])
