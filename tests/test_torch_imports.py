"""The port stands alone: it imports no JAX and nothing of the JAX package,
builds nothing at import, and never runs on the CPU unless asked to."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch_port_util import one_torch_thread  # noqa: F401 (fixture)

_ROOT = Path(__file__).resolve().parent.parent


def _port_modules():
    pkg = _ROOT / "ray_tpu_torch"
    return sorted(
        ".".join(p.relative_to(_ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in pkg.rglob("*.py"))


def test_port_imports_no_jax_and_no_reference_package():
    """Importing every module of the port, and the card scripts
    (chip_smoke, kernel_mutants), loads no JAX, no ml_dtypes,
    nothing of ray_tpu, and builds no kernel."""
    mods = _port_modules() + ["chip_smoke", "kernel_mutants"]
    assert {"ray_tpu_torch.ops.flash_attention", "ray_tpu_torch.ops._build",
            "ray_tpu_torch.models.training"} <= set(mods)
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "from ray_tpu_torch.ops import _build\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'ml_dtypes' or m == 'ray_tpu' or m.startswith('ray_tpu.')"
        " or m == 'bench_serve']\n"
        "print(json.dumps({'bad': bad, 'built': sorted(_build._libs),"
        " 'sources': _build.sources()}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=_ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(_ROOT)})
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"bad": [], "built": [],
                   "sources": ["flash_bwd", "flash_bwd_dkv", "flash_fwd"]}


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_without_device_raise_instead_of_using_cpu(no_cuda):
    import numpy as np

    from ray_tpu_torch.interop import params_from_numpy, tensor_from_numpy
    from ray_tpu_torch.models.config import tiny_config
    from ray_tpu_torch.models.engine import InferenceEngine
    from ray_tpu_torch.models.training import init_train_state, make_optimizer
    from ray_tpu_torch.models.transformer import init_params

    cfg = tiny_config()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_train_state(torch.Generator().manual_seed(0), cfg,
                         make_optimizer())
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine(params, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tensor_from_numpy(np.zeros(3, np.float32))
    tree = {k: (v.numpy() if not isinstance(v, dict) else
                {n: w.numpy() for n, w in v.items()})
            for k, v in params.items()}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_numpy(tree, cfg)


def test_chip_smoke_refuses_to_run_without_a_card():
    """No card: a non-zero exit and no result line."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, str(_ROOT / "chip_smoke.py")],
                         cwd=_ROOT, capture_output=True, text=True,
                         timeout=120, env=env)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
