"""The port's model stack imports without DTensor.

In a fresh process that imports no JAX, importing ``ray_tpu_torch.models``
and running an unmeshed forward (also a remat config's with autograd on,
whose checkpoint would import torch._dynamo), a train step and an
engine's generation on the CPU leaves ``torch.distributed.tensor``, sympy
and torch._dynamo unimported (``parallel/_dtensor.py`` ``is_dtensor``).
The first call with a mesh then imports DTensor, and
``make_mesh(fsdp=1, device="cpu")``'s forward matches the unmeshed one.
Both are held against the JAX package's forward, train step and
``generate()`` on the same params, as ``tests/test_torch_parallel_train.py``
holds its meshes (fp32, 2e-4).
"""

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ray_tpu.models import config as jcfg
from ray_tpu.models.generate import generate as jax_generate
from torch_parallel_checks import TOL, batches, initial_params, jax_steps

_ROOT = Path(__file__).resolve().parent.parent
_PROMPT = [3, 1, 4, 1, 5]
_MAX_NEW = 4

# runs in a process of its own: the port alone, then the mesh of one
_CHILD = """\
import json, pickle, sys
import numpy as np
import torch

torch.set_num_threads(1)
import ray_tpu_torch.models  # the package's every re-export
from ray_tpu_torch.interop import params_from_numpy
from ray_tpu_torch.models import config as C
from ray_tpu_torch.models import training as TR
from ray_tpu_torch.models import transformer as T
from ray_tpu_torch.models.engine import InferenceEngine


def loaded():
    return {m: m in sys.modules for m in ("torch.distributed.tensor",
                                          "sympy", "torch._dynamo")}


with open(sys.argv[1], "rb") as f:
    spec = pickle.load(f)
cfg = C.tiny_config()
out = {"after_import": loaded()}
params = params_from_numpy(spec["params"], cfg, device="cpu")
inputs = torch.from_numpy(spec["batch"]["inputs"])
with torch.no_grad():
    out["logits"] = T.forward(params, inputs, cfg).numpy()
out["after_forward"] = loaded()
# a remat config with autograd on, as a forward-only worker runs it: no
# param needs a gradient, so no torch checkpoint (which imports dynamo)
out["remat_logits"] = T.forward(params, inputs,
                                C.tiny_config(remat=True)).detach().numpy()
out["after_remat_forward"] = loaded()
tx = TR.make_optimizer(spec["lr"])
state = {"step": torch.zeros((), dtype=torch.int32),
         "params": params_from_numpy(spec["params"], cfg, device="cpu")}
state["opt_state"] = tx.init(state["params"])
batch = {k: torch.from_numpy(v) for k, v in spec["batch"].items()}
_, metrics = TR.make_train_step(cfg, tx)(state, batch)
out["loss"] = float(metrics["loss"])
out["after_train_step"] = loaded()
eng = InferenceEngine(params, cfg, device="cpu", slots=2, max_prompt_len=16,
                      max_new_tokens=spec["max_new"])
out["engine_tokens"] = eng.generate(spec["prompt"])
out["after_engine"] = loaded()

from ray_tpu_torch.interop import shard_params
from ray_tpu_torch.parallel import make_mesh

mesh = make_mesh(fsdp=1, device="cpu")
out["after_mesh"] = loaded()
sharded = shard_params(mesh, spec["params"], cfg)
with torch.no_grad():
    logits = T.forward(sharded, inputs, cfg, mesh)
out["meshed_type"] = type(logits).__name__
out["meshed_logits"] = logits.full_tensor().numpy()
out["after_meshed_forward"] = loaded()
torch.distributed.destroy_process_group()
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(the child's results, the JAX references)."""
    cfg = jcfg.tiny_config()
    params = initial_params(cfg)
    batch, _ = batches()
    tmp = tmp_path_factory.mktemp("lazy_import")
    spec_path, out_path = tmp / "spec.pkl", tmp / "out.pkl"
    with open(spec_path, "wb") as f:
        pickle.dump({"params": params, "batch": batch, "lr": 1e-3,
                     "prompt": _PROMPT, "max_new": _MAX_NEW}, f)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(_ROOT)] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p])}
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, str(spec_path), str(out_path)],
        cwd=str(tmp), env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out_path, "rb") as f:
        out = pickle.load(f)
    jparams = jax.tree.map(jnp.asarray, params)
    from ray_tpu.models import transformer as jtr

    gen = jax_generate(jparams, np.asarray([_PROMPT], np.int32), cfg,
                       max_new_tokens=_MAX_NEW, greedy=True)
    refs = {"logits": np.asarray(jtr.forward(
                jparams, jnp.asarray(batch["inputs"]), cfg)),
            "loss": jax_steps(cfg, params, batch)["metrics"][0]["loss"],
            "engine_tokens": np.asarray(gen)[0, len(_PROMPT):].tolist()}
    return out, refs


def _rel(x, ref) -> float:
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("stage", ["after_import", "after_forward",
                                   "after_remat_forward",
                                   "after_train_step", "after_engine",
                                   "after_mesh"])
def test_unmeshed_paths_leave_dtensor_and_sympy_unimported(run, stage):
    out, _ = run
    assert out[stage] == {"torch.distributed.tensor": False,
                          "sympy": False, "torch._dynamo": False}, \
        json.dumps(out[stage])


def test_unmeshed_forward_step_and_engine_match_jax(run):
    out, refs = run
    assert _rel(out["logits"], refs["logits"]) <= TOL
    assert np.array_equal(out["remat_logits"], out["logits"])
    assert abs(out["loss"] - refs["loss"]) <= TOL * abs(refs["loss"])
    assert out["engine_tokens"] == refs["engine_tokens"]


def test_mesh_of_one_imports_dtensor_and_matches_unmeshed(run):
    out, refs = run
    assert out["after_meshed_forward"]["torch.distributed.tensor"] is True
    assert out["meshed_type"] == "DTensor"
    assert out["meshed_logits"].shape == out["logits"].shape
    assert _rel(out["meshed_logits"], out["logits"]) <= TOL
    assert _rel(out["meshed_logits"], refs["logits"]) <= TOL
