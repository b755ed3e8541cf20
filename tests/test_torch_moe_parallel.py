"""Mixture-of-Experts on the ``expert``, ``tensor`` and ``sequence`` axes in
the port against the JAX package's unmeshed functions on the CPU.

One gloo world of 8 ranks (``tests/torch_parallel_ranks.moe_rank``) runs
every case, on the reference's MoE test config (tests/test_models.py:142:
4 experts, top 2, d_model 16, fp32); the JAX side runs first, unmeshed:
- one MoE layer, h [4, 8, 16], each rank on its batch rows and sequence
  chunk with its experts and d_ff columns: on expert=4 x fsdp=2
  (tests/test_models.py:181), on sequence=2 x data=4 (capacity claimed
  along the whole row: rank 1 offsets its places by rank 0's counts) and
  on expert=2 x tensor=2 x data=2. Output and aux against JAX's moe_ffn,
  2e-4; expert ids and kept slots equal to the port's unsharded layer's;
- the virtual expert and sequence drivers (the ranks in one process, as
  chip_smoke.py runs them on one card) on each rank's batch rows against
  the gloo ranks: output, ids and kept slots bit for bit;
- the forward on expert=2 x tensor=2 x data=2 (tests/test_models.py:
  217-235), 2e-4;
- two AdamW steps (lr 1e-3) on expert=2 x tensor=2 x data=2 (the router's
  gradient summed over expert and tensor ranks, the aux's shared out) and
  on sequence=2 x fsdp=4: loss, grad_norm, moe_aux, total_loss and every
  param, 2e-4 (ROADMAP C2's 2 x lr where the starting gradient vanishes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import config as jcfg
from ray_tpu.models import moe as jmoe
from ray_tpu.models import transformer as jtr
from ray_tpu_torch.models import config as tcfg
from ray_tpu_torch.models import moe as tmoe
from ray_tpu_torch.parallel.world import run_world
from torch_parallel_checks import (LR, STEPS, TOL, batches, check_steps,
                                   initial_params, jax_steps)
from torch_parallel_ranks import moe_rank, one_world_at_a_time
from torch_port_util import one_torch_thread  # noqa: F401 (fixture)

CFG = dict(vocab_size=64, d_model=16, n_layers=2, n_heads=2,
           n_kv_heads=None, d_ff=32, attention_impl="xla", moe_experts=4,
           moe_top_k=2)
LAYER = {"expert4_fsdp2": dict(expert=4, fsdp=2),
         "seq2_data4": dict(sequence=2, data=4),
         "expert2_tensor2_data2": dict(expert=2, tensor=2, data=2)}
VIRTUAL = ("expert4_fsdp2", "seq2_data4")
# name -> (mesh, the port's config changes: a split sequence runs the ring)
TRAIN = {"expert2_tensor2_data2": (dict(expert=2, tensor=2, data=2), {}),
         "seq2_fsdp4": (dict(sequence=2, fsdp=4),
                        dict(attention_impl="auto"))}
H_SHAPE = (4, 8, 16)


@pytest.fixture(scope="module")
def runs():
    """(rank results, the JAX references, the port's unsharded layer)."""
    cj = jcfg.tiny_config(**CFG)
    params = initial_params(cj)
    lp = {k: np.array(params["layers"][k][0])
          for k in ("router", "w_gate", "w_up", "w_down")}
    h = np.random.RandomState(5).randn(*H_SHAPE).astype(np.float32)
    y, aux = jmoe.moe_ffn(jnp.asarray(h), jax.tree.map(jnp.asarray, lp), cj)
    refs = {"y": np.asarray(y), "aux": float(aux)}
    with torch.no_grad():
        _, _, top_i, kept = tmoe.moe_layer(
            torch.from_numpy(h), {k: torch.from_numpy(v)
                                  for k, v in lp.items()},
            tcfg.tiny_config(**CFG))
    unsharded = {"top_i": top_i.numpy(), "kept": kept.numpy()}
    tokens = np.random.RandomState(6).randint(0, 64, (4, 16)).astype(
        np.int32)
    refs["forward"] = np.asarray(jtr.forward(
        jax.tree.map(jnp.asarray, params), jnp.asarray(tokens), cj))
    batch, _ = batches(vocab=64)
    refs["train"] = jax_steps(cj, params, batch)
    spec = {"cfg": CFG, "params": params, "lp": lp, "h": h,
            "layer_meshes": LAYER, "tokens": tokens, "train_meshes": TRAIN,
            "batch": batch, "steps": STEPS, "lr": LR}
    with one_world_at_a_time():
        out = run_world(moe_rank, 8, (spec,), device="cpu", timeout=300)
    return out, refs, unsharded


def _assemble(out, name, key, k=1):
    """The ranks' [B_local, T_local * k, ...] parts -> the global array."""
    parts = {}
    for r in out:
        case = r["layer"][name]
        parts[case["coords"]] = case[key]
    (_, nb, _, ns), part = next(iter(parts.items()))
    rows, cols = part.shape[0], part.shape[1]
    full = np.zeros((rows * nb, cols * ns, *part.shape[2:]), part.dtype)
    for (b, _, s, _), p in parts.items():
        full[b * rows:(b + 1) * rows, s * cols:(s + 1) * cols] = p
    return full


@pytest.mark.parametrize("name", list(LAYER))
def test_sharded_moe_layer_matches_unsharded(runs, name):
    out, refs, unsharded = runs
    assert np.abs(_assemble(out, name, "y") - refs["y"]).max() <= TOL
    for r in out:
        assert abs(r["layer"][name]["aux"] - refs["aux"]) <= TOL
    np.testing.assert_array_equal(_assemble(out, name, "top_i"),
                                  unsharded["top_i"])
    np.testing.assert_array_equal(_assemble(out, name, "kept"),
                                  unsharded["kept"])


@pytest.mark.parametrize("name", VIRTUAL)
def test_virtual_moe_driver_equals_gloo_run(runs, name):
    out, _, _ = runs
    for r in out:
        assert r["layer"][name]["virtual_equal"] == {
            "y": True, "top_i": True, "kept": True}


def test_moe_forward_on_expert_tensor_data_mesh_matches_jax(runs):
    out, refs, _ = runs
    assert np.abs(out[0]["forward"] - refs["forward"]).max() <= TOL


@pytest.mark.parametrize("name", list(TRAIN))
def test_moe_train_step_on_model_axes_matches_jax(runs, name):
    out, refs, _ = runs
    check_steps(out[0]["train"][name], refs["train"],
                ("loss", "grad_norm", "moe_aux", "total_loss"))
