"""Tensor parallelism (Megatron over the ``tensor`` axis) in the port against
the JAX package's unmeshed functions on the CPU.

One gloo world of 8 ranks (``tests/torch_parallel_ranks.tensor_rank``) runs
every case; the JAX side runs first, unmeshed:
- two AdamW steps (lr 1e-3) on data=2 x fsdp=2 x tensor=2 (the reference's
  fsdp=2 x tensor=2 case of tests/test_models.py:90-110, with a data axis
  to span 8 ranks), on fsdp=4 x tensor=2 with tied embeddings (the
  vocabulary-parallel lookup and head share one table) under remat
  "dots", and on sequence=2 x tensor=2 x fsdp=2 (ring attention on each
  rank's heads) under remat "nothing": loss, grad_norm and every param,
  fp32 2e-4 (ROADMAP C2's 2 x lr where the starting gradient vanishes);
- the masked eval step and the forward's DTensor logits (vocabulary over
  ``tensor``) on data=2 x fsdp=2 x tensor=2, 2e-4;
- the tensor-parallel engine on data=4 x tensor=2 (tests/test_engine.py:
  224-241), token for token against JAX's generate() under step();
- the virtual tensor driver (both ranks in one process, the reductions
  sums, as chip_smoke.py runs it on one card) against the gloo ranks on
  the same rows: logits, loss and gradients bit for bit.
Without a world: configs that do not split over the mesh raise ValueError.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ray_tpu.models import config as jcfg
from ray_tpu.models import training as jtrain
from ray_tpu.models import transformer as jtr
from ray_tpu.models.generate import generate as jax_generate
from ray_tpu_torch.models import config as tcfg
from ray_tpu_torch.models import transformer as ttr
from ray_tpu_torch.parallel.mesh import VirtualMesh
from ray_tpu_torch.parallel.world import run_world
from torch_parallel_checks import (LR, STEPS, TOL, batches, check_metric,
                                   check_steps, initial_params, jax_steps)
from torch_parallel_ranks import one_world_at_a_time, tensor_rank
from torch_port_util import one_torch_thread  # noqa: F401 (fixture)

# name -> (mesh, the config's changes from tiny_config: port, JAX)
TRAIN = {
    "data2_fsdp2_tensor2": (dict(data=2, fsdp=2, tensor=2), {}, {}),
    "fsdp4_tensor2_tied_dots": (
        dict(fsdp=4, tensor=2),
        dict(tie_embeddings=True, remat=True, remat_policy="dots"),
        dict(tie_embeddings=True)),
    "seq2_tensor2_fsdp2_ring": (
        dict(sequence=2, tensor=2, fsdp=2),
        dict(remat=True, remat_policy="nothing"), {}),
}
PROMPTS, MAX_NEW = [[3, 1, 4, 1, 5], [2, 7]], 8


@pytest.fixture(scope="module")
def runs():
    """(rank results, the JAX references)."""
    batch, eval_batch = batches()
    params = {"plain": initial_params(jcfg.tiny_config())}
    refs, steps = {"train": {}}, {}
    for name, (_, _, jkw) in TRAIN.items():
        key = tuple(sorted(jkw.items()))  # one JAX run a config
        if key not in steps:
            cj = jcfg.tiny_config(**jkw)
            p = initial_params(cj)
            steps[key] = (p, jax_steps(cj, p, batch))
        params[name], refs["train"][name] = steps[key]
    cj = jcfg.tiny_config()
    pj = jax.tree.map(jnp.asarray, params["plain"])
    jeval = {k: jnp.asarray(v) for k, v in eval_batch.items()}
    refs["eval"] = {k: float(v) for k, v in
                    jtrain.make_eval_step(cj)(pj, jeval).items()}
    refs["logits"] = np.asarray(jtr.forward(pj, jeval["inputs"], cj))
    refs["tokens"] = [np.asarray(jax_generate(
        pj, np.asarray([p], np.int32), cj, max_new_tokens=MAX_NEW,
        greedy=True))[0, len(p):].tolist() for p in PROMPTS]
    spec = {"train_meshes": [(n, m, kw) for n, (m, kw, _) in TRAIN.items()],
            "params": params, "batch": batch, "eval_batch": eval_batch,
            "steps": STEPS, "lr": LR, "prompts": PROMPTS, "max_new": MAX_NEW}
    with one_world_at_a_time():
        out = run_world(tensor_rank, 8, (spec,), device="cpu", timeout=300)
    return out, refs


@pytest.mark.parametrize("name", list(TRAIN))
def test_tensor_parallel_train_step_matches_jax(runs, name):
    out, refs = runs
    check_steps(out[0]["train"][name], refs["train"][name],
                ("loss", "grad_norm", "perplexity"))


def test_tensor_parallel_eval_step_matches_jax(runs):
    """The masked loss from vocabulary-parallel logits: the log-sum-exp over
    both ranks' shards, the gold logit from its owner."""
    out, refs = runs
    got = out[0]["eval_forward"]["eval"]
    assert set(got) == set(refs["eval"])
    for k, v in refs["eval"].items():
        check_metric(k, got[k], v)


def test_tensor_parallel_forward_returns_vocab_sharded_logits(runs):
    out, refs = runs
    got = out[0]["eval_forward"]
    # mesh dims: data, fsdp, expert, pipeline, sequence, tensor
    assert got["placements"] == ["S(0)", "S(0)", "R", "R", "S(1)", "S(2)"]
    assert np.abs(got["logits"] - refs["logits"]).max() <= TOL


def test_tensor_parallel_engine_matches_generate(runs):
    """Every rank's engine holds one of the two kv heads (cache [.., 1,
    hd]) and yields JAX's greedy tokens under step(); serve_forever is
    refused here, where the engine's 2 ranks are one of 4 replicas of an
    8-rank world (rank 0's step plans go over the whole world; it serves
    on a world of its own ranks in tests/test_torch_engine_mesh_serve.py)."""
    out, refs = runs
    for r in out:
        assert r["engine"]["tokens"] == refs["tokens"]
        assert r["engine"]["kv_heads_local"] == 1
        assert "whole world" in r["engine"]["serve_forever"]


def test_virtual_tensor_driver_equals_gloo_run(runs):
    out, _ = runs
    for r in out:
        assert r["bitwise"] == {"logits": True, "loss": True, "grads": True}


@pytest.mark.parametrize("axis,n,kw,what", [
    ("tensor", 8, dict(n_heads=4, n_kv_heads=2), "n_heads"),
    ("tensor", 4, dict(n_heads=4, n_kv_heads=2), "kv_heads"),
    ("tensor", 2, dict(d_ff=129), "d_ff"),
    ("tensor", 2, dict(vocab_size=255), "vocab_size"),
    ("pipeline", 2, dict(n_layers=3), "n_layers"),
    ("expert", 2, dict(moe_experts=3), "moe_experts"),
])
def test_indivisible_config_raises(axis, n, kw, what):
    cfg = tcfg.tiny_config(**kw)
    toks = np.zeros((2, 4), np.int32)
    with pytest.raises(ValueError, match=what):
        ttr.forward({}, toks, cfg, VirtualMesh(axis, n))
