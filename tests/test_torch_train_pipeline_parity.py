"""The port's MPMD pipeline against the JAX package's, on the CPU. Inputs
and weights come from a numpy seed; params cross with
``interop.tensor_from_numpy``.

- The tanh(x @ w + b) stack of tests/test_pipeline.py: the port's
  ``single_program_reference`` against ``ray_tpu.train.pipeline``'s (JAX)
  within fp32 2e-4, and the port's ``Pipeline`` (GPipe, 1F1B, 2 stages x 2
  replicas) on a 3-node cluster against the port's oracle within the
  reference's own 1e-6 (loss) / 1e-5 (grads).
- A tiny-config llama cut into 2 stages (``chip_smoke.LlamaStage``, the
  card phase's stage functions) through ``Pipeline``: its loss and its
  grads, the two copies of the tied embedding summed, against
  ``jax.value_and_grad`` of ``ray_tpu.models.transformer.loss_fn`` within
  fp32 2e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ray_tpu.models import config as jcfg
from ray_tpu.models import transformer as jtr
from ray_tpu.train import pipeline as jpl
from ray_tpu_torch.interop import tensor_from_numpy
from ray_tpu_torch.models import config as tcfg
from ray_tpu_torch.models import transformer as ttr
from ray_tpu_torch.train import pipeline as pl
from torch_pipeline_stages import mse, tiny_numpy, tiny_torch_stages
from torch_pipeline_stages import tree_max_err
from torch_port_util import (  # noqa: F401 (fixtures)
    deadline, one_torch_thread, ray_start_cluster)

_TOL = 2e-4


def _jax_tanh_oracle(n_stages=2, n_mb=4):
    params, mbs, tgts = tiny_numpy(n_stages, n_mb)

    def fn(p, x):
        return jnp.tanh(x @ p["w"] + p["b"])

    stages = [jpl.PipelineStage(fn=fn, params=jax.tree.map(jnp.asarray, p))
              for p in params]
    return jpl.single_program_reference(
        stages, lambda y, t: jnp.mean((y - t) ** 2),
        [jnp.asarray(m) for m in mbs], [jnp.asarray(t) for t in tgts])


def test_single_program_reference_matches_jax():
    jloss, jgrads = _jax_tanh_oracle()
    stages, loss_fn, mbs, tgts = tiny_torch_stages(2)
    loss, grads = pl.single_program_reference(stages, loss_fn, mbs, tgts)
    assert abs(loss - float(jloss)) <= _TOL * abs(float(jloss))
    for g, jg in zip(grads, jgrads):
        for k in ("w", "b"):
            np.testing.assert_allclose(g[k].numpy(), np.asarray(jg[k]),
                                       rtol=_TOL, atol=_TOL)
    # the oracle leaves the stages' params as they were
    assert not any(p.requires_grad for st in stages
                   for p in st.params.values())


@deadline(120)
@pytest.mark.parametrize("schedule,replicas", [
    ("gpipe", 1), ("1f1b", 1), ("1f1b", 2)])
def test_pipeline_matches_oracle(ray_start_cluster, schedule, replicas):
    cluster = ray_start_cluster
    cluster.add_node(num_cpus=2)
    cluster.add_node(num_cpus=2)
    stages, loss_fn, mbs, tgts = tiny_torch_stages(2)
    ref_loss, ref_grads = pl.single_program_reference(
        stages, loss_fn, mbs, tgts)
    jloss, jgrads = _jax_tanh_oracle()
    pipe = pl.Pipeline(stages, loss_fn=loss_fn, schedule=schedule,
                       replicas_per_stage=replicas)
    try:
        out = pipe.run_batch(mbs, tgts, by_ref_min_bytes=0)
        grads = pipe.grads()
        probes = pipe.probe()
    finally:
        pipe.shutdown()
    assert abs(out["loss"] - ref_loss) < 1e-6
    for k in range(2):
        assert tree_max_err(grads[k], ref_grads[k]) < 1e-5
        assert tree_max_err(grads[k], jax.tree.map(np.asarray,
                                                   jgrads[k])) < _TOL
    if replicas == 1:
        # a stage folds each microbatch's grads as its backward runs: the
        # oracle folding in the same order (GPipe's backwards run in
        # reverse) equals the pipeline exactly
        order = slice(None, None, -1 if schedule == "gpipe" else 1)
        _, same_order = pl.single_program_reference(
            stages, loss_fn, mbs[order], tgts[order])
        assert out["loss"] == ref_loss
        assert tree_max_err(grads, same_order) == 0.0
    assert all(p["device"] == "cpu" and p["gpu_ids"] == []
               for p in probes)
    assert all(isinstance(v, torch.Tensor) for g in grads
               for v in g.values())


def _numpy_llama(cfg, seed=0):
    """llama params for ``cfg`` from a numpy seed, in the reference's tree
    (ttr.param_shapes): normal * 0.1, norms 1 + normal * 0.1."""
    rng = np.random.default_rng(seed)

    def fill(node, name=""):
        if isinstance(node, dict):
            return {k: fill(v, k) for k, v in node.items()}
        x = rng.standard_normal(node).astype(np.float32) * 0.1
        return x + 1.0 if name.endswith("norm") else x

    return fill(ttr.param_shapes(cfg))


@deadline(150)
def test_llama_two_stages_match_jax_loss_fn(ray_start_cluster):
    cluster = ray_start_cluster
    cluster.add_node(num_cpus=2)
    ct = tcfg.tiny_config(tie_embeddings=True)
    cj = jcfg.tiny_config(tie_embeddings=True)
    tree = _numpy_llama(ct)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, ct.vocab_size, (2, 17)).astype(np.int32)
    inputs, targets = toks[:, :-1], toks[:, 1:]

    jparams = jax.tree.map(jnp.asarray, tree)
    (jloss, _), jgrads = jax.value_and_grad(jtr.loss_fn, has_aux=True)(
        jparams, {"inputs": jnp.asarray(inputs),
                  "targets": jnp.asarray(targets)}, cj)

    tparams = {"embed": tensor_from_numpy(tree["embed"], "cpu"),
               "final_norm": tensor_from_numpy(tree["final_norm"], "cpu"),
               "layers": {k: tensor_from_numpy(v, "cpu")
                          for k, v in tree["layers"].items()}}
    stages = chip_smoke.llama_stages(pl, tparams, ct, 2)
    mbs = [torch.from_numpy(inputs[i:i + 1].copy()) for i in range(2)]
    tgts = [torch.from_numpy(targets[i:i + 1].copy()) for i in range(2)]
    pipe = pl.Pipeline(stages, loss_fn=chip_smoke.stage_loss,
                       schedule="1f1b")
    try:
        out = pipe.run_batch(mbs, tgts)
        g0, g1 = pipe.grads()
    finally:
        pipe.shutdown()
    assert abs(out["loss"] - float(jloss)) <= _TOL * abs(float(jloss))
    got = {"embed": (g0["embed"] + g1["head"]).numpy(),
           "final_norm": g1["final_norm"].numpy(),
           "layers": {k: torch.cat([g0["layers"][k], g1["layers"][k]])
                      .numpy() for k in g0["layers"]}}
    want = jax.tree.map(np.asarray, jgrads)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree.leaves(got)):
        np.testing.assert_allclose(b, a, rtol=_TOL, atol=_TOL,
                                   err_msg=str(path))
    # the card phase's stage: the tied head is its own stage param
    assert dataclasses.replace(ct, n_layers=1, remat=False) == \
        stages[1].fn.cfg
