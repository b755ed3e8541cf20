"""Pipeline parallelism (GPipe over the ``pipeline`` axis,
``ray_tpu_torch.parallel.pipeline``) against the JAX package's unmeshed
functions on the CPU.

One gloo world of 8 ranks (``tests/torch_parallel_ranks.pipeline_rank``)
runs every case; the JAX side runs first, unmeshed:
- ``pipeline_scan`` of tanh(x @ w_l) against ``jax.lax.scan``
  (tests/test_parallel.py:150-188): values with L=8 layers on pipeline=4
  (M=4 microbatches of 2 rows), and the gradient of mean(y^2) with respect
  to w and x with L=4 on pipeline=2 (M=4 of one row). A plain stack gives
  each stage the gradient of its own layers only; the test assembles them.
  fp32 2e-4;
- the same scans on a ``VirtualMesh("pipeline", S)`` (all stages in one
  process, the hand-off a copy, as chip_smoke.py runs them on one card)
  against the gloo ranks: values and gradients bit for bit;
- the pipelined forward on data=2 x pipeline=2 x tensor=2 (tests/
  test_parallel.py:190-212), 2e-4, and the virtual pipeline's forward
  against the pipelined forward over gloo on data=4 x pipeline=2, bit for
  bit;
- two AdamW steps (lr 1e-3) on data=2 x pipeline=2 x tensor=2 (remat
  "nothing") and on pipeline=2 x fsdp=2 x sequence=2 (remat "dots": ring
  attention and the ZeRO gathers inside each stage): loss, grad_norm and
  every param, 2e-4 (ROADMAP C2's 2 x lr where the starting gradient
  vanishes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ray_tpu.models import config as jcfg
from ray_tpu.models import transformer as jtr
from ray_tpu_torch.parallel.world import run_world
from torch_parallel_checks import (LR, STEPS, TOL, batches, check_steps,
                                   initial_params, jax_steps)
from torch_parallel_ranks import one_world_at_a_time, pipeline_rank
from torch_port_util import one_torch_thread  # noqa: F401 (fixture)

# name -> (L, d, B, the port's mesh, microbatches)
SCANS = {"values": (8, 16, 8, dict(pipeline=4, data=2), 4),
         "grads": (4, 8, 4, dict(pipeline=2, data=4), 4)}
# the reference's pipelined-forward config (tests/test_parallel.py:198-201)
CFG = dict(vocab_size=128, d_model=32, n_layers=4, n_heads=4,
           n_kv_heads=None, d_ff=64, attention_impl="xla",
           pipeline_microbatches=4)
TRAIN = {"data2_pipe2_tensor2": (dict(data=2, pipeline=2, tensor=2),
                                 dict(remat=True, remat_policy="nothing")),
         "pipe2_fsdp2_seq2_dots": (dict(pipeline=2, fsdp=2, sequence=2),
                                   dict(remat=True, remat_policy="dots",
                                        attention_impl="auto"))}


def _body(c, w):
    return jnp.tanh(c @ w), None


@pytest.fixture(scope="module")
def runs():
    """(rank results, the JAX references)."""
    scans, refs = {}, {"scan": {}}
    for name, (L, d, B, _, _) in SCANS.items():
        rng = np.random.RandomState({"values": 0, "grads": 1}[name])
        w = (rng.randn(L, d, d) * 0.1).astype(np.float32)
        x = rng.randn(B, d).astype(np.float32)
        scans[name] = (w, x)

        def loss(w, x):
            y, _ = jax.lax.scan(_body, x, w)
            return (y ** 2).mean(), y

        (_, y), (gw, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                              has_aux=True)(w, x)
        refs["scan"][name] = {"y": np.asarray(y), "gw": np.asarray(gw),
                              "gx": np.asarray(gx)}
    cj = jcfg.tiny_config(**CFG)
    params = initial_params(cj)
    tokens = np.random.RandomState(3).randint(0, 128, (8, 16)).astype(
        np.int32)
    refs["forward"] = np.asarray(jtr.forward(
        jax.tree.map(jnp.asarray, params), jnp.asarray(tokens), cj))
    batch, _ = batches(vocab=128)
    refs["train"] = jax_steps(cj, params, batch)
    spec = {"scan_cases": {n: (m, mb) for n, (_, _, _, m, mb)
                           in SCANS.items()},
            "scan": scans, "cfg": CFG, "params": params, "tokens": tokens,
            "train_meshes": [(n, m, kw) for n, (m, kw) in TRAIN.items()],
            "batch": batch, "steps": STEPS, "lr": LR}
    with one_world_at_a_time():
        out = run_world(pipeline_rank, 8, (spec,), device="cpu", timeout=300)
    return out, refs


def _stage_grads(out, name):
    """The stacked gradient assembled from each stage's own layers."""
    got = {r["scan"][name]["stage"]: r["scan"][name]["gw"] for r in out}
    n = out[0]["scan"][name]["stages"]
    L = got[0].shape[0]
    return np.concatenate([got[s][s * L // n:(s + 1) * L // n]
                           for s in range(n)])


@pytest.mark.parametrize("name", list(SCANS))
def test_pipeline_scan_matches_plain_scan(runs, name):
    out, refs = runs
    want = refs["scan"][name]
    for r in out:
        assert np.abs(r["scan"][name]["y"] - want["y"]).max() <= TOL
        assert np.abs(r["scan"][name]["gx"] - want["gx"]).max() <= TOL
    assert np.abs(_stage_grads(out, name) - want["gw"]).max() <= TOL


@pytest.mark.parametrize("name", list(SCANS))
def test_virtual_pipeline_equals_gloo_run(runs, name):
    """The virtual stages' output, input gradient and each stage's weight
    gradient equal the gloo pipeline's bit for bit."""
    out, _ = runs
    for r in out:
        real, virt = r["scan"][name], r["virtual_scan"][name]
        np.testing.assert_array_equal(virt["y"], real["y"])
        np.testing.assert_array_equal(virt["gx"], real["gx"])
    np.testing.assert_array_equal(
        out[0]["virtual_scan"][name]["gw"], _stage_grads(out, name))


def test_pipelined_forward_matches_jax(runs):
    out, refs = runs
    assert np.abs(out[0]["forward"] - refs["forward"]).max() <= TOL


def test_virtual_pipelined_forward_equals_gloo_run(runs):
    out, _ = runs
    assert all(r["virtual_forward_equal"] for r in out)


@pytest.mark.parametrize("name", list(TRAIN))
def test_pipelined_train_step_matches_jax(runs, name):
    out, refs = runs
    check_steps(out[0]["train"][name], refs["train"],
                ("loss", "grad_norm", "perplexity"))
