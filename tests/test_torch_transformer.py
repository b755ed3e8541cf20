"""The port's decoder forward and loss against ``ray_tpu.models``' on the CPU.

The same weights (JAX init, converted by ``params_from_numpy``) and the same
tokens go through both; the JAX side runs its Pallas kernel in interpret
mode where the config asks for it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import config as jcfg
from ray_tpu.models import transformer as jtr
from ray_tpu_torch.interop import params_from_numpy, tensor_from_numpy
from ray_tpu_torch.models import config as tcfg
from ray_tpu_torch.models import transformer as ttr
from torch_port_util import one_torch_thread  # noqa: F401 (fixture)

_DT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
# tolerances of tests/test_ops.py: fp32 2e-4, bf16 5e-2
_TOL = {jnp.float32: 2e-4, jnp.bfloat16: 5e-2}


def _pair(**kw):
    """(JAX cfg, port cfg, JAX params, port params) for tiny_config(**kw)."""
    cj = jcfg.tiny_config(**kw)
    ct = tcfg.tiny_config(**{k: _DT.get(v, v) if k.endswith("dtype") else v
                             for k, v in kw.items()})
    pj = jtr.init_params(jax.random.key(0), cj)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), ct, device="cpu")
    return cj, ct, pj, pt


def _tokens(b, t, vocab=256, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (b, t)).astype(
        np.int32)


_VARIANTS = {
    "gqa_fp32": {},                                   # n_heads=4, kv=2
    "mha": {"n_kv_heads": 4},
    "gqa_4to1": {"n_kv_heads": 1},
    "tied": {"tie_embeddings": True},
    "encoder": {"causal": False},
    "pallas": {"attention_impl": "pallas"},
    "pallas_encoder": {"attention_impl": "pallas", "causal": False},
    "bf16": {"dtype": jnp.bfloat16},
    "bf16_params": {"dtype": jnp.bfloat16, "param_dtype": jnp.bfloat16},
}


@pytest.mark.parametrize("variant", list(_VARIANTS))
def test_forward_and_loss_match_reference(variant):
    kw = _VARIANTS[variant]
    cj, ct, pj, pt = _pair(**kw)
    toks = _tokens(2, 24)
    tol = _TOL[kw.get("dtype", jnp.float32)]
    lj = jtr.forward(pj, jnp.asarray(toks), cj)
    lt = ttr.forward(pt, torch.from_numpy(toks), ct)
    assert lt.dtype == torch.float32 and tuple(lt.shape) == lj.shape
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=tol, atol=tol)
    loss_j, mj = jtr.loss_fn(pj, {"tokens": jnp.asarray(toks)}, cj)
    loss_t, mt = ttr.loss_fn(pt, {"tokens": torch.from_numpy(toks)}, ct)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(float(mt["perplexity"]),
                               float(mj["perplexity"]), rtol=tol * 10)


def test_masked_loss_matches_reference():
    cj, ct, pj, pt = _pair(causal=False)
    inputs, targets = _tokens(2, 16, seed=1), _tokens(2, 16, seed=2)
    mask = (np.random.RandomState(3).rand(2, 16) < 0.3).astype(np.float32)
    lj, _ = jtr.loss_fn(pj, {"inputs": jnp.asarray(inputs),
                             "targets": jnp.asarray(targets),
                             "mask": jnp.asarray(mask)}, cj)
    lt, _ = ttr.loss_fn(pt, {"inputs": torch.from_numpy(inputs),
                             "targets": torch.from_numpy(targets),
                             "mask": torch.from_numpy(mask)}, ct)
    np.testing.assert_allclose(float(lt), float(lj), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("shared", [True, False])
def test_rope_matches_reference(shared):
    rng = np.random.RandomState(4)
    x = rng.randn(2, 6, 3, 16).astype(np.float32)
    pos = (np.arange(6) if shared else
           rng.randint(0, 100, (2, 6))).astype(np.int32)
    want = jtr._rope(jnp.asarray(x), jnp.asarray(pos), 500_000.0)
    got = ttr._rope(torch.from_numpy(x), torch.from_numpy(pos), 500_000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_rms_norm_matches_reference(dtype):
    rng = np.random.RandomState(5)
    x = jnp.asarray(rng.randn(2, 5, 64), jnp.float32).astype(dtype)
    g = jnp.asarray(rng.rand(64) + 0.5, jnp.float32)
    want = jtr.rms_norm(x, g, 1e-5)
    got = ttr.rms_norm(tensor_from_numpy(np.asarray(x), "cpu"),
                       tensor_from_numpy(np.asarray(g), "cpu"), 1e-5)
    assert got.dtype == _DT[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=_TOL[dtype], atol=_TOL[dtype])


def test_causality_and_module_wrapper():
    _, ct, _, pt = _pair()
    toks = torch.from_numpy(_tokens(1, 12))
    base = ttr.forward(pt, toks, ct)
    changed = toks.clone()
    changed[0, 8:] = (changed[0, 8:] + 1) % 256
    out = ttr.forward(pt, changed, ct)
    torch.testing.assert_close(out[:, :8], base[:, :8])
    assert not torch.allclose(out[:, 8:], base[:, 8:])
    module = ttr.Transformer(pt, ct)
    torch.testing.assert_close(module(toks), base)
    assert set(dict(module.named_parameters())) == {
        "embed", "final_norm", "lm_head",
        *(f"layers.{k}" for k in pt["layers"])}


def test_unported_paths_raise():
    """A mesh must be a DeviceMesh (the meshed paths run in
    tests/test_torch_parallel_train.py), and ring attention needs one."""
    _, ct, _, pt = _pair()
    toks = torch.from_numpy(_tokens(1, 4))
    with pytest.raises(TypeError, match="mesh"):
        ttr.forward(pt, toks, ct, mesh=object())
    with pytest.raises(ValueError, match="ring"):
        ttr.forward(pt, toks, dataclasses.replace(ct, attention_impl="ring"))
    with pytest.raises(ValueError, match="attention_impl"):
        ttr.forward(pt, toks, dataclasses.replace(ct, attention_impl="nope"))
