"""The port's model configs against the JAX package's, and the parameter
converter between them."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import config as jcfg
from ray_tpu.models.transformer import init_params as jax_init_params
from ray_tpu_torch.interop import params_from_numpy, tensor_from_numpy
from ray_tpu_torch.models import config as tcfg
from ray_tpu_torch.models.transformer import init_params, param_shapes
from torch_port_util import one_torch_thread  # noqa: F401 (fixture)

_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


@pytest.mark.parametrize("name", list(jcfg.PRESETS))
def test_preset_matches_reference(name):
    j = jcfg.get_config(name)
    t = tcfg.get_config(name)
    assert t.num_params == j.num_params
    assert t.flops_per_token() == j.flops_per_token()
    assert t.flops_per_token(512) == j.flops_per_token(512)
    assert (t.kv_heads, t.head_dim) == (j.kv_heads, j.head_dim)
    for f in dataclasses.fields(j):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if f.name in ("dtype", "param_dtype"):
            assert a == _DTYPES[b], f.name
        else:
            assert a == b, f.name


def test_presets_and_errors():
    assert list(tcfg.PRESETS) == list(jcfg.PRESETS)
    with pytest.raises(KeyError, match="unknown model preset"):
        tcfg.get_config("gpt5")
    # MoE configs build; num_params and flops_per_token stay the
    # reference's, which count one dense FFN a layer and no experts
    moe_t = tcfg.get_config("llama3-1b", moe_experts=8)
    moe_j = jcfg.get_config("llama3-1b", moe_experts=8)
    assert moe_t.num_params == moe_j.num_params == \
        tcfg.get_config("llama3-1b").num_params
    assert moe_t.flops_per_token(2048) == moe_j.flops_per_token(2048)
    assert tcfg.get_config("llama3-1b", param_dtype=torch.bfloat16) \
        .param_dtype == torch.bfloat16


@pytest.mark.parametrize("tie", [False, True])
def test_init_params_shapes_match_reference(tie):
    cfg_j = jcfg.tiny_config(tie_embeddings=tie)
    cfg_t = tcfg.tiny_config(tie_embeddings=tie)
    jp = jax_init_params(jax.random.key(0), cfg_j)
    tp = init_params(torch.Generator().manual_seed(0), cfg_t, device="cpu")
    jshapes = jax.tree.map(lambda x: tuple(x.shape), jp)
    assert jshapes == param_shapes(cfg_t)
    assert jax.tree.map(lambda x: tuple(x.shape), jp) == \
        jax.tree.map(lambda x: tuple(x.shape), tp)
    # same scales: std of each random matrix within 10% of the reference's
    for name in ("wq", "wo", "w_down"):
        a = float(np.asarray(jp["layers"][name]).std())
        b = float(tp["layers"][name].std())
        assert abs(a - b) / a < 0.1, name


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_params_from_numpy_roundtrip(dtype):
    cfg_j = jcfg.tiny_config(param_dtype=dtype)
    cfg_t = tcfg.tiny_config(param_dtype=_DTYPES[dtype])
    jp = jax_init_params(jax.random.key(1), cfg_j)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg_t, device="cpu")
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                            jax.tree.leaves(tp)):
        assert b.dtype == _DTYPES[dtype], path
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      b.float().numpy())


def test_params_from_numpy_rejects_mismatch():
    jp = jax.tree.map(np.asarray,
                      jax_init_params(jax.random.key(0), jcfg.tiny_config()))
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(jp, tcfg.tiny_config(d_ff=64), device="cpu")
    with pytest.raises(ValueError, match="keys"):
        params_from_numpy(jp, tcfg.tiny_config(tie_embeddings=True),
                          device="cpu")


def test_bf16_bits_survive():
    x = np.asarray(jnp.asarray([1.0, -2.5, 3.140625, 1e-3], jnp.bfloat16))
    t = tensor_from_numpy(x, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        t.view(torch.int16).numpy().view(np.uint16), x.view(np.uint16))
