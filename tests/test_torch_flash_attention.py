"""The port's flash-attention forward (its plain version, which CPU tensors
take) against the JAX package's Pallas kernel in interpret mode."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.parallel import reference_attention as jax_reference_attention
from ray_tpu_torch.interop import tensor_from_numpy
from ray_tpu_torch.parallel.ring import reference_attention
from torch_port_util import one_torch_thread  # noqa: F401 (fixture)

# the packages re-export the function under the module's name
jfa = importlib.import_module("ray_tpu.ops.flash_attention")
tfa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

# tolerances of tests/test_ops.py: fp32 2e-4, bf16 5e-2
_TOL = {jnp.float32: 2e-4, jnp.bfloat16: 5e-2}


def _arrays(shapes, dtype, seed=0):
    rng = np.random.RandomState(seed)
    js = [jnp.asarray(rng.randn(*s), jnp.float32).astype(dtype)
          for s in shapes]
    return js, [tensor_from_numpy(np.asarray(x), "cpu") for x in js]


@pytest.mark.parametrize("t,block,d,dtype,causal", [
    (64, 16, 16, jnp.float32, True),
    (64, 16, 16, jnp.float32, False),
    (48, 32, 16, jnp.float32, True),    # cdiv grid: ragged last q block
    (32, 32, 64, jnp.float32, True),
    (32, 16, 64, jnp.bfloat16, True),
    (48, 32, 64, jnp.bfloat16, False),
])
def test_fwd_o_and_lse_match_pallas(t, block, d, dtype, causal):
    bh = 3
    (q, k, v), (tq, tk, tv) = _arrays([(bh, t, d)] * 3, dtype)
    scale = d ** -0.5
    o, lse = jfa._fwd(q, k, v, scale=scale, causal=causal, block_q=block)
    to, tlse = tfa.flash_attention_fwd(tq, tk, tv, scale=scale,
                                       causal=causal)
    assert to.dtype == tq.dtype and tuple(tlse.shape) == tuple(lse.shape)
    tol = _TOL[dtype]
    np.testing.assert_allclose(to.float().numpy(), np.asarray(o, np.float32),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(lse), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_flash_attention_api_matches_pallas(causal, dtype):
    (q, k, v), (tq, tk, tv) = _arrays([(2, 48, 4, 16)] * 3, dtype, seed=1)
    out = jfa.flash_attention(q, k, v, causal=causal, block_q=32, block_k=32)
    tout = tfa.flash_attention(tq, tk, tv, causal=causal, block_q=32,
                               block_k=32)
    assert tout.shape == tq.shape and tout.dtype == tq.dtype
    tol = _TOL[dtype]
    np.testing.assert_allclose(tout.float().numpy(),
                               np.asarray(out, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("causal", [True, False])
def test_reference_attention_matches_jax(causal):
    (q, k, v), (tq, tk, tv) = _arrays(
        [(2, 24, 4, 16), (2, 40, 4, 16), (2, 40, 4, 16)], jnp.float32, seed=2)
    ref = jax_reference_attention(q, k, v, causal=causal)
    np.testing.assert_allclose(
        reference_attention(tq, tk, tv, causal=causal).numpy(),
        np.asarray(ref), rtol=2e-4, atol=2e-4)


def test_cpu_takes_plain_version_and_differentiates():
    """CPU tensors never reach the kernel (the launch count stays), and
    autograd runs through the plain version like ordinary PyTorch."""
    _, (q, k, v) = _arrays([(1, 32, 2, 16)] * 3, jnp.float32, seed=3)
    before = tfa.launches
    grads = []
    for fn in (tfa.flash_attention, reference_attention):
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        (fn(*xs, causal=True) ** 2).sum().backward()
        grads.append([x.grad for x in xs])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=2e-3, atol=2e-3)
    assert tfa.launches == before
