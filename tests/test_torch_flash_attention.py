"""The port's flash attention, forward and backward (the plain versions,
which CPU tensors take), against the JAX package's Pallas kernels in
interpret mode."""

import importlib

import jax
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


@pytest.mark.parametrize("t,t_k,block,d,dtype,causal", [
    (64, 64, 16, 16, jnp.float32, True),
    (64, 64, 16, 16, jnp.float32, False),
    (48, 48, 32, 16, jnp.float32, True),    # ragged: cdiv grid, T=48 block 32
    (48, 48, 32, 64, jnp.bfloat16, True),
    (32, 32, 16, 64, jnp.bfloat16, False),
    (32, 48, 16, 16, jnp.float32, True),    # T_q != T_k, top-left causal
    (48, 32, 16, 64, jnp.bfloat16, False),
])
def test_bwd_matches_pallas(t, t_k, block, d, dtype, causal):
    """flash_attention_bwd_reference (B2 + B3's plain versions, with Delta)
    against the JAX ``_bwd``, from the same residuals: the JAX forward's
    O and LSE."""
    bh = 3
    (q, k, v, do), (tq, tk, tv, tdo) = _arrays(
        [(bh, t, d), (bh, t_k, d), (bh, t_k, d), (bh, t, d)], dtype, seed=4)
    scale = d ** -0.5
    o, lse = jfa._fwd(q, k, v, scale=scale, causal=causal, block_q=block)
    want = jfa._bwd(scale, causal, block, block, (q, k, v, o, lse), do)
    to = tensor_from_numpy(np.asarray(o), "cpu")
    tlse = tensor_from_numpy(np.asarray(lse), "cpu")
    got = tfa.flash_attention_bwd_reference(tq, tk, tv, to, tlse, tdo,
                                            scale=scale, causal=causal)
    tol = _TOL[dtype]
    for g, w, x in zip(got, want, (tq, tk, tv)):
        assert g.dtype == x.dtype and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), rtol=tol,
                                   atol=tol)
    # the CPU dispatch takes exactly the plain versions
    before = (tfa.launches_dq, tfa.launches_dkv)
    for a, b in zip(tfa.flash_attention_bwd(tq, tk, tv, to, tlse, tdo,
                                            scale=scale, causal=causal), got):
        assert torch.equal(a, b)
    assert (tfa.launches_dq, tfa.launches_dkv) == before


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_grad_matches_pallas(causal, dtype):
    """jax.grad through ray_tpu's flash_attention (Pallas in interpret mode)
    against autograd through the port's (``_Flash3`` with the plain B1, B2
    and B3), mirroring tests/test_ops.py's gradient test."""
    (q, k, v, w), (tq, tk, tv, tw) = _arrays([(2, 48, 4, 16)] * 4, dtype,
                                             seed=5)

    def jloss(q, k, v):
        out = jfa.flash_attention(q, k, v, causal=causal, block_q=32,
                                  block_k=32)
        return jnp.sum(out.astype(jnp.float32) * w.astype(jnp.float32))

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    out = tfa.flash_attention(*leaves, causal=causal, block_q=32, block_k=32)
    got = torch.autograd.grad((out.float() * tw.float()).sum(), leaves)
    tol = _TOL[dtype]
    for g, x in zip(got, want):
        assert g.dtype == leaves[0].dtype
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(x, np.float32), rtol=tol,
                                   atol=tol)


def test_cpu_takes_plain_version_and_differentiates(monkeypatch):
    """CPU tensors never reach a kernel (no launch count moves), and
    autograd runs through ``_Flash3`` and the plain backward: the same
    gradients as autograd through reference_attention."""
    _, (q, k, v) = _arrays([(1, 32, 2, 16)] * 3, jnp.float32, seed=3)
    before = (tfa.launches, tfa.launches_dq, tfa.launches_dkv)
    calls = []
    plain_bwd = tfa.flash_attention_bwd
    monkeypatch.setattr(tfa, "flash_attention_bwd", lambda *a, **kw: (
        calls.append(a[0].device.type), plain_bwd(*a, **kw))[1])
    grads = []
    for fn in (tfa.flash_attention, reference_attention):
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        (fn(*xs, causal=True) ** 2).sum().backward()
        grads.append([x.grad for x in xs])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=2e-3, atol=2e-3)
    assert calls == ["cpu"]
    assert (tfa.launches, tfa.launches_dq, tfa.launches_dkv) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_check_bwd_passes_plain_and_fails_a_dropped_tile(dtype):
    """check_bwd's bound holds the plain version against itself and refuses
    gradients with one K/V tile (B2) or one Q tile (B3) left out."""
    g = torch.Generator().manual_seed(6)
    bh, t, d = 2, 192, 64
    q, k, v, do = (torch.randn(bh, t, d, generator=g).to(dtype)
                   for _ in range(4))
    o, lse = tfa.flash_attention_fwd(q, k, v, scale=0.125, causal=True)
    dq, dk, dv = tfa.flash_attention_bwd(q, k, v, o, lse, do, scale=0.125,
                                         causal=True)
    ok = tfa.check_bwd(dq, dk, dv, q, k, v, o, lse, do, scale=0.125,
                       causal=True)
    assert ok["ok"] and ok["dq_err_over_tol"] < 1e-3, ok
    # B2 without keys [64, 128); B3 without queries [128, 192)
    keep_k = torch.ones(t, dtype=torch.bool)
    keep_k[64:128] = False
    dq_bad, _ = tfa.flash_bwd_dq_reference(q, k * keep_k[:, None],
                                           v * keep_k[:, None], o, lse, do,
                                           scale=0.125, causal=True)
    bad = tfa.check_bwd(dq_bad, dk, dv, q, k, v, o, lse, do, scale=0.125,
                        causal=True)
    assert not bad["ok"] and bad["dq_err_over_tol"] > 10, bad
    keep_q = torch.ones(t, 1, dtype=torch.bool)
    keep_q[128:] = False
    _, delta = tfa.flash_bwd_dq_reference(q, k, v, o, lse, do, scale=0.125,
                                          causal=True)
    dk_bad, dv_bad = tfa.flash_bwd_dkv_reference(
        q * keep_q, k, v, lse, delta, do * keep_q, scale=0.125, causal=True)
    bad = tfa.check_bwd(dq, dk_bad, dv_bad, q, k, v, o, lse, do, scale=0.125,
                        causal=True)
    assert not bad["ok"] and bad["dv_err_over_tol"] > 10, bad
