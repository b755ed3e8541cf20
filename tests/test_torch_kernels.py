"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py
"""

import importlib

import pytest
import torch

from ray_tpu_torch.parallel.ring import reference_attention

# ray_tpu_torch.ops re-exports the function under the module's name
fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv3(bh, t, t_k, d, dtype, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn(bh, n, d, generator=g).to(device, dtype)
            for n in (t, t_k, t_k)]


# (bh, t, t_k, d, dtype, causal). The bf16 kernels tile queries and keys
# by 64 and 128: T = 192 and 320 end in a partial 128-row tile, 200/136
# puts T_q != T_k across a 128 boundary, and every BH > 1 case with such a
# T has a partial last tile in each head.
_CASES = [
    (8, 256, 256, 64, torch.bfloat16, True),
    (4, 200, 200, 128, torch.bfloat16, False),
    (4, 48, 48, 64, torch.bfloat16, True),
    (2, 100, 150, 64, torch.bfloat16, True),
    (2, 150, 100, 128, torch.bfloat16, True),
    (3, 192, 192, 64, torch.bfloat16, True),
    (3, 192, 192, 128, torch.bfloat16, False),
    (2, 320, 320, 64, torch.bfloat16, False),
    (2, 320, 320, 128, torch.bfloat16, True),
    (2, 200, 136, 64, torch.bfloat16, True),
    (2, 200, 136, 128, torch.bfloat16, False),
    (2, 136, 200, 128, torch.bfloat16, True),
    (4, 48, 48, 64, torch.float32, True),
    (2, 130, 70, 128, torch.float32, False),
    (2, 100, 100, 128, torch.float32, True),
]


@pytest.mark.parametrize("bh,t,t_k,d,dtype,causal", _CASES)
def test_flash_fwd_matches_plain(cuda, bh, t, t_k, d, dtype, causal):
    q, k, v = _qkv3(bh, t, t_k, d, dtype, cuda)
    scale = d ** -0.5
    o, lse = fa.flash_attention_fwd(q, k, v, scale=scale, causal=causal)
    assert o.dtype == dtype and o.shape == q.shape
    assert lse.shape == (bh, 1, t) and lse.dtype == torch.float32
    # per-element bound scaled to each output, see check_fwd
    check = fa.check_fwd(o, lse, q, k, v, scale=scale, causal=causal)
    assert check["ok"], check


def test_launch_counter_moves(cuda):
    q, k, v = _qkv3(2, 64, 64, 64, torch.bfloat16, cuda)
    before = fa.launches
    fa.flash_attention_fwd(q, k, v, scale=0.125, causal=True)
    assert fa.launches == before + 1
    fa.flash_attention_fwd_reference(q, k, v, scale=0.125, causal=True)
    assert fa.launches == before + 1


@pytest.mark.parametrize("d", [16, 32, 96, 256])
def test_unsupported_head_dim_raises(cuda, d):
    q, k, v = _qkv3(2, 64, 64, d, torch.bfloat16, cuda)
    before = fa.launches
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_fwd(q, k, v, scale=d ** -0.5, causal=True)
    assert fa.launches == before


def test_unsupported_dtype_and_layout_raise(cuda):
    q, k, v = _qkv3(2, 64, 64, 64, torch.float16, cuda)
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(q, k, v, scale=0.125, causal=True)
    q, k, v = _qkv3(2, 64, 64, 64, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_fwd(q.transpose(0, 1), k, v, scale=0.125,
                               causal=True)


def test_flash_attention_api_matches_reference(cuda):
    g = torch.Generator(device="cpu").manual_seed(1)
    b, t, h, d = 2, 96, 4, 64
    q, k, v = (torch.randn(b, t, h, d, generator=g).to(cuda, torch.bfloat16)
               for _ in range(3))
    out = fa.flash_attention(q, k, v, causal=True)
    ref = reference_attention(q, k, v, causal=True)
    # check_fwd's per-element bound, with reference_attention as the plain
    # version; then the [B*H, T, D] entry point gives the same O bit for bit
    u = 2.0 ** -8
    pv_abs = reference_attention(q, k, v.abs(), causal=True).float()
    tol = 1.05 * (2 * u * ref.float().abs() + u * pv_abs) + 1e-6
    assert bool(((out.float() - ref.float()).abs() <= tol).all())

    def to3(x):
        return x.transpose(1, 2).reshape(b * h, t, d)

    o3, _ = fa.flash_attention_fwd(to3(q).contiguous(), to3(k).contiguous(),
                                     to3(v).contiguous(), scale=d ** -0.5,
                                     causal=True)
    assert torch.equal(to3(out), o3)


# B2's 128-row query blocks and four-stage K/V ring: T = 2048 wraps the
# ring many times in every block, and T = 330 over T_k = 200 puts T_q > T_k
# across three query blocks, the last one ragged.
@pytest.mark.parametrize("bh,t,t_k,d,dtype,causal", _CASES + [
    (2, 70, 130, 64, torch.bfloat16, False),
    (2, 64, 192, 64, torch.float32, True),
    (2, 2048, 2048, 64, torch.bfloat16, True),
    (2, 2048, 2048, 128, torch.bfloat16, True),
    (2, 330, 200, 64, torch.bfloat16, True),
    (2, 330, 200, 128, torch.bfloat16, True),
])
def test_flash_bwd_matches_plain(cuda, bh, t, t_k, d, dtype, causal):
    q, k, v = _qkv3(bh, t, t_k, d, dtype, cuda)
    g = torch.Generator(device="cpu").manual_seed(7)
    do = torch.randn(bh, t, d, generator=g).to(cuda, dtype)
    scale = d ** -0.5
    o, lse = fa.flash_attention_fwd(q, k, v, scale=scale, causal=causal)
    before = (fa.launches_dq, fa.launches_dkv)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do, scale=scale,
                                        causal=causal)
    assert (fa.launches_dq, fa.launches_dkv) == (before[0] + 1,
                                                 before[1] + 1)
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape
    assert dq.dtype == dk.dtype == dv.dtype == dtype
    # per-element bound scaled to each output, see check_bwd
    check = fa.check_bwd(dq, dk, dv, q, k, v, o, lse, do, scale=scale,
                         causal=causal)
    assert check["ok"], check
    _, delta = fa.flash_bwd_dq_reference(q, k, v, o, lse, do, scale=scale,
                                         causal=causal)
    _, delta_kernel = fa.flash_bwd_dq(q, k, v, o, lse, do, scale=scale,
                                      causal=causal)
    torch.testing.assert_close(delta_kernel, delta, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_bwd_dq_is_deterministic(cuda, d, causal):
    """B2 sums each dQ and Delta element in one thread, in a fixed order,
    with no atomics: two launches on the same inputs agree bit for bit."""
    bh, t = 4, 520
    q, k, v = _qkv3(bh, t, t, d, torch.bfloat16, cuda)
    g = torch.Generator(device="cpu").manual_seed(7)
    do = torch.randn(bh, t, d, generator=g).to(cuda, torch.bfloat16)
    scale = d ** -0.5
    o, lse = fa.flash_attention_fwd(q, k, v, scale=scale, causal=causal)
    dq1, delta1 = fa.flash_bwd_dq(q, k, v, o, lse, do, scale=scale,
                                  causal=causal)
    dq2, delta2 = fa.flash_bwd_dq(q, k, v, o, lse, do, scale=scale,
                                  causal=causal)
    assert torch.equal(dq1, dq2)
    assert torch.equal(delta1, delta2)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_partial_last_tile_reads_no_other_head(cuda, d, causal):
    """T = 200 leaves every head a partial last tile (rows 128-199 of a
    128-row tile). Heads 1 and 3 are NaN: a kernel whose tile reads past
    the end of its head into the next one (a 2-D tensor map over
    [B*H*T, D]) carries their NaN into heads 0 and 2, whose O, LSE, dQ, dK
    and dV must still match the plain version."""
    bh, t, dtype = 4, 200, torch.bfloat16
    q, k, v = _qkv3(bh, t, t, d, dtype, cuda)
    g = torch.Generator(device="cpu").manual_seed(7)
    do = torch.randn(bh, t, d, generator=g).to(cuda, dtype)
    for x in (q, k, v, do):
        x[1::2] = float("nan")
    scale = d ** -0.5
    o, lse = fa.flash_attention_fwd(q, k, v, scale=scale, causal=causal)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do, scale=scale,
                                        causal=causal)
    ev = slice(0, bh, 2)
    check = fa.check_fwd(o[ev], lse[ev], q[ev], k[ev], v[ev], scale=scale,
                         causal=causal)
    assert check["ok"], check
    check = fa.check_bwd(dq[ev], dk[ev], dv[ev], q[ev], k[ev], v[ev], o[ev],
                         lse[ev], do[ev], scale=scale, causal=causal)
    assert check["ok"], check


def test_bwd_plain_versions_launch_nothing(cuda):
    q, k, v = _qkv3(2, 64, 64, 64, torch.bfloat16, cuda)
    o, lse = fa.flash_attention_fwd(q, k, v, scale=0.125, causal=True)
    before = (fa.launches_dq, fa.launches_dkv)
    fa.flash_attention_bwd_reference(q, k, v, o, lse, o, scale=0.125,
                                     causal=True)
    assert (fa.launches_dq, fa.launches_dkv) == before


@pytest.mark.parametrize("d", [32, 96])
def test_bwd_unsupported_head_dim_raises(cuda, d):
    q, k, v = _qkv3(2, 64, 64, d, torch.bfloat16, cuda)
    lse = torch.zeros(2, 1, 64, device=cuda)
    before = fa.launches_dq
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_bwd(q, k, v, q, lse, q, scale=d ** -0.5,
                               causal=True)
    assert fa.launches_dq == before


def test_backward_launches_b2_and_b3(cuda):
    """A backward through flash_attention on CUDA runs B2 and B3 once each,
    and its gradients agree with autograd through reference_attention."""
    g = torch.Generator(device="cpu").manual_seed(2)
    b, t, h, d = 2, 96, 4, 64
    leaves = [torch.randn(b, t, h, d, generator=g).to(cuda, torch.bfloat16)
              .requires_grad_(True) for _ in range(3)]
    do = torch.randn(b, t, h, d, generator=g).to(cuda, torch.bfloat16)
    before = (fa.launches, fa.launches_dq, fa.launches_dkv)
    out = fa.flash_attention(*leaves, causal=True)
    grads = torch.autograd.grad(out, leaves, do)
    assert (fa.launches, fa.launches_dq, fa.launches_dkv) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    ref = torch.autograd.grad(
        reference_attention(*(x.float() for x in leaves), causal=True),
        leaves, do.float())
    for got, want in zip(grads, ref):
        assert bool(torch.isfinite(got).all())
        # bf16 kernel vs the fp32 plain gradient: rounding of P, dS and the
        # bf16 output (check_bwd's relative bound)
        rel = ((got.float() - want.float()).norm() / want.float().norm())
        assert rel.item() <= 1e-2, rel.item()
