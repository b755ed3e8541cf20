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


@pytest.mark.parametrize("bh,t,t_k,d,dtype,causal", [
    (8, 256, 256, 64, torch.bfloat16, True),
    (4, 200, 200, 128, torch.bfloat16, False),
    (4, 48, 48, 64, torch.bfloat16, True),
    (2, 100, 150, 64, torch.bfloat16, True),
    (2, 150, 100, 128, torch.bfloat16, True),
    (4, 48, 48, 64, torch.float32, True),
    (2, 130, 70, 128, torch.float32, False),
    (2, 100, 100, 128, torch.float32, True),
])
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


def test_backward_raises_on_cuda(cuda):
    q, k, v = (torch.randn(1, 64, 2, 64, device=cuda, dtype=torch.bfloat16,
                           requires_grad=True) for _ in range(3))
    out = fa.flash_attention(q, k, v)
    with pytest.raises(NotImplementedError, match="B2"):
        out.float().sum().backward()
