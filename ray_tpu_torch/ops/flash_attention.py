"""Flash-attention forward: a CUDA kernel for Hopper, and its plain version.

Port of ``ray_tpu/ops/flash_attention.py``. The Pallas forward kernel
(``_fwd_kernel``/``_fwd``) becomes ``csrc/flash_fwd.cu`` (kernel B1), built
by ``ops/_build.py`` and called through ``ctypes``. The layout follows the
reference: ``[B, T, H, D]`` at the API, ``[B*H, T, D]`` inside.

Dispatch is by device, never by a fallback: a CUDA tensor launches the
kernel (or raises), a CPU tensor takes ``flash_attention_fwd_reference``,
the counterpart of Pallas' interpret mode on the CPU. The backward kernels
(B2 ``_bwd_dq_kernel``, B3 ``_bwd_dkv_kernel``) are not ported yet, so the
CUDA op raises on backward; on the CPU, autograd differentiates the plain
version as ordinary PyTorch.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

_NEG_INF = -1e30

# Launches of the CUDA kernel, counted where it is launched and nowhere else.
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_flash_fwd = None  # the bound C function, set at the first CUDA launch

# Unit roundoff of the kernel's arithmetic, for check_fwd: bf16 rounds P
# (and O) to 8 significant bits; fp32 has no rounding step of its own, so
# its "unit" is a generous allowance for summation order and expf.
_UNIT = {torch.bfloat16: 2.0 ** -8, torch.float32: 2.0 ** -14}
_O_REL_NORM_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
_LSE_TOL = 2e-4


def flash_attention_fwd_reference(q3, k3, v3, *, scale: float,
                                  causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of ``_fwd_kernel``, in fp32: q3 [BH, T, D],
    k3/v3 [BH, T_k, D] -> (O [BH, T, D] in q3's dtype, LSE [BH, 1, T] fp32)."""
    q, k, v = q3.float(), k3.float(), v3.float()
    s = torch.matmul(q, k.transpose(1, 2)) * scale
    if causal:
        t, t_k = q.shape[1], k.shape[1]
        keep = (torch.arange(t, device=q.device)[:, None]
                >= torch.arange(t_k, device=q.device)[None, :])
        s = torch.where(keep, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p, v) / l
    return o.to(q3.dtype), (m + torch.log(l))[..., 0][:, None, :]


def check_fwd(o, lse, q3, k3, v3, *, scale: float, causal: bool) -> dict:
    """Holds a kernel's (O, LSE) against the plain version on the same
    inputs; -> the errors, their tolerances and ``ok``.

    O, per element. With u the unit roundoff (bf16: 2^-8), the kernel
    rounds each P entry to bf16 (relative error <= u) before P.V, and both
    sides round O to bf16 (one ulp <= 2u|O| apart at most), so
        |O - O_plain| <= 2u |O_plain| + u (P |V|),   P = softmax(S),
    up to fp32 summation order; (P |V|) is the plain version run on |V|.
    The bound follows each output's own size: a flat tolerance would be
    as large as a typical |O| in the late rows of a long causal sequence,
    where a dropped K/V tile changes O by about that much.
    O, as a whole: ||O - O_plain|| / ||O_plain|| <= 1e-2 (bf16; rounding
    of P alone gives a few 1e-3) or 1e-5 (fp32).
    LSE is fp32 on both sides: |d| <= 2e-4 + 2e-4 |lse|."""
    o_ref, lse_ref = flash_attention_fwd_reference(q3, k3, v3, scale=scale,
                                                   causal=causal)
    pv_abs, _ = flash_attention_fwd_reference(q3, k3, v3.abs(), scale=scale,
                                              causal=causal)
    u = _UNIT[q3.dtype]
    o_ref, pv_abs, d_o = o_ref.float(), pv_abs.float(), o.float() - o_ref.float()
    # 5% and 1e-6 of slack: pv_abs and o_ref are themselves rounded to q3's dtype
    o_tol = 1.05 * (2 * u * o_ref.abs() + u * pv_abs) + 1e-6
    o_excess = (d_o.abs() / o_tol).max().item()
    o_rel = (d_o.norm() / o_ref.norm()).item()
    d_lse = (lse - lse_ref).abs()
    lse_ok = bool((d_lse <= _LSE_TOL + _LSE_TOL * lse_ref.abs()).all())
    finite = bool(torch.isfinite(o.float()).all() and torch.isfinite(lse).all())
    return {"o_max_abs_err": d_o.abs().max().item(),
            "o_err_over_tol": o_excess,
            "o_tol": f"1.05*(2u|O| + u*(P|V|)) + 1e-6, u={u}",
            "o_rel_norm_err": o_rel,
            "o_rel_norm_tol": _O_REL_NORM_TOL[q3.dtype],
            "lse_max_abs_err": d_lse.max().item(),
            "lse_tol": f"{_LSE_TOL} + {_LSE_TOL}*|lse|",
            "ok": (finite and o_excess <= 1.0 and lse_ok
                   and o_rel <= _O_REL_NORM_TOL[q3.dtype])}


def _check(q3, k3, v3):
    for name, x in (("q", q3), ("k", k3), ("v", v3)):
        if x.device != q3.device:
            raise ValueError(f"{name} is on {x.device}, q on {q3.device}")
        if x.dtype != q3.dtype:
            raise ValueError(f"{name} is {x.dtype}, q is {q3.dtype}")
        if x.dim() != 3:
            raise ValueError(f"{name} must be [B*H, T, D], got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous, strides {x.stride()}")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if q3.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_fwd takes {list(_DTYPE_CODE)}, got {q3.dtype}")
    bh, t, d = q3.shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_fwd takes head_dim in {_HEAD_DIMS}, got {d}")
    if k3.shape != v3.shape or k3.shape[0] != bh or k3.shape[2] != d:
        raise ValueError(f"k {tuple(k3.shape)} / v {tuple(v3.shape)} do not "
                         f"match q {tuple(q3.shape)}")
    if t == 0 or k3.shape[1] == 0:
        raise ValueError("flash_fwd needs T >= 1 and T_k >= 1")


def _kernel():
    """The C entry point of ``csrc/flash_fwd.cu``, built and bound once."""
    global _flash_fwd
    if _flash_fwd is None:
        from ray_tpu_torch.ops import _build  # lazy: CPU callers never build

        fn = _build.load("flash_fwd").flash_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        _flash_fwd = fn
    return _flash_fwd


def _launch(q3, k3, v3, scale: float, causal: bool):
    global launches
    _check(q3, k3, v3)
    bh, t, d = q3.shape
    o = torch.empty_like(q3)
    lse = torch.empty((bh, 1, t), dtype=torch.float32, device=q3.device)
    err = _kernel()(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), o.data_ptr(),
                    lse.data_ptr(), bh, t, k3.shape[1], d,
                    _DTYPE_CODE[q3.dtype], int(causal), float(scale),
                    q3.device.index or 0,
                    torch.cuda.current_stream(q3.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel failed: cudaError_t {err}")
    launches += 1
    return o, lse


def flash_attention_fwd(q3, k3, v3, *, scale: float, causal: bool):
    """B1 on ``[B*H, T, D]``: -> (O, LSE [B*H, 1, T] fp32). CUDA tensors run
    the kernel, CPU tensors the plain version."""
    if q3.device.type == "cpu":
        return flash_attention_fwd_reference(q3, k3, v3, scale=scale,
                                             causal=causal)
    if q3.device.type != "cuda":
        raise ValueError(f"flash_fwd runs on CUDA or CPU tensors, not "
                         f"{q3.device}")
    return _launch(q3, k3, v3, scale, causal)


class _Flash3(torch.autograd.Function):
    """Counterpart of the reference's ``_flash3`` custom_vjp (CUDA only)."""

    @staticmethod
    def forward(ctx, q3, k3, v3, scale, causal):
        o, _ = _launch(q3, k3, v3, scale, causal)
        return o

    @staticmethod
    def backward(ctx, do3):
        raise NotImplementedError(
            "flash-attention backward on CUDA needs kernels B2 "
            "(_bwd_dq_kernel) and B3 (_bwd_dkv_kernel), queued in ROADMAP.md")


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None, block_q: int = 256,
                    block_k: int = 256):
    """Fused attention. q, k, v: [B, T, H, D] -> [B, T, H, D].

    ``block_q``/``block_k`` are the Pallas kernel's VMEM tiles, kept for the
    reference's signature; the CUDA kernel tiles at 64 x 64 (shared memory,
    not VMEM, bounds it) and masks ragged tails itself."""
    del block_q, block_k
    b, t, h, d = q.shape
    scale = scale if scale is not None else d ** -0.5

    def to3(x):
        return x.transpose(1, 2).reshape(b * x.shape[2], x.shape[1], d)

    q3, k3, v3 = to3(q), to3(k), to3(v)
    if q.device.type == "cuda":
        o3 = _Flash3.apply(q3.contiguous(), k3.contiguous(), v3.contiguous(),
                           scale, causal)
    else:
        o3, _ = flash_attention_fwd(q3, k3, v3, scale=scale, causal=causal)
    return o3.reshape(b, h, t, d).transpose(1, 2)
