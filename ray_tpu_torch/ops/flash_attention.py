"""Flash attention: CUDA kernels for Hopper, each beside its plain version.

Port of ``ray_tpu/ops/flash_attention.py``. The Pallas forward kernel
(``_fwd_kernel``/``_fwd``) becomes ``csrc/flash_fwd.cu`` (kernel B1), the
backward kernels (``_bwd_dq_kernel``, ``_bwd_dkv_kernel``, launched by
``_bwd``) become ``csrc/flash_bwd.cu`` (B2: dQ and Delta) and
``csrc/flash_bwd_dkv.cu`` (B3: dK, dV). For bf16, all three are Hopper
designs (TMA tile rings gated by mbarriers, wgmma; ``csrc/sm90_common.cuh``).
They are built by ``ops/_build.py`` and called through
``ctypes``. The layout follows the reference: ``[B, T, H, D]`` at the API,
``[B*H, T, D]`` inside.

Dispatch is by device, never by a fallback: a CUDA tensor launches the
kernel (or raises), a CPU tensor takes the plain version
(``flash_attention_fwd_reference``, ``flash_bwd_dq_reference``,
``flash_bwd_dkv_reference``), the counterpart of Pallas' interpret mode on
the CPU. ``flash_attention`` runs through the autograd Function ``_Flash3``
on both devices, so a CPU backward takes the same wiring as the card's.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

_NEG_INF = -1e30

# Launches of each CUDA kernel, counted where it is launched and nowhere
# else: B1 (forward), B2 (dQ), B3 (dK, dV).
launches = 0
launches_dq = 0
launches_dkv = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_bound = {}  # C entry point name -> the bound function, set at first launch

# Unit roundoff of the kernels' arithmetic, for check_fwd/check_bwd: bf16
# rounds P, dS and the outputs to 8 significant bits; fp32 has no rounding
# step of its own, so its "unit" is a generous allowance for summation order
# and expf (also the fp32 allowance of the bf16 kernels' fp32 sums).
_UNIT = {torch.bfloat16: 2.0 ** -8, torch.float32: 2.0 ** -14}
_O_REL_NORM_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
_LSE_TOL = 2e-4


def _scores(q, k, scale: float, causal: bool):
    """fp32 S = scale * Q K^T, the causal mask top-left aligned at -1e30."""
    s = torch.matmul(q, k.transpose(1, 2)) * scale
    if causal:
        t, t_k = q.shape[1], k.shape[1]
        keep = (torch.arange(t, device=q.device)[:, None]
                >= torch.arange(t_k, device=q.device)[None, :])
        s = torch.where(keep, s, torch.full_like(s, _NEG_INF))
    return s


def flash_attention_fwd_reference(q3, k3, v3, *, scale: float,
                                  causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of ``_fwd_kernel``, in fp32: q3 [BH, T, D],
    k3/v3 [BH, T_k, D] -> (O [BH, T, D] in q3's dtype, LSE [BH, 1, T] fp32)."""
    q, k, v = q3.float(), k3.float(), v3.float()
    s = _scores(q, k, scale, causal)
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




def _probs(q, k, lse, scale: float, causal: bool):
    """fp32 P = exp(S - LSE), recomputed from the forward's LSE (0 where
    masked), as the Pallas backward kernels do."""
    return torch.exp(_scores(q, k, scale, causal) - lse.float()[:, 0, :, None])


def flash_bwd_dq_reference(q3, k3, v3, o3, lse, do3, *, scale: float,
                           causal: bool):
    """The plain version of B2 (``_bwd_dq_kernel`` with the Delta of
    ``_bwd``), in fp32 -> (dQ in q3's dtype, Delta [BH, 1, T] fp32)."""
    q, k, v, do = q3.float(), k3.float(), v3.float(), do3.float()
    delta = (do * o3.float()).sum(dim=-1)[:, None, :]
    p = _probs(q, k, lse, scale, causal)
    ds = p * (torch.matmul(do, v.transpose(1, 2)) - delta[:, 0, :, None])
    return (torch.matmul(ds, k) * scale).to(q3.dtype), delta


def flash_bwd_dkv_reference(q3, k3, v3, lse, delta, do3, *, scale: float,
                            causal: bool):
    """The plain version of B3 (``_bwd_dkv_kernel``), in fp32 -> (dK, dV) in
    k3's and v3's dtypes."""
    q, k, v, do = q3.float(), k3.float(), v3.float(), do3.float()
    p = _probs(q, k, lse, scale, causal)
    dv = torch.matmul(p.transpose(1, 2), do)
    dp = torch.matmul(do, v.transpose(1, 2))
    ds = p * (dp - delta.float()[:, 0, :, None])
    dk = torch.matmul(ds.transpose(1, 2), q) * scale
    return dk.to(k3.dtype), dv.to(v3.dtype)


def flash_attention_bwd_reference(q3, k3, v3, o3, lse, do3, *, scale: float,
                                  causal: bool):
    """The plain version of ``_bwd``: -> (dQ, dK, dV) in the inputs' dtypes."""
    dq, delta = flash_bwd_dq_reference(q3, k3, v3, o3, lse, do3, scale=scale,
                                       causal=causal)
    dk, dv = flash_bwd_dkv_reference(q3, k3, v3, lse, delta, do3,
                                     scale=scale, causal=causal)
    return dq, dk, dv


def check_bwd(dq, dk, dv, q3, k3, v3, o3, lse, do3, *, scale: float,
              causal: bool) -> dict:
    """Holds the kernels' (dQ, dK, dV) against the plain version on the same
    inputs; -> the errors, their tolerances and ``ok``.

    Per element, with u the unit roundoff of the input dtype (bf16: 2^-8)
    and w = 2^-14 an allowance for fp32 sums taken in another order. The
    kernels round dS (B2, B3) and P (B3) to bf16 as operands of the second
    products, and both sides round their outputs to the input dtype, so
        |dQ - dQ_plain| <= 2u|dQ| + scale (u|dS| + w M) |K|
        |dK - dK_plain| <= 2u|dK| + scale (u|dS| + w M)^T |Q|
        |dV - dV_plain| <= 2u|dV| + (u P + w P*A)^T |dO|
    where M = P * (|dO| |V|^T + |Delta| + A |dP - Delta|) bounds what an fp32
    rounding of dP, Delta or S does to dS, and A = scale |Q| |K|^T bounds S's
    terms. Each bound is computed with the plain path on |.| of its
    operands, times 1.05, + 1e-6. As a whole: ||dX - dX_plain|| /
    ||dX_plain|| <= 1e-2 (bf16) or 1e-5 (fp32) for each output. The plain
    path runs over slices of B*H, so its T x T tensors stay near 256 MB."""
    u, w = _UNIT[q3.dtype], _UNIT[torch.float32]
    bh, t, _ = q3.shape
    t_k = k3.shape[1]
    step = max(1, (1 << 26) // (t * t_k))
    stats = {n: {"max": 0.0, "excess": 0.0, "d2": 0.0, "r2": 0.0}
             for n in ("dq", "dk", "dv")}
    finite = True
    for i in range(0, bh, step):
        sl = slice(i, i + step)
        q, k, v, o, do = (x[sl].float() for x in (q3, k3, v3, o3, do3))
        refs = flash_attention_bwd_reference(q3[sl], k3[sl], v3[sl], o3[sl],
                                             lse[sl], do3[sl], scale=scale,
                                             causal=causal)
        p = _probs(q, k, lse[sl], scale, causal)
        delta = (do * o).sum(dim=-1)[:, :, None]
        dp = torch.matmul(do, v.transpose(1, 2))
        ds = p * (dp - delta)
        a = scale * torch.matmul(q.abs(), k.abs().transpose(1, 2))
        m = p * (torch.matmul(do.abs(), v.abs().transpose(1, 2))
                 + delta.abs() + a * (dp - delta).abs())
        e = u * ds.abs() + w * m
        del dp, ds, m
        comp = {"dq": scale * torch.matmul(e, k.abs()),
                "dk": scale * torch.matmul(e.transpose(1, 2), q.abs()),
                "dv": torch.matmul((u * p + w * p * a).transpose(1, 2),
                                   do.abs())}
        del e, p, a
        for (name, got), ref in zip((("dq", dq), ("dk", dk), ("dv", dv)),
                                    refs):
            got, ref = got[sl].float(), ref.float()
            d = got - ref
            tol = 1.05 * (2 * u * ref.abs() + comp[name]) + 1e-6
            st = stats[name]
            st["max"] = max(st["max"], d.abs().max().item())
            st["excess"] = max(st["excess"], (d.abs() / tol).max().item())
            st["d2"] += d.double().pow(2).sum().item()
            st["r2"] += ref.double().pow(2).sum().item()
            finite = finite and bool(torch.isfinite(got).all())
    rel_tol = _O_REL_NORM_TOL[q3.dtype]
    out = {"finite": finite}
    ok = finite
    for name, st in stats.items():
        rel = (st["d2"] ** 0.5) / max(st["r2"] ** 0.5, 1e-30)
        out.update({f"{name}_max_abs_err": st["max"],
                    f"{name}_err_over_tol": st["excess"],
                    f"{name}_rel_norm_err": rel})
        ok = ok and st["excess"] <= 1.0 and rel <= rel_tol
    out.update({"tol": f"1.05*(2u|ref| + companion) + 1e-6, u={u}, w={w}",
                "rel_norm_tol": rel_tol, "ok": ok})
    return out


def _check(op, q3, k3, v3, **like_q):
    """Raises on what the kernels do not take: ``like_q`` are further
    [B*H, T, D] tensors of q's shape (O, dO)."""
    named = {"q": q3, "k": k3, "v": v3, **like_q}
    for name, x in named.items():
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
        raise TypeError(f"{op} takes {list(_DTYPE_CODE)}, got {q3.dtype}")
    bh, t, d = q3.shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"{op} takes head_dim in {_HEAD_DIMS}, got {d}")
    if k3.shape != v3.shape or k3.shape[0] != bh or k3.shape[2] != d:
        raise ValueError(f"k {tuple(k3.shape)} / v {tuple(v3.shape)} do not "
                         f"match q {tuple(q3.shape)}")
    for name, x in like_q.items():
        if x.shape != q3.shape:
            raise ValueError(f"{name} {tuple(x.shape)} does not match q "
                             f"{tuple(q3.shape)}")
    if t == 0 or k3.shape[1] == 0:
        raise ValueError(f"{op} needs T >= 1 and T_k >= 1")


def _check_rows(op, name, x, q3):
    """LSE and Delta: fp32, contiguous, [B*H, 1, T] on q's device."""
    want = (q3.shape[0], 1, q3.shape[1])
    if (x.device != q3.device or x.dtype != torch.float32
            or tuple(x.shape) != want or not x.is_contiguous()):
        raise ValueError(f"{op}: {name} must be a contiguous fp32 {want} "
                         f"tensor on {q3.device}, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")


def _kernel(lib: str, name: str, n_ptrs: int):
    """The C entry point ``name`` of ``csrc/<lib>.cu``, built and bound once:
    n_ptrs pointers, then (bh, t, t_k, d, dtype, causal, scale, device,
    stream)."""
    fn = _bound.get(name)
    if fn is None:
        from ray_tpu_torch.ops import _build  # lazy: CPU callers never build

        fn = getattr(_build.load(lib), name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        _bound[name] = fn
    return fn


def _call(lib: str, name: str, tensors, q3, k3, scale: float, causal: bool):
    err = _kernel(lib, name, len(tensors))(
        *(x.data_ptr() for x in tensors), q3.shape[0], q3.shape[1],
        k3.shape[1], q3.shape[2], _DTYPE_CODE[q3.dtype], int(causal),
        float(scale), q3.device.index or 0,
        torch.cuda.current_stream(q3.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel failed: cudaError_t {err}")


def _launch(q3, k3, v3, scale: float, causal: bool):
    global launches
    _check("flash_fwd", q3, k3, v3)
    bh, t, _ = q3.shape
    o = torch.empty_like(q3)
    lse = torch.empty((bh, 1, t), dtype=torch.float32, device=q3.device)
    _call("flash_fwd", "flash_fwd", (q3, k3, v3, o, lse), q3, k3, scale,
          causal)
    launches += 1
    return o, lse


def _launch_dq(q3, k3, v3, o3, lse, do3, scale: float, causal: bool):
    global launches_dq
    _check("flash_bwd_dq", q3, k3, v3, o=o3, do=do3)
    _check_rows("flash_bwd_dq", "lse", lse, q3)
    dq = torch.empty_like(q3)
    delta = torch.empty_like(lse)
    _call("flash_bwd", "flash_bwd_dq", (q3, k3, v3, o3, do3, lse, delta, dq),
          q3, k3, scale, causal)
    launches_dq += 1
    return dq, delta


def _launch_dkv(q3, k3, v3, lse, delta, do3, scale: float, causal: bool):
    global launches_dkv
    _check("flash_bwd_dkv", q3, k3, v3, do=do3)
    _check_rows("flash_bwd_dkv", "lse", lse, q3)
    _check_rows("flash_bwd_dkv", "delta", delta, q3)
    dk, dv = torch.empty_like(k3), torch.empty_like(v3)
    _call("flash_bwd_dkv", "flash_bwd_dkv",
          (q3, k3, v3, do3, lse, delta, dk, dv),
          q3, k3, scale, causal)
    launches_dkv += 1
    return dk, dv


def _device_of(q3, op: str) -> str:
    if q3.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{op} runs on CUDA or CPU tensors, not {q3.device}")
    return q3.device.type


def flash_attention_fwd(q3, k3, v3, *, scale: float, causal: bool):
    """B1 on ``[B*H, T, D]``: -> (O, LSE [B*H, 1, T] fp32). CUDA tensors run
    the kernel, CPU tensors the plain version."""
    if _device_of(q3, "flash_fwd") == "cpu":
        return flash_attention_fwd_reference(q3, k3, v3, scale=scale,
                                             causal=causal)
    return _launch(q3, k3, v3, scale, causal)


def flash_bwd_dq(q3, k3, v3, o3, lse, do3, *, scale: float, causal: bool):
    """B2: -> (dQ, Delta [B*H, 1, T] fp32)."""
    if _device_of(q3, "flash_bwd_dq") == "cpu":
        return flash_bwd_dq_reference(q3, k3, v3, o3, lse, do3, scale=scale,
                                      causal=causal)
    return _launch_dq(q3, k3, v3, o3, lse, do3, scale, causal)


def flash_bwd_dkv(q3, k3, v3, lse, delta, do3, *, scale: float, causal: bool):
    """B3, after B2 has written Delta: -> (dK, dV)."""
    if _device_of(q3, "flash_bwd_dkv") == "cpu":
        return flash_bwd_dkv_reference(q3, k3, v3, lse, delta, do3,
                                       scale=scale, causal=causal)
    return _launch_dkv(q3, k3, v3, lse, delta, do3, scale, causal)


def flash_attention_bwd(q3, k3, v3, o3, lse, do3, *, scale: float,
                        causal: bool):
    """``_bwd`` on ``[B*H, T, D]``: B2 then B3 -> (dQ, dK, dV). CUDA tensors
    run the kernels, CPU tensors the plain versions."""
    dq, delta = flash_bwd_dq(q3, k3, v3, o3, lse, do3, scale=scale,
                             causal=causal)
    dk, dv = flash_bwd_dkv(q3, k3, v3, lse, delta, do3, scale=scale,
                           causal=causal)
    return dq, dk, dv


class _Flash3(torch.autograd.Function):
    """Counterpart of the reference's ``_flash3`` custom_vjp: B1 forward,
    saving (q, k, v, O, LSE); B2 and B3 backward."""

    @staticmethod
    def forward(ctx, q3, k3, v3, scale, causal):
        o, lse = flash_attention_fwd(q3, k3, v3, scale=scale, causal=causal)
        ctx.save_for_backward(q3, k3, v3, o, lse)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    def backward(ctx, do3):
        q3, k3, v3, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q3, k3, v3, o, lse, do3.contiguous(),
                                         scale=ctx.scale, causal=ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None, block_q: int = 256,
                    block_k: int = 256):
    """Fused attention. q, k, v: [B, T, H, D] -> [B, T, H, D].

    ``block_q``/``block_k`` are the Pallas kernels' VMEM tiles, kept for the
    reference's signature; the CUDA kernels choose their own tiles (64 or
    128 rows: shared memory, not VMEM, bounds them) and mask ragged tails
    themselves."""
    del block_q, block_k
    b, t, h, d = q.shape
    scale = scale if scale is not None else d ** -0.5

    def to3(x):
        return x.transpose(1, 2).reshape(b * x.shape[2], x.shape[1],
                                         d).contiguous()

    o3 = _Flash3.apply(to3(q), to3(k), to3(v), scale, causal)
    return o3.reshape(b, h, t, d).transpose(1, 2)
