#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Builds every CUDA kernel of the port from the sources in this checkout, then
drives the port's serving and training paths on llama3-1b at full width
(d_model 2048, 16 layers, 32 heads / 8 KV heads, d_ff 8192, vocab 128,256,
tied embeddings; random weights and tokens from --seed), one JSON line per
phase:

  build     nvcc for every csrc/*.cu, all started together; ptxas'
            registers, shared memory and spills of every kernel (the phase
            fails if any kernel spills)
  device    the card, its count and power limit
  kernels   each kernel against its plain PyTorch version at the main
            paths' shapes and more: errors beside tolerances, kernel / plain
            / PyTorch-library times (CUDA events) and the card's bound;
            B1 (flash_fwd), then B2 and B3 (flash_bwd_dq, flash_bwd_dkv);
            for bf16 all three are sm_90a designs (TMA tile rings gated by
            mbarriers, wgmma)
  ring      ring attention (ray_tpu_torch.parallel.ring) for P = 4
            virtual ranks in one process at llama3-1b's attention width,
            bf16: [4, 2048, 32, 64] causal and non-causal, [1, 8192, 32,
            64] causal; the ring's block steps (B1 forward, B2/B3 backward
            per visited block, LSE merge) against B1 and B2/B3 over the
            whole sequence (ring_check), launches counted, both timed
  entry     ray_tpu_torch.entry.entry(): the GPT-2-small forward at
            [4, 512], finite logits of the right shape
  forward   forward(params, tokens[4, 2048]) in bf16 through the flash
            kernel (launches counted), against plain attention and the
            fp32 forward
  engine    InferenceEngine in fp32 (no TF32), token for token against the
            port's own generate()
  serving   InferenceEngine in bf16 at bench_serve.py's settings under
            serve_forever: 8 client threads, 32 requests
  moe_layer one Mixture-of-Experts layer of llama3-1b with 8 experts, top 2
            (capacity factor 1.25) at [4, 2048] bf16: moe_ffn (dispatch by
            index) against moe_ffn_dense (the reference's one-hot einsums):
            the same experts and kept slots exactly, the output within a
            per-element bf16 bound; both timed beside the layer's bound
  moe_forward  the 16-layer MoE model's forward at [4, 2048] bf16 through
            B1 (launches counted), against plain attention as distances from
            the fp32 forward; tokens that route differently
  moe_serving  the bf16 16-layer MoE model under serve_forever at
            bench_serve.py's settings, as phase serving
  moe_engine   the MoE model at 4 layers in fp32, the engine token for token
            against generate() on prompts that fill their bucket (no pads)
  moe_train    the MoE model at 4 layers, batch 4 x 2048, bf16, remat: the
            train check (a) and five AdamW steps with launches counted; ms
            per step and MFU of the active work
  moe_parallel the MoE layer at [4, 2048] on 4 virtual expert ranks (2
            experts each) and on 2 virtual sequence ranks, at capacity
            factor 1.25 and 0.5, against the unsharded layer by moe_layer's
            checks
  engine_mesh  the fp32 engine on make_mesh(tensor=1), an NCCL world of one,
            token for token against the unmeshed engine (the meshed
            engine's code path only: no split over ranks on one card)
  tensor    the train cell on 4 virtual tensor ranks (VirtualMesh: each
            rank's heads through B1/B2/B3 at [32, 2048, 64], the partial
            sums added in one process): the forward check and train check
            (a) against the unmeshed plain and fp32 runs, launches 64 /
            128/64/64, times and a rank's share
  pipeline  the train cell in 4 virtual GPipe stages of 4 layers on 4
            microbatches of [1, 2048] (bubble ticks skipped): the same
            checks and launches, times, the bubble share
  train_mesh   phase train's cell on make_mesh(fsdp=1), an NCCL world of
            one: params and moments as DTensors, each layer's weights
            gathered at use; one step's loss and gradient against the
            unmeshed step's (equal within 1e-6), then five AdamW steps with
            launches counted, ms per step and peak memory
  train_dots   phase train's cell with remat_policy="dots": one step's loss
            and gradient against the "nothing" step's; two timed optimizer
            steps each way and a third under the profiler: launches, ms per
            step, device time and peak memory
  train     bench.py's llama3-1b training cell (batch 4 x 2048, bf16
            params, remat, AdamW with a bf16 first moment): one step's loss
            and gradient through the kernels and through plain attention,
            each against the fp32 step; five optimizer steps through the
            kernels with their launches counted; ms per step, tokens/s, MFU,
            peak memory and the device's busy share

After each phase a line {"phase_wall": name, "s": seconds}. Then the
kernel summary line, the card's nvidia-smi line, and as the last
line {"ok": true, "device": {...}}. Any failure exits non-zero before that
line. Without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import json
import math
import os
import random
import subprocess
import sys
import threading
import time
import traceback

_ROOT = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): bf16 on the
# tensor cores, fp32 outside them (the fp32 kernel uses no TF32), HBM rate.
_PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
_HBM_BYTES_PER_S = 3.35e12

# The kernel against its plain version: flash_attention.check_fwd, whose
# per-element bound on O follows each output's size (P rounded to bf16,
# O rounded to bf16) and whose LSE bound is 2e-4 + 2e-4 |lse|.
# Forward through the kernel vs through plain attention, as a relative
# distance of the logits: the two differ by the kernel's rounding (P in
# bf16, fp32 sums in another order) in each of 16 layers.
_FWD_REL_TOL = 1e-2
# The bf16 forward through the kernel may be at most 2% further from the
# fp32 forward than the plain-attention bf16 forward is (measured on the
# H100: 1.0045 times as far).
_FWD_BF16_RATIO = 1.02
# The train step's loss and gradients through the kernels may be at most
# this many times as far from the fp32 step as the plain-attention bf16
# step's are. Set from the plain bf16 step's own noise, measured on the H100
# over two weight seeds x two batches (kernel_mutants.py's baseline): the
# flattened gradient's distance held at 0.04350-0.04356 while the kernels'
# stayed 1.0039-1.0069 times it, so 1.05; the loss's distance is a scalar
# at bf16's floor and ranged 5.75e-6 to 4.38e-5, 7.6-fold, so 8. The loss
# reads the forward only. The leaves that B2's dQ and B3's dK, dV reach
# first are held on their own ("attn_grad": the largest ratio among
# _ATTN_GRAD_LEAVES): plain 0.0443-0.0450 from fp32, kernels 0.9941-1.0094
# times it, so 1.05. Mutants of B2 and B3 reach 8.45 and 3.48 there.
_TRAIN_BF16_RATIO = {"loss": 8.0, "grad": 1.05, "attn_grad": 1.05}
_ATTN_GRAD_LEAVES = ("layers.wq", "layers.wk", "layers.wv")
_TRAIN_STEPS = 5
_TRAIN_LAUNCHES = {"flash_fwd": 32, "flash_bwd_dq": 16, "flash_bwd_dkv": 16}

# The MoE configuration: llama3-1b at full width with 8 experts, top 2, the
# reference's capacity factor and aux weight. Training runs 4 of its 16
# layers (params, grads and both moments in bf16 are 8 B a parameter: 55 GB
# at 16 layers, 15 GB at 4).
_MOE = dict(moe_experts=8, moe_top_k=2, moe_capacity_factor=1.25,
            moe_aux_weight=0.01)
_MOE_TRAIN_LAYERS = 4
_MOE_TRAIN_LAUNCHES = {"flash_fwd": 8, "flash_bwd_dq": 4, "flash_bwd_dkv": 4}
# moe_layer: moe_ffn against moe_ffn_dense per element. Both gather the same
# bf16 rows (exactly) and run the same three products; they may differ only
# where a product's fp32 sum runs in another order and flips a bf16
# rounding of gate, up, the op-by-op SwiGLU (a few roundings) or the
# expert's output. With u = 2^-8 and A = sum over a token's kept slots of
# p * (|act| @ |W_down|) (the size the output's rounding follows), the bound
# is 2u|y| (y's own rounding, twice) + 6u A, with 5% and 1e-6 of slack, as
# check_fwd scales its bound; as a whole ||dy|| / ||y|| <= 1e-2.
_MOE_LAYER_UNIT = 2.0 ** -8
_MOE_LAYER_REL_TOL = 1e-2
# moe_layer's second case: a capacity factor under which about half the
# slots drop (C = 256 places an expert a row for 4,096 slots a row), so the
# dropped-slot path runs at full width too
_MOE_LAYER_DROP_CF = 0.5
# moe_forward: routing is a discontinuity. A token near a tie between two
# experts changes its experts when attention's rounding changes, and the
# change spreads to later layers and tokens: the bf16 forwards keep 0.37-
# 0.40 from the fp32 one with 10-11% of token-layers routed differently,
# and even fp32 through B1 and through plain attention route 0-107 of
# 131,072 token-layers differently. Measured on the H100 over 2 weight
# seeds x 2 batches of the unbroken kernels (kernel_mutants.py's baseline):
# the bf16 kernel/plain ratio of distances from the fp32 forward 0.9864-
# 1.0409, so 1.10 (B1's mutant: 3.09); fp32 kernel vs plain 1.1e-5 to
# 3.09e-2 (the largest with 107 flips), so 0.1.
_MOE_FWD_BF16_RATIO = 1.10
_MOE_FWD_FP32_REL_TOL = 0.1
# train_dots: "dots" only chooses which results the backward keeps and
# which it recomputes, from the same ops on the same inputs, so its step
# must equal "nothing"'s: loss (absolute) and flattened gradient (relative)
# within 1e-6, as tests/test_torch_remat_dots.py holds them on the CPU.
_DOTS_TOL = 1e-6
# ring: P virtual ranks; causal runs P(P+1)/2 blocks (the diagonal and the
# blocks below it), non-causal P^2. Cases: name, B, T, H, D, causal.
_RING_P = 4
_RING_CASES = (("main", 4, 2048, 32, 64, True),
               ("long", 1, 8192, 32, 64, True),
               ("noncausal", 4, 2048, 32, 64, False))
# Each side within the kernel checks' 1e-2 of the plain version, so the ring
# and the whole-sequence kernels within 2e-2 of each other, as a whole.
_RING_REL_NORM_TOL = 2e-2
# train_mesh: on a mesh of one every collective is skipped and the DTensor
# wrapper computes the same ops on the same tensors as the unmeshed step
_MESH_TOL = 1e-6
# tensor and pipeline: the model's ranks run in turn on the one card
# (VirtualMesh): 4 tensor ranks (8 of the 32 heads, 2 of the 8 kv heads,
# 2048 of the 8192 d_ff columns, 32,064 of the vocabulary rows each), or 4
# pipeline stages of 4 layers on 4 microbatches of [1, 2048]. The kernel
# side runs there, the plain bf16 and the fp32 truth unmeshed; the forward
# and train checks' ratios are set from the unbroken code over 2 weight
# seeds x 2 batches (kernel_mutants.py's baseline, on the H100). Tensor:
# the four ranks' bf16 partial sums of the output projections (attention
# and SwiGLU) round to bf16 each and add in bf16, as a bf16 psum does, so
# the forward keeps 1.0877-1.0899 times as far from fp32 as the unmeshed
# plain bf16 one, the gradient 1.0919-1.0945 (wq/wk/wv at most 1.0970),
# the loss 0.28-9.31 (a scalar at bf16's floor); in fp32 the split forward
# is 1.02e-5 from the unmeshed one. So 1.15, 1.15 and 16: the mutant that
# drops a rank's partial reaches 42.7 forward, 33.1 gradient. Pipeline:
# the same math a row, 1.0038-1.0050 forward, 1.0067-1.0089 gradient,
# wq/wk/wv at most 1.0158, loss 0.54-2.67: the unmeshed bars hold (the
# mutant that skips a stage: 40.2 forward, 33.3 gradient).
_TP, _PP, _PP_MICRO = 4, 4, 4
_TP_FWD_RATIO = 1.15
_TP_TRAIN_RATIO = {"loss": 16.0, "grad": 1.15, "attn_grad": 1.15}
_PP_FWD_RATIO = _FWD_BF16_RATIO
_PP_TRAIN_RATIO = _TRAIN_BF16_RATIO
# B1 / B2 / B3 launches, each at [B*H/t = 32, 2048, 64]: a forward runs 16
# layers x 4 ranks (or x 4 microbatches: the port skips the bubble ticks),
# a remat train step that forward, its recompute, and one B2 and B3 each
_AXIS_LAUNCHES = {
    "forward": {"flash_fwd": 64, "flash_bwd_dq": 0, "flash_bwd_dkv": 0},
    "train": {"flash_fwd": 128, "flash_bwd_dq": 64, "flash_bwd_dkv": 64}}


def _emit(obj):
    print(json.dumps(obj), flush=True)


def _nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over ``iters`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _pairs(t, t_k, causal):
    """(q, k) pairs the mask keeps: top-left causal keeps min(q + 1, T_k)."""
    return sum(min(q + 1, t_k) for q in range(t)) if causal else t * t_k


def _bound(flops, nbytes, dtype_name):
    t_ops = flops / _PEAK_FLOPS[dtype_name]
    t_mem = nbytes / _HBM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, "operations" if t_ops >= t_mem else "bytes"


def _flash_bound(bh, t, t_k, d, dtype_name, causal):
    """(bound_ms, bound_by, flops, bytes) of one flash forward: QK^T and PV
    over the (q, k) pairs this mask keeps, against each input read once and
    each output written once."""
    flops = 4.0 * d * bh * _pairs(t, t_k, causal)
    elt = 2 if dtype_name == "bfloat16" else 4
    nbytes = elt * d * bh * (2 * t + 2 * t_k) + 4 * bh * t
    return (*_bound(flops, nbytes, dtype_name), flops, nbytes)


def _bwd_bounds(bh, t, t_k, d, dtype_name, causal):
    """{kernel: (bound_ms, bound_by, flops, bytes)} of B2 and B3. B2: QK^T,
    dO V^T and dS K (2 D FLOPs a kept pair each) and Delta (2 D a row);
    reads q, k, v, O, dO and LSE, writes dQ and Delta. B3: QK^T, P^T dO,
    dO V^T and dS^T Q; reads q, k, v, dO, LSE and Delta, writes dK, dV."""
    pairs = _pairs(t, t_k, causal)
    elt = 2 if dtype_name == "bfloat16" else 4
    dq_flops = 6.0 * d * bh * pairs + 2.0 * d * bh * t
    dq_bytes = elt * d * bh * (4 * t + 2 * t_k) + 8 * bh * t
    dkv_flops = 8.0 * d * bh * pairs
    dkv_bytes = elt * d * bh * (2 * t + 4 * t_k) + 8 * bh * t
    return {"flash_bwd_dq": (*_bound(dq_flops, dq_bytes, dtype_name),
                             dq_flops, dq_bytes),
            "flash_bwd_dkv": (*_bound(dkv_flops, dkv_bytes, dtype_name),
                              dkv_flops, dkv_bytes)}


def _sdpa_bwd_ms(q, k, v, do, scale, causal, iters):
    """PyTorch's fused attention backward at the same shape, timed as a
    yardstick only: the port never calls it. One call gives dQ, dK and dV."""
    import torch
    import torch.nn.functional as F

    leaves = [x[None].detach().requires_grad_(True) for x in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                         scale=scale)
    ms = _time_ms(lambda: torch.autograd.grad(out, leaves, do[None],
                                              retain_graph=True), iters)
    del out, leaves
    return ms


def phase_kernels_bwd(fa, seed: int):
    """B2 and B3 against their plain versions (check_bwd) at the training
    shape and six more (tp_shard: a tensor=4 rank's or a pipeline
    microbatch's shape); each kernel's time, its plain version's, SDPA's
    backward and the bound."""
    import torch

    cases = [
        # name, bh, t, t_k, d, dtype, causal
        ("main", 128, 2048, 2048, 64, torch.bfloat16, True),  # llama3-1b train
        ("d128", 64, 2048, 2048, 128, torch.bfloat16, True),
        ("noncausal", 96, 512, 512, 64, torch.bfloat16, False),
        ("fp32", 32, 1024, 1024, 128, torch.float32, True),
        ("ragged_t48", 128, 48, 48, 64, torch.bfloat16, True),
        ("tq_ne_tk", 32, 1000, 1536, 64, torch.bfloat16, True),
        ("tp_shard", 32, 2048, 2048, 64, torch.bfloat16, True),  # tensor=4
    ]
    g = torch.Generator(device="cuda").manual_seed(seed + 5)
    rows = []
    for name, bh, t, t_k, d, dtype, causal in cases:
        q, do = (torch.randn(bh, t, d, generator=g, device="cuda").to(dtype)
                 for _ in range(2))
        k, v = (torch.randn(bh, t_k, d, generator=g, device="cuda").to(dtype)
                for _ in range(2))
        scale = d ** -0.5
        o, lse = fa.flash_attention_fwd(q, k, v, scale=scale, causal=causal)
        dq, delta = fa.flash_bwd_dq(q, k, v, o, lse, do, scale=scale,
                                    causal=causal)
        dk, dv = fa.flash_bwd_dkv(q, k, v, lse, delta, do, scale=scale,
                                  causal=causal)
        torch.cuda.synchronize()
        check = fa.check_bwd(dq, dk, dv, q, k, v, o, lse, do, scale=scale,
                             causal=causal)
        dn = str(dtype).split(".")[-1]
        iters = 20 if t >= 512 else 100
        plain_iters = max(3, iters // 5)
        times = {
            "flash_bwd_dq": (
                _time_ms(lambda: fa.flash_bwd_dq(
                    q, k, v, o, lse, do, scale=scale, causal=causal), iters),
                _time_ms(lambda: fa.flash_bwd_dq_reference(
                    q, k, v, o, lse, do, scale=scale, causal=causal),
                    plain_iters, 1)),
            "flash_bwd_dkv": (
                _time_ms(lambda: fa.flash_bwd_dkv(
                    q, k, v, lse, delta, do, scale=scale, causal=causal),
                    iters),
                _time_ms(lambda: fa.flash_bwd_dkv_reference(
                    q, k, v, lse, delta, do, scale=scale, causal=causal),
                    plain_iters, 1)),
        }
        lib_ms = _sdpa_bwd_ms(q, k, v, do, scale, causal, iters)
        bounds = _bwd_bounds(bh, t, t_k, d, dn, causal)
        row = {"case": name, "shape": [bh, t, t_k, d], "dtype": dn,
               "causal": causal, **check,
               "library_ms_dq_dk_dv": lib_ms}
        for kern, (ms, plain_ms) in times.items():
            bound_ms, bound_by, flops, nbytes = bounds[kern]
            row[kern] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "flops": flops, "bytes": nbytes,
                         "tflops_per_s": flops / ms / 1e9}
        rows.append(row)
        del q, k, v, do, o, lse, dq, dk, dv, delta
        torch.cuda.empty_cache()
    _emit({"phase": "kernels", "kernel": "flash_bwd_dq+flash_bwd_dkv",
           "cases": rows})
    bad = [r["case"] for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"flash_bwd disagrees with its plain version: "
                             f"{bad}")
    return rows


def phase_kernels(fa, seed: int):
    """B1 against its plain version at the forward's shape and six more."""
    import torch
    import torch.nn.functional as F

    cases = [
        # name, bh, t, t_k, d, dtype, causal
        ("main", 128, 2048, 2048, 64, torch.bfloat16, True),  # llama3-1b forward
        ("d128", 64, 2048, 2048, 128, torch.bfloat16, True),
        ("noncausal", 96, 512, 512, 64, torch.bfloat16, False),  # bert-base-like
        ("fp32", 32, 1024, 1024, 128, torch.float32, True),
        ("ragged_t48", 128, 48, 48, 64, torch.bfloat16, True),
        ("tq_ne_tk", 32, 1000, 1536, 64, torch.bfloat16, True),
        # a tensor=4 rank's heads, or a pipeline microbatch: [1*32, 2048]
        ("tp_shard", 32, 2048, 2048, 64, torch.bfloat16, True),
    ]
    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for name, bh, t, t_k, d, dtype, causal in cases:
        q = torch.randn(bh, t, d, generator=g, device="cuda").to(dtype)
        k, v = (torch.randn(bh, t_k, d, generator=g, device="cuda").to(dtype)
                for _ in range(2))
        scale = d ** -0.5
        o, lse = fa.flash_attention_fwd(q, k, v, scale=scale, causal=causal)
        check = fa.check_fwd(o, lse, q, k, v, scale=scale, causal=causal)
        dn = str(dtype).split(".")[-1]
        iters = 20 if t >= 512 else 100
        ms = _time_ms(lambda: fa.flash_attention_fwd(
            q, k, v, scale=scale, causal=causal), iters)
        plain_ms = _time_ms(lambda: fa.flash_attention_fwd_reference(
            q, k, v, scale=scale, causal=causal), max(3, iters // 5), 1)
        # measurement only: the port never calls PyTorch's fused attention
        q4, k4, v4 = q[None], k[None], v[None]  # [1, BH, T, D]: SDPA's layout
        lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal, scale=scale), iters)
        bound_ms, bound_by, flops, nbytes = _flash_bound(
            bh, t, t_k, d, dn, causal)
        row = {"case": name, "shape": [bh, t, t_k, d], "dtype": dn,
               "causal": causal, **check, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
               "bytes": nbytes, "tflops_per_s": flops / ms / 1e9}
        rows.append(row)
        del q, k, v, q4, k4, v4, o, lse
        torch.cuda.empty_cache()
    _emit({"phase": "kernels", "kernel": "flash_fwd", "cases": rows})
    bad = [r["case"] for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"flash_fwd disagrees with its plain version: "
                             f"{bad}")
    return rows


def _ring_blocks(causal: bool) -> int:
    return _RING_P * (_RING_P + 1) // 2 if causal else _RING_P * _RING_P


def _chunks(x, n: int):
    return [c.contiguous() for c in x.chunk(n, dim=1)]


def _finite(x) -> bool:
    import torch

    return bool(torch.isfinite(x.float()).all())


def check_ring_fwd(o, lse, o_w, lse_w, q, k, v, *, scale: float,
                   causal: bool) -> dict:
    """The ring's (O, LSE) against B1's over the whole sequence (O_w,
    LSE_w), [B*H, T, D] and [B*H, 1, T].

    With u = 2^-8 and O the exact output: B1 over the whole sequence is
    within u|O| (its output's rounding) + u (P|V|) (P rounded to bf16) of
    O, as check_fwd bounds it. The ring rounds each block's P and each
    block's output O_b to bf16 before the fp32 merge; the merge weights
    e^(lse_b - lse) are a convex combination and |O_b| <= P_b|V|, so the
    blocks' roundings add up to at most u (P|V|) each, and the merged O is
    within u|O| + 2u (P|V|). Between the two:
        |O_ring - O_w| <= 2u|O| + 3u (P|V|),
    checked as 1.05 (2u|O_w| + 3u (P|V|)) + 1e-6 per element (P|V|: the
    plain version on |V|, fp32), ||O_ring - O_w|| / ||O_w|| <= 2e-2, and
    LSE (fp32 on both sides) within 2e-4 + 2e-4 |lse|."""
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    u = 2.0 ** -8
    bh, t, _ = q.shape
    step = max(1, (1 << 26) // (t * t))
    excess = d_max = d2 = r2 = 0.0
    for i in range(0, bh, step):
        sl = slice(i, i + step)
        pv_abs, _ = fa.flash_attention_fwd_reference(
            q[sl].float(), k[sl].float(), v[sl].float().abs(), scale=scale,
            causal=causal)
        ref, d = o_w[sl].float(), o[sl].float() - o_w[sl].float()
        tol = 1.05 * (2 * u * ref.abs() + 3 * u * pv_abs) + 1e-6
        excess = max(excess, (d.abs() / tol).max().item())
        d_max = max(d_max, d.abs().max().item())
        d2 += d.double().pow(2).sum().item()
        r2 += ref.double().pow(2).sum().item()
    rel = (d2 / r2) ** 0.5
    d_lse = (lse - lse_w).abs()
    lse_ok = bool((d_lse <= 2e-4 + 2e-4 * lse_w.abs()).all())
    finite = bool(_finite(o) and _finite(lse))
    return {"o_max_abs_err": d_max, "o_err_over_tol": excess,
            "o_tol": f"1.05*(2u|O_w| + 3u*(P|V|)) + 1e-6, u={u}",
            "o_rel_norm_err": rel, "o_rel_norm_tol": _RING_REL_NORM_TOL,
            "lse_max_abs_err": d_lse.max().item(),
            "lse_tol": "2e-4 + 2e-4*|lse|",
            "ok": (finite and excess <= 1.0 and lse_ok
                   and rel <= _RING_REL_NORM_TOL)}


def check_ring_bwd(grads, grads_w, q, k, v, o_w, lse, lse_w, do, *,
                   scale: float, causal: bool) -> dict:
    """The ring's (dQ, dK, dV) against B2/B3 over the whole sequence
    (``grads_w``, from B1's whole-sequence O_w and LSE_w); ``lse`` is the
    ring's merged LSE.

    check_bwd bounds one kernel's dQ against the exact one by u|dQ| +
    scale (u|dS| + w M)|K| (dS and P rounded to bf16 as operands, fp32 sums
    in another order; u = 2^-8, w = 2^-14, M and A as in check_bwd). The
    ring adds, over its blocks, one more rounding of each block's dQ, dK or
    dV partial to bf16 before the fp32 sums: at most u scale |dS||K| for
    dQ (|dQ_b| <= scale |dS_b||K_b|), u scale |dS|^T|Q| for dK, u P^T|dO|
    for dV. The two sides also start from different O and LSE: B2's Delta =
    rowsum(dO O) moves by at most 5u R (R = rowsum(P o |dO||V|^T), from
    the forward's |O_ring - O_w| <= 5u (P|V|)), which moves dS by P 5u R;
    an LSE apart by e moves P, and so dS and dV, by a factor e. So
        |dQ - dQ_w| <= 2u|dQ_w| + scale E |K|,
        |dK - dK_w| <= 2u|dK_w| + scale E^T |Q|,
        |dV - dV_w| <= 2u|dV_w| + ((3u + e) P + 2w P A)^T |dO|,
        E = (3u + e)|dS| + 2w M + 5u P R,
    each times 1.05, + 1e-6, with e the per-row |lse - lse_w|; and each
    output within 2e-2 of the whole-sequence one as a whole."""
    u, w = 2.0 ** -8, 2.0 ** -14
    bh, t, _ = q.shape
    step = max(1, (1 << 26) // (t * t))
    names = ("dq", "dk", "dv")
    stats = {n: {"max": 0.0, "excess": 0.0, "d2": 0.0, "r2": 0.0}
             for n in names}
    finite = all(_finite(g) for g in grads)
    import torch

    for i in range(0, bh, step):
        sl = slice(i, i + step)
        qs, ks, vs, os_, dos = (x[sl].float() for x in (q, k, v, o_w, do))
        s = torch.matmul(qs, ks.transpose(1, 2)) * scale
        if causal:
            keep = (torch.arange(t, device=q.device)[:, None]
                    >= torch.arange(t, device=q.device)[None, :])
            s = torch.where(keep, s, torch.full_like(s, -1e30))
        p = torch.exp(s - lse_w[sl].float()[:, 0, :, None])
        del s
        delta = (dos * os_).sum(dim=-1)[:, :, None]
        dp = torch.matmul(dos, vs.transpose(1, 2))
        ds = p * (dp - delta)
        dov = torch.matmul(dos.abs(), vs.abs().transpose(1, 2))
        a = scale * torch.matmul(qs.abs(), ks.abs().transpose(1, 2))
        m = p * (dov + delta.abs() + a * (dp - delta).abs())
        r = (p * dov).sum(dim=-1, keepdim=True)
        e_lse = (lse[sl] - lse_w[sl]).abs()[:, 0, :, None]
        big_e = (3 * u + e_lse) * ds.abs() + 2 * w * m + 5 * u * p * r
        del dp, ds, dov, m
        comp = {"dq": scale * torch.matmul(big_e, ks.abs()),
                "dk": scale * torch.matmul(big_e.transpose(1, 2), qs.abs()),
                "dv": torch.matmul(((3 * u + e_lse) * p + 2 * w * p * a)
                                   .transpose(1, 2), dos.abs())}
        del big_e, p, a
        for name, got, ref in zip(names, grads, grads_w):
            got, ref = got[sl].float(), ref[sl].float()
            d = got - ref
            tol = 1.05 * (2 * u * ref.abs() + comp[name]) + 1e-6
            st = stats[name]
            st["max"] = max(st["max"], d.abs().max().item())
            st["excess"] = max(st["excess"], (d.abs() / tol).max().item())
            st["d2"] += d.double().pow(2).sum().item()
            st["r2"] += ref.double().pow(2).sum().item()
    out, ok = {"finite": finite}, finite
    for name, st in stats.items():
        rel = (st["d2"] ** 0.5) / max(st["r2"] ** 0.5, 1e-30)
        out.update({f"{name}_max_abs_err": st["max"],
                    f"{name}_err_over_tol": st["excess"],
                    f"{name}_rel_norm_err": rel})
        ok = ok and st["excess"] <= 1.0 and rel <= _RING_REL_NORM_TOL
    out.update({"tol": "1.05*(2u|ref| + companion) + 1e-6, E = (3u + e)|dS|"
                       f" + 2wM + 5u P R, u={u}, w={w}",
                "rel_norm_tol": _RING_REL_NORM_TOL, "ok": ok})
    return out


def ring_check(fa, R, case, seed: int, timed: bool = True) -> dict:
    """One ring case: the ring's forward and backward for _RING_P virtual
    ranks (launches counted around each), B1 and B2/B3 over the whole
    sequence on the same inputs, check_ring_fwd and check_ring_bwd, and
    (``timed``) both sides' times beside the whole-sequence bounds."""
    import torch

    name, b, t, h, d, causal = case
    bh, n = b * h, _RING_P
    g = torch.Generator(device="cuda").manual_seed(seed + 31)
    q, k, v, do = (torch.randn(bh, t, d, generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    scale = d ** -0.5
    qs, ks, vs, dos = (_chunks(x, n) for x in (q, k, v, do))

    def ring_fwd():
        return R.ring_forward_virtual(qs, ks, vs, scale=scale, causal=causal)

    _zero_counts(fa)
    os_, lses = ring_fwd()
    torch.cuda.synchronize()
    fwd_launches = _counts(fa)

    def ring_bwd():
        return R.ring_backward_virtual(qs, ks, vs, os_, lses, dos,
                                       scale=scale, causal=causal)

    _zero_counts(fa)
    grads = ring_bwd()
    torch.cuda.synchronize()
    bwd_launches = _counts(fa)
    o, lse = torch.cat(os_, 1), torch.cat(lses, 2)
    grads = [torch.cat(x, 1) for x in grads]
    # the whole sequence through the same kernels (not counted)
    o_w, lse_w = fa.flash_attention_fwd(q, k, v, scale=scale, causal=causal)
    grads_w = fa.flash_attention_bwd(q, k, v, o_w, lse_w, do, scale=scale,
                                     causal=causal)
    torch.cuda.synchronize()
    fwd = check_ring_fwd(o, lse, o_w, lse_w, q, k, v, scale=scale,
                         causal=causal)
    bwd = check_ring_bwd(grads, grads_w, q, k, v, o_w, lse, lse_w, do,
                         scale=scale, causal=causal)
    want = _ring_blocks(causal)
    launches_ok = (fwd_launches == {"flash_fwd": want, "flash_bwd_dq": 0,
                                    "flash_bwd_dkv": 0}
                   and bwd_launches == {"flash_fwd": 0, "flash_bwd_dq": want,
                                        "flash_bwd_dkv": want})
    row = {"case": name, "shape_bthd": [b, t, h, d], "dtype": "bfloat16",
           "causal": causal, "virtual_ranks": n, "block_t": t // n,
           "fwd": fwd, "bwd": bwd, "fwd_launches": fwd_launches,
           "bwd_launches": bwd_launches, "launches_want": want,
           "ok": fwd["ok"] and bwd["ok"] and launches_ok}
    if timed:
        iters = 10
        fb_ms, fb_by, _, _ = _flash_bound(bh, t, t, d, "bfloat16", causal)
        bb = _bwd_bounds(bh, t, t, d, "bfloat16", causal)
        row.update({
            "ring_fwd_ms": _time_ms(ring_fwd, iters),
            "whole_fwd_ms": _time_ms(lambda: fa.flash_attention_fwd(
                q, k, v, scale=scale, causal=causal), iters),
            "ring_bwd_ms": _time_ms(ring_bwd, iters),
            "whole_bwd_ms": _time_ms(lambda: fa.flash_attention_bwd(
                q, k, v, o_w, lse_w, do, scale=scale, causal=causal), iters),
            "fwd_bound_ms": fb_ms, "fwd_bound_by": fb_by,
            "bwd_bound_ms": sum(x[0] for x in bb.values()),
            "bwd_bound_by": "+".join(x[1] for x in bb.values())})
    return row


def phase_ring(fa, R, seed: int):
    """ring_check on each of _RING_CASES; -> the main case's launches."""
    import torch

    rows = []
    for case in _RING_CASES:
        rows.append(ring_check(fa, R, case, seed))
        _emit({"phase": "ring", **rows[-1]})
        torch.cuda.empty_cache()
    bad = [r["case"] for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"ring attention disagrees with the whole-"
                             f"sequence kernels: {bad}")
    main = rows[0]
    return {"ring_forward": main["fwd_launches"]["flash_fwd"],
            "ring_backward": main["bwd_launches"]["flash_bwd_dq"],
            "ring_backward_dkv": main["bwd_launches"]["flash_bwd_dkv"]}


def _rel(x, ref) -> float:
    return ((x - ref).norm() / ref.norm()).item()


def forward_parity(T, cfg, params, p32, tokens,
                   ratio_tol: float = _FWD_BF16_RATIO,
                   rel_tol: float = _FWD_REL_TOL, mesh=None) -> dict:
    """The forward through the kernel (``cfg``) held against plain
    attention two ways:
      - fp32: the same forward in fp32 through the kernel against fp32
        plain attention, within ``rel_tol``;
      - bf16: both bf16 forwards against the fp32 one; the kernel's forward
        may be at most ``ratio_tol`` times as far from it as the
        plain-attention forward is.
    ``p32`` may be the bf16 params themselves: the fp32 configs cast every
    weight to fp32 where it is used, and bf16 values are exact in fp32.
    A direct bf16-vs-bf16 bound cannot hold: this random-weight model is
    chaotic in bf16. Measured on the H100 with P.V made exact to fp32 in
    the kernel, the two bf16 forwards still differed by 2.5%, while each
    kept 3.05% from the fp32 forward (printed as rel_bf16_*). With a
    ``mesh`` (a VirtualMesh) both kernel forwards run on it; the plain and
    the fp32 truth stay unmeshed.
    -> the distances, their ratio, the logits' shape, "finite" and "ok"."""
    import torch

    logits = T.forward(params, tokens, cfg, mesh)
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(logits).all())
    plain_cfg = dataclasses.replace(cfg, attention_impl="xla")
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                param_dtype=torch.float32)
    plain32_cfg = dataclasses.replace(cfg32, attention_impl="xla")
    ref = T.forward(params, tokens, plain_cfg)
    truth = T.forward(p32, tokens, plain32_cfg)
    rel_bf16 = {"kernel_vs_fp32": _rel(logits, truth),
                "plain_vs_fp32": _rel(ref, truth),
                "kernel_vs_plain": _rel(logits, ref)}
    shape = list(logits.shape)
    del ref, logits
    rel_fp32 = _rel(T.forward(p32, tokens, cfg32, mesh), truth)
    del truth
    ratio = rel_bf16["kernel_vs_fp32"] / rel_bf16["plain_vs_fp32"]
    return {"logits_shape": shape, "finite": finite,
            "rel_fp32_kernel_vs_plain": rel_fp32, "rel_tol": rel_tol,
            **{f"rel_bf16_{k}": v for k, v in rel_bf16.items()},
            "bf16_kernel_over_plain": ratio,
            "bf16_ratio_tol": ratio_tol,
            "ok": (finite and rel_fp32 <= rel_tol
                   and ratio <= ratio_tol)}


def forward_tokens(cfg, seed: int):
    """The forward phase's [4, 2048] random tokens on the card."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    return torch.randint(0, cfg.vocab_size, (4, 2048), generator=g,
                         device="cuda", dtype=torch.int32)


def phase_forward(fa, T, cfg, params, p32, seed: int):
    """The main path: forward at [4, 2048] in bf16 through the kernel, its
    launches counted in that one call, then held against plain attention
    (forward_parity) and timed."""
    import torch

    tokens = forward_tokens(cfg, seed)
    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0
    T.forward(params, tokens, cfg)
    torch.cuda.synchronize()
    launches = fa.launches
    peak = torch.cuda.max_memory_allocated()
    if launches != cfg.n_layers:
        raise AssertionError(f"forward launched flash_fwd {launches} times, "
                             f"want {cfg.n_layers} (one per layer)")
    parity = forward_parity(T, cfg, params, p32, tokens)
    plain_cfg = dataclasses.replace(cfg, attention_impl="xla")
    ms = _time_ms(lambda: T.forward(params, tokens, cfg), 3, 1)
    plain_ms = _time_ms(lambda: T.forward(params, tokens, plain_cfg), 3, 1)
    _emit({"phase": "forward", "tokens": [4, 2048], "dtype": "bfloat16",
           "attention_impl": "auto", "flash_launches": launches, **parity,
           "ms": ms, "plain_attention_ms": plain_ms,
           "tokens_per_s": 4 * 2048 / ms * 1e3,
           "peak_mem_gib": peak / 2**30})
    if not parity["ok"]:
        raise AssertionError("forward through the kernel disagrees with "
                             "plain attention")
    return launches


def phase_engine_fp32(E, G, cfg, p32, seed: int):
    """The fp32 engine token for token against the port's generate()."""
    import torch

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                param_dtype=torch.float32)
    rng = random.Random(seed)
    prompts = [[rng.randint(1, cfg.vocab_size - 1) for _ in range(n)]
               for n in (5, 17, 40, 64)]
    want = [G.generate(p32, torch.tensor([p], device="cuda"), cfg32,
                       max_new_tokens=32)[0, len(p):].tolist()
            for p in prompts]
    eng = E.InferenceEngine(p32, cfg32, slots=8, max_prompt_len=64,
                            max_new_tokens=32, greedy=True, seed=seed)
    t0 = time.perf_counter()
    reqs = [eng.submit(p) for p in prompts]
    for _ in range(1000):
        if all(r.done.is_set() for r in reqs):
            break
        eng.step()
    wall = time.perf_counter() - t0
    got = [list(r.tokens) for r in reqs]
    match = [a == b for a, b in zip(got, want)]
    _emit({"phase": "engine", "dtype": "float32", "tf32": False,
           "prompt_lens": [len(p) for p in prompts], "max_new_tokens": 32,
           "match_generate": match, "wall_s": wall,
           "first_mismatch": next(
               ([i, [j for j, (x, y) in enumerate(zip(a, b)) if x != y][:1]]
                for i, (a, b) in enumerate(zip(got, want)) if a != b), None)})
    if not all(match):
        raise AssertionError("fp32 engine tokens differ from generate()")


def _workload(rng_seed: int, max_prompt: int, max_new: int):
    """bench_serve.py's request stream: (prompt, max_new). 80% short answers
    (U[max/16, max/4]) and 20% long generations (U[max/2, max])."""
    rng = random.Random(rng_seed)

    def next_request():
        plen = rng.randint(max(4, max_prompt // 8), max_prompt)
        if rng.random() < 0.8:
            want = rng.randint(max(2, max_new // 16), max(4, max_new // 4))
        else:
            want = rng.randint(max_new // 2, max_new)
        return [rng.randint(1, 200) for _ in range(plen)], want
    return next_request


def _pct(xs, p):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(p / 100 * len(xs)))]


def _decode_chunk_profile(E, eng, cfg, steps: int):
    """Host wall and device busy time of one full-width decode chunk: the
    wall without the profiler, the device time (sum of kernel times) from
    torch.profiler; "not measured" if the profiler sees no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    active = torch.ones(eng.slots, dtype=torch.bool, device="cuda")

    def chunk():
        E.decode_slots(eng.params, eng.cache, eng._next_tok_dev, active,
                       eng._rng, cfg, True, 1.0, -1, steps=steps)
        torch.cuda.synchronize()

    chunk()
    t0 = time.perf_counter()
    chunk()
    wall = time.perf_counter() - t0
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            chunk()
        dev_us = sum(e.device_time_total for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA)
    except Exception:  # the profiler is a probe here, not a phase
        traceback.print_exc()
        dev_us = 0
    eng.cache["pos"].zero_()
    return {"steps": steps, "host_ms_per_step": wall / steps * 1e3,
            "device_ms_per_step": (dev_us / steps / 1e3 if dev_us
                                   else "not measured"),
            "device_busy_share": (dev_us / 1e6 / wall if dev_us
                                  else "not measured")}


def phase_serving(E, cfg, params, seed: int, name: str = "serving"):
    """bf16 engine at bench_serve.py's settings, 8 clients x 4 requests."""
    import torch

    clients, per_client, max_new = 8, 4, 64
    eng = E.InferenceEngine(params, cfg, slots=8, max_prompt_len=64,
                            max_new_tokens=max_new, decode_chunk=16,
                            fetch_every=4, max_inflight=6, seed=seed)
    eng.warmup()
    torch.cuda.reset_peak_memory_stats()
    eng.serve_forever()
    results, errors, lock = [], [], threading.Lock()

    def client(cid):
        nxt = _workload(seed + 17 + cid, 64, max_new)
        try:
            for _ in range(per_client):
                prompt, want = nxt()
                t0 = time.perf_counter()
                ttft, toks = None, []
                for tok in eng.submit_stream(prompt, want):
                    if ttft is None:
                        ttft = time.perf_counter() - t0
                    toks.append(tok)
                with lock:
                    results.append((want, toks, ttft,
                                    time.perf_counter() - t0))
        except BaseException as e:  # reported below, fails the phase
            with lock:
                errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(clients)]
    t0 = time.perf_counter()
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        hung = sum(t.is_alive() for t in threads)
    finally:
        eng.shutdown()
    n_tok = sum(len(r[1]) for r in results)
    bad_len = sum(len(toks) != want for want, toks, _, _ in results)
    bad_vocab = sum(any(not 0 <= x < cfg.vocab_size for x in toks)
                    for _, toks, _, _ in results)
    lat = [r[3] for r in results]
    ttft = [r[2] for r in results if r[2] is not None]
    _emit({"phase": name, "dtype": "bfloat16", "n_layers": cfg.n_layers,
           "moe_experts": cfg.moe_experts, "clients": clients,
           "requests": len(results), "want_requests": clients * per_client,
           "errors": errors, "hung_clients": hung,
           "wrong_length": bad_len, "out_of_vocab": bad_vocab,
           "generated_tokens": n_tok, "wall_s": wall,
           "tokens_per_s": n_tok / wall,
           "latency_p50_s": _pct(lat, 50) if lat else None,
           "latency_p95_s": _pct(lat, 95) if lat else None,
           "ttft_p50_s": _pct(ttft, 50) if ttft else None,
           "ttft_p95_s": _pct(ttft, 95) if ttft else None,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "engine_stats": eng.stats,
           "decode_chunk": _decode_chunk_profile(E, eng, cfg, 16)})
    if errors or hung or bad_len or bad_vocab or \
            len(results) != clients * per_client:
        raise AssertionError(f"{name} phase failed")



def moe_config(C, n_layers: int = 16, **kw):
    """llama3-1b at full width with _MOE's experts, bf16 params."""
    import torch

    return C.get_config("llama3-1b", param_dtype=torch.bfloat16,
                        n_layers=n_layers, **_MOE, **kw)


def moe_train_config(C):
    """moe_train's cell: _MOE_TRAIN_LAYERS layers, T = 2048, remat
    "nothing", as train_config."""
    return moe_config(C, _MOE_TRAIN_LAYERS, max_seq_len=2048, remat=True,
                      remat_policy="nothing")


def _moe_abs_path(M, h, lp, cfg):
    """A [B, T, d] fp32: over each token's kept slots, p * (|act| @
    |W_down|) of its expert, where act is the expert's SwiGLU of the token:
    the size moe_layer's per-element bound follows. Expert by expert,
    from the routing moe_ffn uses."""
    import torch

    B, t, d = h.shape
    k = cfg.moe_top_k
    top_p, top_i = M.top_k(M.router_probs(h, lp["router"]), k)
    _, kept = M.assign_slots(top_i, cfg.moe_experts, M.capacity(t, cfg))
    rows = h[:, :, None, :].expand(B, t, k, d).reshape(-1, d)
    ids, p, kept = top_i.reshape(-1), top_p.reshape(-1), kept.reshape(-1)
    out = torch.zeros(B * t * k, d, device=h.device)
    for e in range(cfg.moe_experts):
        sel = (ids == e) & kept
        x = rows[sel]
        act = M._silu(x @ lp["w_gate"][e]) * (x @ lp["w_up"][e])
        out[sel] = p[sel, None] * (act.abs().float()
                                   @ lp["w_down"][e].abs().float())
    return out.reshape(B, t, k, d).sum(dim=2)


def phase_moe_layer(M, cfg, params, seed: int):
    """One MoE layer (layer 0 of ``params``) at [4, 2048] bf16: moe_ffn
    against moe_ffn_dense on the same h, at ``cfg``'s capacity factor and at
    _MOE_LAYER_DROP_CF. In each case expert ids and kept slots must be
    equal exactly, the output within 1.05 (2u|y| + 6u A) + 1e-6 per element
    (_MOE_LAYER_UNIT; A from _moe_abs_path) and 1e-2 as a whole; the second
    case must drop slots. Both forms timed (CUDA events) beside the layer's
    bound: the three products over the kept slots at 989 TFLOP/s against
    the expert weights', h's and y's bytes at 3.35 TB/s. The bmm also
    multiplies the empty places of its E*B*C rows ("bmm_flops")."""
    import torch

    lp = {k: params["layers"][k][0] for k in ("router", "w_gate", "w_up",
                                              "w_down")}
    g = torch.Generator(device="cuda").manual_seed(seed + 11)
    B, t, d = 4, 2048, cfg.d_model
    h = torch.randn(B, t, d, generator=g, device="cuda").to(cfg.dtype)
    E, k, u = cfg.moe_experts, cfg.moe_top_k, _MOE_LAYER_UNIT
    nbytes = (3.0 * E * d * cfg.d_ff + 2.0 * B * t * d) * h.element_size()
    ok = True
    for cf in (cfg.moe_capacity_factor, _MOE_LAYER_DROP_CF):
        c = dataclasses.replace(cfg, moe_capacity_factor=cf)
        C = M.capacity(t, c)
        with torch.no_grad():
            y, aux = M.moe_ffn(h, lp, c)
            top_p, top_i = M.top_k(M.router_probs(h, lp["router"]), k)
            _, kept = M.assign_slots(top_i, E, C)
            y_d, aux_d, top_i_d, kept_d = M.moe_ffn_dense(h, lp, c)
            torch.cuda.synchronize()
            same_ids = torch.equal(top_i, top_i_d)
            same_kept = torch.equal(kept, kept_d)
            tol = 1.05 * (2 * u * y_d.float().abs()
                          + 6 * u * _moe_abs_path(M, h, lp, c)) + 1e-6
            dy = (y.float() - y_d.float())
            err_over_tol = (dy.abs() / tol).max().item()
            rel = (dy.norm() / y_d.float().norm()).item()
            finite = bool(torch.isfinite(y.float()).all())
            ms = _time_ms(lambda: M.moe_ffn(h, lp, c), 10)
            dense_ms = _time_ms(lambda: M.moe_ffn_dense(h, lp, c), 5)
        kept_rows = int(kept.sum().item())
        dropped = 1 - kept_rows / kept.numel()
        flops = 6.0 * d * cfg.d_ff * kept_rows
        bmm_flops = 6.0 * d * cfg.d_ff * E * B * C
        bound_ms, bound_by = _bound(flops, nbytes, "bfloat16")
        case_ok = (finite and same_ids and same_kept and err_over_tol <= 1.0
                   and rel <= _MOE_LAYER_REL_TOL
                   and (cf == cfg.moe_capacity_factor or dropped > 0))
        _emit({"phase": "moe_layer", "shape": [B, t, d], "dtype": "bfloat16",
               **_MOE, "moe_capacity_factor": cf, "capacity": C,
               "same_expert_ids": same_ids, "same_kept": same_kept,
               "kept_rows": kept_rows, "dropped_share": dropped,
               "max_abs_err": dy.abs().max().item(),
               "err_over_tol": err_over_tol,
               "tol": f"1.05*(2u|y| + 6u*sum_k p|act|@|W_down|) + 1e-6, "
                      f"u={u}",
               "rel_norm_err": rel, "rel_norm_tol": _MOE_LAYER_REL_TOL,
               "aux": aux.item(), "aux_dense": aux_d.item(),
               "ms": ms, "dense_ms": dense_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "flops": flops, "bytes": nbytes,
               "ops_ms": flops / _PEAK_FLOPS["bfloat16"] * 1e3,
               "bytes_ms": nbytes / _HBM_BYTES_PER_S * 1e3,
               "bmm_flops": bmm_flops,
               "tflops_per_s": flops / ms / 1e9, "ok": case_ok})
        ok = ok and case_ok
    if not ok:
        raise AssertionError("moe_ffn disagrees with moe_ffn_dense")


@contextlib.contextmanager
def _routing_recorder(M):
    """Collects the expert ids [B, T, k] of every moe.top_k call while
    active (a measurement wrapper; the model is unchanged)."""
    seen, top_k = [], M.top_k

    def record(probs, k):
        p, i = top_k(probs, k)
        seen.append(i)
        return p, i

    M.top_k = record
    try:
        yield seen
    finally:
        M.top_k = top_k


def moe_forward_tokens(cfg, seed: int):
    """moe_forward's [4, 2048] random tokens on the card."""
    return forward_tokens(cfg, seed + 20)


def moe_forward_parity(T, M, cfg, params, tokens) -> dict:
    """forward_parity of the MoE model within _MOE_FWD_BF16_RATIO and
    _MOE_FWD_FP32_REL_TOL, with the token-layers whose expert set differs
    from the fp32 forward's in each bf16 forward and in the fp32 forward
    through B1."""
    with _routing_recorder(M) as seen:
        par = forward_parity(T, cfg, params, params, tokens,
                             _MOE_FWD_BF16_RATIO, _MOE_FWD_FP32_REL_TOL)
    L = cfg.n_layers
    # forward_parity's order: bf16 B1, bf16 plain, fp32 plain, fp32 B1
    sets = [[i.sort(dim=-1).values for i in seen[j * L:(j + 1) * L]]
            for j in range(4)]

    def differ(j):
        return sum(int((a != b).any(dim=-1).sum().item())
                   for a, b in zip(sets[j], sets[2]))

    par["routed_differently_vs_fp32"] = {
        "bf16_kernel": differ(0), "bf16_plain": differ(1),
        "fp32_kernel": differ(3), "of_token_layers": L * tokens.numel()}
    return par


def phase_moe_forward(fa, T, M, cfg, params, seed: int):
    """The 16-layer MoE forward at [4, 2048] bf16 through B1 (16 launches
    counted in that one call), moe_forward_parity, ms (kernel and plain
    attention) and peak memory."""
    import torch

    tokens = moe_forward_tokens(cfg, seed)
    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0
    with torch.no_grad():
        logits = T.forward(params, tokens, cfg)
    torch.cuda.synchronize()
    launches = fa.launches
    peak = torch.cuda.max_memory_allocated()
    shape_ok = list(logits.shape) == [4, 2048, cfg.vocab_size]
    del logits
    if launches != cfg.n_layers:
        raise AssertionError(f"the MoE forward launched flash_fwd {launches}"
                             f" times, want {cfg.n_layers}")
    parity = moe_forward_parity(T, M, cfg, params, tokens)
    plain_cfg = dataclasses.replace(cfg, attention_impl="xla")
    ms = _time_ms(lambda: T.forward(params, tokens, cfg), 3, 1)
    plain_ms = _time_ms(lambda: T.forward(params, tokens, plain_cfg), 3, 1)
    _emit({"phase": "moe_forward", "tokens": [4, 2048], "dtype": "bfloat16",
           **_MOE, "n_layers": cfg.n_layers, "flash_launches": launches,
           **parity, "ms": ms, "plain_attention_ms": plain_ms,
           "tokens_per_s": 4 * 2048 / ms * 1e3, "peak_mem_gib": peak / 2**30})
    if not (parity["ok"] and shape_ok):
        raise AssertionError("the MoE forward through the kernel disagrees "
                             "with plain attention")
    return launches


def phase_moe_engine(E, G, cfg, params, seed: int):
    """The MoE model in fp32 (no TF32): the engine token for token against
    generate(). Every prompt is max_prompt_len (64) long, so no row carries
    pads: the reference's moe_ffn has no pad mask and pads would claim
    expert capacity in the engine's prefill and not in generate()'s (the
    CPU tests hold mixed lengths against the JAX engine instead)."""
    import torch

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                param_dtype=torch.float32)
    p32 = {"embed": params["embed"].float(),
           "final_norm": params["final_norm"].float(),
           "layers": {k: w.float() for k, w in params["layers"].items()}}
    rng = random.Random(seed + 7)
    prompts = [[rng.randint(1, cfg.vocab_size - 1) for _ in range(64)]
               for _ in range(4)]
    want = [G.generate(p32, torch.tensor([p], device="cuda"), cfg32,
                       max_new_tokens=32)[0, 64:].tolist() for p in prompts]
    eng = E.InferenceEngine(p32, cfg32, slots=8, max_prompt_len=64,
                            max_new_tokens=32, greedy=True, seed=seed)
    t0 = time.perf_counter()
    reqs = [eng.submit(p) for p in prompts]
    for _ in range(1000):
        if all(r.done.is_set() for r in reqs):
            break
        eng.step()
    wall = time.perf_counter() - t0
    got = [list(r.tokens) for r in reqs]
    match = [a == b for a, b in zip(got, want)]
    _emit({"phase": "moe_engine", "dtype": "float32", "tf32": False, **_MOE,
           "n_layers": cfg.n_layers, "prompt_lens": [64] * len(prompts),
           "max_new_tokens": 32, "match_generate": match, "wall_s": wall})
    if not all(match):
        raise AssertionError("fp32 MoE engine tokens differ from generate()")


def phase_entry():
    """ray_tpu_torch.entry.entry() on the card: the GPT-2-small forward at
    [4, 512], finite fp32 logits of shape [4, 512, vocab]."""
    import torch

    from ray_tpu_torch.entry import entry

    fn, args = entry()
    with torch.no_grad():
        logits = fn(*args)
    torch.cuda.synchronize()
    ok = (list(logits.shape) == [4, 512, 50304]
          and logits.dtype == torch.float32
          and bool(torch.isfinite(logits).all()))
    _emit({"phase": "entry", "config": "gpt2-small", "tokens": [4, 512],
           "logits_shape": list(logits.shape), "ok": ok})
    if not ok:
        raise AssertionError("entry()'s forward is wrong")


def _grads(T, TR, params, batch, cfg, mesh=None):
    """(loss, grads) of one step's loss_fn, leaves in tree order; on a
    DeviceMesh (DTensor params) the grads' local shards."""
    import torch

    leaves = TR.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, _ = T.loss_fn(params, batch, cfg, mesh)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    # a DeviceMesh gives DTensor grads, a VirtualMesh plain ones
    grads = [g.to_local() if hasattr(g, "to_local") else g for g in grads]
    return loss.detach(), grads


def _tree_rel(xs, refs) -> float:
    """||x - ref|| / ||ref|| over all leaves, flattened, in fp64 sums."""
    num = den = 0.0
    for x, r in zip(xs, refs):
        r = r.float()
        num += (x.float() - r).double().pow(2).sum().item()
        den += r.double().pow(2).sum().item()
    return (num / den) ** 0.5


def _leaf_names(tree, prefix=""):
    """Dotted names of a tree's leaves, in TR.tree_leaves order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}{k}.")]
    return [prefix[:-1]]


def train_config(C):
    """bench.py's llama3-1b training cell: bf16 params, T = 2048, remat
    with policy "nothing"."""
    import torch

    return C.get_config("llama3-1b", param_dtype=torch.bfloat16,
                        max_seq_len=2048, remat=True, remat_policy="nothing")


def train_batch(cfg, seed: int):
    """One random batch of 4 x 2048 tokens on the card, from ``seed``."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (4, 2049), generator=g,
                         device="cuda", dtype=torch.int32)
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}


def train_parity(T, TR, cfg, params, batch, mesh=None,
                 ratio_tol=None) -> dict:
    """One step's loss and gradients three ways on identical weights and
    batch: bf16 through the kernels (``cfg``), bf16 through plain attention,
    and fp32 with plain attention as the truth (the caller turns TF32 off).
    -> each bf16 step's relative distance from the fp32 step for the loss,
    the flattened gradient of all leaves, and each leaf of _ATTN_GRAD_LEAVES;
    the kernel step's distance over the plain step's ("kernel_over_plain":
    loss, grad, and attn_grad, the largest of the leaves'); the three
    losses; and "ok", whether every ratio is within ``ratio_tol`` (default
    _TRAIN_BF16_RATIO). With a ``mesh`` (a VirtualMesh) the kernel step
    runs on it; the plain and the fp32 steps stay unmeshed."""
    import torch

    ratio_tol = ratio_tol or _TRAIN_BF16_RATIO
    names = _leaf_names(params)
    attn = [names.index(n) for n in _ATTN_GRAD_LEAVES]
    plain_cfg = dataclasses.replace(cfg, attention_impl="xla")
    cfg32 = dataclasses.replace(plain_cfg, dtype=torch.float32,
                                param_dtype=torch.float32)
    loss_k, grads_k = _grads(T, TR, params, batch, cfg, mesh)
    loss_p, grads_p = _grads(T, TR, params, batch, plain_cfg)
    p32 = TR.tree_map(lambda w: w.float(), params)
    loss_32, grads_32 = _grads(T, TR, p32, batch, cfg32)
    del p32
    losses = {"fp32": loss_32.item(), "bf16_kernel": loss_k.item(),
              "bf16_plain": loss_p.item()}
    rel = {"loss_kernel": abs(losses["bf16_kernel"] - losses["fp32"])
           / abs(losses["fp32"]),
           "loss_plain": abs(losses["bf16_plain"] - losses["fp32"])
           / abs(losses["fp32"]),
           "grad_kernel": _tree_rel(grads_k, grads_32),
           "grad_plain": _tree_rel(grads_p, grads_32),
           "grad_kernel_vs_plain": _tree_rel(grads_k, grads_p)}
    leaf_ratio = {}
    for i in attn:
        name = names[i].split(".")[-1]
        rel[f"{name}_kernel"] = _tree_rel([grads_k[i]], [grads_32[i]])
        rel[f"{name}_plain"] = _tree_rel([grads_p[i]], [grads_32[i]])
        leaf_ratio[name] = rel[f"{name}_kernel"] / rel[f"{name}_plain"]
    del grads_k, grads_p, grads_32
    torch.cuda.empty_cache()
    ratio = {k: rel[f"{k}_kernel"] / max(rel[f"{k}_plain"], 1e-30)
             for k in ("loss", "grad")}
    ratio["attn_grad"] = max(leaf_ratio.values())
    return {"rel_to_fp32": rel, "attn_leaf_ratio": leaf_ratio,
            "kernel_over_plain": ratio, "losses": losses,
            "ratio_tol": ratio_tol,
            "ok": all(ratio[k] <= ratio_tol[k] for k in ratio)}


def _counts(fa):
    return {"flash_fwd": fa.launches, "flash_bwd_dq": fa.launches_dq,
            "flash_bwd_dkv": fa.launches_dkv}


def _zero_counts(fa):
    fa.launches = fa.launches_dq = fa.launches_dkv = 0


def _step_profile(step):
    """Device busy share of one step and its ten largest kernels by device
    time, from torch.profiler; "not measured" if it sees no device time.
    A failure of the step itself propagates."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    try:
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        dev_us = sum(e.device_time_total for e in events)
        top = sorted(events, key=lambda e: -e.device_time_total)[:10]
        top = [{"name": e.key[:80], "ms": e.device_time_total / 1e3,
                "count": e.count} for e in top]
    except Exception:  # reading the profile is a probe here, not a phase
        traceback.print_exc()
        dev_us, top = 0, []
    return {"profiled_wall_ms": wall * 1e3,
            "device_ms": dev_us / 1e3 if dev_us else "not measured",
            "device_busy_share": (dev_us / 1e6 / wall if dev_us
                                  else "not measured"),
            "top_kernels": top}


def _train_steps(fa, TR, cfg, params, batch, steps: int, profile: bool,
                 mesh=None):
    """``steps`` AdamW steps (lr 3e-4, bf16 first moment) through the
    kernels on one fixed batch, in place on ``params``; each step's
    metrics, launches and host wall (synchronized), the peak memory, and
    with ``profile`` the last step under torch.profiler (_step_profile).
    With a ``mesh`` the state is sharded on it (interop.shard_state) and
    the step is the meshed one."""
    import torch

    tx = TR.make_optimizer(3e-4, mu_dtype=torch.bfloat16)
    state = {"step": torch.zeros((), dtype=torch.int32, device="cuda"),
             "params": params, "opt_state": tx.init(params)}
    if mesh is not None:
        from ray_tpu_torch.interop import shard_state

        state = shard_state(mesh, state, cfg, tx)
    step_fn = TR.make_train_step(cfg, tx, mesh)
    metrics, launches, walls, prof = [], [], [], None
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
        def one():
            _, m = step_fn(state, batch)
            metrics.append({k: v.item() for k, v in m.items()})
        _zero_counts(fa)
        torch.cuda.synchronize()
        if profile and i == steps - 1:
            prof = _step_profile(one)
        else:
            t0 = time.perf_counter()
            one()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        launches.append(_counts(fa))
    peak = torch.cuda.max_memory_allocated()
    del state, tx
    torch.cuda.empty_cache()
    if not len(metrics) == len(launches) == steps:
        raise AssertionError(f"{len(metrics)} of {steps} train steps "
                             f"reported their metrics")
    losses = [m["loss"] for m in metrics]
    norms = [m["grad_norm"] for m in metrics]
    return {"losses": losses, "grad_norms": norms,
            "finite": all(math.isfinite(x) for x in losses + norms),
            "falling": losses[-1] < losses[0], "launches_per_step": launches,
            "walls_ms": [w * 1e3 for w in walls],
            "peak_mem_gib": peak / 2**30, "profile_last_step": prof,
            "metrics": metrics}


def phase_train(fa, T, TR, C, params, seed: int):
    """bench.py's llama3-1b training cell on the port:
      (a) one step's loss, flattened gradient and wq/wk/wv gradients in
          bf16 through the kernels and through plain attention, each as a
          relative distance from the same step in fp32 with plain attention
          and no TF32 (train_parity); the kernels' may be at most
          _TRAIN_BF16_RATIO times the plain one's, and this step launches
          the kernels as a train step does;
      (b) _TRAIN_STEPS AdamW steps through the kernels on one fixed batch:
          every loss finite, the last below the first;
      (c) launches of each kernel in every step, against _TRAIN_LAUNCHES
          (B1 16 forward + 16 remat recomputes, B2 and B3 16);
      (d) ms per step (steps 2-4, host clock around synchronized steps),
          tokens/s, MFU against 989 TFLOP/s from cfg.flops_per_token, peak
          memory, and the busy share of step 5 from torch.profiler.
    Params are updated in place: this phase runs last."""
    cfg = train_config(C)
    batch = train_batch(cfg, seed + 3)

    # (a) three ways on identical weights and batch
    _zero_counts(fa)
    parity = train_parity(T, TR, cfg, params, batch)
    grad_launches = _counts(fa)  # the plain and fp32 steps launch nothing

    # (b), (c), (d): optimizer steps through the kernels
    run = _train_steps(fa, TR, cfg, params, batch, _TRAIN_STEPS, True)
    walls = run.pop("walls_ms")
    step_ms = sum(walls[1:]) / len(walls[1:])
    flops_step = cfg.flops_per_token(2048) * 4 * 2048
    launches_ok = all(c == _TRAIN_LAUNCHES
                      for c in [grad_launches, *run["launches_per_step"]])
    run["profile_step5"] = run.pop("profile_last_step")
    del run["metrics"]
    _emit({"phase": "train", "config": "llama3-1b", "batch": [4, 2048],
           "param_dtype": "bfloat16", "mu_dtype": "bfloat16", "remat": True,
           "lr": 3e-4, "parity": parity, "ratio_tol": _TRAIN_BF16_RATIO,
           "grad_launches": grad_launches, **run,
           "launches_want": _TRAIN_LAUNCHES, "first_step_ms": walls[0],
           "ms_per_step": step_ms,
           "tokens_per_s": 4 * 2048 / step_ms * 1e3,
           "flops_per_step": flops_step,
           "mfu": flops_step / step_ms * 1e3 / _PEAK_FLOPS["bfloat16"]})
    if not (parity["ok"] and run["finite"] and run["falling"]
            and launches_ok):
        raise AssertionError("train phase failed")
    return run["launches_per_step"][0]


def _active_flops_per_token(cfg, seq: int) -> float:
    """Training FLOPs a token needs in the MoE model: 6 x the parameters
    it multiplies by (q/k/v/o projections, the router, its k experts'
    SwiGLU, the tied head) + the attention term of cfg.flops_per_token
    (12 L d T). Expert places left empty by the capacity, and the experts a
    token is not routed to, are not counted."""
    d, L, hd = cfg.d_model, cfg.n_layers, cfg.head_dim
    attn = d * cfg.n_heads * hd * 2 + 2 * d * cfg.kv_heads * hd
    per_layer = attn + d * cfg.moe_experts + cfg.moe_top_k * 3 * d * cfg.d_ff
    return 6.0 * (L * per_layer + cfg.vocab_size * d) + 12.0 * L * d * seq


def phase_moe_train(fa, T, TR, cfg, params, seed: int):
    """The MoE model at _MOE_TRAIN_LAYERS layers (``cfg``, bf16 params,
    remat "nothing"), batch 4 x 2048: train check (a) within
    _TRAIN_BF16_RATIO (the unbroken kernels over 2 weight seeds x 2 batches
    read loss 0.114-0.942, gradient 0.935-0.997 and wq/wk/wv leaves at most
    1.001 there, under the dense bars; B2's mutant reaches 1.89 on wq, B3's
    1.26 on wk); _TRAIN_STEPS AdamW steps on one fixed batch with
    finite, falling losses and a finite moe_aux; launches per step exactly
    _MOE_TRAIN_LAUNCHES; ms per step (steps 2-5), tokens/s, peak memory and
    MFU of the active work (_active_flops_per_token; cfg.flops_per_token
    is the reference's and counts no experts). Params change in place."""
    batch = train_batch(cfg, seed + 3)
    _zero_counts(fa)
    parity = train_parity(T, TR, cfg, params, batch)
    grad_launches = _counts(fa)
    run = _train_steps(fa, TR, cfg, params, batch, _TRAIN_STEPS, False)
    walls = run.pop("walls_ms")
    step_ms = sum(walls[1:]) / len(walls[1:])
    aux = [m["moe_aux"] for m in run.pop("metrics")]
    flops_step = _active_flops_per_token(cfg, 2048) * 4 * 2048
    launches_ok = all(c == _MOE_TRAIN_LAUNCHES
                      for c in [grad_launches, *run["launches_per_step"]])
    aux_finite = all(math.isfinite(x) for x in aux)
    del run["profile_last_step"]
    _emit({"phase": "moe_train", "config": "llama3-1b", **_MOE,
           "n_layers": cfg.n_layers, "batch": [4, 2048],
           "param_dtype": "bfloat16", "mu_dtype": "bfloat16", "remat": True,
           "lr": 3e-4, "parity": parity, "grad_launches": grad_launches,
           **run, "moe_aux": aux, "moe_aux_finite": aux_finite,
           "launches_want": _MOE_TRAIN_LAUNCHES, "first_step_ms": walls[0],
           "ms_per_step": step_ms, "tokens_per_s": 4 * 2048 / step_ms * 1e3,
           "active_flops_per_step": flops_step,
           "flops_formula": "4*2048*(6*(L*(2*d*H*hd + 2*d*KV*hd + d*E"
                            " + k*3*d*ff) + V*d) + 12*L*d*2048)",
           "mfu_active": flops_step / step_ms * 1e3
           / _PEAK_FLOPS["bfloat16"]})
    if not (parity["ok"] and run["finite"] and run["falling"] and aux_finite
            and launches_ok):
        raise AssertionError("moe_train phase failed")
    return run["launches_per_step"][0]


def phase_train_mesh(fa, T, TR, C, params, seed: int):
    """Phase train's cell on make_mesh(fsdp=1), an NCCL world of one:
      (a) one step's loss and gradient with the params as DTensors
          (interop.shard_params) against the unmeshed step's on the same
          params and batch, within _MESH_TOL (loss absolute, flattened
          gradient relative); that step launches B1 32, B2 16, B3 16 times;
      (b) _TRAIN_STEPS meshed AdamW steps from a copy of the params:
          launches per step, ms per step (steps 2-5), peak memory, beside
          phase train's, which shows the DTensor wrapper's host cost.
    ``params`` are left as they were; the process group is destroyed."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.interop import shard_params
    from ray_tpu_torch.parallel import make_mesh

    cfg = train_config(C)
    batch = train_batch(cfg, seed + 3)
    mesh = make_mesh(fsdp=1)
    try:
        loss_u, grads_u = _grads(T, TR, params, batch, cfg)
        dparams = shard_params(mesh, params, cfg)
        _zero_counts(fa)
        loss_m, grads_m = _grads(T, TR, dparams, batch, cfg, mesh)
        grad_launches = _counts(fa)
        direct = {"loss": abs(loss_m.item() - loss_u.item()),
                  "grad": _tree_rel(grads_m, grads_u)}
        del grads_u, grads_m, dparams
        torch.cuda.empty_cache()
        copy = TR.tree_map(lambda w: w.clone(), params)
        run = _train_steps(fa, TR, cfg, copy, batch, _TRAIN_STEPS, False,
                           mesh)
        del copy
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    walls = run.pop("walls_ms")
    step_ms = sum(walls[1:]) / len(walls[1:])
    del run["metrics"], run["profile_last_step"]
    launches_ok = all(c == _TRAIN_LAUNCHES
                      for c in [grad_launches, *run["launches_per_step"]])
    parity_ok = all(x <= _MESH_TOL for x in direct.values())
    _emit({"phase": "train_mesh", "config": "llama3-1b", "batch": [4, 2048],
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
           "backend": "nccl", "meshed_vs_unmeshed": direct,
           "tol": _MESH_TOL, "loss_unmeshed": loss_u.item(),
           "grad_launches": grad_launches, **run,
           "launches_want": _TRAIN_LAUNCHES, "first_step_ms": walls[0],
           "ms_per_step": step_ms,
           "tokens_per_s": 4 * 2048 / step_ms * 1e3})
    if not (parity_ok and launches_ok and run["finite"] and run["falling"]):
        raise AssertionError("train_mesh phase failed")
    return run["launches_per_step"][0]


def phase_train_dots(fa, T, TR, C, params, seed: int):
    """Phase train's cell with remat_policy "dots" (keep the outputs of
    aten.mm, recompute the rest) from the same params and batch:
      (a) one step's loss and gradients under "dots" and under "nothing"
          through the kernels must agree within _DOTS_TOL; the "dots" step
          launches B1 32, B2 16 and B3 16 times;
      (b) three AdamW steps each way from copies of the params: launches
          per step, ms per step (step 2), peak memory, and step 3's device
          time and busy share from torch.profiler, side by side.
    ``params`` are left as they were."""
    import torch

    nothing = train_config(C)
    dots = dataclasses.replace(nothing, remat_policy="dots")
    batch = train_batch(nothing, seed + 3)
    loss_n, grads_n = _grads(T, TR, params, batch, nothing)
    _zero_counts(fa)
    loss_d, grads_d = _grads(T, TR, params, batch, dots)
    grad_launches = _counts(fa)
    direct = {"loss": abs(loss_d.item() - loss_n.item()),
              "grad": _tree_rel(grads_d, grads_n)}
    del grads_n, grads_d
    torch.cuda.empty_cache()
    parity_ok = all(x <= _DOTS_TOL for x in direct.values())

    runs = {}
    for tag, cfg in (("nothing", nothing), ("dots", dots)):
        copy = TR.tree_map(lambda w: w.clone(), params)
        run = _train_steps(fa, TR, cfg, copy, batch, 3, True)
        del copy, run["metrics"]
        prof = run.pop("profile_last_step")
        run["profile_step3"] = {k: prof[k] for k in (
            "profiled_wall_ms", "device_ms", "device_busy_share")}
        torch.cuda.empty_cache()
        runs[tag] = run
    launches_ok = all(c == _TRAIN_LAUNCHES for c in
                      [grad_launches, *runs["dots"]["launches_per_step"]])
    _emit({"phase": "train_dots", "config": "llama3-1b", "batch": [4, 2048],
           "remat_policy": "dots", "dots_vs_nothing": direct,
           "tol": _DOTS_TOL, "grad_launches": grad_launches,
           "launches_want": _TRAIN_LAUNCHES, "runs": runs,
           "ms_per_step": {k: r["walls_ms"][-1] for k, r in runs.items()},
           "device_ms_step3": {k: r["profile_step3"]["device_ms"]
                               for k, r in runs.items()},
           "peak_mem_gib": {k: r["peak_mem_gib"] for k, r in runs.items()}})
    if not (parity_ok and launches_ok and
            all(r["finite"] for r in runs.values())):
        raise AssertionError("train_dots phase failed")
    return runs["dots"]["launches_per_step"][0]


def axis_check(fa, T, TR, cfg, params, vm, tokens, batch, fwd_ratio,
               train_ratio) -> dict:
    """The forward check (forward_parity) and train check (a)
    (train_parity) with the kernel side on the VirtualMesh ``vm``, and the
    launches of one forward and one train step there."""
    import torch

    _zero_counts(fa)
    with torch.no_grad():
        T.forward(params, tokens, cfg, vm)
    torch.cuda.synchronize()
    fwd_launches = _counts(fa)
    fwd = forward_parity(T, cfg, params, params, tokens, fwd_ratio,
                         _FWD_REL_TOL, vm)
    torch.cuda.empty_cache()
    _zero_counts(fa)
    train = train_parity(T, TR, cfg, params, batch, vm, train_ratio)
    train_launches = _counts(fa)  # the plain and fp32 steps launch nothing
    torch.cuda.empty_cache()
    launches_ok = (fwd_launches == _AXIS_LAUNCHES["forward"]
                   and train_launches == _AXIS_LAUNCHES["train"])
    return {"forward": fwd, "train": train, "forward_launches": fwd_launches,
            "train_launches": train_launches,
            "launches_want": _AXIS_LAUNCHES, "launches_ok": launches_ok,
            "ok": fwd["ok"] and train["ok"] and launches_ok}


def pipeline_config(C):
    """The train cell in _PP stages of 4 layers on _PP_MICRO microbatches."""
    return dataclasses.replace(train_config(C),
                               pipeline_microbatches=_PP_MICRO)


def _axis_times(T, TR, cfg, params, vm, tokens, batch) -> dict:
    """ms of a forward (CUDA events, 3 runs) and of a forward + backward
    (host clock around synchronized calls, 2 runs) on ``vm`` and unmeshed,
    in this order: meshed, unmeshed, unmeshed, meshed."""
    import torch

    def fwd(mesh):
        with torch.no_grad():
            return _time_ms(lambda: T.forward(params, tokens, cfg, mesh), 3,
                            1)

    def grad(mesh):
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _grads(T, TR, params, batch, cfg, mesh)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        return min(walls)

    out = {"forward_ms": fwd(vm), "forward_unmeshed_ms": fwd(None)}
    out["grad_step_unmeshed_ms"] = grad(None)
    out["grad_step_ms"] = grad(vm)
    torch.cuda.empty_cache()
    return out


def phase_tensor(fa, T, TR, C, params, seed: int):
    """The train cell on _TP virtual tensor ranks (VirtualMesh("tensor",
    4)): each rank's heads through B1/B2/B3 at [32, 2048, 64], its d_ff
    columns and vocabulary rows, the partial sums added in rank order.
    axis_check within _TP_FWD_RATIO and _TP_TRAIN_RATIO, launches exactly
    _AXIS_LAUNCHES; times beside the unmeshed ones, and a rank's share
    (each rank does a quarter of the work; the all-reduces are not on
    this card)."""
    from ray_tpu_torch.parallel.mesh import VirtualMesh

    cfg = train_config(C)
    vm = VirtualMesh("tensor", _TP)
    tokens, batch = forward_tokens(cfg, seed), train_batch(cfg, seed + 3)
    row = axis_check(fa, T, TR, cfg, params, vm, tokens, batch,
                     _TP_FWD_RATIO, _TP_TRAIN_RATIO)
    times = _axis_times(T, TR, cfg, params, vm, tokens, batch)
    _emit({"phase": "tensor", "config": "llama3-1b", "virtual_ranks": _TP,
           "batch": [4, 2048], "remat": True, "dtype": "bfloat16",
           "b1_b2_b3_shape": [4 * cfg.n_heads // _TP, 2048, 64],
           "fwd_ratio_tol": _TP_FWD_RATIO,
           "train_ratio_tol": _TP_TRAIN_RATIO, **row, **times,
           "per_rank_forward_ms": times["forward_ms"] / _TP,
           "per_rank_grad_step_ms": times["grad_step_ms"] / _TP})
    if not row["ok"]:
        raise AssertionError("tensor phase failed")
    return row


def phase_pipeline(fa, T, TR, C, params, seed: int):
    """The train cell in _PP virtual stages (VirtualMesh("pipeline", 4)) of
    4 layers on _PP_MICRO microbatches of [1, 2048]: the GPipe schedule of
    parallel/pipeline.py in one process, the hand-off a copy, the bubble
    ticks skipped. axis_check within _PP_FWD_RATIO and _PP_TRAIN_RATIO,
    launches exactly _AXIS_LAUNCHES; times beside the unmeshed ones. A
    stage's work per microbatch is the measured time over S*M, and a real
    pipeline's step takes M + S - 1 such ticks (bubble share (S-1)/(M+S-1),
    derived, not measured across cards)."""
    from ray_tpu_torch.parallel.mesh import VirtualMesh

    cfg = pipeline_config(C)
    vm = VirtualMesh("pipeline", _PP)
    tokens, batch = forward_tokens(cfg, seed), train_batch(cfg, seed + 3)
    row = axis_check(fa, T, TR, cfg, params, vm, tokens, batch,
                     _PP_FWD_RATIO, _PP_TRAIN_RATIO)
    times = _axis_times(T, TR, cfg, params, vm, tokens, batch)
    ticks, work = _PP_MICRO + _PP - 1, _PP * _PP_MICRO
    _emit({"phase": "pipeline", "config": "llama3-1b", "virtual_stages": _PP,
           "microbatches": _PP_MICRO, "microbatch": [1, 2048],
           "bubble_ticks": "skipped", "remat": True, "dtype": "bfloat16",
           "b1_b2_b3_shape": [cfg.n_heads, 2048, 64],
           "fwd_ratio_tol": _PP_FWD_RATIO,
           "train_ratio_tol": _PP_TRAIN_RATIO, **row, **times,
           "bubble_share": (_PP - 1) / ticks,
           "per_rank_forward_ms_derived": times["forward_ms"] / work * ticks,
           "per_rank_grad_step_ms_derived":
               times["grad_step_ms"] / work * ticks})
    if not row["ok"]:
        raise AssertionError("pipeline phase failed")
    return row


def phase_moe_parallel(M, cfg, params, seed: int):
    """Layer 0 of the MoE model at [4, 2048] bf16 on 4 virtual expert ranks
    (2 experts each: each routes every token, runs its experts' kept slots,
    the partial outputs summed) and on 2 virtual sequence ranks (chunks of
    1024 tokens; capacity claimed along the whole row, rank 1 offset by
    rank 0's counts), at capacity factor 1.25 and 0.5, each against the
    unsharded moe_ffn by moe_layer's checks: expert ids and kept slots
    equal, the output within 1.05 (2u|y| + 6u A) + 1e-6 per element and
    1e-2 as a whole; at 0.5 some slots must drop. Times beside the
    unsharded layer's."""
    import torch

    from ray_tpu_torch.parallel.mesh import VirtualMesh

    lp = {k: params["layers"][k][0] for k in ("router", "w_gate", "w_up",
                                              "w_down")}
    g = torch.Generator(device="cuda").manual_seed(seed + 11)
    h = torch.randn(4, 2048, cfg.d_model, generator=g,
                    device="cuda").to(cfg.dtype)
    u, ok = _MOE_LAYER_UNIT, True
    for cf in (cfg.moe_capacity_factor, _MOE_LAYER_DROP_CF):
        c = dataclasses.replace(cfg, moe_capacity_factor=cf)
        with torch.no_grad():
            y_u, _, top_u, kept_u = M.moe_layer(h, lp, c)
            tol = 1.05 * (2 * u * y_u.float().abs()
                          + 6 * u * _moe_abs_path(M, h, lp, c)) + 1e-6
            unsharded_ms = _time_ms(lambda: M.moe_layer(h, lp, c), 5)
            for axis, n in (("expert", 4), ("sequence", 2)):
                vm = VirtualMesh(axis, n)
                y, _, top_i, kept = M.moe_layer(h, lp, c, vm)
                torch.cuda.synchronize()
                dy = y.float() - y_u.float()
                row = {"same_expert_ids": torch.equal(top_i, top_u),
                       "same_kept": torch.equal(kept, kept_u),
                       "dropped_share": 1 - kept.float().mean().item(),
                       "max_abs_err": dy.abs().max().item(),
                       "err_over_tol": (dy.abs() / tol).max().item(),
                       "rel_norm_err": (dy.norm()
                                        / y_u.float().norm()).item(),
                       "finite": bool(torch.isfinite(y.float()).all()),
                       "ms": _time_ms(lambda: M.moe_layer(h, lp, c, vm), 5),
                       "unsharded_ms": unsharded_ms}
                row["ok"] = (row["same_expert_ids"] and row["same_kept"]
                             and row["finite"] and row["err_over_tol"] <= 1
                             and row["rel_norm_err"] <= _MOE_LAYER_REL_TOL
                             and (cf == cfg.moe_capacity_factor
                                  or row["dropped_share"] > 0))
                _emit({"phase": "moe_parallel", "axis": axis,
                       "virtual_ranks": n, "shape": [4, 2048, cfg.d_model],
                       "dtype": "bfloat16", **_MOE,
                       "moe_capacity_factor": cf,
                       "tol": f"1.05*(2u|y| + 6u*sum_k p|act|@|W_down|) + "
                              f"1e-6, u={u}",
                       "rel_norm_tol": _MOE_LAYER_REL_TOL, **row})
                ok = ok and row["ok"]
        torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("the expert- or sequence-split MoE layer "
                             "disagrees with the unsharded one")


def phase_engine_mesh(E, cfg, p32, seed: int):
    """The fp32 engine on make_mesh(tensor=1), an NCCL world of one, token
    for token against the unmeshed engine on the same prompts. It covers
    the meshed engine's code path on the card (its rank's weights and
    cache, the reductions and the logits' gather, all over groups of one);
    the splits over real ranks run in tests/test_torch_multicard.py. The
    process group is destroyed after."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.parallel import make_mesh

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                param_dtype=torch.float32)
    rng = random.Random(seed + 7)
    prompts = [[rng.randint(1, cfg.vocab_size - 1) for _ in range(n)]
               for n in (5, 17, 40, 64)]
    mesh = make_mesh(tensor=1)
    got, walls = {}, {}
    try:
        for tag, m in (("unmeshed", None), ("meshed", mesh)):
            eng = E.InferenceEngine(p32, cfg32, slots=8, max_prompt_len=64,
                                    max_new_tokens=32, greedy=True,
                                    seed=seed, mesh=m)
            t0 = time.perf_counter()
            reqs = [eng.submit(p) for p in prompts]
            for _ in range(1000):
                if all(r.done.is_set() for r in reqs):
                    break
                eng.step()
            walls[tag] = time.perf_counter() - t0
            got[tag] = [list(r.tokens) for r in reqs]
            del eng
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    match = [a == b for a, b in zip(got["meshed"], got["unmeshed"])]
    _emit({"phase": "engine_mesh", "dtype": "float32", "tf32": False,
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
           "backend": "nccl", "covers": "the meshed engine's code path on a "
           "world of one; no split over ranks",
           "prompt_lens": [len(p) for p in prompts], "max_new_tokens": 32,
           "match_unmeshed": match, "wall_s": walls})
    if not all(match):
        raise AssertionError("the meshed engine's tokens differ from the "
                             "unmeshed engine's")


def _axis_launches(tensor_row, pipeline_row, name: str) -> dict:
    """A kernel's launches on the tensor and pipeline paths (a forward is
    listed only where the kernel runs there)."""
    out = {}
    for tag, row in (("tensor", tensor_row), ("pipeline", pipeline_row)):
        if row["forward_launches"][name]:
            out[f"{tag}_forward"] = row["forward_launches"][name]
        out[f"{tag}_train_step"] = row["train_launches"][name]
    return out


def run(seed: int) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, _ROOT)
    try:
        from ray_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the ray_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    from ray_tpu_torch.models import config as C
    from ray_tpu_torch.models import engine as E
    from ray_tpu_torch.models import generate as G
    from ray_tpu_torch.models import moe as M
    from ray_tpu_torch.models import training as TR
    from ray_tpu_torch.models import transformer as T
    from ray_tpu_torch.parallel import ring as R
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

    # fp32 matmuls and convolutions in full fp32: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    per_source = _build.build_all()  # one nvcc per source, all together
    libs = {n: _build.load(n)._name for n in _build.sources()}
    ptxas = {n: _build.ptxas_report(_build.build_log(n)) for n in libs}
    spilled = [k["kernel"] for ks in ptxas.values() for k in ks
               if k["spill_stores"] or k["spill_loads"]]
    _emit({"phase": "build", "seconds": time.perf_counter() - t0,
           "seconds_per_source": per_source,
           "libraries": {n: os.path.relpath(p, _ROOT)
                         for n, p in libs.items()},
           "ptxas": ptxas, "spilled": spilled, "ok": not spilled})

    smi = _nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    _emit({"phase": "device", "kind": kind, "count": count,
           "nvidia_smi": smi, "torch": torch.__version__,
           "cuda": torch.version.cuda})

    failed = ["build"] if spilled else []

    def attempt(name, fn, *args):
        # a failed phase is reported and the later phases still run, so one
        # run shows every fault; the script then exits non-zero
        t0 = time.perf_counter()
        try:
            return fn(*args)
        except Exception:
            traceback.print_exc()
            failed.append(name)
            return None
        finally:
            _emit({"phase_wall": name, "s": time.perf_counter() - t0})

    rows = attempt("kernels", phase_kernels, fa, seed)
    bwd_rows = attempt("kernels_bwd", phase_kernels_bwd, fa, seed)
    ring_launches = attempt("ring", phase_ring, fa, R, seed)
    torch.cuda.empty_cache()
    attempt("entry", phase_entry)

    cfg = C.get_config("llama3-1b", param_dtype=torch.bfloat16)
    params = T.init_params(torch.Generator(device="cuda").manual_seed(seed),
                           cfg, device="cuda")
    # the same weights in fp32 (bf16 values are exact in fp32)
    p32 = {"embed": params["embed"].float(),
           "final_norm": params["final_norm"].float(),
           "layers": {k: w.float() for k, w in params["layers"].items()}}
    launches = attempt("forward", phase_forward, fa, T, cfg, params, p32,
                       seed)
    attempt("engine", phase_engine_fp32, E, G, cfg, p32, seed)
    attempt("engine_mesh", phase_engine_mesh, E, cfg, p32, seed)
    del p32
    torch.cuda.empty_cache()
    attempt("serving", phase_serving, E, cfg, params, seed)
    torch.cuda.empty_cache()

    # Mixture-of-Experts: the 16-layer model (13.7 GB in bf16), then the
    # 4-layer one that trains
    moe = moe_config(C)
    moe_params = attempt("moe_init", T.init_params, torch.Generator(
        device="cuda").manual_seed(seed + 100), moe, "cuda")
    moe_launches = moe_train_launches = None
    if moe_params is not None:
        attempt("moe_layer", phase_moe_layer, M, moe, moe_params, seed)
        attempt("moe_parallel", phase_moe_parallel, M, moe, moe_params,
                seed)
        torch.cuda.empty_cache()
        moe_launches = attempt("moe_forward", phase_moe_forward, fa, T, M,
                               moe, moe_params, seed)
        torch.cuda.empty_cache()
        attempt("moe_serving", phase_serving, E, moe, moe_params, seed,
                "moe_serving")
    del moe_params
    torch.cuda.empty_cache()
    moe4 = moe_train_config(C)
    moe_params = attempt("moe_init", T.init_params, torch.Generator(
        device="cuda").manual_seed(seed + 101), moe4, "cuda")
    if moe_params is not None:
        attempt("moe_engine", phase_moe_engine, E, G, moe4, moe_params,
                seed)
        torch.cuda.empty_cache()
        moe_train_launches = attempt("moe_train", phase_moe_train, fa, T,
                                     TR, moe4, moe_params, seed)
    del moe_params
    torch.cuda.empty_cache()

    tensor_row = attempt("tensor", phase_tensor, fa, T, TR, C, params, seed)
    torch.cuda.empty_cache()
    pipeline_row = attempt("pipeline", phase_pipeline, fa, T, TR, C, params,
                           seed)
    torch.cuda.empty_cache()
    mesh_launches = attempt("train_mesh", phase_train_mesh, fa, T, TR, C,
                            params, seed)
    torch.cuda.empty_cache()
    dots_launches = attempt("train_dots", phase_train_dots, fa, T, TR, C,
                            params, seed)
    torch.cuda.empty_cache()
    train_launches = attempt("train", phase_train, fa, T, TR, C, params,
                             seed)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1

    main = next(r for r in rows if r["case"] == "main")
    bwd_main = next(r for r in bwd_rows if r["case"] == "main")
    line = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "ray_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:35",
        "launches": launches, "max_abs_err": main["o_max_abs_err"],
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "tflops_per_s": main["tflops_per_s"],
        "bound_share": main["bound_ms"] / main["ms"],
        "launches_by_path": {
            "forward": launches, "train_step": train_launches["flash_fwd"],
            "moe_forward": moe_launches,
            "moe_train_step": moe_train_launches["flash_fwd"],
            "train_dots_step": dots_launches["flash_fwd"],
            "ring_forward": ring_launches["ring_forward"],
            "train_mesh_step": mesh_launches["flash_fwd"],
            **_axis_launches(tensor_row, pipeline_row, "flash_fwd")}}]
    for name, line_no, source, err in (
            ("flash_bwd_dq", 87, "flash_bwd.cu", "dq_max_abs_err"),
            ("flash_bwd_dkv", 111, "flash_bwd_dkv.cu", None)):
        k = bwd_main[name]
        line.append({
            "name": name, "route": "cuda",
            "source": f"ray_tpu_torch/csrc/{source}",
            "replaces": f"ray_tpu/ops/flash_attention.py:{line_no}",
            "launches": train_launches[name],
            "max_abs_err": (bwd_main[err] if err else
                            max(bwd_main["dk_max_abs_err"],
                                bwd_main["dv_max_abs_err"])),
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"],
            "tflops_per_s": k["tflops_per_s"],
            "bound_share": k["bound_ms"] / k["ms"],
            "launches_by_path": {
                "train_step": train_launches[name],
                "moe_train_step": moe_train_launches[name],
                "train_dots_step": dots_launches[name],
                "ring_backward": ring_launches[
                    "ring_backward" if name == "flash_bwd_dq"
                    else "ring_backward_dkv"],
                "train_mesh_step": mesh_launches[name],
                **_axis_launches(tensor_row, pipeline_row, name)}})
    _emit({"kernels": line})
    print(smi, flush=True)
    _emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                  "count": count}})
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    try:
        return run(args.seed)
    except Exception:
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
