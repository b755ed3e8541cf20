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
  forward   forward(params, tokens[4, 2048]) in bf16 through the flash
            kernel (launches counted), against plain attention and the
            fp32 forward
  engine    InferenceEngine in fp32 (no TF32), token for token against the
            port's own generate()
  serving   InferenceEngine in bf16 at bench_serve.py's settings under
            serve_forever: 8 client threads, 32 requests
  train     bench.py's llama3-1b training cell (batch 4 x 2048, bf16
            params, remat, AdamW with a bf16 first moment): one step's loss
            and gradient through the kernels and through plain attention,
            each against the fp32 step; five optimizer steps through the
            kernels with their launches counted; ms per step, tokens/s, MFU,
            peak memory and the device's busy share

Then the kernel summary line, the card's nvidia-smi line, and as the last
line {"ok": true, "device": {...}}. Any failure exits non-zero before that
line. Without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import argparse
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
    shape and five more; each kernel's time, its plain version's, SDPA's
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
    """B1 against its plain version at the forward's shape and five more."""
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


def _rel(x, ref) -> float:
    return ((x - ref).norm() / ref.norm()).item()


def forward_parity(T, cfg, params, p32, tokens) -> dict:
    """The forward through the kernel (``cfg``) held against plain
    attention two ways:
      - fp32: the same forward in fp32 through the kernel against fp32
        plain attention, within _FWD_REL_TOL;
      - bf16: both bf16 forwards against the fp32 one; the kernel's forward
        may be at most _FWD_BF16_RATIO times as far from it as the
        plain-attention forward is.
    A direct bf16-vs-bf16 bound cannot hold: this random-weight model is
    chaotic in bf16. Measured on the H100 with P.V made exact to fp32 in
    the kernel, the two bf16 forwards still differed by 2.5%, while each
    kept 3.05% from the fp32 forward (printed as rel_bf16_*).
    -> the distances, their ratio, the logits' shape, "finite" and "ok"."""
    import torch

    logits = T.forward(params, tokens, cfg)
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
    rel_fp32 = _rel(T.forward(p32, tokens, cfg32), truth)
    del truth
    ratio = rel_bf16["kernel_vs_fp32"] / rel_bf16["plain_vs_fp32"]
    return {"logits_shape": shape, "finite": finite,
            "rel_fp32_kernel_vs_plain": rel_fp32, "rel_tol": _FWD_REL_TOL,
            **{f"rel_bf16_{k}": v for k, v in rel_bf16.items()},
            "bf16_kernel_over_plain": ratio,
            "bf16_ratio_tol": _FWD_BF16_RATIO,
            "ok": (finite and rel_fp32 <= _FWD_REL_TOL
                   and ratio <= _FWD_BF16_RATIO)}


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


def phase_serving(E, cfg, params, seed: int):
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
    _emit({"phase": "serving", "dtype": "bfloat16", "clients": clients,
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
        raise AssertionError("serving phase failed")



def _grads(T, TR, params, batch, cfg):
    """(loss, grads) of one step's loss_fn, leaves in tree order."""
    import torch

    leaves = TR.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, _ = T.loss_fn(params, batch, cfg)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
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


def train_parity(T, TR, cfg, params, batch) -> dict:
    """One step's loss and gradients three ways on identical weights and
    batch: bf16 through the kernels (``cfg``), bf16 through plain attention,
    and fp32 with plain attention as the truth (the caller turns TF32 off).
    -> each bf16 step's relative distance from the fp32 step for the loss,
    the flattened gradient of all leaves, and each leaf of _ATTN_GRAD_LEAVES;
    the kernel step's distance over the plain step's ("kernel_over_plain":
    loss, grad, and attn_grad, the largest of the leaves'); the three
    losses; and "ok", whether every ratio is within _TRAIN_BF16_RATIO."""
    import torch

    names = _leaf_names(params)
    attn = [names.index(n) for n in _ATTN_GRAD_LEAVES]
    plain_cfg = dataclasses.replace(cfg, attention_impl="xla")
    cfg32 = dataclasses.replace(plain_cfg, dtype=torch.float32,
                                param_dtype=torch.float32)
    loss_k, grads_k = _grads(T, TR, params, batch, cfg)
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
            "ok": all(ratio[k] <= _TRAIN_BF16_RATIO[k] for k in ratio)}


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
    import torch

    cfg = train_config(C)
    batch = train_batch(cfg, seed + 3)

    # (a) three ways on identical weights and batch
    _zero_counts(fa)
    parity = train_parity(T, TR, cfg, params, batch)
    grad_launches = _counts(fa)  # the plain and fp32 steps launch nothing

    # (b), (c), (d): optimizer steps through the kernels
    tx = TR.make_optimizer(3e-4, mu_dtype=torch.bfloat16)
    state = {"step": torch.zeros((), dtype=torch.int32, device="cuda"),
             "params": params, "opt_state": tx.init(params)}
    step_fn = TR.make_train_step(cfg, tx)
    losses, norms, launches, walls, prof = [], [], [], [], None
    torch.cuda.reset_peak_memory_stats()
    for i in range(_TRAIN_STEPS):
        def one():
            _, m = step_fn(state, batch)
            losses.append(m["loss"].item())
            norms.append(m["grad_norm"].item())
        _zero_counts(fa)
        torch.cuda.synchronize()
        if i == _TRAIN_STEPS - 1:
            prof = _step_profile(one)
        else:
            t0 = time.perf_counter()
            one()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        launches.append(_counts(fa))
    peak = torch.cuda.max_memory_allocated()
    if not len(losses) == len(norms) == len(launches) == _TRAIN_STEPS:
        raise AssertionError(f"{len(losses)} of {_TRAIN_STEPS} train steps "
                             f"reported their metrics")
    step_s = sum(walls[1:]) / len(walls[1:])
    flops_step = cfg.flops_per_token(2048) * 4 * 2048
    finite = all(math.isfinite(x) for x in losses + norms)
    falling = losses[-1] < losses[0]
    launches_ok = all(c == _TRAIN_LAUNCHES
                      for c in [grad_launches, *launches])
    _emit({"phase": "train", "config": "llama3-1b", "batch": [4, 2048],
           "param_dtype": "bfloat16", "mu_dtype": "bfloat16", "remat": True,
           "lr": 3e-4, "parity": parity, "ratio_tol": _TRAIN_BF16_RATIO,
           "grad_launches": grad_launches,
           "losses": losses, "grad_norms": norms, "finite": finite,
           "falling": falling, "launches_per_step": launches,
           "launches_want": _TRAIN_LAUNCHES, "first_step_ms": walls[0] * 1e3,
           "ms_per_step": step_s * 1e3,
           "tokens_per_s": 4 * 2048 / step_s,
           "flops_per_step": flops_step,
           "mfu": flops_step / step_s / _PEAK_FLOPS["bfloat16"],
           "peak_mem_gib": peak / 2**30, "profile_step5": prof})
    if not (parity["ok"] and finite and falling and launches_ok):
        raise AssertionError("train phase failed")
    return launches[0]


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
    from ray_tpu_torch.models import training as TR
    from ray_tpu_torch.models import transformer as T
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
        try:
            return fn(*args)
        except Exception:
            traceback.print_exc()
            failed.append(name)
            return None

    rows = attempt("kernels", phase_kernels, fa, seed)
    bwd_rows = attempt("kernels_bwd", phase_kernels_bwd, fa, seed)

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
    del p32
    torch.cuda.empty_cache()
    attempt("serving", phase_serving, E, cfg, params, seed)
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
        "launches_by_path": {"forward": launches,
                             "train_step": train_launches["flash_fwd"]}}]
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
            "bound_share": k["bound_ms"] / k["ms"]})
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
