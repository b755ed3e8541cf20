#!/usr/bin/env python3
"""Shows that the flash kernels' checks are not blind: deliberately broken
copies of B1, B2 and B3 must fail them, and the unbroken kernels must pass
them with room to spare.

    python3 kernel_mutants.py [--seed N] [--weight-seeds 0 1]
                              [--batch-seeds 3 4]

Four checks, each for the checkout's own kernels (the baseline) and, as
they apply, for each mutant:

  check_fwd   B1 against its plain version at the llama3-1b forward's shape
              [B*H=128, T=2048, D=64] bf16 causal (``flash_attention.
              check_fwd``);
  forward     chip_smoke.py's forward check, ``chip_smoke.forward_parity``:
              the llama3-1b forward at [4, 2048] through the kernel and
              through plain attention, kernel/plain distance from the fp32
              forward within chip_smoke's _FWD_BF16_RATIO;
  check_bwd   B2/B3 against their plain versions at the training shape
              (``flash_attention.check_bwd``);
  train       chip_smoke.py's train check (a), ``chip_smoke.train_parity``:
              one llama3-1b step (batch 4 x 2048, bf16, remat) through the
              kernels and through plain attention, each against the fp32
              step, kernel/plain within chip_smoke's _TRAIN_BF16_RATIO;
  moe_forward chip_smoke.py's MoE forward check, ``chip_smoke.
              moe_forward_parity``: the 16-layer llama3-1b model with 8
              experts at [4, 2048], within _MOE_FWD_BF16_RATIO;
  moe_train   train check (a) on chip_smoke.py's 4-layer MoE cell
              (``moe_train_config``), within _TRAIN_BF16_RATIO;
  ring        chip_smoke.py's ring check, ``chip_smoke.ring_check``: ring
              attention for 4 virtual ranks against B1 and B2/B3 over the
              whole sequence (``check_ring_fwd``, ``check_ring_bwd``) and
              its launch counts, on each of chip_smoke's _RING_CASES;
  tensor      chip_smoke.py's tensor check, ``chip_smoke.axis_check`` on
              4 virtual tensor ranks: the forward check and train check (a)
              of the llama3-1b train cell within _TP_FWD_RATIO and
              _TP_TRAIN_RATIO, and the launch counts;
  pipeline    the same on 4 virtual pipeline stages and 4 microbatches,
              within _PP_FWD_RATIO and _PP_TRAIN_RATIO.

The baseline's train, moe_forward, moe_train, tensor and pipeline checks
run over every --weight-seeds x --batch-seeds pair: the spread of the plain bf16 step or
forward that the ratios are set from; its other checks, and every mutant's,
run at chip_smoke's own seeds (weight seed --seed, batch seed --seed + 3;
for the MoE checks --seed + 100 and + 101, as chip_smoke.py draws them). The mutants, each a few edited lines of one
source (a ``csrc`` kernel, or ``parallel/ring.py``) in a copy of
``ray_tpu_torch`` in a temporary directory, built there with ``nvcc``:

  b1_skip_k_tile   B1 masks out K/V tile 1 (keys 128-255) for every query
                   block (check_fwd, forward, moe_forward)
  b2_skip_k_tile   B2 leaves out K/V tile 1 (keys 64-127: P = 0 there, so
                   neither dS nor dQ sees them) for every query block
                   (check_bwd, train, moe_train)
  b3_skip_q_tile   B3 leaves out the Q/dO tile at query 1024 for every key
                   block (check_bwd, train, moe_train)
  ring_drop_block  the ring skips one block off the diagonal (below it
                   when causal): rank 3's queries never meet rank 0's keys
                   (ring)
  ring_no_rescale  the LSE merge adds the running output without its
                   weight e^(lse_a - lse) (ring)
  tensor_drop_partial  the sum of the tensor ranks' partial results
                   (``region_sum``) leaves out the last rank's (tensor)
  pipeline_skip_stage  the pipeline's hand-off gives stage i + 2 the
                   output of stage i (stage 1 keeps stage 0's) (pipeline)

One JSON line per check run. Exits non-zero unless every check passes the
baseline and refuses every mutant it is run on. Needs an NVIDIA GPU and
nvcc; the checkout itself is not changed.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

_ROOT = os.path.dirname(os.path.abspath(__file__))

# name -> (the source it edits, [(a line of it, the text put in its
# place)], the checks it runs)
MUTANTS = {
    "b1_skip_k_tile": ("csrc/flash_fwd.cu", [
        ("      if (key >= t_k || (causal && key > r0 + 8 * ((i >> 1) & 1))) "
         "sc[i] = kNegInf;\n",
         "      if (k0 == 2 * N || key >= t_k || "
         "(causal && key > r0 + 8 * ((i >> 1) & 1))) sc[i] = kNegInf;\n"),
        ("      return k0 + BN > t_k || (causal && k0 + BN - 1 > row_lo);\n",
         "      return k0 == BN || k0 + BN > t_k || "
         "(causal && k0 + BN - 1 > row_lo);\n")],
        ["check_fwd", "forward", "moe_forward"]),
    "b2_skip_k_tile": ("csrc/flash_bwd.cu", [
        ("        float p = fast_exp2(fmaf(sc[i], sl2, -lse2[h]));\n",
         "        float p = k0 == BN ? 0.f : "
         "fast_exp2(fmaf(sc[i], sl2, -lse2[h]));\n")],
        ["check_bwd", "train", "moe_train"]),
    "b3_skip_q_tile": ("csrc/flash_bwd_dkv.cu", [
        ("      const bool skip = causal && kw > q0 + BM - 1;\n",
         "      const bool skip = (causal && kw > q0 + BM - 1) || q0 == 1024;\n")],
        ["check_bwd", "train", "moe_train"]),
    "ring_drop_block": ("parallel/ring.py", [
        ("    if not causal:\n        return False\n",
         "    if not causal:\n"
         "        return None if (src, rank) == (0, 3) else False\n"),
        ("    if src < rank:\n        return False\n",
         "    if src < rank:\n"
         "        return None if (src, rank) == (0, 3) else False\n")],
        ["ring"]),
    "ring_no_rescale": ("parallel/ring.py", [
        ("    return w_a * o_a.float() + w_b * o_b.float(), lse\n",
         "    return o_a.float() + w_b * o_b.float(), lse\n")],
        ["ring"]),
    "tensor_drop_partial": ("parallel/mesh.py", [
        ("    for p in parts[1:]:\n",
         "    for p in parts[1:-1]:\n")],
        ["tensor"]),
    "pipeline_skip_stage": ("parallel/pipeline.py", [
        ("            return {s + step: x for s, x in sent.items()\n",
         "            return {s + step: sent.get(s - step, x)\n"
         "                    for s, x in sent.items()\n")],
        ["pipeline"]),
}
CHECKS = ["check_fwd", "forward", "check_bwd", "train", "moe_forward",
          "moe_train", "ring", "tensor", "pipeline"]

# argv: package root, seed, weight seeds, batch seeds, checks (JSON lists).
# The package root comes first on sys.path, so ray_tpu_torch is the copy
# there; chip_smoke is the checkout's.
_PROBE = r"""
import importlib, json, sys
import torch
import chip_smoke as cs
fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
from ray_tpu_torch.models import config as C
from ray_tpu_torch.models import moe as M
from ray_tpu_torch.models import training as TR
from ray_tpu_torch.models import transformer as T
assert fa.__file__.startswith(sys.argv[1]), fa.__file__
seed = int(sys.argv[2])
checks = json.loads(sys.argv[5])
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

g = torch.Generator(device="cuda").manual_seed(seed)
bh, t, d = 128, 2048, 64
q, k, v, do = (torch.randn(bh, t, d, generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(4))
scale = d ** -0.5
o, lse = fa.flash_attention_fwd(q, k, v, scale=scale, causal=True)
torch.cuda.synchronize()
if "check_fwd" in checks:
    check = fa.check_fwd(o, lse, q, k, v, scale=scale, causal=True)
    print(json.dumps({"check": "check_fwd", **check}), flush=True)
if "check_bwd" in checks:
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do, scale=scale,
                                        causal=True)
    torch.cuda.synchronize()
    check = fa.check_bwd(dq, dk, dv, q, k, v, o, lse, do, scale=scale,
                         causal=True)
    print(json.dumps({"check": "check_bwd", **check}), flush=True)
    del dq, dk, dv
del q, k, v, do, o, lse
torch.cuda.empty_cache()

if "forward" in checks:
    cfg = C.get_config("llama3-1b", param_dtype=torch.bfloat16)
    params = T.init_params(torch.Generator(device="cuda").manual_seed(seed),
                           cfg, device="cuda")
    p32 = {"embed": params["embed"].float(),
           "final_norm": params["final_norm"].float(),
           "layers": {n: w.float() for n, w in params["layers"].items()}}
    par = cs.forward_parity(T, cfg, params, p32, cs.forward_tokens(cfg, seed))
    print(json.dumps({"check": "forward", "weight_seed": seed, **par}),
          flush=True)
    del params, p32
    torch.cuda.empty_cache()

if "train" in checks:
    cfg = cs.train_config(C)
    for ws in json.loads(sys.argv[3]):
        params = T.init_params(torch.Generator(device="cuda").manual_seed(ws),
                               cfg, device="cuda")
        for bs in json.loads(sys.argv[4]):
            par = cs.train_parity(T, TR, cfg, params, cs.train_batch(cfg, bs))
            print(json.dumps({"check": "train", "weight_seed": ws,
                              "batch_seed": bs, **par}), flush=True)
        del params
        torch.cuda.empty_cache()

for check, cfg, offset in (("moe_forward", cs.moe_config(C), 100),
                           ("moe_train", cs.moe_train_config(C), 101)):
    if check not in checks:
        continue
    for ws in json.loads(sys.argv[3]):
        params = T.init_params(
            torch.Generator(device="cuda").manual_seed(ws + offset), cfg,
            device="cuda")
        for bs in json.loads(sys.argv[4]):
            if check == "moe_forward":
                par = cs.moe_forward_parity(
                    T, M, cfg, params, cs.moe_forward_tokens(cfg, bs - 3))
            else:
                par = cs.train_parity(T, TR, cfg, params,
                                      cs.train_batch(cfg, bs))
            print(json.dumps({"check": check, "weight_seed": ws,
                              "batch_seed": bs, **par}), flush=True)
        del params
        torch.cuda.empty_cache()

from ray_tpu_torch.parallel import ring as R
assert R.__file__.startswith(sys.argv[1]), R.__file__
if "ring" in checks:
    for case in cs._RING_CASES:
        row = cs.ring_check(fa, R, case, seed, timed=False)
        print(json.dumps({"check": "ring", **row}), flush=True)
        torch.cuda.empty_cache()

from ray_tpu_torch.parallel.mesh import VirtualMesh
for check, cfg, n, ratios in (
        ("tensor", cs.train_config(C), cs._TP,
         (cs._TP_FWD_RATIO, cs._TP_TRAIN_RATIO)),
        ("pipeline", cs.pipeline_config(C), cs._PP,
         (cs._PP_FWD_RATIO, cs._PP_TRAIN_RATIO))):
    if check not in checks:
        continue
    for ws in json.loads(sys.argv[3]):
        params = T.init_params(torch.Generator(device="cuda").manual_seed(ws),
                               cfg, device="cuda")
        for bs in json.loads(sys.argv[4]):
            row = cs.axis_check(fa, T, TR, cfg, params, VirtualMesh(check, n),
                                cs.forward_tokens(cfg, bs - 3),
                                cs.train_batch(cfg, bs), *ratios)
            print(json.dumps({"check": check, "weight_seed": ws,
                              "batch_seed": bs, **row}), flush=True)
        del params
        torch.cuda.empty_cache()
"""


def _probe(pkg_root: str, seed: int, weight_seeds, batch_seeds,
           checks) -> list:
    out = subprocess.run(
        [sys.executable, "-c", _PROBE, pkg_root, str(seed),
         json.dumps(weight_seeds), json.dumps(batch_seeds),
         json.dumps(checks)],
        cwd=pkg_root, capture_output=True, text=True, timeout=1200,
        env={**os.environ, "PYTHONPATH": os.pathsep.join(
            dict.fromkeys([pkg_root, _ROOT]))})
    if out.returncode != 0:
        raise RuntimeError(f"the probe in {pkg_root} failed:\n{out.stderr}")
    return [json.loads(ln) for ln in out.stdout.splitlines()
            if ln.startswith("{")]


def run_mutant(name: str, seed: int) -> list:
    """The checks of one mutant, built in a copy."""
    source, edits, checks = MUTANTS[name]
    with tempfile.TemporaryDirectory(prefix=f"mutant_{name}_") as tmp:
        pkg = os.path.join(tmp, "ray_tpu_torch")
        shutil.copytree(os.path.join(_ROOT, "ray_tpu_torch"), pkg,
                        ignore=shutil.ignore_patterns("__pycache__"))
        src = os.path.join(pkg, source)
        text = open(src).read()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the line to edit occurs "
                                   f"{text.count(old)} times in {source}")
            text = text.replace(old, new)
        with open(src, "w") as f:
            f.write(text)
        return _probe(tmp, seed, [seed], [seed + 3], checks)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--weight-seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--batch-seeds", type=int, nargs="+", default=[3, 4])
    args = ap.parse_args()
    ok = True
    runs = [("baseline", _probe(_ROOT, args.seed, args.weight_seeds,
                                args.batch_seeds, CHECKS))]
    runs += [(name, run_mutant(name, args.seed)) for name in MUTANTS]
    for variant, rows in runs:
        want = CHECKS if variant == "baseline" else MUTANTS[variant][2]
        ok &= {row["check"] for row in rows} == set(want)
        for row in rows:
            refused = not row["ok"]
            print(json.dumps({"variant": variant, "refused": refused, **row}),
                  flush=True)
            ok &= refused == (variant != "baseline")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
