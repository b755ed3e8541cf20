"""Driver ``train``: the program's train step in ``TorchTrainer`` workers,
fed by a Ray Data shard through ``iter_torch_batches(device=...)``, as a
Ray Train user writes it.

Set-up makes the packed rows from the seed, starts the runtime and the
trainer; the worker makes the weights on its card from the seed, builds
the train state and the step, and drives them through the cell's first
``check_steps`` steps through the same loop and feed as the window. It
reads from them what the check compares: each step's loss, the first
gradient as the optimizer's first moment holds it, the weights' change
after the last of them. Then the window: steps until ``--seconds`` have
passed, each timed on the host clock and synchronised by reading its loss
(as a user's loop reports it), with the wait for each batch as its own
span. Once the window has closed the worker reports, besides, the
forbidden modules its process holds. After the runtime is down, the plain
reference follows the same first steps from the same weights and rows.
"""

from __future__ import annotations

import math
import tempfile
import time
from typing import Dict, List

import numpy as np

from benchmark import traffic
from benchmark.harness import Context, port_config, wait_device_free


def _leaf(tree: dict, name: str):
    if name.startswith("layers/"):
        return tree["layers"][name.split("/", 1)[1]]
    return tree[name]


def _sq_norm(x) -> float:
    """Sum of squares in fp32, a leading slice at a time (no fp32 copy of
    a whole stacked leaf)."""
    import torch

    if x.dim() > 2:
        return sum(_sq_norm(x[i]) for i in range(x.shape[0]))
    return float(torch.sum(x.float() ** 2))


def train_loop(config: dict) -> None:
    """The loop in each worker (by reference,
    ``benchmark.drivers.train.train_loop``)."""
    import torch

    from benchmark import harness
    from benchmark import trace as TRC
    from benchmark import weights
    from ray_tpu_torch import train
    from ray_tpu_torch.models import training as TR

    dev = config["device"]
    cfg_d, cell, seed = config["config"], config["cell"], config["seed"]
    tcfg = config["tcfg"]
    opt = cell["optimizer"]
    mu_dtype = {"bfloat16": torch.bfloat16, None: None}[opt["mu_dtype"]]
    tx = TR.make_optimizer(opt["learning_rate"],
                           weight_decay=opt["weight_decay"], b1=opt["b1"],
                           b2=opt["b2"], grad_clip=opt["grad_clip"],
                           mu_dtype=mu_dtype)
    params = weights.make_params(cfg_d, seed, dev)
    state = {"step": torch.zeros((), dtype=torch.int32, device=dev),
             "params": params, "opt_state": tx.init(params)}
    del params
    step_fn = TR.make_train_step(tcfg, tx)
    fault = config.get("fault")
    if fault == "jax":  # a stub of the forbidden name, in the worker
        import sys
        import types

        sys.modules["jax"] = types.ModuleType("jax")
    if fault == "unchanged":  # planted by the harness's tests only
        tx.step_ = lambda grads, st, params, g_norm=None: g_norm
    batches = iter(train.get_dataset_shard("train").iter_torch_batches(
        batch_size=cell["batch_rows"], device=dev))
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)

    def one_step():
        t0 = time.monotonic()
        batch = next(batches)
        t1 = time.monotonic()
        toks = batch["tokens"]
        if fault == "half":
            toks = toks[: toks.shape[0] // 2]
        _, m = step_fn(state, {"inputs": toks[:, :-1],
                               "targets": toks[:, 1:]})
        loss = m["loss"].item()
        return {"t0": t0, "wait_s": t1 - t0, "t1": time.monotonic(),
                "loss": loss, "grad_norm": float(m["grad_norm"]),
                "ids": batch["id"].tolist(), "tokens": int(toks.numel()
                                                           - toks.shape[0])}

    check: Dict[str, object] = {"loss": [], "ids": []}
    check_s = 0.0
    names = weights.leaf_names(cfg_d)
    for i in range(cell["check_steps"]):
        rec = one_step()
        check["loss"].append(rec["loss"])
        check["ids"].append(rec["ids"])
        t = time.monotonic()
        if i == 0:
            check["grad_norm"] = rec["grad_norm"]
            one_m_b1 = torch.tensor(1 - opt["b1"],
                                    dtype=mu_dtype or torch.float32).item()
            mu = state["opt_state"]["mu"]
            check["grad"] = {n: math.sqrt(_sq_norm(_leaf(mu, n))) / one_m_b1
                             for n in names}
        check_s += time.monotonic() - t
    t = time.monotonic()
    change = {}
    with torch.no_grad():
        for n in names:
            start = weights.make_leaf(cfg_d, seed, n, dev)
            now = _leaf(state["params"], n)
            change[n] = math.sqrt(sum(
                _sq_norm(now[j] - start[j]) for j in range(now.shape[0]))
                if now.dim() > 1 and n.startswith("layers/")
                else _sq_norm(now - start))
            del start
    check["change"] = change
    sync()
    check_s += time.monotonic() - t

    steps: List[dict] = []
    window = TRC.Window(config["trace"])
    exhausted = False
    with window:
        w0 = time.monotonic()
        while True:
            try:
                rec = one_step()
            except StopIteration:
                exhausted = True
                break
            steps.append(rec)
            if rec["t1"] - w0 >= config["seconds"]:
                break
        w1 = time.monotonic()
    mem = (torch.cuda.max_memory_allocated() if dev == "cuda" else 0)
    train.report({
        "window": [w0, w1], "check_s": check_s, "exhausted": exhausted,
        "steps": [{k: r[k] for k in ("t0", "t1", "wait_s", "loss",
                                     "tokens")} for r in steps],
        "check": check, "trace": window.summary(),
        "memory_peak_bytes": int(mem),
        "forbidden": harness.forbidden_modules(),
        "device": (torch.cuda.get_device_name(0) if dev == "cuda"
                   else "cpu")})


def _rows_needed(ctx: Context) -> int:
    c = ctx.cell
    steps = c["check_steps"] + int(math.ceil(ctx.seconds
                                             * c["max_steps_per_s"])) + 2
    return steps * c["batch_rows"]


def run(ctx: Context) -> dict:
    import ray_tpu_torch as rt
    from ray_tpu_torch import data, train

    c, cfg = ctx.cell, ctx.config
    mix = ctx.mix()
    n_rows = _rows_needed(ctx)
    rows = traffic.train_rows(mix, cfg["vocab_size"], ctx.seed, n_rows)
    ids = np.arange(n_rows, dtype=np.int64)
    per = max(c["batch_rows"], n_rows // 8)
    blocks = [{"id": ids[i:i + per], "tokens": rows[i:i + per]}
              for i in range(0, n_rows, per)]
    loop_cfg = {"config": cfg, "cell": c, "seed": ctx.seed,
                "seconds": ctx.seconds, "trace": ctx.trace,
                "device": ctx.device, "fault": ctx.fault,
                "tcfg": port_config(cfg, c)}
    gpu = ctx.device == "cuda"
    with tempfile.TemporaryDirectory(prefix="bench_train_") as tmp:
        rt.init(num_cpus=max(4, ctx.chips + 2),
                num_gpus=ctx.chips if gpu else 0,
                object_store_memory=c["object_store_bytes"],
                log_to_driver=False)
        try:
            result = train.TorchTrainer(
                train_loop, train_loop_config=loop_cfg,
                scaling_config=train.ScalingConfig(num_workers=ctx.chips,
                                                   use_gpu=gpu),
                run_config=train.RunConfig(name="bench", storage_path=tmp),
                datasets={"train": data.from_numpy(blocks)}).fit()
        finally:
            rt.shutdown()
    if result.error is not None:
        raise RuntimeError(f"the trainer failed: {result.error!r}")
    got = result.metrics_history[-1]
    w0, w1 = got["window"]
    steps = got["steps"]
    window_s = w1 - w0
    tokens = sum(s["tokens"] for s in steps) * ctx.chips
    return {
        "kind": "train", "rows": rows, "got": got, "steps": steps,
        "window_s": window_s, "attempted": len(steps),
        "failed": 0 if not got["exhausted"] else 1,
        "setup_s": w0 - ctx.t_start - got["check_s"],
        "end_to_end": {"train_tokens_per_s": tokens / window_s},
        "memory_peak_bytes": got["memory_peak_bytes"],
        "forbidden": {"worker": got["forbidden"]},
        "device_kind": got["device"], "trace": got["trace"]}


# ---- the check --------------------------------------------------------------

def _gaps(prog: Dict[str, float], ref: Dict[str, float], leaves) -> float:
    """Worst leaf: |program - reference| against the reference's norm of
    that leaf or of the median leaf, whichever is larger."""
    med = float(np.median(list(ref.values())))
    return max(abs(prog[n] - ref[n]) / max(ref[n], med) for n in leaves)


def readings(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers the check compares. A leaf whose reference gradient is
    under a thousandth of the median leaf's moves under Adam by rounding
    alone; it is left out of the change (none is, in these models)."""
    med = float(np.median(list(ref["grad"].values())))
    moved = [n for n, g in ref["grad"].items() if g >= 1e-3 * med]
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"]))
    return {"loss_gap": loss,
            "grad_gap": _gaps(prog["grad"], ref["grad"], ref["grad"]),
            "change_gap": _gaps(prog["change"], ref["change"], moved)}


def reference_run(ctx: Context, res: dict, fp8: bool = False,
                  half: bool = False) -> dict:
    """The plain reference over the same first steps, on the rows the
    program's check steps took (by id), from the same seed's weights."""
    import torch

    from benchmark import weights
    from benchmark.configs import mistral_family as REF

    dev = ctx.device
    wait_device_free(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = res["rows"]
    batches = []
    for ids in res["got"]["check"]["ids"]:
        t = torch.from_numpy(rows[np.asarray(ids)]).to(dev)
        if half:
            t = t[: t.shape[0] // 2]
        batches.append((t[:, :-1], t[:, 1:]))
    params = weights.make_params(ctx.config, ctx.seed, dev)
    out = REF.train_steps(
        ctx.config, params, batches, ctx.cell["optimizer"],
        lambda n: weights.make_leaf(ctx.config, ctx.seed, n, dev),
        compute=weights.DTYPES[ctx.config["torch_dtype"]], fp8=fp8,
        attn_block=ctx.cell.get("ref_attn_block", 1024))
    del params
    if dev == "cuda":
        torch.cuda.empty_cache()
    return out


def check(ctx: Context, res: dict) -> dict:
    """-> {"numbers": {name: [reading, limit]} for the cell's limits,
    "extra": the other readings}; with ``ctx.control`` also the control's
    readings and those of a half batch in the reference's place."""
    ref = reference_run(ctx, res)
    got = res["got"]["check"]
    read = readings(got, ref)
    limits = ctx.cell["limits"]
    out = {"numbers": {k: [read[k], limits[k]] for k in limits},
           "extra": {**{k: v for k, v in read.items() if k not in limits},
                     "ref_loss": ref["loss"], "prog_loss": got["loss"],
                     "ref_grad_norm": ref["grad_norm"],
                     "prog_grad_norm": got["grad_norm"]}}
    if ctx.control:
        ctl = reference_run(ctx, res, fp8=True)
        out["control"] = readings(ctl, ref)
        half = reference_run(ctx, res, half=True)
        out["fault_half"] = readings(half, ref)
    return out
