"""Rank functions of the port's multi-process tests (tests/test_torch_ring.py,
tests/test_torch_parallel_train.py, tests/test_torch_tensor_parallel.py,
tests/test_torch_pipeline.py, tests/test_torch_moe_parallel.py,
tests/test_torch_engine_mesh_serve.py, tests/test_torch_train_checkpoint.py).

Each runs in every rank of a gloo world (8 ranks; 2 for the checkpoint's)
started by ``ray_tpu_torch.parallel.world.run_world``, computes every case
of its test module on the port, and returns plain numpy results; the test
process compares them with the JAX package's. This module imports no JAX: the ranks
are forked from a server that has only torch and the port loaded.
"""

from __future__ import annotations

import contextlib
import dataclasses
import fcntl
import os
import signal
import tempfile
import threading
import time

import numpy as np
import torch

from ray_tpu_torch.interop import params_from_numpy, shard_params, shard_state
from ray_tpu_torch.models import config as C
from ray_tpu_torch.models import moe as M
from ray_tpu_torch.models import training as TR
from ray_tpu_torch.models import transformer as T
from ray_tpu_torch.models.engine import InferenceEngine
from ray_tpu_torch.parallel.mesh import (BATCH_AXES, MeshSpec, VirtualMesh,
                                         axis_index, axis_size)
from ray_tpu_torch.parallel.pipeline import pipeline_scan
from ray_tpu_torch.parallel.ring import (ring_attention,
                                         ring_backward_virtual,
                                         ring_forward_virtual)
from ray_tpu_torch.parallel.world import World

@contextlib.contextmanager
def one_world_at_a_time():
    """Holds a host-wide lock while a test module's worlds run, so that the
    worlds of modules running in parallel workers take turns: two 8-rank
    worlds at once made the runtime's timing-bound tests in the other
    workers fail (tests/test_recovery.py's head-restart test)."""
    path = os.path.join(tempfile.gettempdir(), "ray_tpu_torch_worlds.lock")
    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def qkv(shape, seed: int):
    """The ring cases' q, k, v and the output cotangent g, fp32 numpy."""
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(4)]


def _coords(mesh):
    """(this rank's batch shard, batch shards, sequence chunk, chunks)."""
    b, nb = 0, 1
    for a in BATCH_AXES:
        b, nb = b * axis_size(mesh, a) + axis_index(mesh, a), \
            nb * axis_size(mesh, a)
    return b, nb, axis_index(mesh, "sequence"), axis_size(mesh, "sequence")


def _local(x: np.ndarray, coords) -> torch.Tensor:
    b, nb, s, ns = coords
    rows, t = x.shape[0] // nb, x.shape[1] // ns
    return torch.from_numpy(np.ascontiguousarray(
        x[b * rows:(b + 1) * rows, s * t:(s + 1) * t]))


def _to3(x):
    b, t, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, t, d).contiguous()


def _from3(x3, b):
    bh, t, d = x3.shape
    return x3.reshape(b, bh // b, t, d).transpose(1, 2)


def ring_rank(rank: int, cases, shape, seed: int):
    """Every ring case on this rank: the ring's output and dQ/dK/dV shards
    (autograd through ``ring_attention``), the in-process ring's result for
    the same rows."""
    out = {}
    q, k, v, g = qkv(shape, seed)
    for name, sizes, causal in cases:
        mesh = MeshSpec(**sizes).build("cpu")
        co = _coords(mesh)
        ql, kl, vl, gl = (_local(x, co).requires_grad_(True)
                          for x in (q, k, v, g))
        o = ring_attention(ql, kl, vl, mesh, causal=causal)
        dq, dk, dv = torch.autograd.grad(o, (ql, kl, vl), gl.detach())
        # the in-process ring on this rank's batch rows, all chunks
        b, nb, s, ns = co
        rows = shape[0] // nb
        chunks = [[_to3(_local(x, (b, nb, c, ns))) for c in range(ns)]
                  for x in (q, k, v, g)]
        scale = shape[-1] ** -0.5
        os_, lses = ring_forward_virtual(*chunks[:3], scale=scale,
                                         causal=causal)
        vdq, vdk, vdv = ring_backward_virtual(*chunks[:3], os_, lses,
                                              chunks[3], scale=scale,
                                              causal=causal)
        out[name] = {
            "coords": co,
            "o": o.detach().numpy(), "dq": dq.numpy(), "dk": dk.numpy(),
            "dv": dv.numpy(),
            "virtual": {n: _from3(x[s], rows).numpy() for n, x in
                        (("o", os_), ("dq", vdq), ("dk", vdk),
                         ("dv", vdv))}}
    return out


def _gathered(tree):
    """A DTensor tree's full values as numpy (every rank joins)."""
    return {k: (_gathered(v) if isinstance(v, dict) else
                v.full_tensor().detach().numpy()) for k, v in tree.items()}


def _train(cfg, sizes, params_np, batch_np, steps: int, lr: float):
    mesh = MeshSpec(**sizes).build("cpu")
    tx = TR.make_optimizer(lr)
    params = params_from_numpy(params_np, cfg, "cpu")
    state = shard_state(mesh, {"step": torch.zeros((), dtype=torch.int32),
                               "params": params,
                               "opt_state": tx.init(params)}, cfg, tx)
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    step = TR.make_train_step(cfg, tx, mesh)
    metrics = []
    for _ in range(steps):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "params": _gathered(state["params"])}


def train_rank(rank: int, spec: dict):
    """Every case of the meshed train-step tests on this rank: two steps per
    mesh from the reference's params and batch, the eval step and the
    forward on a mesh. Rank 0's results are compared."""
    out = {"train": {}}
    dense = C.tiny_config(**spec["dense_cfg"])
    for name, sizes, remat in spec["dense_meshes"]:
        cfg = dataclasses.replace(dense, **remat)
        out["train"][name] = _train(cfg, sizes, spec["dense_params"],
                                    spec["batch"], spec["steps"], spec["lr"])
    moe = C.tiny_config(**spec["moe_cfg"])
    out["train"]["moe_fsdp8"] = _train(moe, dict(fsdp=8), spec["moe_params"],
                                       spec["batch"], spec["steps"],
                                       spec["lr"])

    mesh = MeshSpec(data=2, fsdp=2, sequence=2).build("cpu")
    params = shard_params(mesh, spec["dense_params"], dense)
    batch = {k: torch.from_numpy(v) for k, v in spec["eval_batch"].items()}
    out["eval"] = {k: float(v) for k, v in
                   TR.make_eval_step(dense, mesh)(params, batch).items()}
    logits = T.forward(params, batch["inputs"], dense, mesh)
    out["forward"] = {"placements": [str(p) for p in logits.placements],
                      "logits": logits.full_tensor().detach().numpy()}

    return out if rank == 0 else None


def _eval_and_forward(cfg, sizes, params_np, eval_np):
    """The masked eval step's metrics and the forward's DTensor logits
    (placements and full values) on one mesh."""
    mesh = MeshSpec(**sizes).build("cpu")
    params = shard_params(mesh, params_np, cfg)
    batch = {k: torch.from_numpy(v) for k, v in eval_np.items()}
    metrics = {k: float(v) for k, v in
               TR.make_eval_step(cfg, mesh)(params, batch).items()}
    logits = T.forward(params, batch["inputs"], cfg, mesh)
    return {"eval": metrics,
            "placements": [str(p) for p in logits.placements],
            "logits": logits.full_tensor().detach().numpy()}


def _rows(x: np.ndarray, mesh) -> torch.Tensor:
    """This rank's batch rows of a global [B, ...] array (no sequence
    split)."""
    b, nb, _, _ = _coords(mesh)
    n = x.shape[0] // nb
    return torch.from_numpy(np.ascontiguousarray(x[b * n:(b + 1) * n]))


def _leaves(tree):
    return TR.tree_leaves(tree)


def _requiring_grad(tree):
    return TR.tree_map(lambda w: w.detach().clone().requires_grad_(True),
                       tree)


def _tensor_step(ranks, inputs, targets, cfg, mesh, wrt):
    """Logit parts, loss and gradients of the per-rank driver
    (``transformer._model``, ``_nll``) on plain weights."""
    parts, _ = T._model(ranks, inputs, cfg, mesh)
    loss = T._nll(parts, targets, mesh).mean()
    grads = torch.autograd.grad(loss, _leaves(wrt))
    return parts, loss, grads


def _virtual_vs_gloo_tensor(cfg, params_np, batch_np):
    """On data=4 x tensor=2, this rank's real tensor-parallel step (plain
    weights of its tensor rank, copy/reduce over the tensor group) and the
    virtual one (both tensor ranks in this process, the reductions sums)
    on the same rows: whether logits, loss and gradients agree bit for
    bit."""
    mesh = MeshSpec(data=4, tensor=2).build("cpu")
    r = axis_index(mesh, "tensor")
    full = params_from_numpy(params_np, cfg, "cpu")
    inputs, targets = (_rows(batch_np[k], mesh) for k in ("inputs",
                                                          "targets"))
    mine = _requiring_grad(T.tensor_ranks(full, cfg, 2)[r])
    parts, loss, grads = _tensor_step([mine], inputs, targets, cfg, mesh,
                                      mine)
    whole = _requiring_grad(full)
    vparts, vloss, vgrads = _tensor_step(T.tensor_ranks(whole, cfg, 2),
                                         inputs, targets, cfg, None, whole)
    vgrads = _leaves(T.tensor_ranks(
        TR._unflatten(whole, list(vgrads)), cfg, 2)[r])
    return {"logits": torch.equal(parts[0], vparts[r]),
            "loss": torch.equal(loss, vloss),
            "grads": all(torch.equal(a, b) for a, b in zip(grads, vgrads))}


def _engine_tokens(cfg, sizes, params_np, prompts, max_new):
    """Greedy tokens of the tensor-parallel engine, driven by step() with
    the same submissions on every rank."""
    mesh = MeshSpec(**sizes).build("cpu")
    params = params_from_numpy(params_np, cfg, "cpu")
    eng = InferenceEngine(params, cfg, slots=2, max_prompt_len=16,
                          max_new_tokens=max_new, mesh=mesh)
    reqs = [eng.submit(p) for p in prompts]
    for _ in range(100):
        if all(q.done.is_set() for q in reqs):
            break
        eng.step()
    try:
        eng.serve_forever()
        refused = "ran"
    except ValueError as e:
        refused = str(e)
    return {"tokens": [list(q.tokens) for q in reqs],
            "kv_heads_local": eng.cache["k"].shape[3],
            "serve_forever": refused}


def tensor_rank(rank: int, spec: dict):
    """Every case of tests/test_torch_tensor_parallel.py on this rank."""
    out = {"train": {}}
    dense = C.tiny_config()
    for name, sizes, extra in spec["train_meshes"]:
        cfg = dataclasses.replace(dense, **extra)
        out["train"][name] = _train(cfg, sizes, spec["params"][name],
                                    spec["batch"], spec["steps"], spec["lr"])
    out["eval_forward"] = _eval_and_forward(
        dense, dict(data=2, fsdp=2, tensor=2), spec["params"]["plain"],
        spec["eval_batch"])
    out["engine"] = _engine_tokens(dense, dict(data=4, tensor=2),
                                   spec["params"]["plain"], spec["prompts"],
                                   spec["max_new"])
    out["bitwise"] = _virtual_vs_gloo_tensor(dense, spec["params"]["plain"],
                                             spec["batch"])
    return out


def _scan_case(sizes, w_np, x_np, m, virtual: bool):
    """pipeline_scan of tanh(x @ w_l) over the stacked w, and its gradient
    of mean(y^2) with respect to w and x: on the mesh's pipeline axis
    (``virtual``: on a VirtualMesh of the same size in this process)."""
    mesh = MeshSpec(**sizes).build("cpu")
    stages = axis_size(mesh, "pipeline")
    w = torch.from_numpy(w_np).requires_grad_(True)
    x = torch.from_numpy(x_np).requires_grad_(True)
    run = VirtualMesh("pipeline", stages) if virtual else mesh
    y = pipeline_scan(lambda c, lp: (torch.tanh(c @ lp["w"]), None), x,
                      {"w": w}, run, m)
    gw, gx = torch.autograd.grad((y ** 2).mean(), (w, x))
    return {"y": y.detach().numpy(), "gw": gw.numpy(), "gx": gx.numpy(),
            "stage": axis_index(mesh, "pipeline"), "stages": stages}


def pipeline_rank(rank: int, spec: dict):
    """Every case of tests/test_torch_pipeline.py on this rank."""
    out = {"scan": {}, "virtual_scan": {}}
    for name, (sizes, m) in spec["scan_cases"].items():
        w, x = spec["scan"][name]
        out["scan"][name] = _scan_case(sizes, w, x, m, False)
        out["virtual_scan"][name] = _scan_case(sizes, w, x, m, True)
    cfg = C.tiny_config(**spec["cfg"])
    sizes = dict(data=2, pipeline=2, tensor=2)
    mesh = MeshSpec(**sizes).build("cpu")
    params = shard_params(mesh, spec["params"], cfg)
    tokens = torch.from_numpy(spec["tokens"])
    logits = T.forward(params, tokens, cfg, mesh)
    out["forward"] = logits.full_tensor().detach().numpy()
    # the virtual pipeline (one process, all stages) on this rank's rows,
    # against the pipelined forward's rows over gloo, bit for bit
    vmesh = MeshSpec(data=4, pipeline=2).build("cpu")
    vparams = shard_params(vmesh, spec["params"], cfg)
    rows = _rows(spec["tokens"], vmesh)
    real = T.forward(vparams, tokens, cfg, vmesh).to_local()
    with torch.no_grad():
        virt = T.forward(params_from_numpy(spec["params"], cfg, "cpu"), rows,
                         cfg, VirtualMesh("pipeline", 2))
    out["virtual_forward_equal"] = torch.equal(real.detach(), virt)
    out["train"] = {}
    for name, sizes_, extra in spec["train_meshes"]:
        out["train"][name] = _train(dataclasses.replace(cfg, **extra),
                                    sizes_, spec["params"], spec["batch"],
                                    spec["steps"], spec["lr"])
    return out


def _moe_case(sizes, cfg, lp_np, h_np):
    """moe_layer of layer weights ``lp_np`` on this rank's part of h on a
    mesh (each rank taking its experts and columns), and the virtual
    driver over the mesh's expert or sequence axis on the same part."""
    mesh = MeshSpec(**sizes).build("cpu")
    lp = {k: torch.from_numpy(v) for k, v in lp_np.items()}
    b, nb, s, ns = _coords(mesh)
    h = _local(h_np, (b, nb, s, ns))
    e, ne = axis_index(mesh, "expert"), axis_size(mesh, "expert")
    t, nt = axis_index(mesh, "tensor"), axis_size(mesh, "tensor")
    mine = {k: v if k == "router" else v.chunk(ne)[e] for k, v in lp.items()}
    mine = {k: v if k == "router" else v.chunk(nt, dim=2 if k != "w_down"
                                               else 1)[t]
            for k, v in mine.items()}
    with torch.no_grad():
        y, aux, top_i, kept = M.moe_layer(h, mine, cfg, mesh)
        out = {"coords": (b, nb, s, ns), "y": y.numpy(),
               "aux": float(aux), "top_i": top_i.numpy(),
               "kept": kept.numpy()}
        axis = "sequence" if ns > 1 else ("expert" if ne > 1 else None)
        if axis is not None and nt == 1:
            # the virtual driver on the rows of this rank's batch shard,
            # every chunk (sequence) or the whole layer (expert)
            rows = _local(h_np, (b, nb, 0, 1))
            vy, _, vtop, vkept = M.moe_layer(
                rows, lp, cfg, VirtualMesh(axis, max(ns, ne)))
            t_l = h.shape[1]
            cut = slice(s * t_l, (s + 1) * t_l)
            kk = cfg.moe_top_k
            out["virtual_equal"] = {
                "y": torch.equal(vy[:, cut], y),
                "top_i": torch.equal(vtop[:, cut], top_i),
                "kept": torch.equal(vkept[:, s * t_l * kk:(s + 1) * t_l * kk],
                                    kept)}
    return out


def moe_rank(rank: int, spec: dict):
    """Every case of tests/test_torch_moe_parallel.py on this rank."""
    cfg = C.tiny_config(**spec["cfg"])
    out = {"layer": {name: _moe_case(sizes, cfg, spec["lp"], spec["h"])
                     for name, sizes in spec["layer_meshes"].items()}}
    mesh = MeshSpec(expert=2, tensor=2, data=2).build("cpu")
    params = shard_params(mesh, spec["params"], cfg)
    logits = T.forward(params, torch.from_numpy(spec["tokens"]), cfg, mesh)
    out["forward"] = logits.full_tensor().detach().numpy()
    out["train"] = {name: _train(dataclasses.replace(cfg, **extra), sizes,
                                 spec["params"], spec["batch"],
                                 spec["steps"], spec["lr"])
                    for name, (sizes, extra) in spec["train_meshes"].items()}
    return out


# ---- serve_forever on a 2-rank tensor world (tests/test_torch_engine_mesh_serve.py)


def _served_engine(spec):
    cfg = C.tiny_config()
    mesh = MeshSpec(data=1, fsdp=1, tensor=2).build("cpu")
    params = params_from_numpy(spec["params"], cfg, "cpu")
    return InferenceEngine(params, cfg, mesh=mesh, **spec["engine"])


def serve_mesh_follower(rank: int, spec: dict):
    """Rank 1: rank 0's step plans, until rank 0 stops."""
    _served_engine(spec).follow()


def serve_mesh_leader(spec: dict, results) -> None:
    """Rank 0 of a World of 2 (this process): requests submitted at
    staggered times from a client thread under serve_forever, one
    streamed; then the follower is stopped (SIGSTOP) while a request waits
    in its prefill, and killed. Puts a dict of plain results."""
    world = World(serve_mesh_follower, 2, (spec,), device="cpu")
    out = {"follower_pids": world.pids}
    try:
        eng = _served_engine(spec).serve_forever()
        reqs = []

        def client():
            for prompt, max_new, delay in spec["requests"]:
                time.sleep(delay)
                reqs.append(eng.submit(prompt, max_new))

        t = threading.Thread(target=client)
        t.start()
        t.join(60)
        out["served"] = all(r.done.wait(60) for r in reqs)
        out["tokens"] = [list(r.tokens) for r in reqs]
        out["errors"] = [repr(r.error) for r in reqs if r.error is not None]
        prompt, max_new, _ = spec["requests"][0]
        out["streamed"] = list(eng.submit_stream(prompt, max_new))
        pid = world.pids[0]
        os.kill(pid, signal.SIGSTOP)
        waiting = eng.submit(prompt, max_new)
        time.sleep(1.0)
        out["waited_while_stopped"] = not waiting.done.is_set()
        os.kill(pid, signal.SIGKILL)
        t0 = time.monotonic()
        out["failed_after_kill"] = waiting.done.wait(60) and \
            waiting.error is not None
        out["fail_s"] = time.monotonic() - t0
        try:
            eng.submit(prompt, max_new)
            out["refused_after"] = False
        except RuntimeError:
            out["refused_after"] = True
        eng.shutdown()
    finally:
        world.shutdown()
    out["followers_alive"] = [p.is_alive() for p in world.procs]
    results.put(out)


def replica_del_reaps_followers(results) -> None:
    """A tensor_parallel=2 continuous replica on the CPU built in this
    process: its tokens, its follower's pid, and whether the follower is
    gone once ``__del__`` ran. Puts a dict."""
    from ray_tpu_torch.serve.llm import _ContinuousLLMReplica

    rep = _ContinuousLLMReplica("tiny", slots=2, max_prompt_len=8,
                                max_new_tokens=4, tensor_parallel=2,
                                device="cpu")
    out = {"tokens": rep([3, 1, 4])["token_ids"],
           "pids": rep.follower_pids()}
    procs = rep._world.procs
    rep.__del__()
    out["alive_after_del"] = [p.is_alive() for p in procs]
    out["world_left"] = torch.distributed.is_initialized()
    results.put(out)


def checkpoint_rank(rank: int, params_np: dict, directory: str):
    """tests/test_torch_train_checkpoint.py: a tiny bf16 train state from
    ``params_np`` placed on make_mesh(fsdp=2) (params and moments as
    DTensors), through ``Checkpoint.from_pytree`` on every rank (each
    DTensor gathered whole, a collective); rank 0 also writes it to
    ``directory``. -> each leaf's bits as numpy, in tree_leaves order."""
    from ray_tpu_torch.train import Checkpoint

    cfg = C.tiny_config(param_dtype=torch.bfloat16)
    tx = TR.make_optimizer(1e-3, mu_dtype=torch.bfloat16)
    mesh = MeshSpec(fsdp=2).build("cpu")
    params = params_from_numpy(params_np, cfg, "cpu")
    state = shard_state(mesh, {"step": torch.tensor(3, dtype=torch.int32),
                               "params": params,
                               "opt_state": tx.init(params)}, cfg, tx)
    sharded = [type(x).__name__ for x in TR.tree_leaves(state)]
    ckpt = Checkpoint.from_pytree(state, rank=rank)
    if rank == 0:
        ckpt.to_directory(directory)
    tree, extra = ckpt.to_pytree()
    return {"sharded": sharded, "extra": extra,
            "leaves": [x.view(torch.int16).numpy()
                       if x.dtype == torch.bfloat16 else x.numpy()
                       for x in TR.tree_leaves(tree)]}


def axis_vs_unmeshed_rank(rank: int, sizes: dict, moe: bool):
    """dryrun_multichip's train step on ``sizes``' mesh (gloo, the CPU) on
    every rank, and on rank 0 the same step unmeshed."""
    from ray_tpu_torch.entry import _dryrun_step

    dev = torch.device("cpu")
    out = {"meshed": _dryrun_step(sizes, moe, 8, 64, dev)}
    if rank == 0:
        out["unmeshed"] = _dryrun_step(sizes, moe, 8, 64, dev,
                                       unmeshed=True)
    return out
