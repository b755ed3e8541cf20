"""Rank functions of the port's multi-process tests (tests/test_torch_ring.py,
tests/test_torch_parallel_train.py).

Each runs in every rank of an 8-rank gloo world started by
``ray_tpu_torch.parallel.world.run_world``, computes every case of its test
module on the port, and returns plain numpy results; the test process
compares them with the JAX package's. This module imports no JAX: the ranks
are forked from a server that has only torch and the port loaded.
"""

from __future__ import annotations

import contextlib
import dataclasses
import fcntl
import os
import tempfile

import numpy as np
import torch

from ray_tpu_torch.interop import params_from_numpy, shard_params, shard_state
from ray_tpu_torch.models import config as C
from ray_tpu_torch.models import training as TR
from ray_tpu_torch.models import transformer as T
from ray_tpu_torch.parallel.mesh import (BATCH_AXES, MeshSpec, axis_index,
                                         axis_size)
from ray_tpu_torch.parallel.ring import (ring_attention,
                                         ring_backward_virtual,
                                         ring_forward_virtual)

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


def _refused(fn) -> str:
    try:
        fn()
    except NotImplementedError as e:
        return f"NotImplementedError: {e}"
    except Exception as e:  # reported, so the test shows what was raised
        return f"{type(e).__name__}: {e}"
    return "ran"


def ring_rank(rank: int, cases, shape, seed: int):
    """Every ring case on this rank: the ring's output and dQ/dK/dV shards
    (autograd through ``ring_attention``), the in-process ring's result for
    the same rows, and the refusal of a head-split mesh."""
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
    mesh = MeshSpec(sequence=2, tensor=2, fsdp=2).build("cpu")
    x = torch.zeros(1, 4, 2, 8)
    out["refuse_heads"] = _refused(lambda: ring_attention(x, x, x, mesh))
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
    forward on a mesh, and each refusal. Rank 0's results are compared."""
    out = {"train": {}, "refused": {}}
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

    tx = TR.make_optimizer(1e-3)
    gen = torch.Generator().manual_seed(0)
    toks = torch.zeros(8, 8, dtype=torch.int32)
    for axis in ("tensor", "pipeline", "expert"):
        m = MeshSpec(fsdp=4, **{axis: 2}).build("cpu")
        out["refused"][axis] = [
            _refused(lambda: T.forward(params, toks, dense, m)),
            _refused(lambda: TR.make_train_step(dense, tx, m)),
            _refused(lambda: TR.init_train_state(gen, dense, tx, m)),
            _refused(lambda: TR.make_eval_step(dense, m))]
    m = MeshSpec(fsdp=4, sequence=2).build("cpu")
    out["refused"]["moe_sequence"] = [
        _refused(lambda: TR.make_train_step(moe, tx, m)),
        _refused(lambda: TR.init_train_state(gen, moe, tx, m))]
    from ray_tpu_torch.models.engine import InferenceEngine

    plain = T.init_params(gen, dense, device="cpu")
    out["refused"]["engine"] = [_refused(lambda: InferenceEngine(
        plain, dense, mesh=mesh, device="cpu"))]
    return out if rank == 0 else None
