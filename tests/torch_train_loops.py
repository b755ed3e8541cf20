"""Train loops of tests/test_torch_train_parity.py and
tests/test_torch_data_train_parity.py that run in the port's TorchTrainer
workers. This module imports no JAX, so the workers, which
import it to unpickle a loop, load only torch and the port."""

import dataclasses
import os

import numpy as np
import torch

STEPS, FAIL_AFTER = 5, 3


def torch_loop(config):
    """The parity scenario in a TorchTrainer worker: steps up to STEPS
    from ``params`` or the checkpoint, each step's state reported as a
    checkpoint, a failure after FAIL_AFTER's report unless ``marker``
    exists (None: no failure)."""
    from ray_tpu_torch import train
    from ray_tpu_torch.interop import params_from_numpy
    from ray_tpu_torch.models import config as C
    from ray_tpu_torch.models import training as TR

    torch.set_num_threads(1)
    cfg = C.tiny_config(dtype=torch.float32, param_dtype=torch.float32)
    tx = TR.make_optimizer(1e-3)
    ckpt = train.get_checkpoint()
    if ckpt is None:
        params = params_from_numpy(config["params"], cfg, "cpu")
        state = {"step": torch.zeros((), dtype=torch.int32),
                 "params": params, "opt_state": tx.init(params)}
    else:
        state = ckpt.to_pytree()[0]
    step = TR.make_train_step(cfg, tx)
    batch = {k: torch.from_numpy(v) for k, v in config["batch"].items()}
    marker = config["marker"]
    for i in range(int(state["step"]) + 1, STEPS + 1):
        _, m = step(state, batch)
        train.report({"step": i, "loss": m["loss"].item(),
                      "grad_norm": m["grad_norm"].item()},
                     checkpoint=train.Checkpoint.from_pytree(state))
        if i == FAIL_AFTER and marker and not os.path.exists(marker):
            open(marker, "w").close()
            raise RuntimeError("worker down")


def mlm_loop(config):
    """tests/test_encoder.py's BERT-style loop on the port: each worker
    trains the bidirectional tiny encoder with Adam on its own masked
    batch."""
    from ray_tpu_torch import train
    from ray_tpu_torch.interop import params_from_numpy
    from ray_tpu_torch.models import config as C
    from ray_tpu_torch.models import training as TR
    from ray_tpu_torch.models.mlm import mask_tokens
    from ray_tpu_torch.models.transformer import loss_fn

    torch.set_num_threads(1)
    cfg = dataclasses.replace(
        C.tiny_config(dtype=torch.float32, param_dtype=torch.float32),
        causal=False, remat=False)
    params = params_from_numpy(config["params"], cfg, "cpu")
    tx = _adam(TR)
    opt_state = tx.init(params)
    leaves = TR.tree_leaves(params)
    rng = np.random.default_rng(train.get_world_rank())
    toks = rng.integers(4, cfg.vocab_size, size=(8, 32))
    batch = {k: torch.from_numpy(v) for k, v in mask_tokens(
        toks, mask_id=3, vocab_size=cfg.vocab_size, rng=rng).items()}
    for _ in range(10):
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = loss_fn(params, batch, cfg)
        grads = torch.autograd.grad(loss, leaves)
        for p in leaves:
            p.requires_grad_(False)
        tx.step_(TR._unflatten(params, list(grads)), opt_state, params)
        train.report({"mlm_loss": loss.item(),
                      "rank": train.get_world_rank()})


def _adam(TR):
    """optax.adam(1e-3) as the port's chain: no decay, no clip."""
    return TR.make_optimizer(1e-3, weight_decay=0.0, b2=0.999,
                             grad_clip=float("inf"))


def data_loop(config):
    """Two workers on the backend's group: the state on make_mesh(data=2),
    two steps on the global batch."""
    from ray_tpu_torch import train
    from ray_tpu_torch.interop import params_from_numpy, shard_state
    from ray_tpu_torch.models import config as C
    from ray_tpu_torch.models import training as TR
    from ray_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    cfg = C.tiny_config(dtype=torch.float32, param_dtype=torch.float32)
    tx = TR.make_optimizer(1e-3)
    mesh = make_mesh(data=2, device="cpu")
    params = params_from_numpy(config["params"], cfg, "cpu")
    state = shard_state(mesh, {"step": torch.zeros((), dtype=torch.int32),
                               "params": params,
                               "opt_state": tx.init(params)}, cfg, tx)
    step = TR.make_train_step(cfg, tx, mesh)
    batch = {k: torch.from_numpy(v) for k, v in config["batch"].items()}
    for i in range(2):
        _, m = step(state, batch)
        train.report({"loss": m["loss"].item(),
                      "grad_norm": m["grad_norm"].item(),
                      "mesh": dict(zip(mesh.mesh_dim_names,
                                       mesh.mesh.shape))})


def data_fed_loop(config):
    """The tiny fp32 train step fed by the worker's dataset shard through
    ``iter_torch_batches(device="cpu")``: a step on each of the first
    ``steps`` batches, then the rest of the epoch drained; reports the
    losses and every id in the order the batches brought them."""
    from ray_tpu_torch import train
    from ray_tpu_torch.interop import params_from_numpy
    from ray_tpu_torch.models import config as C
    from ray_tpu_torch.models import training as TR

    torch.set_num_threads(1)
    cfg = C.tiny_config(dtype=torch.float32, param_dtype=torch.float32)
    tx = TR.make_optimizer(1e-3)
    params = params_from_numpy(config["params"], cfg, "cpu")
    state = {"step": torch.zeros((), dtype=torch.int32), "params": params,
             "opt_state": tx.init(params)}
    step = TR.make_train_step(cfg, tx)
    losses, ids = [], []
    shard = train.get_dataset_shard("train")
    for i, batch in enumerate(shard.iter_torch_batches(
            batch_size=config["batch_size"], device="cpu")):
        ids.extend(batch["id"].tolist())
        if i < config["steps"]:
            toks = batch["tokens"]
            _, m = step(state, {"inputs": toks[:, :-1],
                                "targets": toks[:, 1:]})
            losses.append(m["loss"].item())
    train.report({"losses": losses, "ids": ids})
