"""The slice as a whole against the reference: a seeded shuffle of
numpy-made token blocks feeds the train step in a TorchTrainer worker
through ``streaming_split`` and ``iter_torch_batches(device="cpu")``; the
rows arrive in the order the reference's exchange functions give on the
same blocks (Arrow, in process), and each step's loss equals the JAX train
step's on those batches from the same params. Setup as
tests/test_torch_train_parity.py: ``tiny_config`` in fp32, JAX's init
carried across by ``interop.params_from_numpy``, each package's
``make_optimizer`` at lr 1e-3; tolerance fp32 2e-4."""

import jax
import jax.numpy as jnp
import numpy as np

import ray_tpu_torch
from ray_tpu.data import block as ref_block
from ray_tpu.data import executor as ref_exec
from ray_tpu.models import config as jcfg
from ray_tpu.models import training as jtrain
from ray_tpu.models import transformer as jtr
from ray_tpu_torch import data, train
from torch_port_util import deadline, one_torch_thread  # noqa: F401
from torch_train_loops import data_fed_loop

_TOL = 2e-4
_BLOCKS, _PER, _SEQ, _BATCH, _STEPS, _SEED = 6, 10, 17, 4, 4, 21


def _blocks():
    rng = np.random.default_rng(_SEED)
    return [{"id": np.arange(i * _PER, (i + 1) * _PER, dtype=np.int64),
             "tokens": rng.integers(0, 256, (_PER, _SEQ), dtype=np.int32)}
            for i in range(_BLOCKS)]


def _reference_rows(blocks):
    """The reference's seeded shuffle of the same blocks, in process: each
    input split with seed + i, each partition merged, partitions in
    order (what streaming_split deals to one consumer)."""
    tables = [ref_block.from_numpy(b) for b in blocks]
    parts = [ref_exec._split_for_partition(t, _BLOCKS, "random_shuffle",
                                           _SEED + i, None)
             for i, t in enumerate(tables)]
    rows = []
    for j in range(_BLOCKS):
        merged = ref_exec._merge_parts("random_shuffle", None, _SEED, False,
                                       *[p[j] for p in parts])
        rows.extend(ref_block.BlockAccessor(merged).iter_rows())
    return rows


def _jax_losses(params, rows):
    cfg = jcfg.tiny_config(dtype=jnp.float32, param_dtype=jnp.float32)
    tx = jtrain.make_optimizer(1e-3)
    params = jax.tree.map(jnp.asarray, params)
    state = {"step": jnp.zeros((), jnp.int32), "params": params,
             "opt_state": tx.init(params)}
    step = jtrain.make_train_step(cfg, tx)
    losses = []
    for i in range(_STEPS):
        toks = np.stack([np.asarray(r["tokens"], np.int32)
                         for r in rows[i * _BATCH:(i + 1) * _BATCH]])
        state, m = step(state, {"inputs": jnp.asarray(toks[:, :-1]),
                                "targets": jnp.asarray(toks[:, 1:])})
        losses.append(float(m["loss"]))
    return losses


@deadline(180)
def test_shuffled_dataset_feeds_the_train_step_as_the_reference(tmp_path):
    blocks = _blocks()
    cfg = jcfg.tiny_config(dtype=jnp.float32, param_dtype=jnp.float32)
    params = jax.tree.map(np.asarray,
                          jtr.init_params(jax.random.key(_SEED), cfg))
    rows = _reference_rows(blocks)
    want_losses = _jax_losses(params, rows)
    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    try:
        ds = data.from_numpy(blocks).random_shuffle(seed=_SEED)
        result = train.TorchTrainer(
            data_fed_loop,
            train_loop_config={"params": params, "batch_size": _BATCH,
                               "steps": _STEPS},
            scaling_config=train.ScalingConfig(num_workers=1),
            run_config=train.RunConfig(name="data_fed",
                                       storage_path=str(tmp_path)),
            datasets={"train": ds}).fit()
    finally:
        ray_tpu_torch.shutdown()
    assert result.error is None
    got = result.metrics
    assert got["ids"] == [r["id"] for r in rows]
    assert sorted(got["ids"]) == list(range(_BLOCKS * _PER))
    np.testing.assert_allclose(got["losses"], want_losses, rtol=_TOL,
                               atol=_TOL)
