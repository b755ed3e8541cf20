"""R2D2's learner in the port against the JAX package's, on the CPU: the
sequence loss (the reference's loss closure under jax.value_and_grad)
without burn-in, with burn-in, and with episode resets inside the
sequences, from carried params and a target net apart from them; loss and
grads within 1e-5 relative, the params after one Adam step by
chip_smoke.adam_first_step_bound. The GRU unroll and the rollout worker's
copy of the carry are checked beside them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import one_torch_thread  # noqa: F401 (fixture)
from torch_rllib_parity import (check_grads, check_rel, check_step,
                                closure, j_tree, np_tree)

from ray_tpu.rllib import r2d2 as jr2d2
from ray_tpu_torch.rllib import r2d2 as tr2d2
from ray_tpu_torch.rllib.models import params_from_numpy

OBS, ACTS, H = 5, 3, 16


def seq_batch(B, T, seed, resets: bool):
    rng = np.random.default_rng(seed)
    reset = (rng.random((B, T)) < 0.15) if resets else \
        np.zeros((B, T), np.bool_)
    return {"obs": rng.normal(size=(B, T, OBS)).astype(np.float32),
            "actions": rng.integers(0, ACTS, (B, T)),
            "rewards": rng.normal(size=(B, T)).astype(np.float32),
            "dones": rng.random((B, T)) < 0.1,
            "reset": reset,
            "h0": (0.5 * rng.normal(size=(B, H))).astype(np.float32)}


@pytest.mark.parametrize("burn_in,resets", [(0, False), (4, False),
                                            (4, True)])
def test_sequence_loss_and_step_match_reference(burn_in, resets):
    lr = 3e-3
    j = jr2d2.R2D2Learner(OBS, ACTS, lr=lr, gamma=0.97, burn_in=burn_in,
                          hidden=H, seed=3)
    t = tr2d2.R2D2Learner(OBS, ACTS, lr=lr, gamma=0.97, burn_in=burn_in,
                          hidden=H, device="cpu")
    w = np_tree(j.params)
    t.set_weights(w)
    # a target net apart from the online one
    rng = np.random.default_rng(4)
    tgt = {k: v + 0.1 * rng.normal(size=v.shape).astype(np.float32)
           for k, v in w.items()}
    j.target_params = j_tree(tgt)
    t.target_params = params_from_numpy(tgt, "cpu")
    batch = seq_batch(8, burn_in + 12, 5, resets)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_fn = closure(j._train_step, "loss_fn")
    loss_r, g_r = jax.value_and_grad(loss_fn)(j.params, j.target_params, jb)
    loss, g = t.train_step(t._batch(batch))
    worst = {}
    check_rel(worst, "loss", loss, loss_r)
    check_grads(worst, "gru", g, g_r)
    out = j.update(batch)
    check_rel(worst, "update_loss", loss, out["loss"])
    check_step(worst, "gru", t.get_weights(), j.get_weights(), g, g_r, lr)
    print(f"burn_in={burn_in} resets={resets} largest errors:", worst)


def test_burn_in_carries_no_gradient():
    """The burn-in prefix reaches the loss only through the carry, which
    is cut from the graph: grads with burn-in equal those of the same
    train segment started from the burnt-in carry."""
    t = tr2d2.R2D2Learner(OBS, ACTS, lr=1e-3, gamma=0.97, burn_in=4,
                          hidden=H, device="cpu")
    b = t._batch(seq_batch(4, 16, 6, False))
    start = {k: v.clone() for k, v in t.params.items()}
    _, g = t.train_step(dict(b))
    with torch.no_grad():
        from ray_tpu_torch.rllib.catalog import gru_unroll
        _, _, h = gru_unroll(start, b["obs"][:, :4].transpose(0, 1),
                             b["h0"], b["reset"][:, :4].transpose(0, 1))
    t2 = tr2d2.R2D2Learner(OBS, ACTS, lr=1e-3, gamma=0.97, burn_in=0,
                           hidden=H, device="cpu")
    t2.params = start
    t2.target_params = t.target_params
    cut = {k: v[:, 4:] for k, v in b.items() if k != "h0"}
    cut["h0"] = h
    _, g2 = t2.train_step(cut)
    for k in g:
        torch.testing.assert_close(g[k], g2[k], rtol=1e-6, atol=1e-7)


def test_worker_carry_is_a_copy():
    """The worker keeps its own copy of the GRU carry, so clearing it at
    an episode's end leaves the stored sequences' h0 untouched."""
    w = tr2d2.R2D2RolloutWorker("CartPole-v1", 4, seq_len=30, burn_in=2,
                                hidden=8, seed=0)
    first = w.sample_sequences(1.0)
    h0s = [s["h0"].copy() for s in first]
    second = w.sample_sequences(1.0)
    for s, h in zip(first, h0s):
        np.testing.assert_array_equal(s["h0"], h)
    assert any(s["reset"].any() for s in first + second)
    assert not np.shares_memory(w._h, second[0]["h0"])
