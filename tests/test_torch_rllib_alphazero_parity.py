"""AlphaZero's learner in the port against the JAX package's, on the CPU,
from the seed alone (both start from _init_net on
np.random.default_rng(seed)): the same params bit for bit; the loss (policy
cross-entropy + value MSE + L2 over every "w" leaf, the heads' wp and wv
included) and grads within 1e-5 relative against the reference's loss
closure under jax.value_and_grad; the params after one update by
chip_smoke.adam_first_step_bound. The game, the numpy net and MCTS are
copies of the reference's: the same search from the same weights and
generator gives the same visit counts."""

import jax
import numpy as np
import torch
from torch_port_util import one_torch_thread  # noqa: F401 (fixture)
from torch_rllib_parity import (check_grads, check_rel, check_step,
                                closure)

from ray_tpu.rllib import alpha_zero as jaz
from ray_tpu_torch.rllib import alpha_zero as taz


def az_batch(n=96, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 18)).astype(np.float32),
            rng.dirichlet(np.ones(9), size=n).astype(np.float32),
            rng.choice([-1.0, 0.0, 1.0], n).astype(np.float32))


def test_update_matches_reference_from_the_seed():
    lr = 1e-2
    j = jaz.AlphaZeroLearner(18, 9, hiddens=(32, 32), lr=lr, seed=7)
    t = taz.AlphaZeroLearner(18, 9, hiddens=(32, 32), lr=lr, seed=7,
                             device="cpu")
    wj, wt = j.get_weights(), t.get_weights()
    assert set(wj) == set(wt)
    for k in wj:
        np.testing.assert_array_equal(wt[k], wj[k])
    obs, pi, z = az_batch()
    loss_fn = closure(j._update, "loss_fn")
    (loss, (pl, vl)), g_r = jax.value_and_grad(loss_fn, has_aux=True)(
        j._state[0], obs, pi, z)
    metrics, g = t.train_step(*map(torch.from_numpy, (obs, pi, z)))
    worst = {}
    check_rel(worst, "total_loss", metrics["total_loss"], loss)
    check_rel(worst, "policy_loss", metrics["policy_loss"], pl)
    check_rel(worst, "value_loss", metrics["value_loss"], vl)
    check_grads(worst, "net", g, g_r)
    out = j.update(obs, pi, z)
    check_rel(worst, "update_total_loss", metrics["total_loss"],
              out["total_loss"])
    new_t = {k: v for k, v in t.get_weights().items()
             if k != "__n_hidden__"}
    new_j = {k: v for k, v in j.get_weights().items()
             if k != "__n_hidden__"}
    check_step(worst, "net", new_t, new_j, g, g_r, lr)
    print("alphazero largest errors:", worst)


def test_mcts_copy_searches_like_the_reference():
    w = jaz._init_net(np.random.default_rng(0), 18, 9, (32,))
    assert all(np.array_equal(w[k], taz._init_net(
        np.random.default_rng(0), 18, 9, (32,))[k]) for k in w)
    s = taz.TicTacToe.step(taz.TicTacToe.initial(), 4)
    a = jaz.MCTS(jaz.TicTacToe, w, sims=48,
                 rng=np.random.default_rng(5)).policy(s)
    b = taz.MCTS(taz.TicTacToe, w, sims=48,
                 rng=np.random.default_rng(5)).policy(s)
    np.testing.assert_array_equal(a, b)
