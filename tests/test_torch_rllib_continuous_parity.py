"""SAC, TD3 and DDPG learners of the port against the JAX package's, on the
CPU: one update from the same carried state on a numpy batch, with the
reference's own noise (recomputed from its key by the same splits). Each
stage is held at the inputs the port's stage saw (the critic step at the
start, the actor step on the port's updated critics): loss metrics and
grads within 1e-5 relative against the reference's loss closures under
jax.value_and_grad; the new params (targets and SAC's temperature
included) by chip_smoke.adam_first_step_bound against the reference's
own step. Each test prints the largest errors seen."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import one_torch_thread  # noqa: F401 (fixture)
from torch_rllib_parity import (check_grads, check_rel, check_step,
                                closure, j_tree, np_tree)

from ray_tpu.rllib import sac as jsac
from ray_tpu.rllib import td3 as jtd3
from ray_tpu_torch.rllib import DDPGConfig, TD3Config
from ray_tpu_torch.rllib import sac as tsac
from ray_tpu_torch.rllib import td3 as ttd3
from ray_tpu_torch.rllib.models import params_from_numpy
from ray_tpu_torch.rllib.sample_batch import SampleBatch

OBS, ACT, HID, B = 3, 1, (32, 32), 64


def pendulum_batch(seed=0):
    rng = np.random.default_rng(seed)
    return SampleBatch({
        "obs": rng.normal(size=(B, OBS)).astype(np.float32),
        "actions": rng.uniform(-2, 2, (B, ACT)).astype(np.float32),
        "rewards": rng.normal(size=B).astype(np.float32),
        "dones": rng.random(B) < 0.2,
        "new_obs": rng.normal(size=(B, OBS)).astype(np.float32)})


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_sac_step_matches_reference():
    kw = dict(actor_lr=3e-3, critic_lr=2e-3, alpha_lr=1e-3, gamma=0.97,
              tau=0.05, action_scale=2.0, initial_alpha=0.2,
              target_entropy=-1.0, hiddens=HID)
    j = jsac.SACLearner(OBS, ACT, seed=3, **kw)
    t = tsac.SACLearner(OBS, ACT, device="cpu", **kw)
    s0 = np_tree(j.state)
    t.state = params_from_numpy(s0, "cpu")
    batch, jb = pendulum_batch(), _jbatch(pendulum_batch())
    # the reference's draws: update() splits its key, train_step splits
    # the subkey into the critic's and the actor's
    _, sub = jax.random.split(j._rng)
    r1, r2 = jax.random.split(sub)
    n1, n2 = (np.array(jax.random.normal(r, (B, ACT))) for r in (r1, r2))
    m, g = t.train_step(tsac.to_batch(batch, "cpu"), torch.from_numpy(n1),
                        torch.from_numpy(n2))
    s1 = np_tree(t.state)
    critic_loss = closure(j._train_step, "critic_loss")
    actor_loss = closure(j._train_step, "actor_loss")
    alpha0 = jnp.exp(s0["log_alpha"])
    worst = {}
    closs, cg = jax.value_and_grad(critic_loss)(
        (j_tree(s0["q1"]), j_tree(s0["q2"])), j_tree(s0["actor"]),
        j_tree(s0["tq1"]), j_tree(s0["tq2"]), alpha0, jb, r1)
    check_rel(worst, "critic_loss", m["critic_loss"], closs)
    check_grads(worst, "critic", g["critic"], {"q1": cg[0], "q2": cg[1]})
    check_rel(worst, "alpha", m["alpha"], alpha0)
    # the actor stage at the port's updated critics
    (aloss, logp), ag = jax.value_and_grad(actor_loss, has_aux=True)(
        j_tree(s0["actor"]), j_tree(s1["q1"]), j_tree(s1["q2"]), alpha0,
        jb, r2)
    check_rel(worst, "actor_loss", m["actor_loss"], aloss)
    check_rel(worst, "entropy", m["entropy"], -jnp.mean(logp))
    check_grads(worst, "actor", g["actor"], ag)
    check_rel(worst, "alpha_grad", g["alpha"], -(jnp.mean(logp) - 1.0))
    # the reference's own step from the same state and key
    out = j.update(batch)
    r_1 = np_tree(j.state)
    _, ag_own = jax.value_and_grad(actor_loss, has_aux=True)(
        j_tree(s0["actor"]), j_tree(r_1["q1"]), j_tree(r_1["q2"]), alpha0,
        jb, r2)
    (_, logp_own) = actor_loss(j_tree(s0["actor"]), j_tree(r_1["q1"]),
                               j_tree(r_1["q2"]), alpha0, jb, r2)
    lg_own = -(jnp.mean(logp_own) - 1.0)
    check_rel(worst, "update_critic_loss", m["critic_loss"],
              out["critic_loss"])
    cref = {"q1": cg[0], "q2": cg[1]}
    check_step(worst, "critic", {"q1": s1["q1"], "q2": s1["q2"]},
               {"q1": r_1["q1"], "q2": r_1["q2"]}, g["critic"], cref,
               kw["critic_lr"])
    check_step(worst, "actor", s1["actor"], r_1["actor"], g["actor"],
               ag_own, kw["actor_lr"])
    check_step(worst, "log_alpha", s1["log_alpha"], r_1["log_alpha"],
               g["alpha"], lg_own, kw["alpha_lr"])
    # the targets move tau of the critics' step
    check_step(worst, "targets", {"q1": s1["tq1"], "q2": s1["tq2"]},
               {"q1": r_1["tq1"], "q2": r_1["tq2"]}, g["critic"], cref,
               kw["critic_lr"], scale=kw["tau"])
    print("sac largest errors:", worst)


@pytest.mark.parametrize("algo", ["td3", "ddpg"])
def test_td3_and_ddpg_steps_match_reference(algo):
    c = TD3Config() if algo == "td3" else DDPGConfig()
    kw = dict(actor_lr=3e-3, critic_lr=2e-3, gamma=0.97, tau=0.05,
              action_scale=2.0, action_shift=0.0, twin_q=c.twin_q,
              target_noise=c.target_noise,
              target_noise_clip=c.target_noise_clip, hiddens=HID)
    j = jtd3.TD3Learner(OBS, ACT, seed=3, **kw)
    t = ttd3.TD3Learner(OBS, ACT, device="cpu", **kw)
    # targets apart from the online nets, so the blend is visible
    s0 = np_tree(j.state)
    rng = np.random.default_rng(9)
    for tk in ("t_actor", "tq1", "tq2"):
        s0[tk] = {k: v + 0.05 * rng.normal(size=v.shape).astype(np.float32)
                  for k, v in s0[tk].items()}
    j.state = j_tree(s0)
    t.state = params_from_numpy(s0, "cpu")
    batch, jb = pendulum_batch(1), _jbatch(pendulum_batch(1))
    _, sub = jax.random.split(j._rng)
    noise = np.array(jax.random.normal(sub, (B, ACT)))
    dev = tsac.to_batch(batch, "cpu")
    closs, cgrads = t.critic_step(dev, torch.from_numpy(noise))
    s_c = np_tree(t.state)
    aloss, agrads = t.actor_step(dev)
    s1 = np_tree(t.state)
    critic_loss = closure(j._critic_step, "critic_loss")
    actor_loss = closure(j._actor_step, "actor_loss")
    worst = {}
    closs_r, cg = jax.value_and_grad(critic_loss)(
        (j_tree(s0["q1"]), j_tree(s0["q2"])), j_tree(s0), jb, sub)
    check_rel(worst, "critic_loss", closs, closs_r)
    check_grads(worst, "critic", cgrads, {"q1": cg[0], "q2": cg[1]})
    aloss_r, ag = jax.value_and_grad(actor_loss)(
        j_tree(s0["actor"]), j_tree(s_c), jb)
    check_rel(worst, "actor_loss", aloss, aloss_r)
    check_grads(worst, "actor", agrads, ag)
    out = j.update(batch, do_actor=True)
    r_1 = np_tree(j.state)
    check_rel(worst, "update_critic_loss", closs, out["critic_loss"])
    _, ag_own = jax.value_and_grad(actor_loss)(j_tree(s0["actor"]),
                                               j_tree(r_1), jb)
    cref = {"q1": cg[0], "q2": cg[1]}
    check_step(worst, "critic", {"q1": s1["q1"], "q2": s1["q2"]},
               {"q1": r_1["q1"], "q2": r_1["q2"]}, cgrads, cref,
               kw["critic_lr"])
    check_step(worst, "actor", s1["actor"], r_1["actor"], agrads, ag_own,
               kw["actor_lr"])
    check_step(worst, "t_actor", s1["t_actor"], r_1["t_actor"], agrads,
               ag_own, kw["actor_lr"], scale=kw["tau"])
    check_step(worst, "targets", {"q1": s1["tq1"], "q2": s1["tq2"]},
               {"q1": r_1["tq1"], "q2": r_1["tq2"]}, cgrads, cref,
               kw["critic_lr"], scale=kw["tau"])
    print(algo, "largest errors:", worst)


def test_full_state_carries_the_generator():
    """A learner restored from full_state() continues bit for bit: the
    params, the three Adams and the generator's state (the reference
    stores its JAX key there)."""
    kw = dict(actor_lr=3e-4, critic_lr=3e-4, alpha_lr=3e-4, gamma=0.99,
              tau=0.005, action_scale=2.0, initial_alpha=0.2,
              target_entropy=-1.0, device="cpu")
    a = tsac.SACLearner(OBS, ACT, seed=0, **kw)
    a.update(pendulum_batch(2))
    st = a.full_state()
    assert st["rng"].dtype == np.uint8
    b = tsac.SACLearner(OBS, ACT, seed=99, **kw)
    b.load_full_state(st)
    assert a.update(pendulum_batch(3)) == b.update(pendulum_batch(3))
    for k, v in np_tree(a.state["actor"]).items():
        np.testing.assert_array_equal(v, np_tree(b.state["actor"])[k])
