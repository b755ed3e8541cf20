"""RLlib's learners in the port against the JAX package's, on the CPU.

Each learner starts from the reference learner's params (carried across as
numpy through ``set_weights``) and takes one update on a fixed batch made by
numpy from a seed. The policy head ``w_pi`` is scaled by 100 on both sides
first: at the init's gain of 0.01 the policy is nearly uniform, logp nearly
constant, and a policy loss over normalized advantages (which sum to zero)
cancels to ~1e-4 of its terms, where a relative error measures the
cancellation rather than the port. The loss metrics and the grads (the
reference's own loss closure under ``jax.value_and_grad``) are held within
1e-5 relative, and
the new params after one Adam step by ``chip_smoke.adam_first_step_bound``:
1e-6 absolute plus lr |f(g_port) - f(g_ref)|, f(g) = g / (|g| + eps), the
first step's direction on each side's own grads (where |g| is near eps,
Adam turns reduction-order noise into up to 2 lr). Each test prints the
largest errors seen.
"""

import functools

import chip_smoke
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import (deadline, one_torch_thread,  # noqa: F401
                             ray_start)

from ray_tpu.rllib import a2c as ja2c
from ray_tpu.rllib import appo as jappo
from ray_tpu.rllib import dqn as jdqn
from ray_tpu.rllib import learner as jl
from ray_tpu_torch.rllib import a2c as ta2c
from ray_tpu_torch.rllib import appo as tappo
from ray_tpu_torch.rllib import dqn as tdqn
from ray_tpu_torch.rllib import learner as tl
from ray_tpu_torch.rllib.sample_batch import SampleBatch

_TOL = 1e-5
_ADAM_ABS = 1e-6
_TINY_G = 1e-6
OBS, ACTS = 6, 3


def ppo_batch(B=64, seed=0):
    rng = np.random.default_rng(seed)
    return SampleBatch({
        "obs": rng.normal(size=(B, OBS)).astype(np.float32),
        "actions": rng.integers(0, ACTS, B),
        "action_logp": (np.log(1 / ACTS) + 0.3 * rng.normal(size=B)
                        ).astype(np.float32),
        "advantages": rng.normal(size=B).astype(np.float32),
        "value_targets": rng.normal(size=B).astype(np.float32)})


def vtrace_batch(T=8, N=5, seed=1):
    rng = np.random.default_rng(seed)
    return SampleBatch({
        "obs": rng.normal(size=(T, N, OBS)).astype(np.float32),
        "actions": rng.integers(0, ACTS, (T, N)),
        "rewards": rng.normal(size=(T, N)).astype(np.float32),
        "dones": rng.random((T, N)) < 0.15,
        "action_logp": (np.log(1 / ACTS) + 0.3 * rng.normal(size=(T, N))
                        ).astype(np.float32),
        "bootstrap_obs": rng.normal(size=(N, OBS)).astype(np.float32)})


def dqn_batch(B=64, seed=2):
    rng = np.random.default_rng(seed)
    return SampleBatch({
        "obs": rng.normal(size=(B, OBS)).astype(np.float32),
        "actions": rng.integers(0, ACTS, B),
        "rewards": rng.normal(size=B).astype(np.float32),
        "dones": rng.random(B) < 0.2,
        "new_obs": rng.normal(size=(B, OBS)).astype(np.float32),
        "weights": rng.uniform(0.2, 1.0, B).astype(np.float32)})


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref),
                                                 1e-30))


def _loss_fn(jlearner):
    """The reference learner's own loss closure (inside its jitted step)."""
    fn = jlearner._train_step.__wrapped__
    return dict(zip(fn.__code__.co_freevars,
                    fn.__closure__))["loss_fn"].cell_contents


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def check_adam_step(new, ref_new, grads, ref_grads, lr, clip) -> dict:
    """Params after one Adam step from the same params, by
    chip_smoke.adam_first_step_bound -> the largest error and its share of
    the bound."""
    bound = chip_smoke.adam_first_step_bound(grads, ref_grads, lr, clip)
    worst = {"abs": 0.0, "share_of_bound": 0.0}
    for k in ref_new:
        d = np.abs(np.asarray(new[k], np.float64) - np.asarray(ref_new[k]))
        worst["abs"] = max(worst["abs"], float(d.max()))
        worst["share_of_bound"] = max(worst["share_of_bound"],
                                      float((d / bound[k]).max()))
        assert (d <= bound[k]).all(), k
    return worst


def check_adam_steps(new, ref_new, ref_grads, lr) -> dict:
    """Params after several Adam steps: within 1e-6 absolute, except
    elements whose starting gradient is below 1e-6 of their leaf's
    largest, which may take ``lr`` of noise."""
    worst = {"abs": 0.0, "tiny_g": 0.0}
    for k in ref_new:
        g = np.abs(np.asarray(ref_grads[k]))
        tiny = g < _TINY_G * max(g.max(), 1e-30)
        d = np.abs(np.asarray(new[k], np.float64) - np.asarray(ref_new[k]))
        worst["abs"] = max(worst["abs"], float(d[~tiny].max(initial=0)))
        worst["tiny_g"] = max(worst["tiny_g"], float(d[tiny].max(initial=0)))
        assert d[~tiny].max(initial=0) <= _ADAM_ABS, k
        assert d[tiny].max(initial=0) <= lr, k
    return worst


def _pair(name):
    """(JAX learner, port learner on the CPU from its params, batch, lr)."""
    lr = 3e-3
    if name == "ppo":
        j = jl.PPOLearner(OBS, ACTS, lr=lr, hiddens=(32, 32), seed=3)
        t = tl.PPOLearner(OBS, ACTS, lr=lr, hiddens=(32, 32), device="cpu")
        batch = ppo_batch()
    elif name == "a2c":
        kw = dict(lr=lr, vf_coeff=0.5, entropy_coeff=0.01, grad_clip=0.5,
                  hiddens=(32, 32))
        j = ja2c.A2CLearner(OBS, ACTS, seed=3, **kw)
        t = ta2c.A2CLearner(OBS, ACTS, device="cpu", **kw)
        batch = ppo_batch()
    elif name == "impala":
        j = jl.ImpalaLearner(OBS, ACTS, lr=lr, hiddens=(32, 32), seed=3,
                             grad_clip=0.5)
        t = tl.ImpalaLearner(OBS, ACTS, lr=lr, hiddens=(32, 32),
                             grad_clip=0.5, device="cpu")
        batch = vtrace_batch()
    elif name == "appo":
        j = jappo.APPOLearner(OBS, ACTS, lr=lr, hiddens=(32, 32), seed=3)
        t = tappo.APPOLearner(OBS, ACTS, lr=lr, hiddens=(32, 32),
                              device="cpu")
        batch = vtrace_batch()
    else:
        kw = dict(lr=lr, gamma=0.97, hiddens=(32, 32))
        j = jdqn.DQNLearner(OBS, ACTS, seed=3, **kw)
        t = tdqn.DQNLearner(OBS, ACTS, device="cpu", **kw)
        batch = dqn_batch()
    w = j.get_weights()
    w["w_pi"] = w["w_pi"] * 100.0
    j.set_weights(w)
    t.set_weights(w)
    return j, t, batch, lr


def _jax_grads(name, j, batch):
    loss_fn = _loss_fn(j)
    args = (j.params, j.target_params) if name == "dqn" else (j.params,)
    (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        *args, _jbatch(batch))
    if name == "dqn":
        aux = {"td_abs": aux}
    return ({k: np.asarray(v) for k, v in grads.items()},
            {**{k: np.asarray(v) for k, v in aux.items()},
             "total_loss": float(loss)})


@pytest.mark.parametrize("name", ["ppo", "a2c", "impala", "appo", "dqn"])
def test_first_step_matches_reference_learner(name):
    j, t, batch, lr = _pair(name)
    g_ref, m_ref = _jax_grads(name, j, batch)
    g, m = t.compute_grads(batch)
    worst = {}
    for k in g_ref:
        worst[f"grad_{k}"] = e = _rel(g[k], g_ref[k])
        assert e <= _TOL, (k, e)
    for k in m_ref:
        worst[f"metric_{k}"] = e = _rel(m[k], m_ref[k])
        assert e <= _TOL, (k, e, m[k], m_ref[k])
    # one whole step through each learner's update()
    out_ref = j.update(batch)
    out = t.update(batch)
    if name == "dqn":
        assert set(out) == {"loss", "td_abs"}
        out_ref["total_loss"], out["total_loss"] = out_ref.pop(
            "loss"), out.pop("loss")
    assert set(out) == set(out_ref)
    for k in out_ref:
        worst[f"update_{k}"] = e = _rel(out[k], out_ref[k])
        assert e <= _TOL, (k, e)
    worst.update(check_adam_step(t.get_weights(), j.get_weights(), g,
                                 g_ref, lr, t.tx.grad_clip))
    print(name, "largest errors:", worst)


def test_whole_ppo_update_matches_reference():
    """Two epochs of 64 rows in minibatches of 32 (4 Adam steps, shuffled
    by the same numpy permutations), held by the Adam rule with the small
    gradients taken at the starting params and 2 lr granted per step."""
    j, t, _, lr = _pair("ppo")
    batch = ppo_batch(B=64, seed=4)
    g_ref, _ = _jax_grads("ppo", j, batch)
    out_ref = j.update(batch, num_epochs=2, minibatch_size=32, seed=7)
    out = t.update(batch, num_epochs=2, minibatch_size=32, seed=7)
    worst = {k: _rel(out[k], out_ref[k]) for k in out_ref}
    assert max(worst.values()) <= _TOL, worst
    worst.update(check_adam_steps(t.get_weights(), j.get_weights(), g_ref,
                                  4 * 2 * lr))
    print("largest errors:", worst)


def test_vtrace_matches_reference():
    rng = np.random.default_rng(5)
    T, N = 16, 7
    args = [rng.normal(size=(T, N)).astype(np.float32) - 1.0,
            rng.normal(size=(T, N)).astype(np.float32) - 1.0,
            rng.normal(size=(T, N)).astype(np.float32),
            rng.random((T, N)) < 0.2,
            rng.normal(size=(T, N)).astype(np.float32),
            rng.normal(size=N).astype(np.float32)]
    for clip_rho, clip_c in ((1.0, 1.0), (2.0, 0.5)):
        ref = jl.vtrace(*map(jnp.asarray, args), 0.95, clip_rho, clip_c)
        got = tl.vtrace(*map(torch.from_numpy, args), 0.95, clip_rho, clip_c)
        errs = [_rel(g.numpy(), r) for g, r in zip(got, ref)]
        print("vtrace (vs, pg_adv) relative errors:", errs)
        assert max(errs) <= _TOL


def test_vtrace_carries_no_gradient():
    rng = np.random.default_rng(6)
    tl_ = torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32)
                           ).requires_grad_(True)
    vals = torch.zeros(4, 3, requires_grad=True)
    vs, adv = tl.vtrace(torch.zeros(4, 3), tl_, torch.ones(4, 3),
                        torch.zeros(4, 3, dtype=torch.bool), vals,
                        torch.zeros(3), 0.9)
    assert not vs.requires_grad and not adv.requires_grad


def test_compute_and_apply_grads_equal_update():
    """compute_grads then apply_grads is one update() step, bit for bit
    (PPO's update shuffles its one minibatch with the seed's permutation)."""
    for name in ("ppo", "a2c"):
        _, a, batch, _ = _pair(name)
        _, b, _, _ = _pair(name)
        if name == "ppo":
            out = b.update(batch, num_epochs=1,
                           minibatch_size=batch.count, seed=5)
            batch = batch.shuffle(np.random.default_rng(5))
        else:
            out = b.update(batch)
        grads, metrics = a.compute_grads(batch)
        a.apply_grads(grads)
        wa, wb = a.get_weights(), b.get_weights()
        for k in wa:
            np.testing.assert_array_equal(wa[k], wb[k])
        assert metrics == out


def test_a2c_microbatches_accumulate_like_the_reference():
    """Four microbatch grads averaged, one Adam step, held by the same
    bound on each side's averaged grads (an average can cancel to ~1e-5
    of its terms: one w1 element's four grads of ~1e-2 sum to 1.4e-7,
    1.4% apart between the two sides)."""
    j, t, batch, lr = _pair("a2c")
    mbs = list(batch.minibatches(16))
    per_ref = [_jax_grads("a2c", j, mb)[0] for mb in mbs]
    per = [t.compute_grads(mb)[0] for mb in mbs]
    g_ref = {k: np.mean([g[k] for g in per_ref], axis=0) for k in per_ref[0]}
    g = {k: np.mean([x[k] for x in per], axis=0) for k in per[0]}
    out_ref = j.update(batch, microbatch_size=16)
    out = t.update(batch, microbatch_size=16)
    worst = {k: _rel(out[k], out_ref[k]) for k in out_ref}
    assert max(worst.values()) <= _TOL, worst
    worst.update(check_adam_step(t.get_weights(), j.get_weights(), g, g_ref,
                                 lr, t.tx.grad_clip))
    print("largest errors:", worst)


def test_dqn_sync_target_is_a_copy():
    _, t, batch, _ = _pair("dqn")
    t.update(batch)
    assert not all(torch.equal(t.params[k], t.target_params[k])
                   for k in t.params)
    t.sync_target()
    for k in t.params:
        assert torch.equal(t.params[k], t.target_params[k])
        assert t.params[k].data_ptr() != t.target_params[k].data_ptr()


@deadline(120)
def test_learner_group_averages_shard_grads(ray_start):
    import ray_tpu_torch

    make = functools.partial(tl.PPOLearner, OBS, ACTS, hiddens=(32, 32),
                             seed=0, device="cpu")
    group = tl.LearnerGroup(make, num_learners=2)
    try:
        batch = ppo_batch(B=64, seed=8)
        shards = [batch.slice(0, 32), batch.slice(32, 64)]
        where = ray_tpu_torch.get([r.where.remote() for r in group.remotes],
                                  timeout=60)
        assert [w["device"] for w in where] == ["cpu", "cpu"]
        remote = ray_tpu_torch.get(
            [r.compute_grads.remote(s)
             for r, s in zip(group.remotes, shards)], timeout=60)
        local = [group.local.compute_grads(s) for s in shards]
        for (gr, mr), (gl, ml) in zip(remote, local):
            for k in gl:
                assert _rel(gr[k], gl[k]) <= _TOL, k
            assert _rel(mr["total_loss"], ml["total_loss"]) <= _TOL
        ref = make()
        ref.apply_grads({k: np.mean([g[k] for g, _ in remote], axis=0)
                         for k in remote[0][0]})
        group.update(batch)
        w = group.get_weights()
        for k in w:
            np.testing.assert_array_equal(w[k], ref.get_weights()[k])
        for rw in ray_tpu_torch.get([r.get_weights.remote()
                                     for r in group.remotes], timeout=60):
            for k in w:
                np.testing.assert_array_equal(rw[k], w[k])
    finally:
        for r in group.remotes:
            ray_tpu_torch.kill(r)


def test_get_weights_is_a_snapshot():
    """Weights handed out (to workers, to a checkpoint) do not follow the
    learner's later in-place steps (a CPU tensor's .numpy() is a view)."""
    _, t, batch, _ = _pair("ppo")
    w = t.get_weights()
    before = {k: v.copy() for k, v in w.items()}
    t.update(batch, num_epochs=1, minibatch_size=batch.count)
    for k in w:
        np.testing.assert_array_equal(w[k], before[k])
    assert any(not np.array_equal(t.get_weights()[k], w[k]) for k in w)
