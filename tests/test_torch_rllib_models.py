"""RLlib's nets in the port against the JAX package's, on the CPU.

Params come from the reference's init (a JAX key), carried across as numpy
through ``ray_tpu_torch.rllib.models.params_from_numpy``; inputs are made
by numpy from a seed. Each function's output is held within 1e-5 of the
reference's, relative to the reference's largest magnitude (the fp32
ceiling of the port is 2e-4); each test prints the largest error seen.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats
from torch_port_util import one_torch_thread  # noqa: F401 (fixture)

from ray_tpu.rllib import catalog as jcat
from ray_tpu.rllib import models as jm
from ray_tpu_torch.rllib import catalog as tcat
from ray_tpu_torch.rllib import models as tm
from ray_tpu_torch.rllib.policy import TorchPolicy

_TOL = 1e-5


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _carry(jparams):
    return tm.params_from_numpy(_np(jparams), device="cpu")


def _rel(got, ref) -> float:
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)),
                                                  1e-30))


def _check(name, got, ref, worst):
    err = _rel(got, ref)
    worst[name] = err
    assert err <= _TOL, f"{name}: {err:.3e} > {_TOL}"


def _obs(B, D, seed=1):
    return np.random.default_rng(seed).normal(size=(B, D)).astype(np.float32)


def test_mlp_heads_logp_and_entropy_match_reference():
    worst = {}
    jp = jm.init_actor_critic(jax.random.key(0), 7, 5, (32, 16))
    p = _carry(jp)
    obs = _obs(64, 7)
    lj, vj = jm.forward(jp, jnp.asarray(obs))
    lt, vt = tm.forward(p, torch.from_numpy(obs))
    _check("logits", lt, lj, worst)
    _check("value", vt, vj, worst)
    acts = np.random.default_rng(2).integers(0, 5, 64)
    _check("logp_of", tm.logp_of(lt, torch.from_numpy(acts)),
           jm.logp_of(lj, jnp.asarray(acts)), worst)
    _check("entropy_of", tm.entropy_of(lt), jm.entropy_of(lj), worst)
    print("largest relative errors:", worst)


def test_gaussian_q_and_squashed_sample_match_reference():
    worst = {}
    ja = jm.init_gaussian_actor(jax.random.key(3), 6, 2, (32, 32))
    jq = jm.init_q_net(jax.random.key(4), 6, 2, (32, 32))
    pa, pq = _carry(ja), _carry(jq)
    obs = _obs(48, 6)
    mj, sj = jm.gaussian_forward(ja, jnp.asarray(obs))
    mt, st = tm.gaussian_forward(pa, torch.from_numpy(obs))
    _check("mean", mt, mj, worst)
    _check("log_std", st, sj, worst)
    act = np.random.default_rng(5).uniform(-1, 1, (48, 2)).astype(
        np.float32)
    _check("q", tm.q_forward(pq, torch.from_numpy(obs),
                             torch.from_numpy(act)),
           jm.q_forward(jq, jnp.asarray(obs), jnp.asarray(act)), worst)
    # the reference draws its noise as jax.random.normal(key, mu.shape)
    key = jax.random.key(6)
    noise = np.array(jax.random.normal(key, mj.shape))
    aj, lpj = jm.squashed_sample(ja, jnp.asarray(obs), key, 2.0, 0.5)
    at, lpt = tm.squashed_from_noise(mt, st, torch.from_numpy(noise), 2.0,
                                     0.5)
    _check("squashed_action", at, aj, worst)
    _check("squashed_logp", lpt, lpj, worst)
    print("largest relative errors:", worst)


def test_squashed_sample_draws_standard_normal_noise_from_its_generator():
    p = tm.init_gaussian_actor(tm.seeded(0), 3, 2, (8,), device="cpu")
    obs = torch.from_numpy(_obs(5, 3))
    a, lp = tm.squashed_sample(p, obs, torch.Generator().manual_seed(9), 1.5)
    mu, ls = tm.gaussian_forward(p, obs)
    noise = torch.randn(mu.shape, generator=torch.Generator().manual_seed(9))
    a2, lp2 = tm.squashed_from_noise(mu, ls, noise, 1.5)
    assert torch.equal(a, a2) and torch.equal(lp, lp2)
    assert float(a.abs().max()) < 1.5


def test_catalog_mlp_and_conv_match_reference_at_breakout_planes():
    worst = {}
    spec_j = jcat.ModelSpec(400, 3, obs_planes=(4, 10, 10))
    spec_t = tcat.ModelSpec(400, 3, obs_planes=(4, 10, 10))
    obs = _obs(16, 400)
    for name, cfg in (("mlp", {"hiddens": (64, 32)}),
                      ("conv", {"type": "conv", "conv_filters": (16, 32),
                                "hiddens": (128,)})):
        ij, fj = jcat.get_model(spec_j, cfg)
        _, ft = tcat.get_model(spec_t, cfg)
        jp = ij(jax.random.key(7))
        lj, vj = fj(jp, jnp.asarray(obs))
        lt, vt = ft(_carry(jp), torch.from_numpy(obs))
        _check(f"{name}_logits", lt, lj, worst)
        _check(f"{name}_value", vt, vj, worst)
    assert tuple(_carry(jp)["cw0"].shape) == (3, 3, 4, 16)  # HWIO kept
    print("largest relative errors:", worst)


def test_gru_cell_forward_and_unroll_match_reference():
    worst = {}
    jp = jcat.init_gru(jax.random.key(8), 5, 3, hidden=16, embed=(12,))
    p = _carry(jp)
    rng = np.random.default_rng(9)
    T, B = 6, 4
    obs = rng.normal(size=(T, B, 5)).astype(np.float32)
    h0 = rng.normal(size=(B, 16)).astype(np.float32)
    x = rng.normal(size=(B, 12)).astype(np.float32)
    _check("gru_cell", tcat.gru_cell(p, torch.from_numpy(x),
                                     torch.from_numpy(h0)),
           jcat.gru_cell(jp, jnp.asarray(x), jnp.asarray(h0)), worst)
    for state in (None, h0):
        out_j = jcat.gru_forward(jp, jnp.asarray(obs[0]),
                                 None if state is None
                                 else jnp.asarray(state))
        out_t = tcat.gru_forward(p, torch.from_numpy(obs[0]),
                                 None if state is None
                                 else torch.from_numpy(state))
        for i, name in enumerate(("logits", "value", "h")):
            _check(f"gru_forward_{name}", out_t[i], out_j[i], worst)
    reset = rng.random((T, B)) < 0.3
    for r in (None, reset):
        out_j = jcat.gru_unroll(jp, jnp.asarray(obs), jnp.asarray(h0),
                                None if r is None else jnp.asarray(r))
        out_t = tcat.gru_unroll(p, torch.from_numpy(obs),
                                torch.from_numpy(h0),
                                None if r is None else torch.from_numpy(r))
        tag = "reset" if r is not None else "plain"
        for i, name in enumerate(("logits", "values", "h_final")):
            _check(f"gru_unroll_{tag}_{name}", out_t[i], out_j[i], worst)
    print("largest relative errors:", worst)


@pytest.mark.parametrize("shape", [(16, 8), (8, 16), (400, 256), (64, 1)])
def test_ortho_gives_orthonormal_columns_times_the_gain(shape):
    q = tm._ortho(torch.Generator().manual_seed(0), shape, gain=0.7)
    assert tuple(q.shape) == shape
    # orthonormal columns when tall, rows when wide
    g = q.T @ q if shape[0] >= shape[1] else q @ q.T
    eye = torch.eye(min(shape))
    assert float((g - 0.49 * eye).abs().max()) < 1e-5


def test_init_is_seeded_and_device_independent_of_the_draws():
    a = tm.init_actor_critic(tm.seeded(3), 4, 2, device="cpu")
    b = tm.init_actor_critic(tm.seeded(3), 4, 2, device="cpu")
    c = tm.init_actor_critic(tm.seeded(4), 4, 2, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["w0"], c["w0"])
    assert {k: tuple(v.shape) for k, v in a.items()} == {
        k: tuple(np.shape(v)) for k, v in
        jm.init_actor_critic(jax.random.key(0), 4, 2).items()}


def test_policy_same_seed_same_actions_and_logp_of_its_draws():
    obs = _obs(32, 4)
    p1 = TorchPolicy(4, 3, seed=5, device="cpu")
    p2 = TorchPolicy(4, 3, seed=5, device="cpu")
    out1 = [p1.compute_actions(obs) for _ in range(3)]
    out2 = [p2.compute_actions(obs) for _ in range(3)]
    for a, b in zip(out1, out2):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert any((out1[0][0] != o[0]).any() for o in out1[1:])
    a, lp, v, lg = out1[0]
    assert a.dtype == np.int64 and lp.dtype == np.float32
    want = tm.logp_of(torch.from_numpy(lg), torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(lp, want)
    np.testing.assert_array_equal(v, p1.value(obs))


def test_policy_draws_follow_softmax_chi_square():
    """20,000 draws at fixed logits pass a chi-square test against the
    softmax at p >= 1e-3 (fixed seed)."""
    pol = TorchPolicy(2, 4, hiddens=(8,), seed=11, device="cpu")
    # a row of fixed logits through the head's bias alone
    pol.params = {k: torch.zeros_like(v) for k, v in pol.params.items()}
    logits = torch.tensor([0.5, -1.0, 1.5, 0.0])
    pol.params["b_pi"] = logits.clone()
    acts, _, _, _ = pol.compute_actions(np.zeros((20000, 2), np.float32))
    counts = np.bincount(acts, minlength=4)
    expected = torch.softmax(logits.double(), -1).numpy() * 20000
    p = stats.chisquare(counts, expected).pvalue
    print("chi-square p:", p, "counts:", counts.tolist())
    assert p >= 1e-3


def test_policy_greedy_is_the_argmax():
    obs = _obs(64, 4, seed=3)
    pol = TorchPolicy(4, 3, seed=2, device="cpu")
    a, lp, v, lg = pol.compute_actions(obs, explore=False)
    logits, _ = tm.forward(pol.params, torch.from_numpy(obs))
    np.testing.assert_array_equal(a, torch.argmax(logits, -1).numpy())
    assert not lp.any() and not lg.any()
    np.testing.assert_array_equal(pol.greedy(obs)[0], a)


def test_weights_round_trip_through_numpy():
    pol = TorchPolicy(4, 2, seed=0, device="cpu")
    other = TorchPolicy(4, 2, seed=1, device="cpu")
    other.set_weights(pol.get_weights())
    obs = _obs(8, 4)
    for x, y in zip(pol.compute_actions(obs, explore=False),
                    other.compute_actions(obs, explore=False)):
        np.testing.assert_array_equal(x, y)


def test_squashed_gaussian_policy_in_a_continuous_worker():
    """SAC's collection path (its learner is part 2): actions inside the
    box, reproducible for a seed, the mean action when not exploring."""
    from ray_tpu_torch.rllib import ContinuousRolloutWorker

    w1 = ContinuousRolloutWorker("Pendulum-v1", 2, 8, 0.99, 0.95, seed=3)
    w2 = ContinuousRolloutWorker("Pendulum-v1", 2, 8, 0.99, 0.95, seed=3)
    assert w1.policy.device.type == "cpu"
    b1, b2 = w1.sample_transitions(0.0), w2.sample_transitions(0.0)
    for k in b1:
        np.testing.assert_array_equal(b1[k], b2[k])
    env0 = w1.vec.envs[0]
    assert b1["actions"].shape == (16, 1)
    assert (np.abs(b1["actions"]) <= env0.action_high).all()
    pol = w1.policy
    obs = _obs(4, 3)
    a, lp = pol.compute_actions(obs, explore=False)
    mu, _ = tm.gaussian_forward(pol.params, torch.from_numpy(obs))
    np.testing.assert_array_equal(
        a, (pol.action_shift + pol.action_scale * torch.tanh(mu)).numpy())
    assert not lp.any()
    assert np.isfinite(w1.evaluate(num_episodes=1)["mean_return"])
