"""DreamerV3's learner in the port against the JAX package's, on the CPU.

The port draws every categorical as argmax(logits + g) on Gumbel noise g;
jax.random.categorical(key, lg) is argmax(lg + gumbel(key, lg.shape)) (held
here on this JAX), so the reference's draws are recomputed from its key by
the same splits (the posterior unroll's one split a step, imagination's
three) and handed to the port. From carried world model, actor-critic, a
target critic apart from the critic and a return scale above 1: wm_loss
(the reference's closure under jax.value_and_grad) at the start and
ac_loss at the port's updated world model and posterior states, loss
metrics and grads within 1e-5 relative; one whole update's params by
chip_smoke.adam_first_step_bound against the reference's own update (the
EMA target at 0.02 of it), the return scale within 1e-5. symlog / symexp
and the port's Gumbel sampler (chi-square) beside them."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from scipy import stats
from torch_port_util import one_torch_thread  # noqa: F401 (fixture)
from torch_rllib_parity import (assert_categorical_is_gumbel_argmax,
                                check_grads, check_rel, check_step,
                                closure, j_tree, np_tree)

from ray_tpu.rllib import dreamer as jdr
from ray_tpu_torch.rllib import dreamer as tdr
from ray_tpu_torch.rllib.models import (categorical_from_gumbel, gumbel,
                                        params_from_numpy)

OBS, A, DETER, HID, HOR = 6, 3, 32, 32, 5
B, L = 4, 12


def ref_noise(key, learner):
    """The reference update's keys and draws: (k1, k2, noise for the
    port)."""
    G, C, N = learner.groups, learner.classes, B * L
    _, k = jax.random.split(key)
    _, k1, k2 = jax.random.split(k, 3)
    post, r = [], k1
    for _ in range(L):
        r, sub = jax.random.split(r)
        post.append(jax.random.gumbel(sub, (B, G, C)))
    act, img, r = [], [], k2
    for _ in range(HOR):
        r, ka, ks = jax.random.split(r, 3)
        act.append(jax.random.gumbel(ka, (N, A)))
        img.append(jax.random.gumbel(ks, (N, G, C)))
    t = lambda xs: torch.from_numpy(np.array(jnp.stack(xs)))  # noqa: E731
    return k1, k2, {"post": t(post), "act": t(act), "img": t(img)}


def batch(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, L, OBS)).astype(np.float32),
            rng.integers(0, A, (B, L)),
            rng.normal(size=(B, L)).astype(np.float32),
            (rng.random((B, L)) > 0.1).astype(np.float32))


def test_categorical_is_argmax_of_gumbel_on_this_jax():
    assert_categorical_is_gumbel_argmax()


def test_update_matches_reference():
    kw = dict(deter=DETER, hidden=HID, horizon=HOR, wm_lr=1e-3,
              ac_lr=2e-3)
    j = jdr.DreamerLearner(OBS, A, seed=2, **kw)
    t = tdr.DreamerLearner(OBS, A, device="cpu", **kw)
    rng = np.random.default_rng(3)
    s0 = {k: np_tree(j._state[k]) for k in ("wm", "ac")}
    s0["target"] = {n: {k: v + 0.05 * rng.normal(size=v.shape).astype(
        np.float32) for k, v in p.items()} for n, p in s0["ac"].items()}
    s0["ret_scale"] = np.float32(3.0)
    j._state = dict(j._state, target=j_tree(s0["target"]),
                    ret_scale=jnp.asarray(s0["ret_scale"]))
    t._state.update(params_from_numpy(s0, "cpu"))
    obs, act_idx, rew, cont = batch()
    k1, k2, noise = ref_noise(j._rng, t)
    dev = t.to_device(obs, act_idx, rew, cont)
    taken = np.eye(A, dtype=np.float32)[act_idx]
    act = np.concatenate([np.zeros_like(taken[:, :1]), taken[:, :-1]], 1)
    with torch.no_grad():
        hs, ss, _, _ = t.observe(params_from_numpy(s0["wm"], "cpu"),
                                 dev[0], torch.from_numpy(act),
                                 noise["post"])
    m, g = t.train_step(*dev, noise)
    s1 = np_tree({k: t._state[k] for k in ("wm", "ac", "target",
                                           "ret_scale")})
    wm_loss = closure(j._update, "wm_loss")
    ac_loss = closure(j._update, "ac_loss")
    worst = {}
    (wl, aux), gw = jax.value_and_grad(wm_loss, has_aux=True)(
        j_tree(s0["wm"]), *map(jnp.asarray, (obs, act, rew, cont)), k1)
    check_rel(worst, "wm_loss", m["wm_loss"], wl)
    for name, ref in zip(("recon_loss", "reward_loss", "kl_dyn"), aux[2:]):
        check_rel(worst, name, m[name], ref)
    check_rel(worst, "posterior_h", hs, aux[0])
    check_rel(worst, "posterior_s", ss, aux[1])
    check_grads(worst, "wm", g["wm"], gw)
    # the actor-critic stage at the port's updated world model and
    # posterior states
    h0, st0 = (jnp.asarray(x.reshape(B * L, -1).numpy()) for x in (hs, ss))
    (al, aux2), ga = jax.value_and_grad(ac_loss, has_aux=True)(
        j_tree(s0["ac"]), j_tree(s1["wm"]), j_tree(s0["target"]),
        jnp.asarray(s0["ret_scale"]), h0, st0, k2)
    for name, ref in zip(("critic_loss", "actor_loss", "entropy",
                          "imag_return_mean"), aux2[:4]):
        check_rel(worst, name, m[name], ref)
    check_grads(worst, "ac", g["ac"], ga)
    check_rel(worst, "ret_scale", s1["ret_scale"],
              0.99 * s0["ret_scale"] + 0.01 * aux2[4])
    # the reference's own update from the same state and key
    out = j.update(obs, act_idx, rew, cont)
    check_rel(worst, "update_wm_loss", m["wm_loss"], out["wm_loss"])
    r1 = np_tree({k: j._state[k] for k in ("wm", "ac", "target",
                                           "ret_scale")})
    _, ga_own = jax.value_and_grad(ac_loss, has_aux=True)(
        j_tree(s0["ac"]), j_tree(r1["wm"]), j_tree(s0["target"]),
        jnp.asarray(s0["ret_scale"]), aux[0].reshape(B * L, -1),
        aux[1].reshape(B * L, -1), k2)
    check_step(worst, "wm", s1["wm"], r1["wm"], g["wm"], gw, 1e-3, 100.0)
    check_step(worst, "ac", s1["ac"], r1["ac"], g["ac"], ga_own, 2e-3,
               100.0)
    check_step(worst, "target", s1["target"], r1["target"], g["ac"],
               ga_own, 2e-3, 100.0, scale=0.02)
    check_rel(worst, "update_ret_scale", s1["ret_scale"], r1["ret_scale"])
    print("dreamer largest errors:", worst)


def test_symlog_symexp_match_reference():
    x = np.array([-100.0, -1.0, -1e-3, 0.0, 0.5, 1000.0], np.float32)
    for fj, ft in ((jdr.symlog, tdr.symlog), (jdr.symexp, tdr.symexp)):
        np.testing.assert_allclose(ft(torch.from_numpy(x)).numpy(),
                                   np.asarray(fj(jnp.asarray(x))),
                                   rtol=1e-6)
    # the reference's round trip (tests/test_rllib_dreamer.py)
    x = np.array([-100.0, -1.0, 0.0, 0.5, 1000.0], np.float32)
    np.testing.assert_allclose(
        tdr.symexp(tdr.symlog(torch.from_numpy(x))).numpy(), x, rtol=1e-5)


def test_gumbel_sampler_follows_softmax_chi_square():
    """20,000 draws at fixed logits pass a chi-square test against the
    softmax at p >= 1e-3 (fixed seed)."""
    logits = torch.tensor([0.5, -1.0, 1.5, 0.0])
    g = gumbel((20000, 4), torch.Generator().manual_seed(13))
    counts = np.bincount(categorical_from_gumbel(logits, g).numpy(),
                         minlength=4)
    expected = torch.softmax(logits.double(), -1).numpy() * 20000
    p = stats.chisquare(counts, expected).pvalue
    print("chi-square p:", p, "counts:", counts.tolist())
    assert p >= 1e-3
