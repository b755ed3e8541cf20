"""Shared checks of the port's RLlib learners against the JAX package's
(tests/test_torch_rllib_*_parity.py): the reference's loss closures, the
bars, and the one-step Adam bound. Imports JAX: used by CPU tests only.

A learner whose step has stages (SAC's critic then actor, TD3's, Dreamer's
world model then actor-critic) is held stage by stage: each of the
reference's stage losses is evaluated at the inputs the port's stage saw
(the port's state after the earlier stages), so metrics and grads compare
like for like within REL_TOL; the params after the whole step are then
held against the reference's own step by chip_smoke.adam_first_step_bound
on the grads each side applied.
"""

import jax
import jax.numpy as jnp
import numpy as np

import chip_smoke

REL_TOL = 1e-5


def rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref),
                                                 1e-30))


def closure(fn, name: str):
    """``name`` from the closure of the jitted ``fn``'s Python function."""
    fn = getattr(fn, "__wrapped__", fn)
    return dict(zip(fn.__code__.co_freevars,
                    fn.__closure__))[name].cell_contents


def np_tree(tree):
    """A JAX or torch tree (dicts, tuples) as numpy leaves."""
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(np_tree(v) for v in tree)
    if hasattr(tree, "detach"):
        return tree.detach().cpu().numpy().copy()
    return np.asarray(tree)


def j_tree(tree):
    if isinstance(tree, dict):
        return {k: j_tree(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def flat(tree, prefix: str = "") -> dict:
    """{"a/b/c": leaf} of a nested dict (a bare leaf -> {prefix: leaf})."""
    if not isinstance(tree, dict):
        return {prefix or "leaf": np_tree(tree)}
    out = {}
    for k, v in tree.items():
        out.update(flat(v, f"{prefix}/{k}" if prefix else k))
    return out


def check_rel(worst: dict, name: str, got, ref, tol: float = REL_TOL):
    e = rel(np_tree(got), np_tree(ref))
    worst[name] = max(worst.get(name, 0.0), e)
    assert e <= tol, (name, e)


def check_grads(worst: dict, name: str, got, ref):
    """Each leaf within REL_TOL as |d| / |g|."""
    g, r = flat(got), flat(ref)
    assert set(g) == set(r), (sorted(g), sorted(r))
    e = max(rel(g[k], r[k]) for k in r)
    worst[f"grad_{name}"] = e
    assert e <= REL_TOL, (name, {k: rel(g[k], r[k]) for k in r})


def check_step(worst: dict, name: str, new, ref_new, grads, ref_grads,
               lr: float, clip=None, scale: float = 1.0):
    """The params after one Adam step from the same params, each leaf
    within ``scale`` x adam_first_step_bound of each side's grads (scale <
    1 for a Polyak or EMA target that moves a share of the step)."""
    n, r = flat(new), flat(ref_new)
    bound = chip_smoke.adam_first_step_bound(flat(grads), flat(ref_grads),
                                             lr, clip)
    worst_share, worst_abs = 0.0, 0.0
    for k in r:
        d = np.abs(np.asarray(n[k], np.float64) - np.asarray(r[k]))
        b = chip_smoke._RL_ADAM_ABS + scale * (bound[k]
                                               - chip_smoke._RL_ADAM_ABS)
        worst_abs = max(worst_abs, float(d.max(initial=0.0)))
        worst_share = max(worst_share, float((d / b).max(initial=0.0)))
        assert (d <= b).all(), (name, k, float(d.max()))
    worst[f"param_{name}_abs"] = worst_abs
    worst[f"param_{name}_share_of_bound"] = worst_share


def assert_categorical_is_gumbel_argmax():
    """jax.random.categorical(key, lg) == argmax(lg + gumbel(key,
    lg.shape)) on this JAX, the identity the port's samplers rely on."""
    key = jax.random.key(11)
    lg = jax.random.normal(jax.random.key(12), (64, 8, 5))
    got = jax.random.categorical(key, lg)
    want = jnp.argmax(lg + jax.random.gumbel(key, lg.shape), axis=-1)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
