"""The JAX side of the port's multi-process train-step tests: the unmeshed
JAX steps a meshed port step is held against, and the checks.

Tolerance: fp32, 2e-4 for losses, norms and params, except where a
starting gradient vanishes (ROADMAP C2): Adam's g / (|g| + 1e-8) turns fp32
summation-order noise there into an O(lr) step, so two steps may part such
an element by up to 2 x lr.
"""

import jax
import jax.numpy as jnp
import numpy as np

from ray_tpu.models import training as jtrain
from ray_tpu.models import transformer as jtr

TOL, LR, STEPS = 2e-4, 1e-3, 2
VANISHING = 1e-7  # ROADMAP C2: a starting gradient this small


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def batches(vocab: int = 256, seed: int = 7):
    """A [8, 32] batch of inputs and targets, and the same with a mask."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, vocab, size=(8, 33)).astype(np.int32)
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    mask = (rng.rand(8, 32) < 0.7).astype(np.float32)
    return batch, {**batch, "mask": mask}


def initial_params(cfg, seed: int = 0):
    """The JAX package's initial params for ``cfg``, as numpy."""
    tx = jtrain.make_optimizer(LR)
    return np_tree(jtrain.init_train_state(jax.random.key(seed), cfg,
                                           tx)["params"])


def jax_steps(cfg, params, batch):
    """STEPS unmeshed JAX steps from numpy ``params`` -> metrics, params and
    the starting grads."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.tree.map(jnp.asarray, params)
    grads = np_tree(jax.grad(lambda p: jtr.loss_fn(p, jb, cfg)[0])(params))
    tx = jtrain.make_optimizer(LR)
    state = {"step": jnp.zeros((), jnp.int32), "params": params,
             "opt_state": tx.init(params)}
    step = jtrain.make_train_step(cfg, tx)
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, jb)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "params": np_tree(state["params"]),
            "grads": grads}


def check_params(got, want):
    """Every param within TOL, but where the starting gradient vanishes
    (ROADMAP C2) within the 2 x lr two Adam steps can part them by."""
    assert jax.tree.structure(got["params"]) == jax.tree.structure(
        want["params"])
    for a, b, g in zip(jax.tree.leaves(want["params"]),
                       jax.tree.leaves(got["params"]),
                       jax.tree.leaves(want["grads"])):
        d = np.abs(np.asarray(a) - b)
        vanishing = np.abs(g) < VANISHING
        assert d[~vanishing].max(initial=0) <= TOL
        assert d[vanishing].max(initial=0) <= STEPS * LR


def check_metric(k, got, want):
    """Within TOL; perplexity, exp(loss), relatively."""
    scale = abs(want) if k == "perplexity" else 1.0
    assert abs(got - want) <= TOL * scale, (k, got, want)


def check_steps(got, want, keys):
    for g, w in zip(got["metrics"], want["metrics"]):
        for k in keys:
            check_metric(k, g[k], w[k])
    check_params(got, want)
