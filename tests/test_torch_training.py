"""The port's train step (``ray_tpu_torch.models.training``) against the JAX
package's on the CPU: the optimizer chain against optax on random trees,
and a 5-step trajectory of the whole step on ``tiny_config`` from the same
params (JAX init, converted by ``params_from_numpy``), with plain attention
and with the flash op (JAX: the Pallas kernels in interpret mode; the port:
``_Flash3`` with the plain versions of B1, B2 and B3)."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import config as jcfg
from ray_tpu.models import training as jtrain
from ray_tpu_torch.interop import params_from_numpy, tensor_from_numpy
from ray_tpu_torch.models import config as tcfg
from ray_tpu_torch.models import training as ttrain
from torch_port_util import one_torch_thread  # noqa: F401 (fixture)

_MU = {None: None, jnp.bfloat16: torch.bfloat16}
_SHAPES = {"embed": (9, 6), "layers": {"w": (2, 6, 5), "norm": (2, 6)},
           "final_norm": (6,)}


def _random_tree(rng, scale, dtype):
    return jax.tree.map(
        lambda s: jnp.asarray(rng.randn(*s) * scale, jnp.float32).astype(
            dtype), _SHAPES, is_leaf=lambda x: isinstance(x, tuple))


def _to_torch(tree):
    return jax.tree.map(lambda x: tensor_from_numpy(np.asarray(x), "cpu"),
                        tree)


def _max_diff(jtree, ttree):
    return max(float(np.abs(np.asarray(a, np.float32) - b.float().numpy())
                     .max())
               for a, b in zip(jax.tree.leaves(jtree),
                               ttrain.tree_leaves(ttree)))


@pytest.mark.parametrize("dtype,mu_dtype", [
    (jnp.float32, None),
    (jnp.bfloat16, jnp.bfloat16),
    (jnp.float32, jnp.bfloat16),
])
@pytest.mark.parametrize("grad_clip", [100.0, 0.5])  # unclipped / clipped
@pytest.mark.parametrize("schedule", [False, True])
def test_optimizer_matches_optax(dtype, mu_dtype, grad_clip, schedule):
    """Four updates of the chain on random trees: params and both moments
    equal optax's within the repo's tolerances (fp32 2e-4, bf16 5e-2)."""
    rng = np.random.RandomState(0)
    kw = dict(grad_clip=grad_clip, warmup_steps=2 if schedule else 0,
              total_steps=6 if schedule else None)
    jtx = jtrain.make_optimizer(1e-2, mu_dtype=mu_dtype, **kw)
    ttx = ttrain.make_optimizer(1e-2, mu_dtype=_MU[mu_dtype], **kw)
    jp = _random_tree(rng, 1.0, dtype)
    tp = _to_torch(jp)
    js, ts = jtx.init(jp), ttx.init(tp)
    tol = 5e-2 if dtype == jnp.bfloat16 else 2e-4
    for _ in range(4):
        g = _random_tree(rng, 0.3, dtype)
        norm = float(optax.global_norm(g))
        assert (norm < grad_clip) == (grad_clip == 100.0)
        ju, js = jtx.update(g, js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = ttx.update(_to_torch(g), ts, tp)
        tp = ttrain.tree_map(ttrain.apply_updates, tp, tu)
        assert _max_diff(jp, tp) <= tol
        adam = js[1][0]
        assert _max_diff(adam.mu, ts["mu"]) <= tol
        assert _max_diff(adam.nu, ts["nu"]) <= tol
        assert int(adam.count) == int(ts["count"])
    for leaf in ttrain.tree_leaves(ts["mu"]):
        assert leaf.dtype == (_MU[mu_dtype] or tp["embed"].dtype)
    for leaf in ttrain.tree_leaves(ts["nu"]):
        assert leaf.dtype == tp["embed"].dtype


def test_step_in_place_equals_update():
    """``step_`` (the train step's in-place path) gives update()'s params,
    moments and count, and returns the raw grads' global norm."""
    rng = np.random.RandomState(1)
    tx = ttrain.make_optimizer(1e-2, grad_clip=0.5, mu_dtype=torch.bfloat16)
    params = _to_torch(_random_tree(rng, 1.0, jnp.float32))
    grads = _to_torch(_random_tree(rng, 0.3, jnp.float32))
    state = tx.init(params)
    updates, want_state = tx.update(grads, state, params)
    want = ttrain.tree_map(ttrain.apply_updates, params, updates)
    norm = tx.step_(grads, state, params)
    torch.testing.assert_close(norm, ttrain.global_norm(grads))
    for a, b in zip(ttrain.tree_leaves(want) + ttrain.tree_leaves(
            want_state["mu"]) + ttrain.tree_leaves(want_state["nu"]),
            ttrain.tree_leaves(params) + ttrain.tree_leaves(state["mu"])
            + ttrain.tree_leaves(state["nu"])):
        assert torch.equal(a, b)
    assert int(state["count"]) == 1


def test_schedule_matches_optax():
    for warmup, total in ((3, 10), (1, 2), (1, 50)):
        jsched = optax.warmup_cosine_decay_schedule(0.0, 3e-4, warmup, total)
        tsched = ttrain.warmup_cosine_decay_schedule(0.0, 3e-4, warmup, total)
        for c in range(total + 3):
            np.testing.assert_allclose(
                float(tsched(torch.tensor(c, dtype=torch.int32))),
                float(jsched(c)), rtol=1e-6, atol=1e-12)
    # no cosine part: both refuse it
    with pytest.raises(ValueError):
        optax.warmup_cosine_decay_schedule(0.0, 3e-4, 4, 4)
    with pytest.raises(ValueError):
        ttrain.warmup_cosine_decay_schedule(0.0, 3e-4, 4, 4)


def _pair(**kw):
    cj = jcfg.tiny_config(**kw)
    ct = tcfg.tiny_config(**kw)
    return cj, ct


def _batch(cfg, b=2, t=16, seed=0):
    toks = np.random.RandomState(seed).randint(
        0, cfg.vocab_size, size=(b, t + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_train_steps_match_reference(impl, monkeypatch):
    """5 steps from the same params and batch: loss and grad_norm at every
    step, and the params after the last, within fp32 2e-4.

    The peak learning rate is 1e-3, not test_models' 1e-2: Adam's update
    g / (|g| + 1e-8) turns fp32 summation-order noise in a gradient element
    near zero into an O(lr) difference, so the params bound scales with lr
    (test_train_steps_at_lr_1e2_part_only_where_the_gradient_vanishes)."""
    cj, ct = _pair(attention_impl=impl)
    kw = dict(warmup_steps=2, total_steps=10)
    jtx = jtrain.make_optimizer(1e-3, **kw)
    ttx = ttrain.make_optimizer(1e-3, **kw)
    jstate = jtrain.init_train_state(jax.random.key(0), cj, jtx)
    params = params_from_numpy(jax.tree.map(np.asarray, jstate["params"]),
                               ct, device="cpu")
    tstate = {"step": torch.zeros((), dtype=torch.int32), "params": params,
              "opt_state": ttx.init(params)}
    inputs, targets = _batch(cj)
    jbatch = {"inputs": jnp.asarray(inputs), "targets": jnp.asarray(targets)}
    tbatch = {"inputs": torch.from_numpy(inputs),
              "targets": torch.from_numpy(targets)}
    jstep = jtrain.make_train_step(cj, jtx)
    tstep = ttrain.make_train_step(ct, ttx)
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    bwd_calls = []
    plain_bwd = fa.flash_attention_bwd
    monkeypatch.setattr(fa, "flash_attention_bwd", lambda *a, **k: (
        bwd_calls.append(1), plain_bwd(*a, **k))[1])
    before = (fa.launches, fa.launches_dq, fa.launches_dkv)
    got, want = [], []
    for _ in range(5):
        jstate, jm = jstep(jstate, jbatch)
        tstate, tm = tstep(tstate, tbatch)
        want.append((float(jm["loss"]), float(jm["grad_norm"])))
        got.append((float(tm["loss"]), float(tm["grad_norm"])))
        assert int(tm["step"]) == int(jm["step"])
    # CPU tensors never launch a kernel; "pallas" backpropagates through
    # _Flash3 and the plain B2/B3, once per layer and step
    assert (fa.launches, fa.launches_dq, fa.launches_dkv) == before
    assert len(bwd_calls) == (5 * ct.n_layers if impl == "pallas" else 0)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert got[-1][0] < got[0][0]
    assert _max_diff(jstate["params"], tstate["params"]) <= 2e-4
    assert _max_diff(jstate["opt_state"][1][0].nu,
                     tstate["opt_state"]["nu"]) <= 2e-4


def test_train_steps_at_lr_1e2_part_only_where_the_gradient_vanishes():
    """At test_models' lr 1e-2 the 5-step losses and grad norms agree
    within 2e-4, and so do the params, except elements whose gradient at
    the start is below 1e-7 on both sides: there Adam's g / (|g| + 1e-8)
    turns fp32 summation-order noise into an O(lr) step. This is why
    test_train_steps_match_reference runs at lr 1e-3."""
    from ray_tpu.models import transformer as jtr
    from ray_tpu_torch.models import transformer as ttr

    cj, ct = _pair(attention_impl="xla")
    kw = dict(warmup_steps=2, total_steps=10)
    jtx = jtrain.make_optimizer(1e-2, **kw)
    ttx = ttrain.make_optimizer(1e-2, **kw)
    jstate = jtrain.init_train_state(jax.random.key(0), cj, jtx)
    params = params_from_numpy(jax.tree.map(np.asarray, jstate["params"]),
                               ct, device="cpu")
    inputs, targets = _batch(cj)
    jbatch = {"inputs": jnp.asarray(inputs), "targets": jnp.asarray(targets)}
    tbatch = {"inputs": torch.from_numpy(inputs),
              "targets": torch.from_numpy(targets)}
    jgrads = jax.tree.leaves(jax.jit(jax.grad(
        lambda p: jtr.loss_fn(p, jbatch, cj)[0]))(jstate["params"]))
    leaves = [p.clone().requires_grad_(True)
              for p in ttrain.tree_leaves(params)]
    tgrads = torch.autograd.grad(
        ttr.loss_fn(ttrain._unflatten(params, leaves), tbatch, ct)[0], leaves)
    tstate = {"step": torch.zeros((), dtype=torch.int32), "params": params,
              "opt_state": ttx.init(params)}
    jstep = jtrain.make_train_step(cj, jtx)
    tstep = ttrain.make_train_step(ct, ttx)
    got, want = [], []
    for _ in range(5):
        jstate, jm = jstep(jstate, jbatch)
        tstate, tm = tstep(tstate, tbatch)
        want.append((float(jm["loss"]), float(jm["grad_norm"])))
        got.append((float(tm["loss"]), float(tm["grad_norm"])))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    for a, b, gj, gt in zip(jax.tree.leaves(jstate["params"]),
                            ttrain.tree_leaves(tstate["params"]), jgrads,
                            tgrads):
        apart = np.abs(np.asarray(a) - b.numpy()) > 2e-4
        assert np.abs(np.asarray(gj))[apart].max(initial=0) < 1e-7
        assert gt.abs().numpy()[apart].max(initial=0) < 1e-7


def test_remat_gives_the_same_step():
    """remat=True (each layer under torch.utils.checkpoint) and remat=False
    give the same loss and params after a step."""
    ct = tcfg.tiny_config(attention_impl="pallas")
    inputs, targets = _batch(ct, seed=3)
    batch = {"inputs": torch.from_numpy(inputs),
             "targets": torch.from_numpy(targets)}
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(ct, remat=remat)
        tx = ttrain.make_optimizer(1e-2)
        state = ttrain.init_train_state(torch.Generator().manual_seed(0),
                                        cfg, tx, device="cpu")
        state, m = ttrain.make_train_step(cfg, tx)(state, batch)
        out.append((m, state["params"]))
    (m0, p0), (m1, p1) = out
    torch.testing.assert_close(m1["loss"], m0["loss"], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(m1["grad_norm"], m0["grad_norm"], rtol=1e-5,
                               atol=1e-6)
    for a, b in zip(ttrain.tree_leaves(p0), ttrain.tree_leaves(p1)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_remat_policy_dots_and_mesh_raise():
    """remat_policy="dots" trains: a step from the same state gives the
    "nothing" step's loss, grad norm and params. A mesh that is not a
    DeviceMesh raises (meshes run in tests/test_torch_parallel_train.py)."""
    ct = tcfg.tiny_config(remat=True, attention_impl="pallas")
    inputs, targets = _batch(ct)
    batch = {"inputs": torch.from_numpy(inputs),
             "targets": torch.from_numpy(targets)}
    out = []
    for policy in ("nothing", "dots"):
        cfg = dataclasses.replace(ct, remat_policy=policy)
        tx = ttrain.make_optimizer(1e-2)
        state = ttrain.init_train_state(torch.Generator().manual_seed(0),
                                        cfg, tx, device="cpu")
        state, m = ttrain.make_train_step(cfg, tx)(state, batch)
        out.append((m, state["params"]))
    (m0, p0), (m1, p1) = out
    torch.testing.assert_close(m1["loss"], m0["loss"], rtol=0, atol=1e-6)
    torch.testing.assert_close(m1["grad_norm"], m0["grad_norm"], rtol=1e-6,
                               atol=1e-6)
    for a, b in zip(ttrain.tree_leaves(p0), ttrain.tree_leaves(p1)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    tx = ttrain.make_optimizer()
    with pytest.raises(TypeError, match="mesh"):
        ttrain.make_train_step(ct, tx, mesh=object())
    with pytest.raises(TypeError, match="mesh"):
        ttrain.init_train_state(torch.Generator(), ct, tx, mesh=object(),
                                device="cpu")


def test_loss_decreases_single_device():
    """Mirrors tests/test_models.py::test_loss_decreases_single_device."""
    cfg = tcfg.tiny_config()
    tx = ttrain.make_optimizer(1e-2, warmup_steps=0)
    state = ttrain.init_train_state(torch.Generator().manual_seed(0), cfg, tx,
                                    device="cpu")
    step = ttrain.make_train_step(cfg, tx)
    inputs, targets = _batch(cfg)
    batch = {"inputs": torch.from_numpy(inputs),
             "targets": torch.from_numpy(targets)}
    losses = []
    for _ in range(10):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] * 0.9, losses
    assert int(state["step"]) == 10
    for p in ttrain.tree_leaves(state["params"]):
        assert not p.requires_grad


def test_eval_step_matches_loss():
    from ray_tpu_torch.models import transformer as ttr

    cfg = tcfg.tiny_config()
    params = ttr.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    inputs, targets = _batch(cfg)
    batch = {"inputs": torch.from_numpy(inputs),
             "targets": torch.from_numpy(targets)}
    metrics = ttrain.make_eval_step(cfg)(params, batch)
    loss, _ = ttr.loss_fn(params, batch, cfg)
    torch.testing.assert_close(metrics["loss"], loss.detach())
    assert not metrics["loss"].requires_grad


def test_module_parameters_receive_gradients():
    """The nn.Module wrapper's parameters are trainable: a backward through
    it fills every parameter's .grad, equal to autograd on the dict."""
    from ray_tpu_torch.models import transformer as ttr

    cfg = tcfg.tiny_config(attention_impl="pallas")
    params = ttr.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    inputs, _ = _batch(cfg)
    module = ttr.Transformer(params, cfg)
    module(torch.from_numpy(inputs)).float().square().mean().backward()
    leaves = [p.detach().clone().requires_grad_(True)
              for p in ttrain.tree_leaves(params)]
    logits = ttr.forward(ttrain._unflatten(params, leaves),
                         torch.from_numpy(inputs), cfg)
    want = torch.autograd.grad(logits.float().square().mean(), leaves)
    got = ttrain.tree_leaves(module.params())
    for p, w in zip(got, want):
        assert p.grad is not None
        torch.testing.assert_close(p.grad, w)
