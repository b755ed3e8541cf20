"""One training scenario through ``ray_tpu.train.JaxTrainer`` and through
``ray_tpu_torch.train.TorchTrainer``, run one package after the other, as
tests/test_torch_runtime_api.py runs its scenario.

Setup: ``tiny_config`` in fp32, the same params (JAX's init, carried across
by ``interop.params_from_numpy``), the same batch, and each package's
``make_optimizer`` at lr 1e-3 (tests/test_torch_training.py says why 1e-3).
The run: 5 steps, a checkpoint every step, the best 2 by loss kept, a
failure after step 3 and a gang restart from the step-3 checkpoint. Then
the JAX run's step-3 state, carried across by
``interop.train_state_from_numpy``, resumes in the port; the MLM loop of
tests/test_encoder.py on 2 workers; and two workers on the backend's gloo
group train on ``make_mesh(data=2)``. Tolerance: fp32 2e-4."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ray_tpu
import ray_tpu.train  # noqa: F401 (ray_tpu's submodules load on import)
import ray_tpu_torch
from ray_tpu.models import config as jcfg
from ray_tpu.models import training as jtrain
from ray_tpu.models import transformer as jtr
from ray_tpu.models.mlm import mask_tokens as jmask_tokens
from ray_tpu_torch.interop import params_from_numpy, train_state_from_numpy
from ray_tpu_torch.models import config as tcfg
from ray_tpu_torch.models import training as ttrain
from torch_port_util import one_torch_thread  # noqa: F401 (fixture)
from torch_train_loops import (FAIL_AFTER as _FAIL_AFTER, STEPS as _STEPS,
                               data_loop, mlm_loop, torch_loop)

_TOL = 2e-4


def _params(seed: int = 0, **kw):
    cfg = jcfg.tiny_config(dtype=jnp.float32, param_dtype=jnp.float32, **kw)
    return jax.tree.map(np.asarray, jtr.init_params(jax.random.key(seed),
                                                    cfg))


def _batch(b: int = 2, t: int = 16, seed: int = 0):
    toks = np.random.RandomState(seed).randint(
        0, 256, size=(b, t + 1)).astype(np.int32)
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}


# ---------------------------------------------------------------- the loops


def _jax_loop(config):
    """The scenario in a JaxTrainer worker."""
    import jax.numpy as jnp

    from ray_tpu import train
    from ray_tpu.models import config as C
    from ray_tpu.models import training as TR

    cfg = C.tiny_config(dtype=jnp.float32, param_dtype=jnp.float32)
    tx = TR.make_optimizer(1e-3)
    ckpt = train.get_checkpoint()
    if ckpt is None:
        params = jax.tree.map(jnp.asarray, config["params"])
        state = {"step": jnp.zeros((), jnp.int32), "params": params,
                 "opt_state": tx.init(params)}
    else:
        state = ckpt.to_pytree()[0]
    step = TR.make_train_step(cfg, tx)
    batch = {k: jnp.asarray(v) for k, v in config["batch"].items()}
    for i in range(int(state["step"]) + 1, _STEPS + 1):
        state, m = step(state, batch)
        saved = train.Checkpoint.from_pytree(state)
        if i == _FAIL_AFTER:
            saved.to_directory(config["keep"])
        train.report({"step": i, "loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"])}, checkpoint=saved)
        if i == _FAIL_AFTER and not os.path.exists(config["marker"]):
            open(config["marker"], "w").close()
            raise RuntimeError("worker down")


# ---------------------------------------------------------------- the runs


def _run(pkg, loop, tmp_path, name, config, **kw):
    trainer_cls = (pkg.train.JaxTrainer if pkg is ray_tpu
                   else pkg.train.TorchTrainer)
    return trainer_cls(loop, train_loop_config=config, run_config=(
        pkg.train.RunConfig(
            name=name, storage_path=str(tmp_path),
            checkpoint_config=pkg.train.CheckpointConfig(
                num_to_keep=2, checkpoint_score_attribute="loss",
                checkpoint_score_order="min"),
            failure_config=pkg.train.FailureConfig(max_failures=1))),
        **kw).fit()


def _scenario_config(tmp_path, tag):
    return {"params": _params(), "batch": _batch(),
            "marker": str(tmp_path / f"{tag}_failed"),
            "keep": str(tmp_path / f"{tag}_step3")}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The scenario through the JAX package, run once for the module."""
    tmp_path = tmp_path_factory.mktemp("jax")
    ray_tpu.init(num_cpus=4, num_tpus=0)
    try:
        result = _run(ray_tpu, _jax_loop, tmp_path, "parity",
                      _scenario_config(tmp_path, "jax"))
    finally:
        ray_tpu.shutdown()
    return result, tmp_path


@pytest.fixture(scope="module")
def rt():
    ray_tpu_torch.init(num_cpus=4, num_gpus=0, ignore_reinit_error=True)
    yield
    ray_tpu_torch.shutdown()


def _kept(pkg, result):
    root = os.path.join(result.path, "checkpoints")
    return {d: pkg.train.Checkpoint.from_directory(os.path.join(root, d))
            for d in sorted(os.listdir(root))}


def _max_diff(jtree, ttree):
    return max(float(np.abs(np.asarray(a, np.float32) - b.numpy()).max())
               for a, b in zip(jax.tree.leaves(jtree),
                               ttrain.tree_leaves(ttree)))


def _history(result):
    return [(m["step"], m["loss"], m["grad_norm"])
            for m in result.metrics_history]


def test_same_scenario_through_jax_and_torch_trainers(reference, rt,
                                                      tmp_path):
    jres, _ = reference
    tres = _run(ray_tpu_torch, torch_loop, tmp_path, "parity",
                _scenario_config(tmp_path, "torch"))
    assert jres.error is None and tres.error is None
    want, got = _history(jres), _history(tres)
    # steps 1-3, the failure, then 4-5 from the step-3 checkpoint
    assert [s for s, _, _ in got] == [s for s, _, _ in want] == \
        list(range(1, _STEPS + 1))
    np.testing.assert_allclose([r[1:] for r in got], [r[1:] for r in want],
                               rtol=_TOL, atol=_TOL)
    # the best 2 by loss, kept by both: the same steps, the same params
    jkept, tkept = _kept(ray_tpu, jres), _kept(ray_tpu_torch, tres)
    assert list(jkept) == list(tkept) == ["checkpoint_000003",
                                          "checkpoint_000004"]
    for d in jkept:
        jstate, _ = jkept[d].to_pytree()
        tstate, _ = tkept[d].to_pytree()
        assert int(jstate["step"]) == int(tstate["step"])
        assert _max_diff(jstate["params"], tstate["params"]) <= _TOL
        assert _max_diff(jstate["opt_state"][1][0].nu,
                         tstate["opt_state"]["nu"]) <= _TOL
    assert int(tres.checkpoint.to_pytree()[0]["step"]) == _STEPS


def test_jax_step3_state_resumes_in_the_port(reference, rt, tmp_path):
    """The JAX run's step-3 checkpoint, as numpy, through
    interop.train_state_from_numpy into a TorchTrainer's
    resume_from_checkpoint: its steps 4-5 are the JAX run's."""
    jres, jdir = reference
    jstate, _ = ray_tpu.train.Checkpoint.from_directory(
        str(jdir / "jax_step3")).to_pytree()
    assert int(jstate["step"]) == _FAIL_AFTER
    state = train_state_from_numpy(jstate, tcfg.tiny_config(
        dtype=torch.float32, param_dtype=torch.float32), device="cpu")
    assert int(state["opt_state"]["count"]) == _FAIL_AFTER
    tres = ray_tpu_torch.train.TorchTrainer(
        torch_loop, train_loop_config={"params": None, "batch": _batch(),
                                       "marker": None},
        run_config=ray_tpu_torch.train.RunConfig(
            name="resumed", storage_path=str(tmp_path)),
        resume_from_checkpoint=ray_tpu_torch.train.Checkpoint.from_pytree(
            state)).fit()
    assert tres.error is None
    got = _history(tres)
    want = _history(jres)[_FAIL_AFTER:]
    assert [s for s, _, _ in got] == [s for s, _, _ in want] == [4, 5]
    np.testing.assert_allclose([r[1:] for r in got], [r[1:] for r in want],
                               rtol=_TOL, atol=_TOL)


def test_bert_style_torch_trainer(rt, tmp_path):
    """tests/test_encoder.py::test_bert_style_jax_trainer's MLM loop
    (causal=False, models/mlm.py) on 2 gloo workers; rank 0's losses
    against the same loop in JAX (optax.adam) in this process."""
    cfg = dataclasses.replace(
        jcfg.tiny_config(dtype=jnp.float32, param_dtype=jnp.float32),
        causal=False, remat=False)
    params = _params()
    result = ray_tpu_torch.train.TorchTrainer(
        mlm_loop, train_loop_config={"params": params},
        scaling_config=ray_tpu_torch.train.ScalingConfig(num_workers=2),
        run_config=ray_tpu_torch.train.RunConfig(
            name="bert_mlm", storage_path=str(tmp_path))).fit()
    assert result.error is None
    got = [m["mlm_loss"] for m in result.metrics_history]
    assert all(m["rank"] == 0 for m in result.metrics_history)
    assert len(got) == 10 and got[-1] < got[0]

    rng = np.random.default_rng(0)
    toks = rng.integers(4, cfg.vocab_size, size=(8, 32))
    batch = {k: jnp.asarray(v) for k, v in jmask_tokens(
        toks, mask_id=3, vocab_size=cfg.vocab_size, rng=rng).items()}
    opt = optax.adam(1e-3)
    p = jax.tree.map(jnp.asarray, params)
    opt_state = opt.init(p)

    @jax.jit
    def step(p, opt_state):
        (loss, _), grads = jax.value_and_grad(
            lambda q: jtr.loss_fn(q, batch, cfg), has_aux=True)(p)
        upd, opt_state = opt.update(grads, opt_state, p)
        return optax.apply_updates(p, upd), opt_state, loss

    want = []
    for _ in range(10):
        p, opt_state, loss = step(p, opt_state)
        want.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=_TOL, atol=_TOL)


def test_data_mesh_on_the_backend_group_equals_the_unmeshed_step(rt,
                                                                 tmp_path):
    """Two workers on the TorchConfig's gloo group build make_mesh(data=2)
    on it; each meshed step on the global batch equals the unmeshed step,
    the port's and the JAX package's."""
    params, batch = _params(), _batch(b=4)
    result = ray_tpu_torch.train.TorchTrainer(
        data_loop, train_loop_config={"params": params, "batch": batch},
        scaling_config=ray_tpu_torch.train.ScalingConfig(num_workers=2),
        run_config=ray_tpu_torch.train.RunConfig(
            name="data2", storage_path=str(tmp_path))).fit()
    assert result.error is None
    hist = result.metrics_history
    assert all(m["mesh"]["data"] == 2 for m in hist)
    got = [(m["loss"], m["grad_norm"]) for m in hist]

    ct = tcfg.tiny_config(dtype=torch.float32, param_dtype=torch.float32)
    tx = ttrain.make_optimizer(1e-3)
    tp = params_from_numpy(params, ct, "cpu")
    tstate = {"step": torch.zeros((), dtype=torch.int32), "params": tp,
              "opt_state": tx.init(tp)}
    tstep = ttrain.make_train_step(ct, tx)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    cj = jcfg.tiny_config(dtype=jnp.float32, param_dtype=jnp.float32)
    jtx = jtrain.make_optimizer(1e-3)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = {"step": jnp.zeros((), jnp.int32), "params": jp,
              "opt_state": jtx.init(jp)}
    jstep = jtrain.make_train_step(cj, jtx)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    unmeshed, jax_side = [], []
    for _ in range(2):
        _, tm = tstep(tstate, tbatch)
        unmeshed.append((tm["loss"].item(), tm["grad_norm"].item()))
        jstate, jm = jstep(jstate, jbatch)
        jax_side.append((float(jm["loss"]), float(jm["grad_norm"])))
    np.testing.assert_allclose(got, unmeshed, rtol=_TOL, atol=_TOL)
    np.testing.assert_allclose(got, jax_side, rtol=_TOL, atol=_TOL)
