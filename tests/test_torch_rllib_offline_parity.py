"""The offline algorithms of the port against the JAX package's, on the
CPU: BC, CQL and MARWIL each take one update from carried params (CQL's
target net apart from them, MARWIL's moving average of squared advantages
carried at a value away from its start) on a numpy batch; loss metrics and
grads within 1e-5 relative against the reference's loss closure under
jax.value_and_grad, the params after the step by
chip_smoke.adam_first_step_bound, MARWIL's carried average within 1e-5.
And .npz datasets cross between the packages both ways."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_port_util import one_torch_thread  # noqa: F401 (fixture)
from torch_rllib_parity import (check_grads, check_rel, check_step,
                                closure, j_tree, np_tree)

import ray_tpu.rllib as jr
import ray_tpu_torch.rllib as tr
from ray_tpu_torch.rllib.models import params_from_numpy

OBS, ACTS, HID, B = 4, 2, (32, 32), 128


def logged(seed=0, n=512):
    rng = np.random.default_rng(seed)
    return tr.SampleBatch({
        "obs": rng.normal(size=(n, OBS)).astype(np.float32),
        "actions": rng.integers(0, ACTS, n),
        "rewards": rng.normal(size=n).astype(np.float32),
        "dones": rng.random(n) < 0.1,
        "new_obs": rng.normal(size=(n, OBS)).astype(np.float32)})


def _build(pkg, name, path, lr):
    cfg = getattr(pkg, f"{name}Config")().environment("CartPole-v1") \
        .offline_data(input_path=path).training(model_hiddens=HID, lr=lr)
    if pkg is tr:
        cfg = cfg.resources(device="cpu")
    return cfg.build()


@pytest.mark.parametrize("name", ["BC", "CQL", "MARWIL"])
def test_offline_step_matches_reference(name, tmp_path):
    lr = 3e-3
    path = str(tmp_path / "data")
    tr.save_batches(path, [logged()])
    j, t = _build(jr, name, path, lr), _build(tr, name, path, lr)
    w = np_tree(j.params)
    w["w_pi"] = w["w_pi"] * 100.0  # a policy far from uniform
    j.params = j_tree(w)
    t.params = params_from_numpy(w, "cpu")
    args_j, extra = (), ()
    if name == "CQL":
        rng = np.random.default_rng(4)
        tgt = {k: v + 0.1 * rng.normal(size=v.shape).astype(np.float32)
               for k, v in w.items()}
        j.target_params = j_tree(tgt)
        t.target_params = params_from_numpy(tgt, "cpu")
        args_j = (j.target_params,)
    mb = tr.SampleBatch({k: v[:B] for k, v in logged(1).items()})
    cols = t.columns
    jb = {k: jnp.asarray(mb[k]) for k in cols}
    loss_fn = closure(j._train_step, "loss_fn")
    if name == "MARWIL":
        j.ma_adv_sq = jnp.asarray(2.5)
        t.ma_adv_sq = params_from_numpy(np.float32(2.5), "cpu")
        extra = (j.ma_adv_sq,)
    (loss, aux), g_r = jax.value_and_grad(loss_fn, has_aux=True)(
        j.params, *args_j, jb, *extra)
    metrics_r = aux[0] if name == "MARWIL" else aux
    metrics, g = t.train_step(t.to_device(mb))
    worst = {}
    check_rel(worst, "total_loss", metrics["total_loss"], loss)
    for k in metrics_r:
        check_rel(worst, k, metrics[k], metrics_r[k])
    check_grads(worst, "net", g, g_r)
    # the reference's own step
    if name == "MARWIL":
        new = j._train_step(j.params, j.opt_state, j.ma_adv_sq, jb)
        new_params, new_ma = new[0], new[2]
        check_rel(worst, "ma_adv_sq", t.ma_adv_sq, new_ma)
        assert abs(float(new_ma) - 2.5) > 1e-3
    elif name == "CQL":
        new_params = j._train_step(j.params, j.target_params, j.opt_state,
                                   jb)[0]
    else:
        new_params = j._train_step(j.params, j.opt_state, jb)[0]
    check_step(worst, "net", t.get_policy_weights(), np_tree(new_params),
               g, g_r, lr)
    print(name, "largest errors:", worst)


def test_datasets_cross_between_packages(tmp_path):
    """A save_batches directory of the JAX package loads in the port and
    the reverse, column for column and dtype for dtype."""
    a, b = logged(2, 64), logged(3, 96)
    jr.save_batches(str(tmp_path / "jax"), [a, b])
    tr.save_batches(str(tmp_path / "torch"), [a, b])
    for got in (tr.load_batches(str(tmp_path / "jax")),
                jr.load_batches(str(tmp_path / "torch"))):
        assert got.count == 160 and set(got) == set(a)
        for k in a:
            want = np.concatenate([a[k], b[k]])
            assert got[k].dtype == want.dtype
            np.testing.assert_array_equal(got[k], want)


def test_collect_dataset_loads_in_the_reference(tmp_path):
    """collect_dataset (the behaviour policy's forward on the CPU) writes
    shards the JAX package reads."""
    path = str(tmp_path / "logged")
    files = tr.collect_dataset("CartPole-v1", path, num_steps=128,
                               num_envs=4, epsilon=0.5, seed=1)
    assert files
    ds = jr.load_batches(path)
    assert ds.count == 128 and ds["actions"].dtype == np.int64
    assert set(ds.keys()) >= {"obs", "actions", "rewards", "dones",
                              "new_obs"}
