"""The port's meshed train step, eval step and forward against the JAX
package's unmeshed ones on the CPU, ``dryrun_multichip(8, device="cpu")``,
and the refusals of what this slice does not run.

One gloo world of 8 ranks (``tests/torch_parallel_ranks.train_rank``) runs
every case: two AdamW steps (lr 1e-3, ROADMAP C2) on each dense mesh of
the dry run and MoE on fsdp=8, from the JAX package's initial params
(placed as DTensors by ``interop.shard_state``) and one batch [8, 32]. The
JAX side runs the same steps unmeshed before the world starts; as the dry
run's own gate holds meshes against each other, each mesh is held here
against that one reference: loss and grad_norm at both steps, and every
param after them, fp32, 2e-4. The exception is ROADMAP C2's: where the
starting gradient is below 1e-7, Adam's g / (|g| + 1e-8) turns fp32
summation-order noise into an O(lr) step (one `wo` element with
|g| = 2.1e-8 ends 2.07e-4 apart on sequence=4 x fsdp=2), so there the
bound is what two such steps can do, 2 x lr. Two meshes run under remat
("dots" and "nothing"), so the backward gathers again and reruns the
ring's P2P.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ray_tpu.models import config as jcfg
from ray_tpu.models import training as jtrain
from ray_tpu.models import transformer as jtr
from ray_tpu_torch.entry import dryrun_multichip
from ray_tpu_torch.parallel.world import run_world
from torch_parallel_ranks import one_world_at_a_time, train_rank
from torch_port_util import one_torch_thread  # noqa: F401 (fixture)

TOL, LR, STEPS = 2e-4, 1e-3, 2
VANISHING = 1e-7  # ROADMAP C2: a starting gradient this small
DENSE_CFG = {}
MOE_CFG = dict(moe_experts=4, tie_embeddings=True)
# name -> (mesh, remat settings of the port's config)
DENSE_MESHES = {
    "data2_fsdp2_seq2": (dict(data=2, fsdp=2, sequence=2),
                         dict(remat=True, remat_policy="dots")),
    "fsdp8": (dict(fsdp=8), {}),
    "slices2_fsdp4": (dict(slices=2, fsdp=4), {}),
    "seq4_fsdp2": (dict(sequence=4, fsdp=2),
                   dict(remat=True, remat_policy="nothing")),
}
REFUSED = ("tensor", "pipeline", "expert", "moe_sequence", "engine")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batches():
    rng = np.random.RandomState(7)
    toks = rng.randint(0, 256, size=(8, 33)).astype(np.int32)
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    mask = (rng.rand(8, 32) < 0.7).astype(np.float32)
    return batch, {**batch, "mask": mask}


def _jax_steps(cfg, state, batch):
    """STEPS unmeshed JAX steps -> metrics, params and the starting grads."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    grads = _np_tree(jax.grad(lambda p: jtr.loss_fn(p, jb, cfg)[0])(
        state["params"]))
    tx = jtrain.make_optimizer(LR)
    state = {**state, "opt_state": tx.init(state["params"])}
    step = jtrain.make_train_step(cfg, tx)
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, jb)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "params": _np_tree(state["params"]),
            "grads": grads}


@pytest.fixture(scope="module")
def runs():
    """(rank 0's results, the JAX references, the dry run's result or
    error). The JAX side runs first, then the world, then the dry run's
    world, one test module's worlds at a time on the host
    (``one_world_at_a_time``)."""
    batch, eval_batch = _batches()
    cj, cm = jcfg.tiny_config(**DENSE_CFG), jcfg.tiny_config(**MOE_CFG)
    tx = jtrain.make_optimizer(LR)
    dense0 = jtrain.init_train_state(jax.random.key(0), cj, tx)
    moe0 = jtrain.init_train_state(jax.random.key(0), cm, tx)
    spec = {"dense_cfg": DENSE_CFG, "moe_cfg": MOE_CFG,
            "dense_meshes": [(n, m, r) for n, (m, r) in DENSE_MESHES.items()],
            "dense_params": _np_tree(dense0["params"]),
            "moe_params": _np_tree(moe0["params"]), "batch": batch,
            "eval_batch": eval_batch, "steps": STEPS, "lr": LR}

    jeval = {k: jnp.asarray(v) for k, v in eval_batch.items()}
    # eval and forward first: the train steps donate the params
    refs = {"eval": {k: float(v) for k, v in jtrain.make_eval_step(cj)(
                dense0["params"], jeval).items()},
            "logits": np.asarray(jtr.forward(dense0["params"],
                                             jeval["inputs"], cj))}
    refs.update(dense=_jax_steps(cj, dense0, batch),
                moe=_jax_steps(cm, moe0, batch))
    with one_world_at_a_time():
        out = run_world(train_rank, 8, (spec,), device="cpu", timeout=300)
        try:
            dry = dryrun_multichip(8, device="cpu", timeout=300)
        except Exception as e:  # the dry run's own test reports it
            dry = e
    return out[0], refs, dry


def _check_params(got, want):
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


def _check_metric(k, got, want):
    """Within TOL; perplexity, exp(loss), relatively."""
    scale = abs(want) if k == "perplexity" else 1.0
    assert abs(got - want) <= TOL * scale, (k, got, want)


def _check_steps(got, want, keys):
    for g, w in zip(got["metrics"], want["metrics"]):
        for k in keys:
            _check_metric(k, g[k], w[k])
    _check_params(got, want)


@pytest.mark.parametrize("name", list(DENSE_MESHES))
def test_meshed_train_step_matches_jax(runs, name):
    out, refs, _ = runs
    _check_steps(out["train"][name], refs["dense"],
                 ("loss", "grad_norm", "perplexity"))


def test_meshed_moe_train_step_matches_jax(runs):
    """MoE on fsdp=8: the Switch aux loss from global frac and mean_p (each
    rank routes its own rows), its weight in the gradient, a tied head."""
    out, refs, _ = runs
    _check_steps(out["train"]["moe_fsdp8"], refs["moe"],
                 ("loss", "grad_norm", "moe_aux", "total_loss"))


def test_meshed_eval_step_matches_jax(runs):
    """The masked loss on data=2 x fsdp=2 x sequence=2: the global masked
    mean from each rank's share."""
    out, refs, _ = runs
    assert set(out["eval"]) == set(refs["eval"])
    for k, v in refs["eval"].items():
        _check_metric(k, out["eval"][k], v)


def test_meshed_forward_returns_sharded_logits(runs):
    out, refs, _ = runs
    placements = out["forward"]["placements"]
    assert placements[0] == "S(0)" and placements[1] == "S(0)", placements
    assert placements[4] == "S(1)", placements
    assert np.abs(out["forward"]["logits"] - refs["logits"]).max() <= TOL


def test_dryrun_multichip_cpu(runs):
    """dryrun_multichip(8, device="cpu"): four dense meshes and two MoE
    meshes in a gloo world of 8, each group's losses within 2e-3."""
    _, _, dry = runs
    if isinstance(dry, Exception):
        raise dry
    assert len(dry["dense"]) == 4 and len(dry["moe"]) == 2
    assert dry["dense_spread"] < 2e-3 and dry["moe_spread"] < 2e-3


@pytest.mark.parametrize("what", REFUSED)
def test_refusals(runs, what):
    """tensor, pipeline and expert above 1, MoE with sequence above 1 and a
    meshed engine each raise NotImplementedError naming ROADMAP A1b."""
    out, _, _ = runs
    got = out["refused"][what]
    assert got and all(r.startswith("NotImplementedError") and "A1b" in r
                       for r in got), got
