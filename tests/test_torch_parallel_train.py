"""The port's meshed train step, eval step and forward against the JAX
package's unmeshed ones on the CPU, and ``dryrun_multichip(8, device="cpu")``.

One gloo world of 8 ranks (``tests/torch_parallel_ranks.train_rank``) runs
every case: two AdamW steps (lr 1e-3, ROADMAP C2) on four of the dry
run's dense meshes, those that split only tokens (the model axes have
their own modules: test_torch_tensor_parallel.py, test_torch_pipeline.py,
test_torch_moe_parallel.py), and MoE on fsdp=8, from the JAX package's initial params
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
from torch_parallel_checks import (LR, STEPS, TOL, batches, check_metric,
                                   check_steps, jax_steps, np_tree)
from torch_parallel_ranks import one_world_at_a_time, train_rank
from torch_port_util import one_torch_thread  # noqa: F401 (fixture)
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


@pytest.fixture(scope="module")
def runs():
    """(rank 0's results, the JAX references, the dry run's result or
    error). The JAX side runs first, then the world, then the dry run's
    world, one test module's worlds at a time on the host
    (``one_world_at_a_time``)."""
    batch, eval_batch = batches()
    cj, cm = jcfg.tiny_config(**DENSE_CFG), jcfg.tiny_config(**MOE_CFG)
    tx = jtrain.make_optimizer(LR)
    dense0 = jtrain.init_train_state(jax.random.key(0), cj, tx)
    moe0 = jtrain.init_train_state(jax.random.key(0), cm, tx)
    spec = {"dense_cfg": DENSE_CFG, "moe_cfg": MOE_CFG,
            "dense_meshes": [(n, m, r) for n, (m, r) in DENSE_MESHES.items()],
            "dense_params": np_tree(dense0["params"]),
            "moe_params": np_tree(moe0["params"]), "batch": batch,
            "eval_batch": eval_batch, "steps": STEPS, "lr": LR}

    jeval = {k: jnp.asarray(v) for k, v in eval_batch.items()}
    # eval and forward first: the train steps donate the params
    refs = {"eval": {k: float(v) for k, v in jtrain.make_eval_step(cj)(
                dense0["params"], jeval).items()},
            "logits": np.asarray(jtr.forward(dense0["params"],
                                             jeval["inputs"], cj))}
    refs.update(dense=jax_steps(cj, spec["dense_params"], batch),
                moe=jax_steps(cm, spec["moe_params"], batch))
    with one_world_at_a_time():
        out = run_world(train_rank, 8, (spec,), device="cpu", timeout=300)
        try:
            dry = dryrun_multichip(8, device="cpu", timeout=300)
        except Exception as e:  # the dry run's own test reports it
            dry = e
    return out[0], refs, dry


@pytest.mark.parametrize("name", list(DENSE_MESHES))
def test_meshed_train_step_matches_jax(runs, name):
    out, refs, _ = runs
    check_steps(out["train"][name], refs["dense"],
                 ("loss", "grad_norm", "perplexity"))


def test_meshed_moe_train_step_matches_jax(runs):
    """MoE on fsdp=8: the Switch aux loss from global frac and mean_p (each
    rank routes its own rows), its weight in the gradient, a tied head."""
    out, refs, _ = runs
    check_steps(out["train"]["moe_fsdp8"], refs["moe"],
                 ("loss", "grad_norm", "moe_aux", "total_loss"))


def test_meshed_eval_step_matches_jax(runs):
    """The masked loss on data=2 x fsdp=2 x sequence=2: the global masked
    mean from each rank's share."""
    out, refs, _ = runs
    assert set(out["eval"]) == set(refs["eval"])
    for k, v in refs["eval"].items():
        check_metric(k, out["eval"][k], v)


def test_meshed_forward_returns_sharded_logits(runs):
    out, refs, _ = runs
    placements = out["forward"]["placements"]
    assert placements[0] == "S(0)" and placements[1] == "S(0)", placements
    assert placements[4] == "S(1)", placements
    assert np.abs(out["forward"]["logits"] - refs["logits"]).max() <= TOL


def test_dryrun_multichip_cpu(runs):
    """dryrun_multichip(8, device="cpu"): the reference's five dense and two
    MoE meshes plus sequence=4 x fsdp=2 (dense) and data=2 x fsdp=4 (MoE)
    in a gloo world of 8, each group's losses within 2e-3."""
    _, _, dry = runs
    if isinstance(dry, Exception):
        raise dry
    assert len(dry["dense"]) == 6 and len(dry["moe"]) == 3
    assert dry["dense_spread"] < 2e-3 and dry["moe_spread"] < 2e-3
