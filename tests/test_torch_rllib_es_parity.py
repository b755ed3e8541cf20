"""ES and ARS of the port against the JAX package's, on the CPU: one
training_step from the same flat parameter vector and the same seeds. The
workers' greedy episodes (the reference's JAX forward, the port's torch
forward on the CPU) give the same returns, so the host-side numpy update
(ES's centered-rank Adam, ARS's top-k step) gives the same vector, bit for
bit. Each package's runtime runs in turn, one CPU worker each."""

import numpy as np
from torch_port_util import deadline, one_torch_thread  # noqa: F401

import ray_tpu
import ray_tpu.rllib as jr
import ray_tpu_torch
import ray_tpu_torch.rllib as tr

_KW = dict(model_hiddens=(8,), perturbations_per_step=6,
           episodes_per_perturbation=4, sigma=0.1, lr=0.05)


def _run(pkg, init, name, flat=None):
    """One training_step of ``name`` on ``pkg``'s runtime -> (the flat
    vector it started from, its state after the step)."""
    init()
    try:
        cfg = getattr(pkg, f"{name}Config")().environment(
            "StatelessGuess-v0").rollouts(num_rollout_workers=1).training(
                **_KW).debugging(seed=3)
        if pkg is tr:
            cfg = cfg.resources(device="cpu")
        algo = cfg.build()
        try:
            if flat is not None:
                assert flat.shape == algo._flat.shape
                algo._flat = flat.copy()
            start = algo._flat.copy()
            metrics = algo.training_step()
            state = {"flat": algo._flat.copy(), "metrics": metrics}
            if name == "ES":
                state.update(m=algo._m.copy(), v=algo._v.copy())
        finally:
            algo.stop()
    finally:
        pkg_shutdown = (ray_tpu if pkg is jr else ray_tpu_torch).shutdown
        pkg_shutdown()
    return start, state


@deadline(240)
def test_es_and_ars_steps_equal_the_reference():
    for name in ("ES", "ARS"):
        start, ref = _run(jr, lambda: ray_tpu.init(num_cpus=2, num_tpus=0),
                          name)
        _, got = _run(tr, lambda: ray_tpu_torch.init(num_cpus=2,
                                                     num_gpus=0),
                      name, flat=start)
        assert got["metrics"] == ref["metrics"], name
        for k in ref:
            if k != "metrics":
                np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        assert not np.array_equal(got["flat"], start)
        print(name, "metrics:", got["metrics"])
