"""The port's Tune library (``ray_tpu_torch.tune``) on its runtime: the
cases of tests/test_tune.py (ref model: python/ray/tune/tests/ — SURVEY.md
§4.5)."""

import os
import tempfile

import pytest

import ray_tpu_torch
from ray_tpu_torch import tune
from torch_port_util import one_torch_thread  # noqa: F401 (fixture)


@pytest.fixture(scope="module")
def runtime():
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init(num_cpus=8, num_gpus=0)
    yield
    ray_tpu_torch.shutdown()


def test_grid_and_random_variants():
    space = {"a": tune.grid_search([1, 2, 3]), "b": tune.uniform(0, 1),
             "nest": {"c": tune.choice(["x", "y"])}}
    variants = list(tune.search.generate_variants(space, num_samples=2,
                                                  seed=0))
    assert len(variants) == 6
    assert {v["a"] for v in variants} == {1, 2, 3}
    assert all(0 <= v["b"] <= 1 for v in variants)
    assert all(v["nest"]["c"] in ("x", "y") for v in variants)


def test_function_api_fit(runtime):
    def objective(config):
        score = 0.0
        for i in range(5):
            score += config["lr"]
            tune.report({"score": score})

    results = tune.Tuner(
        objective,
        param_space={"lr": tune.grid_search([0.1, 0.5, 1.0])},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
    ).fit()
    assert len(results) == 3
    best = results.get_best_result()
    assert best.config["lr"] == 1.0
    assert best.metrics["score"] == pytest.approx(5.0)


def test_class_api_and_stop_criteria(runtime):
    class MyTrainable(tune.Trainable):
        def setup(self, config):
            self.x = config["start"]

        def step(self):
            self.x += 1
            return {"x": self.x}

        def save_checkpoint(self):
            return {"x": self.x}

        def load_checkpoint(self, ckpt):
            self.x = ckpt["x"]

    results = tune.run(MyTrainable, config={"start": 0},
                       stop={"training_iteration": 4},
                       metric="x", mode="max")
    assert results[0].metrics["x"] == 4


def test_asha_stops_bad_trials(runtime):
    def objective(config):
        import time

        for i in range(20):
            # weak trials report slower (as in real HPO, where promising
            # configs are not systematically the last to arrive at a rung)
            time.sleep((1.0 - config["q"]) * 0.08)
            tune.report({"acc": config["q"] * (i + 1)})

    scheduler = tune.ASHAScheduler(metric="acc", mode="max", grace_period=2,
                                   max_t=20, reduction_factor=2)
    results = tune.Tuner(
        objective,
        param_space={"q": tune.grid_search([0.1, 0.2, 0.9, 1.0])},
        tune_config=tune.TuneConfig(metric="acc", mode="max",
                                    scheduler=scheduler,
                                    max_concurrent_trials=4),
    ).fit()
    best = results.get_best_result()
    assert best.config["q"] == pytest.approx(1.0)
    iters = {r.config["q"]: r.metrics.get("training_iteration", 0)
             for r in results}
    # the best trial ran to max_t; at least one poor trial stopped early
    assert iters[1.0] == 20
    assert min(iters.values()) < 20


def test_trial_failure_retry(runtime):
    marker = os.path.join(tempfile.mkdtemp(), "attempts")

    def flaky(config):
        n = 0
        if os.path.exists(marker):
            with open(marker) as f:
                n = int(f.read())
        with open(marker, "w") as f:
            f.write(str(n + 1))
        if n == 0:
            raise RuntimeError("boom")
        tune.report({"ok": 1})

    results = tune.Tuner(
        flaky, param_space={},
        tune_config=tune.TuneConfig(metric="ok", mode="max",
                                    max_failures=2),
    ).fit()
    assert results[0].metrics["ok"] == 1
    assert not results.errors


def test_error_surfaces_without_retry(runtime):
    def bad(config):
        raise ValueError("nope")

    results = tune.Tuner(bad, param_space={}).fit()
    assert len(results.errors) == 1
    assert "nope" in results.errors[0]


def test_pbt_smoke(runtime):
    def objective(config):
        lr = config["lr"]
        v = 0.0
        for i in range(12):
            v += lr
            tune.report({"v": v, "lr": lr})

    pbt = tune.PopulationBasedTraining(
        metric="v", mode="max", perturbation_interval=3,
        hyperparam_mutations={"lr": tune.uniform(0.1, 1.0)}, seed=0)
    results = tune.Tuner(
        objective,
        param_space={"lr": tune.uniform(0.1, 1.0)},
        tune_config=tune.TuneConfig(metric="v", mode="max", num_samples=4,
                                    scheduler=pbt,
                                    max_concurrent_trials=4),
    ).fit()
    assert len(results) == 4
    assert not results.errors
    assert results.get_best_result().metrics["v"] > 0


def test_experiment_state_persisted(runtime, tmp_path):
    def objective(config):
        tune.report({"m": 1})

    tune.Tuner(
        objective, param_space={},
        tune_config=tune.TuneConfig(metric="m", mode="max"),
        run_config=ray_tpu_torch.train.RunConfig(
            name="exp1", storage_path=str(tmp_path)),
    ).fit()
    import json

    state = json.load(open(tmp_path / "exp1" / "experiment_state.json"))
    assert state["trials"][0]["status"] == "TERMINATED"


def test_tpe_searcher_beats_random_on_synthetic():
    """Native TPE (ref wraps hyperopt/optuna for this class of searcher):
    on a smooth synthetic objective, TPE's best-of-60 should beat random
    search's, averaged over seeds."""
    import math
    import statistics

    from ray_tpu_torch.tune.search import (RandomSearch, TPESearcher,
                                           choice, loguniform, uniform)

    space = {"x": uniform(-2, 2), "lr": loguniform(1e-5, 1e-1),
             "act": choice(["relu", "tanh", "gelu"])}

    def objective(cfg):
        pen = 0.0 if cfg["act"] == "relu" else 1.0
        return -((cfg["x"] - 0.3) ** 2
                 + (math.log10(cfg["lr"]) + 3) ** 2 * 0.3 + pen)

    def best_of(searcher, n=60):
        best = -1e9
        for i in range(n):
            tid = f"t{i}"
            cfg = searcher.suggest(tid)
            score = objective(cfg)
            best = max(best, score)
            searcher.on_trial_complete(tid, {"reward": score})
        return best

    tpe = [best_of(TPESearcher(space, metric="reward", seed=s,
                               n_initial_points=10)) for s in range(6)]
    rnd = [best_of(RandomSearch(space, seed=s)) for s in range(6)]
    assert statistics.mean(tpe) > statistics.mean(rnd)


def test_tpe_in_tuner(runtime):
    """TPESearcher drives a real Tuner run end-to-end."""
    from ray_tpu_torch import tune

    def trainable(config):
        tune.report({"score": -(config["x"] - 1.0) ** 2})

    searcher = tune.TPESearcher({"x": tune.uniform(-4, 4)},
                                metric="score", n_initial_points=4, seed=0)
    results = tune.Tuner(
        trainable,
        tune_config=tune.TuneConfig(num_samples=16, metric="score",
                                    mode="max", search_alg=searcher),
    ).fit()
    best = results.get_best_result()
    assert best.metrics["score"] > -1.0  # found x near 1 (random often not)
