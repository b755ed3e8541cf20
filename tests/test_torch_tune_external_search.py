"""The port's OptunaSearch adapter (``ray_tpu_torch.tune``) against a fake
optuna module: the cases of tests/test_tune_external_search.py.

Ref analog: tune/tests/test_searchers.py — the adapter's translation
layer (space mapping, ask/tell protocol, failure reporting) is what we
own; the optimizer itself is external. A fake module makes that layer
testable on a sealed image with no optuna."""

import sys
import types

import pytest

import ray_tpu_torch
from ray_tpu_torch import tune


class _FakeTrial:
    def __init__(self, study):
        self.study = study
        self.params = {}

    def suggest_float(self, name, low, high, log=False, step=None):
        assert not (log and step), "optuna rejects log+step"
        v = low if not log else low * 1.5
        self.params[name] = ("float", low, high, log, step, v)
        return v

    def suggest_int(self, name, low, high, step=1):
        self.params[name] = ("int", low, high, step)
        return low

    def suggest_categorical(self, name, choices):
        self.params[name] = ("cat", tuple(choices))
        return choices[0]


class _FakeStudy:
    def __init__(self, direction, sampler):
        self.direction = direction
        self.sampler = sampler
        self.asked = []
        self.told = []

    def ask(self):
        t = _FakeTrial(self)
        self.asked.append(t)
        return t

    def tell(self, trial, value=None, state=None):
        self.told.append((trial, value, state))


def _install_fake_optuna(monkeypatch):
    mod = types.ModuleType("optuna")
    mod.samplers = types.SimpleNamespace(
        TPESampler=lambda seed=None: ("tpe", seed))
    mod.trial = types.SimpleNamespace(
        TrialState=types.SimpleNamespace(FAIL="FAIL"))
    created = []

    def create_study(direction, sampler):
        s = _FakeStudy(direction, sampler)
        created.append(s)
        return s

    mod.create_study = create_study
    monkeypatch.setitem(sys.modules, "optuna", mod)
    return created


@pytest.fixture
def ray_start():
    """Fresh single-node runtime of the port per test (4 CPUs)."""
    info = ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield info
    ray_tpu_torch.shutdown()


def test_import_error_names_native_alternative(monkeypatch):
    monkeypatch.setitem(sys.modules, "optuna", None)
    with pytest.raises(ImportError, match="TPESearcher"):
        tune.OptunaSearch({"lr": tune.uniform(0, 1)})


def test_space_mapping_and_tell(monkeypatch):
    created = _install_fake_optuna(monkeypatch)
    space = {
        "lr": tune.loguniform(1e-4, 1e-1),
        "layers": tune.randint(1, 5),
        "act": tune.choice(["relu", "gelu"]),
        "nested": {"dropout": tune.quniform(0.0, 0.5, 0.1)},
        "const": 7,
    }
    s = tune.OptunaSearch(space, metric="loss", mode="min", seed=3)
    study = created[0]
    assert study.direction == "minimize"
    assert study.sampler == ("tpe", 3)

    cfg = s.suggest("t1")
    assert cfg["const"] == 7
    assert cfg["act"] == "relu"
    assert cfg["layers"] == 1
    assert "dropout" in cfg["nested"]
    trial = study.asked[0]
    # loguniform -> log=True, no step; our randint upper is exclusive
    assert trial.params["lr"][3] is True and trial.params["lr"][4] is None
    assert trial.params["layers"][1:3] == (1, 4)
    assert trial.params["nested.dropout"][4] == 0.1  # quantized step

    s.on_trial_complete("t1", {"loss": 0.25})
    (told_trial, value, state) = study.told[0]
    assert told_trial is trial and value == 0.25 and state is None


def test_failed_trial_reported_as_failure(monkeypatch):
    created = _install_fake_optuna(monkeypatch)
    s = tune.OptunaSearch({"x": tune.uniform(0, 1)}, metric="m")
    s.suggest("t1")
    s.on_trial_complete("t1", error=True)
    assert created[0].told[0][2] == "FAIL"


def test_sample_from_rejected(monkeypatch):
    _install_fake_optuna(monkeypatch)
    with pytest.raises(ValueError, match="sample_from"):
        tune.OptunaSearch({"x": tune.sample_from(lambda _: 1)})


def test_runs_inside_tuner(monkeypatch, ray_start):
    """The adapter drives a real (tiny) Tuner run end to end."""
    _install_fake_optuna(monkeypatch)

    def objective(config):
        tune.report(loss=config["lr"] * 2)

    searcher = tune.OptunaSearch({"lr": tune.uniform(0.1, 1.0)},
                                 metric="loss", mode="min")
    tuner = tune.Tuner(
        objective,
        tune_config=tune.TuneConfig(search_alg=searcher, num_samples=3,
                                    metric="loss", mode="min"))
    grid = tuner.fit()
    assert len(grid) == 3
