"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix and metric reader loads; the harness and the reference load
nothing of the JAX package (top-level names compared whole)."""

import importlib
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness, traffic
from benchmark.run import _reader

ROOT = Path(__file__).resolve().parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_names_and_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names)) and all(map(NAME.match, names))
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_loads(w):
    ctx = harness.load_context(w["name"], 1, 10, False, 0.0)
    driver = importlib.import_module(
        f"benchmark.drivers.{ctx.cell['driver']}")
    assert callable(driver.run) and callable(driver.check)
    assert ctx.config["torch_dtype"] == "bfloat16"
    assert traffic.load(w["traffic"])["kind"]
    conf = [c for c in BENCH["configs"] if c["name"] == w["config"]][0]
    assert sorted(ctx.config["reduced"]) == sorted(conf["reduced"])
    assert all(v is not None for v in ctx.cell["limits"].values())
    names = harness.metric_names(w["name"])
    e2e = [m["name"] for m in names["end_to_end"]]
    assert "setup_s" in e2e and len(e2e) >= 2 and names["per_layer"]
    for m in names["per_layer"]:
        assert m["moves"] in e2e
        assert callable(_reader(m["name"]).read)


def test_every_config_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def _modules(code):
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport sys, json; print(json.dumps(sorted({m.split('.')[0] "
        "for m in sys.modules})))")], cwd=ROOT, capture_output=True,
        text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax_package():
    mods = _modules(
        "import benchmark.run, benchmark.sweep, importlib, pathlib\n"
        "from benchmark.run import _reader\n"
        "import json\n"
        "for p in pathlib.Path('benchmark/drivers').glob('[a-z]*.py'): "
        "importlib.import_module('benchmark.drivers.' + p.stem)\n"
        "for m in json.load(open('BENCHMARK.json'))['per_layer']: "
        "_reader(m['name'])")
    assert "ray_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "ray_tpu"}


def test_reference_loads_no_program():
    mods = _modules("import benchmark.configs.mistral_family, "
                    "benchmark.weights, benchmark.counts")
    assert not mods & {"jax", "jaxlib", "flax", "ray_tpu", "ray_tpu_torch"}
