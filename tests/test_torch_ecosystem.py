"""The Dask scheduler of the port (the cases of tests/test_ecosystem.py's
TestDaskOnRay on ray_tpu_torch) and the port's core microbenchmark, run
as its command and held to the reference's metric names."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import ray_tpu_torch

_ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def rt():
    info = ray_tpu_torch.init(num_cpus=4, num_gpus=0,
                              ignore_reinit_error=True)
    yield info
    ray_tpu_torch.shutdown()


class TestDaskOnRay:
    def test_raw_graph_executes(self, rt):
        from ray_tpu_torch.utils.dask import ray_dask_get

        def add(a, b):
            return a + b

        def inc(a):
            return a + 1

        dsk = {
            "x": 1,
            "y": 2,
            "a": (add, "x", "y"),        # 3
            "b": (inc, "a"),             # 4
            "c": (add, (inc, "b"), "a"),  # nested task: 5 + 3 = 8
        }
        assert ray_dask_get(dsk, "c") == 8
        assert ray_dask_get(dsk, ["a", "b"]) == [3, 4]

    def test_parallel_branches_are_cluster_tasks(self, rt):
        from ray_tpu_torch.utils.dask import ray_dask_get

        def pid_of(_):
            return os.getpid()

        dsk = {f"p{i}": (pid_of, i) for i in range(4)}
        pids = ray_dask_get(dsk, [f"p{i}" for i in range(4)])
        # tasks ran in worker processes, not the driver
        assert all(p != os.getpid() for p in pids)

    def test_dask_collections_if_available(self, rt):
        dask = pytest.importorskip("dask")
        import dask.array  # noqa: F401  (requires dask[array])
        from ray_tpu_torch.utils.dask import (disable_dask_on_ray,
                                              enable_dask_on_ray)

        enable_dask_on_ray()
        try:
            x = dask.array.ones((100, 100), chunks=(50, 50))
            assert float((x + x).sum().compute()) == 20000.0
        finally:
            disable_dask_on_ray()


def _reference_metric_names() -> set:
    """Every metric name the reference's microbenchmark ``main`` emits,
    read from its text: the ``timeit`` names and the ``results[...]``
    keys it sets itself."""
    tree = ast.parse((_ROOT / "ray_tpu" / "utils" / "microbenchmark.py"
                      ).read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    names = set()
    for node in ast.walk(main):
        if isinstance(node, ast.Call) and getattr(
                node.func, "id", None) == "timeit":
            names.add(ast.literal_eval(node.args[0]))
        elif isinstance(node, ast.Subscript) and isinstance(
                node.ctx, ast.Store) and getattr(
                    node.value, "id", None) == "results":
            names.add(ast.literal_eval(node.slice))
    return names


def test_microbenchmark_quick_emits_every_reference_metric():
    """``python -m ray_tpu_torch.utils.microbenchmark --quick`` exits 0,
    prints one JSON object last, with exactly the reference's metric
    names, and every rate positive."""
    want = _reference_metric_names()
    assert len(want) == 13 and "single_client_put_gigabytes" in want
    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.utils.microbenchmark",
         "--quick"], cwd=_ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(_ROOT),
             "RAY_TPU_USAGE_STATS_ENABLED": "0"})
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(got) == want
    assert all(v > 0 for v in got.values()), got


def test_chip_smoke_checks_every_reference_metric():
    """The card's phase microbenchmark fails on a missing metric of the
    reference's: its list is the reference's names."""
    import chip_smoke

    assert set(chip_smoke._MICROBENCH_METRICS) == _reference_metric_names()
    assert len(chip_smoke._MICROBENCH_METRICS) == 13
