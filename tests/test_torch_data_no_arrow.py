"""The port's Data path from numpy blocks to torch batches needs no
pyarrow, pandas or PIL. A subprocess whose driver and workers cannot import
them (a ``sys.meta_path`` blocker in a ``sitecustomize`` on PYTHONPATH)
runs from_numpy, map_batches, random_shuffle, groupby, sort,
streaming_split and iter_torch_batches(device="cpu") and gives the same
rows as a subprocess that has them; the edges that need them raise
ImportError naming the package."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

from torch_port_util import one_torch_thread  # noqa: F401 (fixture)

_ROOT = Path(__file__).resolve().parent.parent
_BLOCKED = ("pyarrow", "pandas", "PIL")

_BLOCKER = f'''
import sys


class _Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.partition(".")[0] in {_BLOCKED!r}:
            raise ModuleNotFoundError(f"No module named {{name!r}}")
        return None


sys.meta_path.insert(0, _Blocker())
'''

_SCRIPT = textwrap.dedent('''
    import importlib, json, sys
    import numpy as np
    import ray_tpu_torch as rt
    from ray_tpu_torch import data

    rt.init(num_cpus=2, num_gpus=0)
    rng = np.random.default_rng(0)
    arrays = [{"id": np.arange(i * 50, (i + 1) * 50),
               "k": rng.integers(0, 7, 50),
               "t": rng.integers(0, 100, (50, 4)).astype(np.int32)}
              for i in range(6)]
    ds = data.from_numpy(arrays).map_batches(
        lambda b: {**b, "v": b["k"] * 0.5})
    out = {}
    out["shuffle"] = [r["id"] for r in
                      ds.random_shuffle(seed=5).take_all()]
    out["sort"] = [[r["k"], r["id"], r["t"].tolist()] for r in
                   ds.sort("k", descending=True).take_all()]
    out["groupby"] = sorted([r["k"], r["count()"]] for r in
                            ds.groupby("k").count().take_all())
    out["sum_v"] = sorted([r["k"], r["sum(v)"]] for r in
                          ds.groupby("k").sum("v").take_all())
    (it,) = ds.random_shuffle(seed=5).streaming_split(1)
    out["torch"] = [[b["id"].tolist(), b["t"].sum(-1).tolist(),
                     str(b["t"].dtype), str(b["v"].dtype)]
                    for b in it.iter_torch_batches(batch_size=32,
                                                   device="cpu")]

    @rt.remote
    def importable():
        found = []
        for m in ("pyarrow", "pandas", "PIL"):
            try:
                importlib.import_module(m)
                found.append(m)
            except ImportError:
                pass
        return found

    out["worker_imports"] = rt.get(importable.remote(), timeout=60)
    errors = {}
    for name, fn in (
            ("read_parquet", lambda: data.read_parquet("x.parquet")),
            ("to_pandas", lambda: ds.to_pandas()),
            ("batch_format_pyarrow",
             lambda: next(ds.iter_batches(batch_format="pyarrow")))):
        try:
            fn()
            errors[name] = None
        except ImportError as e:
            errors[name] = str(e)
    out["errors"] = errors
    out["driver_modules"] = sorted(
        m for m in sys.modules
        if m.partition(".")[0] in ("pyarrow", "pandas", "PIL"))
    rt.shutdown()
    print(json.dumps(out))
''')


def _start(tmp_path: Path, blocked: bool) -> subprocess.Popen:
    site = tmp_path / ("blocked" if blocked else "open")
    site.mkdir()
    if blocked:
        (site / "sitecustomize.py").write_text(_BLOCKER)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(site),
                                                        str(_ROOT)])}
    return subprocess.Popen([sys.executable, "-c", _SCRIPT], cwd=site,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


def _result(proc: subprocess.Popen) -> dict:
    out, err = proc.communicate(timeout=240)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


def test_data_path_without_arrow_pandas_or_pil(tmp_path):
    # both runs at once, each with its own runtime
    procs = [_start(tmp_path, blocked) for blocked in (True, False)]
    try:
        without, with_ = [_result(p) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert without["worker_imports"] == []
    assert without["driver_modules"] == []
    assert sorted(with_["worker_imports"]) == sorted(_BLOCKED)
    for key in ("shuffle", "sort", "groupby", "sum_v", "torch"):
        assert without[key] == with_[key], key
    assert sorted(without["shuffle"]) == list(range(300))
    assert without["torch"][0][2:] == ["torch.int32", "torch.float64"]
    for name, package in (("read_parquet", "pyarrow"),
                          ("to_pandas", "pandas"),
                          ("batch_format_pyarrow", "pyarrow")):
        assert without["errors"][name] is not None, name
        assert package in without["errors"][name], name
