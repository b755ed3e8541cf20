"""The port stands alone: it imports no JAX and nothing of the JAX package,
builds nothing at import, and never runs on the CPU unless asked to."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch_port_util import one_torch_thread  # noqa: F401 (fixture)

_ROOT = Path(__file__).resolve().parent.parent


def _port_modules():
    pkg = _ROOT / "ray_tpu_torch"
    return sorted(
        ".".join(p.relative_to(_ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in pkg.rglob("*.py"))


def test_port_imports_no_jax_and_no_reference_package():
    """Importing every module of the port, the runtime's included, and the
    card scripts (chip_smoke, kernel_mutants), loads no JAX, no ml_dtypes,
    nothing of ray_tpu, and builds no kernel and no native library."""
    mods = _port_modules() + ["chip_smoke", "kernel_mutants"]
    assert {"ray_tpu_torch.ops.flash_attention", "ray_tpu_torch.ops._build",
            "ray_tpu_torch.models.training", "ray_tpu_torch.core.head",
            "ray_tpu_torch.core.api", "ray_tpu_torch.core.serialization",
            "ray_tpu_torch.core.worker_main",
            "ray_tpu_torch.native.build", "ray_tpu_torch.train",
            "ray_tpu_torch.train.backend", "ray_tpu_torch.train.checkpoint",
            "ray_tpu_torch.train.trainer", "ray_tpu_torch.tune",
            "ray_tpu_torch.tune.execution",
            "ray_tpu_torch.tune.external_search",
            "ray_tpu_torch.cluster_utils", "ray_tpu_torch.collective",
            "ray_tpu_torch.collective.collective",
            "ray_tpu_torch.train.pipeline",
            "ray_tpu_torch.train.pipeline_schedules",
            "ray_tpu_torch.dag", "ray_tpu_torch.dag.dag_node",
            "ray_tpu_torch.workflow", "ray_tpu_torch.workflow.execution",
            *(f"ray_tpu_torch.utils.{m}" for m in (
                "actor_pool", "multiprocessing", "joblib_backend", "dask",
                "microbenchmark", "queue")),
            *(f"ray_tpu_torch.rllib.{m}" for m in (
                "sample_batch", "env", "connectors", "replay_buffers",
                "models", "catalog", "policy", "learner", "rollout_worker",
                "algorithm", "ppo", "impala", "appo", "a2c", "dqn",
                "apex_dqn", "sac", "td3", "r2d2", "multi_agent", "offline",
                "bandits", "es", "ars", "dreamer", "alpha_zero"))
            } <= set(mods)
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "from ray_tpu_torch.ops import _build\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'ml_dtypes' or m == 'ray_tpu' or m.startswith('ray_tpu.')"
        " or m == 'bench_serve']\n"
        "print(json.dumps({'bad': bad, 'built': sorted(_build._libs),"
        " 'sources': _build.sources(),"
        " 'native': [ln for ln in open('/proc/self/maps')"
        " if 'ray_tpu_torch/native' in ln]}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=_ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(_ROOT)})
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"bad": [], "built": [],
                   "sources": ["flash_bwd", "flash_bwd_dkv", "flash_fwd"],
                   "native": []}


def test_runtime_entry_points_load_no_torch():
    """A worker process (python -m ray_tpu_torch.core.worker_main), a
    driver that imports the runtime API, Serve's controller, replica and
    proxies (actors that never touch a model), and Train and Tune (a
    trainer, its workers' actor class, the backend, checkpoints, a tuner)
    load no torch: the package's names load on first access, the LLM
    deployments import torch inside their replicas, and a train worker
    when its backend or its loop needs it. So do the collective library,
    cluster_utils and the MPMD pipeline (its stages import torch when they
    run a torch-mode program)."""
    code = (
        "import json, sys\n"
        "import ray_tpu_torch\n"
        "import ray_tpu_torch.core.worker_main, ray_tpu_torch.core.api\n"
        "from ray_tpu_torch import init, remote, get, put, get_gpu_ids\n"
        "from ray_tpu_torch import ObjectRef, RayTaskError, serve\n"
        "from ray_tpu_torch.serve import controller, replica, http_proxy\n"
        "from ray_tpu_torch.serve import grpc_proxy, router, llm\n"
        "serve.deployment(lambda x: x)\n"
        "from ray_tpu_torch import train, tune\n"
        "from ray_tpu_torch.train import backend, checkpoint, worker_group\n"
        "from ray_tpu_torch.tune import execution, external_search\n"
        "from ray_tpu_torch import cluster_utils, collective\n"
        "from ray_tpu_torch.train import pipeline, pipeline_schedules\n"
        "from ray_tpu_torch.train import Pipeline, PipelineStage\n"
        "PipelineStage(fwd=lambda p, x: (x, None), bwd=lambda p, s, g: g)\n"
        "pipeline_schedules.one_f_one_b_order(4, 8)\n"
        "train.TorchTrainer(lambda: None,\n"
        "                   scaling_config=train.ScalingConfig(use_gpu=True))\n"
        "train.Checkpoint.from_dict({'a': 1})\n"
        "tune.Tuner(lambda config: None, param_space={})\n"
        "print(json.dumps(sorted(m for m in sys.modules if m == 'torch'"
        " or m.startswith('torch.') or m == 'jax')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=_ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(_ROOT)})
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_without_device_raise_instead_of_using_cpu(no_cuda):
    import numpy as np

    from ray_tpu_torch.interop import (params_from_numpy, tensor_from_numpy,
                                       train_state_from_numpy)
    from ray_tpu_torch.models.config import tiny_config
    from ray_tpu_torch.models.engine import InferenceEngine
    from ray_tpu_torch.models.training import init_train_state, make_optimizer
    from ray_tpu_torch.models.transformer import init_params

    cfg = tiny_config()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_train_state(torch.Generator().manual_seed(0), cfg,
                         make_optimizer())
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine(params, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tensor_from_numpy(np.zeros(3, np.float32))
    tree = {k: (v.numpy() if not isinstance(v, dict) else
                {n: w.numpy() for n, w in v.items()})
            for k, v in params.items()}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_numpy(tree, cfg)
    opt = {"count": np.zeros((), np.int32), "mu": tree, "nu": tree}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_state_from_numpy({"step": np.zeros((), np.int32),
                                "params": tree, "opt_state": opt}, cfg)
    # RLlib: each learner, TorchPolicy and an Algorithm raise before any
    # worker process starts; rollout workers run their policy on the CPU
    # by design
    from ray_tpu_torch import rllib
    from ray_tpu_torch.rllib.models import params_from_numpy

    kw = dict(lr=1e-3, vf_coeff=0.5, entropy_coeff=0.0, grad_clip=0.5)
    for make in (lambda: rllib.PPOLearner(4, 2),
                 lambda: rllib.ImpalaLearner(4, 2),
                 lambda: rllib.APPOLearner(4, 2),
                 lambda: rllib.A2CLearner(4, 2, **kw),
                 lambda: rllib.DQNLearner(4, 2, lr=1e-3, gamma=0.99),
                 lambda: rllib.TorchPolicy(4, 2),
                 lambda: params_from_numpy({"w0": np.zeros((4, 2))})):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    # part 2's learners
    from ray_tpu_torch.rllib.dreamer import DreamerLearner

    cont = dict(actor_lr=1e-3, critic_lr=1e-3, gamma=0.99, tau=0.005,
                action_scale=2.0)
    for make in (lambda: rllib.SACLearner(3, 1, alpha_lr=1e-3,
                                          initial_alpha=0.2,
                                          target_entropy=-1.0, **cont),
                 lambda: rllib.TD3Learner(3, 1, action_shift=0.0,
                                          twin_q=True, target_noise=0.2,
                                          target_noise_clip=0.5, **cont),
                 lambda: rllib.R2D2Learner(4, 2, lr=1e-3, gamma=0.99,
                                           burn_in=2),
                 lambda: DreamerLearner(4, 2),
                 lambda: rllib.AlphaZeroLearner(18, 9)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    import ray_tpu_torch
    assert not ray_tpu_torch.is_initialized()
    # Algorithm.setup (and each algorithm's own setup) resolves the device
    # before it starts a worker: the runtime is never reached
    for config in (rllib.PPOConfig(), rllib.SACConfig(), rllib.TD3Config(),
                   rllib.DDPGConfig(), rllib.R2D2Config(),
                   rllib.ApexDQNConfig(), rllib.DreamerV3Config(),
                   rllib.AlphaZeroConfig(), rllib.ESConfig(),
                   rllib.ARSConfig()):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            config.build()
    # the offline algorithms, before they read their dataset
    for config in (rllib.BCConfig(), rllib.CQLConfig(),
                   rllib.MARWILConfig()):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            config.offline_data(input_path="/nonexistent").build()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rllib.MultiAgentPPO(lambda: None, policies=["p0"],
                            policy_mapping_fn=lambda agent: "p0")
    assert not ray_tpu_torch.is_initialized()
    w = rllib.RolloutWorker("CartPole-v1", 2, 4, 0.99, 0.95)
    assert w.policy.device.type == "cpu"


def test_chip_smoke_refuses_to_run_without_a_card():
    """No card: a non-zero exit and no result line."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, str(_ROOT / "chip_smoke.py")],
                         cwd=_ROOT, capture_output=True, text=True,
                         timeout=120, env=env)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_rllib_exports_every_name_of_the_reference():
    """ray_tpu_torch.rllib.__all__ holds every name of ray_tpu.rllib's
    (read from the file's text: the reference imports JAX), TorchPolicy
    standing for JaxPolicy."""
    import ast

    from ray_tpu_torch import rllib

    tree = ast.parse((_ROOT / "ray_tpu" / "rllib" / "__init__.py"
                      ).read_text())
    ref = next(ast.literal_eval(node.value) for node in tree.body
               if isinstance(node, ast.Assign)
               and node.targets[0].id == "__all__")
    want = {"TorchPolicy" if n == "JaxPolicy" else n for n in ref}
    assert want <= set(rllib.__all__), sorted(want - set(rllib.__all__))
    assert all(hasattr(rllib, n) for n in rllib.__all__)


def test_data_and_utils_load_no_torch_arrow_or_pandas():
    """Data's modules (and utils' Queue) load no torch, no JAX, nothing of
    ray_tpu, no pyarrow and no pandas at import: map, shuffle and read
    tasks run in CPU workers that never pay for them. Torch comes with
    iter_torch_batches, the edge packages with the edges that use them."""
    mods = [m for m in _port_modules()
            if m.startswith(("ray_tpu_torch.data", "ray_tpu_torch.utils"))]
    assert {"ray_tpu_torch.data", "ray_tpu_torch.data.block",
            "ray_tpu_torch.data.executor", "ray_tpu_torch.data.iterator",
            "ray_tpu_torch.data.dataset", "ray_tpu_torch.data.read_api",
            "ray_tpu_torch.utils.queue"} <= set(mods)
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import ray_tpu_torch\n"
        "ray_tpu_torch.data, ray_tpu_torch.utils, ray_tpu_torch.state\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.partition('.')"
        "[0] in ('torch', 'jax', 'ray_tpu', 'pyarrow', 'pandas'))))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=_ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(_ROOT)})
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_iter_torch_batches_without_device_raises_before_a_batch(no_cuda):
    """iter_torch_batches() means CUDA: without it, the call raises before
    it takes a block; device="cpu" is the only way to the CPU."""
    from ray_tpu_torch.data import DataIterator

    class Untouched:
        def __iter__(self):
            raise AssertionError("a block was taken")

    it = DataIterator(Untouched())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        it.iter_torch_batches()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        it.iter_torch_batches(batch_size=4, device="cuda")
    gen = it.iter_torch_batches(device="cpu")
    with pytest.raises(AssertionError, match="a block was taken"):
        next(gen)


def _reference_public(path: str, cls=None) -> set:
    """Public names of a reference module's ``__all__`` or of one of its
    classes, read from the file's text (the reference imports JAX and
    pyarrow)."""
    import ast

    tree = ast.parse((_ROOT / path).read_text())
    if cls is None:
        return set(next(ast.literal_eval(node.value) for node in tree.body
                        if isinstance(node, ast.Assign)
                        and node.targets[0].id == "__all__"))
    body = next(n for n in tree.body
                if isinstance(n, ast.ClassDef) and n.name == cls).body
    return {n.name for n in body if isinstance(n, ast.FunctionDef)
            and not n.name.startswith("_")}


def test_data_exports_every_name_of_the_reference():
    """ray_tpu_torch.data.__all__ equals ray_tpu.data's; Dataset and
    DataIterator have every public method of the reference's but
    iter_jax_batches, whose counterpart is iter_torch_batches(device=,
    dtype=, sharding=); state has data_shuffle_summary."""
    import inspect

    from ray_tpu_torch import data, state

    assert set(data.__all__) == _reference_public("ray_tpu/data/__init__.py")
    assert all(hasattr(data, n) for n in data.__all__)
    for cls, path in ((data.Dataset, "ray_tpu/data/dataset.py"),
                      (data.DataIterator, "ray_tpu/data/iterator.py")):
        want = _reference_public(path, cls.__name__) - {"iter_jax_batches"}
        assert want <= set(dir(cls)), sorted(want - set(dir(cls)))
        assert not hasattr(cls, "iter_jax_batches")
    params = inspect.signature(
        data.DataIterator.iter_torch_batches).parameters
    assert {"batch_size", "device", "dtype", "sharding"} <= set(params)
    assert callable(state.data_shuffle_summary)


def test_bind_builds_nodes_and_utils_exports_the_references_names():
    """``fn.bind()`` and ``Cls.bind()`` build DAG nodes (no runtime
    needed), ``dag`` and ``workflow`` load as the package's attributes,
    and ``ray_tpu_torch.utils.__all__`` is ``ray_tpu.utils.__all__``;
    none of it loads torch or JAX."""
    code = (
        "import json, sys\n"
        "import ray_tpu_torch as rt\n"
        "from ray_tpu_torch.dag import (ClassMethodNode, ClassNode,\n"
        "                               FunctionNode, InputNode)\n"
        "from ray_tpu_torch.utils import ActorPool, register_ray\n"
        "f = rt.remote(lambda x: x)\n"
        "class C:\n"
        "    def m(self, x):\n"
        "        return x\n"
        "c = rt.remote(C).bind()\n"
        "with InputNode() as inp:\n"
        "    node = f.bind(inp)\n"
        "ok = [isinstance(node, FunctionNode), isinstance(c, ClassNode),\n"
        "      isinstance(c.m.bind(node), ClassMethodNode),\n"
        "      callable(rt.workflow.resume), rt.dag.InputNode is InputNode]\n"
        "print(json.dumps({'ok': ok, 'all': rt.utils.__all__,\n"
        "    'mods': sorted(m for m in sys.modules\n"
        "                   if m.partition('.')[0] in ('torch', 'jax',\n"
        "                                              'ray_tpu'))}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=_ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(_ROOT)})
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["ok"] == [True] * 5
    assert got["mods"] == []
    assert len(set(got["all"])) == len(got["all"])
    assert set(got["all"]) == _reference_public("ray_tpu/utils/__init__.py")


_OPS_MODULES = ("ray_tpu_torch.jobs", "ray_tpu_torch.scripts",
                "ray_tpu_torch.__main__", "ray_tpu_torch.dashboard",
                "ray_tpu_torch.dashboard_ui", "ray_tpu_torch.autoscaler",
                "ray_tpu_torch.autoscaler.autoscaler",
                "ray_tpu_torch.autoscaler.batching_provider",
                "ray_tpu_torch.autoscaler.gke", "ray_tpu_torch.utils.spark")


def test_ops_layer_loads_no_torch_jax_or_reference():
    """The CLI, jobs, the dashboard, the autoscaler and the Spark shim
    load no torch, no JAX and nothing of ray_tpu at import (a head the
    CLI starts does not pay for torch's import), and each is one of the
    package's lazy names."""
    code = (
        "import importlib, json, sys\n"
        "import ray_tpu_torch as rt\n"
        f"for m in {_OPS_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "lazy = [callable(rt.scripts.main), rt.jobs.JOB_MANAGER_NAME,\n"
        "        rt.dashboard.DOCTOR_ENDPOINTS[0],\n"
        "        'GPU avail / total' in rt.dashboard_ui.INDEX_HTML,\n"
        "        rt.autoscaler.FakeGkeGpuCloud.__name__]\n"
        "print(json.dumps({'lazy': lazy,\n"
        "    'mods': sorted(m for m in sys.modules\n"
        "                   if m.partition('.')[0] in ('torch', 'jax',\n"
        "                                              'ray_tpu'))}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=_ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(_ROOT)})
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"lazy": [True, "_ray_tpu_job_manager", "/", True,
                            "FakeGkeGpuCloud"], "mods": []}
    assert set(_OPS_MODULES) <= set(_port_modules())


def _reference_subcommands() -> list:
    """Every subcommand ``ray_tpu.scripts.build_parser`` adds, read from
    its text."""
    import ast

    tree = ast.parse((_ROOT / "ray_tpu" / "scripts.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "build_parser")
    return [c.args[0].value for c in ast.walk(fn)
            if isinstance(c, ast.Call) and getattr(c.func, "attr", "") ==
            "add_parser" and getattr(c.func.value, "id", "") == "sub"]


def test_cli_help_lists_every_reference_subcommand():
    """``python -m ray_tpu_torch --help`` names every top-level command
    of the reference's CLI, and ``start --help`` takes ``--num-gpus``
    where the reference takes ``--num-tpus``."""
    subs = _reference_subcommands()
    assert {"start", "stop", "status", "profile", "drain", "doctor",
            "timeline", "analyze", "list", "memory", "summary", "serve",
            "job"} == set(subs)
    env = {**os.environ, "PYTHONPATH": str(_ROOT)}
    out = subprocess.run([sys.executable, "-m", "ray_tpu_torch", "--help"],
                         cwd=_ROOT, capture_output=True, text=True,
                         timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    listed = out.stdout.split("{", 1)[1].split("}", 1)[0].split(",")
    assert sorted(listed) == sorted(subs)
    start = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch", "start", "--help"],
        cwd=_ROOT, capture_output=True, text=True, timeout=120, env=env)
    assert start.returncode == 0, start.stderr
    assert "--num-gpus" in start.stdout and "--num-tpus" not in start.stdout


def test_autoscaler_exports_the_references_names_with_gpu_pools():
    """``ray_tpu_torch.autoscaler.__all__`` is the reference's with Tpu
    turned into Gpu; every name is there."""
    import ray_tpu_torch.autoscaler as port

    ref = _reference_public("ray_tpu/autoscaler/__init__.py")
    assert "FakeGkeTpuCloud" in ref
    assert set(port.__all__) == {n.replace("Tpu", "Gpu") for n in ref}
    assert len(set(port.__all__)) == len(port.__all__)
    assert all(hasattr(port, n) for n in port.__all__)
