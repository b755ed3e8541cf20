"""GPU leases of the port's runtime, on the CPU with fake GPUs: the cases
of tests/test_collective.py's TestTpuChipAssignment with ``num_gpus`` and
``CUDA_VISIBLE_DEVICES``, GPU detection, and the ids, resource model and
config of tests/test_ids_and_resources.py."""

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import pytest

import ray_tpu_torch
from ray_tpu_torch.core import resources
from ray_tpu_torch.core.config import Config
from ray_tpu_torch.core.ids import (ActorID, JobID, NodeID, ObjectID,
                                    PlacementGroupID, TaskID)
from ray_tpu_torch.core.resources import NodeResources, ResourceSet

_ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def rt():
    info = ray_tpu_torch.init(num_cpus=2, num_gpus=4,
                              ignore_reinit_error=True)
    yield info
    ray_tpu_torch.shutdown()


def _lease_view(hold_s=0.0):
    time.sleep(hold_s)
    return (os.getpid(), sorted(ray_tpu_torch.get_gpu_ids()),
            os.environ.get("CUDA_VISIBLE_DEVICES"))


def _lease_view_together(rendezvous, n):
    """``_lease_view`` once ``n`` tasks hold their leases at once: each
    marks ``rendezvous`` and waits for the others' marks."""
    Path(rendezvous, str(os.getpid())).touch()
    deadline = time.monotonic() + 60
    while len(os.listdir(rendezvous)) < n:
        assert time.monotonic() < deadline, "the leases never overlapped"
        time.sleep(0.01)
    return _lease_view()


class TestGpuLeases:
    def test_gpus_assigned_and_released(self, rt, tmp_path):
        assert ray_tpu_torch.cluster_resources()["GPU"] == 4.0
        two = ray_tpu_torch.remote(num_gpus=2, num_cpus=0)(
            _lease_view_together)
        a, b = ray_tpu_torch.get([two.remote(str(tmp_path), 2),
                                  two.remote(str(tmp_path), 2)],
                                 timeout=120)
        for _pid, ids, env in (a, b):
            assert len(ids) == 2 and env == ",".join(map(str, ids))
        # both leases were held at once: disjoint GPUs
        assert not set(a[1]) & set(b[1]), (a, b)
        # after release the whole pool is usable again
        four = ray_tpu_torch.remote(num_gpus=4, num_cpus=0)(_lease_view)
        _pid, ids, env = ray_tpu_torch.get(four.remote(), timeout=120)
        assert ids == [0, 1, 2, 3] and env == "0,1,2,3"

    def test_actor_gpu_assignment(self, rt):
        @ray_tpu_torch.remote(num_gpus=2)
        class GpuActor:
            def view(self):
                return _lease_view()

        a1, a2 = GpuActor.remote(), GpuActor.remote()
        (_p1, ids1, env1), (_p2, ids2, env2) = ray_tpu_torch.get(
            [a1.view.remote(), a2.view.remote()], timeout=120)
        assert len(ids1) == 2 and len(ids2) == 2
        assert not set(ids1) & set(ids2), (ids1, ids2)
        assert env1 == ",".join(map(str, ids1))
        assert env2 == ",".join(map(str, ids2))
        ray_tpu_torch.kill(a1)
        ray_tpu_torch.kill(a2)

    def test_task_without_gpus_sees_none(self, rt):
        plain = ray_tpu_torch.remote(_lease_view)
        for _pid, ids, env in ray_tpu_torch.get(
                [plain.remote() for _ in range(4)], timeout=120):
            assert ids == [] and env == ""

    def test_gpu_lease_at_the_worker_cap_retires_an_idle_worker(self):
        """At the node's worker cap (the driver and one worker), an idle
        worker bound to other GPU ids (here a CPU task's, none) is
        retired so that a GPU lease starts its own at once, and not after
        the idle reaper's keep-alive."""
        code = (
            "import json, os, time\n"
            "import ray_tpu_torch as rt\n"
            "rt.init(num_cpus=1, num_gpus=1, log_to_driver=False,\n"
            "        _system_config={'max_workers_per_node': 2,\n"
            "                        'idle_worker_keep_alive_s': 600})\n"
            "@rt.remote\n"
            "def cpu():\n"
            "    return os.getpid(), os.environ['CUDA_VISIBLE_DEVICES']\n"
            "@rt.remote(num_gpus=1)\n"
            "def gpu():\n"
            "    return os.getpid(), os.environ['CUDA_VISIBLE_DEVICES']\n"
            "a = rt.get(cpu.remote(), timeout=60)\n"
            "t0 = time.monotonic()\n"
            "b = rt.get(gpu.remote(), timeout=60)\n"
            "waited = time.monotonic() - t0\n"
            "c = rt.get(cpu.remote(), timeout=60)\n"
            "rt.shutdown()\n"
            "print(json.dumps({'cpu': a, 'gpu': b, 'cpu_again': c,"
            " 'waited': waited}))\n")
        out = subprocess.run(
            [sys.executable, "-c", code], cwd=_ROOT, capture_output=True,
            text=True, timeout=180,
            env={**os.environ, "PYTHONPATH": str(_ROOT),
                 "RAY_TPU_USAGE_STATS_ENABLED": "0"})
        assert out.returncode == 0, out.stderr
        got = json.loads(out.stdout.strip().splitlines()[-1])
        (pid_a, env_a), (pid_b, env_b) = got["cpu"], got["gpu"]
        pid_c, env_c = got["cpu_again"]
        assert (env_a, env_b, env_c) == ("", "0", "")
        assert len({pid_a, pid_b, pid_c}) == 3
        assert got["waited"] < 60

    def test_gpu_burst_runs_at_once_when_workers_start_slowly(self):
        """Two num_gpus=2 tasks on a node of 4 GPUs run at once, each on a
        worker of its own, also when no worker is prestarted and each
        takes more than a second to start: the first lease's worker must
        not take the second task into its queue while the second lease
        waits for its worker."""
        code = (
            "import json, os, time\n"
            "import ray_tpu_torch as rt\n"
            "rt.init(num_cpus=2, num_gpus=4, log_to_driver=False,\n"
            "        _system_config={'prestart_workers': False})\n"
            "d = os.environ['RENDEZVOUS']\n"
            "@rt.remote(num_gpus=2, num_cpus=0)\n"
            "def together():\n"
            "    open(os.path.join(d, str(os.getpid())), 'w').close()\n"
            "    t = time.monotonic() + 30\n"
            "    while len(os.listdir(d)) < 2 and time.monotonic() < t:\n"
            "        time.sleep(0.01)\n"
            "    return (os.getpid(), len(os.listdir(d)),\n"
            "            os.environ['CUDA_VISIBLE_DEVICES'])\n"
            "out = rt.get([together.remote(), together.remote()],\n"
            "             timeout=120)\n"
            "rt.shutdown()\n"
            "print(json.dumps(out))\n")
        with tempfile.TemporaryDirectory() as d:
            out = subprocess.run(
                [sys.executable, "-c", code], cwd=_ROOT,
                capture_output=True, text=True, timeout=180,
                env={**os.environ, "PYTHONPATH": str(_ROOT),
                     "RENDEZVOUS": d, "RAY_TPU_USAGE_STATS_ENABLED": "0"})
        assert out.returncode == 0, out.stderr
        (pid_a, seen_a, env_a), (pid_b, seen_b, env_b) = json.loads(
            out.stdout.strip().splitlines()[-1])
        assert pid_a != pid_b and seen_a == seen_b == 2
        assert sorted([env_a, env_b]) == ["0,1", "2,3"]

    def test_worker_never_switches_gpus(self, rt):
        """Leases of 1, 2 and 0 GPUs in waves over a pool of reused
        workers: each worker process keeps the one CUDA_VISIBLE_DEVICES
        it exported first."""
        one = ray_tpu_torch.remote(num_gpus=1, num_cpus=0)(_lease_view)
        two = ray_tpu_torch.remote(num_gpus=2, num_cpus=0)(_lease_view)
        none = ray_tpu_torch.remote(num_cpus=0.5)(_lease_view)
        seen = {}
        for wave in range(3):
            refs = [one.remote(0.05) for _ in range(6)] + \
                [two.remote(0.05) for _ in range(3)] + \
                [none.remote(0.05) for _ in range(4)]
            for pid, ids, env in ray_tpu_torch.get(refs, timeout=120):
                assert env == ",".join(map(str, ids))
                assert seen.setdefault(pid, env) == env, (wave, pid)
        assert len(set(seen.values())) >= 3


# ----------------------------------------------------------- detection


class TestDetection:
    def test_visible_devices_win(self, monkeypatch):
        for value, n in (("0,1,2", 3), ("", 0), ("3", 1), ("0,-1,1", 1),
                         ("GPU-8f2c,GPU-77aa", 2)):
            monkeypatch.setenv("CUDA_VISIBLE_DEVICES", value)
            assert resources._detect_gpus() == n, value

    def test_proc_entries_then_nvidia_smi(self, monkeypatch, tmp_path):
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
        for i in range(2):
            (tmp_path / f"0000:0{i}:00.0").mkdir()
        monkeypatch.setattr(resources, "_NVIDIA_PROC_GPUS", str(tmp_path))
        assert resources._detect_gpus() == 2
        monkeypatch.setattr(resources, "_NVIDIA_PROC_GPUS",
                            str(tmp_path / "absent"))
        smi = tmp_path / "bin" / "nvidia-smi"
        smi.parent.mkdir()
        smi.write_text("#!/bin/sh\necho 'GPU 0: NVIDIA H100 80GB HBM3 "
                       "(UUID: GPU-1)'\necho 'GPU 1: NVIDIA H100 80GB HBM3 "
                       "(UUID: GPU-2)'\necho 'GPU 2: NVIDIA H100 80GB "
                       "HBM3 (UUID: GPU-3)'\n")
        smi.chmod(0o755)
        monkeypatch.setenv("PATH", str(smi.parent))
        assert resources._detect_gpus() == 3
        monkeypatch.setenv("PATH", str(tmp_path / "empty"))
        assert resources._detect_gpus() == 0

    def test_explicit_count_wins(self, monkeypatch):
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1")
        assert resources.detect_node_resources(num_cpus=1).total.get(
            "GPU") == 2
        assert resources.detect_node_resources(
            num_cpus=1, num_gpus=5).total.get("GPU") == 5
        assert "GPU" not in resources.detect_node_resources(
            num_cpus=1, num_gpus=0).total.to_dict()

    def test_driver_detects_from_the_environment_without_torch(self):
        """init() with the GPU count left to detection reads
        CUDA_VISIBLE_DEVICES, and neither it nor running a task loads
        torch in the driver."""
        code = (
            "import json, sys\n"
            "import ray_tpu_torch as rt\n"
            "rt.init(num_cpus=1, log_to_driver=False)\n"
            "res = rt.cluster_resources()\n"
            "@rt.remote(num_gpus=1, num_cpus=0)\n"
            "def f():\n"
            "    import os\n"
            "    return os.environ['CUDA_VISIBLE_DEVICES']\n"
            "env = rt.get(f.remote(), timeout=60)\n"
            "rt.shutdown()\n"
            "print(json.dumps({'gpus': res.get('GPU'), 'env': env,"
            " 'torch': 'torch' in sys.modules}))\n")
        out = subprocess.run(
            [sys.executable, "-c", code], cwd=_ROOT, capture_output=True,
            text=True, timeout=120,
            env={**os.environ, "PYTHONPATH": str(_ROOT),
                 "CUDA_VISIBLE_DEVICES": "5,7",
                 "RAY_TPU_USAGE_STATS_ENABLED": "0"})
        assert out.returncode == 0, out.stderr
        got = json.loads(out.stdout.strip().splitlines()[-1])
        # id 0 of the node is the driver's first visible device, "5"
        assert got == {"gpus": 2.0, "env": "5", "torch": False}


# ------------------------------------------- ids, resources and config


class TestIds:
    def test_sizes_and_roundtrip(self):
        j = JobID.from_int(7)
        assert j.to_int() == 7
        a = ActorID.of(j)
        assert a.job_id() == j
        t = TaskID.for_actor_task(a)
        assert len(t.binary()) == TaskID.SIZE
        o = ObjectID.for_return(t, 1)
        assert o.task_id() == t and o.index() == 1 and not o.is_put()
        p = ObjectID.for_put(t, 3)
        assert p.is_put() and p.index() == 3

    def test_hex_roundtrip_nil_uniqueness_pickle(self):
        import pickle

        n = NodeID.from_random()
        assert NodeID.from_hex(n.hex()) == n
        assert TaskID.nil().is_nil()
        assert not TaskID.for_normal_task(JobID.from_int(1)).is_nil()
        assert len({ObjectID.from_random() for _ in range(1000)}) == 1000
        t = TaskID.for_normal_task(JobID.from_int(1))
        assert pickle.loads(pickle.dumps(t)) == t
        assert PlacementGroupID.from_random() != \
            PlacementGroupID.from_random()


class TestResourceSet:
    def test_fixed_point_fractions(self):
        rs = ResourceSet({"GPU": 0.0001})
        acc = ResourceSet({"GPU": 1})
        for _ in range(10000):
            acc = acc.subtract(rs)
        assert acc.get("GPU") == 0

    def test_covers_subtract_add(self):
        a = ResourceSet({"CPU": 4, "GPU": 8})
        b = ResourceSet({"CPU": 2, "GPU": 8})
        assert a.covers(b) and not b.covers(a)
        c = a.subtract(b)
        assert c.get("CPU") == 2 and c.get("GPU") == 0
        assert c.add(b) == a

    def test_negative_raises(self):
        with pytest.raises(ValueError):
            ResourceSet({"GPU": 1}).subtract(ResourceSet({"GPU": 2}))
        with pytest.raises(ValueError):
            ResourceSet({"GPU": -1})

    def test_node_resources_accounting(self):
        nr = NodeResources(total=ResourceSet({"CPU": 4, "GPU": 2}),
                           available=ResourceSet({"CPU": 4, "GPU": 2}))
        req = ResourceSet({"CPU": 1, "GPU": 2})
        assert nr.is_available(req)
        nr.allocate(req)
        assert not nr.is_available(req)
        assert nr.utilization() == 1.0
        nr.release(req)
        assert nr.is_available(req)
        with pytest.raises(ValueError):
            nr.release(ResourceSet({"GPU": 1}))


class TestConfig:
    def test_env_override(self, monkeypatch):
        monkeypatch.setenv("RAY_TPU_MAX_INLINE_OBJECT_SIZE", "12345")
        assert Config().max_inline_object_size == 12345

    def test_apply_overrides(self):
        cfg = Config()
        cfg.apply_overrides({"scheduler_spread_threshold": 0.9})
        assert cfg.scheduler_spread_threshold == 0.9
        with pytest.raises(ValueError):
            cfg.apply_overrides({"tpu_accelerator_type": "v5p-64"})
