"""DAG IR and durable workflows of the port: the cases of
tests/test_dag_workflow.py on ray_tpu_torch, with a CPU tensor as a
step's value in the resume case, and the reference's step ids and
on-disk layout for the same graph."""

import os
import pickle

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import workflow
from ray_tpu_torch.dag import InputNode
from torch_port_util import one_torch_thread  # noqa: F401 (fixture)


@pytest.fixture(scope="module")
def rt():
    info = ray_tpu_torch.init(num_cpus=4, num_gpus=0,
                              ignore_reinit_error=True)
    yield info
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote
def _add(a, b):
    return a + b


@ray_tpu_torch.remote
def _mul(a, b):
    return a * b


def test_function_dag(rt):
    with InputNode() as inp:
        dag = _add.bind(_mul.bind(inp, 3), _add.bind(inp, 1))
    # x=2: (2*3) + (2+1) = 9
    assert ray_tpu_torch.get(dag.execute(2), timeout=60) == 9
    # re-executable with a different input
    assert ray_tpu_torch.get(dag.execute(10), timeout=60) == 41


def test_diamond_dag_executes_shared_dep_once(rt, tmp_path):
    marker = tmp_path / "runs"

    @ray_tpu_torch.remote
    def base():
        with open(marker, "a") as f:
            f.write("x")
        return 5

    b = base.bind()
    dag = _add.bind(_mul.bind(b, 2), b)  # 5*2 + 5
    assert ray_tpu_torch.get(dag.execute(), timeout=60) == 15
    assert marker.read_text() == "x"  # shared dep ran once


def test_class_dag(rt):
    @ray_tpu_torch.remote
    class Counter:
        def __init__(self, start):
            self.v = start

        def add(self, x):
            self.v += x
            return self.v

    node = Counter.bind(100)
    dag = node.add.bind(_add.bind(1, 2))
    assert ray_tpu_torch.get(dag.execute(), timeout=60) == 103


def test_workflow_run_and_output(rt, tmp_path):
    workflow.init(str(tmp_path))
    dag = _add.bind(_mul.bind(2, 3), 4)
    out = workflow.run(dag, workflow_id="w1")
    assert out == 10
    assert workflow.get_status("w1") == workflow.WorkflowStatus.SUCCESSFUL
    assert workflow.get_output("w1") == 10
    assert ("w1", "SUCCESSFUL") in workflow.list_all()


def test_workflow_input(rt, tmp_path):
    workflow.init(str(tmp_path))
    with InputNode() as inp:
        dag = _mul.bind(inp, 7)
    assert workflow.run(dag, workflow_id="w2", input=6) == 42


def test_workflow_resume_skips_completed_steps(rt, tmp_path):
    """The completed step's value is a CPU tensor: its checkpoint loads
    as a tensor on the CPU, bit for bit, and feeds the resumed step."""
    workflow.init(str(tmp_path))
    marker = tmp_path / "effects"
    flag = tmp_path / "fail_once"
    flag.write_text("1")
    want = torch.arange(12, dtype=torch.float32).reshape(3, 4) / 7

    @ray_tpu_torch.remote
    def expensive():
        import torch

        with open(marker, "a") as f:
            f.write("E")
        return torch.arange(12, dtype=torch.float32).reshape(3, 4) / 7

    @ray_tpu_torch.remote(max_retries=0)
    def flaky(x):
        import os

        if os.path.exists(flag):
            raise RuntimeError("transient failure")
        return x * 2

    dag = flaky.bind(expensive.bind())
    with pytest.raises(Exception):
        workflow.run(dag, workflow_id="w3")
    assert workflow.get_status("w3") == workflow.WorkflowStatus.RESUMABLE
    assert marker.read_text() == "E"  # expensive step completed + persisted
    steps = tmp_path / "w3" / "steps"
    assert sorted(os.listdir(steps)) == ["step_0_expensive.pkl"]
    with open(steps / "step_0_expensive.pkl", "rb") as f:
        ckpt = pickle.load(f)
    assert isinstance(ckpt, torch.Tensor) and ckpt.device.type == "cpu"
    assert torch.equal(ckpt, want)

    flag.unlink()  # heal the transient failure
    out = workflow.resume("w3")
    assert torch.equal(out, want * 2)
    assert workflow.get_status("w3") == workflow.WorkflowStatus.SUCCESSFUL
    assert torch.equal(workflow.get_output("w3"), want * 2)
    # the expensive step did NOT re-run — its checkpoint was reused
    assert marker.read_text() == "E"


def test_workflow_rejects_actor_nodes(rt, tmp_path):
    workflow.init(str(tmp_path))

    @ray_tpu_torch.remote
    class A:
        def f(self):
            return 1

    with pytest.raises(ValueError):
        workflow.run(A.bind(), workflow_id="w4")
    assert workflow.get_status("w4") == workflow.WorkflowStatus.FAILED


def test_workflow_delete(rt, tmp_path):
    workflow.init(str(tmp_path))
    workflow.run(_add.bind(1, 1), workflow_id="w5")
    workflow.delete("w5")
    with pytest.raises(ValueError):
        workflow.get_status("w5")


def test_step_ids_and_layout_match_the_reference(rt, tmp_path):
    """The same graph gets the reference's step ids (stable DFS
    post-order) in both packages, and the port writes the reference's
    layout: dag.pkl, steps/step_{i}_{name}.pkl, status, output.pkl."""
    import ray_tpu
    from ray_tpu.dag import InputNode as RefInputNode
    from ray_tpu.workflow import execution as ref_exec

    from ray_tpu_torch.workflow import execution as port_exec

    def graph(remote, input_node):
        def base(x):
            return x + 1

        def left(a):
            return a * 2

        def right(a, k=0):
            return a + k

        def join(a, b):
            return a + b

        base, left, right, join = (remote(f) for f in (base, left, right,
                                                       join))
        with input_node() as inp:
            b = base.bind(inp)
            return join.bind(left.bind(b), right.bind(b, k=b))

    ids = []
    for remote, inp, ex in ((ray_tpu.remote, RefInputNode, ref_exec),
                            (ray_tpu_torch.remote, InputNode, port_exec)):
        order = ex._topo_order(graph(remote, inp))
        ids.append([ex._step_id(i, n) for i, n in enumerate(order)])
    assert ids[0] == ids[1] == ["step_0_inputnode", "step_1_base",
                                "step_2_left", "step_3_right",
                                "step_4_join"]

    workflow.init(str(tmp_path))
    # x=3: base 4, left 8, right 4+4, join 16
    assert workflow.run(graph(ray_tpu_torch.remote, InputNode),
                        workflow_id="w6", input=3) == 16
    wf = tmp_path / "w6"
    assert sorted(os.listdir(wf)) == ["dag.pkl", "output.pkl", "status",
                                      "steps"]
    assert sorted(os.listdir(wf / "steps")) == [
        f"{s}.pkl" for s in ids[1][1:]]
    assert port_exec._storage_base == str(tmp_path)


def test_default_storage_is_the_ports_own():
    """Unset, the storage root is /tmp/ray_tpu_torch/workflows, apart from
    the reference's /tmp/ray_tpu/workflows; the env var keeps its name."""
    import subprocess
    import sys

    code = ("from ray_tpu_torch.workflow import execution as e\n"
            "print(e._storage_base)\n")
    env = {k: v for k, v in os.environ.items()
           if k != "RAY_TPU_WORKFLOW_STORAGE"}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60, cwd=root,
                         env={**env, "PYTHONPATH": root})
    assert out.stdout.strip() == "/tmp/ray_tpu_torch/workflows", out.stderr
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60, cwd=root,
                         env={**env, "PYTHONPATH": root,
                              "RAY_TPU_WORKFLOW_STORAGE": "/x/wf"})
    assert out.stdout.strip() == "/x/wf", out.stderr
