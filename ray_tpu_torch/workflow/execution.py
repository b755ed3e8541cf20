"""Workflow executor: topological DAG run with durable step checkpoints.

Ref analog: python/ray/workflow/workflow_executor.py:32 (the in-flight
dict of step futures + completion persistence) and workflow/api.py (the
public run/resume surface). Differences by design: storage is a local
directory tree (the reference's filesystem storage backend) and the DAG is
the general ray_tpu_torch.dag IR — no separate @workflow.step decorator
layer (the reference also moved to plain dag.bind graphs).

Layout: ``{base}/{workflow_id}/dag.pkl`` (the pickled DAG, so resume works
in a fresh process), ``steps/{step_id}.pkl`` (one per completed step),
``status`` (RUNNING | SUCCESSFUL | RESUMABLE | FAILED — FAILED means the
DAG itself is invalid and resume cannot help).

Step values are checkpointed with plain ``pickle``; a torch tensor pickles
through torch's own reducer, which records its device, so a step that
returned a CUDA tensor comes back from its checkpoint on the same CUDA
device, bit for bit (and raises in a process that sees no CUDA device).
The default root is ``/tmp/ray_tpu_torch/workflows``, apart from the JAX
package's, so the two never read each other's workflows.
"""

from __future__ import annotations

import os
import pickle
import shutil
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.dag import ClassNode, DAGNode, InputNode


class WorkflowStatus:
    RUNNING = "RUNNING"
    SUCCESSFUL = "SUCCESSFUL"
    FAILED = "FAILED"
    RESUMABLE = "RESUMABLE"


_storage_base = os.environ.get("RAY_TPU_WORKFLOW_STORAGE",
                               "/tmp/ray_tpu_torch/workflows")


def init(storage: Optional[str] = None):
    """Set the workflow storage root (reference: workflow.init(storage))."""
    global _storage_base
    if storage:
        _storage_base = storage


def _wf_dir(workflow_id: str) -> str:
    return os.path.join(_storage_base, workflow_id)


def _write_status(workflow_id: str, status: str):
    with open(os.path.join(_wf_dir(workflow_id), "status"), "w") as f:
        f.write(status)


# ------------------------------------------------------------ topology


def _topo_order(root: DAGNode) -> List[DAGNode]:
    """Stable DFS postorder — step ids must be identical across runs of
    the same (unpickled) DAG for resume to match checkpoints."""
    order: List[DAGNode] = []
    seen: set = set()

    def visit(node: DAGNode):
        if id(node) in seen:
            return
        seen.add(id(node))
        deps = list(node._bound_args) + list(node._bound_kwargs.values())
        if hasattr(node, "_class_node"):
            deps.append(node._class_node)
        for d in deps:
            if isinstance(d, DAGNode):
                visit(d)
        order.append(node)

    visit(root)
    return order


def _step_id(index: int, node: DAGNode) -> str:
    name = getattr(getattr(node, "_remote_fn", None), "_name", "") or \
        type(node).__name__.lower()
    return f"step_{index}_{name}"


# ------------------------------------------------------------ execution


def _execute(workflow_id: str, root: DAGNode, input_value) -> Any:
    """Run the DAG: submit steps whose deps are ready, persist each step
    result as it lands, and surface the root's value."""
    wf_dir = _wf_dir(workflow_id)
    steps_dir = os.path.join(wf_dir, "steps")
    os.makedirs(steps_dir, exist_ok=True)
    order = _topo_order(root)
    for node in order:
        if isinstance(node, ClassNode):
            _write_status(workflow_id, WorkflowStatus.FAILED)
            raise ValueError(
                "workflows checkpoint pure task DAGs; actor (ClassNode) "
                "steps are not durable — use a FunctionNode graph")

    values: Dict[int, Any] = {}      # id(node) -> checkpointed value
    refs: Dict[int, Any] = {}        # id(node) -> in-flight ObjectRef
    ref_to_node: Dict[Any, DAGNode] = {}
    step_ids = {id(n): _step_id(i, n) for i, n in enumerate(order)}

    def resolve(a):
        if isinstance(a, InputNode):
            return input_value
        if isinstance(a, DAGNode):
            return values[id(a)] if id(a) in values else refs[id(a)]
        return a

    _write_status(workflow_id, WorkflowStatus.RUNNING)
    try:
        for node in order:
            if isinstance(node, InputNode):
                continue
            ckpt = os.path.join(steps_dir, step_ids[id(node)] + ".pkl")
            if os.path.exists(ckpt):
                with open(ckpt, "rb") as f:
                    values[id(node)] = pickle.load(f)
                continue
            args = [resolve(a) for a in node._bound_args]
            kwargs = {k: resolve(v)
                      for k, v in node._bound_kwargs.items()}
            ref = node._remote_fn.remote(*args, **kwargs)
            refs[id(node)] = ref
            ref_to_node[ref] = node

        # persist results in completion order (reference: executor's
        # in-flight dict + checkpoint-on-complete)
        outstanding = list(ref_to_node)
        while outstanding:
            done, outstanding = ray_tpu_torch.wait(
                outstanding, num_returns=1, timeout=None)
            for ref in done:
                node = ref_to_node[ref]
                value = ray_tpu_torch.get(ref)
                sid = step_ids[id(node)]
                tmp = os.path.join(steps_dir, sid + ".tmp")
                with open(tmp, "wb") as f:
                    pickle.dump(value, f, protocol=5)
                os.replace(tmp, os.path.join(steps_dir, sid + ".pkl"))
                values[id(node)] = value
    except Exception:
        _write_status(workflow_id, WorkflowStatus.RESUMABLE)
        raise
    out = values[id(order[-1])]
    tmp = os.path.join(wf_dir, "output.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(out, f, protocol=5)
    os.replace(tmp, os.path.join(wf_dir, "output.pkl"))
    _write_status(workflow_id, WorkflowStatus.SUCCESSFUL)
    return out


# ------------------------------------------------------------ public API


def run(dag: DAGNode, *, workflow_id: Optional[str] = None,
        input: Any = None) -> Any:  # noqa: A002 - ref-parity kwarg
    """Execute a DAG durably; returns the final output value."""
    import uuid

    workflow_id = workflow_id or f"wf_{uuid.uuid4().hex[:10]}"
    wf_dir = _wf_dir(workflow_id)
    os.makedirs(wf_dir, exist_ok=True)
    from ray_tpu_torch.core.serialization import dumps as _dumps

    with open(os.path.join(wf_dir, "dag.pkl"), "wb") as f:
        f.write(_dumps((dag, input)))
    return _execute(workflow_id, dag, input)


def run_async(dag: DAGNode, *, workflow_id: Optional[str] = None,
              input: Any = None):
    """Like run(), but returns a concurrent.futures.Future."""
    import concurrent.futures
    import uuid

    workflow_id = workflow_id or f"wf_{uuid.uuid4().hex[:10]}"
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    fut = pool.submit(run, dag, workflow_id=workflow_id, input=input)
    fut.workflow_id = workflow_id
    pool.shutdown(wait=False)
    return fut


def resume(workflow_id: str) -> Any:
    """Re-run a RESUMABLE/failed workflow; completed steps short-circuit
    from their checkpoints (reference: workflow.resume)."""
    wf_dir = _wf_dir(workflow_id)
    dag_path = os.path.join(wf_dir, "dag.pkl")
    if not os.path.exists(dag_path):
        raise ValueError(f"no such workflow: {workflow_id}")
    from ray_tpu_torch.core.serialization import loads as _loads

    with open(dag_path, "rb") as f:
        dag, input_value = _loads(f.read())
    return _execute(workflow_id, dag, input_value)


def get_status(workflow_id: str) -> str:
    try:
        with open(os.path.join(_wf_dir(workflow_id), "status")) as f:
            return f.read().strip()
    except OSError:
        raise ValueError(f"no such workflow: {workflow_id}")


def get_output(workflow_id: str) -> Any:
    """Output of a SUCCESSFUL workflow (reference: workflow.get_output)."""
    path = os.path.join(_wf_dir(workflow_id), "output.pkl")
    if not os.path.exists(path):
        status = get_status(workflow_id)
        raise ValueError(
            f"workflow {workflow_id} has no output (status: {status})")
    with open(path, "rb") as f:
        return pickle.load(f)


def list_all() -> List[tuple]:
    """[(workflow_id, status)] for every stored workflow."""
    if not os.path.isdir(_storage_base):
        return []
    out = []
    for wid in sorted(os.listdir(_storage_base)):
        try:
            out.append((wid, get_status(wid)))
        except ValueError:
            continue
    return out


def delete(workflow_id: str):
    shutil.rmtree(_wf_dir(workflow_id), ignore_errors=True)
