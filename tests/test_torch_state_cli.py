"""The port's state API, task events, CLI and driver log mirroring: the
cases of tests/test_state_cli.py, one for one, on ray_tpu_torch's runtime
(``ray_start``: 4 CPUs, ``num_gpus=0``), with the CLI run as
``python -m ray_tpu_torch``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import state as state_api
from ray_tpu_torch.core.context import get_context
from torch_port_util import deadline, ray_start  # noqa: F401 (fixture)


def _flush_events():
    get_context().events.flush()
    time.sleep(0.1)


@deadline(120)
def test_list_nodes_and_workers(ray_start):
    rows = state_api.list_nodes()
    assert len(rows) == 1 and rows[0]["alive"]
    assert rows[0]["resources_total"]["CPU"] == 4.0

    @ray_tpu_torch.remote
    def f():
        return 1

    ray_tpu_torch.get(f.remote(), timeout=60)
    workers = state_api.list_workers()
    assert len(workers) >= 1
    assert all(w["node_idx"] == 0 for w in workers)


@deadline(120)
def test_list_tasks_and_summary(ray_start):
    @ray_tpu_torch.remote
    def my_task(x):
        return x + 1

    ray_tpu_torch.get([my_task.remote(i) for i in range(3)], timeout=60)
    _flush_events()
    t_end = time.monotonic() + 10
    while time.monotonic() < t_end:
        rows = [r for r in state_api.list_tasks(limit=1000)
                if r["name"] == "my_task"]
        if len(rows) == 3 and all(r["state"] == "FINISHED" for r in rows):
            break
        time.sleep(0.2)
    assert len(rows) == 3
    assert all(r["state"] == "FINISHED" for r in rows)

    summ = state_api.summarize_tasks()
    assert summ["by_func_name"]["my_task"]["FINISHED"] == 3


@deadline(120)
def test_failed_task_event(ray_start):
    @ray_tpu_torch.remote(max_retries=0)
    def boom():
        raise ValueError("nope")

    with pytest.raises(Exception):
        ray_tpu_torch.get(boom.remote(), timeout=60)
    _flush_events()
    t_end = time.monotonic() + 10
    rows = []
    while time.monotonic() < t_end:
        rows = [r for r in state_api.list_tasks(limit=1000)
                if r["name"] == "boom" and r["state"] == "FAILED"]
        if rows:
            break
        time.sleep(0.2)
    assert rows and "ValueError" in rows[0]["error"]


@deadline(120)
def test_list_actors_and_objects(ray_start):
    @ray_tpu_torch.remote
    class Counter:
        def bump(self):
            return 1

    c = Counter.remote()
    ray_tpu_torch.get(c.bump.remote(), timeout=60)
    actors = state_api.list_actors()
    assert len(actors) == 1 and actors[0]["state"] == "ALIVE"
    assert actors[0]["class_name"] == "Counter"

    big = ray_tpu_torch.put(np.zeros(60_000))
    objs = state_api.list_objects()
    assert any(o["object_id"] == big.id.hex() for o in objs)
    del big


@deadline(120)
def test_io_loop_stats(ray_start):
    """Event-loop lag counters (analog: instrumented_io_context /
    event_stats.h) are queryable and advance with traffic."""
    @ray_tpu_torch.remote
    def noop():
        return 0

    ray_tpu_torch.get([noop.remote() for _ in range(5)], timeout=60)
    (row,) = state_api.io_loop_stats()
    assert row["loop"] == "head-io"
    assert row["events"] > 0 and row["busy_s"] >= 0
    before = row["events"]
    ray_tpu_torch.get([noop.remote() for _ in range(5)], timeout=60)
    (row2,) = state_api.io_loop_stats()
    assert row2["events"] > before


@deadline(120)
def test_cli_status_and_list_from_subprocess(ray_start):
    """`python -m ray_tpu_torch status/list --address ...` attaches to a live
    head from another process (reference: `ray status` against a running
    cluster)."""
    addr = ray_start.address
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch", "status", "--address", addr],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "nodes: 1" in out.stdout
    assert "CPU" in out.stdout

    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch", "list", "nodes",
         "--address", addr],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    rows = json.loads(out.stdout)
    assert rows and rows[0]["alive"] is True


@deadline(120)
def test_worker_logs_mirrored_to_driver(ray_start, capfd):
    """print() inside a task surfaces in the driver, prefixed with the
    worker source (reference: test_output.py / print_logs)."""
    @ray_tpu_torch.remote
    def chatty():
        print("hello-from-task-xyz", flush=True)
        return 0

    ray_tpu_torch.get(chatty.remote(), timeout=60)
    t_end = time.monotonic() + 10
    seen = ""
    while time.monotonic() < t_end:
        seen += capfd.readouterr().err
        if "hello-from-task-xyz" in seen:
            break
        time.sleep(0.2)
    assert "hello-from-task-xyz" in seen
    assert "(worker-" in seen  # source prefix


def test_cli_parser_covers_surface():
    from ray_tpu_torch.scripts import build_parser

    p = build_parser()
    args = p.parse_args(["start", "--head", "--num-cpus", "2"])
    assert args.head and args.num_cpus == 2
    args = p.parse_args(["list", "actors", "--limit", "5"])
    assert args.entity == "actors" and args.limit == 5
    args = p.parse_args(["summary", "tasks"])
    assert args.entity == "tasks"
