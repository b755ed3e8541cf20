"""Spark-on-ray_tpu_torch: stand a cluster up inside Spark executors.

Ref parity: ray.util.spark (python/ray/util/spark/cluster_init.py
setup_ray_cluster/shutdown_ray_cluster): a head starts on the Spark
driver, then one long-running Spark *job* pins a task per executor and
each task execs a worker-node process that joins the head; drivers on
the Spark driver then ``init(address=...)``.

Redesign: the Spark coupling is exactly one seam — "run this worker
command once per executor, keep it alive". That seam is the injectable
``launcher`` here, so the cluster logic (head bootstrap, address
handoff, node-count readiness wait, teardown) is testable without a
Spark installation: tests inject a subprocess launcher; a real Spark
session supplies the default one (gated import, like the reference's
`ray.util.spark` requiring pyspark).

A copy of ``ray_tpu.utils.spark``: the worker command is
``python -m ray_tpu_torch start --address … --num-cpus … --num-gpus …``
(``num_gpus_per_node`` where the reference has ``num_tpus_per_node``).
"""

from __future__ import annotations

import subprocess
import sys
import time
from typing import Callable, List, Optional

__all__ = ["setup_ray_cluster", "shutdown_ray_cluster",
           "subprocess_launcher"]

_state = {"procs": [], "address": None, "cleanup": None}


def subprocess_launcher(worker_cmd: List[str]) -> Callable[[], None]:
    """Local-process launcher (what the tests inject; also useful for
    single-host many-process setups): starts the worker command on this
    host, returns a terminator."""
    proc = subprocess.Popen(worker_cmd, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    _state["procs"].append(proc)

    def stop():
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
    return stop


def _spark_launcher(spark, worker_cmd: List[str]) -> Callable[[], None]:
    """The real seam: one Spark task per executor runs the worker
    command for the life of the cluster (ref: cluster_init.py's
    _start_ray_worker_nodes background job)."""
    import threading

    def job():
        n = int(spark.sparkContext.defaultParallelism)

        def run_worker(_):
            import subprocess as sp
            sp.run(worker_cmd)
            return []
        (spark.sparkContext.parallelize(range(n), n)
         .mapPartitions(run_worker).collect())

    t = threading.Thread(target=job, daemon=True)
    t.start()
    return lambda: None  # spark tears tasks down with the job/session


def setup_ray_cluster(*, num_worker_nodes: int, num_cpus_per_node: int = 1,
                      num_gpus_per_node: int = 0, spark=None,
                      launcher: Optional[Callable] = None,
                      timeout_s: float = 120.0) -> str:
    """Start a head here plus ``num_worker_nodes`` workers via Spark (or
    an injected launcher); returns the head address for ``init``.

    Exactly one of ``spark`` (a SparkSession) or ``launcher`` (a
    callable ``launcher(worker_cmd) -> stop_fn``) selects the transport.
    """
    import ray_tpu_torch

    if _state["address"] is not None:
        raise RuntimeError("a spark cluster is already up; call "
                           "shutdown_ray_cluster() first")
    ray_tpu_torch.init(num_cpus=num_cpus_per_node, ignore_reinit_error=True)
    from ray_tpu_torch.core import api as _api

    address = _api._head.enable_tcp()  # "tcp:IP:PORT"
    worker_cmd = [sys.executable, "-m", "ray_tpu_torch", "start",
                  "--address", address,
                  "--num-cpus", str(num_cpus_per_node),
                  "--num-gpus", str(num_gpus_per_node)]
    if launcher is None:
        if spark is None:
            raise ValueError("pass a SparkSession (spark=) or an "
                             "injectable launcher=")
        stop = _spark_launcher(spark, worker_cmd)
        stops = [stop]
    else:
        stops = [launcher(worker_cmd) for _ in range(num_worker_nodes)]

    # readiness: the reference waits for worker registration the same way
    deadline = time.monotonic() + timeout_s
    want = num_worker_nodes + 1  # + the head's own node
    while time.monotonic() < deadline:
        if len(ray_tpu_torch.nodes()) >= want:
            break
        time.sleep(0.2)
    else:
        for s in stops:
            s()
        raise TimeoutError(
            f"only {len(ray_tpu_torch.nodes())}/{want} nodes joined within "
            f"{timeout_s}s")
    _state["address"] = address
    _state["cleanup"] = stops
    return address


def shutdown_ray_cluster():
    """Tear down launched workers (head shuts down with the driver)."""
    for stop in _state.get("cleanup") or []:
        try:
            stop()
        except Exception:
            pass
    _state["procs"].clear()
    _state["address"] = None
    _state["cleanup"] = None
