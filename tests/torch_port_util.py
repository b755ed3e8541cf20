"""Shared fixture of the port's CPU tests (tests/test_torch_*.py)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while a port test module runs: the suite runs
    several pytest workers on one host, and torch's default of a thread per
    core in each of them starves the runtime tests' timing."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def deadline(seconds: int):
    """Fail the decorated test with TimeoutError once it has run
    ``seconds`` (SIGALRM in the main thread, where pytest runs tests): each
    cluster test of the port carries a timeout of its own, so a wedged
    runtime fails that test instead of the whole run's time limit."""
    import functools
    import signal

    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            def expired(signum, frame):
                raise TimeoutError(
                    f"{fn.__name__} ran past its {seconds} s deadline")

            old = signal.signal(signal.SIGALRM, expired)
            signal.alarm(seconds)
            try:
                return fn(*args, **kwargs)
            finally:
                signal.alarm(0)
                signal.signal(signal.SIGALRM, old)

        return run

    return wrap


@pytest.fixture
def ray_start():
    """A fresh single-node runtime of the port per test (4 CPUs, no GPU;
    tests/conftest.py's fixture of this name starts the JAX package's)."""
    import ray_tpu_torch

    info = ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield info
    ray_tpu_torch.shutdown()


@pytest.fixture
def ray_start_cluster():
    """A ray_tpu_torch.cluster_utils.Cluster with a head node of 2 CPUs;
    tests add nodes as needed."""
    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(initialize_head=True,
                      head_node_args={"num_cpus": 2, "num_gpus": 0})
    yield cluster
    cluster.shutdown()
