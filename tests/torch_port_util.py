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
