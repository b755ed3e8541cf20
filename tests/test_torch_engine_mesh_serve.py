"""``InferenceEngine.serve_forever`` on a tensor mesh of 2 ranks (ROADMAP
A1c), on the CPU.

One process (``tests/torch_parallel_ranks.serve_mesh_leader``) is rank 0
of a ``parallel.world.World`` of 2 whose rank 1 runs ``follow()``. Rank 0
serves requests submitted at staggered times from a client thread and
broadcasts its step plans. Its tokens, and those of a streamed request,
must equal the unmeshed engine's ``generate()`` and the model's
``generate()`` token for token. Then the follower is stopped while a
request waits in its prefill, and killed: the waiting request must fail
(not hang), later submissions are refused, and no follower is left.

The tensor-parallel Serve replica's own teardown: a ``tensor_parallel=2``
replica built in one process leaves no follower once ``__del__`` ran.
"""

import multiprocessing as mp
import queue
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import config as C
from ray_tpu_torch.models import transformer as T
from ray_tpu_torch.models.engine import InferenceEngine
from ray_tpu_torch.models.generate import generate
from torch_parallel_ranks import (one_world_at_a_time,
                                  replica_del_reaps_followers,
                                  serve_mesh_leader)
from torch_port_util import one_torch_thread  # noqa: F401 (fixture)

ENGINE = dict(slots=2, max_prompt_len=16, max_new_tokens=8, decode_chunk=2,
              seed=0)
# (prompt, max_new_tokens, seconds after the previous submission)
REQUESTS = [([3, 1, 4, 1, 5], 8, 0.0), ([2, 7], 5, 0.05),
            ([9, 2, 6, 5, 3, 5, 8, 9, 7], 8, 0.2), ([1], 3, 0.0),
            ([4, 4], 6, 0.3)]


def _in_process(fn, *args, timeout: float = 240):
    """``fn(*args, results)`` in a fresh process (not a daemon: it starts
    followers) under the host-wide world lock; -> what it put."""
    ctx = mp.get_context("forkserver")
    results = ctx.Queue()
    proc = ctx.Process(target=fn, args=(*args, results))
    deadline = time.monotonic() + timeout
    with one_world_at_a_time():
        proc.start()
        try:
            while True:
                try:
                    return results.get(timeout=1)
                except queue.Empty:
                    if not proc.is_alive() or time.monotonic() > deadline:
                        raise RuntimeError(
                            f"{fn.__name__} gave no result (exit code "
                            f"{proc.exitcode})") from None
        finally:
            proc.join(30)
            if proc.is_alive():
                proc.kill()
                proc.join(5)


@pytest.fixture(scope="module")
def served():
    """(rank 0's results, the params as numpy)."""
    cfg = C.tiny_config()
    params = T.init_params(torch.Generator().manual_seed(5), cfg,
                           device="cpu")
    params_np = {k: ({n: w.numpy() for n, w in v.items()}
                     if isinstance(v, dict) else v.numpy())
                 for k, v in params.items()}
    spec = {"params": params_np, "engine": ENGINE, "requests": REQUESTS}
    return _in_process(serve_mesh_leader, spec), params


def test_served_mesh_matches_unmeshed_generate(served):
    out, params = served
    cfg = C.tiny_config()
    assert out["served"] and out["errors"] == []
    eng = InferenceEngine(params, cfg, device="cpu", **ENGINE)
    want = [eng.generate(p, n) for p, n, _ in REQUESTS]
    assert out["tokens"] == want
    model = [generate(params, torch.tensor([p]), cfg, max_new_tokens=n)
             [0, len(p):].tolist() for p, n, _ in REQUESTS]
    assert out["tokens"] == model
    assert out["streamed"] == want[0]
    assert np.all([len(t) == n for t, (_, n, _) in
                   zip(out["tokens"], REQUESTS)])


def test_dead_follower_fails_waiting_requests(served):
    out, _ = served
    assert out["waited_while_stopped"]
    assert out["failed_after_kill"] and out["fail_s"] < 30
    assert out["refused_after"]
    assert out["followers_alive"] == [False]


def test_replica_del_reaps_its_follower():
    out = _in_process(replica_del_reaps_followers)
    assert len(out["tokens"]) == 4 and len(out["pids"]) == 1
    assert out["alive_after_del"] == [False]
    assert not out["world_left"]
