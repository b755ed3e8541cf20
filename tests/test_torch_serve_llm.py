"""The port's LLM deployments (ray_tpu_torch.serve.llm) on its runtime, on
the CPU (``device="cpu"``, tiny config):

- the cases of tests/test_generate.py::TestServeLLM, one for one, on
  ray_tpu_torch.init(num_cpus=4, num_gpus=0);
- one scenario through ray_tpu.serve and then ray_tpu_torch.serve: both
  packages' LLM deployments load the same pickled numpy checkpoint of JAX's
  tiny params, and their fp32 greedy tokens are equal for batched, streamed
  and continuous requests;
- a sampled replica: draws repeat for the same seed, differ between
  requests;
- bf16 CPU tensors above both by-reference thresholds, bound as weights (a
  state dict, leaf by leaf) and sent as a request, arrive bitwise equal;
- the tensor-parallel replica (``tensor_parallel=2``: a gloo world of the
  replica and one follower process) equals the unmeshed replica token for
  token, and after serve.shutdown() no follower is left;
- the builders' GPU leases, and a replica that finds no card raises.
"""

import importlib
import os
import pickle
import time

import jax
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu.models.config import get_config as jax_get_config
from ray_tpu.models.transformer import init_params as jax_init_params
from ray_tpu_torch import serve
from ray_tpu_torch.core.config import get_config
from ray_tpu_torch.serve.llm import (GPU_REPLICA_START_S,
                                     _ContinuousLLMReplica, _LLMReplica,
                                     build_continuous_llm_deployment,
                                     build_llm_deployment)
from torch_parallel_ranks import one_world_at_a_time


@pytest.fixture
def serve_rt():
    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield serve
    serve.shutdown()
    ray_tpu_torch.shutdown()


class TestServeLLM:
    """tests/test_generate.py::TestServeLLM on the port."""

    def test_llm_deployment_batches_and_generates(self, serve_rt):
        app = build_llm_deployment(
            "tiny", max_prompt_len=8, max_new_tokens=4, max_batch_size=4,
            device="cpu")
        handle = serve.run(app, name="llm")
        prompts = [[1, 2, 3], [4, 5], [6, 7, 8, 9]]
        futs = [handle.remote(p) for p in prompts]
        outs = [f.result(timeout_s=120) for f in futs]
        for o in outs:
            assert len(o["token_ids"]) == 4
        # greedy generation is deterministic per prompt, batched or not
        again = handle.remote([1, 2, 3]).result(timeout_s=120)
        assert again["token_ids"] == outs[0]["token_ids"]
        # oversized prompts are rejected per-request, not silently
        # clipped (and don't poison the coalesced batch)
        with pytest.raises(Exception, match="max_prompt_len"):
            handle.remote(list(range(20))).result(timeout_s=120)

    def test_streaming_tokens_match_batched(self, serve_rt):
        app = build_llm_deployment(
            "tiny", name="llm_s", max_prompt_len=8, max_new_tokens=4,
            max_batch_size=4, device="cpu")
        handle = serve.run(app, name="llm_s")
        batched = handle.remote([1, 2, 3]).result(timeout_s=120)
        gen = handle.options(method_name="stream",
                             stream=True).remote([1, 2, 3])
        streamed = [chunk["token_id"] for chunk in gen]
        assert streamed == batched["token_ids"]

    def test_continuous_deployment_serves_concurrent_requests(self,
                                                              serve_rt):
        app = build_continuous_llm_deployment(
            "tiny", name="cllm", slots=4, max_prompt_len=8,
            max_new_tokens=8, device="cpu")
        handle = serve.run(app, name="cllm")
        futs = [handle.remote([1 + i, 2 + i], max_new_tokens=2 + i % 4)
                for i in range(8)]
        outs = [f.result(timeout_s=180) for f in futs]
        for i, o in enumerate(outs):
            assert len(o["token_ids"]) <= 2 + i % 4
        again = handle.remote([1, 2], max_new_tokens=2).result(timeout_s=120)
        assert again["token_ids"] == outs[0]["token_ids"]
        # every request got its own slot admission (no cohort batching)
        stats = handle.options(method_name="engine_stats") \
            .remote().result(timeout_s=60)
        assert stats["prefills"] == 9
        assert stats["requests_done"] == 9

    def test_continuous_streaming_matches_call(self, serve_rt):
        app = build_continuous_llm_deployment(
            "tiny", name="cllm_s", slots=2, max_prompt_len=8,
            max_new_tokens=4, device="cpu")
        handle = serve.run(app, name="cllm_s")
        whole = handle.remote([3, 1, 4]).result(timeout_s=120)
        gen = handle.options(method_name="stream",
                             stream=True).remote([3, 1, 4])
        streamed = [chunk["token_id"] for chunk in gen]
        assert streamed == whole["token_ids"]

    def test_batcher_cap_matches_compiled_shape(self, serve_rt):
        app = build_llm_deployment(
            "tiny", name="llm2", max_prompt_len=4, max_new_tokens=2,
            max_batch_size=2, device="cpu")
        handle = serve.run(app, name="llm2")
        futs = [handle.remote([1 + i]) for i in range(6)]
        outs = [f.result(timeout_s=120) for f in futs]
        assert all(len(o["token_ids"]) == 2 for o in outs)


# ------------------------------------- one scenario through both packages

PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9]]
CONT_PROMPTS = [([3, 1, 4, 1, 5], 8), ([2, 7], 3), ([9, 2, 6, 5, 3, 5], 6),
                ([8], 8)]


def _llm_scenario(pkg, ckpt: str, cpu: dict) -> dict:
    """Greedy fp32 tokens of both LLM deployments on one checkpoint:
    batched (concurrent calls), streamed, and continuous (concurrent calls
    of different lengths, and one streamed)."""
    srv = pkg.serve
    llm = importlib.import_module(f"{pkg.__name__}.serve.llm")
    out = {}
    h = srv.run(llm.build_llm_deployment(
        "tiny", name="b", max_prompt_len=8, max_new_tokens=4,
        max_batch_size=4, checkpoint_dir=ckpt, **cpu), name="b")
    futs = [h.remote(p) for p in PROMPTS]
    out["batched"] = [f.result(timeout_s=120)["token_ids"] for f in futs]
    out["streamed"] = [[c["token_id"] for c in h.options(
        method_name="stream", stream=True).remote(p)] for p in PROMPTS]
    h = srv.run(llm.build_continuous_llm_deployment(
        "tiny", name="c", slots=2, max_prompt_len=8, max_new_tokens=8,
        checkpoint_dir=ckpt, **cpu), name="c")
    futs = [h.remote(p, max_new_tokens=n) for p, n in CONT_PROMPTS]
    out["continuous"] = [f.result(timeout_s=180)["token_ids"] for f in futs]
    out["continuous_streamed"] = [c["token_id"] for c in h.options(
        method_name="stream", stream=True).remote(*CONT_PROMPTS[0])]
    srv.shutdown()
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(ray_tpu.serve's tokens, ray_tpu_torch.serve's tokens)."""
    import ray_tpu.serve  # noqa: F401 (pkg.serve)

    params = jax_init_params(jax.random.key(7), jax_get_config("tiny"))
    ckpt = str(tmp_path_factory.mktemp("llm") / "tiny.pkl")
    with open(ckpt, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, params), f)
    ray_tpu.init(num_cpus=4, num_tpus=0)
    try:
        ref = _llm_scenario(ray_tpu, ckpt, {})
    finally:
        ray_tpu.shutdown()
    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    try:
        port = _llm_scenario(ray_tpu_torch, ckpt, {"device": "cpu"})
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()
    return ref, port


@pytest.mark.parametrize("path", ["batched", "streamed", "continuous",
                                  "continuous_streamed"])
def test_same_checkpoint_same_tokens_through_both_packages(both, path):
    ref, port = both
    assert port[path] == ref[path]
    assert ref["streamed"] == ref["batched"]
    assert ref["continuous_streamed"] == ref["continuous"][0]


# ---------------------------------------------------------- sampling


def test_sampled_draws_repeat_for_a_seed_and_differ_between_requests(
        serve_rt):
    """Each request draws from a fresh generator seeded from the replica's
    master (the reference's key split): a second replica with the same
    seed repeats the first's draws request by request, and two requests
    of one replica draw differently."""
    def draws(name, seed):
        h = serve.run(build_llm_deployment(
            "tiny", name=name, max_prompt_len=8, max_new_tokens=6,
            max_batch_size=2, greedy=False, seed=seed, device="cpu"),
            name=name)
        return [h.remote([1, 2, 3]).result(timeout_s=120)["token_ids"]
                for _ in range(2)] + [[c["token_id"] for c in h.options(
                    method_name="stream", stream=True).remote([1, 2, 3])]]

    a, b, c = draws("s1", 3), draws("s2", 3), draws("s3", 4)
    assert a == b
    assert a[0] != a[1] and a[0] != a[2] and a != c
    assert all(0 <= t < 256 for row in a for t in row)


# ------------------------------------------------- tensors by reference


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _bits(t) -> bytes:
    return t.contiguous().view(torch.uint16).numpy().tobytes()


def test_bf16_tensors_ride_by_reference_bitwise(serve_rt):
    from ray_tpu_torch.core.object_ref import ObjectRef
    from ray_tpu_torch.serve import api as serve_api
    from ray_tpu_torch.serve.handle import _to_ref

    g = torch.Generator().manual_seed(0)
    state = {"a": torch.randn(64, 1024, generator=g).to(torch.bfloat16),
             "b": {"c": torch.randn(128, 512, generator=g).to(
                 torch.bfloat16)}}
    x = torch.randn(256, 256, generator=g).to(torch.bfloat16)  # 128 KiB

    class TensorHolder:  # defined here: pickled by value, no test imports
        """Holds bf16 weights (a state dict) and reports what came."""

        def __init__(self, state):
            self.state = state

        @staticmethod
        def bits(t) -> bytes:
            import torch

            return t.contiguous().view(torch.uint16).numpy().tobytes()

        def weights(self) -> dict:
            return {"a": self.bits(self.state["a"]),
                    "b.c": self.bits(self.state["b"]["c"])}

        def __call__(self, x) -> dict:
            return {"dtype": str(x.dtype), "shape": list(x.shape),
                    "bits": self.bits(x)}

    cfg = get_config()
    old = (cfg.serve_weights_by_ref_min_bytes,
           cfg.serve_request_by_ref_min_bytes)
    cfg.serve_weights_by_ref_min_bytes = 64 * 1024
    cfg.serve_request_by_ref_min_bytes = 64 * 1024
    try:
        app = serve.deployment(TensorHolder).bind(state)
        # every leaf goes by reference, and a redeploy of the same tensors
        # reuses the refs (the digest cache)
        refs = serve_api._collect_app(app)[0]["weights_refs"]
        again = serve_api._collect_app(app)[0]["weights_refs"]
        assert len(refs) == 2 and all(isinstance(r, ObjectRef)
                                      for r in refs)
        assert [r.id for r in again] == [r.id for r in refs]
        assert isinstance(_to_ref(x), ObjectRef)
        assert not isinstance(_to_ref(x[:8]), ObjectRef)
        h = serve.run(app, name="tensors")
        got = h.weights.remote().result(timeout_s=60)
        assert got == {k: _bits(v) for k, v in _leaves(state).items()}
        out = h.remote(x).result(timeout_s=60)
        assert out == {"dtype": "torch.bfloat16", "shape": [256, 256],
                       "bits": _bits(x)}
    finally:
        (cfg.serve_weights_by_ref_min_bytes,
         cfg.serve_request_by_ref_min_bytes) = old


def test_weights_digest_of_tensors():
    """dtype, shape and bytes each change the digest; the same values in
    another tensor do not."""
    from ray_tpu_torch.serve.api import _weights_digest

    t = torch.arange(12, dtype=torch.float32)
    same = _weights_digest(t.clone())
    assert _weights_digest(t) == same
    assert _weights_digest(t.reshape(3, 4)) != same
    assert _weights_digest(t.to(torch.bfloat16)) != same
    assert _weights_digest(t + 1) != same
    assert _weights_digest(t.numpy()) != same  # numpy keeps its own form


# ---------------------------------------------------- tensor parallel


def _alive(pids):
    return [p for p in pids if os.path.exists(f"/proc/{p}")
            and open(f"/proc/{p}/stat").read().split()[2] != "Z"]


def test_tensor_parallel_replica_equals_unmeshed_and_leaves_no_follower(
        serve_rt):
    kw = dict(slots=2, max_prompt_len=8, max_new_tokens=6, device="cpu")
    requests = [([3, 1, 4, 1, 5], 6), ([2, 7], 4), ([9, 9, 9], 6),
                ([1], 5)]
    with one_world_at_a_time():
        tp = serve.run(build_continuous_llm_deployment(
            "tiny", name="tp", tensor_parallel=2, **kw), name="tp")
        pids = tp.options(method_name="follower_pids").remote().result(
            timeout_s=60)
        one = serve.run(build_continuous_llm_deployment(
            "tiny", name="one", **kw), name="one")
        futs = [(tp.remote(p, max_new_tokens=n),
                 one.remote(p, max_new_tokens=n)) for p, n in requests]
        got = [(a.result(timeout_s=180)["token_ids"],
                b.result(timeout_s=180)["token_ids"]) for a, b in futs]
        streamed = [c["token_id"] for c in tp.options(
            method_name="stream", stream=True).remote([3, 1, 4, 1, 5])]
        assert len(pids) == 1 and _alive(pids) == pids
        serve.shutdown()
        for _ in range(150):
            if not _alive(pids):
                break
            time.sleep(0.1)
    assert [a for a, _ in got] == [b for _, b in got]
    assert [len(a) for a, _ in got] == [n for _, n in requests]
    assert streamed == got[0][0]
    assert _alive(pids) == []


# ------------------------------------------------ GPU leases, no card


def test_builders_lease_gpus_unless_on_the_cpu():
    """A GPU replica leases its cards and has GPU_REPLICA_START_S to start
    (a fresh worker imports torch and makes a CUDA context first); on the
    CPU the deployment defaults stay."""
    def opts(app):
        c = app.deployment.config
        return c.ray_actor_options, c.health_check_timeout_s

    start = GPU_REPLICA_START_S
    assert opts(build_llm_deployment("tiny")) == ({"num_gpus": 1}, start)
    assert opts(build_continuous_llm_deployment("tiny")) == (
        {"num_gpus": 1}, start)
    assert opts(build_continuous_llm_deployment(
        "tiny", tensor_parallel=4)) == ({"num_gpus": 4}, start)
    assert opts(build_llm_deployment("tiny", device="cpu")) == ({}, 10.0)
    assert opts(build_continuous_llm_deployment(
        "tiny", device="cpu", tensor_parallel=2)) == ({}, 10.0)


def test_replicas_without_a_card_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (_LLMReplica, _ContinuousLLMReplica):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls("tiny")


def test_tensor_parallel_needs_as_many_cards(monkeypatch):
    """Raised before any process starts or any CUDA call is made."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="only 1 local devices"):
        _ContinuousLLMReplica("tiny", tensor_parallel=2)
