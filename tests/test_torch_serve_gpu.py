"""The port's Serve on the card: a num_gpus=1 continuous-batching replica
and CUDA tensors sent to a replica by reference.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_serve_gpu.py

Its deployment class is a module-level definition, so it pickles by
reference with or without cloudpickle.
"""

import os

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import serve

pytestmark = pytest.mark.gpu

PROMPTS = [[3, 1, 4, 1, 5], [2, 7], [9, 2, 6, 5, 3, 5, 8, 9, 7], [1]]
ENGINE = dict(slots=4, max_prompt_len=16, max_new_tokens=8, seed=0)


@pytest.fixture(scope="module")
def cuda_serve():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    ray_tpu_torch.init(num_cpus=2, object_store_memory=2 << 30,
                       log_to_driver=False)
    yield serve
    serve.shutdown()
    ray_tpu_torch.shutdown()


class _TensorEcho:
    """Reports where a request tensor landed and its bits' checksum."""

    def __call__(self, t):
        return {"device": t.device.type, "dtype": str(t.dtype),
                "cuda_visible_devices":
                    os.environ.get("CUDA_VISIBLE_DEVICES"),
                "sum": int(t.view(torch.int16).sum(dtype=torch.int64))}


def test_gpu_replica_matches_the_in_process_engine(cuda_serve):
    from ray_tpu_torch.models import config as C
    from ray_tpu_torch.models import transformer as T
    from ray_tpu_torch.models.engine import InferenceEngine
    from ray_tpu_torch.serve.llm import build_continuous_llm_deployment

    app = build_continuous_llm_deployment("tiny", name="cuda_llm", **ENGINE)
    assert app.deployment.config.ray_actor_options == {"num_gpus": 1}
    assert app.deployment.config.health_check_timeout_s == 300.0
    h = serve.run(app, name="cuda_llm")
    futs = [h.remote(p) for p in PROMPTS]
    got = [f.result(timeout_s=300)["token_ids"] for f in futs]
    streamed = [c["token_id"] for c in h.options(
        method_name="stream", stream=True).remote(PROMPTS[0])]
    cfg = C.tiny_config()
    params = T.init_params(torch.Generator(device="cuda").manual_seed(0),
                           cfg, device="cuda")
    eng = InferenceEngine(params, cfg, **ENGINE)
    want = [eng.generate(p) for p in PROMPTS]
    assert got == want
    assert streamed == want[0]
    serve.delete("cuda_llm")


def test_cuda_tensor_request_rides_by_reference(cuda_serve):
    from ray_tpu_torch.core.object_ref import ObjectRef
    from ray_tpu_torch.serve.handle import _to_ref

    x = torch.randn(16 << 20, generator=torch.Generator(
        device="cuda").manual_seed(1), device="cuda",
        dtype=torch.bfloat16)  # 32 MiB, above the 16 MiB threshold
    assert isinstance(_to_ref(x), ObjectRef)
    dep = serve.deployment(_TensorEcho, ray_actor_options={"num_gpus": 1},
                           health_check_timeout_s=300)
    h = serve.run(dep.bind(), name="echo")
    out = h.remote(x).result(timeout_s=300)
    assert out == {"device": "cuda", "dtype": "torch.bfloat16",
                   "cuda_visible_devices": "0",
                   "sum": int(x.view(torch.int16).sum(dtype=torch.int64))}
    serve.delete("echo")
