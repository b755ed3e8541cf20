"""The port's parallel layer across real cards: NCCL worlds of 4 ranks, one
card a rank.

Every test here needs 4 NVIDIA GPUs and skips with fewer. The file imports
no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_multicard.py

- ``dryrun_multichip(4)``: the reference's 4-rank mesh sequence=2 x
  tensor=2 (ring attention on each rank's heads, the tensor axis'
  all-reduces over NCCL) against fsdp=4, one train step each of the dry
  run's tiny decoder; their losses within 2e-3;
- the tensor-parallel engine on tensor=4 at llama3-1b's full width in fp32
  (no TF32), driven by step() with the same submissions on every rank,
  token for token against the unmeshed engine on one card.
"""

import pytest
import torch

pytestmark = pytest.mark.gpu

PROMPT_LENS, MAX_NEW, SEED = (5, 17, 40, 64), 32, 0


@pytest.fixture
def four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")


def test_dryrun_multichip_4(four_cards):
    from ray_tpu_torch.entry import dryrun_multichip

    out = dryrun_multichip(4)
    assert out["meshes"] == [dict(data=1, fsdp=1, expert=1, pipeline=1,
                                  sequence=2, tensor=2), dict(fsdp=4)]
    assert len(out["dense"]) == 2 and out["dense_spread"] < 2e-3


def _engine_tokens(rank: int, tensor: int):
    """Each prompt's greedy tokens from the fp32 engine on tensor=``tensor``
    (every rank), and on rank 0 also from the unmeshed engine."""
    import dataclasses
    import random
    import time

    from ray_tpu_torch.models import config as C
    from ray_tpu_torch.models import transformer as T
    from ray_tpu_torch.models.engine import InferenceEngine
    from ray_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(C.get_config("llama3-1b"), dtype=torch.float32)
    params = T.init_params(torch.Generator(device="cuda").manual_seed(SEED),
                           cfg, device="cuda")
    rng = random.Random(SEED)
    prompts = [[rng.randint(1, cfg.vocab_size - 1) for _ in range(n)]
               for n in PROMPT_LENS]

    def run(mesh):
        eng = InferenceEngine(params, cfg, slots=8, max_prompt_len=64,
                              max_new_tokens=MAX_NEW, greedy=True, seed=SEED,
                              mesh=mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = [eng.submit(p) for p in prompts]
        for _ in range(1000):
            if all(r.done.is_set() for r in reqs):
                break
            eng.step()
        return [list(r.tokens) for r in reqs], time.perf_counter() - t0

    out = {"meshed": run(make_mesh(tensor=tensor))}
    if rank == 0:
        out["unmeshed"] = run(None)
        out["card"] = torch.cuda.get_device_name(0)
    return out


def test_tensor_parallel_engine_4_cards(four_cards):
    from ray_tpu_torch.parallel.world import run_world

    out = run_world(_engine_tokens, 4, (4,), device="cuda", timeout=900)
    want, wall = out[0]["unmeshed"]
    print(f"tensor=4 engine on {out[0]['card']}: meshed "
          f"{[r['meshed'][1] for r in out]} s, unmeshed {wall} s")
    for r in out:
        assert r["meshed"][0] == want
