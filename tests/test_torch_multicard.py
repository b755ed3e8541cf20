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
  token for token against the unmeshed engine on one card;
- the tensor-parallel Serve replica (``tensor_parallel=4``, a num_gpus=4
  lease: the replica is rank 0 of an NCCL world whose 3 followers run
  rank 0's step plans) serving the same prompts, token for token against
  the unmeshed engine, and no follower left after serve.shutdown();
- a TorchTrainer of 4 num_gpus=1 workers in one NCCL group (TorchConfig)
  training the llama3-1b train cell on make_mesh(fsdp=4) at global batch
  4 x 2048: its losses within 2e-3 of the unmeshed steps on one card; a
  checkpoint gathered by every rank and kept from rank 0 has the unmeshed
  state's shapes, and resuming from it gives the uninterrupted step.
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


def test_tensor_parallel_replica_4_cards(four_cards):
    """build_continuous_llm_deployment(tensor_parallel=4) on the runtime,
    the GPUs detected; the prompts sent at once through the handle."""
    import dataclasses
    import os
    import random
    import time

    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.models import config as C
    from ray_tpu_torch.models import transformer as T
    from ray_tpu_torch.models.engine import InferenceEngine
    from ray_tpu_torch.serve.llm import build_continuous_llm_deployment

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(C.get_config("llama3-1b"), dtype=torch.float32)
    rng = random.Random(SEED)
    prompts = [[rng.randint(1, cfg.vocab_size - 1) for _ in range(n)]
               for n in PROMPT_LENS]
    kw = dict(slots=8, max_prompt_len=64, max_new_tokens=MAX_NEW, seed=SEED)
    ray_tpu_torch.init(num_cpus=4, log_to_driver=False)
    try:
        assert ray_tpu_torch.cluster_resources()["GPU"] >= 4
        t0 = time.perf_counter()
        h = serve.run(build_continuous_llm_deployment(
            cfg, name="tp4", tensor_parallel=4, **kw), name="tp4",
            timeout_s=600)
        ready = time.perf_counter() - t0
        pids = h.options(method_name="follower_pids").remote().result(
            timeout_s=60)
        t0 = time.perf_counter()
        futs = [h.remote(p) for p in prompts]
        got = [f.result(timeout_s=600)["token_ids"] for f in futs]
        wall = time.perf_counter() - t0
        serve.shutdown()
    finally:
        ray_tpu_torch.shutdown()
    for _ in range(100):
        left = [p for p in pids if os.path.exists(f"/proc/{p}")]
        if not left:
            break
        time.sleep(0.1)
    params = T.init_params(torch.Generator(device="cuda").manual_seed(SEED),
                           cfg, device="cuda")
    eng = InferenceEngine(params, cfg, **kw)
    want = [eng.generate(p) for p in prompts]
    print(f"tensor=4 replica on {torch.cuda.get_device_name(0)}: ready "
          f"{ready} s, 4 requests {wall} s, followers {pids}")
    assert len(pids) == 3 and left == []
    assert got == want


def _train_batch(cfg, device):
    """The train cell's batch: 4 x 2048 tokens from the seed."""
    g = torch.Generator(device=device).manual_seed(SEED + 3)
    toks = torch.randint(0, cfg.vocab_size, (4, cfg.max_seq_len + 1),
                         generator=g, device=device, dtype=torch.int32)
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}


def _seed_state(cfg, tx, device):
    from ray_tpu_torch.models import transformer as T

    params = T.init_params(torch.Generator(device=device).manual_seed(SEED),
                           cfg, device=device)
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "params": params, "opt_state": tx.init(params)}


def _fsdp_loop(config):
    """Each worker of the gang: the state from the seed (or the resumed
    checkpoint) placed on make_mesh(fsdp=world) over the backend's group,
    steps up to config["steps"] on the global batch; at
    config["ckpt_step"] every rank gathers the state (full_tensor() is a
    collective) and rank 0 reports it."""
    import os

    import torch.distributed as dist

    from ray_tpu_torch import train
    from ray_tpu_torch.interop import shard_state
    from ray_tpu_torch.models import training as TR
    from ray_tpu_torch.parallel import make_mesh

    cfg, device = config["cfg"], config["device"]
    ctx = train.get_context()
    tx = TR.make_optimizer(3e-4, mu_dtype=torch.bfloat16)
    mesh = make_mesh(fsdp=ctx.world_size, device=device)
    restored = train.get_checkpoint()
    state = (_seed_state(cfg, tx, device) if restored is None
             else restored.to_pytree(device=device)[0])
    state = shard_state(mesh, state, cfg, tx)
    step = TR.make_train_step(cfg, tx, mesh)
    batch = _train_batch(cfg, device)
    for i in range(int(state["step"]) + 1, config["steps"] + 1):
        _, m = step(state, batch)
        ckpt = None
        if i == config.get("ckpt_step"):
            ckpt = train.Checkpoint.from_pytree(state)
        train.report({"step": i, "loss": m["loss"].item(),
                      "rank": ctx.world_rank, "world": ctx.world_size,
                      "backend": dist.get_backend(),
                      "cuda_visible_devices":
                          os.environ.get("CUDA_VISIBLE_DEVICES")},
                     checkpoint=ckpt if ctx.world_rank == 0 else None)


_FSDP_STEPS, _FSDP_CKPT_STEP, _FSDP_WORKERS = 3, 2, 4


def fsdp_trainer_run(cfg, device: str, storage: str) -> dict:
    """The gang's run, its resumption from the step-_FSDP_CKPT_STEP
    checkpoint, and the same steps unmeshed in this process; the caller
    has started the runtime."""
    from ray_tpu_torch import train
    from ray_tpu_torch.models import training as TR

    gpu = device == "cuda"
    kw = dict(scaling_config=train.ScalingConfig(num_workers=_FSDP_WORKERS,
                                                 use_gpu=gpu),
              run_config=train.RunConfig(
                  name="fsdp", storage_path=storage,
                  checkpoint_config=train.CheckpointConfig(num_to_keep=1)))
    conf = {"cfg": cfg, "device": device, "steps": _FSDP_STEPS}
    first = train.TorchTrainer(_fsdp_loop, **kw, train_loop_config={
        **conf, "ckpt_step": _FSDP_CKPT_STEP}).fit()
    again = train.TorchTrainer(_fsdp_loop, **kw, train_loop_config=conf,
                               resume_from_checkpoint=first.checkpoint).fit()
    kept, _ = first.checkpoint.to_pytree()
    tx = TR.make_optimizer(3e-4, mu_dtype=torch.bfloat16)
    state = _seed_state(cfg, tx, device)
    shapes = [tuple(x.shape) for x in TR.tree_leaves(state)]
    run = TR.make_train_step(cfg, tx)
    batch = _train_batch(cfg, device)
    unmeshed = [run(state, batch)[1]["loss"].item()
                for _ in range(_FSDP_STEPS)]
    return {"first": first, "again": again, "unmeshed": unmeshed,
            "kept_shapes": [tuple(x.shape) for x in TR.tree_leaves(kept)],
            "kept_dtypes": [x.dtype for x in TR.tree_leaves(kept)],
            "shapes": shapes,
            "dtypes": [x.dtype for x in TR.tree_leaves(state)]}


def check_fsdp_trainer_run(out: dict, backend: str = "nccl"):
    first, again = out["first"], out["again"]
    assert first.error is None and again.error is None
    hist = first.metrics_history
    assert [m["step"] for m in hist] == list(range(1, _FSDP_STEPS + 1))
    assert all(m["rank"] == 0 and m["world"] == _FSDP_WORKERS
               and m["backend"] == backend for m in hist)
    losses = [m["loss"] for m in hist]
    assert losses == pytest.approx(out["unmeshed"], rel=2e-3, abs=0)
    assert out["kept_shapes"] == out["shapes"]
    assert out["kept_dtypes"] == out["dtypes"]
    resumed = again.metrics_history
    assert [m["step"] for m in resumed] == list(range(_FSDP_CKPT_STEP + 1,
                                                      _FSDP_STEPS + 1))
    assert [m["loss"] for m in resumed] == pytest.approx(
        losses[_FSDP_CKPT_STEP:], rel=1e-6, abs=0)


def test_torch_trainer_4_cards(four_cards, tmp_path):
    """The llama3-1b train cell (bf16, remat) on 4 cards through
    TorchTrainer: 3 steps, a checkpoint at step 2, and the resumption."""
    import time

    import ray_tpu_torch
    from ray_tpu_torch.models import config as C

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = C.get_config("llama3-1b", param_dtype=torch.bfloat16,
                       max_seq_len=2048, remat=True, remat_policy="nothing")
    ray_tpu_torch.init(num_cpus=8, object_store_memory=16 << 30,
                       log_to_driver=False)
    try:
        assert ray_tpu_torch.cluster_resources()["GPU"] >= 4
        t0 = time.perf_counter()
        out = fsdp_trainer_run(cfg, "cuda", str(tmp_path))
        wall = time.perf_counter() - t0
    finally:
        ray_tpu_torch.shutdown()
    hist = out["first"].metrics_history
    print(f"fsdp=4 TorchTrainer on {torch.cuda.get_device_name(0)}: "
          f"{wall} s, losses {[m['loss'] for m in hist]}, unmeshed "
          f"{out['unmeshed']}, resumed "
          f"{[m['loss'] for m in out['again'].metrics_history]}, "
          f"CUDA_VISIBLE_DEVICES {hist[0]['cuda_visible_devices']}")
    check_fsdp_trainer_run(out)
