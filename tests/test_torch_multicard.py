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
  state's shapes, and resuming from it gives the uninterrupted step;
- the MPMD pipeline (ray_tpu_torch.train.Pipeline) of the llama3-1b train
  cell on one node with 4 GPUs: 4 num_gpus=1 stage actors, one a card,
  and 2 stages x 2 replicas whose grads sync through
  ray_tpu_torch.collective, against single_program_reference on one card.
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


def _axis_vs_unmeshed(rank: int, sizes: dict, moe: bool):
    """dryrun_multichip's train step on ``sizes``' mesh on every rank, and
    on rank 0 the same step unmeshed on its own card."""
    from ray_tpu_torch.entry import _dryrun_step

    dev = torch.device("cuda")
    out = {"meshed": _dryrun_step(sizes, moe, 8, 64, dev)}
    if rank == 0:
        out["unmeshed"] = _dryrun_step(sizes, moe, 8, 64, dev,
                                       unmeshed=True)
        out["card"] = torch.cuda.get_device_name(0)
    return out


@pytest.mark.parametrize("sizes,moe", [
    (dict(pipeline=4), False), (dict(fsdp=1, expert=4), True)],
    ids=["pipeline4", "moe_expert4"])
def test_axis_of_4_cards_matches_unmeshed(four_cards, sizes, moe):
    """ROADMAP C5: pipeline and expert over NCCL across 4 cards, each held
    against the unmeshed step within dryrun_multichip's spread (2e-3)."""
    from ray_tpu_torch.entry import SPREAD_TOL
    from ray_tpu_torch.parallel.world import run_world

    out = run_world(_axis_vs_unmeshed, 4, (sizes, moe), device="cuda",
                    timeout=600)
    want = out[0]["unmeshed"]
    print(f"{sizes} moe={moe} on {out[0]['card']}: meshed "
          f"{[r['meshed'] for r in out]}, unmeshed {want}")
    for r in out:
        assert abs(r["meshed"] - want) < SPREAD_TOL


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


def pipeline_run(n_stages: int, replicas: int, device: str) -> dict:
    """The llama3-1b train cell (device "cuda"; on the CPU, tiny_config
    for a rehearsal) as ``n_stages`` x ``replicas`` stage actors of the
    port's MPMD pipeline (chip_smoke.LlamaStage), 1F1B on 4 microbatches
    of [1, T], on one node of 4 GPUs: one num_gpus=1 stage a card (on the
    CPU the gang takes no GPU). The oracle is single_program_reference in
    the driver on one card. -> walls, leases, losses, and the grads'
    distances from the oracle."""
    import time

    import chip_smoke as CS
    import ray_tpu_torch as rt
    from ray_tpu_torch.models import config as C
    from ray_tpu_torch.models import transformer as T
    from ray_tpu_torch.train import pipeline as PL

    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = device == "cuda"
    if gpu:
        cfg = C.get_config("llama3-1b", param_dtype=torch.bfloat16)
        seq = 2048
    else:
        cfg = C.tiny_config(tie_embeddings=True, n_layers=4)
        seq = 32
    params = T.init_params(torch.Generator(device=device).manual_seed(SEED),
                           cfg, device=device)
    g = torch.Generator(device=device).manual_seed(SEED + 3)
    toks = torch.randint(0, cfg.vocab_size, (4, seq + 1), generator=g,
                         device=device, dtype=torch.int32)
    mbs = [toks[i:i + 1, :-1] for i in range(4)]
    tgts = [toks[i:i + 1, 1:] for i in range(4)]
    stages = CS.llama_stages(PL, params, cfg, n_stages)
    ref_loss, ref = PL.single_program_reference(stages, CS.stage_loss, mbs,
                                                tgts)
    absum = (CS.abs_grad_sum(PL, stages, mbs, tgts) if replicas > 1
             else None)
    rt.init(num_cpus=8, num_gpus=4 if gpu else 0,
            object_store_memory=(16 << 30) if gpu else None,
            log_to_driver=False,
            _system_config={"pipeline_checkpoint_every_waves": 0})
    try:
        t0 = time.perf_counter()
        pipe = PL.Pipeline(stages, loss_fn=CS.stage_loss, schedule="1f1b",
                           replicas_per_stage=replicas, placement="none")
        probes = pipe.probe()
        start_s = time.perf_counter() - t0
        pipe.reset()
        t0 = time.perf_counter()
        out = pipe.run_batch(mbs, tgts)
        wall = time.perf_counter() - t0
        launches = [p["kernel_launches"] for p in pipe.probe()]
        grads = pipe.grads()
        others = (rt.get([pipe.actors[k * replicas + 1].grads.remote(True)
                          for k in range(n_stages)], timeout=600)
                  if replicas > 1 else None)
        pipe.shutdown()
    finally:
        rt.shutdown()
    leaves = [PL._tree_leaves(x) for x in grads]
    refs = [PL._tree_leaves(x) for x in ref]
    res = {"stages": n_stages, "replicas": replicas,
           "gpu_ids": sorted(p["gpu_ids"][0] for p in probes
                             if p["gpu_ids"]),
           "cuda_devices": [p["cuda_devices"] for p in probes],
           "stage_actors_start_s": start_s, "batch_wall_s": wall,
           "loss": out["loss"], "oracle_loss": ref_loss,
           "loss_rel": abs(out["loss"] - ref_loss) / abs(ref_loss),
           "grad_rel": [CS._tree_rel(x, r) for x, r in zip(leaves, refs)],
           "launches": launches}
    if replicas > 1:
        res["over_bound"], res["worst_over_bound"] = CS.dp_over_bound(
            PL, grads, ref, absum, 4)
        res["replicas_bitwise"] = all(
            CS._bitwise_tree(PL._tree_leaves(a), PL._tree_leaves(b))
            for a, b in zip(grads, others))
    return res


def check_pipeline_run(res: dict, gpu: bool = True):
    import chip_smoke as CS

    n, r = res["stages"], res["replicas"]
    if gpu:
        assert res["gpu_ids"] == [0, 1, 2, 3]  # one stage a card
        assert res["cuda_devices"] == [1] * 4
        per = 16 // n * 4 // r  # layers x microbatches of a stage actor
        assert res["launches"] == [{k: per for k in CS._TPIPE_LAUNCHES}] * 4
    assert res["loss_rel"] <= CS._TPIPE_REL_TOL
    if r == 1:
        assert max(res["grad_rel"]) <= CS._TPIPE_REL_TOL
    else:
        assert res["over_bound"] == 0 and res["replicas_bitwise"]


@pytest.mark.parametrize("n_stages,replicas", [(4, 1), (2, 2)])
def test_train_pipeline_4_cards(four_cards, n_stages, replicas):
    """The port's MPMD pipeline across 4 cards: 4 stages of 4 layers, one
    card a stage, and 2 stages x 2 replicas whose bf16 CUDA grads sync
    through ray_tpu_torch.collective, each against
    single_program_reference on one card within chip_smoke's bars
    (_TPIPE_REL_TOL; the 2 x 2 grads per element within _TPIPE_DP_BOUND
    and the replicas equal bit for bit). Prints the batch wall beside
    phase train_pipeline's on one card."""
    import json

    res = pipeline_run(n_stages, replicas, "cuda")
    print(json.dumps({"train_pipeline_4_cards": res}), flush=True)
    check_pipeline_run(res)
