"""Entry points of the port: the counterparts of the repo's
``__graft_entry__.entry()`` and ``dryrun_multichip(n)``.

``entry()`` returns a forward step of the flagship decoder family at
GPT-2-small scale (``gpt2_small_config(remat=False)``, bf16 compute, fp32
weights from a generator seeded with 0) with its example arguments, tokens
[4, 512], on the card unless the caller asks for the CPU:

    fn, args = entry()
    logits = fn(*args)   # [4, 512, 50304] fp32

``dryrun_multichip(n)`` runs one train step of a tiny decoder on each mesh
of the reference's 8-device sweep, and two more, in a world of n ranks, and
holds their losses together (a spread below 2e-3):

    dryrun_multichip(8)                 # 8 cards, NCCL
    dryrun_multichip(8, device="cpu")   # 8 processes, gloo
"""

from __future__ import annotations

import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.config import gpt2_small_config, tiny_config
from ray_tpu_torch.models.transformer import forward, init_params


def entry(device=None, cfg=None, tokens_shape=(4, 512)):
    """-> (fn, (params, tokens)): ``fn(params, tokens)`` is the forward,
    logits [B, T, vocab] fp32. ``cfg`` (default GPT-2-small) and
    ``tokens_shape`` may be cut for a quick check."""
    cfg = cfg or gpt2_small_config(remat=False)
    dev = resolve_device(device)
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    tokens = torch.zeros(tokens_shape, dtype=torch.int32, device=dev)

    def fn(params, tokens):
        return forward(params, tokens, cfg)

    return fn, (params, tokens)


# The reference's n=8 sweep (__graft_entry__.py:159-187): 5 dense meshes
# and 2 MoE meshes, plus sequence=4 (dense) and data=2 x fsdp=4 (MoE).
DENSE_MESHES = (
    dict(fsdp=4, tensor=2),
    dict(data=2, fsdp=2, sequence=2),
    dict(fsdp=8),
    dict(data=2, fsdp=1, pipeline=2, tensor=2),
    dict(slices=2, fsdp=4),
    dict(sequence=4, fsdp=2),
)
MOE_MESHES = (dict(fsdp=1, expert=2, pipeline=2, sequence=2), dict(fsdp=8),
              dict(data=2, fsdp=4))
SPREAD_TOL = 2e-3


def _axis_sizes(n: int) -> dict:
    """The reference's spread of n ranks over the axes (its
    ``_axis_sizes``): expert and pipeline 2 when 8 divides n, sequence 2
    when 4 does, tensor 2 when 16 does or n is even but not a multiple of
    8, data 2 when 32 does, the rest fsdp."""
    expert = pipeline = 2 if n % 8 == 0 else 1
    sequence = 2 if n % 4 == 0 else 1
    tensor = 2 if n % 16 == 0 or (n % 2 == 0 and n % 8 != 0) else 1
    data = 2 if n % 32 == 0 else 1
    fsdp = n // (data * expert * pipeline * sequence * tensor)
    return dict(data=data, fsdp=fsdp, expert=expert, pipeline=pipeline,
                sequence=sequence, tensor=tensor)


def _meshes(n: int) -> list:
    """The meshes for n ranks other than 8: the reference's spread and
    fsdp=n beside it to hold it against."""
    spread = _axis_sizes(n)
    return [spread] if spread["fsdp"] == n else [spread, dict(fsdp=n)]


def _dryrun_step(sizes: dict, moe: bool, batch_size: int, seq: int,
                 device) -> float:
    """One train step of the tiny decoder on one mesh -> the global loss.
    The same config, init and data on every mesh (of one size of fsdp)."""
    from ray_tpu_torch.models import training as TR
    from ray_tpu_torch.parallel.mesh import MeshSpec

    mesh = MeshSpec(**sizes).build(device)
    # the reference's dry-run config at d_model 256 in place of 64: heads
    # of 64, the smallest the flash kernels take on the card
    cfg = tiny_config(d_model=max(256, 8 * sizes.get("fsdp", 1)),
                      n_heads=4, n_kv_heads=4, d_ff=128,
                      attention_impl="auto", moe_experts=4 if moe else 0)
    tx = TR.make_optimizer(1e-3)
    state = TR.init_train_state(
        torch.Generator(device=device).manual_seed(0), cfg, tx, mesh)
    step = TR.make_train_step(cfg, tx, mesh)
    toks = torch.randint(0, cfg.vocab_size, (batch_size, seq + 1),
                         generator=torch.Generator(device=device).manual_seed(1),
                         device=device, dtype=torch.int32)
    _, metrics = step(state, {"inputs": toks[:, :-1],
                              "targets": toks[:, 1:]})
    loss = float(metrics["loss"])
    if not loss == loss or abs(loss) == float("inf"):
        raise AssertionError(f"non-finite loss {loss} on mesh {sizes}")
    return loss


def _dryrun_rank(rank: int, n: int, device_type: str):
    device = torch.device(device_type)
    if n != 8:
        meshes = _meshes(n)
        moe = meshes[0]["expert"] > 1  # MoE where the spread has experts
        losses = [_dryrun_step(m, moe, 2 * n, 64, device) for m in meshes]
        return {"meshes": [] if moe else meshes,
                "dense": [] if moe else losses,
                "moe_meshes": meshes if moe else [],
                "moe": losses if moe else []}
    dense = [_dryrun_step(m, False, 8, 64, device) for m in DENSE_MESHES]
    moe = [_dryrun_step(m, True, 8, 64, device) for m in MOE_MESHES]
    return {"meshes": list(DENSE_MESHES), "dense": dense,
            "moe_meshes": list(MOE_MESHES), "moe": moe}


def dryrun_multichip(n_devices: int, device=None, timeout: float = 600.0):
    """One train step on each mesh of the sweep in a world of ``n_devices``
    ranks: on the card (NCCL, one card a rank; raises with fewer cards)
    unless the caller passes ``device="cpu"`` (gloo). With 8 ranks the
    dense losses of DENSE_MESHES, and the MoE losses of MOE_MESHES, must
    each spread less than SPREAD_TOL; with another n, the losses of
    ``_meshes(n)``. -> rank 0's losses and their spreads."""
    from ray_tpu_torch.parallel.world import run_world

    dev = resolve_device(device)
    out = run_world(_dryrun_rank, n_devices, (n_devices, dev.type),
                    device=dev.type, timeout=timeout)[0]
    groups = [("dense", "meshes", False), ("moe", "moe_meshes", True)]
    for key, meshes, moe in groups:
        for sizes, loss in zip(out.get(meshes, []), out[key]):
            print(f"dryrun_multichip({n_devices}): mesh={sizes} moe={moe} "
                  f"loss={loss:.4f}")
        out[f"{key}_spread"] = (max(out[key]) - min(out[key])
                                if out[key] else 0.0)
        if not out[f"{key}_spread"] < SPREAD_TOL:
            raise AssertionError(
                f"{key} loss parity violated across meshes: {out[key]} "
                f"(spread {out[f'{key}_spread']})")
    print(f"dryrun_multichip({n_devices}): swept "
          f"{len(out['dense']) + len(out['moe'])} meshes, dense spread="
          f"{out['dense_spread']:.2e}, moe spread={out['moe_spread']:.2e} ok")
    return out
