"""Single-device entry point of the port: the counterpart of the repo's
``__graft_entry__.entry()``.

``entry()`` returns a forward step of the flagship decoder family at
GPT-2-small scale (``gpt2_small_config(remat=False)``, bf16 compute, fp32
weights from a generator seeded with 0) with its example arguments, tokens
[4, 512], on the card unless the caller asks for the CPU:

    fn, args = entry()
    logits = fn(*args)   # [4, 512, 50304] fp32
"""

from __future__ import annotations

import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.config import gpt2_small_config
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
