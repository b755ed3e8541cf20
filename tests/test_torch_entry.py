"""``ray_tpu_torch.entry.entry()``, the port's counterpart of
``__graft_entry__.entry()``: it builds and runs on the CPU when asked to, at
a tiny size, and without a device it means the card."""

import pytest
import torch

from ray_tpu_torch.entry import entry
from ray_tpu_torch.models import config as tcfg
from ray_tpu_torch.models.transformer import forward, init_params
from torch_port_util import one_torch_thread  # noqa: F401 (fixture)


def test_entry_builds_and_runs_on_the_cpu_at_a_tiny_size():
    cfg = tcfg.tiny_config()
    fn, (params, tokens) = entry(device="cpu", cfg=cfg, tokens_shape=(2, 8))
    assert tokens.shape == (2, 8) and tokens.device.type == "cpu"
    logits = fn(params, tokens)
    assert logits.shape == (2, 8, cfg.vocab_size)
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
    want = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    torch.testing.assert_close(logits, forward(want, tokens, cfg))


def test_entry_without_a_card_raises(monkeypatch):
    """Without a device it means the card, and raises when there is none:
    no silent run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()
