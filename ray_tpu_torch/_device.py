"""Where the port runs: on the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` or CUDA by default; raises if CUDA was meant but is absent,
    so a missing card never turns into a silent run on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU unless the "
            "caller passes device='cpu'")
    return dev
