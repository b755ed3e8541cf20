"""Parallel layer of the port: only the unsharded reference attention so far."""

from ray_tpu_torch.parallel.ring import reference_attention

__all__ = ["reference_attention"]
