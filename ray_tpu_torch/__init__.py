"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu's model stack, for NVIDIA Hopper.

The JAX package ``ray_tpu`` stays the reference; this package imports
nothing from it. What is ported so far is the decoder's inference and
training stack with its dense or Mixture-of-Experts FFN (``models``), the
first half of the parallel layer (``parallel``: device meshes, logical
sharding over data/fsdp/slice, ring attention over sequence), the entry
points (``entry``: ``entry()`` and ``dryrun_multichip``) and the
flash-attention kernels, forward and backward (``ops``), which run as
hand-written CUDA on the card and as their plain PyTorch versions on CPU
tensors. Entry points run on CUDA unless the caller passes
``device="cpu"``.
"""

from ray_tpu_torch import models, ops, parallel
from ray_tpu_torch.interop import params_from_numpy

__all__ = ["models", "ops", "parallel", "params_from_numpy"]
