"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

Counterpart of ``ray_tpu/ops`` (Pallas kernels for the TPU). Importing this
package builds nothing: a kernel is compiled by ``ops/_build.py`` the first
time a wrapper is handed a CUDA tensor.
"""

from ray_tpu_torch.ops.flash_attention import flash_attention

__all__ = ["flash_attention"]
