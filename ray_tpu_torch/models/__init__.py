"""Built-in model family of the port: the Llama-style decoder.

Mirrors ``ray_tpu/models/__init__.py``: configs, the forward and loss (dense or Mixture-of-Experts FFN), the train
step, KV-cache generation, the continuous-batching engine and the MLM
masking, and with a mesh the sharded forward, loss and train step
(``param_logical_axes``, ``state_shardings``, ``batch_sharding``).
"""

from ray_tpu_torch.models.config import (
    PRESETS,
    TransformerConfig,
    bert_base_config,
    get_config,
    gpt2_small_config,
    llama3_1b_config,
    llama3_8b_config,
    llama3_70b_config,
    tiny_config,
)
from ray_tpu_torch.models.mlm import mask_tokens
# NOTE: generate() itself is not re-exported, as in the reference: it would
# shadow the ray_tpu_torch.models.generate submodule.
from ray_tpu_torch.models.generate import decode_step, init_cache, prefill
from ray_tpu_torch.models.engine import InferenceEngine
from ray_tpu_torch.models.transformer import (
    Transformer,
    forward,
    init_params,
    loss_fn,
    param_logical_axes,
)
from ray_tpu_torch.models.training import (
    batch_sharding,
    init_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
    state_shardings,
)

__all__ = [
    "TransformerConfig", "get_config", "PRESETS", "tiny_config",
    "gpt2_small_config", "llama3_1b_config", "llama3_8b_config",
    "llama3_70b_config", "bert_base_config", "mask_tokens",
    "forward", "init_params", "loss_fn", "Transformer",
    "param_logical_axes", "state_shardings", "batch_sharding",
    "prefill", "decode_step", "init_cache", "InferenceEngine",
    "make_optimizer", "make_train_step", "make_eval_step",
    "init_train_state",
]
