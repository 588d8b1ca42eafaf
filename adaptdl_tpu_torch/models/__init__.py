"""Models of the port."""

from adaptdl_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
    init_transformer,
    lm_loss_fn,
)

__all__ = [
    "TransformerConfig",
    "TransformerLM",
    "init_transformer",
    "lm_loss_fn",
]
