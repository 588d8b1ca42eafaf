"""Hand-written Hopper kernels and their plain PyTorch versions."""

from adaptdl_tpu_torch.ops.flash_attention import (
    flash_attention,
    make_flash_attention,
)

__all__ = ["flash_attention", "make_flash_attention"]
