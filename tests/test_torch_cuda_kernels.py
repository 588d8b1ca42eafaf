"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Needs an NVIDIA GPU and nvcc; skips elsewhere. The card's machine
has no JAX, so this file imports none and runs without the suite's
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import math

import pytest
import torch

from adaptdl_tpu_torch.ops import _build
from adaptdl_tpu_torch.ops.flash_attention import (
    flash_attention_fwd,
    flash_attention_reference,
)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(6, 192, 64), (3, 100, 40), (2, 96, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_forward_kernel_matches_plain(shape, dtype, causal):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    dtype = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (
        torch.randn(shape, generator=gen, device="cuda").to(dtype)
        for _ in range(3)
    )
    block = shape[1] if shape[1] % 32 else 32
    before = _build.LAUNCHES["flash_attention_fwd"]
    out, lse = flash_attention_fwd(q, k, v, causal, None, block, block)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention_fwd"] == before + 1
    ref, ref_lse = flash_attention_reference(q, k, v, causal, None, block, block)
    # f32: summation order only; bf16: one ulp at the output's scale.
    scale = ref.float().abs().max().item()
    tol = 2e-5 if dtype == torch.float32 else 2.0 ** (math.floor(math.log2(scale)) - 7)
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() <= 1e-4
