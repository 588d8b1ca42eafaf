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
    KERNEL,
    KERNEL_SM90,
    NEG_INF,
    flash_attention_fwd,
    flash_attention_reference,
)
# By its own name (pytest puts tests/ on sys.path): on the card's machine
# an installed package named "tests" hides this directory's.
from torch_support import private_tempdir  # noqa: F401


def _bf16_ulp(x):
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def _sm90_bound(q, k, v, causal, ref, ref_lse):
    """Per-element bound on |sm90 kernel - plain version|. The kernel
    rounds P to bf16 before P V, moving o_id by at most 2^-9 w_id with
    w_id = sum_j p_ij |v_jd| (p rebuilt from the plain lse); both outputs
    then round to bf16, together at most one ulp at |ref| + 2^-9 w. The P
    term is taken twice, for f32 summation order."""
    seq, head_dim = q.shape[1:]
    s = (q.float() * head_dim**-0.5) @ k.float().transpose(1, 2)
    if causal:
        above = torch.ones(seq, seq, dtype=torch.bool, device=q.device).triu(1)
        s = s.masked_fill(above, NEG_INF)
    w = torch.exp(s - ref_lse[..., None]) @ v.float().abs()
    magnitude = ref.float().abs() + 2.0**-8 * w
    ulp = torch.exp2(torch.floor(torch.log2(magnitude.clamp_min(2.0**-126))) - 7)
    return 2.0**-8 * w + ulp


def _run(shape, dtype, causal, block):
    """flash_attention_fwd on seeded inputs: (inputs, outputs, the launch
    counts that moved)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (
        torch.randn(shape, generator=gen, device="cuda").to(dtype)
        for _ in range(3)
    )
    before = dict(_build.LAUNCHES)
    out, lse = flash_attention_fwd(q, k, v, causal, None, block, block)
    torch.cuda.synchronize()
    moved = {
        name: count - before.get(name, 0)
        for name, count in _build.LAUNCHES.items()
        if count != before.get(name, 0)
    }
    return (q, k, v), (out, lse), moved


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(6, 192, 64), (3, 100, 40), (2, 96, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_forward_kernel_matches_plain(shape, dtype, causal):
    dtype = getattr(torch, dtype)
    block = shape[1] if shape[1] % 32 else 32
    (q, k, v), (out, lse), moved = _run(shape, dtype, causal, block)
    want = KERNEL_SM90 if dtype == torch.bfloat16 and shape[2] != 40 else KERNEL
    assert moved == {want: 1}
    ref, ref_lse = flash_attention_reference(q, k, v, causal, None, block, block)
    diff = (out.float() - ref.float()).abs()
    if want == KERNEL_SM90:
        assert (diff <= _sm90_bound(q, k, v, causal, ref, ref_lse)).all()
    else:
        # f32: summation order only; bf16: one ulp at the output's scale.
        scale = ref.float().abs().max().item()
        tol = 2e-5 if dtype == torch.float32 else _bf16_ulp(scale)
        assert diff.max().item() <= tol
    assert (lse - ref_lse).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("seq", [512, 192, 100])
@pytest.mark.parametrize("causal", [True, False])
def test_sm90_kernel_matches_plain(head_dim, seq, causal):
    block = {512: 128, 192: 64, 100: 100}[seq]
    (q, k, v), (out, lse), moved = _run(
        (4, seq, head_dim), torch.bfloat16, causal, block
    )
    assert moved == {KERNEL_SM90: 1}
    ref, ref_lse = flash_attention_reference(q, k, v, causal, None, block, block)
    diff = (out.float() - ref.float()).abs()
    assert (diff <= _sm90_bound(q, k, v, causal, ref, ref_lse)).all()
    assert (lse - ref_lse).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape, dtype",
    [
        ((2, 64, 64), "float32"),
        ((2, 64, 128), "float32"),
        ((2, 64, 40), "bfloat16"),
        ((2, 64, 96), "bfloat16"),
        ((8, 512, 64), "float32"),
        ((4, 128, 8), "float32"),
        ((4, 128, 72), "float32"),
        ((4, 128, 128), "float32"),
        ((3, 100, 40), "float32"),
        ((3, 100, 120), "float32"),
        ((3, 100, 120), "bfloat16"),
        ((4, 128, 96), "bfloat16"),
    ],
)
@pytest.mark.parametrize("causal", [True, False])
def test_other_inputs_take_the_f32_kernel(shape, dtype, causal):
    """f32 and bf16 at head dims the sm90 kernel does not take reach the
    f32 kernel, whose 3xTF32 products keep the float32 result: S 512 (the
    main path's sequence), the smallest and largest head dims, one that is
    not a power of two, ragged seqs."""
    dtype = getattr(torch, dtype)
    block = {512: 128, 128: 64, 100: 100, 64: 64}[shape[1]]
    (q, k, v), (out, lse), moved = _run(shape, dtype, causal, block)
    assert moved == {KERNEL: 1}
    ref, ref_lse = flash_attention_reference(q, k, v, causal, None, block, block)
    scale = ref.float().abs().max().item()
    tol = 2e-5 if dtype == torch.float32 else _bf16_ulp(scale)
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() <= 1e-4
