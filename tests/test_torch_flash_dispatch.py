"""Which forward kernel the port's flash attention picks, decided on the
host before any launch, and the plain path for CPU tensors. No CUDA is
touched; the kernels themselves are tested on the card by
test_torch_cuda_kernels.py."""

import importlib

import numpy as np
import pytest
import torch

from adaptdl_tpu_torch.ops import _build
from tests.torch_support import private_tempdir  # noqa: F401

fa = importlib.import_module("adaptdl_tpu_torch.ops.flash_attention")


@pytest.mark.parametrize("head_dim", [64, 128])
def test_bf16_head_dims_of_the_tensor_core_kernel_take_it(head_dim):
    assert fa.forward_kernel(torch.bfloat16, head_dim) == fa.KERNEL_SM90


@pytest.mark.parametrize(
    "dtype, head_dim",
    [
        (torch.float32, 64), (torch.float32, 128), (torch.float32, 40),
        (torch.bfloat16, 40), (torch.bfloat16, 8), (torch.bfloat16, 96),
    ],
)
def test_other_inputs_take_the_f32_kernel(dtype, head_dim):
    assert fa.forward_kernel(dtype, head_dim) == fa.KERNEL


def test_both_kernels_have_sources():
    assert {fa.KERNEL, fa.KERNEL_SM90} <= set(_build.sources())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head_dim", [64, 128, 40])
def test_cpu_tensors_take_the_plain_version_on_either_key(dtype, head_dim):
    _build.reset_launches()
    rng = np.random.default_rng(head_dim)
    q, k, v = (
        torch.from_numpy(rng.normal(size=(2, 32, head_dim)).astype(np.float32))
        .to(dtype)
        for _ in range(3)
    )
    out, lse = fa.flash_attention_fwd(q, k, v, True, None, 16, 16)
    ref, ref_lse = fa.flash_attention_reference(q, k, v, True, None, 16, 16)
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    assert _build.LAUNCHES[fa.KERNEL] == 0
    assert _build.LAUNCHES[fa.KERNEL_SM90] == 0


def test_sm90_launcher_refuses_inputs_it_does_not_take():
    q = torch.zeros((2, 32, 40), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        fa._launch(fa.KERNEL_SM90, q, q, q, True, None)
    q = torch.zeros((2, 32, 64), dtype=torch.float32)
    with pytest.raises(ValueError, match="bfloat16"):
        fa._launch(fa.KERNEL_SM90, q, q, q, True, None)
    assert _build.LAUNCHES[fa.KERNEL_SM90] == 0


def test_sm90_source_declares_its_parallel_build():
    source = (_build.CSRC_DIR / f"{fa.KERNEL_SM90}.cu").read_text()
    assert _build._PARTS.search(source).group(1) == "2"
    # The C entry point and the error-string hook the loader binds.
    assert f'extern "C" int adaptdl_{fa.KERNEL_SM90}(' in source
    assert "adaptdl_cuda_error_string" in source

