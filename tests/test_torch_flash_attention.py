"""The port's flash attention against the JAX package's.

The JAX side runs its Pallas kernel in interpret mode on the CPU, as
``tests/test_flash_attention.py`` does; the port's wrapper takes its
plain PyTorch version for CPU tensors. Same numpy inputs, same
tolerances as the JAX tests: forward 2e-5, gradients atol 5e-5 / rtol
5e-4 (float32; the two differ only in summation order). The CUDA
kernel itself is tested on the card by test_torch_cuda_kernels.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptdl_tpu.ops import flash_attention as jax_flash_attention
from adaptdl_tpu.ops.flash_attention import _flash_fwd as jax_flash_fwd
from adaptdl_tpu_torch.ops import _build
from adaptdl_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_fwd,
    flash_attention_reference,
)
from tests.torch_support import private_tempdir  # noqa: F401


def _qkv(batch=2, heads=2, seq=64, d=16, seed=0):
    rng = np.random.default_rng(seed)
    shape = (batch, heads, seq, d)
    return tuple(rng.normal(size=shape).astype(np.float32) for _ in range(3))


def _torch(*arrays):
    return tuple(torch.from_numpy(a.copy()) for a in arrays)


@pytest.mark.parametrize("causal", [True, False])
def test_forward_matches_jax(causal):
    q, k, v = _qkv()
    want = jax_flash_attention(*map(jnp.asarray, (q, k, v)), causal, None, 16, 16)
    got = flash_attention(*_torch(q, k, v), causal, None, 16, 16)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5
    )


@pytest.mark.parametrize("causal", [True, False])
def test_lse_matches_jax(causal):
    q, k, v = _qkv(seed=3)
    _, want = jax_flash_fwd(*map(jnp.asarray, (q, k, v)), causal, None, 16, 16)
    flat = [t.reshape(4, 64, 16) for t in _torch(q, k, v)]
    _, got = flash_attention_reference(*flat, causal, None, 16, 16)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(want).reshape(4, 64), atol=2e-5, rtol=2e-5
    )


def test_forward_unequal_blocks():
    q, k, v = _qkv(seq=64)
    want = jax_flash_attention(*map(jnp.asarray, (q, k, v)), True, None, 32, 16)
    got = flash_attention(*_torch(q, k, v), True, None, 32, 16)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5
    )


@pytest.mark.parametrize("causal", [True, False])
def test_gradients_match_jax(causal):
    q, k, v = _qkv(seq=32, d=8, seed=1)

    def jax_loss(q, k, v):
        out = jax_flash_attention(q, k, v, causal, None, 16, 16)
        return jnp.sum(out * jnp.cos(out))

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v))
    )
    tq, tk, tv = (t.requires_grad_() for t in _torch(q, k, v))
    out = flash_attention(tq, tk, tv, causal, None, 16, 16)
    got = torch.autograd.grad((out * torch.cos(out)).sum(), (tq, tk, tv))
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(
            g.numpy(), np.asarray(w), atol=5e-5, rtol=5e-4,
            err_msg=f"d{name}",
        )


def test_seq_must_divide_into_blocks():
    q, k, v = (t.reshape(4, 64, 16) for t in _torch(*_qkv()))
    with pytest.raises(ValueError, match="divide into blocks"):
        flash_attention_fwd(q, k, v, True, None, 48, 16)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    _build.reset_launches()
    q, k, v = (t.reshape(4, 64, 16) for t in _torch(*_qkv()))
    out, lse = flash_attention_fwd(q, k, v, True, None, 16, 16)
    ref, ref_lse = flash_attention_reference(q, k, v, True, None, 16, 16)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    assert _build.LAUNCHES["flash_attention_fwd"] == 0


def test_other_devices_raise_and_count_no_launch():
    _build.reset_launches()
    q = torch.empty((4, 64, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        flash_attention_fwd(q, q, q)
    assert _build.LAUNCHES["flash_attention_fwd"] == 0


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_libraries", {})
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.load("flash_attention_fwd")
    assert not (tmp_path / "kernels").exists() or not any(
        (tmp_path / "kernels").iterdir()
    )
