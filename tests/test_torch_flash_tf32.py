"""The arithmetic of the f32 flash forward kernel, emulated on the CPU.

``adaptdl_tpu_torch/csrc/flash_attention_fwd.cu`` computes both products
of the attention forward on the tensor cores in TF32 (10 explicit
mantissa bits), each operand split as x = big + small with both parts
TF32, and each product as small*big + big*small + big*big (3xTF32). No
card is needed to check that this keeps the float32 result: the rounding
``cvt.rna.tf32.f32`` does is emulated here on the int32 view (add 0x1000,
clear the low 13 bits), the MMA's reading of an unrounded operand
(its top 19 bits) by clearing them, and a product of two TF32 values is
exact in float32. The blockwise loop runs in the kernel's order (32-key
tiles, online softmax in log2 units with the scale folded into the
exponent) and is held to the JAX package's flash forward (its Pallas
kernel in interpret mode) at the tolerances the kernel is held to on the
card: 2e-5 on the output, 1e-4 on the log-sum-exp. The same loop with one
TF32 product misses 2e-5, which is why the kernel splits.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adaptdl_tpu.ops.flash_attention import _flash_fwd as jax_flash_fwd
from tests.torch_support import one_torch_thread, private_tempdir  # noqa: F401

NEG_INF = -1e30
BLOCK_N = 32  # the kernel's keys per tile
LOW_BITS = 0x1FFF  # the 13 mantissa bits TF32 drops


def tf32_rna(x):
    """``cvt.rna.tf32.f32``: round to nearest, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~LOW_BITS).view(torch.float32)


def tf32_trunc(x):
    """What the MMA reads of an f32 operand: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & ~LOW_BITS).view(torch.float32)


def split(x):
    """Q and P: big and small both rounded to TF32."""
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def split_kv(x):
    """K and V: small = x - big left unrounded, read as its top 19 bits."""
    big = tf32_rna(x)
    return big, tf32_trunc(x - big)


def product(a, b, three):
    """a @ b on TF32 parts: small*big + big*small + big*big (3xTF32), or
    big*big alone."""
    (a_big, a_small), (b_big, b_small) = a, b
    if not three:
        return a_big @ b_big
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def emulated_forward(q, k, v, causal, three=True):
    """The kernel's loop over 32-key tiles for [bh, seq, d] float32
    inputs: ``(out, lse)``."""
    bh, seq, head_dim = q.shape
    c = torch.tensor(head_dim**-0.5 * math.log2(math.e), dtype=torch.float32)
    q_parts = split(q)
    m = torch.full((bh, seq, 1), NEG_INF)
    l = torch.zeros((bh, seq, 1))
    acc = torch.zeros((bh, seq, head_dim))
    rows = torch.arange(seq)[:, None]
    for k0 in range(0, seq, BLOCK_N):
        k_tile = k[:, k0 : k0 + BLOCK_N]
        s = product(q_parts, split_kv(k_tile.transpose(1, 2)), three)
        if causal:
            keys = k0 + torch.arange(k_tile.shape[1])[None, :]
            s = torch.where(keys <= rows, s, torch.tensor(NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True) * c)
        p = torch.exp2(s * c - m_new)
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + product(
            split(p), split_kv(v[:, k0 : k0 + BLOCK_N]), three
        )
        m = m_new
    safe_l = torch.clamp(l, min=1e-30)
    return acc / safe_l, (m * math.log(2.0) + torch.log(safe_l))[..., 0]


def _inputs(batch=1, heads=4, seq=256, d=64, seed=0):
    """The numpy inputs of tests/test_torch_flash_attention.py, larger."""
    rng = np.random.default_rng(seed)
    shape = (batch, heads, seq, d)
    return tuple(rng.normal(size=shape).astype(np.float32) for _ in range(3))


def _against_jax(causal, three):
    q, k, v = _inputs()
    want, want_lse = jax_flash_fwd(
        *map(jnp.asarray, (q, k, v)), causal, None, 64, 64
    )
    flat = [torch.from_numpy(a.reshape(4, 256, 64).copy()) for a in (q, k, v)]
    got, got_lse = emulated_forward(*flat, causal, three)
    out_err = np.abs(got.numpy() - np.asarray(want).reshape(4, 256, 64)).max()
    lse_err = np.abs(got_lse.numpy() - np.asarray(want_lse).reshape(4, 256)).max()
    return out_err, lse_err


@pytest.mark.parametrize(
    "splitter, bound",
    [(split, 2.0**-22), (split_kv, 2.0**-21)],
    ids=["q_and_p_rna", "k_and_v_unrounded_small"],
)
def test_split_parts_are_tf32_and_sum_to_x(splitter, bound):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=4096) * 10.0 ** rng.uniform(-6, 6, size=4096)).astype(
        np.float32
    )
    big, small = splitter(torch.from_numpy(x))
    assert not (big.view(torch.int32) & LOW_BITS).any()
    assert not (small.view(torch.int32) & LOW_BITS).any()
    residual = np.abs(x.astype(np.float64) - big.double().numpy() - small.double().numpy())
    assert (residual <= bound * np.abs(x.astype(np.float64))).all()


@pytest.mark.parametrize("causal", [True, False])
def test_3xtf32_forward_matches_jax(causal):
    out_err, lse_err = _against_jax(causal, three=True)
    assert out_err <= 2e-5, out_err
    assert lse_err <= 1e-4, lse_err


@pytest.mark.parametrize("causal", [True, False])
def test_1xtf32_forward_misses_the_f32_tolerance(causal):
    out_err, _ = _against_jax(causal, three=False)
    assert out_err > 2e-5, out_err
