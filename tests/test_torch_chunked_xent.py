"""The port's chunked softmax cross-entropy against the JAX package's.

``chunked_softmax_xent`` and the JAX function see the same float32
inputs (a vocab of 100, not a multiple of the chunk): per-token losses
at atol 1e-5, ``dx`` and ``dE`` at atol 1e-4 (float32 accumulation
order over the chunks). A bf16 hidden state with the float32 table, as
the LM example passes them, promotes to float32 in both: losses at
1e-5, ``dx`` (returned in bf16) within one bf16 rounding. The LM losses
(``chunked_lm_loss_fn``, dense and MoE) match the JAX ones on the same
converted weights at atol 1e-5 (loss) and 1e-4 (gradients), and the
dense head at atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptdl_tpu.models import TransformerConfig as JaxConfig
from adaptdl_tpu.models import init_transformer as jax_init
from adaptdl_tpu.ops.chunked_xent import chunked_lm_loss_fn as jax_chunked_lm_loss_fn
from adaptdl_tpu.ops.chunked_xent import chunked_softmax_xent as jax_xent
from adaptdl_tpu_torch.models import TransformerConfig, TransformerLM, lm_loss_fn
from adaptdl_tpu_torch.ops.chunked_xent import chunked_lm_loss_fn, chunked_softmax_xent
from adaptdl_tpu_torch.weights import flax_to_state_dict
from tests.torch_support import one_torch_thread, private_tempdir  # noqa: F401


T, D, V = 24, 16, 100


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.normal(size=(T, D)).astype(np.float32),
        rng.normal(size=(V, D)).astype(np.float32),
        rng.integers(0, V, T).astype(np.int32),
        rng.normal(size=T).astype(np.float32),
    )


@pytest.mark.parametrize("chunk", [16, 32, 48, 100, 4096])
def test_losses_and_gradients_match_jax(chunk):
    x, emb, targets, g = _inputs()

    def jloss(a, b):
        return jnp.sum(jax_xent(a, b, jnp.asarray(targets), chunk) * g)

    want = jax_xent(jnp.asarray(x), jnp.asarray(emb), jnp.asarray(targets), chunk)
    want_dx, want_de = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(emb))
    xt = torch.tensor(x, requires_grad=True)
    et = torch.tensor(emb, requires_grad=True)
    got = chunked_softmax_xent(xt, et, torch.tensor(targets), chunk)
    (got * torch.tensor(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), atol=1e-4)
    np.testing.assert_allclose(et.grad.numpy(), np.asarray(want_de), atol=1e-4)


def test_equals_the_dense_cross_entropy():
    x, emb, targets, _ = _inputs(seed=1)
    dense = torch.nn.functional.cross_entropy(
        torch.tensor(x) @ torch.tensor(emb).t(), torch.tensor(targets).long(),
        reduction="none",
    )
    got = chunked_softmax_xent(torch.tensor(x), torch.tensor(emb), torch.tensor(targets), 32)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=1e-5)


def test_bf16_hidden_with_f32_table_promotes_as_jax():
    x, emb, targets, g = _inputs(seed=2)
    xb = jnp.asarray(x, jnp.bfloat16)

    def jloss(a):
        return jnp.sum(jax_xent(a, jnp.asarray(emb), jnp.asarray(targets), 32) * g)

    want = jax_xent(xb, jnp.asarray(emb), jnp.asarray(targets), 32)
    want_dx = np.asarray(jax.grad(jloss)(xb).astype(jnp.float32))
    xt = torch.tensor(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16).requires_grad_()
    got = chunked_softmax_xent(xt, torch.tensor(emb), torch.tensor(targets), 32)
    (got * torch.tensor(g)).sum().backward()
    assert got.dtype == torch.float32 and xt.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    # Both round the same float32 gradient to bf16 (one ulp apart at most).
    np.testing.assert_allclose(
        xt.grad.float().numpy(), want_dx, rtol=2**-7, atol=1e-6
    )


SIZES = dict(vocab_size=100, num_layers=2, num_heads=2, d_model=32, d_ff=64)


@pytest.mark.parametrize("moe", [False, True])
def test_chunked_lm_loss_matches_jax(moe):
    extra = dict(moe_every_n=2, moe_num_experts=4, moe_top_k=2) if moe else {}
    jax_model, params = jax_init(
        JaxConfig(**SIZES, **extra, max_seq_len=16, dtype=jnp.float32, remat=False),
        seq_len=16,
    )
    model = TransformerLM(TransformerConfig(**SIZES, **extra, dtype=torch.float32))
    model.load_state_dict(flax_to_state_dict(jax.device_get(params)))
    tokens = np.random.default_rng(3).integers(0, 100, (2, 17), dtype=np.int32)
    jloss = jax_chunked_lm_loss_fn(jax_model, chunk_size=48)
    want, grads = jax.value_and_grad(jloss)(
        params, {"tokens": jnp.asarray(tokens)}, jax.random.key(0)
    )
    loss = chunked_lm_loss_fn(48)(model, {"tokens": torch.from_numpy(tokens)})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), atol=1e-5)
    want_grads = flax_to_state_dict(jax.device_get(grads))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(
            p.grad.numpy(), want_grads[name].numpy(), atol=1e-4, err_msg=name
        )
    with torch.no_grad():
        dense = lm_loss_fn(model, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(loss.item(), dense.item(), atol=1e-5)
