"""The port's transformer LM against the JAX package's.

Weights come from the JAX model's initialisation and cross over with
``adaptdl_tpu_torch.weights``; both models then see the same tokens
(2 layers, 2 heads, d_model 32, seq 32, float32). Logits and loss
gradients agree to float32 accumulation order (atol 2e-5, rtol 1e-4),
with plain attention and with flash attention as ``attention_fn`` (the
JAX kernel in interpret mode, the port's plain version on the CPU).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from adaptdl_tpu.models import TransformerConfig as JaxConfig
from adaptdl_tpu.models import init_transformer as jax_init
from adaptdl_tpu.ops import make_flash_attention as jax_make_flash
from adaptdl_tpu_torch.models import TransformerConfig, TransformerLM, lm_loss_fn
from adaptdl_tpu_torch.ops import make_flash_attention
from adaptdl_tpu_torch.weights import flax_to_state_dict
from tests.torch_support import private_tempdir  # noqa: F401

SIZES = dict(vocab_size=64, num_layers=2, num_heads=2, d_model=32, d_ff=64)


def _tokens(seed=0):
    return np.random.default_rng(seed).integers(0, 64, (4, 33), dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _jax_model(flash: bool):
    return jax_init(
        JaxConfig(
            **SIZES, max_seq_len=32, dtype=jnp.float32, remat=False,
            attention_fn=jax_make_flash(block_q=16, block_k=16) if flash else None,
        ),
        seq_len=32,
    )


def _models(flash: bool, remat: bool = False):
    """The JAX model (no remat: it changes no value) and the port's,
    with the JAX weights."""
    jax_model, params = _jax_model(flash)
    model = TransformerLM(
        TransformerConfig(
            **SIZES, dtype=torch.float32, remat=remat,
            attention_fn=make_flash_attention(block_q=16, block_k=16) if flash else None,
        )
    )
    model.load_state_dict(flax_to_state_dict(jax.device_get(params)))
    return jax_model, params, model


@pytest.mark.parametrize("flash", [False, True])
def test_logits_match_jax(flash):
    jax_model, params, model = _models(flash)
    inputs = _tokens()[:, :-1]
    want = jax.jit(
        lambda p, x: jax_model.apply({"params": p}, x, train=False)
    )(params, jnp.asarray(inputs))
    with torch.no_grad():
        got = model(torch.from_numpy(inputs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("flash", [False, True])
def test_loss_gradients_match_jax(flash):
    jax_model, params, model = _models(flash, remat=True)
    tokens = _tokens(seed=1)

    def jax_loss(p):
        logits = jax_model.apply({"params": p}, jnp.asarray(tokens[:, :-1]), train=False)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(tokens[:, 1:])
        ).mean()

    want_loss, want_grads = jax.jit(jax.value_and_grad(jax_loss))(params)
    loss = lm_loss_fn(model, {"tokens": torch.from_numpy(tokens)})
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want = flax_to_state_dict(jax.device_get(want_grads))
    assert sorted(want) == sorted(names)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(
            g.numpy(), want[name].numpy(), atol=2e-5, rtol=1e-4, err_msg=name
        )


def test_remat_matches_no_remat():
    _, _, plain = _models(flash=True, remat=False)
    _, _, remat = _models(flash=True, remat=True)
    batch = {"tokens": torch.from_numpy(_tokens(seed=2))}
    results = []
    for model in (plain, remat):
        loss = lm_loss_fn(model, batch)
        results.append((loss, torch.autograd.grad(loss, list(model.parameters()))))
    (l0, g0), (l1, g1) = results
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)


def test_state_dict_covers_every_flax_leaf():
    _, params, model = _models(flash=False)
    converted = flax_to_state_dict(jax.device_get(params))
    assert sorted(converted) == sorted(model.state_dict())
    assert sum(v.numel() for v in converted.values()) == sum(
        np.size(x) for x in jax.tree.leaves(params)
    )


def test_moe_config_is_rejected():
    # As the JAX model, the port refuses expert-choice routing on a causal
    # model; token-choice MoE configs are accepted.
    with pytest.raises(ValueError, match="not causally valid"):
        TransformerConfig(moe_every_n=2, moe_num_experts=4, moe_router="experts")
    assert TransformerConfig(moe_every_n=2, moe_num_experts=4).use_moe
