"""The port's model zoo against the JAX package's, layer rules included.

Each model is initialised by flax, its parameters carried into the port
by ``adaptdl_tpu_torch.weights``, and both sides run on the same numpy
inputs (seeded) in float32: ResNet18 at width 8, SmallCNN, NeuMF, and the
DCGAN generator and discriminator at 8 features. Forward outputs agree
to ``rtol=1e-5, atol=1e-5``. Parameter gradients (of the model's loss,
or of a fixed random projection of the generator's images) agree to
``rtol=1e-4, atol=1e-5`` after the same conversion: the backward sums
over batch and space in another order on each side, and the ResNet's
GroupNorm backward subtracts nearly equal sums, which leaves float32
error near 1e-5 of each gradient's scale.

The layer rules the converters rely on are held on their own:
flax ``SAME`` padding of a stride-2 3x3 conv (0 before, 1 after on an
even size), ``ConvTranspose`` at three spatial sizes, GroupNorm's float32
statistics and epsilon, and the masked-LM loss on a mask both sides
share. Dropout is off on both sides (the JAX SmallCNN drops only when
given an rng), since the two random streams differ.
"""

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp
import optax

from adaptdl_tpu.models import cnn as jax_cnn
from adaptdl_tpu.models import dcgan as jax_dcgan
from adaptdl_tpu.models import ncf as jax_ncf
from adaptdl_tpu.models import resnet as jax_resnet
from adaptdl_tpu.models import transformer as jax_transformer
from adaptdl_tpu_torch import weights
from adaptdl_tpu_torch.models import cnn, dcgan, ncf, resnet, transformer
from adaptdl_tpu_torch.models.layers import (
    Conv2d,
    ConvTranspose2d,
    GroupNorm,
    nhwc_to_nchw,
)
from tests.torch_support import private_tempdir  # noqa: F401

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close_tree(got: dict, want: dict, **tol):
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        np.testing.assert_allclose(
            got[name].numpy(), value.numpy(), err_msg=name, **tol
        )


def _grads(model) -> dict:
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def _load(model, state):
    missing, unexpected = model.load_state_dict(state, strict=True)
    assert not missing and not unexpected
    return model


# -- models ----------------------------------------------------------------


def test_resnet18_forward_and_gradients_match_jax():
    jmodel, params = jax_resnet.init_resnet18(image_size=16, width=8)
    model = _load(resnet.ResNet18(width=8), weights.resnet18_state_dict(params))
    rng = _rng(1)
    images = rng.normal(size=(3, 16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, 10, size=3).astype(np.int32)

    def jax_loss(p):
        logits = jmodel.apply({"params": p}, images)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, labels
        ).mean(), logits

    (jloss, jlogits), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(params)
    batch = {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)}
    logits = model(batch["image"])
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), **FWD)
    loss = resnet.resnet_loss_fn(model, batch)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **FWD)
    loss.backward()
    _close_tree(_grads(model), weights.resnet18_state_dict(jgrads), **GRAD)


def test_small_cnn_forward_and_gradients_match_jax():
    jmodel, params = jax_cnn.init_cnn(image_size=12, channels=1)
    model = _load(cnn.SmallCNN(image_size=12), weights.cnn_state_dict(params))
    rng = _rng(2)
    images = rng.normal(size=(4, 12, 12, 1)).astype(np.float32)
    labels = rng.integers(0, 10, size=4).astype(np.int32)

    def jax_loss(p):
        logits = jmodel.apply({"params": p}, images, train=True, rng=None)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, labels
        ).mean(), logits

    (jloss, jlogits), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(params)
    logits = model(torch.from_numpy(images))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), **FWD)
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(labels).long())
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **FWD)
    loss.backward()
    _close_tree(_grads(model), weights.cnn_state_dict(jgrads), **GRAD)


def test_small_cnn_dropout_draws_from_the_generator():
    model = cnn.init_cnn(device="cpu", image_size=8)
    images = torch.from_numpy(_rng(3).normal(size=(2, 8, 8, 1)).astype(np.float32))
    a = model(images, torch.Generator().manual_seed(5))
    b = model(images, torch.Generator().manual_seed(5))
    c = model(images, torch.Generator().manual_seed(6))
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert not torch.equal(a, model(images))


def test_neumf_forward_and_gradients_match_jax():
    jmodel, params = jax_ncf.init_ncf(20, 30, embed_dim=8, mlp_dims=(16, 8))
    model = _load(
        ncf.NeuMF(20, 30, embed_dim=8, mlp_dims=(16, 8)),
        weights.ncf_state_dict(params),
    )
    rng = _rng(4)
    batch = {
        "user": rng.integers(0, 20, size=16).astype(np.int32),
        "item": rng.integers(0, 30, size=16).astype(np.int32),
        "label": rng.integers(0, 2, size=16).astype(np.float32),
    }
    jloss, jgrads = jax.value_and_grad(jax_ncf.ncf_loss_fn(jmodel))(
        params, batch, None
    )
    jlogits = jmodel.apply({"params": params}, batch["user"], batch["item"])
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits = model(tbatch["user"], tbatch["item"])
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), **FWD)
    loss = ncf.ncf_loss_fn(model, tbatch)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **FWD)
    loss.backward()
    _close_tree(_grads(model), weights.ncf_state_dict(jgrads), **GRAD)


def _dcgan_pair(channels=3):
    gen, g_params, disc, d_params = jax_dcgan.init_dcgan(
        latent_dim=8, base_features=8, channels=channels
    )
    g = _load(
        dcgan.Generator(8, 8, channels), weights.generator_state_dict(g_params)
    )
    d = _load(
        dcgan.Discriminator(8, channels),
        weights.discriminator_state_dict(d_params),
    )
    return gen, g_params, disc, d_params, g, d


def test_generator_forward_and_gradients_match_jax():
    gen, g_params, _, _, g, _ = _dcgan_pair()
    rng = _rng(5)
    z = rng.normal(size=(3, 8)).astype(np.float32)
    probe = rng.normal(size=(3, 32, 32, 3)).astype(np.float32)

    def jax_loss(p):
        out = gen.apply({"params": p}, z)
        return jnp.sum(out * probe), out

    (jloss, jout), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(g_params)
    out = g(torch.from_numpy(z))
    assert out.shape == (3, 32, 32, 3)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **FWD)
    (out * torch.from_numpy(probe)).sum().backward()
    _close_tree(_grads(g), weights.generator_state_dict(jgrads), **GRAD)


def test_discriminator_forward_and_gradients_match_jax():
    _, _, disc, d_params, _, d = _dcgan_pair()
    images = np.tanh(_rng(6).normal(size=(4, 32, 32, 3))).astype(np.float32)

    def jax_loss(p):
        logits = disc.apply({"params": p}, images)
        return optax.sigmoid_binary_cross_entropy(
            logits, jnp.ones_like(logits)
        ).mean(), logits

    (jloss, jlogits), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(d_params)
    logits = d(torch.from_numpy(images))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), **FWD)
    loss = torch.nn.functional.binary_cross_entropy_with_logits(
        logits, torch.ones_like(logits)
    )
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **FWD)
    loss.backward()
    _close_tree(_grads(d), weights.discriminator_state_dict(jgrads), **GRAD)


def test_discriminator_loss_matches_jax():
    gen, g_params, disc, d_params, g, d = _dcgan_pair(channels=1)
    rng = _rng(7)
    batch = {
        "image": rng.normal(size=(4, 32, 32, 1)).astype(np.float32),
        "z": rng.normal(size=(4, 8)).astype(np.float32),
    }
    jloss = jax_dcgan.discriminator_loss_fn(disc, gen)(
        d_params, batch, None, g_params
    )
    loss = dcgan.discriminator_loss_fn(
        d, {k: torch.from_numpy(v) for k, v in batch.items()}, None, g
    )
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **FWD)


# -- layer rules -------------------------------------------------------------


def test_strided_conv_backward_on_the_layout_the_models_use():
    """The weight gradient of a 1x1 stride-2 conv (the ResNet's
    projection) equals its definition on the NCHW input the models
    make; PyTorch 2.13's CPU kernel gets it wrong on a channels-last
    input, which is why nhwc_to_nchw copies."""
    rng = _rng(13)
    images = torch.from_numpy(rng.normal(size=(3, 16, 16, 8)).astype(np.float32))
    x = nhwc_to_nchw(images).requires_grad_()
    layer = Conv2d(8, 16, 1, 2, bias=False)
    layer.weight.data = torch.from_numpy(
        rng.normal(size=(16, 8, 1, 1)).astype(np.float32)
    )
    y = layer(x)
    go = torch.from_numpy(rng.normal(size=tuple(y.shape)).astype(np.float32))
    gx, gw = torch.autograd.grad(y, (x, layer.weight), go)
    want = torch.einsum("bohw,bihw->oi", go, x.detach()[:, :, ::2, ::2])
    np.testing.assert_allclose(gw.reshape(16, 8).numpy(), want.numpy(), **FWD)


@pytest.mark.parametrize(
    "size, kernel, stride, padding",
    [(8, 3, 2, (0, 1)), (7, 3, 2, (1, 1)), (8, 1, 2, (0, 0)), (8, 4, 2, (1, 1)),
     (6, 3, 1, (1, 1))],
)
def test_conv_same_padding_matches_flax(size, kernel, stride, padding):
    from adaptdl_tpu_torch.models.layers import same_padding

    assert same_padding(size, kernel, stride) == padding
    rng = _rng(8)
    x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    layer = fnn.Conv(5, (kernel, kernel), (stride, stride), padding="SAME")
    params = layer.init(jax.random.key(0), x)["params"]
    want = np.asarray(layer.apply({"params": params}, x))
    port = _load(
        Conv2d(3, 5, kernel, stride),
        {k[2:]: v for k, v in weights.conv(params, "x").items()},
    )
    got = port(nhwc_to_nchw(torch.from_numpy(x))).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, **FWD)


@pytest.mark.parametrize("size", [4, 5, 8])
def test_conv_transpose_matches_flax(size):
    rng = _rng(9)
    x = rng.normal(size=(2, size, size, 6)).astype(np.float32)
    layer = fnn.ConvTranspose(4, (4, 4), strides=(2, 2), use_bias=False)
    params = layer.init(jax.random.key(1), x)["params"]
    want = np.asarray(layer.apply({"params": params}, x))
    port = _load(
        ConvTranspose2d(6, 4, 4, 2),
        {k[2:]: v for k, v in weights.conv_transpose(params, "x").items()},
    )
    got = port(nhwc_to_nchw(torch.from_numpy(x))).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (2, 2 * size, 2 * size, 4)
    np.testing.assert_allclose(got.detach().numpy(), want, **FWD)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_group_norm_matches_flax(dtype):
    rng = _rng(10)
    # A variance of 1e-4, where epsilon 1e-6 (flax) and 1e-5 (PyTorch's
    # default) move the output by about 5%.
    x = (1e-2 * rng.normal(size=(2, 5, 5, 16))).astype(np.float32)
    layer = fnn.GroupNorm(num_groups=8, dtype=dtype)
    params = {
        "scale": rng.normal(size=16).astype(np.float32),
        "bias": rng.normal(size=16).astype(np.float32),
    }
    want = np.asarray(
        layer.apply({"params": params}, jnp.asarray(x, dtype)).astype(jnp.float32)
    )
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    port = _load(
        GroupNorm(8, 16, tdtype),
        {k[2:]: v for k, v in weights.group_norm(params, "x").items()},
    )
    got = port(nhwc_to_nchw(torch.from_numpy(x).to(tdtype))).permute(0, 2, 3, 1)
    assert got.dtype == tdtype
    # bf16: both sides round the same float32 value once (1 ulp).
    tol = FWD if dtype == jnp.float32 else dict(rtol=2**-7, atol=0)
    np.testing.assert_allclose(got.float().detach().numpy(), want, **tol)


def test_mlm_loss_matches_jax_on_a_shared_mask():
    sizes = dict(vocab_size=32, num_layers=2, num_heads=2, d_model=16, d_ff=32)
    jmodel, params = jax_transformer.init_transformer(
        jax_transformer.TransformerConfig(
            **sizes, max_seq_len=12, dtype=jnp.float32, causal=False
        ),
        seq_len=12,
    )
    model = _load(
        transformer.TransformerLM(transformer.TransformerConfig(
            **sizes, dtype=torch.float32, causal=False
        )),
        weights.flax_to_state_dict(jax.device_get(params)),
    )
    rng = _rng(11)
    tokens = rng.integers(0, 31, size=(3, 12)).astype(np.int32)
    mask = rng.random(size=tokens.shape) < 0.3
    mask_token = 31
    # The JAX loss with its mask replaced by the shared one.
    inputs = jnp.where(mask, mask_token, tokens)
    logits = jmodel.apply({"params": params}, inputs, train=False)
    losses = optax.softmax_cross_entropy_with_integer_labels(logits, tokens)
    w = mask.astype(np.float32)
    want = float(jnp.sum(losses * w) / max(w.sum(), 1.0))
    got = transformer.masked_lm_loss(
        model, torch.from_numpy(tokens), torch.from_numpy(mask), mask_token
    )
    np.testing.assert_allclose(float(got.detach()), want, **FWD)
    # Bidirectional: the first position sees the last one.
    changed = tokens.copy()
    changed[:, -1] = (changed[:, -1] + 1) % 31
    first = model(torch.from_numpy(tokens))[:, 0]
    assert not torch.allclose(first, model(torch.from_numpy(changed))[:, 0])


def test_mlm_loss_fn_masks_from_the_generator():
    model = transformer.init_transformer(
        transformer.TransformerConfig(
            vocab_size=32, num_layers=1, num_heads=2, d_model=16, d_ff=32,
            dtype=torch.float32, causal=False,
        ),
        device="cpu",
    )
    loss_fn = transformer.mlm_loss_fn(mask_token=31)
    batch = {"tokens": torch.from_numpy(_rng(12).integers(0, 31, size=(2, 16)))}
    a = loss_fn(model, batch, torch.Generator().manual_seed(1))
    b = loss_fn(model, batch, torch.Generator().manual_seed(1))
    c = loss_fn(model, batch, torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.isfinite(a)
