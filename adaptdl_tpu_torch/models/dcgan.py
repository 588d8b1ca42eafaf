"""DCGAN generator and discriminator, the port of ``adaptdl_tpu.models.dcgan``.

The elastic recipe trains the discriminator under an
``ElasticTrainer(has_aux=True)`` (its gradient noise drives the adaptive
batch size), with the current generator reaching its loss as ``aux``,
and steps the generator beside it with :func:`make_generator_step`.

Layouts: the generator's dense output is read as NCHW ``[4F, 4, 4]``
and the discriminator flattens NCHW before its dense layer; flax does
both in NHWC, and the weight converter permutes the dense weights to
match. The transposed convolutions are flax's (``transpose_kernel=
False``), see :mod:`.layers`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from adaptdl_tpu_torch import collective
from adaptdl_tpu_torch.device import resolve_device
from adaptdl_tpu_torch.models.layers import (
    Conv2d,
    ConvTranspose2d,
    Dense,
    GroupNorm,
    nhwc_to_nchw,
    reset_flax,
)

GROUPS = 8


class Generator(nn.Module):
    def __init__(self, latent_dim: int = 64, base_features: int = 64,
                 channels: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        f = base_features
        self.base_features, self.dtype = f, dtype
        self.project = Dense(latent_dim, 4 * 4 * f * 4, dtype=dtype)
        self.norm0 = GroupNorm(GROUPS, f * 4, dtype)
        self.up1 = ConvTranspose2d(f * 4, f * 2, 4, 2, dtype)
        self.norm1 = GroupNorm(GROUPS, f * 2, dtype)
        self.up2 = ConvTranspose2d(f * 2, f, 4, 2, dtype)
        self.norm2 = GroupNorm(GROUPS, f, dtype)
        self.up3 = ConvTranspose2d(f, channels, 4, 2, dtype)

    def forward(self, z):
        """z: [b, latent] -> float32 images [b, 32, 32, c] (NHWC) in
        [-1, 1]."""
        x = self.project(z).reshape(z.shape[0], self.base_features * 4, 4, 4)
        x = F.relu(self.norm0(x))
        x = F.relu(self.norm1(self.up1(x)))  # 8x8
        x = F.relu(self.norm2(self.up2(x)))  # 16x16
        x = self.up3(x)  # 32x32
        return torch.tanh(x.float()).permute(0, 2, 3, 1)


class Discriminator(nn.Module):
    def __init__(self, base_features: int = 64, channels: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        f = base_features
        self.dtype = dtype
        self.conv1 = Conv2d(channels, f, 4, 2, bias=False, dtype=dtype)
        self.conv2 = Conv2d(f, f * 2, 4, 2, bias=False, dtype=dtype)
        self.norm2 = GroupNorm(GROUPS, f * 2, dtype)
        self.conv3 = Conv2d(f * 2, f * 4, 4, 2, bias=False, dtype=dtype)
        self.norm3 = GroupNorm(GROUPS, f * 4, dtype)
        self.out = Dense(f * 4 * 4 * 4, 1)

    def forward(self, images):
        """images: [b, 32, 32, c] (NHWC) -> float32 logits [b]."""
        x = nhwc_to_nchw(images.to(self.dtype))
        x = F.leaky_relu(self.conv1(x), 0.2)
        x = F.leaky_relu(self.norm2(self.conv2(x)), 0.2)
        x = F.leaky_relu(self.norm3(self.conv3(x)), 0.2)
        return self.out(x.reshape(x.shape[0], -1))[..., 0]


def init_dcgan(seed: int = 0, device="cuda", latent_dim: int = 64,
               base_features: int = 64, channels: int = 3):
    """(generator, discriminator) at flax's default initialisation on
    ``device``, each from its own CPU generator of ``seed``."""
    device = resolve_device(device)
    generator = Generator(latent_dim, base_features, channels)
    discriminator = Discriminator(base_features, channels)
    reset_flax(generator, torch.Generator().manual_seed(2 * seed))
    reset_flax(discriminator, torch.Generator().manual_seed(2 * seed + 1))
    return generator.to(device), discriminator.to(device)


def _bce(logits, target: float):
    return F.binary_cross_entropy_with_logits(
        logits, torch.full_like(logits, target)
    )


def discriminator_loss_fn(discriminator, batch, rng, generator) -> torch.Tensor:
    """The discriminator's loss under ``ElasticTrainer(has_aux=True)``:
    real images scored as 1, the current generator's fakes of
    ``batch["z"]`` as 0. The generator arrives as ``aux``; the fakes
    carry no graph back to it. Draws nothing from ``rng``."""
    with torch.no_grad():
        fakes = generator(batch["z"])
    real = discriminator(batch["image"])
    fake = discriminator(fakes)
    return _bce(real, 1.0) + _bce(fake, 0.0)


def make_generator_step(generator, discriminator, optimizer):
    """``step(z) -> loss``: one update of ``generator`` toward fakes the
    current ``discriminator`` scores as real, with ``optimizer`` over
    ``generator.parameters()``.

    With several replicas, each passes its own block of ``z``; the
    gradients and the loss are averaged over the process group in one
    all-reduce before the update, so every replica applies the same
    update and the generators stay equal. With one replica there is no
    collective."""
    params = list(generator.parameters())

    def step(z):
        logits = discriminator(generator(z))
        loss = _bce(logits, 1.0)
        grads = [g.float() for g in torch.autograd.grad(loss, params)]
        loss = loss.detach().float()
        if collective.world_size() > 1:
            collective.allreduce_mean(grads + [loss])
        for p, g in zip(params, grads):
            p.grad = g
        optimizer.step()
        for p in params:
            p.grad = None
        return loss

    return step
