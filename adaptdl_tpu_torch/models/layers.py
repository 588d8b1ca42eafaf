"""Flax layers with flax's numerics, for the port's model zoo.

Each layer computes what its ``flax.linen`` namesake computes, so that
weights converted by :mod:`adaptdl_tpu_torch.weights` give the same
outputs:

- :class:`Conv2d` pads ``SAME`` the way flax does: ``total = max((out -
  1) * stride + kernel - size, 0)``, ``total // 2`` before and the rest
  after, which is asymmetric for a 3x3 stride-2 conv on an even size (0
  before, 1 after). Symmetric padding goes to the convolution; the
  rest is an explicit ``F.pad``.
- :class:`ConvTranspose2d` is flax's ``ConvTranspose`` with its default
  ``transpose_kernel=False``: the stride-dilated input, padded as
  ``lax.conv_transpose`` pads ``SAME``, correlated with the kernel as
  stored. ``F.conv_transpose2d`` correlates with the kernel flipped in
  space and with in and out swapped, so the converter flips it and the
  layer's padding is ``kernel - 1 - pad``.
- :class:`GroupNorm` takes its statistics in float32 whatever the
  compute dtype (``var = E[x^2] - E[x]^2``, clamped at 0; epsilon 1e-6,
  flax's default, not PyTorch's 1e-5) and casts the output to it.
- :class:`Dense` and the convolutions cast inputs and weights to the
  compute dtype, as flax promotes them to ``dtype``.

Images are NCHW inside the port's models; the models take the NHWC
batches the datasets hold and permute them once, into a contiguous NCHW
copy: PyTorch 2.13's CPU backward of a strided 1x1 convolution over a
channels-last input returns wrong weight gradients and corrupts the
heap (``tests/test_torch_models_zoo.py::test_strided_conv_backward_
on_the_layout_the_models_use``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

GN_EPS = 1e-6  # flax GroupNorm's default
# The truncated normal's standard deviation at unit scale, truncated at
# two standard deviations: lecun_normal divides by it (flax's default
# kernel initialiser).
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, fan_in: int, generator) -> None:
    """Flax's default kernel initialiser: a normal truncated at two
    standard deviations with variance ``1 / fan_in``."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std, generator=generator)


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """Flax's ``SAME`` padding (before, after) of one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Dense(nn.Linear):
    """``nn.Dense``: ``x @ kernel + bias`` in ``dtype``; the weight is
    stored ``[out, in]``."""

    def __init__(self, in_features, out_features, bias=True, dtype=torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.dtype = dtype

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)

    def reset_flax(self, generator) -> None:
        lecun_normal_(self.weight, self.in_features, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


class Conv2d(nn.Module):
    """``nn.Conv(features, (k, k), strides, padding="SAME")`` over NCHW;
    the weight is stored OIHW."""

    def __init__(self, in_channels, out_channels, kernel, stride=1,
                 bias=True, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel, kernel)
        )
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        self.kernel, self.stride, self.dtype = kernel, stride, dtype

    def forward(self, x):
        (top, bottom), (left, right) = (
            same_padding(size, self.kernel, self.stride) for size in x.shape[2:]
        )
        x = x.to(self.dtype)
        if top == bottom and left == right:
            padding = (top, left)
        else:
            x = F.pad(x, (left, right, top, bottom))
            padding = 0
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(
            x, self.weight.to(self.dtype), bias, self.stride, padding
        )

    def reset_flax(self, generator) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


class ConvTranspose2d(nn.Module):
    """``nn.ConvTranspose(features, (k, k), strides, padding="SAME")``
    (``transpose_kernel=False``) over NCHW; the weight is stored as
    ``F.conv_transpose2d`` takes it, ``[in, out, k, k]``, flipped from
    flax's kernel (see the module docstring)."""

    def __init__(self, in_channels, out_channels, kernel, stride,
                 dtype=torch.float32):
        super().__init__()
        # lax.conv_transpose's SAME padding of the dilated input.
        pad_len = kernel + stride - 2
        before = kernel - 1 if stride > kernel - 1 else -(-pad_len // 2)
        if before != pad_len - before:
            raise ValueError(
                f"asymmetric SAME padding (kernel {kernel}, stride {stride}) "
                "is not supported"
            )
        self.padding = kernel - 1 - before
        self.weight = nn.Parameter(
            torch.empty(in_channels, out_channels, kernel, kernel)
        )
        self.stride, self.dtype = stride, dtype

    def forward(self, x):
        return F.conv_transpose2d(
            x.to(self.dtype), self.weight.to(self.dtype),
            stride=self.stride, padding=self.padding,
        )

    def reset_flax(self, generator) -> None:
        # flax's fan-in of a (k, k, in, out) kernel: k * k * in.
        fan_in = self.weight.shape[0] * self.weight[0, 0].numel()
        lecun_normal_(self.weight, fan_in, generator)


class GroupNorm(nn.Module):
    """``nn.GroupNorm(num_groups)`` over NCHW in ``dtype``."""

    def __init__(self, num_groups: int, channels: int, dtype=torch.float32):
        super().__init__()
        self.num_groups, self.dtype = num_groups, dtype
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        groups = self.num_groups
        per_group = (1, groups, x.shape[1] // groups, 1)
        # [b, groups, channels per group, h * w]: statistics over the
        # last two axes, as flax reduces each group over (h, w, c).
        x32 = x.float().reshape(x.shape[0], *per_group[1:3], -1)
        mean = x32.mean(dim=(2, 3), keepdim=True)
        var = torch.clamp(
            x32.square().mean(dim=(2, 3), keepdim=True) - mean.square(),
            min=0.0,
        )
        mul = torch.rsqrt(var + GN_EPS) * self.scale.view(per_group)
        y = (x32 - mean) * mul + self.bias.view(per_group)
        return y.reshape(x.shape).to(self.dtype)

    def reset_flax(self, generator) -> None:
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)


def reset_flax(model: nn.Module, generator: torch.Generator) -> None:
    """Every layer of ``model`` at flax's default initialisation (in
    module order), embeddings ``N(0, 1 / features)``."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, nn.Embedding):
                module.weight.normal_(
                    0.0, module.embedding_dim**-0.5, generator=generator
                )
            elif hasattr(module, "reset_flax"):
                module.reset_flax(generator)


def nhwc_to_nchw(images: torch.Tensor) -> torch.Tensor:
    """The dataset's NHWC batch as the contiguous NCHW tensor the
    convolutions take."""
    return images.permute(0, 3, 1, 2).contiguous()
