"""ResNet-18 for CIFAR-class inputs, the port of ``adaptdl_tpu.models.resnet``.

GroupNorm(8) in place of BatchNorm (no running statistics to keep in
step across replicas or to tie to the atomic batch size), compute in
``dtype`` (bf16 on the card) with float32 parameters and a float32
head. Flax ``SAME`` padding, asymmetric for the stride-2 3x3 convs, and
flax's GroupNorm numerics come from :mod:`.layers`. The model takes the
NHWC images the dataset holds.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from adaptdl_tpu_torch.device import resolve_device
from adaptdl_tpu_torch.models.layers import (
    Conv2d,
    Dense,
    GroupNorm,
    nhwc_to_nchw,
    reset_flax,
)

GROUPS = 8


class ResidualBlock(nn.Module):
    def __init__(self, in_features, features, stride, dtype):
        super().__init__()
        self.conv1 = Conv2d(in_features, features, 3, stride, bias=False, dtype=dtype)
        self.norm1 = GroupNorm(GROUPS, features, dtype)
        self.conv2 = Conv2d(features, features, 3, bias=False, dtype=dtype)
        self.norm2 = GroupNorm(GROUPS, features, dtype)
        # A projection where the residual's shape changes.
        self.proj = self.proj_norm = None
        if stride != 1 or in_features != features:
            self.proj = Conv2d(in_features, features, 1, stride, bias=False, dtype=dtype)
            self.proj_norm = GroupNorm(GROUPS, features, dtype)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = self.norm2(self.conv2(y))
        residual = x if self.proj is None else self.proj_norm(self.proj(x))
        return F.relu(y + residual)


class ResNet18(nn.Module):
    def __init__(
        self,
        num_classes: int = 10,
        stage_sizes: Sequence[int] = (2, 2, 2, 2),
        width: int = 64,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.dtype = dtype
        self.stem = Conv2d(3, width, 3, bias=False, dtype=dtype)
        self.stem_norm = GroupNorm(GROUPS, width, dtype)
        blocks, in_features = [], width
        for stage, num_blocks in enumerate(stage_sizes):
            features = width * 2**stage
            for block in range(num_blocks):
                stride = 2 if stage > 0 and block == 0 else 1
                blocks.append(ResidualBlock(in_features, features, stride, dtype))
                in_features = features
        self.blocks = nn.ModuleList(blocks)
        self.head = Dense(in_features, num_classes)

    def forward(self, images):
        """images: [b, h, w, 3] (NHWC) -> float32 logits [b, classes]."""
        x = nhwc_to_nchw(images.to(self.dtype))
        x = F.relu(self.stem_norm(self.stem(x)))
        for block in self.blocks:
            x = block(x)
        return self.head(x.mean(dim=(2, 3)))


def init_resnet18(seed: int = 0, device="cuda", **kwargs) -> ResNet18:
    """A ResNet18 at flax's default initialisation on ``device``, drawn
    from a CPU generator seeded with ``seed``."""
    device = resolve_device(device)
    model = ResNet18(**kwargs)
    reset_flax(model, torch.Generator().manual_seed(seed))
    return model.to(device)


def resnet_loss_fn(model: ResNet18, batch, generator=None) -> torch.Tensor:
    """Mean softmax cross-entropy (float32) of ``model(batch["image"])``
    against ``batch["label"]``; draws nothing from ``generator``."""
    logits = model(batch["image"])
    return F.cross_entropy(logits.float(), batch["label"].long())
