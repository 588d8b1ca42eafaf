"""Small CNN for MNIST-class tasks, the port of ``adaptdl_tpu.models.cnn``.

Two 3x3 convs, a 2x2 max pool, dropout 0.25, and two dense layers. The
dropout mask is drawn from the microbatch's generator (the JAX model
drops only when it is given an rng, and so does this one). The first
dense layer reads the pooled features flattened in NCHW order; the
weight converter permutes flax's NHWC-ordered rows to match.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from adaptdl_tpu_torch.device import resolve_device
from adaptdl_tpu_torch.models.layers import Conv2d, Dense, nhwc_to_nchw, reset_flax

DROPOUT = 0.25


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator):
    """Flax's ``Dropout``: keep each element with probability ``1 -
    rate`` (a uniform draw from ``generator`` below it), scaled by its
    inverse; zero the rest."""
    keep_prob = 1.0 - rate
    draws = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(draws < keep_prob, x / keep_prob, torch.zeros_like(x))


class SmallCNN(nn.Module):
    def __init__(
        self,
        num_classes: int = 10,
        image_size: int = 28,
        channels: int = 1,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv2d(channels, 32, 3, dtype=dtype)
        self.conv2 = Conv2d(32, 64, 3, dtype=dtype)
        pooled = image_size // 2
        self.fc1 = Dense(64 * pooled * pooled, 128, dtype=dtype)
        self.fc2 = Dense(128, num_classes)

    def forward(self, images, generator: torch.Generator | None = None):
        """images: [b, h, w, c] (NHWC) -> float32 logits; dropout only
        when ``generator`` is given."""
        x = nhwc_to_nchw(images.to(self.dtype))
        x = F.relu(self.conv2(F.relu(self.conv1(x))))
        x = F.max_pool2d(x, 2, 2)
        if generator is not None:
            x = dropout(x, DROPOUT, generator)
        x = F.relu(self.fc1(x.reshape(x.shape[0], -1)))
        return self.fc2(x)


def init_cnn(seed: int = 0, device="cuda", **kwargs) -> SmallCNN:
    device = resolve_device(device)
    model = SmallCNN(**kwargs)
    reset_flax(model, torch.Generator().manual_seed(seed))
    return model.to(device)


def cnn_loss_fn(model: SmallCNN, batch, generator) -> torch.Tensor:
    """Mean cross-entropy with dropout drawn from ``generator``."""
    logits = model(batch["image"], generator)
    return F.cross_entropy(logits.float(), batch["label"].long())

