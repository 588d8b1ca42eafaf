"""Neural collaborative filtering, the port of ``adaptdl_tpu.models.ncf``.

NeuMF: GMF (the elementwise product of user and item embeddings) fused
with an MLP tower over the concatenated MLP embeddings, one logit per
(user, item) pair scored against 0/1 implicit feedback. Batches are
``{"user": [b], "item": [b], "label": [b]}``; negatives are sampled in
the data pipeline.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from adaptdl_tpu_torch.device import resolve_device
from adaptdl_tpu_torch.models.layers import Dense, reset_flax


class NeuMF(nn.Module):
    def __init__(
        self,
        num_users: int,
        num_items: int,
        embed_dim: int = 32,
        mlp_dims: tuple = (64, 32, 16),
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.dtype = dtype
        self.gmf_user = nn.Embedding(num_users, embed_dim)
        self.gmf_item = nn.Embedding(num_items, embed_dim)
        self.mlp_user = nn.Embedding(num_users, embed_dim)
        self.mlp_item = nn.Embedding(num_items, embed_dim)
        tower, width = [], 2 * embed_dim
        for dim in mlp_dims:
            tower.append(Dense(width, dim, dtype=dtype))
            width = dim
        self.tower = nn.ModuleList(tower)
        self.out = Dense(embed_dim + width, 1)

    def forward(self, user, item):
        """user, item: [b] int -> float32 logits [b]."""
        user, item = user.long(), item.long()
        gmf = self.gmf_user(user) * self.gmf_item(item)
        x = torch.cat([self.mlp_user(user), self.mlp_item(item)], dim=-1)
        for layer in self.tower:
            x = F.relu(layer(x))
        fused = torch.cat([gmf.to(self.dtype), x.to(self.dtype)], dim=-1)
        return self.out(fused)[..., 0]


def init_ncf(num_users: int, num_items: int, seed: int = 0, device="cuda",
             **kwargs) -> NeuMF:
    device = resolve_device(device)
    model = NeuMF(num_users, num_items, **kwargs)
    reset_flax(model, torch.Generator().manual_seed(seed))
    return model.to(device)


def ncf_loss_fn(model: NeuMF, batch, generator=None) -> torch.Tensor:
    """Mean sigmoid binary cross-entropy of the pair logits; draws
    nothing from ``generator``."""
    logits = model(batch["user"], batch["item"])
    return F.binary_cross_entropy_with_logits(logits, batch["label"].float())
