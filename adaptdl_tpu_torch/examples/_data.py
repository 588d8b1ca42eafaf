"""Synthetic datasets of the examples: learnable stand-ins for CIFAR,
MovieLens and token corpora, of the same shapes, made from a seed.

The port's copies of ``examples/_data.py``'s generators and of the NCF
example's (``examples/ncf.py``): numpy only, and the same arrays from
the same seeds as the JAX package's examples draw.
"""

from __future__ import annotations

import numpy as np


def synthetic_images(
    n: int, image_size: int, channels: int, num_classes: int, seed: int = 0
):
    """Class-template images + noise, NHWC float32, int32 labels."""
    rng = np.random.default_rng(seed)
    templates = rng.normal(
        size=(num_classes, image_size, image_size, channels)
    ).astype(np.float32)
    labels = rng.integers(0, num_classes, size=n)
    images = 0.8 * templates[labels] + 0.6 * rng.normal(
        size=(n, image_size, image_size, channels)
    ).astype(np.float32)
    return {"image": images, "label": labels.astype(np.int32)}


def synthetic_tokens(n: int, seq_len: int, vocab: int, seed: int = 0):
    """Deterministic arithmetic sequences: a fully learnable LM task."""
    rng = np.random.default_rng(seed)
    start = rng.integers(0, vocab, size=(n, 1))
    stride = rng.integers(1, 4, size=(n, 1))
    seqs = (start + stride * np.arange(seq_len + 1)[None, :]) % vocab
    return {"tokens": seqs.astype(np.int32)}


def synthetic_interactions(
    num_users: int, num_items: int, per_user: int, seed: int = 0
):
    """Implicit feedback from latent factors: each user's positives are
    their top-scoring items under a low-rank model, split leave-one-out
    for the ranked evaluation. Returns (train positives [users,
    per_user], held-out positive [users])."""
    rng = np.random.default_rng(seed)
    u_f = rng.normal(size=(num_users, 8))
    i_f = rng.normal(size=(num_items, 8))
    scores = u_f @ i_f.T + 0.3 * rng.normal(size=(num_users, num_items))
    top = np.argsort(-scores, axis=1)[:, : per_user + 1]
    return top[:, 1:], top[:, 0]


def make_training_pairs(train_pos, num_items, num_negatives: int, seed: int):
    """(user, item, label) arrays: every positive plus ``num_negatives``
    sampled negatives each, shuffled. The seed is derived from the epoch
    so that negatives are resampled every epoch, the same way on a
    replay after a restart."""
    rng = np.random.default_rng(seed)
    num_users, per_user = train_pos.shape
    users = np.repeat(
        np.arange(num_users, dtype=np.int32), per_user * (1 + num_negatives)
    )
    pos_mask = np.zeros((num_users, per_user * (1 + num_negatives)), bool)
    pos_mask[:, :per_user] = True
    items = np.concatenate(
        [
            train_pos.astype(np.int32),
            rng.integers(
                0, num_items, size=(num_users, per_user * num_negatives),
                dtype=np.int32,
            ),
        ],
        axis=1,
    )
    labels = pos_mask.astype(np.float32)
    order = rng.permutation(users.size)
    return {
        "user": users[order],
        "item": items.reshape(-1)[order],
        "label": labels.reshape(-1)[order],
    }


def stride_walks(n: int, seq_len: int, vocab: int, seed: int = 0):
    """BERT MLM data: ``token[i] = (base + i * stride) % (vocab - 1)``,
    leaving the last id free for the mask token, so that a masked token
    follows from its bidirectional context."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, vocab - 1, size=(n, 1))
    stride = rng.integers(1, 4, size=(n, 1))
    tokens = (base + stride * np.arange(seq_len)) % (vocab - 1)
    return {"tokens": tokens.astype(np.int32)}
