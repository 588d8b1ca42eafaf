"""Ulysses sequence parallelism: the port of ``adaptdl_tpu.parallel.ulysses``.

Each rank of the ``"seq"`` axis holds one contiguous block of the
sequence with every head. Two all-to-all exchanges swap the sharded axis
from the sequence to the heads around an attention over the whole
sequence: ``[b, h, s/n, d] -> [b, h/n, s, d]``, attention, then the
inverse exchange. The inner attention is any ``fn(q, k, v, causal=...)``
over ``[b, heads, seq, d]``: the port's plain ``causal_attention`` by
default, or ``ops.flash_attention`` (the sm90 kernel on the card) on the
gathered sequence. Needs ``num_heads % seq_shards == 0``; ring attention
(:mod:`.ring_attention`) takes any head count.

Each exchange is an autograd function whose backward is the inverse
all-to-all of the cotangent. Every rank issues the same exchanges in
the same order, the recomputation of a rematerialised block included.
"""

from __future__ import annotations

from functools import partial

import torch

from adaptdl_tpu_torch import collective
from adaptdl_tpu_torch.parallel.mesh import SEQ_AXIS, axis_group, axis_size


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.split_dim, ctx.concat_dim = group, split_dim, concat_dim
        return collective.all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        return (
            collective.all_to_all(grad.contiguous(), ctx.group, ctx.concat_dim, ctx.split_dim),
            None, None, None,
        )


def all_to_all(x, group, split_dim: int, concat_dim: int):
    """Differentiable tiled all-to-all (:func:`collective.all_to_all`)."""
    return _AllToAll.apply(x, group, split_dim, concat_dim)


def ulysses_attention(
    q, k, v, axis_name: str = SEQ_AXIS, causal: bool = True,
    inner_attention=None,
):
    """Exact attention across a sequence-sharded axis via all-to-all.

    Args:
      q, k, v: local blocks ``[batch, heads, seq_local, head_dim]`` with
        every head (parameters are replicated over the seq axis).
      axis_name: the mesh axis the sequence is sharded over.
      causal: a causal mask in global positions.
      inner_attention: ``fn(q, k, v, causal=...)`` over the gathered
        blocks; default the plain ``causal_attention``.

    Returns ``[batch, heads, seq_local, head_dim]`` in q's dtype.
    """
    shards = axis_size(axis_name)
    heads = q.shape[1]
    if heads % shards != 0:
        raise ValueError(
            f"ulysses attention needs num_heads ({heads}) divisible "
            f"by seq shards ({shards}); use ring attention otherwise"
        )
    if inner_attention is None:
        from adaptdl_tpu_torch.models.transformer import causal_attention

        inner_attention = causal_attention
    group = axis_group(axis_name) if shards > 1 else None
    # One exchange for q, k and v: [3, b, h, s/n, d] -> [3, b, h/n, s, d].
    # Head chunk j of every rank's block lands on rank j; blocks
    # concatenate along the sequence in source-rank order, which is
    # global sequence order (rank i holds block i).
    qkv = all_to_all(torch.stack([q, k, v]), group, split_dim=2, concat_dim=3)
    q, k, v = qkv.unbind(0)
    out = inner_attention(q, k, v, causal=causal).to(qkv.dtype)
    # [b, h/n, s, d] -> [b, h, s/n, d]: the transpose exchange.
    return all_to_all(out.contiguous(), group, split_dim=2, concat_dim=1)


def make_ulysses_attention(
    axis_name: str = SEQ_AXIS, causal: bool = True, inner_attention=None,
):
    """Partial suitable for ``TransformerConfig.attention_fn``."""
    return partial(
        ulysses_attention, axis_name=axis_name, causal=causal,
        inner_attention=inner_attention,
    )
