"""Ring attention: the port of ``adaptdl_tpu.parallel.ring_attention``.

Exact attention over a sequence-sharded ``"seq"`` axis. Each rank holds
one block of Q/K/V; the K/V blocks rotate around the ring (each rank
sends to the next and receives from the one before) while an f32
online-softmax accumulator folds in one block per step, with the causal
mask in *global* positions. Memory per rank is O(seq / ranks). The
blocked softmax is plain JAX in the reference and plain PyTorch here.

The rotation is an autograd function whose backward sends the
cotangent the other way round the ring; autograd runs through the loop.
"""

from __future__ import annotations

from functools import partial

import torch

from adaptdl_tpu_torch import collective
from adaptdl_tpu_torch.parallel.mesh import SEQ_AXIS, axis_group, axis_index, axis_size

NEG_INF = -1e30


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return collective.ppermute(x, group, shift=1)

    @staticmethod
    def backward(ctx, grad):
        return collective.ppermute(grad, ctx.group, shift=-1), None


def ppermute(x, group):
    """Differentiable ring shift by one (:func:`collective.ppermute`)."""
    return _PPermute.apply(x, group)


def ring_attention(q, k, v, axis_name: str = SEQ_AXIS, causal: bool = True):
    """Exact (causal) attention across a sequence-sharded axis.

    Args:
      q, k, v: local blocks ``[batch, heads, seq_local, head_dim]``.
      axis_name: the mesh axis the sequence is sharded over.
      causal: a causal mask in global positions.

    Returns ``[batch, heads, seq_local, head_dim]`` in q's dtype.
    """
    ring_size = axis_size(axis_name)
    my_block = axis_index(axis_name)
    group = axis_group(axis_name) if ring_size > 1 else None
    seq_local = q.shape[2]
    scale = q.shape[-1] ** -0.5
    q32 = q.float() * scale
    arange = torch.arange(seq_local, device=q.device)
    q_pos = my_block * seq_local + arange
    out = torch.zeros_like(q32)
    row_max = torch.full(q32.shape[:-1], NEG_INF, device=q.device)
    row_sum = torch.zeros(q32.shape[:-1], device=q.device)
    kv = torch.stack([k, v])
    for step in range(ring_size):
        k_blk, v_blk = kv.unbind(0)
        src_block = (my_block - step) % ring_size
        logits = torch.einsum("bhqd,bhkd->bhqk", q32, k_blk.float())
        if causal:
            k_pos = src_block * seq_local + arange
            visible = q_pos[:, None] >= k_pos[None, :]
            logits = torch.where(visible, logits, NEG_INF)
        new_max = torch.maximum(row_max, logits.amax(dim=-1))
        probs = torch.exp(logits - new_max[..., None])
        rescale = torch.exp(row_max - new_max)
        row_sum = row_sum * rescale + probs.sum(dim=-1)
        out = out * rescale[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", probs, v_blk.float()
        )
        row_max = new_max
        if step < ring_size - 1:
            # Pass our current K/V block on; after r hops rank i holds
            # block (i - r) mod ring_size. The last hop would bring each
            # rank its own block back, so it is not made.
            kv = ppermute(kv, group)
    # Every causal query row sees its own diagonal block, so row_sum > 0;
    # the guard covers degenerate non-causal edge cases.
    out = out / torch.clamp(row_sum[..., None], min=1e-30)
    return out.to(q.dtype)


def make_ring_attention(axis_name: str = SEQ_AXIS, causal: bool = True):
    """Partial suitable for ``TransformerConfig.attention_fn``."""
    return partial(ring_attention, axis_name=axis_name, causal=causal)
