"""Chunked softmax cross-entropy: the LM loss without the logits tensor,
the port of ``adaptdl_tpu.ops.chunked_xent``.

A tied-embedding LM's head computes ``logits = x @ E^T`` over ``x:
[tokens, d]`` and ``E: [vocab, d]``; the ``[tokens, vocab]`` float32
logits are the step's largest buffer (32 x 512 tokens x 32000 in f32 =
2.1 GB). :class:`ChunkedSoftmaxXent` streams the vocab axis in chunks
through an online log-sum-exp, so one ``[tokens, chunk]`` block is live
at a time; its backward recomputes each chunk's probabilities from the
saved per-row log-sum-exp and accumulates ``dx`` and ``dE`` chunkwise.
The price is a second pass of the head's products.

Numerics as the reference's: every product accumulates in float32 and
the softmax arithmetic runs on the float32 products. ``x @ E_c^T`` is a
plain ``torch.matmul`` of the operands in float32 (a product of two
bf16 values is exact in float32, so this is the reference's bf16 x bf16
with f32 accumulation); with a bf16 hidden and the float32 table, as the
LM example passes them, the reference promotes to float32 too. TF32 is
whatever ``torch.backends.cuda.matmul.allow_tf32`` says (off by default).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _chunks(embedding: torch.Tensor, chunk_size: int) -> list[torch.Tensor]:
    """The table's rows in chunks of ``min(chunk_size, vocab)``, the
    last zero-padded to full size."""
    vocab, d = embedding.shape
    chunk_size = min(chunk_size, vocab)
    pad = (-vocab) % chunk_size
    if pad:
        embedding = torch.cat([embedding, embedding.new_zeros(pad, d)])
    return list(embedding.split(chunk_size))


def _chunk_logits(x32, e_chunk, start, vocab):
    """``[tokens, chunk]`` float32 logits, padded columns at -1e30."""
    logits = x32 @ e_chunk.float().t()
    if start + e_chunk.shape[0] > vocab:
        cols = start + torch.arange(e_chunk.shape[0], device=x32.device)
        logits = torch.where(cols[None, :] < vocab, logits, NEG_INF)
    return logits


def _forward(x, embedding, targets, chunk_size):
    """``(losses [tokens] f32, lse [tokens] f32)``."""
    vocab = embedding.shape[0]
    x32 = x.float()
    m = x32.new_full((x.shape[0],), NEG_INF)
    s = x32.new_zeros(x.shape[0])
    start = 0
    for e_chunk in _chunks(embedding, chunk_size):
        logits = _chunk_logits(x32, e_chunk, start, vocab)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=-1)
        m = m_new
        start += e_chunk.shape[0]
    lse = m + torch.log(torch.clamp(s, min=1e-30))
    target_logit = (x32 * embedding[targets.long()].float()).sum(dim=-1)
    return lse - target_logit, lse


class ChunkedSoftmaxXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, embedding, targets, chunk_size):
        losses, lse = _forward(x, embedding, targets, chunk_size)
        ctx.save_for_backward(x, embedding, targets, lse)
        ctx.chunk_size = chunk_size
        return losses

    @staticmethod
    def backward(ctx, g):
        """dL/dx = diag(g) (P E - E[targets]); dL/dE = P^T diag(g) x
        minus g x scattered onto the target rows; P chunk by chunk from
        the saved log-sum-exp."""
        x, embedding, targets, lse = ctx.saved_tensors
        vocab, d = embedding.shape
        x32 = x.float()
        g32 = g.float()
        dx = torch.zeros_like(x32)
        de_chunks = []
        start = 0
        for e_chunk in _chunks(embedding, ctx.chunk_size):
            logits = _chunk_logits(x32, e_chunk, start, vocab)
            gp = g32[:, None] * torch.exp(logits - lse[:, None])
            dx += gp @ e_chunk.float()
            de_chunks.append(gp.t() @ x32)
            start += e_chunk.shape[0]
        de = torch.cat(de_chunks)[:vocab]
        # The -1 of (p - onehot) on the target columns.
        dx -= g32[:, None] * embedding[targets.long()].float()
        de = de.index_add(0, targets.long(), -g32[:, None] * x32)
        return dx.to(x.dtype), de.to(embedding.dtype), None, None


def chunked_softmax_xent(x, embedding, targets, chunk_size: int = 4096):
    """Per-token cross-entropy of ``softmax(x @ embedding^T)``.

    Args:
      x: ``[tokens, d]`` final hidden states (any float dtype).
      embedding: ``[vocab, d]`` tied output embedding table.
      targets: ``[tokens]`` integer target ids.
      chunk_size: vocab rows per streamed chunk (the live-memory knob).

    Returns ``[tokens]`` float32 losses, ``logsumexp(x E^T) - (x
    E^T)[target]``.
    """
    return ChunkedSoftmaxXent.apply(x, embedding, targets, chunk_size)


def _chunked_lm_loss(model, inputs, targets, chunk_size):
    """The mean chunked cross-entropy of the model's final hidden states
    of ``inputs`` against ``targets`` (the tied table ``model.embed``),
    plus the weighted MoE aux loss."""
    from adaptdl_tpu_torch.models.transformer import apply_with_moe_aux

    hidden, aux = apply_with_moe_aux(model, inputs, return_hidden=True)
    losses = chunked_softmax_xent(
        hidden.reshape(-1, hidden.shape[-1]),
        model.embed.weight,
        targets.reshape(-1),
        chunk_size,
    )
    return losses.mean() + aux


def chunked_lm_loss_fn(chunk_size: int = 4096):
    """Next-token LM loss streaming the vocab axis, a drop-in for
    ``models.lm_loss_fn``: the model returns its final hidden states
    (no logits tensor anywhere in the step) and the loss reads the tied
    table from ``model.embed.weight`` (float32). Adds the weighted MoE
    aux loss. batch = {"tokens": [b, s+1] int}."""

    def loss_fn(model, batch, generator=None):
        tokens = batch["tokens"]
        return _chunked_lm_loss(model, tokens[:, :-1], tokens[:, 1:], chunk_size)

    return loss_fn


def chunked_lm_pair_loss_fn(chunk_size: int = 4096):
    """:func:`chunked_lm_loss_fn` over inputs and targets aligned on the
    host, a drop-in for ``models.lm_pair_loss_fn`` (the JAX example's
    chunked loss): under a seq axis each rank streams the head over its
    own block of positions, and the trainer averages the loss over the
    seq group as it does the dense pair loss. batch = {"inputs": [b, s]
    int, "targets": [b, s] int}."""

    def loss_fn(model, batch, generator=None):
        return _chunked_lm_loss(model, batch["inputs"], batch["targets"], chunk_size)

    return loss_fn
