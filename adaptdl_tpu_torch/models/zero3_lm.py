"""The transformer LM under per-layer ZeRO-3 (``zero3_blocks``), the port
of ``adaptdl_tpu.models.zero3_lm``.

:func:`init_zero3_lm` returns ``(loss_fn, params)`` for
``ElasticTrainer(loss_fn, params, ..., zero3_blocks="blocks")``.
``params`` is a module holding the LM's parameters in the layout the
mode shards: ``embed.weight`` and ``ln_f.scale`` (the non-block family,
gathered once per microbatch) and the L blocks stacked ``[L, ...]``
under ``blocks.`` with the port's :class:`~adaptdl_tpu_torch.models.
transformer.Block` names (``blocks.attention.qkv.weight [L, 3d, d]``,
...). A dense :class:`TransformerLM`'s checkpoint (``layers.<i>.…``)
restores into it (:func:`adaptdl_tpu_torch.parallel.zero3.stack_layers`).

The loss receives the trainer's ``Zero3View``: it embeds, runs
:func:`~adaptdl_tpu_torch.parallel.zero3.scan_blocks` over the existing
``Block`` (applied with ``torch.func.functional_call`` to each gathered
block), applies ``ln_f`` and computes the tied logits in float32 -- the
dense LM's arithmetic, op for op. Attention is the plain (dense) one,
as in the JAX example, which refuses ``--flash`` with this mode; there
is no dropout, and no MoE block.

Under ``config.seq_axis`` (long context: seq-parallel attention with
per-layer ZeRO-3 on a data x seq mesh) the batch is pre-split
``{"inputs", "targets"}`` of ``[rows, seq_len]``, so the seq dim shards
cleanly, each rank holds one contiguous block of every sequence, RoPE
takes global positions and attention crosses the axis as
``config.seq_attention`` says, as in the JAX model.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from adaptdl_tpu_torch.device import resolve_device
from adaptdl_tpu_torch.models.transformer import (
    Block,
    LayerNorm,
    TransformerConfig,
    TransformerLM,
    init_transformer,
)
from adaptdl_tpu_torch.parallel import zero3

BLOCKS_KEY = "blocks"


class Zero3LMParams(nn.Module):
    """The zero3 LM's parameters: ``embed``, ``blocks`` (a ``Block``
    whose every parameter is stacked over the layers) and ``ln_f``, in
    the dense LM's order."""

    def __init__(self, config: TransformerConfig):
        super().__init__()
        self.config = config
        self.embed = nn.Embedding(config.vocab_size, config.d_model)
        with torch.device("meta"):
            self.blocks = Block(config)
        L = config.num_layers
        for name, p in list(self.blocks.named_parameters()):
            path, leaf = name.rsplit(".", 1)
            setattr(
                self.blocks.get_submodule(path), leaf,
                nn.Parameter(torch.empty((L, *p.shape))),
            )
        self.ln_f = LayerNorm(config.d_model, config.dtype)

    @classmethod
    def from_transformer(cls, model: TransformerLM) -> "Zero3LMParams":
        """The same weights as a dense ``TransformerLM`` (no MoE)."""
        params = cls(model.config)
        stacked = zero3.stack_layers(
            dict(model.named_parameters()), zero3.block_spec(params, BLOCKS_KEY)
        )
        if stacked is None:
            raise ValueError("the dense LM's parameters do not stack into blocks")
        with torch.no_grad():
            for name, p in params.named_parameters():
                p.copy_(stacked[name])
        return params.to(next(model.parameters()).device)


def init_zero3_lm(
    config: TransformerConfig,
    seed: int = 0,
    device="cuda",
    seq_len: int | None = None,
    gather_unroll: int = 1,
):
    """``(loss_fn, params)`` for a causal LM trained with
    ``ElasticTrainer(..., zero3_blocks="blocks")``. The weights are
    :func:`init_transformer`'s for ``seed``, stacked. ``loss_fn(view,
    batch, generator)`` takes ``batch["tokens"]`` of shape ``[rows,
    seq_len + 1]`` (raw token rows; under ``config.seq_axis`` pre-split
    ``batch["inputs"]`` and ``batch["targets"]`` of ``[rows, seq_len]``,
    this rank's block of them) and draws nothing from the generator;
    ``loss_fn.forward(view, inputs)`` gives the logits.
    ``gather_unroll`` > 1 prefetches that many blocks' gathers per
    checkpointed region (``scan_blocks``). ``seq_len`` is accepted for
    the JAX signature; the model takes any length."""
    del seq_len
    if config.use_moe:
        raise ValueError("the zero3 LM stacks homogeneous dense blocks; no MoE")
    config = dataclasses.replace(config, attention_fn=None)
    device = resolve_device(device)
    params = Zero3LMParams.from_transformer(
        init_transformer(config, seed=seed, device="cpu")
    ).to(device)
    return zero3_lm_loss_fn(params, gather_unroll), params


def zero3_lm_loss_fn(params: Zero3LMParams, gather_unroll: int = 1):
    """The loss of :func:`init_zero3_lm` for ``params`` (its config and
    layout; the values come from the trainer's rows)."""
    config = dataclasses.replace(params.config, attention_fn=None)
    spec = zero3.block_spec(params, BLOCKS_KEY)
    with torch.device("meta"):
        block = Block(config)
        ln_f = LayerNorm(config.d_model, config.dtype)

    def forward(view: zero3.Zero3View, inputs):
        """``[rows, seq]`` tokens -> ``[rows, seq, vocab]`` float32
        logits through the per-block-gather layer loop."""
        table = view.other["embed.weight"].to(config.dtype)
        x = F.embedding(inputs, table)
        positions = torch.arange(inputs.shape[1], device=inputs.device)
        if config.seq_axis is not None:
            # This rank's block of the global sequence.
            from adaptdl_tpu_torch.parallel.mesh import axis_index

            positions = positions + axis_index(config.seq_axis) * inputs.shape[1]

        def block_fn(p, h):
            out, _ = functional_call(block, p, (h, positions))
            return out

        x = zero3.scan_blocks(block_fn, view.blocks, x, spec, unroll=gather_unroll)
        h = functional_call(ln_f, {"scale": view.other["ln_f.scale"]}, (x,))
        return torch.matmul(h.to(config.dtype), table.t()).float()

    def split(batch):
        """``(inputs, targets)`` of a batch under the seq contract."""
        if config.seq_axis is not None:
            return batch["inputs"], batch["targets"]
        tokens = batch["tokens"]
        return tokens[:, :-1], tokens[:, 1:]

    def loss_fn(view, batch, generator=None):
        inputs, targets = split(batch)
        logits = forward(view, inputs)
        return F.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), targets.reshape(-1).long()
        )

    loss_fn.forward = forward
    loss_fn.split = split
    return loss_fn


def zero3_lm_metric_fn(loss_fn):
    """``metric_fn`` for ``ElasticTrainer.eval_step`` under
    zero3_blocks: partial sums of the token cross-entropy, the correct
    next-token predictions and the tokens seen."""

    def metric_fn(view, batch):
        inputs, targets = loss_fn.split(batch)
        targets = targets.long()
        logits = loss_fn.forward(view, inputs)
        losses = F.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), targets.reshape(-1),
            reduction="none",
        )
        return {
            "loss_sum": losses.sum(),
            "correct": (logits.argmax(-1) == targets).sum(),
            "seen": torch.tensor(targets.numel()),
        }

    return metric_fn
