"""The transformer LM under pipeline parallelism: the port of
``adaptdl_tpu.models.pipeline_lm``.

Only the uniform ``[batch, seq, d_model]`` blocks are staged; the
embedding, the final LayerNorm and the tied head are replicated on
every stage of the group and computed there (the head on ones off the
last stage, :mod:`adaptdl_tpu_torch.parallel.pipeline`). The blocks run
plain causal attention, as the JAX package builds them
(``attention_fn=None``): no flash kernel runs on this path.

The model's ``v * S`` chunks of ``L / (v * S)`` layers each are global
chunks ``c``, layers ``[c * lpc, (c + 1) * lpc)``; stage ``d`` holds
chunks ``d, d + S, ...`` (GPipe: ``v = 1``). A rank's
:class:`PipelineLM` holds the replicated leaves and only its own blocks,
under the dense :class:`TransformerLM`'s names (``layers.<l>.*`` with
``l`` the global layer index), so that a checkpoint gathered over the
stage group is the dense LM's, and a job moves between ss 1 and ss 2,
and between GPipe and the interleaved schedule, across a restart: the
port's form of the JAX ``pipeline_checkpoint_transforms`` and
``dense_lm_checkpoint_transforms``.

Under ``config.model_axis`` the blocks are also split by the Megatron
table over the model axis (the JAX ``pipeline_lm_tp_sharding_fn``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from adaptdl_tpu_torch.device import resolve_device
from adaptdl_tpu_torch.models.transformer import (
    Block, LayerNorm, TransformerConfig, TransformerLM, _reset_parameters, apply_block,
)
from adaptdl_tpu_torch.parallel.mesh import STAGE_AXIS, axis_index, axis_size, current_mesh
from adaptdl_tpu_torch.parallel.pipeline import (
    gpipe, interleaved_pipeline, last_stage_loss, microbatches,
)


def stage_layers(num_layers: int, num_stages: int, interleave: int, stage: int) -> list:
    """The global layer indices stage ``stage`` holds, in its visit order:
    chunk ``k * S + stage`` for each visit ``k``, each chunk's layers in
    order."""
    lpc = num_layers // (num_stages * interleave)
    return [
        (k * num_stages + stage) * lpc + i
        for k in range(interleave)
        for i in range(lpc)
    ]


class PipelineLM(nn.Module):
    """One stage's share of the pipelined LM: ``embed``, ``ln_f`` and
    the blocks of :func:`stage_layers` under ``layers.<l>``. Its
    ``chunks`` are the visit-ordered lists of its blocks."""

    def __init__(
        self, config: TransformerConfig, num_stages: int, num_micro: int,
        interleave: int = 1, stage: int = 0,
    ):
        super().__init__()
        total = num_stages * max(interleave, 1)
        if config.num_layers % total:
            raise ValueError(
                f"{config.num_layers} layers cannot split into {total} uniform "
                f"chunks ({num_stages} stages x {interleave} interleave)"
            )
        if interleave > 1 and num_micro < num_stages:
            raise ValueError("the interleaved schedule needs num_micro >= num_stages")
        if config.use_moe:
            raise ValueError(
                "MoE blocks are unsupported under the pipeline schedule (the "
                "staged chunks apply the dense Block only); compose expert "
                "parallelism with dp instead"
            )
        # The staged blocks see plain attention: the seq and expert axes
        # compose with dp, not with the pipeline.
        self.config = dataclasses.replace(
            config, seq_axis=None, attention_fn=None, moe_axis=None
        )
        self.num_stages = num_stages
        self.num_micro = num_micro
        self.interleave = max(interleave, 1)
        self.stage = stage
        self.embed = nn.Embedding(config.vocab_size, config.d_model)
        self.layers = nn.ModuleDict(
            (str(layer), Block(self.config))
            for layer in stage_layers(config.num_layers, num_stages, self.interleave, stage)
        )
        self.ln_f = LayerNorm(config.d_model, config.dtype)

    @property
    def chunks(self) -> list:
        """This stage's chunks in visit order, each a list of blocks."""
        blocks = list(self.layers.values())
        lpc = len(blocks) // self.interleave
        return [blocks[k * lpc : (k + 1) * lpc] for k in range(self.interleave)]

    def peer_name(self, name: str, stage: int) -> str:
        """The name stage ``stage`` gives to the parameter this stage
        calls ``name`` (the same for a replicated leaf)."""
        if not name.startswith("layers."):
            return name
        _, layer, rest = name.split(".", 2)
        mine = list(self.layers)
        theirs = stage_layers(
            self.config.num_layers, self.num_stages, self.interleave, stage
        )
        return f"layers.{theirs[mine.index(layer)]}.{rest}"

    def dense_names(self) -> list:
        """Every parameter name of the dense :class:`TransformerLM`, in
        its parameter order."""
        block = [n for n, _ in next(iter(self.layers.values())).named_parameters()]
        return (
            ["embed.weight"]
            + [f"layers.{l}.{n}" for l in range(self.config.num_layers) for n in block]
            + ["ln_f.scale"]
        )

    def _chunk(self, blocks, x):
        positions = torch.arange(x.shape[1], device=x.device)
        for block in blocks:
            x, _ = apply_block(self.config, block, x, positions)
        return x

    def forward(self, tokens) -> torch.Tensor:
        """The last stage's final hidden states ``[b, s, d]`` (garbage on
        the other stages); ``b`` divisible by ``num_micro``."""
        x = F.embedding(tokens, self.embed.weight.to(self.config.dtype))
        micro = microbatches(x, self.num_micro)
        if self.interleave > 1:
            outs = interleaved_pipeline(self._chunk, self.chunks, micro)
        else:
            outs = gpipe(self._chunk, self.chunks[0], micro)
        return outs.reshape(x.shape)


def pipeline_lm_loss_fn(model: PipelineLM, batch, generator=None) -> torch.Tensor:
    """Next-token cross-entropy of raw token rows (``batch = {"tokens":
    [b, s + 1] int}``, shifted here), the mean over every position,
    computed on the last stage and shared with the stage group. Draws
    nothing from ``generator``."""
    tokens = batch["tokens"]
    dtype = model.config.dtype

    def head(final, _):
        # The tied output head through the embedding table.
        h = model.ln_f(final).to(dtype)
        logits = torch.matmul(h, model.embed.weight.to(dtype).t()).float()
        return F.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1).long()
        )

    return last_stage_loss(model(tokens[:, :-1]), batch, head)


def init_pipeline_lm(
    config: TransformerConfig, num_stages: int, num_micro: int,
    interleave: int = 1, seed: int = 0, device="cuda",
):
    """``(loss_fn, model)``: this rank's :class:`PipelineLM` on ``device``
    and :func:`pipeline_lm_loss_fn`. The weights are the dense
    :func:`init_transformer`'s for ``seed`` (drawn whole on the CPU),
    the blocks of this rank's stage on the current mesh (create the mesh
    first; stage 0 without one) kept and, under ``config.model_axis``,
    cut to this rank's Megatron shards. The loss takes raw token rows,
    ``rows`` divisible by ``num_micro``."""
    from adaptdl_tpu_torch.parallel.tensor_parallel import shard_transformer

    stage = 0
    if current_mesh() is not None:
        if axis_size(STAGE_AXIS) != num_stages:
            raise ValueError(
                f"the current mesh has {axis_size(STAGE_AXIS)} stage(s), not {num_stages}"
            )
        stage = axis_index(STAGE_AXIS)
    device = resolve_device(device)
    model = PipelineLM(config, num_stages, num_micro, interleave, stage)
    dense = TransformerLM(dataclasses.replace(config, model_axis=None))
    _reset_parameters(dense, torch.Generator().manual_seed(seed))
    model.load_state_dict(
        {k: v for k, v in dense.state_dict().items() if k in model.state_dict()}
    )
    if config.model_axis is not None:
        model = shard_transformer(
            model, (axis_index(config.model_axis), axis_size(config.model_axis))
        )
    return pipeline_lm_loss_fn, model.to(device)
