"""Megatron tensor parallelism over the ``"model"`` axis: the port of
``adaptdl_tpu.parallel.tensor_parallel``.

The JAX package writes the layout as PartitionSpecs and leaves the
collectives to GSPMD. PyTorch inserts none, so the port writes both:

- :data:`TP_KERNEL_SPECS`, the table of which parameter is split on
  which dim: the attention's ``qkv`` by head (column-parallel), its
  ``out`` projection on its input, the head-concat dim (row-parallel),
  ``ff_up`` by column and ``ff_down`` by row; embeddings and LayerNorm
  scales are replicated. The port's ``qkv`` is one ``[3d, d]`` weight
  whose rows run (q|k|v, head, head_dim), so a rank's heads are three
  strided row blocks: a :class:`ShardSpec` cuts each of its ``groups``
  equal blocks of the split dim into the shards.
- the region operators, autograd functions over the model group:
  :func:`copy_in` (identity forward, all-reduce-sum backward) on the
  input of each column-parallel product, :func:`reduce_out`
  (all-reduce-sum forward, identity backward) on the output of each
  row-parallel product.

The expert axis shards ``moe.w_up`` / ``moe.w_down`` on their expert
dim (:data:`EXPERT_SPEC`): :func:`leaf_shard_spec` answers for both
axes, and the trainer and the canonical checkpoint read it.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from adaptdl_tpu_torch import collective
from adaptdl_tpu_torch.parallel.mesh import EXPERT_AXIS, MODEL_AXIS


@dataclass(frozen=True)
class ShardSpec:
    """A parameter split on ``dim``: the dim is ``groups`` equal blocks,
    and shard ``i`` of ``n`` holds the ``i``-th ``1/n`` of each block,
    the blocks kept in order."""

    dim: int
    groups: int = 1

    def shard(self, full: torch.Tensor, index: int, shards: int) -> torch.Tensor:
        """Shard ``index`` of ``shards`` of the full tensor (a copy)."""
        if shards == 1:
            return full
        blocks = full.unflatten(self.dim, (self.groups, -1))
        if blocks.shape[self.dim + 1] % shards:
            raise ValueError(
                f"dim {self.dim} of {tuple(full.shape)} ({self.groups} "
                f"block(s)) does not split into {shards} shards"
            )
        part = blocks.chunk(shards, dim=self.dim + 1)[index]
        return part.flatten(self.dim, self.dim + 1).clone()

    def gather(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """Every shard, in index order -> the full tensor."""
        if len(parts) == 1:
            return parts[0]
        blocks = [p.unflatten(self.dim, (self.groups, -1)) for p in parts]
        return torch.cat(blocks, dim=self.dim + 1).flatten(self.dim, self.dim + 1)


# Megatron layout by parameter name (suffix, spec). Weights are
# ``nn.Linear``'s ``[out, in]``.
TP_KERNEL_SPECS: tuple[tuple[str, ShardSpec], ...] = (
    # qkv [3d, d], rows (3, heads, head_dim) -> heads split in each of q, k, v
    ("attention.qkv.weight", ShardSpec(dim=0, groups=3)),
    # out [d, heads * head_dim] -> the input (head-concat) dim split
    ("attention.out.weight", ShardSpec(dim=1)),
    # ff_up [d_ff, d] -> columns (its output rows); ff_down [d, d_ff] -> its input
    ("ff_up.weight", ShardSpec(dim=0)),
    ("ff_down.weight", ShardSpec(dim=1)),
)
# A MoE block's experts ``[E, ...]``: whole experts per expert rank.
EXPERT_SPEC = ShardSpec(dim=0)
EXPERT_LEAVES = ("moe.w_up", "moe.w_down")


def match_tp_kernel_spec(name: str) -> ShardSpec | None:
    """The Megatron split of a parameter name, or None for the
    replicated roles (embeddings, LayerNorm scales, the MoE block)."""
    for suffix, spec in TP_KERNEL_SPECS:
        if name.endswith(suffix):
            return spec
    return None


def transformer_tp_specs(name: str, param: torch.Tensor) -> ShardSpec | None:
    """The :data:`TP_KERNEL_SPECS` split of a :class:`TransformerLM`
    parameter (None: replicated), as the JAX function of the name."""
    spec = match_tp_kernel_spec(name)
    if spec is not None and param.dim() == 2:
        return spec
    return None


def leaf_shard_spec(name: str, param: torch.Tensor) -> tuple[str, ShardSpec] | None:
    """``(axis, spec)`` of a transformer parameter sharded over the model
    or the expert axis; None for a replicated one."""
    if name.endswith(EXPERT_LEAVES):
        return EXPERT_AXIS, EXPERT_SPEC
    spec = transformer_tp_specs(name, param)
    return None if spec is None else (MODEL_AXIS, spec)


def shard_state_dict(
    state: dict, model: tuple[int, int] = (0, 1), expert: tuple[int, int] = (0, 1)
) -> dict:
    """A full (logical) state dict -> the shard of model rank ``model =
    (index, size)`` and expert rank ``expert = (index, size)``; the
    replicated entries as they are."""
    out = {}
    for name, value in state.items():
        found = leaf_shard_spec(name, value)
        if found is None:
            out[name] = value
            continue
        axis, spec = found
        index, size = model if axis == MODEL_AXIS else expert
        out[name] = spec.shard(value, index, size)
    return out


def shard_transformer(
    model: torch.nn.Module, model_shard: tuple[int, int] = (0, 1),
    expert_shard: tuple[int, int] = (0, 1),
) -> torch.nn.Module:
    """Replace ``model``'s full parameters by this rank's shards, in
    place (:func:`shard_state_dict`'s cut); returns the model."""
    full = {n: p.detach() for n, p in model.named_parameters()}
    for name, value in shard_state_dict(full, model_shard, expert_shard).items():
        if value is full[name]:
            continue
        path, leaf = name.rsplit(".", 1)
        setattr(model.get_submodule(path), leaf, torch.nn.Parameter(value))
    return model


def group_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` as a new tensor in
    ``x``'s dtype, summed in float32 (every rank gets the same bits)."""
    total = collective.allreduce_sum(x.detach().to(torch.float32, copy=True), group)
    return total.to(x.dtype)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return group_sum(grad, ctx.group), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_in(x: torch.Tensor, group) -> torch.Tensor:
    """Enter a region whose ranks each hold part of the next product:
    identity forward; backward, the sum over ``group`` of the ranks'
    partial input gradients."""
    if collective.group_size(group) == 1:
        return x
    return _CopyIn.apply(x, group)


def reduce_out(x: torch.Tensor, group) -> torch.Tensor:
    """Leave a row-parallel region: the sum over ``group`` of the ranks'
    partial outputs forward (float32 on the wire); backward, identity
    (every rank already holds the whole output's cotangent)."""
    if collective.group_size(group) == 1:
        return x
    return _ReduceOut.apply(x, group)
