"""Per-layer ZeRO-3 / FSDP: block-wise parameter gather inside the
layer loop, the port of ``adaptdl_tpu.parallel.zero3``.

- **Storage** is flat rows over the replicas, per block: each rank keeps
  a ``[L, shard_b]`` row of the L homogeneous blocks' parameters (block
  ``l``'s parameters raveled and padded to ``dp * shard_b``, this rank's
  slice of it) and one ``[shard_o]`` row of everything else (embedding,
  norms, head). Each rank holds 1/dp of every tensor.
- **The gather is an autograd Function** (:class:`GatherRows`): its
  forward all-gathers the rows into the flat vector, its backward
  reduce-scatters (sums) the flat gradient back to this rank's row --
  the transpose the JAX package gets from AD, written out.
- **The layer loop** (:func:`scan_blocks`) runs each block's gather and
  the block under ``torch.utils.checkpoint`` (non-reentrant), so the
  gathered block is not kept for the backward: the backward re-gathers
  it and reduce-scatters its gradient. Per-rank peak memory is the rows
  plus one gathered block (``unroll`` of them) plus activations. Every
  rank runs the same graph, so every rank issues the collectives in the
  same order, forward and backward.

The port's parameter "tree" is an ordered mapping of names to tensors in
the module's parameter order (``named_parameters``); the family
``blocks_key`` holds the names ``f"{blocks_key}.<rest>"``, each stacked
``[L, ...]``. The flat canonical vector is that order raveled: the
layout the zero1 and zero3 modes checkpoint their moments in, so the
three storage modes restore each other's checkpoints.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Mapping, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from adaptdl_tpu_torch import collective
from adaptdl_tpu_torch.parallel.mesh import data_group


class Zero3View(NamedTuple):
    """What a ``zero3_blocks`` loss receives instead of the model: the
    non-block parameters assembled (``other``: name -> tensor, gathered
    through :class:`GatherRows`, so differentiable with respect to this
    rank's row), and the block rows still as this rank's ``[L,
    shard_b]`` rows, for :func:`scan_blocks` to gather one block at a
    time."""

    other: dict
    blocks: torch.Tensor


class BlockSpec(NamedTuple):
    """Static layout facts of one ``zero3_blocks`` parameter family,
    from the parameter tree (dp-independent).

    ``block_fields``: ``(suffix, per-layer shape, offset in one block's
    flat vector, numel)`` of each block parameter, in tree order;
    ``other_fields``: ``(name, shape, offset in the non-block flat
    vector, numel)``; ``names``/``shapes``: the whole tree's order."""

    blocks_key: str
    num_blocks: int
    n_block: int
    n_other: int
    block_fields: tuple
    other_fields: tuple
    names: tuple
    shapes: tuple

    @property
    def n_total(self) -> int:
        return self.num_blocks * self.n_block + self.n_other

    def unravel_block(self, flat: torch.Tensor) -> dict:
        """One block's flat ``[n_block]`` vector -> suffix -> view."""
        return {
            suffix: flat[off : off + k].view(shape)
            for suffix, shape, off, k in self.block_fields
        }

    def unravel_other(self, flat: torch.Tensor) -> dict:
        """The non-block flat ``[n_other]`` vector -> name -> view."""
        return {
            name: flat[off : off + k].view(shape)
            for name, shape, off, k in self.other_fields
        }

    def unravel_tree(self, flat: torch.Tensor) -> dict:
        """A flat canonical ``[n]`` vector -> the tree (views)."""
        tree, off = {}, 0
        for name, shape in zip(self.names, self.shapes):
            k = _numel(shape)
            tree[name] = flat[off : off + k].view(shape)
            off += k
        return tree


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def named_tree(params) -> dict:
    """An ``nn.Module``'s parameters (or a mapping) as the ordered
    name -> tensor tree."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def block_spec(params, blocks_key: str) -> BlockSpec:
    """Layout facts from a tree (or module) whose ``blocks_key`` family
    holds ``[L, ...]`` layer-stacked tensors."""
    tree = named_tree(params)
    prefix = blocks_key + "."
    blocks = [(n[len(prefix):], t) for n, t in tree.items() if n.startswith(prefix)]
    if not blocks:
        raise ValueError(f"params has no {blocks_key!r} entry to treat as "
                         "the layer-stacked block family")
    num_blocks = int(blocks[0][1].shape[0])
    block_fields, off = [], 0
    for suffix, t in blocks:
        if t.dim() == 0 or t.shape[0] != num_blocks:
            raise ValueError(
                "zero3_blocks leaves must share the leading layer dim; "
                f"got {tuple(t.shape)} vs {num_blocks}"
            )
        k = _numel(t.shape[1:])
        block_fields.append((suffix, tuple(t.shape[1:]), off, k))
        off += k
    other_fields, o_off = [], 0
    for name, t in tree.items():
        if not name.startswith(prefix):
            other_fields.append((name, tuple(t.shape), o_off, t.numel()))
            o_off += t.numel()
    return BlockSpec(
        blocks_key=blocks_key,
        num_blocks=num_blocks,
        n_block=off,
        n_other=o_off,
        block_fields=tuple(block_fields),
        other_fields=tuple(other_fields),
        names=tuple(tree),
        shapes=tuple(tuple(t.shape) for t in tree.values()),
    )


def shard_sizes(spec: BlockSpec, dp: int) -> tuple[int, int]:
    """(shard_b, shard_o): per-rank row widths at ``dp`` replicas."""
    return (
        (spec.n_block + (-spec.n_block) % dp) // dp,
        (spec.n_other + (-spec.n_other) % dp) // dp,
    )


def _pad(flat: torch.Tensor, size: int) -> torch.Tensor:
    if flat.shape[-1] == size:
        return flat
    pad = torch.zeros(
        (*flat.shape[:-1], size - flat.shape[-1]), dtype=flat.dtype,
        device=flat.device,
    )
    return torch.cat([flat, pad], dim=-1)


def tree_to_rows(params, blocks_key: str, spec: BlockSpec, dp: int):
    """Tree -> ``(blocks_rows [L, dp, shard_b], other_rows [dp,
    shard_o])``, every rank's rows."""
    tree = named_tree(params)
    shard_b, shard_o = shard_sizes(spec, dp)
    L = spec.num_blocks
    blocks_flat = torch.cat(
        [
            tree[f"{blocks_key}.{suffix}"].detach().reshape(L, -1).float()
            for suffix, _, _, _ in spec.block_fields
        ],
        dim=1,
    )
    blocks_rows = _pad(blocks_flat, dp * shard_b).reshape(L, dp, shard_b)
    other_flat = torch.cat(
        [tree[name].detach().reshape(-1).float()
         for name, _, _, _ in spec.other_fields]
    ) if spec.other_fields else torch.zeros(0)
    other_rows = _pad(other_flat, dp * shard_o).reshape(dp, shard_o)
    return blocks_rows, other_rows


def rows_to_tree(blocks_rows, other_rows, blocks_key: str, spec: BlockSpec) -> dict:
    """Inverse of :func:`tree_to_rows`: the canonical, dp-independent
    tree (in the module's order)."""
    L = spec.num_blocks
    blocks_flat = blocks_rows.reshape(L, -1)[:, : spec.n_block]
    other_flat = other_rows.reshape(-1)[: spec.n_other]
    parts = {}
    for suffix, shape, off, k in spec.block_fields:
        parts[f"{blocks_key}.{suffix}"] = blocks_flat[:, off : off + k].reshape(L, *shape)
    parts.update(spec.unravel_other(other_flat))
    return {name: parts[name] for name in spec.names}


def rows_to_flat_canonical(blocks_rows, other_rows, blocks_key: str, spec: BlockSpec):
    """Row layout -> the ``[n]`` flat vector in tree order."""
    tree = rows_to_tree(blocks_rows, other_rows, blocks_key, spec)
    return torch.cat([t.reshape(-1) for t in tree.values()])


def flat_canonical_to_rows(flat, blocks_key: str, spec: BlockSpec, dp: int):
    """Canonical ``[n]`` vector (tree order) -> every rank's rows at
    ``dp`` replicas."""
    return tree_to_rows(spec.unravel_tree(flat), blocks_key, spec, dp)


def row_segments(spec: BlockSpec, rank: int, dp: int) -> list:
    """Where rank ``rank``'s rows sit in the flat canonical vector:
    ``[(canonical_start, length, row_offset), ...]``, with the rank's
    rows laid end to end as one vector (the ``[L, shard_b]`` block rows,
    then the ``[shard_o]`` row). Pad positions belong to no segment."""
    shard_b, shard_o = shard_sizes(spec, dp)
    segments = []
    canon_off = {}
    off = 0
    for name, shape in zip(spec.names, spec.shapes):
        canon_off[name] = off
        off += _numel(shape)
    lo_b, hi_b = rank * shard_b, min((rank + 1) * shard_b, spec.n_block)
    for layer in range(spec.num_blocks):
        for suffix, _, f_off, k in spec.block_fields:
            s, t = max(lo_b, f_off), min(hi_b, f_off + k)
            if s < t:
                start = canon_off[f"{spec.blocks_key}.{suffix}"] + layer * k + (s - f_off)
                segments.append((start, t - s, layer * shard_b + (s - lo_b)))
    base = spec.num_blocks * shard_b
    lo_o, hi_o = rank * shard_o, min((rank + 1) * shard_o, spec.n_other)
    for name, _, f_off, k in spec.other_fields:
        s, t = max(lo_o, f_off), min(hi_o, f_off + k)
        if s < t:
            segments.append((canon_off[name] + (s - f_off), t - s, base + (s - lo_o)))
    return segments


_LAYER_NAME = re.compile(r"^(?P<prefix>[\w.]+?)\.(?P<index>\d+)\.(?P<rest>.+)$")


def stack_layers(tree: Mapping[str, Any], spec: BlockSpec) -> dict | None:
    """A tree whose layers are separate (``"<prefix>.<i>.<rest>"``, the
    port's ``TransformerLM`` names them ``layers.<i>.…``) as this
    spec's tree, each ``f"{blocks_key}.<rest>"`` stacked over i; None
    when it does not fit. What lets a dense LM's checkpoint restore
    into the per-layer ZeRO-3 LM."""
    stacked: dict[str, dict[int, Any]] = {}
    out = {}
    for name, value in tree.items():
        if name in spec.names:
            out[name] = value
            continue
        m = _LAYER_NAME.match(name)
        if m is None:
            return None
        stacked.setdefault(m["rest"], {})[int(m["index"])] = value
    for suffix, _, _, _ in spec.block_fields:
        layers = stacked.get(suffix, {})
        if sorted(layers) != list(range(spec.num_blocks)):
            return None
        out[f"{spec.blocks_key}.{suffix}"] = torch.stack(
            [torch.as_tensor(layers[i]) for i in range(spec.num_blocks)]
        )
    if set(out) != set(spec.names):
        return None
    return {name: out[name] for name in spec.names}


class GatherRows(torch.autograd.Function):
    """``[shard]`` row -> the flat ``[n]`` vector of every data rank's
    rows (an all-gather over the data group; ``n`` trims the padding).
    Its backward pads the ``[n]`` gradient and reduce-scatters it: each
    rank receives the sum over the data group of its own row's
    gradient."""

    @staticmethod
    def forward(ctx, row, n, group):
        ctx.n, ctx.group = n, group
        ctx.shape = row.shape
        full = collective.all_gather_rows(row.detach().reshape(-1).float(), group=group)
        return full[:n]

    @staticmethod
    def backward(ctx, grad):
        dp = collective.group_size(ctx.group)
        shard = _numel(ctx.shape)
        flat = _pad(grad.float().reshape(-1), dp * shard)
        row = collective.reduce_scatter_sum(flat, group=ctx.group)
        return row.reshape(ctx.shape), None, None


def gather_rows(row_local: torch.Tensor, n: int) -> torch.Tensor:
    """This rank's row -> the full ``[n]`` flat vector, differentiable
    (:class:`GatherRows`, over :func:`~adaptdl_tpu_torch.parallel.mesh.
    data_group`); at one data replica a slice of the row."""
    group = data_group()
    if collective.group_size(group) == 1:
        return row_local.reshape(-1)[:n]
    return GatherRows.apply(row_local, n, group)


def gather_block(row_local: torch.Tensor, spec: BlockSpec) -> dict:
    """One block's ``[shard_b]`` row -> that block's parameters
    (suffix -> tensor). Call inside the layer loop's checkpointed body
    (:func:`scan_blocks` does), so the backward re-gathers it."""
    return spec.unravel_block(gather_rows(row_local, spec.n_block))


def scan_blocks(
    block_fn: Callable[[dict, Any], Any],
    blocks_rows: torch.Tensor,
    x: Any,
    spec: BlockSpec,
    unroll: int = 1,
):
    """Apply the L blocks to ``x`` with a per-block gather:
    ``block_fn(block_params, x) -> x``. Each run of ``unroll`` blocks
    is one checkpointed region whose gathers are all issued at its
    start, before its first block runs (the next blocks' gathers are
    prefetched), so the backward re-gathers those blocks and
    reduce-scatters their gradients. ``unroll`` changes the schedule and
    the peak (one more gathered block per unroll step), never the
    numbers. The port overlaps nothing by it: at one replica the gather
    is a slice, and over gloo each gather blocks the host until it
    returns."""
    L = spec.num_blocks
    unroll = max(int(unroll), 1)

    def region(h, *rows):
        gathered = [gather_block(row, spec) for row in rows]
        for params in gathered:
            h = block_fn(params, h)
        return h

    for start in range(0, L, unroll):
        rows = [blocks_rows[i] for i in range(start, min(start + unroll, L))]
        if torch.is_grad_enabled():
            x = checkpoint(region, x, *rows, use_reentrant=False)
        else:
            x = region(x, *rows)
    return x


def build_view(blocks_rows_local: torch.Tensor, other_rows_local: torch.Tensor,
               spec: BlockSpec) -> Zero3View:
    """This rank's rows -> the :class:`Zero3View` a ``zero3_blocks``
    loss consumes: the non-block parameters gathered once here, the
    block rows passed through for :func:`scan_blocks`."""
    other = spec.unravel_other(gather_rows(other_rows_local, spec.n_other))
    return Zero3View(other=other, blocks=blocks_rows_local)


def assemble_tree(blocks_rows_local: torch.Tensor, other_rows_local: torch.Tensor,
                  blocks_key: str, spec: BlockSpec) -> dict:
    """This rank's rows -> the whole canonical tree (every block at once:
    an evaluation and export helper, not the training path). A
    collective: every rank calls it."""
    group = data_group()
    dp = collective.group_size(group)
    L = spec.num_blocks
    blocks = torch.stack(
        [
            collective.all_gather_rows(
                blocks_rows_local[i].detach().reshape(-1), group=group
            )
            for i in range(L)
        ]
    ).reshape(L, dp, -1)
    other = collective.all_gather_rows(
        other_rows_local.detach().reshape(-1), group=group
    ).reshape(dp, -1)
    return rows_to_tree(blocks, other, blocks_key, spec)
