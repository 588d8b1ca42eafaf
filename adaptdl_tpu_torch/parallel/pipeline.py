"""Pipeline parallelism over the ``"stage"`` axis: the port of
``adaptdl_tpu.parallel.pipeline``.

The layers split across the ranks of a stage group; activations move
between neighbouring stages by a ring shift (:func:`ring_attention.
ppermute`, one send and one receive per rank, whose backward shifts the
cotangent the other way) while a Python loop advances the schedule. With
M microbatches and S stages GPipe runs ``M + S - 1`` ticks; every rank
runs its stage every tick and the bubble is ``(S - 1) / (M + S - 1)``.
The interleaved schedule gives each rank ``v`` chunks and runs ``v * M +
S - 1`` ticks.

Every rank builds the same autograd graph: what differs by rank (which
input a tick reads, which buffer slot an activation lands in, which
chunk runs) is selected by ``torch.where`` masks and index tensors, not
by rank-dependent branches, so that each rank's backward issues the same
reverse hops in the same order. A rank that left a hop out of its graph
(stage 0 ignoring what the last stage hands it) would never send that
hop's cotangent, and its neighbour would wait for it forever. The last
tick's hop carries nothing any tick reads, so it is not made; the JAX
scan makes it and drops the carry.

The outputs are valid on the last stage only. The losses replace the
other stages' outputs by ones before the head and share the last stage's
loss with the group by a sum whose backward hands each rank the output's
cotangent unchanged (the transpose of ``lax.psum`` of a stage-invariant
value under ``shard_map``).
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from adaptdl_tpu_torch import collective
from adaptdl_tpu_torch.parallel.mesh import STAGE_AXIS, axis_group, axis_index, axis_size
from adaptdl_tpu_torch.parallel.ring_attention import ppermute


def _stage(axis_name: str):
    """(this rank's stage, the stage count, the stage group)."""
    return axis_index(axis_name), axis_size(axis_name), axis_group(axis_name)


class _GroupSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return collective.allreduce_sum(x.detach().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def stage_sum(x: torch.Tensor, axis_name: str = STAGE_AXIS) -> torch.Tensor:
    """The sum of ``x`` over the stage group; backward, the output's
    cotangent on every rank (each rank's masked share of a value the
    group holds once)."""
    group = axis_group(axis_name)
    if collective.group_size(group) == 1:
        return x
    return _GroupSum.apply(x, group)


def _mask(values: list, device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.bool, device=device)


def gpipe(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params_local: Any,
    micro_inputs: torch.Tensor,
    axis_name: str = STAGE_AXIS,
) -> torch.Tensor:
    """The GPipe schedule over the stage group of the current mesh.

    Args:
      stage_fn: one stage's forward, ``stage_fn(params, x) -> y`` with
        ``y.shape == x.shape``.
      stage_params_local: this stage's parameters.
      micro_inputs: ``[num_micro, micro_batch, ...]``, the same on every
        stage (only stage 0 reads it).

    Returns ``[num_micro, micro_batch, ...]``: the last stage's outputs,
    valid on the last stage only.
    """
    stage, num_stages, group = _stage(axis_name)
    num_micro = micro_inputs.shape[0]
    ticks = num_micro + num_stages - 1
    first = _mask([stage == 0], micro_inputs.device)[0]
    incoming = torch.zeros_like(micro_inputs[0])
    outs = []
    for t in range(ticks):  # graftcheck: stage-seq=pipeline-tick
        # Stage 0 feeds microbatch t (clamped: the ticks past the last
        # microbatch compute garbage that the output window drops).
        x = torch.where(first, micro_inputs[min(t, num_micro - 1)], incoming)
        y = stage_fn(stage_params_local, x)
        outs.append(y)
        if t < ticks - 1:
            incoming = ppermute(y, group)
    # The last stage emits microbatch m at tick m + S - 1.
    return torch.stack(outs[num_stages - 1 : num_stages - 1 + num_micro])


def stack_interleaved_params(chunk_params: list, num_stages: int) -> dict:
    """Stack ``v * S`` chunk trees (name -> tensor, in GLOBAL chunk order:
    chunk ``g`` runs on stage ``g % S``, visit ``g // S``) into tensors
    shaped ``[S, v, ...]``: stage ``d``'s visit-``k`` chunk at ``[d, k]``."""
    total = len(chunk_params)
    if total % num_stages:
        raise ValueError(f"{total} chunks do not divide over {num_stages} stages")
    v = total // num_stages
    return {
        name: torch.stack([
            torch.stack([chunk_params[k * num_stages + d][name] for k in range(v)])
            for d in range(num_stages)
        ])
        for name in chunk_params[0]
    }


def interleaved_pipeline(
    chunk_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    chunks_local: Sequence[Any],
    micro_inputs: torch.Tensor,
    axis_name: str = STAGE_AXIS,
) -> torch.Tensor:
    """The interleaved (circular) schedule over the stage group
    (Megatron-LM's interleaved stages as a ring-shift program).

    The model is ``v * S`` chunks; stage ``d`` owns chunks ``d, d + S,
    ...`` (``chunks_local[k]`` is its visit-``k`` chunk) and runs them
    depth-first: all M microbatches through local chunk k before chunk
    k + 1, so the pipeline fills once per chunk hop: ``v * M + S - 1``
    ticks. Stage ``d`` runs (visit k, microbatch m) at tick ``k * M + m +
    d``. The wrap hop (stage S - 1 to stage 0) arrives ``M - S`` ticks
    early when M > S, so arrivals land in an M-slot buffer keyed by
    microbatch.

    Returns ``[M, micro_batch, ...]``, the final chunk's outputs, valid
    on the last stage only. Needs ``M >= S`` (raises ``ValueError``).
    """
    num_stages, num_micro = axis_size(axis_name), micro_inputs.shape[0]
    if num_micro < num_stages:
        # With M < S the wrap hop lands after its read tick and stage 0
        # would read garbage.
        raise ValueError(
            f"interleaved pipeline needs num_micro >= num_stages "
            f"(got M={num_micro} < S={num_stages}); use gpipe or raise "
            "the microbatch count"
        )
    stage, _, group = _stage(axis_name)
    v = len(chunks_local)
    ticks = v * num_micro + num_stages - 1
    device = micro_inputs.device
    # Per tick: the slot the arrival belongs to (the predecessor's
    # microbatch of the tick before), this rank's chunk and microbatch,
    # and whether it reads the inputs (stage 0's first visit).
    prev = (stage - 1) % num_stages
    slot_in, slot_here, visit, reads_input = [], [], [], []
    for t in range(ticks):
        slot_in.append((t - 1 - prev) % num_micro)
        here = t - stage
        visit.append(min(max(here // num_micro, 0), v - 1))
        slot_here.append(min(max(here % num_micro, 0), num_micro - 1))
        reads_input.append(stage == 0 and visit[-1] == 0)
    slot_in_t = torch.tensor(slot_in, device=device)
    slot_here_t = torch.tensor(slot_here, device=device)
    reads_input_t = _mask(reads_input, device)
    buf = torch.zeros_like(micro_inputs)
    incoming = torch.zeros_like(micro_inputs[0])
    outs = []
    for t in range(ticks):  # graftcheck: stage-seq=pipeline-tick
        buf = buf.index_copy(0, slot_in_t[t : t + 1], incoming.unsqueeze(0))
        index = slot_here_t[t : t + 1]
        x = torch.where(
            reads_input_t[t],
            micro_inputs.index_select(0, index)[0],
            buf.index_select(0, index)[0],
        )
        y = chunk_fn(chunks_local[visit[t]], x)
        outs.append(y)
        if t < ticks - 1:
            incoming = ppermute(y, group)
    # The last stage emits microbatch m of its last visit at tick
    # (v - 1) * M + m + S - 1.
    start = (v - 1) * num_micro + num_stages - 1
    return torch.stack(outs[start : start + num_micro])


def last_stage_loss(final, batch, loss_head, axis_name: str = STAGE_AXIS):
    """``loss_head(final, batch)`` of the last stage's outputs, shared
    with the group (a scalar on every rank): the
    other stages' garbage is replaced by ones BEFORE the head (a head
    with a partial-domain op would otherwise give NaN, and 0 * NaN
    survives the mask into every stage's gradients)."""
    stage, num_stages, _ = _stage(axis_name)
    is_last = _mask([stage == num_stages - 1], final.device)[0]
    final = torch.where(is_last, final, torch.ones_like(final))
    loss = loss_head(final, batch)
    return stage_sum(torch.where(is_last, loss, torch.zeros_like(loss)), axis_name)


def microbatches(x: torch.Tensor, num_micro: int) -> torch.Tensor:
    """``[rows, ...]`` -> ``[num_micro, rows / num_micro, ...]``; raises
    when the rows do not divide."""
    if x.shape[0] % num_micro:
        raise ValueError(
            f"per-replica batch {x.shape[0]} not divisible into {num_micro} "
            "pipeline microbatches"
        )
    return x.reshape((num_micro, -1) + tuple(x.shape[1:]))


def gpipe_loss(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    loss_head: Callable[[torch.Tensor, Any], torch.Tensor],
    num_micro: int,
    axis_name: str = STAGE_AXIS,
) -> Callable:
    """A trainer loss over the GPipe schedule:
    ``loss_fn(stage_params_local, batch, generator)`` with ``batch["x"]``
    ``[per_replica_batch, ...]`` divisible by ``num_micro``;
    ``loss_head(final, batch)`` is the scalar mean loss, evaluated on
    the last stage and shared with the group."""

    def loss_fn(stage_params_local, batch, generator=None):  # graftcheck: stage-seq=pipeline-loss
        x = batch["x"]
        outs = gpipe(stage_fn, stage_params_local, microbatches(x, num_micro), axis_name)
        return last_stage_loss(outs.reshape(x.shape), batch, loss_head, axis_name)

    return loss_fn


def interleaved_loss(
    chunk_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    loss_head: Callable[[torch.Tensor, Any], torch.Tensor],
    num_micro: int,
    axis_name: str = STAGE_AXIS,
) -> Callable:
    """:func:`gpipe_loss` over the interleaved schedule:
    ``loss_fn(chunks_local, batch, generator)``, ``chunks_local`` this
    rank's ``v`` chunks in visit order. Both losses issue the same
    collective program on every rank: the hops, tick after tick, then
    the group sum."""

    def loss_fn(chunks_local, batch, generator=None):  # graftcheck: stage-seq=pipeline-loss
        x = batch["x"]
        outs = interleaved_pipeline(chunk_fn, chunks_local, microbatches(x, num_micro), axis_name)
        return last_stage_loss(outs.reshape(x.shape), batch, loss_head, axis_name)

    return loss_fn
