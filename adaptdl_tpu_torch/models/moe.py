"""Switch/GShard mixture-of-experts FFN, the port of
``adaptdl_tpu.models.moe``: ``dense_switch_moe`` at one expert shard and
``switch_moe`` over an expert axis, with their routing.

Routing, per slice of ``s`` tokens (``num_slices`` slices bin tokens as
an expert-parallel run's devices would):

- *token choice* (Switch at ``top_k=1``, GShard at ``top_k=2``): each
  token takes its ``top_k`` most probable experts in turn; its place in
  an expert's queue counts the tokens before it in this choice plus
  every token queued there by earlier choices, and a place at or past
  the capacity drops the (token, choice) pair. With ``top_k > 1`` the
  gates are renormalised over all ``top_k`` choices, dropped ones
  included. The aux loss is Switch's ``E * sum_e f_e * P_e``.
- *expert choice* (arXiv:2202.09368): each expert takes its
  ``capacity`` most probable tokens (ties to the lower token index, as
  ``lax.top_k``); aux 0.

A token no kept pair routes passes through unchanged. Router, dispatch
and experts run in float32, as the reference's.

The reference builds one-hot ``[s, E, C]`` dispatch and combine tensors
and contracts them with einsums. :func:`dense_switch_moe` computes the
same function by indices: a routing is a list of (token, slot, weight)
pairs, slot ``e * C + c``; each kept pair's token row is written into
its slot of the experts' ``[E, C, d]`` input, and their output returns
to the tokens by a weighted scatter-add. :func:`dense_switch_moe_reference`
keeps the literal one-hot form as the plain version the tests hold it
to.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from adaptdl_tpu_torch import collective


def gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def capacity(router_type, capacity_factor, top_k, slice_len, num_experts):
    """Per-(slice, expert) token capacity: token choice scales with
    ``top_k`` (each token queues k times); expert choice does not, and
    an expert never takes more tokens than the slice holds."""
    if router_type == "experts":
        return min(
            max(int(capacity_factor * slice_len / num_experts), 1), slice_len
        )
    if router_type != "tokens":
        raise ValueError(
            f"unknown router_type {router_type!r}: expected \"tokens\" "
            "(Switch/GShard) or \"experts\" (expert-choice)"
        )
    return max(int(capacity_factor * top_k * slice_len / num_experts), 1)


class Routing(NamedTuple):
    """A slice's routing as (token, slot, weight) pairs, one per
    (token, choice) for token choice and one per (expert, place) for
    expert choice. ``slot = e * capacity + c``; a dropped pair keeps
    its token, has ``kept`` False, weight 0 and slot 0."""

    token: torch.Tensor  # [P] int64
    slot: torch.Tensor  # [P] int64
    weight: torch.Tensor  # [P] float32 (differentiable: the gates)
    kept: torch.Tensor  # [P] bool
    aux: torch.Tensor  # scalar float32


def _router_probs(x, router):
    return torch.softmax(x.float() @ router.float(), dim=-1)  # [s, E]


def token_choice_routing(x, router, num_experts, cap, top_k=1) -> Routing:
    """Top-``top_k`` token choice for one slice ``x`` [s, d]."""
    probs = _router_probs(x, router)
    s = probs.shape[0]
    tokens = torch.arange(s, device=x.device)
    counts = torch.zeros(num_experts, dtype=torch.int64, device=x.device)
    remaining = probs
    experts, positions, gates = [], [], []
    for _ in range(top_k):
        expert = torch.argmax(remaining, dim=-1)  # the first maximum
        gates.append(remaining.gather(1, expert[:, None])[:, 0])
        onehot = F.one_hot(expert, num_experts)
        # Place in the expert's queue: tokens before this one in this
        # choice, plus every token earlier choices queued there. The scan
        # runs along the tokens as the innermost dim ([E, s]), where it
        # is parallel.
        queued = torch.cumsum(onehot.t().contiguous(), dim=1)
        before = queued.gather(0, expert[None, :])[0] - 1
        positions.append(before + counts[expert])
        counts = counts + queued[:, -1]
        experts.append(expert)
        remaining = remaining * (1.0 - onehot.to(remaining.dtype))
    if top_k > 1:
        # GShard: gates renormalised over all k choices, kept or not.
        denom = sum(gates) + 1e-9
        gates = [g / denom for g in gates]
    expert = torch.stack(experts, dim=1).reshape(-1)  # [s * k], token-major
    position = torch.stack(positions, dim=1).reshape(-1)
    weight = torch.stack(gates, dim=1).reshape(-1)
    kept = position < cap
    f = torch.bincount(experts[0], minlength=num_experts).float() / s
    aux = num_experts * torch.sum(f * probs.mean(dim=0))
    return Routing(
        token=tokens.repeat_interleave(top_k),
        slot=torch.where(kept, expert * cap + position, 0),
        weight=torch.where(kept, weight, 0.0),
        kept=kept,
        aux=aux,
    )


def expert_choice_routing(x, router, num_experts, cap) -> Routing:
    """Expert choice for one slice ``x`` [s, d]: each expert's top
    ``cap`` tokens by router probability, ties to the lower index (a
    stable descending sort; ``torch.topk`` does not order ties)."""
    probs = _router_probs(x, router)
    ranked, order = torch.sort(probs.t(), dim=-1, descending=True, stable=True)
    gates, token = ranked[:, :cap], order[:, :cap]  # [E, C] both
    return Routing(
        token=token.reshape(-1),
        slot=torch.arange(num_experts * cap, device=x.device),
        weight=gates.reshape(-1),
        kept=torch.ones(num_experts * cap, dtype=torch.bool, device=x.device),
        aux=torch.zeros((), device=x.device),
    )


def route(x, router, num_experts, cap, top_k, router_type) -> Routing:
    if router_type == "experts":
        return expert_choice_routing(x, router, num_experts, cap)
    return token_choice_routing(x, router, num_experts, cap, top_k)


def _experts(sent, w_up, w_down, activation):
    """The expert FFNs on ``[E, C, d]`` (float32)."""
    return torch.bmm(activation(torch.bmm(sent, w_up)), w_down)


def _dispatch(x32, routing: Routing, slots):
    """The kept pairs' token rows written into their slots: ``(sent
    [slots, d], slot_token [slots], slot_weight [slots])``. Each kept
    pair writes its slot (a slot holds at most one pair); dropped pairs
    write a spare slot past the end. An empty slot holds token ``s`` (a
    spare row), weight 0 and a zero input row."""
    s, dim = x32.shape
    target = torch.where(routing.kept, routing.slot, slots)
    slot_token = torch.full((slots + 1,), s, dtype=torch.int64, device=x32.device)
    slot_token = slot_token.index_put((target,), routing.token)[:slots]
    slot_weight = x32.new_zeros(slots + 1).index_put((target,), routing.weight)[:slots]
    # Writing rows, not gathering them, keeps the backward a gather: a
    # gather's backward accumulates serially over an index repeated per
    # empty slot.
    sent = x32.new_zeros(slots + 1, dim).index_put((target,), x32[routing.token])
    return sent[:slots], slot_token, slot_weight


def _combine(x32, out, slot_token, slot_weight):
    """The experts' ``[slots, d]`` output back onto the tokens by a
    weighted scatter-add; unrouted tokens (every pair dropped, or a zero
    gate) pass through."""
    s, dim = x32.shape
    combined = x32.new_zeros(s + 1, dim).index_add(
        0, slot_token, slot_weight[:, None] * out
    )[:s]
    gate_sum = x32.new_zeros(s + 1).index_add(0, slot_token, slot_weight.detach())[:s]
    return torch.where(gate_sum[:, None] > 0, combined, x32)


def _apply_slice(x, routing: Routing, w_up, w_down, cap, activation):
    num_experts = w_up.shape[0]
    x32 = x.float()
    sent, slot_token, slot_weight = _dispatch(x32, routing, num_experts * cap)
    out = _experts(sent.view(num_experts, cap, -1), w_up, w_down, activation)
    return _combine(x32, out.view(num_experts * cap, -1), slot_token, slot_weight)


def dense_switch_moe(
    router, expert_params, x, num_slices=1, capacity_factor=2.0,
    activation: Callable = gelu, top_k=1, return_aux=False,
    router_type="tokens",
):
    """Single-shard MoE FFN over ``x`` [n, d] with ``router`` [d, E] and
    ``expert_params = {"w_up": [E, d, f], "w_down": [E, f, d]}``; the
    output is in x's dtype. ``num_slices`` bins the tokens as that many
    expert-parallel devices would; the aux loss is the slices' mean."""
    n, _ = x.shape
    num_experts = expert_params["w_up"].shape[0]
    slice_len = n // num_slices
    cap = capacity(router_type, capacity_factor, top_k, slice_len, num_experts)
    w_up = expert_params["w_up"].float()
    w_down = expert_params["w_down"].float()
    outs, auxes = [], []
    for i in range(num_slices):
        x_local = x[i * slice_len : (i + 1) * slice_len]
        routing = route(x_local, router, num_experts, cap, top_k, router_type)
        outs.append(_apply_slice(x_local, routing, w_up, w_down, cap, activation))
        auxes.append(routing.aux)
    out = torch.cat(outs, dim=0).to(x.dtype)
    if return_aux:
        return out, torch.stack(auxes).mean()
    return out


class _GatherSlices(torch.autograd.Function):
    """Every rank's ``[s, d]`` slice -> the ``[ep * s, d]`` whole in rank
    order (an all-gather: the JAX package's psum of disjoint slices);
    backward, this rank's slice of the whole's cotangent, which every
    rank of the group holds alike."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = collective.group_size(group)
        full = collective.all_gather_rows(x.detach().reshape(-1), group=group)
        return full.view(n * x.shape[0], *x.shape[1:])

    @staticmethod
    def backward(ctx, grad):
        n, me = collective.group_size(ctx.group), collective.group_rank(ctx.group)
        s = grad.shape[0] // n
        return grad[me * s : (me + 1) * s], None


class _MeanOver(torch.autograd.Function):
    """The mean over ``group`` of a per-rank value; backward, the
    cotangent over the group size (every rank holds the same one)."""

    @staticmethod
    def forward(ctx, x, group):
        from adaptdl_tpu_torch.parallel.tensor_parallel import group_sum

        ctx.n = collective.group_size(group)
        return group_sum(x, group) / ctx.n

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.n, None


def switch_moe(
    router, expert_params, x, group, capacity_factor=2.0,
    activation: Callable = gelu, top_k=1, return_aux=False,
    router_type="tokens",
):
    """Expert-parallel Switch/GShard FFN over the ranks of ``group`` (the
    expert axis), the port of the JAX ``switch_moe``.

    ``router`` [d, E] is replicated; ``expert_params = {"w_up": [E/ep,
    d, f], "w_down": [E/ep, f, d]}`` are this rank's experts (expert
    ``e`` lives on rank ``e // (E/ep)``). ``x`` [n, d] is the replica
    group's batch, identical on every rank; rank ``r`` routes token slice
    ``r`` (``n / ep`` tokens) with the capacity per (source rank,
    expert), sends its ``[ep, E/ep, C, d]`` blocks to the experts' ranks
    by an all-to-all, runs its experts on what arrives, returns the
    blocks by the inverse exchange, and the slices reassemble the full
    ``[n, d]`` output on every rank: :func:`dense_switch_moe` at
    ``num_slices = ep``, expert for expert.

    The gradients the JAX varying-axis rules supply are explicit here:
    ``x`` and the router enter through a copy-in (their gradients summed
    over the group), the reassembly's backward hands each rank its
    slice, and the aux loss is the group's mean.
    """
    from adaptdl_tpu_torch.parallel.tensor_parallel import copy_in
    from adaptdl_tpu_torch.parallel.ulysses import all_to_all

    ep, me = collective.group_size(group), collective.group_rank(group)
    w_up = expert_params["w_up"].float()
    w_down = expert_params["w_down"].float()
    local_e = w_up.shape[0]
    num_experts = ep * local_e
    if router.shape[-1] != num_experts:
        raise ValueError(
            f"router has {router.shape[-1]} experts but the shards imply "
            f"{num_experts}"
        )
    n, dim = x.shape
    if n % ep:
        raise ValueError(f"batch {n} must divide across {ep} expert ranks")
    slice_len = n // ep
    cap = capacity(router_type, capacity_factor, top_k, slice_len, num_experts)
    x_in, router = copy_in(x, group), copy_in(router, group)
    x32 = x_in[me * slice_len : (me + 1) * slice_len].float()
    routing = route(x32, router, num_experts, cap, top_k, router_type)
    sent, slot_token, slot_weight = _dispatch(x32, routing, num_experts * cap)
    # Block g ([E/ep, C, d]) goes to rank g; dim 0 then indexes the
    # source rank of each block that arrived.
    recv = all_to_all(sent.view(ep, local_e, cap, dim), group, 0, 0)
    # Each local expert over every source's C rows.
    rows = recv.transpose(0, 1).reshape(local_e, ep * cap, dim)
    out = _experts(rows, w_up, w_down, activation)
    out = out.view(local_e, ep, cap, dim).transpose(0, 1).contiguous()
    # The return trip: expert output for source g goes back to g.
    returned = all_to_all(out, group, 0, 0).view(num_experts * cap, dim)
    out_local = _combine(x32, returned, slot_token, slot_weight)
    full = _GatherSlices.apply(out_local, group) if ep > 1 else out_local
    full = full.to(x.dtype)
    if return_aux:
        aux = _MeanOver.apply(routing.aux, group) if ep > 1 else routing.aux
        return full, aux
    return full


# -- the plain version: the reference's one-hot tensors, literally ----------


def routing_onehot(x, router, num_experts, cap, top_k=1):
    """``(dispatch [s, E, C], combine [s, E, C], aux)``, the reference's
    ``_routing`` line for line."""
    probs = _router_probs(x, router)
    dispatches, gates = [], []
    counts = torch.zeros(num_experts, device=x.device)
    remaining = probs
    first_choice = None
    for _ in range(top_k):
        expert = torch.argmax(remaining, dim=-1)
        if first_choice is None:
            first_choice = expert
        gate = torch.amax(remaining, dim=-1)
        onehot = F.one_hot(expert, num_experts).float()
        position = (
            torch.einsum("se,se->s", torch.cumsum(onehot, dim=0) - 1.0, onehot)
            + onehot @ counts
        )
        counts = counts + onehot.sum(dim=0)
        keep = position < cap
        slot = F.one_hot(position.long().clamp(max=cap), cap + 1)[:, :cap].float()
        dispatches.append(onehot[:, :, None] * slot[:, None, :] * keep[:, None, None])
        gates.append(gate)
        remaining = remaining * (1.0 - onehot)
    if top_k > 1:
        denom = sum(gates) + 1e-9
        combine = sum(d * (g / denom)[:, None, None] for d, g in zip(dispatches, gates))
    else:
        combine = dispatches[0] * gates[0][:, None, None]
    f = F.one_hot(first_choice, num_experts).float().mean(dim=0)
    aux = num_experts * torch.sum(f * probs.mean(dim=0))
    return sum(dispatches), combine, aux


def expert_choice_routing_onehot(x, router, num_experts, cap):
    """The reference's ``_expert_choice_routing`` (ties to the lower
    token index)."""
    probs = _router_probs(x, router)
    ranked, order = torch.sort(probs.t(), dim=-1, descending=True, stable=True)
    gates, token = ranked[:, :cap], order[:, :cap]
    dispatch = F.one_hot(token, probs.shape[0]).float().permute(2, 0, 1)
    return dispatch, dispatch * gates[None], torch.zeros((), device=x.device)


def dense_switch_moe_reference(
    router, expert_params, x, num_slices=1, capacity_factor=2.0,
    activation: Callable = gelu, top_k=1, return_aux=False,
    router_type="tokens",
):
    """:func:`dense_switch_moe` through the one-hot einsums of the
    reference: ``O(s * E * C)`` memory, for tests and small checks."""
    n, _ = x.shape
    num_experts = expert_params["w_up"].shape[0]
    slice_len = n // num_slices
    cap = capacity(router_type, capacity_factor, top_k, slice_len, num_experts)
    w_up = expert_params["w_up"].float()
    w_down = expert_params["w_down"].float()
    outs, auxes = [], []
    for i in range(num_slices):
        x_local = x[i * slice_len : (i + 1) * slice_len]
        if router_type == "experts":
            dispatch, combine, aux = expert_choice_routing_onehot(
                x_local, router, num_experts, cap
            )
        else:
            dispatch, combine, aux = routing_onehot(
                x_local, router, num_experts, cap, top_k
            )
        sent = torch.einsum("sec,sd->ecd", dispatch, x_local.float())
        hidden = activation(torch.einsum("ecd,edf->ecf", sent, w_up))
        expert_out = torch.einsum("ecf,efd->ecd", hidden, w_down)
        out_local = torch.einsum("sec,ecd->sd", combine, expert_out)
        routed = torch.einsum("sec->s", combine) > 0
        outs.append(torch.where(routed[:, None], out_local, x_local.float()))
        auxes.append(aux)
    out = torch.cat(outs, dim=0).to(x.dtype)
    if return_aux:
        return out, torch.stack(auxes).mean()
    return out


def onehot_from_routing(routing: Routing, num_tokens, num_experts, cap):
    """The ``(dispatch, combine)`` one-hot tensors a routing stands for
    (kept pairs only), to hold the index form to the plain version."""
    device = routing.token.device
    dispatch = torch.zeros(num_tokens, num_experts * cap, device=device)
    combine = torch.zeros(num_tokens, num_experts * cap, device=device)
    token, slot = routing.token[routing.kept], routing.slot[routing.kept]
    dispatch.index_put_((token, slot), torch.ones_like(slot, dtype=torch.float32),
                        accumulate=True)
    combine.index_put_((token, slot), routing.weight[routing.kept].detach(),
                       accumulate=True)
    shape = (num_tokens, num_experts, cap)
    return dispatch.view(shape), combine.view(shape)
