"""Gradient noise scale statistics, the port of ``adaptdl_tpu.gns``.

Each step the trainer already holds every microbatch gradient, so the
two statistics the adaptive batch size needs fall out of it almost for
free: the mean squared norm of the individual microbatch gradients
(``local_sqr``) and the squared norm of the averaged gradient
(``total_sqr``), one scalar per parameter group riding the gradient
all-reduce.

With ``count = num_replicas * num_microbatches > 1`` independent
microbatch gradients of one atomic batch size:

    grad_sqr = (count * |g_mean|^2 - mean_i |g_i|^2) / (count - 1)
    grad_var = (mean_i |g_i|^2 - |g_mean|^2) * scale / (count - 1)

With ``count == 1`` consecutive steps are differenced instead: the
previous step's gradient rides in the state and (g_prev, g_curr) count
as a two-sample batch at twice the scale, flagged as biased so the
EMAs restart once real multi-sample estimates appear. Both EMAs are
bias-corrected and decay per unit of batch scale (theta ** scale).

Every function is a pure function of tensors with no host read, so the
step never waits on the device: branches are ``torch.where``.

Under the ZeRO storage modes: zero1 and zero3 keep the carry whole at
one replica and an empty placeholder (:func:`empty_prev_grad`) at more,
where ``count > 1`` never reads it; ``zero3_blocks`` keeps it in row
layout (n/dp per rank) at any replica count, and its squared norms are
:func:`rows_normsqr`, local row sums all-reduced.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from adaptdl_tpu_torch import collective

VAR_FLOOR = 1e-6


@dataclass(frozen=True)
class GNSState:
    """EMA state of the two statistics, per param group (shape (G,)),
    plus the differenced-mode carry (``prev_grad`` has the params'
    structure: a list of float32 tensors in parameter order)."""

    sqr_biased: torch.Tensor
    sqr_unbias: torch.Tensor
    var_biased: torch.Tensor
    var_unbias: torch.Tensor
    ema_is_biased: torch.Tensor  # bool: the EMAs hold differenced estimates
    prev_grad: list
    prev_grad_valid: torch.Tensor  # bool

    def tensors(self) -> dict:
        """Field name -> tensor (``prev_grad`` as a list)."""
        return {
            "sqr_biased": self.sqr_biased,
            "sqr_unbias": self.sqr_unbias,
            "var_biased": self.var_biased,
            "var_unbias": self.var_unbias,
            "ema_is_biased": self.ema_is_biased,
            "prev_grad": list(self.prev_grad),
            "prev_grad_valid": self.prev_grad_valid,
        }


def init(params, num_groups: int = 1) -> GNSState:
    params = list(params)
    device = params[0].device if params else torch.device("cpu")

    def zeros():
        return torch.zeros((num_groups,), dtype=torch.float32, device=device)

    def false():
        return torch.zeros((), dtype=torch.bool, device=device)

    return GNSState(
        sqr_biased=zeros(),
        sqr_unbias=zeros(),
        var_biased=zeros(),
        var_unbias=zeros(),
        ema_is_biased=false(),
        prev_grad=[
            torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in params
        ],
        prev_grad_valid=false(),
    )


def empty_prev_grad(params) -> list:
    """The differenced carry's placeholder under zero1 and zero3 at more
    than one replica (and in their checkpoints): one ``(1,)`` zero per
    parameter, never read."""
    return [
        torch.zeros((1,), dtype=torch.float32, device=p.device) for p in params
    ]


def is_placeholder(prev_grad, shapes) -> bool:
    """Whether ``prev_grad`` is :func:`empty_prev_grad`'s layout for
    parameters of ``shapes``."""
    prev_grad = list(prev_grad)
    return len(prev_grad) == len(shapes) and any(
        tuple(t.shape) == (1,) and tuple(s) != (1,)
        for t, s in zip(prev_grad, shapes)
    )


def rows_normsqr(tensors, precond=None, group=None) -> torch.Tensor:
    """Squared norm, shape (1,), of a gradient held as disjoint rows on
    each replica (``zero3_blocks``): the local sum of squares,
    all-reduced over ``group``, the data group (pad positions carry
    zeros; the seq ranks of a replica hold the same rows)."""
    tensors = list(tensors)
    local = group_normsqr(tensors, [0] * len(tensors), 1, precond)
    return collective.allreduce_sum(local, group=group)


def normalize_groups(state: GNSState, num_groups: int) -> GNSState:
    """``state`` with its four statistics at ``num_groups`` groups: a
    scalar or one-group statistic (a checkpoint without groups) seeds
    every group; any other size must already match."""

    def fix(x: torch.Tensor) -> torch.Tensor:
        if x.numel() == 1:
            return x.reshape(1).float().expand(num_groups).clone()
        if tuple(x.shape) != (num_groups,):
            raise ValueError(
                f"GNS statistics have {x.shape[0]} groups; trainer "
                f"declares {num_groups}"
            )
        return x

    return replace(
        state,
        sqr_biased=fix(state.sqr_biased),
        sqr_unbias=fix(state.sqr_unbias),
        var_biased=fix(state.var_biased),
        var_unbias=fix(state.var_unbias),
    )


def raw_sqr_avg(state: GNSState) -> torch.Tensor:
    """Per-group debiased estimates of |E g|^2, shape (G,)."""
    positive = state.sqr_unbias > 0
    avg = torch.where(
        positive,
        state.sqr_biased / torch.where(positive, state.sqr_unbias, 1.0),
        0.0,
    )
    return torch.clamp(avg, min=0.0)


def raw_var_avg(state: GNSState) -> torch.Tensor:
    """Per-group debiased estimates of tr(Var g), shape (G,)."""
    positive = state.var_unbias > 0
    avg = torch.where(
        positive,
        state.var_biased / torch.where(positive, state.var_unbias, 1.0),
        VAR_FLOOR,
    )
    return torch.clamp(avg, min=VAR_FLOOR)


def sqr_avg(state: GNSState) -> torch.Tensor:
    """Debiased total |E g|^2 (sum over groups, >= 0)."""
    return raw_sqr_avg(state).sum()


def var_avg(state: GNSState) -> torch.Tensor:
    """Debiased total tr(Var g) (floored away from 0)."""
    return raw_var_avg(state).sum()


def gain(state: GNSState, scale) -> torch.Tensor:
    """Statistical speedup of training at ``scale`` x the initial batch
    size, in [1, scale], from the total signal and noise."""
    var = var_avg(state)
    sqr = sqr_avg(state)
    return (var + sqr) / (var / scale + sqr)


def per_group_gain(state: GNSState, scale) -> torch.Tensor:
    """Per-group gain ratios, shape (G,)."""
    var = raw_var_avg(state)
    sqr = raw_sqr_avg(state)
    return (var + sqr) / (var / scale + sqr)


def _sq(g: torch.Tensor, p: torch.Tensor | None) -> torch.Tensor:
    g32 = g.float()
    if p is not None:
        g32 = g32 / p
    return g32.square().sum()


def normsqr(tensors, precond=None) -> torch.Tensor:
    """Sum of squared entries, optionally preconditioned elementwise."""
    tensors = list(tensors)
    pre = list(precond) if precond is not None else [None] * len(tensors)
    return torch.stack([_sq(g, p) for g, p in zip(tensors, pre)]).sum()


def group_normsqr(
    tensors, group_ids, num_groups: int, precond=None
) -> torch.Tensor:
    """Per-group sums of squared entries, shape (G,); ``group_ids``
    aligns with ``tensors``."""
    tensors = list(tensors)
    pre = list(precond) if precond is not None else [None] * len(tensors)
    terms = [[] for _ in range(num_groups)]
    for gid, g, p in zip(group_ids, tensors, pre):
        terms[gid].append(_sq(g, p))
    device = tensors[0].device
    return torch.stack(
        [
            torch.stack(t).sum() if t
            else torch.zeros((), dtype=torch.float32, device=device)
            for t in terms
        ]
    )


def _apply_estimates(
    state: GNSState, grad_sqr, grad_var, theta: float, now_biased: bool
) -> GNSState:
    """Push one (grad_sqr, grad_var) sample into the EMAs, restarting
    them when switching from differenced to real estimates. A
    non-finite value in any group skips the whole sample."""
    finite = torch.all(torch.isfinite(grad_sqr) & torch.isfinite(grad_var))
    reset = state.ema_is_biased & (not now_biased)

    def ema(biased, unbias, value):
        biased = torch.where(reset, 0.0, biased)
        unbias = torch.where(reset, 0.0, unbias)
        return (
            theta * biased + (1 - theta) * value,
            theta * unbias + (1 - theta),
        )

    new_sqr_b, new_sqr_u = ema(state.sqr_biased, state.sqr_unbias, grad_sqr)
    new_var_b, new_var_u = ema(state.var_biased, state.var_unbias, grad_var)
    return replace(
        state,
        sqr_biased=torch.where(finite, new_sqr_b, state.sqr_biased),
        sqr_unbias=torch.where(finite, new_sqr_u, state.sqr_unbias),
        var_biased=torch.where(finite, new_var_b, state.var_biased),
        var_unbias=torch.where(finite, new_var_u, state.var_unbias),
        ema_is_biased=torch.where(
            finite, torch.full_like(state.ema_is_biased, now_biased),
            state.ema_is_biased,
        ),
    )


def update(
    state: GNSState,
    grads_mean,
    local_sqr_mean: torch.Tensor,
    *,
    count: int,
    accum_scale: float,
    num_microbatches: int,
    smoothing: float = 0.999,
    precond=None,
    group_ids=None,
    num_groups: int = 1,
    normsqr_fn=None,
) -> GNSState:
    """One GNS update after a synchronized optimizer step.

    Args:
      state: current GNSState.
      grads_mean: the fully averaged gradient (list in parameter order).
      local_sqr_mean: per-group mean over all ``count`` microbatch
        gradients of the preconditioned squared norm, shape (G,).
      count: num_replicas * num_microbatches.
      accum_scale: num_replicas * atomic_bsz / init_batch_size.
      num_microbatches: accum_steps + 1.
      smoothing: per-unit-scale EMA retention.
      precond: optional preconditioner list (Adam second moments).
      group_ids: parameter-aligned group assignment (default: all 0).
      num_groups: G.
      normsqr_fn: ``(tensors, precond) -> (G,)`` squared norms in place
        of the per-group sums (``rows_normsqr`` under zero3_blocks).
    """
    grads_mean = list(grads_mean)
    if group_ids is None:
        group_ids = [0] * len(grads_mean)
    local_sqr_mean = local_sqr_mean.float().reshape(num_groups)

    def norm(tensors):
        if normsqr_fn is not None:
            return normsqr_fn(tensors, precond)
        return group_normsqr(tensors, group_ids, num_groups, precond)

    scale = accum_scale * num_microbatches
    if count > 1:
        total_sqr = norm(grads_mean)
        grad_sqr = (count * total_sqr - local_sqr_mean) / (count - 1)
        grad_var = (local_sqr_mean - total_sqr) * scale / (count - 1)
        new_state = _apply_estimates(
            state, grad_sqr, grad_var, smoothing**scale, False
        )
        # The differenced carry is stale once real estimates flow.
        return replace(
            new_state,
            prev_grad_valid=torch.zeros_like(state.prev_grad_valid),
        )

    # Single-sample configuration: difference consecutive gradients.
    prev = state.prev_grad
    curr_sqr = norm(grads_mean)
    pair_local = (norm(prev) + curr_sqr) / 2
    pair_total = norm([(a + b) / 2 for a, b in zip(prev, grads_mean)])
    d_scale = 2 * accum_scale
    grad_sqr = 2 * pair_total - pair_local
    grad_var = (pair_local - pair_total) * d_scale
    paired = _apply_estimates(
        state, grad_sqr, grad_var, smoothing**d_scale, True
    )
    valid = state.prev_grad_valid
    fields = ("sqr_biased", "sqr_unbias", "var_biased", "var_unbias",
              "ema_is_biased")
    new_state = replace(
        state,
        **{
            name: torch.where(
                valid, getattr(paired, name), getattr(state, name)
            )
            for name in fields
        },
    )
    return replace(
        new_state,
        prev_grad=[g.float() for g in grads_mean],
        prev_grad_valid=torch.ones_like(state.prev_grad_valid),
    )
