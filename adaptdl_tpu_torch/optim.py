"""Optimizers with the semantics of ``optax.sgd``, ``optax.adam`` and
``optax.adamw``.

The JAX trainer steps an optax transformation and then multiplies each
parameter group's whole update by that group's scaling-rule factor
(``adaptdl_tpu/trainer.py:1580-1597``); the factor never reaches the
momentum or moment buffers. The port's optimizers take the factors as
an argument of :meth:`step` and apply them the same way:

- :class:`SGD` is ``optax.sgd(lr, momentum)``: the trace ``v <- g + m v``
  (nesterov off), update ``-lr v``; without momentum the update is
  ``-lr g``.
- :class:`AdamW` is ``optax.adamw(lr)`` (b1 0.9, b2 0.999, eps 1e-8
  added outside the square root, weight decay 1e-4 -- optax's default,
  not PyTorch's 1e-2): ``p - factor * lr * (mu_hat / (sqrt(nu_hat) +
  eps) + wd * p)``, decay term included in the scaled update.
- :class:`Adam` is ``optax.adam(lr, b1)``: AdamW without the decay term.

These are small ``torch.optim.Optimizer`` subclasses rather than the
stock optimizers with a tensor ``lr``: the factor arrives as a device
tensor every step, and applying it here keeps the update's arithmetic in
optax's order without a host read and without depending on the
tensor-``lr`` code paths of a particular PyTorch version. Adam's second
moments stay reachable (:meth:`AdamW.second_moments`) for the trainer's
Adam preconditioner of the gradient-noise statistics; an optimizer
without them cannot be preconditioned that way.

Under the trainer's ZeRO storage modes the optimizer steps flat rows:
:meth:`_FactorOptimizer.rebind` moves it from the model's parameters
onto this rank's ``[shard]`` parameter row (``[L, shard_b]`` and
``[shard_o]`` under ``zero3_blocks``), its moments become rows of the
same shape, and a factor may be a per-position tensor of the row's shape
(each position's parameter group's factor). The arithmetic is the
per-parameter update's, element by element, so at one replica a row
update equals the per-parameter update bit for bit.
"""

from __future__ import annotations

import torch


class _FactorOptimizer(torch.optim.Optimizer):
    """Steps ``p.grad`` into ``p`` with a per-parameter factor on the
    whole update; subclasses give the update."""

    def params(self) -> list[torch.Tensor]:
        """Every parameter, in step order."""
        return [p for group in self.param_groups for p in group["params"]]

    def _update(self, p, g, group) -> torch.Tensor:
        raise NotImplementedError

    def rebind(self, params: list[torch.Tensor]) -> None:
        """Step ``params`` (the ZeRO modes' rows) instead of the
        parameters this optimizer was built over: one param group, no
        state yet."""
        if len(self.param_groups) != 1:
            raise ValueError(
                "a ZeRO storage mode steps one flat row: the optimizer "
                f"must have one param group, not {len(self.param_groups)}"
            )
        if self.state:
            raise ValueError("rebind an optimizer before its first step")
        self.param_groups[0]["params"] = list(params)

    @torch.no_grad()
    def step(self, lr_factors=None):
        """One update from ``p.grad``. ``lr_factors``: optional sequence
        aligned with :meth:`params` of scalar tensors, or tensors of the
        parameter's shape (per-position factors of a row), each
        multiplying that parameter's whole update."""
        params = self.params()
        if lr_factors is None:
            lr_factors = [None] * len(params)
        factor_of = dict(zip(map(id, params), lr_factors))
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                update = self._update(p, p.grad.float(), group)
                factor = factor_of[id(p)]
                if factor is not None:
                    update = update * factor
                p.add_(update.to(p.dtype))


class SGD(_FactorOptimizer):
    def __init__(self, params, lr: float, momentum: float | None = None):
        super().__init__(params, dict(lr=lr, momentum=momentum))

    def _update(self, p, g, group):
        momentum = group["momentum"]
        if momentum is None:
            return -group["lr"] * g
        state = self.state[p]
        if not state:
            state["momentum_buffer"] = torch.zeros_like(p, dtype=torch.float32)
        trace = g + momentum * state["momentum_buffer"]
        state["momentum_buffer"].copy_(trace)
        return -group["lr"] * trace


class AdamW(_FactorOptimizer):
    def __init__(
        self,
        params,
        lr: float,
        betas: tuple[float, float] = (0.9, 0.999),
        eps: float = 1e-8,
        weight_decay: float = 1e-4,
    ):
        super().__init__(
            params,
            dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay),
        )

    def _state(self, p: torch.Tensor) -> dict:
        state = self.state[p]
        if not state:
            state["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
            state["exp_avg"] = torch.zeros_like(p, dtype=torch.float32)
            state["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
        return state

    def load_state_dict(self, state_dict) -> None:
        super().load_state_dict(state_dict)
        # PyTorch restores "step" where it was saved; keep it beside
        # its parameter so the update reads no host tensor.
        for p in self.params():
            if self.state.get(p):
                self.state[p]["step"] = self.state[p]["step"].to(p.device)

    def second_moments(self) -> list[torch.Tensor]:
        """Adam's ``nu`` for every parameter, in step order."""
        return [self._state(p)["exp_avg_sq"] for p in self.params()]

    def _update(self, p, g, group):
        b1, b2 = group["betas"]
        lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
        state = self._state(p)
        state["step"] += 1
        mu = (1 - b1) * g + b1 * state["exp_avg"]
        nu = (1 - b2) * g.square() + b2 * state["exp_avg_sq"]
        state["exp_avg"].copy_(mu)
        state["exp_avg_sq"].copy_(nu)
        mu_hat = mu / (1 - torch.pow(b1, state["step"]))
        nu_hat = nu / (1 - torch.pow(b2, state["step"]))
        update = mu_hat / (torch.sqrt(nu_hat) + eps)
        if wd:
            update = update + wd * p
        return -lr * update


class Adam(AdamW):
    """``optax.adam(lr, b1)``: AdamW with no weight decay."""

    def __init__(self, params, lr: float, b1: float = 0.9):
        super().__init__(params, lr, betas=(b1, 0.999), weight_decay=0.0)
