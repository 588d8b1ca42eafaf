"""AdamW with the semantics of ``optax.adamw(lr)``.

The JAX trainer steps ``optax.adamw(lr)`` (b1 0.9, b2 0.999, eps 1e-8
added outside the square root, weight decay 1e-4 -- optax's default,
not PyTorch's 1e-2) and then multiplies each parameter group's whole
update, decay term included, by that group's scaling-rule factor.

This is a small ``torch.optim.Optimizer`` subclass rather than
``torch.optim.AdamW`` with a tensor ``lr``: the factor arrives as a
device tensor every step, and applying it here keeps the update's
arithmetic in optax's order (``p - factor * lr * (mu_hat / (sqrt(nu_hat)
+ eps) + wd * p)``) without a host read and without depending on the
tensor-``lr`` code paths of a particular PyTorch version. The second
moments stay reachable (:meth:`second_moments`) for the trainer's Adam
preconditioner of the gradient-noise statistics.
"""

from __future__ import annotations

import torch


class AdamW(torch.optim.Optimizer):
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

    def params(self) -> list[torch.Tensor]:
        """Every parameter, in step order."""
        return [p for group in self.param_groups for p in group["params"]]

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

    @torch.no_grad()
    def step(self, lr_factors=None):
        """One update from ``p.grad``. ``lr_factors``: optional sequence
        of scalar tensors aligned with :meth:`params`, each multiplying
        that parameter's whole update."""
        params = self.params()
        if lr_factors is None:
            lr_factors = [None] * len(params)
        factor_of = dict(zip(map(id, params), lr_factors))
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad.float()
                state = self._state(p)
                state["step"] += 1
                mu = (1 - b1) * g + b1 * state["exp_avg"]
                nu = (1 - b2) * g.square() + b2 * state["exp_avg_sq"]
                state["exp_avg"].copy_(mu)
                state["exp_avg_sq"].copy_(nu)
                mu_hat = mu / (1 - torch.pow(b1, state["step"]))
                nu_hat = nu / (1 - torch.pow(b2, state["step"]))
                update = mu_hat / (torch.sqrt(nu_hat) + eps) + wd * p
                update = -lr * update
                factor = factor_of[id(p)]
                if factor is not None:
                    update = update * factor
                p.add_(update.to(p.dtype))
