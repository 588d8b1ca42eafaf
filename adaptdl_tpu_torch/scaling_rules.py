"""Learning-rate scaling rules for adaptive batch sizes.

When the goodput optimizer grows the global batch by ``scale``x, the
learning rate must follow. Each rule is a function of the step's
training statistics returning a multiplicative LR factor as a device
tensor, which the trainer applies to the optimizer update (no host
read). Formulas as in ``adaptdl_tpu.scaling_rules``:

- AdaScale: factor = gain(scale), the gradient-noise-aware rule.
- AdamScale: AdaScale ** 0.5, the variant for Adam/AdamW/RMSProp.
- LinearScale / SqrtScale: classic heuristics.
- LEGWScale: sqrt(scale) with a warmup proportional to scale.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from adaptdl_tpu_torch import gns


class RuleContext(NamedTuple):
    """Everything a rule may consult. ``scale``/``batch_size`` are host
    numbers fixed per step configuration; the rest are device tensors."""

    scale: float  # global_bsz / init_batch_size
    batch_size: int  # current global batch size
    init_batch_size: int
    gns_state: gns.GNSState
    progress: torch.Tensor  # scale-invariant steps taken


def _tensor(value, ctx: RuleContext) -> torch.Tensor:
    return torch.as_tensor(
        value, dtype=torch.float32, device=ctx.gns_state.sqr_biased.device
    )


class ScalingRule:
    """Base: no scaling (factor 1)."""

    def lr_factor(self, ctx: RuleContext) -> torch.Tensor:
        """Scalar factor (logging / single-group application)."""
        return _tensor(1.0, ctx)

    def lr_factor_groups(self, ctx: RuleContext) -> torch.Tensor:
        """Per-param-group factors, shape (G,): the scalar factor
        broadcast, unless a noise-aware rule overrides it."""
        num_groups = ctx.gns_state.sqr_biased.shape[0]
        return self.lr_factor(ctx).expand(num_groups)


class AdaScale(ScalingRule):
    def lr_factor(self, ctx: RuleContext) -> torch.Tensor:
        return gns.gain(ctx.gns_state, ctx.scale)

    def lr_factor_groups(self, ctx: RuleContext) -> torch.Tensor:
        # Each group's gain from its own signal/noise ratio.
        return gns.per_group_gain(ctx.gns_state, ctx.scale)


class AdamScale(AdaScale):
    def __init__(self, power: float = 0.5):
        self.power = power

    def lr_factor(self, ctx: RuleContext) -> torch.Tensor:
        return super().lr_factor(ctx) ** self.power

    def lr_factor_groups(self, ctx: RuleContext) -> torch.Tensor:
        return super().lr_factor_groups(ctx) ** self.power


class LinearScale(ScalingRule):
    def lr_factor(self, ctx: RuleContext) -> torch.Tensor:
        return _tensor(ctx.scale, ctx)


class SqrtScale(ScalingRule):
    def lr_factor(self, ctx: RuleContext) -> torch.Tensor:
        return _tensor(ctx.scale, ctx) ** 0.5


class LEGWScale(ScalingRule):
    """sqrt(scale) target with a warmup stretched by ``scale``:

        warmup (scale-invariant steps) =
            base_warmup_epochs * scale * data_size / batch_size

    compared against progress, which advances by the gain per step.
    """

    def __init__(self, base_warmup_epochs: float, data_size: int):
        self.base_warmup_epochs = base_warmup_epochs
        self.data_size = data_size

    def lr_factor(self, ctx: RuleContext) -> torch.Tensor:
        total_steps = (
            self.base_warmup_epochs * ctx.scale * self.data_size
            / ctx.batch_size
        )
        max_factor = ctx.scale**0.5
        ratio = torch.clamp(
            _tensor(ctx.progress, ctx) / total_steps, max=1.0
        )
        return max_factor * ratio
