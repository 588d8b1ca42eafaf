"""The port's scaling rules against the JAX package's on a grid of
scale, progress and noise statistics (one and two parameter groups);
float32 factors agree to rtol 1e-6."""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adaptdl_tpu import gns as jgns
from adaptdl_tpu import scaling_rules as jrules
from adaptdl_tpu_torch import gns as tgns
from adaptdl_tpu_torch import scaling_rules as trules
from tests.torch_support import private_tempdir  # noqa: F401

RULES = {
    "none": lambda m: m.ScalingRule(),
    "adascale": lambda m: m.AdaScale(),
    "adamscale": lambda m: m.AdamScale(),
    "adamscale_0.7": lambda m: m.AdamScale(0.7),
    "linear": lambda m: m.LinearScale(),
    "sqrt": lambda m: m.SqrtScale(),
    "legw": lambda m: m.LEGWScale(2.0, 1000),
}

# (sqr_biased, sqr_unbias, var_biased, var_unbias) per group.
STATS = {
    "one_group": ([0.02], [0.5], [0.3], [0.5]),
    "two_groups": ([0.02, 0.004], [0.5, 0.5], [0.3, 0.01], [0.5, 0.5]),
    "fresh": ([0.0, 0.0], [0.0, 0.0], [0.0, 0.0], [0.0, 0.0]),
}


def _states(stats):
    arrays = [np.asarray(x, np.float32) for x in stats]
    jstate = jgns.GNSState(
        *map(jnp.asarray, arrays), jnp.zeros((), bool), [], jnp.zeros((), bool)
    )
    tstate = tgns.GNSState(
        *map(torch.from_numpy, arrays), torch.zeros((), dtype=torch.bool), [],
        torch.zeros((), dtype=torch.bool),
    )
    return jstate, tstate


@pytest.mark.parametrize("rule", sorted(RULES))
@pytest.mark.parametrize("stats", sorted(STATS))
def test_factors_match_jax_on_a_grid(rule, stats):
    jrule, trule = RULES[rule](jrules), RULES[rule](trules)
    jstate, tstate = _states(STATS[stats])
    for scale, progress in itertools.product((1.0, 2.0, 8.0), (0.0, 5.0, 50.0)):
        batch = int(32 * scale)
        jctx = jrules.RuleContext(scale, batch, 32, jstate, jnp.asarray(progress))
        tctx = trules.RuleContext(scale, batch, 32, tstate, torch.tensor(progress))
        np.testing.assert_allclose(
            float(trule.lr_factor(tctx)), float(jrule.lr_factor(jctx)),
            rtol=1e-6, err_msg=f"{rule} scale={scale} progress={progress}",
        )
        np.testing.assert_allclose(
            trule.lr_factor_groups(tctx).numpy(),
            np.asarray(jrule.lr_factor_groups(jctx)),
            rtol=1e-6, err_msg=f"{rule} groups scale={scale}",
        )
