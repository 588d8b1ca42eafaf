"""The port's optimizers against optax, with the trainer's LR factor.

``SGD`` (without momentum, and with momentum 0.9), ``Adam(b1=0.5)`` and
``AdamW`` take five steps from the same parameters on the same numpy
gradients (seeded) as ``optax.sgd`` / ``optax.adam`` / ``optax.adamw``,
each step's update multiplied by a factor that changes every step, as
the JAX trainer scales the whole update (``adaptdl_tpu/trainer.py:
1580-1597``). Parameters and the momentum / moment buffers agree to
``rtol=1e-6, atol=1e-7`` (float32, a few roundings per step).
"""

import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from adaptdl_tpu_torch.optim import SGD, Adam, AdamW
from tests.torch_support import private_tempdir  # noqa: F401

FACTORS = [1.0, 0.5, 2.5, 1.25, 0.1]
TOL = dict(rtol=1e-6, atol=1e-7)


def _run(make_port, jax_opt, shapes=((3, 4), (5,))):
    rng = np.random.default_rng(0)
    init = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [
        [rng.normal(size=s).astype(np.float32) for s in shapes] for _ in FACTORS
    ]
    params = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in init]
    opt = make_port(params)
    jparams = [jnp.asarray(x) for x in init]
    jstate = jax_opt.init(jparams)
    for factor, g in zip(FACTORS, grads):
        for p, gi in zip(params, g):
            p.grad = torch.from_numpy(gi)
        opt.step([torch.tensor(factor)] * len(params))
        updates, jstate = jax_opt.update([jnp.asarray(x) for x in g], jstate, jparams)
        updates = [(u.astype(jnp.float32) * factor).astype(u.dtype) for u in updates]
        jparams = optax.apply_updates(jparams, updates)
    for p, want in zip(params, jparams):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want), **TOL)
    return opt, params, jstate


@pytest.mark.parametrize("momentum", [None, 0.9])
def test_sgd_matches_optax(momentum):
    opt, params, jstate = _run(
        lambda ps: SGD(ps, lr=0.1, momentum=momentum),
        optax.sgd(0.1, momentum=momentum),
    )
    if momentum is None:
        assert not opt.state
    else:
        # The trace never sees the factor: optax's trace state.
        trace = jstate[0].trace
        for p, want in zip(params, trace):
            np.testing.assert_allclose(
                opt.state[p]["momentum_buffer"].numpy(), np.asarray(want), **TOL
            )
    assert not hasattr(opt, "second_moments")


def test_adam_b1_half_matches_optax():
    opt, params, jstate = _run(
        lambda ps: Adam(ps, lr=2e-4, b1=0.5), optax.adam(2e-4, b1=0.5)
    )
    adam_state = jstate[0]
    for p, mu, nu in zip(params, adam_state.mu, adam_state.nu):
        np.testing.assert_allclose(opt.state[p]["exp_avg"].numpy(), np.asarray(mu), **TOL)
        np.testing.assert_allclose(opt.state[p]["exp_avg_sq"].numpy(), np.asarray(nu), **TOL)
    assert all(
        t is opt.state[p]["exp_avg_sq"]
        for p, t in zip(params, opt.second_moments())
    )


def test_adamw_matches_optax():
    _run(lambda ps: AdamW(ps, lr=3e-4), optax.adamw(3e-4))


def test_sgd_momentum_survives_a_state_dict_round_trip():
    rng = np.random.default_rng(1)
    params = [torch.nn.Parameter(torch.from_numpy(rng.normal(size=4).astype(np.float32)))]
    opt = SGD(params, lr=0.1, momentum=0.9)
    params[0].grad = torch.ones(4)
    opt.step()
    twin_params = [torch.nn.Parameter(params[0].detach().clone())]
    twin = SGD(twin_params, lr=0.1, momentum=0.9)
    saved = io.BytesIO()
    torch.save(opt.state_dict(), saved)
    saved.seek(0)
    twin.load_state_dict(torch.load(saved, weights_only=True))
    for o, p in ((opt, params[0]), (twin, twin_params[0])):
        p.grad = torch.full((4,), 0.5)
        o.step()
    assert torch.equal(params[0], twin_params[0])
