"""The port's gradient-noise statistics against the JAX package's.

The same numpy gradients go through ``adaptdl_tpu.gns.update`` and
``adaptdl_tpu_torch.gns.update`` for several steps, and every
``GNSState`` field must agree: one and two parameter groups, the
unbiased (count > 1) and differenced (count == 1) estimators and the
switch between them, with and without an Adam-style preconditioner,
and a non-finite sample that must be skipped. Tolerance rtol 1e-4: the
estimators difference squared norms summed in another order, which
amplifies float32 rounding.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adaptdl_tpu import gns as jgns
from adaptdl_tpu_torch import gns as tgns
from tests.torch_support import private_tempdir  # noqa: F401

SHAPES = [(3, 4), (5,), (2, 2, 2)]


def _draw(rng, scale=1.0):
    return [rng.normal(size=s).astype(np.float32) * scale for s in SHAPES]


def _run(schedule, group_ids, precond_on, poison_step=None, seed=0):
    rng = np.random.default_rng(seed)
    num_groups = max(group_ids) + 1
    params = _draw(rng)
    precond = (
        [rng.uniform(0.5, 2.0, size=s).astype(np.float32) for s in SHAPES]
        if precond_on else None
    )
    jstate = jgns.init([jnp.asarray(p) for p in params], num_groups)
    tstate = tgns.init([torch.from_numpy(p) for p in params], num_groups)
    snapshots = []
    for step, count in enumerate(schedule):
        micro = [_draw(rng, 0.1) for _ in range(count)]
        for g in micro:
            for i in range(len(g)):
                g[i] = g[i] + params[i] * 0.05  # a shared signal
        if step == poison_step:
            micro[0][1][0] = np.inf
        mean = [np.mean([m[i] for m in micro], axis=0) for i in range(len(SHAPES))]
        local = np.mean(
            [
                np.asarray(jgns.group_normsqr(
                    m, tuple(group_ids), num_groups, precond
                ))
                for m in micro
            ],
            axis=0,
        ).astype(np.float32)
        kwargs = dict(count=count, accum_scale=0.5, num_microbatches=count,
                      smoothing=0.9, group_ids=tuple(group_ids),
                      num_groups=num_groups)
        jstate = jgns.update(
            jstate, [jnp.asarray(m) for m in mean], jnp.asarray(local),
            precond=None if precond is None else [jnp.asarray(p) for p in precond],
            **kwargs,
        )
        tstate = tgns.update(
            tstate, [torch.from_numpy(m) for m in mean], torch.from_numpy(local),
            precond=None if precond is None else [torch.from_numpy(p) for p in precond],
            **kwargs,
        )
        snapshots.append((jstate, tstate))
    return snapshots


def _assert_same(jstate, tstate):
    for name in ("sqr_biased", "sqr_unbias", "var_biased", "var_unbias"):
        np.testing.assert_allclose(
            getattr(tstate, name).numpy(), np.asarray(getattr(jstate, name)),
            rtol=1e-4, atol=1e-7, err_msg=name,
        )
    for name in ("ema_is_biased", "prev_grad_valid"):
        assert bool(getattr(tstate, name)) == bool(getattr(jstate, name)), name
    for a, b in zip(tstate.prev_grad, jstate.prev_grad):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    for fn in ("sqr_avg", "var_avg"):
        np.testing.assert_allclose(
            float(getattr(tgns, fn)(tstate)), float(getattr(jgns, fn)(jstate)),
            rtol=1e-4, err_msg=fn,
        )
    for scale in (1.0, 3.0):
        np.testing.assert_allclose(
            float(tgns.gain(tstate, scale)), float(jgns.gain(jstate, scale)),
            rtol=1e-4,
        )
        np.testing.assert_allclose(
            tgns.per_group_gain(tstate, scale).numpy(),
            np.asarray(jgns.per_group_gain(jstate, scale)), rtol=1e-4,
        )


@pytest.mark.parametrize("group_ids", [(0, 0, 0), (0, 1, 1)])
@pytest.mark.parametrize("precond_on", [False, True])
@pytest.mark.parametrize(
    "schedule",
    [(1, 1, 1, 1), (4, 4, 4), (1, 1, 2, 2)],
    ids=["differenced", "unbiased", "switch"],
)
def test_every_field_matches_jax(schedule, group_ids, precond_on):
    for jstate, tstate in _run(schedule, group_ids, precond_on):
        _assert_same(jstate, tstate)


@pytest.mark.parametrize("schedule", [(1, 1, 1, 1), (3, 3, 3)])
def test_non_finite_sample_is_skipped_like_jax(schedule):
    snapshots = _run(schedule, (0, 1, 1), True, poison_step=2)
    for jstate, tstate in snapshots:
        _assert_same(jstate, tstate)
    (_, before), (_, after) = snapshots[1], snapshots[2]
    assert torch.equal(before.sqr_biased, after.sqr_biased)
    assert torch.equal(before.var_biased, after.var_biased)


def test_normsqr_matches_jax():
    rng = np.random.default_rng(5)
    grads = _draw(rng)
    pre = [rng.uniform(0.5, 2.0, size=s).astype(np.float32) for s in SHAPES]
    for precond in (None, pre):
        want = jgns.normsqr(
            [jnp.asarray(g) for g in grads],
            None if precond is None else [jnp.asarray(p) for p in precond],
        )
        got = tgns.normsqr(
            [torch.from_numpy(g) for g in grads],
            None if precond is None else [torch.from_numpy(p) for p in precond],
        )
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
