"""The port's goodput model and perf-param fit against the JAX package's.

The fit runs on the profiles of ``tests/test_goodput.py``
(``test_fit_round_trip`` and the no-multi-node priors): the port's
torch-autograd objective under L-BFGS-B must land where the JAX fit
lands. Two optimizers stopping on the same flat valley differ in the
poorly identified terms, so the comparison is on what the fit is for:
predicted throughput across the observed envelope within 1%, the
well-identified compute terms within 1%, and the same pinned priors.
The model formulas themselves (numpy in both) agree exactly.
"""

import numpy as np
import pytest

from adaptdl_tpu import goodput as jgoodput
from adaptdl_tpu_torch import goodput as tgoodput
from tests.test_goodput import GRAD, INIT_BSZ, PERF, _synthetic_measurements
from tests.torch_support import private_tempdir  # noqa: F401

ENVELOPE = [(1, 1, 64), (1, 2, 128), (1, 8, 64), (2, 16, 256), (4, 16, 128)]


def test_fit_round_trip_matches_jax():
    data = _synthetic_measurements(PERF, np.random.default_rng(0))
    want = jgoodput.fit_perf_params(*data)
    got = tgoodput.fit_perf_params(*data)
    np.testing.assert_allclose(got.alpha_c, want.alpha_c, rtol=1e-2)
    np.testing.assert_allclose(got.beta_c, want.beta_c, rtol=1e-2)
    np.testing.assert_allclose(got.gamma, want.gamma, rtol=1e-2)
    got_fn = tgoodput.GoodputFunction(got, GRAD, INIT_BSZ)
    want_fn = jgoodput.GoodputFunction(want, GRAD, INIT_BSZ)
    for n, r, b in ENVELOPE:
        np.testing.assert_allclose(
            got_fn.throughput(n, r, b, 0), want_fn.throughput(n, r, b, 0),
            rtol=1e-2, err_msg=str((n, r, b)),
        )


def test_fit_without_multinode_observations_pins_the_same_priors():
    nodes = np.ones(6, dtype=int)
    replicas = np.array([1, 2, 2, 4, 4, 8])
    bsz = np.array([64, 64, 128, 128, 256, 256])
    t_acc = PERF.alpha_c + PERF.beta_c * bsz
    t_net = jgoodput._network_time(np, PERF, nodes, replicas)
    t_opt = np.exp(jgoodput._log_optim_time(np, PERF, t_acc, t_net))
    want = jgoodput.fit_perf_params(nodes, replicas, bsz, t_acc, t_opt)
    got = tgoodput.fit_perf_params(nodes, replicas, bsz, t_acc, t_opt)
    assert got.alpha_n >= 1.1 * got.alpha_r - 1e-12
    assert got.beta_n >= 1.1 * got.beta_r - 1e-12
    # Unobserved sharding axes keep the same floor in both fits.
    for field in ("beta_sp", "beta_tp", "beta_pp", "beta_ep"):
        assert getattr(got, field) == getattr(want, field) == 1e-8
    got_fn = tgoodput.GoodputFunction(got, GRAD, INIT_BSZ)
    want_fn = jgoodput.GoodputFunction(want, GRAD, INIT_BSZ)
    for r, b in zip(replicas, bsz):
        np.testing.assert_allclose(
            got_fn.throughput(1, r, b, 0), want_fn.throughput(1, r, b, 0),
            rtol=1e-2,
        )


@pytest.mark.parametrize("accumulation", [False, True])
def test_goodput_function_is_the_same_model(accumulation):
    got = tgoodput.GoodputFunction(PERF, GRAD, INIT_BSZ)
    want = jgoodput.GoodputFunction(PERF, GRAD, INIT_BSZ)
    for n, r, b in ENVELOPE:
        for accum in (0, 2):
            if r * b * (accum + 1) < INIT_BSZ:
                continue
            assert got(n, r, b, accum) == want(n, r, b, accum)
    kwargs = dict(max_batch_size=4096, atomic_bsz_range=(32, 256),
                  accumulation=accumulation)
    nodes, replicas = np.array([1, 1, 2]), np.array([1, 4, 16])
    for a, b in zip(got.optimize(nodes, replicas, **kwargs),
                    want.optimize(nodes, replicas, **kwargs)):
        np.testing.assert_array_equal(a, b)
