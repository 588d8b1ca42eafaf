"""Where the fitted throughput's excess over the measured one comes from.

On the card the fit of phase 6 reads 12-27 % above the measured
throughput at (32, 0). Here the port's ``metrics`` and the JAX
``adaptdl_tpu.metrics`` take the same recorded timings, in phase 6's
order (a calibration, the (32, 0) steps, the re-optimisation's (16, 1)
calibration and steps): their profile entries are equal, sum for sum and
count for count, and so are their fitted throughputs (rtol 1e-6). So
the port records what the JAX package records from the same timings,
and the gap lies in the timings themselves. The fit follows the
calibration: with the compute-only microbatch time equal to the step
time it predicts the measured throughput within 1 %, and a calibration
25 % shorter than the step (the step also runs the optimizer update,
the statistics and the loader's host work, which the calibration does
not) makes both packages predict more than 10 % above it.
"""

import numpy as np
import pytest

from adaptdl_tpu import metrics as jax_metrics
from adaptdl_tpu.goodput import GoodputFunction as JaxGoodput
from adaptdl_tpu.goodput import PerfParams as JaxPerfParams
from adaptdl_tpu_torch import metrics
from adaptdl_tpu_torch.goodput import GoodputFunction, PerfParams
from tests.torch_support import private_tempdir  # noqa: F401

GRAD = (0.1, 1.0)


@pytest.fixture(autouse=True)
def _no_refits(monkeypatch):
    """Fit only when the test asks; no refit thread, no posts."""
    monkeypatch.setenv("ADAPTDL_FIT_INTERVAL", "1e9")
    monkeypatch.delenv("ADAPTDL_SUPERVISOR_URL", raising=False)
    for module in (metrics, jax_metrics):
        module._reset_state()
    yield
    for module in (metrics, jax_metrics):
        module._reset_state()


def _record(module, calibration_s, step_s):
    """Phase 6's sequence of recorded timings."""
    module.set_batch_size_config(32, 1024, (4, 128), True)
    module.profile_accum_time(32, calibration_s)
    for k in range(8):
        module.profile_step(32, 0, step_s * (1 + 0.01 * (k % 3)))
    module.profile_accum_time(16, calibration_s * 0.52)
    for k in range(5):
        module.profile_step(16, 1, step_s * (1.1 + 0.01 * (k % 2)))


def _profile(module):
    return {
        key: vars(entry).copy()
        for key, entry in module.current_state().profile.items()
    }


def _fitted_over_measured(calibration_s, step_s):
    """Each package's fitted throughput at (32, 0) over the measured."""
    _record(jax_metrics, calibration_s, step_s)
    _record(metrics, calibration_s, step_s)
    assert _profile(metrics) == _profile(jax_metrics)
    ours = GoodputFunction(PerfParams(*metrics._fit()), GRAD, 32)
    theirs = JaxGoodput(JaxPerfParams(*jax_metrics._fit()), GRAD, 32)
    measured = 32 / step_s
    return (ours.throughput(1, 1, 32, 0) / measured,
            theirs.throughput(1, 1, 32, 0) / measured)


@pytest.mark.parametrize("calibration_s,step_s", [
    (0.2, 0.2), (0.17, 0.2), (0.15, 0.2), (0.12, 0.25),
])
def test_the_same_timings_give_the_same_profile_and_fit(calibration_s, step_s):
    ours, theirs = _fitted_over_measured(calibration_s, step_s)
    np.testing.assert_allclose(ours, theirs, rtol=1e-6)


def test_the_fit_follows_the_calibration():
    equal, _ = _fitted_over_measured(0.2, 0.2)
    assert abs(equal - 1.0) < 0.01
    for module in (metrics, jax_metrics):
        module._reset_state()
    shorter, theirs = _fitted_over_measured(0.15, 0.2)
    assert shorter > 1.10 and theirs > 1.10
