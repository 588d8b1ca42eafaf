"""Numeric-health sentinel: NaN/loss-spike detection, last-known-good
rollback and incident reporting, the port of ``adaptdl_tpu.guard``.

Detection grades the values ``ElasticTrainer.run_step`` already pulls to
the host every ``metrics_every`` steps (the loss and the noise scale's
gradient statistics), so a healthy step pays a few float comparisons:

- **NaN/Inf**: loss or gradient statistics non-finite -> ``nan_loss`` /
  ``nan_grad``. Always armed.
- **Spike**: a finite loss more than ``ADAPTDL_GUARD_MAD_K`` robust
  sigmas (1.4826 x MAD) above the median of the last
  ``ADAPTDL_GUARD_WINDOW`` healthy losses -> ``loss_spike``. Arms once
  ``ADAPTDL_GUARD_MIN_SAMPLES`` healthy samples exist; upper side only.
  Unhealthy samples never enter the window.

``ADAPTDL_GUARD_POLICY`` decides the response: ``warn`` logs and
reports, ``skip`` also records the poisoned batch range so the sampler
never re-feeds it, ``rollback`` (the default) restores the newest
good-marked checkpoint (``checkpoint.rollback_to_good``) and then
records the range. A checkpoint earns its marker only after
``ADAPTDL_GUARD_CONFIRM_STEPS`` healthy observations; an incident
clears every pending candidate. Each incident is also reported
(best-effort) to the supervisor's ``POST /incident/{job}``.

At several replicas each process has its own guard. The loss and the
statistics are all-reduced in the step before they reach it, and fault
hit counts are per process, so every rank reaches the same verdict at
the same observation. Thread model: ``observe_step`` runs on the
training thread; ``guard_stats`` reads plain numbers and may run on the
fit thread.
"""

from __future__ import annotations

import logging
import math
from typing import Any

from adaptdl_tpu_torch import checkpoint, env, faults, rpc

LOG = logging.getLogger(__name__)

# Incident kinds (the wire vocabulary of the `incident` family).
KIND_NAN_LOSS = "nan_loss"
KIND_NAN_GRAD = "nan_grad"
KIND_LOSS_SPIKE = "loss_spike"

# The scaled median absolute deviation estimates a normal distribution's
# standard deviation.
_MAD_SIGMA = 1.4826


def _finite(value: Any) -> bool:
    try:
        return math.isfinite(float(value))
    except (TypeError, ValueError):
        return False


class NumericGuard:
    """Per-process health sentinel (module singleton below)."""

    def __init__(self) -> None:
        self.policy = env.guard_policy()
        self.window_size = env.guard_window()
        self.min_samples = env.guard_min_samples()
        self.mad_k = env.guard_mad_k()
        self._window: list[float] = []  # healthy losses, newest last
        self._observations = 0
        self.healthy_streak = 0
        self.unhealthy_steps = 0
        self.rollbacks = 0
        self.skipped_batches = 0
        self.incidents_by_kind: dict[str, int] = {}
        self.last_incident: dict[str, Any] | None = None

    # -- detection ----------------------------------------------------

    def _spike_bound(self) -> float | None:
        """Upper loss bound before a sample counts as a spike, or None
        while the detector is still collecting its baseline."""
        if len(self._window) < self.min_samples:
            return None
        ordered = sorted(self._window)
        n = len(ordered)
        median = (
            ordered[n // 2]
            if n % 2
            else 0.5 * (ordered[n // 2 - 1] + ordered[n // 2])
        )
        devs = sorted(abs(x - median) for x in ordered)
        mad = devs[n // 2] if n % 2 else 0.5 * (devs[n // 2 - 1] + devs[n // 2])
        # A flat window (MAD 0) still needs a usable bound: a small
        # fraction of the median's magnitude.
        scale = _MAD_SIGMA * mad or 0.01 * abs(median) or 1e-8
        return median + self.mad_k * scale

    def _classify(self, loss: Any, grad_sqr: Any, grad_var: Any) -> str | None:
        if loss is not None and not _finite(loss):
            return KIND_NAN_LOSS
        for stat in (grad_sqr, grad_var):
            if stat is not None and not _finite(stat):
                return KIND_NAN_GRAD
        if loss is not None:
            bound = self._spike_bound()
            if bound is not None and float(loss) > bound:
                return KIND_LOSS_SPIKE
        return None

    # -- the per-step entry point -------------------------------------

    def observe(
        self,
        loss: Any,
        grad_sqr: Any = None,
        grad_var: Any = None,
        dataloader: Any = None,
    ) -> dict[str, Any]:
        """Grade one step's health and apply the policy. Returns
        ``{"healthy", "kind", "action", "restored"}``; ``dataloader``
        supplies the poisoned batch span and receives the skip range."""
        if self.policy == "off":
            return {
                "healthy": True, "kind": None,
                "action": "off", "restored": None,
            }
        self._observations += 1
        # Injected faults SIMULATE the corruption: the guard consumes
        # them as a poisoned observation.
        try:
            faults.maybe_fail("guard.corrupt_grad")
        except faults.InjectedFault:
            grad_sqr = float("nan")
        try:
            faults.maybe_fail("guard.loss_spike")
        except faults.InjectedFault:
            loss = (abs(float(loss)) + 1.0) * 1e6 if _finite(loss) else loss

        kind = self._classify(loss, grad_sqr, grad_var)
        if kind is None:
            self.healthy_streak += 1
            if loss is not None:
                self._window.append(float(loss))
                if len(self._window) > self.window_size:
                    del self._window[: -self.window_size]
            checkpoint.note_healthy_step()
            return {
                "healthy": True, "kind": None,
                "action": None, "restored": None,
            }
        return self._handle_incident(kind, dataloader)

    def _handle_incident(self, kind: str, dataloader: Any) -> dict[str, Any]:
        from adaptdl_tpu_torch import metrics

        self.healthy_streak = 0
        self.unhealthy_steps += 1
        self.incidents_by_kind[kind] = self.incidents_by_kind.get(kind, 0) + 1
        # Every not-yet-confirmed checkpoint may already carry the
        # corruption.
        checkpoint.reset_health_confirmation()
        # Goodput hygiene: this step's profile sample stays out of the
        # guarded EWMAs and the fit.
        metrics.note_unhealthy_step()
        step = self._observations
        span = dataloader.current_batch_span() if dataloader is not None else None
        data_id = "{}:{}-{}".format(*span) if span is not None else None
        action = self.policy
        restored = None
        if self.policy == "rollback":
            restored = self._rollback()
            if restored is None:
                # No good checkpoint yet: at least never re-feed the
                # poisoned batch.
                action = "skip"
        if action in ("skip", "rollback") and span is not None:
            # A rollback just rewound the loader's skip table, so the
            # range is recorded after it.
            dataloader.add_skip_range(*span)
            self.skipped_batches += 1
        self.last_incident = {
            "kind": kind, "step": int(step), "data": data_id, "action": action,
        }
        LOG.warning(
            "numeric-health incident: kind=%s step=%d data=%s action=%s "
            "restored=%s",
            kind, step, data_id, action, restored,
        )
        post_incident(kind, step=step, data_id=data_id, action=action)
        return {
            "healthy": False, "kind": kind,
            "action": action, "restored": restored,
        }

    def _rollback(self) -> str | None:
        restored = checkpoint.rollback_to_good()
        if restored is None:
            LOG.warning(
                "guard rollback requested but no good-marked checkpoint "
                "exists; skipping the poisoned batch only"
            )
            return None
        self.rollbacks += 1
        # The restored weights are known good; detection restarts from a
        # fresh baseline (the old window described another trajectory).
        self._window.clear()
        self.healthy_streak = 0
        return restored


_guard: NumericGuard | None = None


def _get_guard() -> NumericGuard:
    global _guard
    if _guard is None:
        _guard = NumericGuard()
    return _guard


def observe_step(
    loss: Any,
    grad_sqr: Any = None,
    grad_var: Any = None,
    dataloader: Any = None,
) -> dict[str, Any]:
    """:meth:`NumericGuard.observe` on the process's guard."""
    return _get_guard().observe(
        loss, grad_sqr=grad_sqr, grad_var=grad_var, dataloader=dataloader
    )


def guard_stats() -> dict[str, Any] | None:
    """The guard's summary for the ``guardStats`` hint (the
    ``guard_stats`` wire family); None when the guard is off."""
    g = _get_guard()
    if g.policy == "off":
        return None
    from adaptdl_tpu_torch import metrics

    return {
        "policy": g.policy,
        "incidents": int(sum(g.incidents_by_kind.values())),
        "incidentsByKind": dict(g.incidents_by_kind),
        "rollbacks": int(g.rollbacks),
        "skippedBatches": int(g.skipped_batches),
        "unhealthySteps": int(g.unhealthy_steps),
        "healthyStreak": int(g.healthy_streak),
        "lastGoodAge": checkpoint.last_good_age(),
        "rawGoodput": metrics.raw_goodput(),
    }


def post_incident(
    kind: str,
    step: int | None = None,
    data_id: str | None = None,
    action: str | None = None,
) -> bool:
    """POST one incident to the supervisor; False on any failure
    (best-effort, like the hint posts). The worker sends its rank; the
    supervisor resolves the slot it occupies."""
    url, job_id = env.supervisor_url(), env.job_id()
    if not url or not job_id:
        return False
    payload: dict[str, Any] = {"kind": kind}
    if step is not None:
        payload["step"] = int(step)
    if data_id is not None:
        payload["data"] = str(data_id)
    if action is not None:
        payload["action"] = action
    payload["rank"] = env.process_rank()
    try:
        response = rpc.default_client().post(
            f"{url}/incident/{job_id}",
            endpoint=f"incident/{job_id}",
            json=payload,
            params={"group": env.num_restarts()},
            timeout=(2, 10),
            attempts=2,
            deadline=30.0,
        )
        response.raise_for_status()
        return True
    except Exception as exc:  # noqa: BLE001 - best effort by design
        LOG.warning("failed to post incident: %s", exc)
        return False


def _reset_state() -> None:
    """Drop the process's guard (test isolation)."""
    global _guard
    _guard = None
