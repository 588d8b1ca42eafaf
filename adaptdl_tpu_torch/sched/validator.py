"""Job-spec validation, the port's copy of ``adaptdl_tpu.sched.validator``.

Plain functions the runners and the supervisor call, with the JAX
package's messages: ``validate_job_spec`` and ``validate_job_update``.
The admission webhook and its pod-template checks come with ``k8s/*``
(ROADMAP Queue 1).
"""

from __future__ import annotations

from typing import Any

IMMUTABLE_FIELDS = ("template", "min_replicas", "max_replicas")


class ValidationError(ValueError):
    pass


def validate_job_spec(spec: dict[str, Any]) -> None:
    """Raise ValidationError if a job spec is malformed."""
    min_replicas = spec.get("min_replicas", 0)
    max_replicas = spec.get("max_replicas", 1)
    if not isinstance(min_replicas, int) or min_replicas < 0:
        raise ValidationError("min_replicas must be a non-negative int")
    if not isinstance(max_replicas, int) or max_replicas < 1:
        raise ValidationError("max_replicas must be a positive int")
    if max_replicas < min_replicas:
        raise ValidationError(
            f"max_replicas ({max_replicas}) < min_replicas "
            f"({min_replicas})"
        )
    resources = spec.get("resources") or {}
    for rtype, amount in resources.items():
        if not isinstance(amount, int) or amount < 0:
            raise ValidationError(
                f"resource {rtype!r} must be a non-negative int"
            )


def validate_job_update(
    old_spec: dict[str, Any], new_spec: dict[str, Any]
) -> None:
    """Scaling limits and template are immutable after submission
    (changing them mid-flight would silently invalidate the fitted
    goodput model and the scheduler's assumptions)."""
    validate_job_spec(new_spec)
    for field in IMMUTABLE_FIELDS:
        if old_spec.get(field) != new_spec.get(field):
            raise ValidationError(f"spec.{field} is immutable")

