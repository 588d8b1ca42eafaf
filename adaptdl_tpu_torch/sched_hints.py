"""Scheduling-hints client: the job -> cluster half of the Pollux loop.

The port of ``adaptdl_tpu.sched_hints``. Rank 0 periodically PUTs its
fitted goodput-model parameters to the supervisor (``/hints``), and the
cluster allocator turns them into speedup functions; the job reads the
allocator's decision back from ``/config``; every rank renews its lease
with heartbeats. Every call is best-effort: training never blocks on
the supervisor being reachable. Adopting the ``traceParent`` a
``/config`` reply carries is not part of the port yet.
"""

from __future__ import annotations

import logging
from typing import Any

from adaptdl_tpu_torch import env, rpc
from adaptdl_tpu_torch.goodput import GradParams, PerfParams
from adaptdl_tpu_torch.wire import SCHED_HINTS_KEYS

LOG = logging.getLogger(__name__)

PERF_PARAMS_KEYS = tuple(PerfParams._fields)
# The 7 base (Pollux-published) params are required on the wire; the
# sharded-axis terms are optional (PerfParams defaults them to 0).
PERF_PARAMS_REQUIRED = tuple(
    f for f in PerfParams._fields if PerfParams._field_defaults.get(f) is None
)
GRAD_PARAMS_KEYS = tuple(GradParams._fields)

# After a failed /config fetch, the circuit breaker skips further
# fetches for this long: a dead supervisor must not tax every
# re-optimization.
_FETCH_BACKOFF_S = 60.0


def empty_hints() -> dict[str, Any]:
    return {key: None for key in SCHED_HINTS_KEYS}


def validate_hints(hints: dict[str, Any]) -> None:
    """Raise ``ValueError`` unless ``hints`` is a well-formed payload of
    the ``sched_hints`` family."""
    unknown = set(hints) - set(SCHED_HINTS_KEYS)
    if unknown:
        raise ValueError(f"unknown sched hint keys: {sorted(unknown)}")
    if hints.get("perfParams") is not None:
        missing = set(PERF_PARAMS_REQUIRED) - set(hints["perfParams"])
        if missing:
            raise ValueError(f"perfParams missing {sorted(missing)}")
        bad = set(hints["perfParams"]) - set(PERF_PARAMS_KEYS)
        if bad:
            raise ValueError(f"unknown perfParams keys: {sorted(bad)}")
    if hints.get("gradParams") is not None:
        missing = set(GRAD_PARAMS_KEYS) - set(hints["gradParams"])
        if missing:
            raise ValueError(f"gradParams missing {sorted(missing)}")
    if hints.get("restartStats") is not None and not isinstance(
        hints["restartStats"], dict
    ):
        raise ValueError("restartStats must be an object")
    if hints.get("guardStats") is not None and not isinstance(
        hints["guardStats"], dict
    ):
        raise ValueError("guardStats must be an object")
    if hints.get("measuredGoodput") is not None:
        measured = hints["measuredGoodput"]
        if (
            not isinstance(measured, (int, float))
            or isinstance(measured, bool)
            or measured < 0
        ):
            raise ValueError("measuredGoodput must be a non-negative number")
    if hints.get("meshShapeGrid") is not None:
        grid = hints["meshShapeGrid"]
        if not isinstance(grid, (list, tuple)):
            raise ValueError("meshShapeGrid must be a list of shapes")
        for shape in grid:
            if (
                not isinstance(shape, (list, tuple))
                or len(shape) != 4
                or not all(isinstance(a, int) and a >= 1 for a in shape)
            ):
                raise ValueError(
                    "meshShapeGrid entries must be [sp, tp, ss, ep] "
                    f"lists of positive ints; got {shape!r}"
                )


def fetch_job_config() -> dict | None:
    """GET the supervisor's current decision for this job (allocation,
    batchConfig, retunes); None on any failure."""
    url, job_id = env.supervisor_url(), env.job_id()
    if not url or not job_id:
        return None
    try:
        # One attempt on a sub-second connect budget: this runs on the
        # training thread (rank 0, re-optimization cadence), and the
        # circuit (threshold 1) absorbs the next _FETCH_BACKOFF_S of
        # cycles after a failure.
        response = rpc.default_client().get(
            f"{url}/config/{job_id}",
            endpoint=f"config/{job_id}",
            # The restart group lets the supervisor's piggybacked lease
            # renewal reject a superseded incarnation's polls.
            params={"group": env.num_restarts()},
            timeout=(0.5, 2),
            attempts=1,
            circuit_threshold=1,
            circuit_cooldown=_FETCH_BACKOFF_S,
        )
        response.raise_for_status()
        payload = response.json()
        return payload if isinstance(payload, dict) else None
    except Exception as exc:  # noqa: BLE001 - best effort by design
        LOG.debug("failed to fetch job config: %s", exc)
        return None


def post_sched_hints(hints: dict[str, Any]) -> bool:
    """PUT hints to the supervisor; False on any failure."""
    url, job_id = env.supervisor_url(), env.job_id()
    if not url or not job_id:
        return False
    validate_hints(hints)
    try:
        response = rpc.default_client().put(
            f"{url}/hints/{job_id}",
            endpoint=f"hints/{job_id}",
            json=hints,
            params={"group": env.num_restarts()},
            timeout=(2, 10),
            attempts=2,
            deadline=30.0,
        )
        response.raise_for_status()
        return True
    except Exception as exc:  # noqa: BLE001 - best effort by design
        LOG.warning("failed to post sched hints: %s", exc)
        return False


def send_heartbeat(
    rank: int | None = None, step_time_ewma: float | None = None
) -> bool:
    """PUT a liveness heartbeat for this worker's lease; False on any
    failure. The restart group rides along so the supervisor can tell a
    doomed incarnation's beats from its successor's; ``step_time_ewma``
    (this rank's smoothed step time, seconds) rides the beat for the
    supervisor's straggler detection."""
    url, job_id = env.supervisor_url(), env.job_id()
    if not url or not job_id:
        return False
    rank = env.process_rank() if rank is None else rank
    payload = None
    if step_time_ewma is not None and step_time_ewma > 0:
        payload = {"stepTimeEwma": float(step_time_ewma)}
    try:
        response = rpc.default_client().put(
            f"{url}/heartbeat/{job_id}/{rank}",
            endpoint=f"heartbeat/{job_id}",
            params={"group": env.num_restarts()},
            json=payload,
            timeout=(0.5, 2),
            attempts=1,
            circuit_threshold=3,
            circuit_cooldown=30.0,
        )
        response.raise_for_status()
        return True
    except Exception as exc:  # noqa: BLE001 - best effort by design
        LOG.debug("heartbeat failed: %s", exc)
        return False
