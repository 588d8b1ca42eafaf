"""Deterministic fault injection, the port of ``adaptdl_tpu.faults``.

Code reaches a named *injection point* with ``maybe_fail(point)``; with
no schedule installed that is one global read and a return. A schedule
comes from ``ADAPTDL_FAULT_SPEC`` (or :func:`configure`) as
semicolon-separated clauses:

    <point>=<action>[:<value>][@<n>[+] | %<p>]

- ``fail`` raises :class:`InjectedFault`; ``fail@3`` fires on the 3rd
  hit of the point only, ``fail@3+`` on the 3rd and every later one,
  ``fail%0.2`` with probability 0.2.
- ``exit`` is ``os._exit(1)`` at exactly this point, same qualifiers.
- ``sleep:S`` injects S seconds of latency, same qualifiers.

Hit counts are per point and process-wide; a probabilistic decision is
a hash of ``ADAPTDL_FAULT_SEED``, the point and the hit index, so a
(spec, seed) pair replays the same schedule, the same as the JAX
package's for the same points. The catalog below holds the points the
port reaches; a clause naming any other point is rejected when the
schedule is parsed.
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading
import time

from adaptdl_tpu_torch import env

LOG = logging.getLogger(__name__)

INJECTION_POINTS = {
    # resilient RPC client (rpc.RpcClient.request)
    "rpc.request.send": "before each HTTP attempt leaves the client",
    "rpc.response.recv": "after a response arrives, before it is returned",
    # numeric-health guard (guard.py and the checkpoint rollback; a
    # fault at corrupt_grad/loss_spike SIMULATES the corruption: the
    # guard takes it as a poisoned observation instead of crashing)
    "guard.corrupt_grad": "per-step gradient-statistic intake (injects NaN)",
    "guard.loss_spike": "per-step loss intake (injects a spike)",
    "guard.rollback": "before a last-known-good rollback restore",
    # peer-to-peer handoff (handoff.py; serve faults become 500s on the
    # shard server, fetch faults abort the successor's pull: both fall
    # back to the durable checkpoint)
    "handoff.serve": "shard-server chunk handler (doomed incarnation)",
    "handoff.fetch": "before each chunk fetch on the successor",
    # preemption survival (sched/preemption.py; an injected fault at
    # preempt.notice SIMULATES a reclaim notice in the listener)
    "preempt.notice": "each listener poll for a reclaim notice",
    "preempt.drain_save": "before the urgent drain's blocking save",
    # sharded checkpoint (sharded_checkpoint.py: a fault leaves a fresh
    # payload dir no complete checkpoint references)
    "ckpt.sharded.payload": "each rank's row write into the versioned dir",
    # supervisor handlers (sched/supervisor.py; injected faults become 500s)
    "sup.register.pre": "worker registration handler",
    "sup.discover.pre": "rendezvous long-poll handler",
    "sup.hints.pre": "sched-hints intake handler",
    "sup.hints.get.pre": "sched-hints readback handler",
    "sup.config.pre": "job-config snapshot handler",
    "sup.heartbeat.pre": "heartbeat lease-renewal handler",
    "sup.trace.pre": "worker trace-span intake handler",
    "sup.trace.get.pre": "stitched per-job timeline handler",
    "sup.preempt.pre": "preemption-notice intake handler",
    "sup.handoff.pre": "handoff advertisement intake handler",
    "sup.handoff.get.pre": "handoff discovery handler",
    "sup.candidate.pre": "candidate-allocation readback handler",
    "sup.status.pre": "operator status snapshot handler",
    "sup.incident.pre": "numeric-incident intake handler",
    # worker lifecycle (sched/local_runner.py, sched/multi_runner.py)
    "runner.launch.pre": "before a worker subprocess launch",
    "runner.supervise.poll": "each supervision poll cycle",
    # transactional rescale (sched/state.py; an injected fault
    # SUPPRESSES the commit signal so the epoch times out)
    "alloc.commit_timeout": "before an allocation epoch commits",
}


class InjectedFault(RuntimeError):
    """A failure raised by the fault-injection schedule."""


class _Clause:
    """One parsed spec clause: an action with its firing qualifier."""

    __slots__ = ("point", "action", "value", "nth", "nth_plus", "prob")

    def __init__(self, point, action, value, nth, nth_plus, prob):
        self.point = point
        self.action = action  # "fail" | "exit" | "sleep"
        self.value = value  # sleep seconds (0.0 otherwise)
        self.nth = nth  # fire on this 1-based hit (None = every hit)
        self.nth_plus = nth_plus  # with nth: fire on every hit >= nth
        self.prob = prob  # fire with this probability (None = always)

    def should_fire(self, hit: int, seed: int) -> bool:
        if self.nth is not None:
            if self.nth_plus:
                if hit < self.nth:
                    return False
            elif hit != self.nth:
                return False
        if self.prob is not None:
            return _decision(seed, self.point, hit) < self.prob
        return True


def _decision(seed: int, point: str, hit: int) -> float:
    """Deterministic uniform [0, 1) draw for (seed, point, hit)."""
    digest = hashlib.sha256(f"{seed}|{point}|{hit}".encode()).digest()
    return int.from_bytes(digest[:8], "big") / float(1 << 64)


def _parse_clause(text: str) -> _Clause:
    point, sep, action_text = text.partition("=")
    point = point.strip()
    action_text = action_text.strip()
    if not sep or not point or not action_text:
        raise ValueError(f"fault clause must be point=action: {text!r}")
    if point not in INJECTION_POINTS:
        raise ValueError(
            f"unknown injection point {point!r} (see "
            "adaptdl_tpu_torch/faults.py INJECTION_POINTS)"
        )
    nth = None
    nth_plus = False
    prob = None
    if "@" in action_text:
        action_text, _, qual = action_text.partition("@")
        qual = qual.strip()
        nth_plus = qual.endswith("+")
        nth = int(qual.rstrip("+"))
        if nth < 1:
            raise ValueError(f"@N must be >= 1 in {text!r}")
    elif "%" in action_text:
        action_text, _, qual = action_text.partition("%")
        prob = float(qual)
        if not 0.0 <= prob <= 1.0:
            raise ValueError(f"%p must be in [0, 1] in {text!r}")
    action, _, value_text = action_text.strip().partition(":")
    action = action.strip()
    if action not in ("fail", "exit", "sleep"):
        raise ValueError(
            f"unknown fault action {action!r} in {text!r} "
            "(expected fail, exit, or sleep)"
        )
    value = 0.0
    if action == "sleep":
        if not value_text:
            raise ValueError(f"sleep needs seconds (sleep:S) in {text!r}")
        value = float(value_text)
    elif value_text:
        raise ValueError(f"{action} takes no value in {text!r}")
    return _Clause(point, action, value, nth, nth_plus, prob)


class _Schedule:
    """A parsed fault spec plus its per-point hit counters."""

    def __init__(self, spec: str, seed: int):
        self.spec = spec
        self.seed = seed
        self.clauses: dict[str, list[_Clause]] = {}
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            clause = _parse_clause(part)
            self.clauses.setdefault(clause.point, []).append(clause)
        self._lock = threading.Lock()
        # Bumped from every instrumented thread (training, fit, heartbeat).
        self._hits: dict[str, int] = {}  # guarded-by: _lock

    def hit_count(self, point: str) -> int:
        with self._lock:
            return self._hits.get(point, 0)

    def fire(self, point: str) -> None:
        if point not in INJECTION_POINTS:
            raise ValueError(
                f"maybe_fail called with unregistered point {point!r}"
            )
        with self._lock:
            hit = self._hits.get(point, 0) + 1
            self._hits[point] = hit
        for clause in self.clauses.get(point, ()):
            if not clause.should_fire(hit, self.seed):
                continue
            if clause.action == "sleep":
                LOG.debug(
                    "fault injection: sleep %.3fs at %s (hit %d)",
                    clause.value, point, hit,
                )
                time.sleep(clause.value)
            elif clause.action == "exit":
                LOG.warning(
                    "fault injection: hard exit at %s (hit %d)", point, hit
                )
                os._exit(1)
            else:
                LOG.debug("fault injection: fail at %s (hit %d)", point, hit)
                raise InjectedFault(f"{point} (hit {hit})")


# The active schedule; None (the production state) disables injection.
# Written only by configure()/reset()/the first maybe_fail; other
# threads only read the reference.
_schedule: _Schedule | None = None
_env_loaded = False


def configure(spec: str | None, seed: int | None = None) -> None:
    """Install (or clear, with ``spec=None``) a fault schedule
    in-process, overriding ``ADAPTDL_FAULT_SPEC``."""
    global _schedule, _env_loaded
    _env_loaded = True
    _schedule = (
        _Schedule(spec, seed if seed is not None else env.fault_seed())
        if spec
        else None
    )


def reset() -> None:
    """Clear any schedule and re-arm the lazy load from the environment
    (test teardown)."""
    global _schedule, _env_loaded
    _schedule = None
    _env_loaded = False


def _load_from_env() -> None:
    global _schedule, _env_loaded
    _env_loaded = True
    spec = env.fault_spec_raw()
    if spec:
        _schedule = _Schedule(spec, env.fault_seed())
        LOG.warning(
            "fault injection ACTIVE: spec=%r seed=%d", spec, _schedule.seed
        )


def is_active() -> bool:
    if not _env_loaded:
        _load_from_env()
    return _schedule is not None


def hit_count(point: str) -> int:
    """How many times ``point`` has been reached under the active
    schedule (0 when inactive)."""
    schedule = _schedule
    return schedule.hit_count(point) if schedule is not None else 0


def maybe_fail(point: str) -> None:
    """Reach injection point ``point``: a no-op without a schedule;
    otherwise count the hit and run any clause that fires."""
    if not _env_loaded:
        _load_from_env()
    schedule = _schedule
    if schedule is None:
        return
    schedule.fire(point)
