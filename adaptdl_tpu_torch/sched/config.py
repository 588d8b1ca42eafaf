"""Scheduler defaults, the port's copy of ``adaptdl_tpu.sched.config``
trimmed to what the local runners read.

The raw ``ADAPTDL_*`` reads live in ``adaptdl_tpu_torch.env`` (None when
unset); this layer owns the defaults. Getters read the environment at
call time so tests can monkeypatch. The cluster deployment's settings
(namespace, image, ports, the webhook's certificate, the expander, node
pools) come with ``k8s/*`` and ``expander`` (ROADMAP Queue 1).
"""

from __future__ import annotations

from adaptdl_tpu_torch import env


def allocator_interval() -> float:
    """Seconds between the runners' Pollux cycles."""
    interval = env.allocator_interval()
    return 5.0 if interval is None else interval


def max_worker_failures() -> int:
    """Non-graceful worker failures tolerated before a job is Failed."""
    failures = env.max_worker_failures()
    return 2 if failures is None else failures
