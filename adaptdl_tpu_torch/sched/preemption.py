"""Preemption-notice survival, the job side of
``adaptdl_tpu.sched.preemption``.

A spot machine gets a notice before it is reclaimed (GCE flips
``/computeMetadata/v1/instance/preempted`` to TRUE). The notice opens the
*urgent drain*:

1. :func:`deliver_notice` stamps a drain deadline (the notice window less
   a margin), mints a trace context for the survival arc, raises the
   graceful-exit flag, and reports the notice to the supervisor (``POST
   /preempt/{job}``) on a thread, so re-placement overlaps the drain;
2. the loader's exit path runs :func:`urgent_drain`: it joins a periodic
   write in flight, runs the blocking final save against the deadline,
   flushes the trace, and the process exits 143.

The listener (:func:`ensure_listener`, started by ``initialize_job`` when
``ADAPTDL_PREEMPT_POLL_S`` > 0) jitters its interval and, after
``ADAPTDL_PREEMPT_BACKOFF_AFTER`` consecutive polls that reached no
metadata server, backs off to ``ADAPTDL_PREEMPT_SLOW_POLL_S``. The
``preempt.notice`` injection point simulates a notice.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Callable

from adaptdl_tpu_torch import _signal, checkpoint, env, faults, rpc, trace

LOG = logging.getLogger(__name__)

GCE_PREEMPTED_URL = (
    "http://metadata.google.internal/computeMetadata/v1/instance/preempted"
)
_HEADERS = {"Metadata-Flavor": "Google"}
# Poll outcomes: "reachable, not preempted" resets the backoff streak,
# "unreachable" grows it.
POLL_PREEMPTED = "preempted"
POLL_OK = "ok"
POLL_UNREACHABLE = "unreachable"

_notice_lock = threading.Lock()
_notice: dict | None = None  # guarded-by: _notice_lock
_listener_stop: threading.Event | None = None  # guarded-by: _notice_lock
_listener_thread: threading.Thread | None = None
_notify_thread: threading.Thread | None = None


def poll_status(url: str = GCE_PREEMPTED_URL, timeout: float = 2.0) -> str:
    """One metadata poll: :data:`POLL_PREEMPTED`, :data:`POLL_OK` (it
    answered anything else) or :data:`POLL_UNREACHABLE`. One attempt and
    no circuit: the listener's interval is the retry loop."""
    try:
        response = rpc.default_client().get(
            url, headers=_HEADERS, timeout=timeout, attempts=1,
            use_circuit=False, traced=False,
        )
    except Exception:  # noqa: BLE001 - no metadata server
        return POLL_UNREACHABLE
    if response.status_code == 200 and response.text.strip().upper() == "TRUE":
        return POLL_PREEMPTED
    return POLL_OK


def poll_once(url: str = GCE_PREEMPTED_URL, timeout: float = 2.0) -> bool:
    """True when the metadata server reports this machine preempted."""
    return poll_status(url, timeout) == POLL_PREEMPTED


def _poll_for_notice(url: str = GCE_PREEMPTED_URL) -> str:
    """One listener poll; a fault injected at ``preempt.notice`` is a
    notice."""
    try:
        faults.maybe_fail("preempt.notice")
    except faults.InjectedFault:
        return POLL_PREEMPTED
    return poll_status(url)


def notice_active() -> bool:
    with _notice_lock:
        return _notice is not None


def notice_state() -> dict | None:
    """A copy of the active notice: source, window, budget, deadline,
    trace parent, whether the supervisor acknowledged it, whether the
    drain ran (and its seconds)."""
    with _notice_lock:
        return dict(_notice) if _notice is not None else None


def drain_remaining_s() -> float | None:
    """Seconds left in the drain budget (None without a notice)."""
    with _notice_lock:
        if _notice is None:
            return None
        deadline = _notice["deadline"]
    return max(deadline - time.monotonic(), 0.0)


def reset_notice() -> None:
    """Clear the notice (tests)."""
    global _notice
    with _notice_lock:
        _notice = None


def deliver_notice(
    source: str = "metadata", notice_s: float | None = None, notify: bool = True
) -> bool:
    """Record a notice for this incarnation (False when one is active):
    a drain deadline, a fresh trace context for the survival arc, the
    graceful-exit flag, and with ``notify`` the supervisor report on a
    thread."""
    global _notice, _notify_thread
    if notice_s is None:
        notice_s = env.preempt_notice_s()
    budget = max(float(notice_s) - env.preempt_margin_s(), 1.0)
    traceparent = trace.new_traceparent()
    with _notice_lock:
        if _notice is not None:
            return False
        _notice = {
            "source": source,
            "noticeS": float(notice_s),
            "budgetS": budget,
            "deadline": time.monotonic() + budget,
            "traceParent": traceparent,
            "reported": False,
            "drained": False,
        }
    trace.set_traceparent(traceparent)
    trace.event("preempt.notice", traceparent=traceparent, source=source,
                noticeS=float(notice_s))
    LOG.warning("preemption notice (%s): draining within %.1f s", source, budget)
    _signal.set_exit_flag(True)
    if notify:
        _notify_thread = threading.Thread(
            target=notify_supervisor, name="adaptdl-torch-preempt-notify",
            daemon=True,
        )
        _notify_thread.start()
    return True


def notify_supervisor(job_id: str | None = None) -> bool:
    """POST the active notice to the supervisor's ``/preempt/{job}``
    (idempotent there), with retries bounded well inside the window."""
    url = env.supervisor_url()
    job_id = job_id if job_id is not None else env.job_id()
    with _notice_lock:
        notice = dict(_notice) if _notice is not None else None
    if not url or not job_id or notice is None:
        return False
    try:
        rpc.default_client().post(
            f"{url}/preempt/{job_id}",
            endpoint=f"preempt/{job_id}",
            json={
                "group": env.num_restarts(),
                "rank": env.process_rank(),
                "noticeS": notice["noticeS"],
                "traceParent": notice["traceParent"],
            },
            timeout=(2, 5),
            attempts=3,
            deadline=min(notice["budgetS"] / 2.0, 10.0),
            use_circuit=False,
        ).raise_for_status()
    except Exception as exc:  # noqa: BLE001 - the drain must not wait
        LOG.warning("failed to report the preemption notice: %s", exc)
        return False
    with _notice_lock:
        if _notice is not None:
            _notice["reported"] = True
    return True


def urgent_drain() -> dict:
    """The notice's final checkpoint: join a write in flight, run the
    blocking save against the deadline, flush the trace. Returns the
    summary: seconds, whether the deadline was met, whether the last
    measured save cost predicted it would be, whether a write in flight
    was joined. A miss records ``drain.deadline_exceeded``."""
    notice = notice_state()
    deadline = notice["deadline"] if notice else None
    traceparent = notice["traceParent"] if notice else trace.current_traceparent()
    remaining = None if deadline is None else max(deadline - time.monotonic(), 0.0)
    expected = _expected_save_s()
    fits = None if expected is None or remaining is None else expected <= remaining
    if fits is False:
        LOG.warning("urgent drain may miss the window: last save %.2f s, "
                    "%.2f s left", expected, remaining)
    inflight = checkpoint.inflight_save()
    joined = inflight is not None and not inflight.done()
    faults.maybe_fail("preempt.drain_save")
    start = time.monotonic()
    with trace.span("drain.save", traceparent=traceparent,
                    joined_inflight=joined) as attrs:
        if remaining is not None:
            attrs["budget_s"] = round(remaining, 4)
        checkpoint.save_all_states(wait=True)
    duration = time.monotonic() - start
    met = deadline is None or time.monotonic() <= deadline
    if not met:
        trace.event("drain.deadline_exceeded", traceparent=traceparent,
                    overrun_s=round(duration - (remaining or 0.0), 4))
        LOG.warning("urgent drain overran the window by %.2f s",
                    duration - (remaining or 0.0))
    with _notice_lock:
        if _notice is not None:
            _notice["drained"] = True
            _notice["drainS"] = duration
    trace.flush_to_supervisor()
    return {
        "durationS": duration,
        "deadlineMet": met,
        "fitPredicted": fits,
        "joinedInflight": joined,
    }


def _expected_save_s() -> float | None:
    """The last measured save's snapshot + write seconds, or None."""
    from adaptdl_tpu_torch import metrics

    stats = metrics.restart_stats()
    if not stats or stats.get("snapshotS") is None:
        return None
    return float(stats["snapshotS"]) + float(stats.get("writeS") or 0.0)


def _next_interval(
    streak: int, base: float, slow: float, backoff_after: int, jitter: float
) -> float:
    """The wait before the next poll: the base cadence, or the slow one
    after ``backoff_after`` unreachable polls in a row; +-20% jitter
    (``jitter`` in [0, 1))."""
    cadence = slow if streak >= backoff_after else base
    return cadence * (0.8 + 0.4 * jitter)


def listen(
    poll: Callable[[], str],
    wait: Callable[[float], bool],
    interval: float,
    slow_interval: float,
    backoff_after: int,
    jitter: Callable[[], float] = random.random,
) -> bool:
    """The listener's loop: ``poll`` until a notice (delivered, True) or
    until ``wait(seconds)`` returns True (stopped, False). ``wait`` is
    the clock: a stop event's ``wait`` in the listener thread, a fake
    clock in tests."""
    streak = 0
    while True:
        status = poll()
        if status == POLL_PREEMPTED:
            deliver_notice(source="metadata")
            return True
        if status == POLL_UNREACHABLE:
            streak += 1
            if streak == backoff_after:
                LOG.info("metadata endpoint unreachable %d times; polling "
                         "every %.0f s", streak, slow_interval)
        else:
            streak = 0
        if wait(_next_interval(streak, interval, slow_interval,
                               backoff_after, jitter())):
            return False


def start_listener(
    url: str = GCE_PREEMPTED_URL,
    interval: float | None = None,
    slow_interval: float | None = None,
    backoff_after: int | None = None,
) -> threading.Event:
    """Poll for a notice on a thread; returns its stop event."""
    global _listener_thread, _listener_stop
    stop = threading.Event()
    rng = random.Random()
    args = (
        lambda: _poll_for_notice(url),
        stop.wait,
        interval if interval is not None else (env.preempt_poll_s() or 5.0),
        slow_interval if slow_interval is not None else env.preempt_slow_poll_s(),
        backoff_after if backoff_after is not None else env.preempt_backoff_after(),
        rng.random,
    )
    with _notice_lock:
        _listener_stop = stop
    _listener_thread = threading.Thread(
        target=listen, args=args, name="adaptdl-torch-preemption", daemon=True
    )
    _listener_thread.start()
    return stop


def ensure_listener() -> threading.Event | None:
    """Start the listener once per process when the deployment asks for
    it (``ADAPTDL_PREEMPT_POLL_S`` > 0); returns its stop event or None."""
    if env.preempt_poll_s() <= 0:
        return None
    with _notice_lock:
        if _listener_stop is not None and not _listener_stop.is_set():
            return _listener_stop
    return start_listener()


def stop_listener(timeout: float | None = 5.0) -> None:
    """Stop the listener and join it and any notify thread."""
    with _notice_lock:
        stop = _listener_stop
    if stop is not None:
        stop.set()
    for thread in (_listener_thread, _notify_thread):
        if thread is not None:
            thread.join(timeout)
