"""Graceful-preemption signal handling.

The scheduler preempts a job with SIGTERM. The handler only records the
signal in a flag that the dataloader polls once per step; once every
replica has seen it, the job checkpoints and exits with code 143, which
the controller treats as a graceful rescale rather than a failure.
"""

from __future__ import annotations

import atexit
import signal

GRACEFUL_EXIT_CODE = 143

# A bare boolean: loads and stores are atomic in CPython and the handler
# runs on the main thread between bytecodes.
_exit_flag = False
_installed = False


def _handler(signum, frame):  # noqa: ARG001 - signal handler signature
    global _exit_flag
    _exit_flag = True


def install_handlers() -> None:
    """Install SIGTERM/SIGINT handlers (idempotent, main thread only),
    and ignore both once the process exits (:func:`ignore_at_exit`)."""
    global _installed
    if _installed:
        return
    signal.signal(signal.SIGTERM, _handler)
    signal.signal(signal.SIGINT, _handler)
    atexit.register(ignore_at_exit)
    _installed = True


def ignore_at_exit() -> None:
    """Ignore SIGTERM and SIGINT from here on. Once a process exits, a
    termination signal changes nothing: its run ended, finished or saved.
    Python restores the default action of its own handlers during
    finalization, so a signal landing there would kill the process, and
    death by SIGTERM reads as a graceful stop (143): a runner that asked
    for a rescale just as the job finished its budget would relaunch it
    from an older checkpoint. An ignored signal is left as it is."""
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    signal.signal(signal.SIGINT, signal.SIG_IGN)


def get_exit_flag() -> bool:
    """True once a termination signal has been received."""
    return _exit_flag


def set_exit_flag(value: bool = True) -> None:
    """Set the flag programmatically (tests, in-process rescale)."""
    global _exit_flag
    _exit_flag = value
