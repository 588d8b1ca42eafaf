"""Graceful-preemption signal handling.

The scheduler preempts a job with SIGTERM. The handler only records the
signal in a flag that the dataloader polls once per step; once every
replica has seen it, the job checkpoints and exits with code 143, which
the controller treats as a graceful rescale rather than a failure.
"""

from __future__ import annotations

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
    """Install SIGTERM/SIGINT handlers (idempotent, main thread only)."""
    global _installed
    if _installed:
        return
    signal.signal(signal.SIGTERM, _handler)
    signal.signal(signal.SIGINT, _handler)
    _installed = True


def get_exit_flag() -> bool:
    """True once a termination signal has been received."""
    return _exit_flag


def set_exit_flag(value: bool = True) -> None:
    """Set the flag programmatically (tests, in-process rescale)."""
    global _exit_flag
    _exit_flag = value
