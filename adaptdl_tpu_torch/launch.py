"""Launch one process per replica of an elastic job.

    python -m adaptdl_tpu_torch.launch script.py [args...]
    python -m adaptdl_tpu_torch.launch -m package.module [args...]

The JAX package drives every local chip from one process; the port runs
one process per replica instead. The launcher starts
``ADAPTDL_NUM_REPLICAS`` fresh interpreters on this host, each with its
own ``ADAPTDL_REPLICA_RANK`` / ``ADAPTDL_PROCESS_RANK``, the job's
``ADAPTDL_NUM_PROCESSES`` and the ``ADAPTDL_COORDINATOR_ADDR`` of a free
port on ``ADAPTDL_MASTER_ADDR`` (or of ``ADAPTDL_MASTER_PORT``), for
``initialize_job`` to join one process group. It forwards SIGTERM and
SIGINT to every rank as SIGTERM, the graceful-preemption signal, and
waits for all of them. It exits with :func:`exit_code` of theirs. Should
a rank fail (exit other than 0 or 143), the others could wait forever in
a collective, so the launcher kills them after a short grace.

A warm successor's launcher (``ADAPTDL_WARMUP_READY_FILE`` set, see
``sched/warmup.py``) gives rank r the ready path ``<ready>.r`` and writes
``<ready>`` itself once every rank's exists: the runner reads one ready
file that means every rank holds. All ranks read the one cutover file.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import time

from adaptdl_tpu_torch import env
from adaptdl_tpu_torch._signal import GRACEFUL_EXIT_CODE

# Seconds the other ranks get to exit on their own after one has failed.
FAILURE_GRACE_S = 5.0
_POLL_S = 0.05


def exit_code(codes: list[int]) -> int:
    """The job's exit code from its ranks', in the order they exited:
    143 only when every rank exited 143 (a graceful preemption, each
    rank having agreed to stop at one step); else the first code that is
    neither 0 nor 143; 0 when every rank finished; and 1 when some
    finished while others stopped, which no agreed exit produces."""
    if codes and all(c == GRACEFUL_EXIT_CODE for c in codes):
        return GRACEFUL_EXIT_CODE
    for code in codes:
        if code not in (0, GRACEFUL_EXIT_CODE):
            return code
    return 0 if all(c == 0 for c in codes) else 1


def pick_unused_port(host: str = "127.0.0.1") -> int:
    """A port nothing listens on right now (the OS picks it)."""
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def _rank_environments(base: dict) -> list[dict]:
    """One environment per replica of the job that ``base`` describes."""
    replicas = env.num_replicas()
    host = env.master_addr()
    port = env.master_port() or pick_unused_port(host)
    shared = {
        **base,
        "ADAPTDL_NUM_REPLICAS": str(replicas),
        "ADAPTDL_NUM_PROCESSES": str(replicas),
        "ADAPTDL_COORDINATOR_ADDR": f"{host}:{port}",
        # Every rank of this launcher shares its host.
        "ADAPTDL_NUM_NODES": base.get("ADAPTDL_NUM_NODES") or "1",
    }
    ready = env.warmup_ready_file()
    return [
        {
            **shared,
            "ADAPTDL_REPLICA_RANK": str(rank),
            "ADAPTDL_PROCESS_RANK": str(rank),
            **(
                {"ADAPTDL_WARMUP_READY_FILE": f"{ready}.{rank}"}
                if ready else {}
            ),
        }
        for rank in range(replicas)
    ]


def _mark_ready_when_every_rank_is(ready: str, replicas: int) -> bool:
    """Write ``ready`` once every rank's ``ready.r`` exists; True once
    written."""
    if not all(os.path.exists(f"{ready}.{r}") for r in range(replicas)):
        return False
    tmp = f"{ready}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write("ready")
    os.replace(tmp, ready)
    return True


def _returncode(proc: subprocess.Popen) -> int:
    # A rank killed by a signal reports as the shell would: 128 + signal.
    code = proc.returncode
    return 128 - code if code < 0 else code


def run(argv: list[str]) -> int:
    """Start every rank on ``python argv...`` and wait for them."""
    procs: list[subprocess.Popen] = []

    def forward(signum, frame):  # noqa: ARG001 - signal handler signature
        for proc in procs:
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)

    previous = {
        sig: signal.signal(sig, forward)
        for sig in (signal.SIGTERM, signal.SIGINT)
    }
    codes: list[int] = []
    kill_at = None
    ready = env.warmup_ready_file()
    try:
        for rank_env in _rank_environments(dict(os.environ)):
            procs.append(subprocess.Popen([sys.executable, *argv], env=rank_env))
        running = list(procs)
        while running:
            if ready and _mark_ready_when_every_rank_is(ready, len(procs)):
                ready = None
            for proc in [p for p in running if p.poll() is not None]:
                running.remove(proc)
                codes.append(_returncode(proc))
                if kill_at is None and codes[-1] not in (
                    0, GRACEFUL_EXIT_CODE
                ):
                    kill_at = time.monotonic() + FAILURE_GRACE_S
            if kill_at is not None and time.monotonic() >= kill_at:
                for proc in running:
                    proc.kill()
            time.sleep(_POLL_S)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
        for sig, handler in previous.items():
            signal.signal(sig, handler)
    return exit_code(codes)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__.strip().splitlines()[0], file=sys.stderr)
        print(
            "usage: python -m adaptdl_tpu_torch.launch "
            "(script.py | -m module) [args...]",
            file=sys.stderr,
        )
        return 2
    return run(argv)


if __name__ == "__main__":
    sys.exit(main())
