"""Local elastic runner: the one-machine job controller.

The port's copy of ``adaptdl_tpu.sched.local_runner``: one job under
the port's supervisor (hints, heartbeats, rendezvous) and Pollux
allocator over one ``"local"`` node of ``num_chips`` slots. It is a
``multi_runner.MultiJobRunner`` over that one job, whose job loop
launches, rescales (SIGTERM, exit 143, relaunch at the new replica
count, or the cutover to a warm successor) and retries it; with
``state_dir`` its cluster state is journaled and recovered.

Usage (the script takes the card unless given its own ``--cpu``)::

    python -m adaptdl_tpu_torch.sched.local_runner SCRIPT --chips 2 \\
        --checkpoint-dir DIR [-- SCRIPT_ARGS...]

Slots need not be cards: with more slots than cards the ranks share a
card, which checks the mechanism, not scaling.
"""

from __future__ import annotations

import logging
import subprocess
import sys

from adaptdl_tpu_torch.sched.allocator import Allocator
from adaptdl_tpu_torch.sched.multi_runner import (
    JobSpec,
    MultiJobRunner,
    _device_count,
)
from adaptdl_tpu_torch.sched.state import ClusterState
from adaptdl_tpu_torch.sched.supervisor import Supervisor


class LocalElasticRunner:
    def __init__(
        self,
        script: str,
        num_chips: int,
        checkpoint_dir: str,
        job_name: str = "default/local",
        min_replicas: int = 0,
        max_replicas: int | None = None,
        allocator_interval: float | None = None,
        max_failures: int | None = None,
        extra_env: dict | None = None,
        pop_size: int = 24,
        generations: int = 20,
        term_grace_period: float = 120.0,
        preemptible: bool = True,
        handoff: bool | None = None,
        script_args=(),
        state_dir: str | None = None,
    ):
        self.job_name = job_name
        job = JobSpec(
            job_name, script, checkpoint_dir, min_replicas=min_replicas,
            max_replicas=max_replicas, preemptible=preemptible,
            # None inherits the environment's ADAPTDL_HANDOFF.
            handoff=handoff, extra_env=dict(extra_env or {}),
            script_args=list(script_args),
        )
        self._runner = MultiJobRunner(
            [job], num_chips, allocator_interval=allocator_interval,
            max_failures=max_failures, term_grace_period=term_grace_period,
            pop_size=pop_size, generations=generations, state_dir=state_dir,
        )

    @property
    def state(self) -> ClusterState:
        return self._runner.state

    @property
    def supervisor(self) -> Supervisor:
        return self._runner.supervisor

    @property
    def allocator(self) -> Allocator:
        return self._runner.allocator

    @property
    def events(self) -> list[dict]:
        """One record per launch, signal and exit, in order (wall time):
        what a caller reads to time and check each rescale."""
        return self._runner.events[self.job_name]

    @property
    def proc(self) -> subprocess.Popen | None:
        """The live launcher (stale after it exits)."""
        return self._runner.procs.get(self.job_name)

    @property
    def restarts(self) -> int:
        return self._runner.restart_counts[self.job_name]

    @property
    def failures(self) -> int:
        return self._runner.failures[self.job_name]

    def restart_control_plane(self) -> dict[str, dict]:
        """See ``MultiJobRunner.restart_control_plane``."""
        return self._runner.restart_control_plane()

    def run(self) -> int:
        """Run the job to completion; returns the final exit code."""
        return self._runner.run()[self.job_name]


def main(argv=None) -> int:
    import argparse

    argv = sys.argv[1:] if argv is None else list(argv)
    script_args: list[str] = []
    if "--" in argv:
        cut = argv.index("--")
        argv, script_args = argv[:cut], argv[cut + 1:]
    parser = argparse.ArgumentParser(
        description="Run a training script elastically on this machine."
    )
    parser.add_argument("script")
    parser.add_argument(
        "--chips", type=int, default=None,
        help="slots of the local node (default: the visible cards)",
    )
    parser.add_argument("--checkpoint-dir", required=True)
    parser.add_argument("--min-replicas", type=int, default=0)
    parser.add_argument("--max-replicas", type=int, default=None)
    parser.add_argument(
        "--allocator-interval", type=float, default=None,
        help="seconds between Pollux cycles (default: "
        "ADAPTDL_ALLOCATOR_INTERVAL, else 5)",
    )
    parser.add_argument(
        "--non-preemptible",
        action="store_true",
        help="pin the job's allocation once granted (the scheduler "
        "never shrinks or moves it to make room for other jobs)",
    )
    args = parser.parse_args(argv)
    chips = args.chips if args.chips is not None else _device_count()
    if chips < 1:
        parser.error("no card visible: pass --chips")
    runner = LocalElasticRunner(
        args.script,
        num_chips=chips,
        checkpoint_dir=args.checkpoint_dir,
        min_replicas=args.min_replicas,
        max_replicas=args.max_replicas,
        allocator_interval=args.allocator_interval,
        preemptible=not args.non_preemptible,
        script_args=script_args,
    )
    return runner.run()


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    sys.exit(main())
