"""Elastic runners' job loop, and Pollux co-scheduling on one machine.

The port's copy of ``adaptdl_tpu.sched.multi_runner``: several training
jobs run at once on one node's slots, with ONE allocator co-optimising
their allocations from their posted goodput hints. Each job is
supervised by a thread of its own, which

- launches the job as ``python -m adaptdl_tpu_torch.launch <script>
  <args>`` with the full ``ADAPTDL_*`` environment of its allocation:
  the port runs one process per replica, so the runner sets the replica
  count and the launcher each rank's environment;
- watches the allocation; when it moves, sends SIGTERM to the launcher,
  which forwards it to every rank: each checkpoints and exits 143, a
  graceful rescale, never a failure; then relaunches with
  ``ADAPTDL_NUM_RESTARTS + 1`` at the new replica count;
- counts any other exit against a retry budget (``max_failures``).

Slots need not be cards: with more slots than cards the ranks share a
card, and the process group takes gloo (``collective.py``). That checks
the mechanism, not scaling. ``local_runner.LocalElasticRunner`` is this
runner over one job. The warm successor of the JAX runners is not ported
(ROADMAP Queue 1).
"""

from __future__ import annotations

import logging
import os
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field

import adaptdl_tpu_torch
from adaptdl_tpu_torch import faults
from adaptdl_tpu_torch._signal import GRACEFUL_EXIT_CODE
from adaptdl_tpu_torch.launch import pick_unused_port
from adaptdl_tpu_torch.sched import config
from adaptdl_tpu_torch.sched.allocator import Allocator
from adaptdl_tpu_torch.sched.policy import NodeInfo, PolluxPolicy
from adaptdl_tpu_torch.sched.state import ClusterState, normalize_topology
from adaptdl_tpu_torch.sched.supervisor import Supervisor
from adaptdl_tpu_torch.sched.validator import validate_job_spec

LOG = logging.getLogger(__name__)

_POLL_S = 0.2
# The directory that holds the package: ranks started on a script path
# import it from there.
_PACKAGE_ROOT = os.path.dirname(
    os.path.dirname(os.path.abspath(adaptdl_tpu_torch.__file__))
)


def launch_command(script: str, script_args=()) -> list[str]:
    """The command that starts every rank of one incarnation."""
    return [
        sys.executable, "-m", "adaptdl_tpu_torch.launch", script,
        *script_args,
    ]


def job_environment(
    base: dict,
    job_name: str,
    checkpoint_dir: str,
    num_replicas: int,
    topology: dict | None,
    restarts: int,
    supervisor_url: str,
    trace_parent: str | None = None,
    handoff: bool | None = None,
) -> dict:
    """The ``ADAPTDL_*`` environment of one launch: the JAX runner's
    ``_job_env`` with one process per replica and a fresh master port
    (the previous incarnation's may still be in TIME_WAIT)."""
    env = dict(base)
    env.update(
        {
            "ADAPTDL_JOB_ID": job_name,
            "ADAPTDL_CHECKPOINT_PATH": checkpoint_dir,
            "ADAPTDL_MASTER_ADDR": "127.0.0.1",
            "ADAPTDL_MASTER_PORT": str(pick_unused_port()),
            "ADAPTDL_NUM_REPLICAS": str(num_replicas),
            "ADAPTDL_NUM_PROCESSES": str(num_replicas),
            "ADAPTDL_NUM_NODES": "1",
            "ADAPTDL_NUM_RESTARTS": str(restarts),
            "ADAPTDL_SUPERVISOR_URL": supervisor_url,
        }
    )
    for name in ("ADAPTDL_REPLICA_RANK", "ADAPTDL_PROCESS_RANK"):
        env.pop(name, None)  # the launcher sets each rank's
    paths = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    if _PACKAGE_ROOT not in paths:
        env["PYTHONPATH"] = os.pathsep.join([_PACKAGE_ROOT, *paths])
    if handoff is not None:
        env["ADAPTDL_HANDOFF"] = "on" if handoff else "off"
    if trace_parent:
        # The new incarnation's restore and first-step spans join the
        # trace of the decision that restarted it.
        env["ADAPTDL_TRACEPARENT"] = trace_parent
    topology = topology or {}
    env["ADAPTDL_SEQ_SHARDS"] = str(topology.get("seqShards", 1))
    env["ADAPTDL_MODEL_SHARDS"] = str(topology.get("modelShards", 1))
    env["ADAPTDL_STAGE_SHARDS"] = str(topology.get("stageShards", 1))
    env["ADAPTDL_EXPERT_SHARDS"] = str(topology.get("expertShards", 1))
    default_micro = 4 if int(topology.get("stageShards", 1)) > 1 else 1
    env["ADAPTDL_PIPELINE_MICRO"] = str(
        topology.get("pipelineMicro", default_micro)
    )
    return env


def withdraw_handoff_descriptor(checkpoint_dir: str) -> None:
    """A crash never ran the drain: remove any handoff descriptor an
    older incarnation left, so the next launch reads the checkpoint."""
    from adaptdl_tpu_torch.handoff import DESCRIPTOR_NAME

    try:
        os.remove(os.path.join(checkpoint_dir, DESCRIPTOR_NAME))
    except OSError:
        pass


def start_incarnation(command: list[str], env: dict) -> subprocess.Popen:
    """Start the launcher in a process group of its own, so that
    :func:`kill_incarnation` reaches its ranks too."""
    return subprocess.Popen(command, env=env, start_new_session=True)


def kill_incarnation(proc: subprocess.Popen) -> None:
    """SIGKILL the launcher and every rank it started, then reap it."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except OSError:
        pass
    proc.wait()


def supervise(
    proc: subprocess.Popen,
    state: ClusterState,
    job_name: str,
    allocation,
    topology,
    term_grace_period: float,
    events: list,
    stop_if=None,
) -> tuple[int, bool]:
    """Wait for the launcher; SIGTERM it when the job's allocation or
    topology moves (or ``stop_if()`` turns true), SIGKILL after the
    grace period. Returns (exit code, whether it was signalled).
    Batch-config-only decisions never signal: the job adopts them
    in-process through ``/config``."""
    signalled = False
    term_deadline = None
    while True:
        faults.maybe_fail("runner.supervise.poll")
        code = proc.poll()
        if code is not None:
            events.append(
                {"event": "exit", "time": time.time(), "code": code}
            )
            return code, signalled
        current, cur_topology = state.get_launch_config(job_name)
        drifted = list(current) != list(allocation) or normalize_topology(
            cur_topology
        ) != normalize_topology(topology)
        stop = stop_if is not None and stop_if()
        if not signalled and (drifted or stop):
            LOG.info(
                "%s drift %s/%s -> %s/%s: requesting graceful rescale",
                job_name, allocation, topology, current, cur_topology,
            )
            proc.send_signal(signal.SIGTERM)
            signalled = True
            term_deadline = time.monotonic() + term_grace_period
            events.append(
                {
                    "event": "signal", "time": time.time(),
                    "allocation": list(current),
                }
            )
        if term_deadline is not None and time.monotonic() > term_deadline:
            LOG.warning("grace period expired; killing %s", job_name)
            kill_incarnation(proc)
            term_deadline = None
        time.sleep(_POLL_S)


def is_rescale(code: int, signalled: bool) -> bool:
    """A graceful exit (143), or our own SIGTERM landing before the
    launcher installed its handler."""
    return code == GRACEFUL_EXIT_CODE or (
        signalled and code == -signal.SIGTERM
    )


def _device_count() -> int:
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 0


@dataclass
class JobSpec:
    name: str  # "namespace/name"
    script: str
    checkpoint_dir: str
    min_replicas: int = 0
    max_replicas: int | None = None
    # False pins the job's allocation once granted.
    preemptible: bool = True
    # None inherits ADAPTDL_HANDOFF; True / False force it per job.
    handoff: bool | None = None
    extra_env: dict = field(default_factory=dict)
    script_args: list = field(default_factory=list)


class MultiJobRunner:
    def __init__(
        self,
        jobs: list[JobSpec],
        num_chips: int,
        allocator_interval: float | None = None,
        max_failures: int | None = None,
        term_grace_period: float = 120.0,
        pop_size: int = 24,
        generations: int = 20,
    ):
        self.num_chips = num_chips
        self.max_failures = (
            config.max_worker_failures() if max_failures is None
            else max_failures
        )
        self.term_grace_period = term_grace_period
        self.state = ClusterState()
        self.jobs: dict[str, JobSpec] = {}
        self.exit_codes: dict[str, int] = {}
        self.restart_counts: dict[str, int] = {}
        self.failures: dict[str, int] = {}
        # Per job: one record per launch, signal and exit (wall time).
        self.events: dict[str, list] = {}
        self._stopped: set[str] = set()
        # Live launcher process per job (entries go stale after exit).
        self.procs: dict[str, subprocess.Popen] = {}
        self._lock = threading.Lock()
        self._threads: list[threading.Thread] = []
        self._running = False
        for job in jobs:
            self._create(job)
        self.supervisor = Supervisor(self.state)
        self.allocator = Allocator(
            self.state,
            {"local": NodeInfo(resources={"tpu": num_chips})},
            policy=PolluxPolicy(pop_size=pop_size, generations=generations),
            interval=(
                config.allocator_interval() if allocator_interval is None
                else allocator_interval
            ),
        )

    def _create(self, job: JobSpec) -> None:
        spec = {
            "resources": {"tpu": 1},
            "min_replicas": job.min_replicas,
            "max_replicas": job.max_replicas or self.num_chips,
            "preemptible": bool(job.preemptible),
        }
        validate_job_spec(spec)
        self.state.create_job(job.name, spec=spec)
        self.jobs[job.name] = job
        self.restart_counts[job.name] = 0
        self.failures[job.name] = 0
        self.events[job.name] = []

    def submit(self, job: JobSpec) -> None:
        """Add a job while the runner runs: the allocator places it in
        its next cycle, shrinking others where Pollux finds that better,
        and ``run()`` returns only once it has ended too."""
        with self._lock:
            self._create(job)
            if self._running:
                self._start(job)

    def stop_job(self, name: str) -> None:
        """Terminate a job from outside: its allocation is withdrawn, its
        supervising thread SIGTERMs it for a graceful checkpoint, and it
        is not relaunched (status Stopped, exit code 143). The status
        turns terminal at once, so the allocator never re-grants it."""
        self._stopped.add(name)
        self.state.update(name, allocation=[], topology=None, status="Stopped")

    def _job_env(self, job: JobSpec, num_replicas: int, topology) -> dict:
        record = self.state.get_job(job.name)
        base = dict(os.environ)
        base.update(job.extra_env)
        return job_environment(
            base, job.name, job.checkpoint_dir, num_replicas, topology,
            self.restart_counts[job.name], self.supervisor.url,
            trace_parent=record.trace_parent if record else None,
            handoff=job.handoff,
        )

    def _run_job(self, job: JobSpec) -> None:
        events = self.events[job.name]
        while True:
            if job.name in self._stopped:
                self.state.update(job.name, status="Stopped")
                self.exit_codes.setdefault(job.name, GRACEFUL_EXIT_CODE)
                return
            allocation, topology = self.state.get_launch_config(job.name)
            if not allocation:
                # Wait until the allocator gives this job slots.
                self.state.wait_for(
                    lambda jobs: bool(jobs[job.name].allocation)
                    or job.name in self._stopped,
                    timeout=5.0,
                )
                continue
            num_replicas = len(allocation)
            if num_replicas > max(_device_count(), 1):
                LOG.info(
                    "%d replicas on %d card(s): ranks share a card",
                    num_replicas, _device_count(),
                )
            LOG.info(
                "starting %s: replicas=%d restarts=%d topology=%s",
                job.name, num_replicas, self.restart_counts[job.name],
                topology,
            )
            self.state.update(
                job.name, status="Running",
                restarts=self.restart_counts[job.name],
            )
            events.append(
                {
                    "event": "launch", "time": time.time(),
                    "replicas": num_replicas, "allocation": list(allocation),
                    "restarts": self.restart_counts[job.name],
                }
            )
            try:
                # An injected fault models a failed launch; it rides the
                # same retry budget as a crashing worker.
                faults.maybe_fail("runner.launch.pre")
                proc = start_incarnation(
                    launch_command(job.script, job.script_args),
                    self._job_env(job, num_replicas, topology),
                )
            except faults.InjectedFault:
                LOG.warning("injected launch failure for %s", job.name)
                events.append({"event": "exit", "time": time.time(), "code": 1})
                code, signalled = 1, False
            else:
                self.procs[job.name] = proc
                try:
                    code, signalled = supervise(
                        proc, self.state, job.name, allocation, topology,
                        self.term_grace_period, events,
                        stop_if=lambda: job.name in self._stopped,
                    )
                finally:
                    if proc.poll() is None:
                        kill_incarnation(proc)
            if code == 0:
                self.state.update(job.name, status="Succeeded")
                self.exit_codes[job.name] = 0
                return
            if is_rescale(code, signalled):
                self.restart_counts[job.name] += 1
                continue
            self.failures[job.name] += 1
            withdraw_handoff_descriptor(job.checkpoint_dir)
            LOG.warning(
                "%s failed code=%s (%d/%d)", job.name, code,
                self.failures[job.name], self.max_failures,
            )
            if self.failures[job.name] > self.max_failures:
                self.state.update(job.name, status="Failed")
                self.exit_codes[job.name] = code
                return
            self.restart_counts[job.name] += 1

    def _start(self, job: JobSpec) -> None:  # holds-lock: _lock
        thread = threading.Thread(
            target=self._run_job, args=(job,), daemon=True,
            name=f"job-{job.name}",
        )
        self._threads.append(thread)
        thread.start()

    def run(self) -> dict[str, int]:
        """Run every job, the submitted ones too, to completion; returns
        exit codes by job."""
        self.supervisor.start()
        self.allocator.start()
        try:
            with self._lock:
                self._running = True
                for job in self.jobs.values():
                    self._start(job)
            while True:
                with self._lock:
                    live = [t for t in self._threads if t.is_alive()]
                    if not live:
                        self._running = False
                        return dict(self.exit_codes)
                live[0].join()
        finally:
            self._running = False
            self.allocator.stop()
            self.supervisor.stop()
