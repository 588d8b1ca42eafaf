"""Speculative successor warm-up: the zero-downtime rescale protocol.

The port's copy of ``adaptdl_tpu.sched.warmup``. A planned rescale
serializes decide -> drain -> restart -> build -> restore, so the
successor's whole cold start (interpreter, imports, CUDA context, model,
trainer) is time the job does not train. Here that cold start overlaps
the incumbent's last steps:

- The allocator publishes its decision as a CANDIDATE first
  (``ClusterState.publish_candidate``, ``GET /candidate/{job}``), so the
  runner that sees the launch config move finds a matching target.
- The runner starts the successor with ``ADAPTDL_WARMUP=1`` BEFORE it
  signals the incumbent (:class:`WarmSuccessor`). The successor runs its
  cold start up to its state restore, prefetches the peer's chunks into
  the differential cache (``handoff.warm_prefetch``), writes the READY
  file and holds (:func:`maybe_hold`).
- Only then is the incumbent signalled; once it has drained, the runner
  checks the launch config against what the successor was built for and
  writes ``go`` into the CUTOVER file. The successor restores (pulling
  only the chunks that changed since its prefetch) and steps.
- Anything else (the successor dies while warming, the candidate was
  mispredicted or cleared by a rollback, the incumbent crashes before
  the cutover) discards it (``abort``, then SIGKILL) and the runner falls
  back to the cold planned path, bit-identically.

The channel is two files in a directory the runner makes, the JAX
package's wire format: ``ready`` (written by the successor) and
``cutover`` (``go`` or ``abort``, written by the runner). A port
successor is N processes, one per replica, under ``python -m
adaptdl_tpu_torch.launch``; N ranks map onto the two files so:

- every rank reads the one ``cutover`` file, so all ranks take the one
  verdict, and on ``abort`` every rank exits 143;
- the launcher hands rank r the ready path ``ready.r`` and writes
  ``ready`` itself once every rank's file exists, so the runner's
  ``ready`` means that every rank holds;
- :meth:`WarmSuccessor.discard` kills the launcher's whole process group,
  as ``multi_runner.kill_incarnation`` does, and the runner removes the
  directory once an adopted incarnation has ended (a rank cannot: its
  peers may not have read the verdict yet).

A warm successor sends the supervisor nothing before its ``go``
(``bootstrap`` defers registration, heartbeats and the preemption
listener to :func:`maybe_hold`): the successor's group must not commit
the new allocation epoch while the incumbent still trains. Its process
group forms before the hold, on the launcher's own rendezvous port.
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile
import time

from adaptdl_tpu_torch import env, faults, rpc, trace
from adaptdl_tpu_torch._signal import GRACEFUL_EXIT_CODE
from adaptdl_tpu_torch.sched.state import normalize_topology

LOG = logging.getLogger(__name__)

# Cutover-file verdicts: the whole wire format of the runner ->
# successor channel.
GO = "go"
ABORT = "abort"


def candidate_matches(candidate: dict | None, allocation, topology) -> bool:
    """Whether a published candidate predicts exactly this launch config:
    the runner warms a successor only for a config the allocator told it
    to expect, so a vanished candidate (rolled-back epoch, superseding
    decision) disables warm-up instead of racing it."""
    if not candidate:
        return False
    return list(candidate.get("allocation") or []) == list(
        allocation or []
    ) and normalize_topology(candidate.get("topology")) == normalize_topology(
        topology
    )


def fetch_candidate(
    supervisor_url: str | None = None, job: str | None = None
) -> dict | None:
    """The supervisor's published warm-up target for this job (``GET
    /candidate/{job}``), or None when nothing is predicted. Best effort:
    an unreachable supervisor means "warm nothing, rescale cold"."""
    sup = supervisor_url or env.supervisor_url()
    job = job or env.job_id()
    if not sup or not job:
        return None
    try:
        response = rpc.default_client().get(
            f"{sup}/candidate/{job}",
            endpoint=f"candidate/{job}",
            timeout=(2, 5),
            attempts=2,
            deadline=5.0,
            use_circuit=False,
        )
        if response.status_code != 200:
            return None
        body = response.json()
    except Exception:  # noqa: BLE001 - speculation is best effort
        LOG.debug("candidate readback failed", exc_info=True)
        return None
    if not isinstance(body, dict) or not body.get("allocation"):
        return None
    return {
        "allocation": list(body["allocation"]),
        "topology": body.get("topology"),
        "batchConfig": body.get("batchConfig"),
        "epoch": int(body.get("epoch", -1)),
    }


class WarmSuccessor:
    """One speculatively started successor incarnation (its launcher and
    every rank) and its cutover channel. The runner owns the lifecycle:
    ``spawn`` -> ``wait_ready`` -> (incumbent drains) -> ``matches`` ->
    ``cutover`` | ``discard``."""

    def __init__(
        self, argv: list[str], job_env: dict, allocation, topology,
        restarts: int,
    ):
        self.argv = list(argv)
        self.allocation = list(allocation or [])
        self.topology = normalize_topology(topology)
        self.restarts = int(restarts)
        self.workdir = tempfile.mkdtemp(prefix="adaptdl-torch-warmup-")
        self.ready_file = os.path.join(self.workdir, "ready")
        self.cutover_file = os.path.join(self.workdir, "cutover")
        self.env = dict(job_env)
        self.env["ADAPTDL_WARMUP"] = "1"
        self.env["ADAPTDL_WARMUP_READY_FILE"] = self.ready_file
        self.env["ADAPTDL_WARMUP_CUTOVER_FILE"] = self.cutover_file
        self.proc = None

    def spawn(self) -> None:
        """Start the successor in warm-up mode, in a process group of its
        own (raises InjectedFault under a ``warmup.spawn`` schedule: the
        caller falls back to the cold path)."""
        from adaptdl_tpu_torch.sched.multi_runner import start_incarnation

        faults.maybe_fail("warmup.spawn")
        self.proc = start_incarnation(self.argv, self.env)

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def wait_ready(self, deadline_s: float) -> bool:
        """Block (while the incumbent keeps training) until every rank of
        the successor holds, it dies, or the deadline passes: warm-up
        must never delay a rescale by more than it saves."""
        deadline = time.monotonic() + max(deadline_s, 0.0)
        while time.monotonic() < deadline:
            if os.path.exists(self.ready_file):
                return True
            if not self.alive():
                return False
            time.sleep(0.05)
        return os.path.exists(self.ready_file)

    def matches(self, allocation, topology) -> bool:
        """Whether this successor was built for exactly the launch config
        now published; anything else is a misprediction."""
        return list(allocation or []) == self.allocation and (
            normalize_topology(topology) == self.topology
        )

    def cutover(self):
        """Adopt: release the held successor (raises InjectedFault under a
        ``warmup.cutover`` schedule: the caller discards and relaunches
        cold). Returns its launcher process."""
        faults.maybe_fail("warmup.cutover")
        _write_atomic(self.cutover_file, GO)
        return self.proc

    def cleanup(self) -> None:
        """Remove the channel directory (after the adopted incarnation
        ended, or with a discard)."""
        shutil.rmtree(self.workdir, ignore_errors=True)

    def discard(self, reason: str = "") -> None:
        """Abandon the speculation: tell held ranks to exit, kill the
        launcher's process group regardless (a rank may be wedged
        mid-import) and remove the channel. Falling back costs exactly the
        cold path: the successor never registered, restored or wrote
        anything durable."""
        from adaptdl_tpu_torch.sched.multi_runner import kill_incarnation

        if reason:
            LOG.info("discarding warm successor: %s", reason)
        try:
            _write_atomic(self.cutover_file, ABORT)
        except OSError:
            pass
        if self.proc is not None:
            kill_incarnation(self.proc)
        self.cleanup()


def _write_atomic(path: str, verdict: str) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(verdict)
    os.replace(tmp, path)


# ---- job side (runs in every rank of the successor) ---------------------

_held = False
# What this process's hold did: whether it held, its verdict and seconds
# (the examples' reports carry them).
_hold = {"held": False, "verdict": None, "seconds": None}


def hold_info() -> dict:
    return dict(_hold)


def _reset_state() -> None:
    """Forget the hold (tests)."""
    global _held
    _held = False
    _hold.update(held=False, verdict=None, seconds=None)


def maybe_hold() -> bool:
    """The warm successor's half of the protocol, called from
    ``checkpoint.load_state`` just before the restore (so every script
    warms everything up to it), and callable earlier by a script. A no-op
    in a normal launch; under ``ADAPTDL_WARMUP=1`` it prefetches the
    peer's chunks into the differential cache, writes the ready file and
    blocks on the runner's verdict. ``go`` starts the deferred liveness
    (registration, heartbeats) and returns True, once the predecessor's
    shard server is discoverable or the handoff timeout has passed;
    ``abort`` exits 143, so nothing counts it as a failure. Idempotent:
    the first call holds, later ones return False at once."""
    global _held
    if _held or not env.warmup_flag():
        return False
    _held = True
    if env.handoff_enabled():
        from adaptdl_tpu_torch import handoff

        try:
            handoff.warm_prefetch()
        except Exception:  # noqa: BLE001 - speculation is best effort
            LOG.debug("warm prefetch failed", exc_info=True)
    start = time.monotonic()
    with trace.span("warmup.hold") as attrs:
        ready = env.warmup_ready_file()
        if ready:
            _write_atomic(ready, "ready")
        verdict = _await_cutover(env.warmup_cutover_file())
        attrs["verdict"] = verdict
    _hold.update(held=True, verdict=verdict, seconds=time.monotonic() - start)
    if verdict != GO:
        LOG.info("warm-up discarded (%s); exiting gracefully", verdict)
        # os._exit: mid-start-up there may be no exception path to a
        # clean shutdown, and exit hooks must not write anything durable
        # from a discarded speculation.
        os._exit(GRACEFUL_EXIT_CODE)
    from adaptdl_tpu_torch import bootstrap

    bootstrap.start_deferred_liveness()
    if env.handoff_enabled():
        _await_predecessor_server(env.handoff_timeout_s())
    return True


def _await_predecessor_server(timeout_s: float) -> None:
    """The go comes right after the incumbent's exit 143, and the shard
    server its drain left behind advertises itself a moment later: wait
    (bounded) until it is discoverable, so the restore pulls from it
    instead of finding no peer and reading storage."""
    from adaptdl_tpu_torch import handoff

    deadline = time.monotonic() + timeout_s
    while handoff.discover_url() is None and time.monotonic() < deadline:
        time.sleep(0.05)


def _await_cutover(path: str | None) -> str:
    """Poll the cutover file until the runner renders a verdict. No path
    (direct use, no runner) proceeds at once; an expired deadline counts
    as ``abort``: the runner is gone, and proceeding could fight an
    incumbent that still owns the card."""
    if not path:
        return GO
    # Generous: the hold spans the incumbent's whole drain (its final
    # save), not just the warm-up window.
    deadline = time.monotonic() + max(env.warmup_deadline_s() * 6.0, 60.0)
    while time.monotonic() < deadline:
        try:
            with open(path, encoding="utf-8") as f:
                return f.read().strip() or GO
        except OSError:
            time.sleep(0.05)
    return ABORT
