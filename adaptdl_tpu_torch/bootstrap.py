"""Job initialization for the port.

``initialize_job`` wires a training process into the elastic job:

1. places the process on its device (raising if CUDA was asked for and
   is absent) and installs the graceful-preemption signal handlers;
2. under a supervisor (``ADAPTDL_SUPERVISOR_URL`` and ``ADAPTDL_JOB_ID``)
   with several processes, registers this rank (``PUT /register``) and
   long-polls ``GET /discover`` until every rank of its restart group is
   known; rank 0's address becomes the process group's host;
3. starts the heartbeat thread, which renews this rank's lease every
   ``ADAPTDL_HEARTBEAT_INTERVAL`` seconds and flushes the trace spans;
4. starts the preemption-notice listener when ``ADAPTDL_PREEMPT_POLL_S``
   asks for it, and in a successor of a planned rescale
   (``ADAPTDL_HANDOFF`` on, ``ADAPTDL_NUM_RESTARTS`` > 0) fetches the
   predecessor's handoff manifest on a side thread;
5. for a job of several replicas, joins the process group.

A warm successor (``ADAPTDL_WARMUP=1``, ``sched/warmup.py``) skips steps
2-4 before its hold: its liveness would commit the new allocation epoch
while the incumbent still trains, and no peer has drained yet for a
prefetch to find. Its ranks join the process group on the launcher's
rendezvous address, and :func:`start_deferred_liveness` registers them
and starts the heartbeats once the runner's ``go`` arrives.

It adopts ``ADAPTDL_TRACEPARENT`` first and opens the
``restart.first_step`` span, which the first profiled step closes. The
kernel libraries' cache on the share path is placed by
``ops/_build.py`` from the same environment when a kernel first builds.

The port runs one process per chip (``python -m
adaptdl_tpu_torch.launch`` starts them), so ``ADAPTDL_NUM_PROCESSES``
must equal ``ADAPTDL_NUM_REPLICAS`` as launched (the chips), or that
count times ``ADAPTDL_SEQ_SHARDS`` once an example has rewritten it to
the data-parallel replicas; a process holding several replicas raises.
"""

from __future__ import annotations

import atexit
import logging
import socket
import threading

import torch

from adaptdl_tpu_torch import (
    _signal,
    collective,
    env,
    handoff,
    metrics,
    rpc,
    sched_hints,
    trace,
)
from adaptdl_tpu_torch.device import replica_device
from adaptdl_tpu_torch.sched import preemption

LOG = logging.getLogger(__name__)

# Rendezvous retry budgets. Registration is small and idempotent, so it
# retries through supervisor blips; discover is a long poll with its own
# server-side timeout, so it gets few attempts and a generous deadline.
_REGISTER_ATTEMPTS = 6
_REGISTER_DEADLINE = 120.0
_DISCOVER_ATTEMPTS = 3
_DISCOVER_DEADLINE = 700.0


def _local_address() -> str:
    """The address this rank registers: ``ADAPTDL_POD_IP`` where set,
    else its host name's address, as the JAX worker registers; the
    rendezvous host from the environment if the name does not resolve."""
    address = env.pod_ip()
    if address:
        return address
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        LOG.warning("host name does not resolve; registering the "
                    "rendezvous host")
        coordinator = env.coordinator_addr()
        return coordinator.rsplit(":", 1)[0] if coordinator else env.master_addr()


def _register() -> bool:
    """Register this rank with the supervisor (``PUT /register``); False
    when there is no supervisor or a single process. Rides the resilient
    client: a supervisor blip is retried within a deadline.
    Re-registration is idempotent (keyed by group and rank), and a 404 is
    retried too: after a supervisor restart the job record returns a
    moment later."""
    url = env.supervisor_url()
    job = env.job_id()
    if not url or not job or env.num_processes() <= 1:
        return False
    rpc.default_client().put(
        f"{url}/register/{job}/{env.num_restarts()}/{env.process_rank()}",
        # The process count is the supervisor's commit quorum for a
        # pending allocation epoch.
        json={"address": _local_address(), "processes": env.num_processes()},
        endpoint=f"register/{job}",
        timeout=(5, 30),
        attempts=_REGISTER_ATTEMPTS,
        deadline=_REGISTER_DEADLINE,
        retry_statuses=rpc.RETRY_STATUSES + (404,),
    ).raise_for_status()
    return True


def _discover_peers() -> dict[int, str] | None:
    """Register and wait for every process of this restart group; returns
    rank -> address, or None when there is no supervisor or a single
    process."""
    if not _register():
        return None
    url, job = env.supervisor_url(), env.job_id()
    group = env.num_restarts()
    client = rpc.default_client()
    response = client.get(
        f"{url}/discover/{job}/{group}",
        params={"replicas": env.num_processes()},
        endpoint=f"discover/{job}",
        timeout=(5, 330),
        attempts=_DISCOVER_ATTEMPTS,
        deadline=_DISCOVER_DEADLINE,
    )
    response.raise_for_status()
    return {int(r): addr for r, addr in response.json().items()}


_heartbeat_stop: threading.Event | None = None
_heartbeat_thread: threading.Thread | None = None


def start_heartbeat() -> threading.Event | None:
    """Start the liveness-heartbeat thread (idempotent); returns its stop
    event, or None without a supervisor or with heartbeats disabled.
    Each beat after the first carries this rank's smoothed step time."""
    global _heartbeat_stop, _heartbeat_thread
    interval = env.heartbeat_interval()
    if not env.supervisor_url() or not env.job_id() or interval <= 0:
        return None
    if _heartbeat_stop is not None and not _heartbeat_stop.is_set():
        return _heartbeat_stop
    stop = threading.Event()
    rank = env.process_rank()

    def loop():
        sched_hints.send_heartbeat(rank=rank)
        while not stop.wait(interval):
            sched_hints.send_heartbeat(
                rank=rank, step_time_ewma=metrics.step_time_ewma()
            )
            # Every rank's spans reach the supervisor on this cadence;
            # the hint-cadence flush runs on rank 0 alone.
            trace.flush_to_supervisor()

    _heartbeat_thread = threading.Thread(
        target=loop, name="adaptdl-torch-heartbeat", daemon=True
    )
    _heartbeat_thread.start()
    _heartbeat_stop = stop
    return stop


def stop_heartbeat(timeout: float | None = 5.0) -> None:
    """Stop the heartbeat thread and join it and the handoff prefetch.
    Safe when none runs; a later :func:`start_heartbeat` starts a fresh
    one."""
    if _heartbeat_stop is not None:
        _heartbeat_stop.set()
    for thread in (_heartbeat_thread, _prefetch_thread):
        if thread is not None:
            thread.join(timeout)


_prefetch_thread: threading.Thread | None = None
_restart_span_armed = False
# True while a warm successor's supervisor traffic waits for its go.
_liveness_deferred = False


def start_deferred_liveness() -> None:
    """A warm successor's go: register this rank (its process group
    already formed) and start the heartbeats and the preemption listener
    that ``initialize_job`` deferred. A no-op when nothing was deferred."""
    global _liveness_deferred
    if not _liveness_deferred:
        return
    _liveness_deferred = False
    try:
        _register()
    except Exception:  # noqa: BLE001 - the heartbeats prove liveness too
        LOG.exception("registration after the warm cutover failed")
    start_heartbeat()
    preemption.ensure_listener()


def _at_exit() -> None:
    """Heartbeats stop (and the fit thread is joined, by metrics) before
    the interpreter finalizes; the spans recorded since the last flush,
    the final save's among them, go to the supervisor."""
    stop_heartbeat()
    trace.flush_to_supervisor()


atexit.register(_at_exit)


def initialize_job(device="cuda") -> torch.device:
    """Initialize this process for elastic training and return its
    device (``cuda`` maps to this replica's card). Idempotent."""
    global _restart_span_armed
    trace.init_from_env()
    if not _restart_span_armed:
        _restart_span_armed = True
        trace.begin_pending("restart.first_step", restarts=env.num_restarts())
    with trace.span("bootstrap.init", restarts=env.num_restarts()):
        return _initialize(device)


def _initialize(device) -> torch.device:
    global _prefetch_thread, _liveness_deferred
    replicas, processes = env.num_replicas(), env.num_processes()
    # One process per chip: ADAPTDL_NUM_REPLICAS counts the chips at
    # launch, or the data-parallel replicas of seq_shards chips each once
    # an example has rewritten it.
    if processes not in (replicas, replicas * env.seq_shards()):
        raise NotImplementedError(
            "multi-replica data parallelism runs one process per replica "
            f"(python -m adaptdl_tpu_torch.launch); ADAPTDL_NUM_REPLICAS="
            f"{replicas} over ADAPTDL_NUM_PROCESSES={processes} would hold "
            "several replicas in one process"
        )
    coordinator = env.coordinator_addr()
    if processes > 1 and coordinator is None and env.master_port() == 0:
        raise RuntimeError(
            f"ADAPTDL_NUM_PROCESSES={processes} needs "
            "ADAPTDL_COORDINATOR_ADDR (host:port of rank 0's "
            "rendezvous); python -m adaptdl_tpu_torch.launch sets it"
        )
    resolved = replica_device(device, env.local_rank())
    _signal.install_handlers()
    if not env.num_replicas_is_set():
        env.set_num_replicas(1)
    peers = None
    if env.warmup_flag():
        _liveness_deferred = True
    else:
        if not collective.initialized():
            try:
                peers = _discover_peers()
            except Exception:  # noqa: BLE001 - rendezvous falls back to env
                LOG.exception(
                    "supervisor discovery failed; using the launcher's "
                    "coordinator address"
                )
        start_heartbeat()
        preemption.ensure_listener()
        if (
            env.handoff_enabled() and env.num_restarts() > 0
            and (_prefetch_thread is None or not _prefetch_thread.is_alive())
        ):
            # A planned rescale's successor: discover the peer and fetch
            # its manifest while the rest of start-up runs.
            _prefetch_thread = threading.Thread(
                target=handoff.prefetch,
                name="adaptdl-torch-handoff-prefetch", daemon=True,
            )
            _prefetch_thread.start()
    if processes > 1 and not collective.initialized():
        # The host is rank 0's discovered address; the port comes from
        # the environment, so every rank agrees on it.
        if coordinator is not None:
            host, port = coordinator.rsplit(":", 1)
        else:
            host, port = env.master_addr(), env.master_port()
        if peers and 0 in peers:
            host = peers[0]
        collective.initialize(
            host,
            int(port),
            rank=env.process_rank(),
            world_size=processes,
            device=resolved,
            local_world_size=processes // max(env.num_nodes(), 1),
        )
        atexit.register(collective.teardown)
    return resolved
