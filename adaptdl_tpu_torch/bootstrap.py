"""Job initialization for the port.

``initialize_job`` wires a training process into the elastic job: it
places the process on its device (raising if CUDA was asked for and is
absent), installs the graceful-preemption signal handlers, exports the
single replica of a standalone run and, for a job of several replicas,
joins the process group. The port runs one process per replica
(``python -m adaptdl_tpu_torch.launch`` starts them), so
``ADAPTDL_NUM_PROCESSES`` must equal ``ADAPTDL_NUM_REPLICAS``; a process
holding several replicas raises. Supervisor rendezvous and scheduling
hints belong to a later slice of the port and raise here rather than
being skipped.
"""

from __future__ import annotations

import atexit

import torch

from adaptdl_tpu_torch import _signal, collective, env
from adaptdl_tpu_torch.device import replica_device


def initialize_job(device="cuda") -> torch.device:
    """Initialize this process for elastic training and return its
    device (``cuda`` maps to this replica's card). Idempotent."""
    if env.supervisor_url():
        raise NotImplementedError(
            "supervisor rendezvous and scheduling hints are not ported "
            "to adaptdl_tpu_torch yet; unset ADAPTDL_SUPERVISOR_URL"
        )
    replicas, processes = env.num_replicas(), env.num_processes()
    if replicas != processes:
        raise NotImplementedError(
            "multi-replica data parallelism runs one process per replica "
            f"(python -m adaptdl_tpu_torch.launch); ADAPTDL_NUM_REPLICAS="
            f"{replicas} over ADAPTDL_NUM_PROCESSES={processes} would hold "
            "several replicas in one process"
        )
    coordinator = env.coordinator_addr()
    if processes > 1 and coordinator is None:
        raise RuntimeError(
            f"ADAPTDL_NUM_PROCESSES={processes} needs "
            "ADAPTDL_COORDINATOR_ADDR (host:port of rank 0's "
            "rendezvous); python -m adaptdl_tpu_torch.launch sets it"
        )
    resolved = replica_device(device, env.local_rank())
    _signal.install_handlers()
    if not env.num_replicas_is_set():
        env.set_num_replicas(1)
    if processes > 1 and not collective.initialized():
        host, port = coordinator.rsplit(":", 1)
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
