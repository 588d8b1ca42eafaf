"""Job initialization for the port.

``initialize_job`` wires a training process into the elastic job: it
resolves the device (raising if CUDA was asked for and is absent),
installs the graceful-preemption signal handlers and, for a standalone
run, exports the single replica it runs. Supervisor rendezvous,
scheduling hints and multi-replica process groups belong to later
slices of the port and raise here rather than being skipped.
"""

from __future__ import annotations

import torch

from adaptdl_tpu_torch import _signal, env
from adaptdl_tpu_torch.device import resolve_device


def initialize_job(device="cuda") -> torch.device:
    """Initialize this process for elastic training and return its
    device. Idempotent."""
    resolved = resolve_device(device)
    if env.supervisor_url():
        raise NotImplementedError(
            "supervisor rendezvous and scheduling hints are not ported "
            "to adaptdl_tpu_torch yet (the multi-replica slice); unset "
            "ADAPTDL_SUPERVISOR_URL"
        )
    if env.num_replicas() > 1 or env.num_processes() > 1:
        raise NotImplementedError(
            "multi-replica data parallelism is not ported to "
            "adaptdl_tpu_torch yet; run with ADAPTDL_NUM_REPLICAS=1"
        )
    _signal.install_handlers()
    if not env.num_replicas_is_set():
        env.set_num_replicas(1)
    return resolved
