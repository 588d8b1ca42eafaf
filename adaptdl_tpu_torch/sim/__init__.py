"""Discrete-event simulation of an elastic cluster: the port's copy of
``adaptdl_tpu.sim``.

See :mod:`adaptdl_tpu_torch.sim.engine` for the event loop and
:mod:`adaptdl_tpu_torch.sim.workload` for the trace format. Traces,
summaries and watch summaries are the JAX package's, byte for byte.
"""

from adaptdl_tpu_torch.sim.clock import VirtualClock  # noqa: F401
from adaptdl_tpu_torch.sim.engine import (  # noqa: F401
    ClusterSim,
    SimReport,
    run_trace,
)
from adaptdl_tpu_torch.sim.workload import (  # noqa: F401
    CATEGORIES,
    generate_trace,
    load_trace,
    resolve_job,
    write_trace,
)
