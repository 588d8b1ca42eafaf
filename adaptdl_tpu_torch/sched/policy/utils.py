"""Scheduler-facing job and node descriptors, the port's copy of
``adaptdl_tpu.sched.policy.utils``. A "node" is the unit of fast
interconnect (a host of GPUs here, a slice in the JAX package); the
resource key stays ``"tpu"``, the name the wire and the cluster state
carry for one accelerator slot."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable


@dataclass
class JobInfo:
    resources: dict[str, int]  # per-replica requests (e.g. {"tpu": 1})
    speedup_fn: Callable  # speedup(num_nodes, num_replicas) -> float
    creation_timestamp: float = 0.0
    min_replicas: int = 0
    max_replicas: int = 1
    preemptible: bool = True
    # Fractional goodput discount the policy applies to solutions that
    # move this job off its current allocation. None -> the policy's
    # assumed default; jobs that report measured checkpoint/restore
    # timings get a measured value instead (allocator.job_info_from_
    # hints), so cheap-to-rescale jobs move freely and expensive ones
    # stay put.
    restart_penalty: float | None = None
    # Measured wall seconds one checkpoint-restart costs this job
    # (final save + restore, the rescale critical path). Prices the
    # hazard expected-loss term: on a slice with reclaim hazard h the
    # policy charges ~h * restart_cost_s of goodput, so expensive-
    # restart jobs migrate to on-demand slices while cheap-restart
    # jobs soak up spot. None -> the policy's assumed default.
    restart_cost_s: float | None = None
    # Candidate mesh shapes ((sp, tp, ss, ep) tuples) the scheduler
    # may factorize this job's chips into — the job's meshShapeGrid
    # hint, carried so policy-level consumers (sim, dashboards,
    # dp-only equivalence tests) can see the searchable shape set
    # without reaching into the speedup function. None/((1,1,1,1),)
    # means the job is schedulable as pure data-parallel only.
    mesh_shape_grid: tuple | None = None

    def __post_init__(self):
        assert self.max_replicas > 0
        assert self.min_replicas <= self.max_replicas


@dataclass
class NodeInfo:
    resources: dict[str, int]  # total allocatable (e.g. {"tpu": 8})
    preemptible: bool = False  # spot/preemptible slice
    # Estimated reclaim hazard of this slice (expected preemption
    # notices per second; the cluster state maintains a per-slot-kind
    # EWMA from observed notices and the allocator stamps it here
    # each cycle). 0 = reliable capacity.
    hazard: float = 0.0
    extra: dict = field(default_factory=dict)
