"""Discrete-event cluster simulator (the port's copy of
``adaptdl_tpu.sim.engine``).

Drives the REAL scheduler — :class:`PolluxPolicy`,
:class:`Allocator` (``optimize_once``), and :class:`ClusterState` —
under a virtual clock, replaying a job-arrival trace with fitted
goodput models standing in for real training (the Pollux OSDI'21
evaluation methodology). A policy change is scored on 1k jobs / 10k
slots in seconds, and a fixed seed reproduces the summary
bit-for-bit: every deadline, hazard stamp, and completion time inside
``ClusterState`` derives from the injected :class:`VirtualClock`, job
populations resolve deterministically from trace-record seeds, and
the NSGA-II search is internally seeded.

What IS deterministic: everything in :meth:`SimReport.summary` —
makespan, JCTs, queue times, goodput, finish-time fairness, restart
and preemption counts. What is NOT (and is reported separately by
:meth:`SimReport.latency`): the allocator's real decision latency —
the wall-clock cost of each ``optimize_once`` call, which is exactly
the number the incremental-allocator work optimizes.

Event kinds: job arrival/departure, hint updates sampled from the
fitted goodput/restart-stat models, allocator cycles, and preemption
notices routed through the existing hazard machinery
(``ClusterState.report_preemption``).
"""

from __future__ import annotations

import json
import logging
import random
import time
from dataclasses import dataclass, field

import numpy as np

from adaptdl_tpu_torch.goodput import GoodputFunction
from adaptdl_tpu_torch.sched.allocator import Allocator
from adaptdl_tpu_torch.sched.policy import NodeInfo, PolluxPolicy
from adaptdl_tpu_torch.sched.state import FINISHED, ClusterState
from adaptdl_tpu_torch.sim import events as ev
from adaptdl_tpu_torch.sim.clock import VirtualClock
from adaptdl_tpu_torch.sim.events import Event, EventQueue
from adaptdl_tpu_torch.sim.workload import (
    SimJobSpec,
    hints_payload,
    percentile as _pct,
    resolve_job,
)

LOG = logging.getLogger(__name__)

# Virtual seconds between a job's (re)allocation and its next hints
# post — the profiling delay before the scheduler learns the model
# (a few profiled steps at the new scale, not a full fit interval:
# posting quickly keeps the 2x-profiling-gate ramp inside one
# allocator cycle per doubling).
PROFILE_DELAY_S = 15.0
_EPS = 1e-9


_DP_TOPO = (1, 1, 1, 1, 1)


def _topo_tuple(topology: dict | None) -> tuple[int, int, int, int, int]:
    """A published topology dict as the (sp, tp, ss, ep, micro) tuple
    the goodput model prices."""
    topology = topology or {}
    ss = max(int(topology.get("stageShards", 1)), 1)
    return (
        max(int(topology.get("seqShards", 1)), 1),
        max(int(topology.get("modelShards", 1)), 1),
        ss,
        max(int(topology.get("expertShards", 1)), 1),
        max(int(topology.get("pipelineMicro", 1)), 1) if ss > 1 else 1,
    )


@dataclass
class _SimJob:
    spec: SimJobSpec
    goodput_fn: GoodputFunction
    work_total: float
    ideal_rate: float  # goodput at the requested fixed allocation
    work_done: float = 0.0
    goodput: float = 0.0  # current useful-examples/s (0 = stalled)
    alloc: tuple[str, ...] = ()
    topo: tuple = _DP_TOPO  # published mesh shape the job runs
    restart_until: float = 0.0
    gen: int = 0  # bumped on any rate change; stale finish events die
    first_alloc_t: float | None = None
    finish_t: float | None = None
    restarts: int = 0
    profiled: int = 0  # maxProfiledReplicas last posted
    hints_pending: bool = False
    mesh_assignments: int = 0  # times published with a non-DP shape
    _cache: dict = field(default_factory=dict)

    @property
    def done(self) -> bool:
        return self.finish_t is not None

    def rate_at(
        self,
        num_nodes: int,
        replicas: int,
        topo: tuple = _DP_TOPO,
    ) -> float:
        """Best adaptive goodput of this job at (slices, chips) under
        the published mesh shape and its own fitted model (the
        dataloader self-tunes its batch geometry locally). ``topo``
        is (sp, tp, ss, ep, micro); the chips factor as dp =
        replicas // (sp*tp*ss*ep) data-parallel groups. Cached — the
        same points recur every cycle."""
        key = (num_nodes, replicas, topo)
        if key not in self._cache:
            sp, tp, ss, ep, micro = topo
            group = sp * tp * ss * ep
            dp = replicas // group if group > 1 else replicas
            if replicas <= 0 or dp <= 0 or dp * group != replicas:
                # Unfactorizable publication (shouldn't happen — the
                # policy derives the shape from the chip count);
                # price it as dp-only rather than stall the job.
                dp, sp, tp, ss, ep, micro = replicas, 1, 1, 1, 1, 1
            if dp <= 0:
                self._cache[key] = 0.0
            else:
                goodput, _, _ = self.goodput_fn.optimize(
                    np.asarray([min(num_nodes, dp)]),
                    np.asarray([dp]),
                    max_batch_size=self.spec.max_bsz,
                    atomic_bsz_range=self.spec.bounds,
                    accumulation=True,
                    seq_shards=sp,
                    model_shards=tp,
                    stage_shards=ss,
                    pipeline_micro=micro,
                    expert_shards=ep,
                )
                self._cache[key] = float(np.atleast_1d(goodput)[0])
        return self._cache[key]


class ClusterSim:
    """One simulated cluster run over a trace.

    Args:
      records: trace records (``workload.load_trace`` /
        ``generate_trace``).
      slices: number of TPU slices; chips_per_slice chips each.
      seed: drives preemption-victim choice and reclaim arrivals.
      interval: virtual seconds between allocator cycles.
      fixed: score the fixed-allocation baseline instead of Pollux —
        every job gets its requested replica count, first-come
        first-served, and never changes.
      spot_fraction / reclaims_per_slot_hour: preemptible capacity and
        its reclaim rate (0 disables preemption events).
    """

    def __init__(
        self,
        records: list[dict],
        slices: int = 16,
        chips_per_slice: int = 8,
        seed: int = 0,
        interval: float = 60.0,
        fixed: bool = False,
        spot_fraction: float = 0.0,
        reclaims_per_slot_hour: float = 0.0,
        reclaim_notice_s: float = 30.0,
        reclaim_outage_s: float = 600.0,
        max_sim_s: float = 400_000.0,
        policy: PolluxPolicy | None = None,
        dirty_threshold: float | None = None,
        full_every: int | None = None,
        dp_only: bool = False,
    ):
        self.clock = VirtualClock()
        self.queue = EventQueue()
        self.fixed = bool(fixed)
        # dp_only strips the mesh hints (max*Shards / meshShapeGrid)
        # from every job's posts, so the REAL policy runs its
        # replica-only search — the comparison arm that prices what
        # mesh-shape elasticity is worth on a trace.
        self.dp_only = bool(dp_only)
        self.chips_per_slice = int(chips_per_slice)
        self.interval = float(interval)
        self.max_sim_s = float(max_sim_s)
        self.reclaim_notice_s = float(reclaim_notice_s)
        self.reclaim_outage_s = float(reclaim_outage_s)
        self._rng = random.Random(int(seed))
        spot = int(round(slices * spot_fraction))
        self._inventory: dict[str, NodeInfo] = {
            f"slice-{i:05d}": NodeInfo(
                resources={"tpu": self.chips_per_slice},
                preemptible=i < spot,
            )
            for i in range(int(slices))
        }
        self._reclaim_rate = (
            reclaims_per_slot_hour / 3600.0
        ) * max(spot, 0)
        self._reclaimed: dict[str, NodeInfo] = {}
        # state_dir="" pins the simulated state IN-MEMORY regardless
        # of ADAPTDL_SCHED_STATE_DIR: a sim run on a supervisor host
        # must never journal thousands of fake jobs into the real
        # durable state directory (or pay an fsync per event).
        self.state = ClusterState(
            state_dir="", alloc_commit_timeout=0.0, clock=self.clock
        )
        # Static inventory: widen the autoscaling utilization band so
        # the policy actually uses free capacity instead of packing
        # for a shrink that will never come (no expander here).
        self._policy = policy or PolluxPolicy(
            pop_size=16, generations=10, util_band=(0.0, 1.0)
        )
        self.allocator = Allocator(
            self.state,
            lambda: dict(self._inventory),
            node_template=NodeInfo(
                resources={"tpu": self.chips_per_slice}
            ),
            policy=self._policy,
            interval=self.interval,
            # Steady state rides the incremental path: arrivals plus
            # ramping jobs routinely dirty >25% of the ACTIVE set, and
            # a full partitioned re-solve every cycle both churns
            # settled jobs (restarts) and dominates the wall clock.
            dirty_threshold=(
                0.5 if dirty_threshold is None else dirty_threshold
            ),
            full_every=full_every,
        )
        self.jobs: dict[str, _SimJob] = {}
        self._arrivals_pending = 0
        self._alloc_scheduled = False
        self._alloc_cycles = 0
        self._last_t = 0.0
        self._decide_s: list[float] = []
        self._wall_start: float | None = None
        self._wall_s = 0.0
        self._preempt_notices = 0
        # Fixed-baseline bookkeeping: per-slice free chips + FIFO of
        # jobs waiting for their requested count.
        self._free = {
            key: self.chips_per_slice for key in self._inventory
        }
        self._waiting: list[str] = []
        for record in sorted(
            records, key=lambda r: (float(r["t"]), r["job"])
        ):
            spec = resolve_job(record)
            goodput_fn = GoodputFunction(
                spec.perf, spec.grad, spec.init_bsz
            )
            req_nodes = -(-spec.requested // self.chips_per_slice)
            atomic = max(spec.init_bsz // spec.requested, 1)
            ideal = float(
                np.atleast_1d(
                    goodput_fn.evaluate(
                        np.asarray([req_nodes]),
                        np.asarray([spec.requested]),
                        np.asarray([atomic]),
                        np.asarray([0]),
                    )
                )[0]
            )
            job = _SimJob(
                spec=spec,
                goodput_fn=goodput_fn,
                # The job's total useful work: its target duration at
                # the requested fixed allocation — both arms of the
                # retention comparison run exactly this much work.
                work_total=max(spec.duration_s * ideal, _EPS),
                ideal_rate=max(ideal, _EPS),
            )
            self.jobs[spec.key] = job
            self.queue.push(
                Event(spec.arrival, ev.ARRIVE, {"key": spec.key})
            )
            self._arrivals_pending += 1

    # -- progress integration ------------------------------------------

    def _advance_to(self, t: float) -> None:  # replay-pure
        """Integrate every running job's useful work from the previous
        event time to ``t`` (restart downtime excluded)."""
        t0 = self._last_t
        if t <= t0:
            return
        for job in self.jobs.values():
            if job.done or job.goodput <= 0:
                continue
            begin = max(t0, job.restart_until)
            if t > begin:
                job.work_done += job.goodput * (t - begin)
        self._last_t = t

    def _schedule_finish(self, job: _SimJob, now: float) -> None:  # replay-pure
        if job.done or job.goodput <= 0:
            return
        remaining = job.work_total - job.work_done
        if remaining <= 0:
            eta = max(now, job.restart_until)
        else:
            eta = max(now, job.restart_until) + remaining / job.goodput
        self.queue.push(
            Event(
                eta,
                ev.FINISH,
                {"key": job.spec.key, "gen": job.gen},
            )
        )

    # -- shared helpers ------------------------------------------------

    def _set_allocation(
        self,
        job: _SimJob,
        alloc: tuple[str, ...],
        now: float,
        topo: tuple = _DP_TOPO,
    ) -> None:
        """Apply an allocation (or mesh-shape) change to the simulated
        job: charge a checkpoint-restart when it leaves a non-empty
        allocation (a topology change restarts too — the worker
        rebuilds its mesh), recompute its goodput at the published
        shape, and re-arm its completion event."""
        if alloc == job.alloc and topo == job.topo:
            return
        if job.alloc:
            job.restarts += 1
            job.restart_until = max(
                job.restart_until, now + job.spec.restart_cost_s
            )
        job.alloc = alloc
        job.topo = topo
        job.gen += 1
        if alloc and topo != _DP_TOPO:
            job.mesh_assignments += 1
        replicas = len(alloc)
        nodes = len(set(alloc))
        if not replicas:
            job.goodput = 0.0
        elif self.fixed:
            # The fixed-allocation baseline runs the USER's config:
            # requested replicas, static batch size — no adaptive
            # batch tuning without the elastic machinery (the Pollux
            # paper's comparison arm).
            job.goodput = job.ideal_rate
        else:
            job.goodput = job.rate_at(nodes, replicas, topo)
        if replicas and job.first_alloc_t is None:
            job.first_alloc_t = now
            self.queue.push(
                Event(
                    now + PROFILE_DELAY_S,
                    ev.HINTS,
                    {"key": job.spec.key},
                )
            )
            job.hints_pending = True
        elif (
            replicas > job.profiled
            and job.profiled > 0
            and not job.hints_pending
        ):
            # Running past the profiled range: the next hints post
            # raises maxProfiledReplicas so the 2x profiling gate can
            # open further.
            self.queue.push(
                Event(
                    now + PROFILE_DELAY_S,
                    ev.HINTS,
                    {"key": job.spec.key},
                )
            )
            job.hints_pending = True
        self._schedule_finish(job, now)

    def _complete(self, job: _SimJob, now: float) -> None:
        job.finish_t = now
        job.goodput = 0.0
        job.gen += 1
        self.state.update(job.spec.key, status="Succeeded")
        if self.fixed:
            for slot in job.alloc:
                self._free[slot] = self._free.get(slot, 0) + 1
            job.alloc = ()
            self._drain_waiting(now)

    # -- fixed-allocation baseline -------------------------------------

    def _try_place_fixed(self, job: _SimJob, now: float) -> bool:
        want = job.spec.requested
        picked: list[str] = []
        for slot in sorted(self._free):
            if slot in self._reclaimed:
                continue
            take = min(self._free[slot], want - len(picked))
            picked.extend([slot] * take)
            if len(picked) >= want:
                break
        if len(picked) < want:
            return False
        for slot in picked:
            self._free[slot] -= 1
        self.state.update(job.spec.key, allocation=list(picked))
        self._set_allocation(job, tuple(picked), now)
        return True

    def _drain_waiting(self, now: float) -> None:
        while self._waiting:
            job = self.jobs[self._waiting[0]]
            if not self._try_place_fixed(job, now):
                return
            self._waiting.pop(0)

    # -- event handlers ------------------------------------------------

    def _handle_arrive(self, event: Event) -> None:
        now = event.time
        self._arrivals_pending -= 1
        job = self.jobs[event.payload["key"]]
        self.state.create_job(
            job.spec.key,
            spec={
                "min_replicas": 0,
                "max_replicas": job.spec.max_replicas,
                "resources": {"tpu": 1},
                "preemptible": True,
                # Watch accounting: the workload category is the
                # tenant (fairness curves per size class), and the
                # requested fixed allocation is the fairness-rho
                # denominator — the same ask the trace's duration is
                # defined against.
                "tenant": job.spec.category,
                "requested": job.spec.requested,
            },
        )
        self.state.update(job.spec.key, status="Running")
        if self.fixed:
            if not self._try_place_fixed(job, now):
                self._waiting.append(job.spec.key)
        else:
            # The real single-job-arrival cheap path: first-fit the
            # new job immediately (PolluxPolicy.allocate_job) instead
            # of making it wait out the optimization cadence.
            self._place_arrival(job, now)
            self._ensure_alloc_cycle(now)

    def _place_arrival(self, job: _SimJob, now: float) -> None:
        from adaptdl_tpu_torch.sched.allocator import job_info_from_hints

        used: dict[str, int] = {}
        for other in self.jobs.values():
            if other.done:
                continue
            for slot in other.alloc:
                used[slot] = used.get(slot, 0) + 1
        free = {
            key: NodeInfo(
                resources={
                    "tpu": max(
                        node.resources.get("tpu", 0)
                        - used.get(key, 0),
                        0,
                    )
                },
                preemptible=node.preemptible,
            )
            for key, node in self._inventory.items()
        }
        info = job_info_from_hints(
            None,
            {"min_replicas": 0, "max_replicas": job.spec.max_replicas},
            now,
        )
        alloc = self._policy.allocate_job(
            info, free, quarantined=set(self.state.draining_slots())
        )
        if alloc:
            self.state.update(job.spec.key, allocation=list(alloc))
            self._set_allocation(job, tuple(alloc), now)

    def _ensure_alloc_cycle(self, now: float, delay: float = 0.0) -> None:
        if self._alloc_scheduled or self.fixed:
            return
        self._alloc_scheduled = True
        self.queue.push(Event(now + delay, ev.ALLOC, {}))

    def _emit_watch(self) -> None:  # replay-pure
        """The watch store's measured half, sim-side: every running job's
        integrated goodput feeds the SAME ClusterState entry point the
        supervisor's hint intake uses, so the allocator-cycle sampler
        emits the identical record stream a live cluster would —
        fairness/drift curves at 1k jobs from a simulated run,
        bit-identical at fixed seed (virtual-clock stamps, no wall
        reads on this path)."""
        for key in sorted(self.jobs):
            job = self.jobs[key]
            if job.done or not job.alloc:
                continue
            self.state.observe_measured(key, job.goodput)

    def _handle_alloc(self, event: Event) -> None:
        now = event.time
        self._alloc_scheduled = False
        self._alloc_cycles += 1
        self._emit_watch()
        wall = time.monotonic()
        try:
            self.allocator.optimize_once()
        finally:
            self._decide_s.append(time.monotonic() - wall)
        # Mirror the published allocations (and mesh shapes) onto the
        # simulated jobs.
        for key, job in self.jobs.items():
            if job.done:
                continue
            record = self.state.get_job(key)
            if record is None or record.status in FINISHED:
                continue
            self._set_allocation(
                job,
                tuple(record.allocation),
                now,
                topo=_topo_tuple(record.topology),
            )
            # A job still below its profiling cap keeps nudging the
            # allocator — the stand-in for the periodic sched-hints
            # repost every live job's fit thread sends (rank 0 posts
            # on the ADAPTDL_FIT_INTERVAL cadence, which keeps an
            # under-allocated job in the optimizer's working set).
            # Throttled to alternate cycles so steady-state dirtiness
            # stays under the full-cycle threshold and ramping rides
            # the incremental path (which re-searches the dirty set
            # against dedicated free-capacity candidates) instead of
            # forcing a cluster-wide re-solve every cycle.
            if (
                self._alloc_cycles % 2 == 0
                and job.profiled
                and len(job.alloc) < min(
                    2 * job.profiled, job.spec.max_replicas
                )
            ):
                self.state.mark_job_dirty(key)
        if self._arrivals_pending or any(
            not job.done for job in self.jobs.values()
        ):
            self._ensure_alloc_cycle(now, delay=self.interval)

    def _handle_hints(self, event: Event) -> None:
        job = self.jobs[event.payload["key"]]
        job.hints_pending = False
        if job.done:
            return
        record = self.state.get_job(job.spec.key)
        if record is None or record.status in FINISHED:
            return
        job.profiled = max(job.profiled, len(job.alloc), 1)
        self.state.update(
            job.spec.key,
            hints=hints_payload(
                job.spec,
                profiled=job.profiled,
                dp_only=self.dp_only,
            ),
        )

    def _handle_finish(self, event: Event) -> None:
        job = self.jobs[event.payload["key"]]
        if job.done or job.gen != event.payload["gen"]:
            return
        if job.work_done + _EPS < job.work_total:
            # The rate changed without a gen bump (shouldn't happen,
            # but a mis-scheduled completion must re-arm, not finish
            # early).
            self._schedule_finish(job, event.time)
            return
        self._complete(job, event.time)

    def _handle_preempt(self, event: Event) -> None:
        now = event.time
        self._chain_preempt(now)
        occupied = sorted(
            (slot, key)
            for key, job in self.jobs.items()
            if not job.done
            for slot in set(job.alloc)
            if self._inventory.get(slot) is not None
            and self._inventory[slot].preemptible
        )
        if not occupied:
            return
        slot, key = occupied[
            self._rng.randrange(len(occupied))
        ]
        self._preempt_notices += 1
        # Through the REAL hazard machinery: marks the job draining,
        # withdraws the slot for the notice window, charges the
        # per-kind hazard EWMA, and kicks the allocator.
        self.state.report_preemption(
            key, slot=slot, notice_s=self.reclaim_notice_s
        )
        # The kicked cycle overlaps the notice window.
        self._ensure_alloc_cycle(now, delay=1.0)
        self.queue.push(
            Event(
                now + self.reclaim_notice_s,
                ev.SLOT_RETURN,
                {"slot": slot, "phase": "reclaim"},
            )
        )

    def _handle_slot_return(self, event: Event) -> None:
        now = event.time
        slot = event.payload["slot"]
        if event.payload.get("phase") == "reclaim":
            node = self._inventory.pop(slot, None)
            if node is not None:
                self._reclaimed[slot] = node
                self.queue.push(
                    Event(
                        now + self.reclaim_outage_s,
                        ev.SLOT_RETURN,
                        {"slot": slot, "phase": "return"},
                    )
                )
                if self.fixed:
                    # The baseline is NOT immune to reclaims: a fixed
                    # job on the vanished slot dies, pays its restart
                    # cost, and re-queues for its requested count —
                    # otherwise --compare-fixed under spot flags would
                    # score an adaptive arm that pays reclaim costs
                    # against a baseline that ignores them.
                    self._reclaim_fixed_jobs(slot, now)
            self._ensure_alloc_cycle(now, delay=0.0)
            return
        node = self._reclaimed.pop(slot, None)
        if node is not None:
            self._inventory[slot] = node
            self._ensure_alloc_cycle(now, delay=0.0)
            if self.fixed:
                self._drain_waiting(now)

    def _reclaim_fixed_jobs(self, slot: str, now: float) -> None:
        for key, job in self.jobs.items():
            if job.done or slot not in job.alloc:
                continue
            for held in job.alloc:
                self._free[held] = self._free.get(held, 0) + 1
            self.state.update(key, allocation=[])
            # _set_allocation charges the restart (non-empty -> empty
            # is a checkpoint-restore on the next placement).
            self._set_allocation(job, (), now)
            if not self._try_place_fixed(job, now):
                self._waiting.append(key)

    def _chain_preempt(self, now: float) -> None:
        if self._reclaim_rate > 0:
            self.queue.push(
                Event(
                    now + self._rng.expovariate(self._reclaim_rate),
                    ev.PREEMPT,
                    {},
                )
            )

    # -- the loop ------------------------------------------------------

    _HANDLERS = {
        ev.ARRIVE: "_handle_arrive",
        ev.ALLOC: "_handle_alloc",
        ev.HINTS: "_handle_hints",
        ev.FINISH: "_handle_finish",
        ev.PREEMPT: "_handle_preempt",
        ev.SLOT_RETURN: "_handle_slot_return",
    }

    def run(self) -> "SimReport":
        self._wall_start = time.monotonic()
        self._chain_preempt(0.0)
        if not self.fixed:
            self._ensure_alloc_cycle(0.0)
        while len(self.queue):
            event = self.queue.pop()
            if event.time > self.max_sim_s:
                LOG.warning(
                    "sim horizon %.0fs reached with %d jobs "
                    "incomplete",
                    self.max_sim_s,
                    sum(1 for j in self.jobs.values() if not j.done),
                )
                break
            self.clock.advance_to(event.time)
            self._advance_to(event.time)
            getattr(self, self._HANDLERS[event.kind])(event)
            if all(job.done for job in self.jobs.values()):
                break
        self._wall_s = time.monotonic() - self._wall_start
        return SimReport(self)


class SimReport:
    """Metrics sink: the deterministic summary (fixed seed ⇒
    bit-identical) and the real decision-latency report, kept apart
    so the determinism gate can compare one and print the other."""

    def __init__(self, sim: ClusterSim):
        self._sim = sim
        self.jobs = sim.jobs

    def summary(self) -> dict:
        """Deterministic virtual-time metrics. Finish-time fairness
        follows the Pollux framing: rho = actual JCT / the job's ideal
        JCT at its requested fixed allocation with zero queueing (the
        trace's ``duration``); rho < 1 means the policy beat the ask."""
        sim = self._sim
        done = [job for job in self.jobs.values() if job.done]
        jcts = [
            job.finish_t - job.spec.arrival for job in done
        ]
        queues = [
            job.first_alloc_t - job.spec.arrival
            for job in self.jobs.values()
            if job.first_alloc_t is not None
        ]
        rhos = [
            (job.finish_t - job.spec.arrival) / job.spec.duration_s
            for job in done
        ]
        # Effective goodput vs the requested-fixed ideal rate: how
        # fast the policy actually ran each job's work, normalized so
        # the number is comparable across arms and job sizes.
        goodputs = [
            (job.work_total / max(job.finish_t - job.spec.arrival, _EPS))
            / job.ideal_rate
            for job in done
        ]
        r6 = lambda x: round(float(x), 6)  # noqa: E731
        return {
            "jobs": len(self.jobs),
            "completed": len(done),
            "mode": "fixed" if sim.fixed else "pollux",
            "slices": len(sim._inventory) + len(sim._reclaimed),
            "chips_per_slice": sim.chips_per_slice,
            "makespan_s": r6(
                max((job.finish_t for job in done), default=0.0)
            ),
            "jct_mean_s": r6(sum(jcts) / len(jcts)) if jcts else 0.0,
            "jct_p50_s": r6(_pct(jcts, 0.5)),
            "jct_p90_s": r6(_pct(jcts, 0.9)),
            "queue_mean_s": (
                r6(sum(queues) / len(queues)) if queues else 0.0
            ),
            "queue_p50_s": r6(_pct(queues, 0.5)),
            "queue_p90_s": r6(_pct(queues, 0.9)),
            "avg_goodput_x_ideal": (
                r6(sum(goodputs) / len(goodputs)) if goodputs else 0.0
            ),
            "fairness_rho_p50": r6(_pct(rhos, 0.5)),
            "fairness_rho_p90": r6(_pct(rhos, 0.9)),
            "fairness_rho_max": r6(max(rhos, default=0.0)),
            "restarts_total": sum(
                job.restarts for job in self.jobs.values()
            ),
            "preempt_notices": sim._preempt_notices,
            "dp_only": sim.dp_only,
            # Jobs the policy ever shaped beyond pure data-parallel —
            # the head count mesh-shape elasticity actually touched.
            "mesh_shaped_jobs": sum(
                1
                for job in self.jobs.values()
                if job.mesh_assignments > 0
            ),
        }

    def summary_json(self) -> str:
        """Canonical form for the bit-identical determinism gate."""
        return json.dumps(self.summary(), sort_keys=True)

    def watch_summary(self) -> dict:
        """The watch store's deterministic per-tenant fairness/drift
        summary over the run (tenant = workload category): goodput
        share, rho percentiles, SLO burn, cluster utilization, drift
        stats. Fixed seed ⇒ bit-identical (the store is stamped by
        the virtual clock and samples are rounded at intake)."""
        return self._sim.state.watch.watch_summary()

    def watch_summary_json(self) -> str:
        """Canonical form for the watchgate's bit-identical check."""
        return json.dumps(self.watch_summary(), sort_keys=True)

    def latency(self) -> dict:
        """Real wall-clock telemetry (NOT deterministic): per-decision
        allocator latency and total sim runtime."""
        sim = self._sim
        alloc = sim.state.alloc_cycle_metrics()
        modes = {
            mode: raw["count"] for mode, raw in alloc["modes"].items()
        }
        return {
            "alloc_decisions": len(sim._decide_s),
            "alloc_decide_p50_s": round(_pct(sim._decide_s, 0.5), 6),
            "alloc_decide_p99_s": round(_pct(sim._decide_s, 0.99), 6),
            "alloc_cycles_by_mode": modes,
            "sim_wall_s": round(sim._wall_s, 3),
        }

    def render(self) -> str:
        """Operator-facing table (the ``sim`` verb)."""
        summary = self.summary()
        latency = self.latency()
        lines = [
            f"{'METRIC':<26} VALUE",
        ]
        for key in sorted(summary):
            lines.append(f"{key:<26} {summary[key]}")
        lines.append("")
        lines.append("allocator latency (wall clock, not part of the")
        lines.append("deterministic summary):")
        for key in sorted(latency):
            lines.append(f"  {key:<24} {latency[key]}")
        return "\n".join(lines)


def run_trace(
    records: list[dict], **kwargs
) -> SimReport:
    """Convenience wrapper: simulate a trace and return the report."""
    return ClusterSim(records, **kwargs).run()
