"""Allocator: turns posted hints into Pollux allocations.

The port's copy of ``adaptdl_tpu.sched.allocator``, over the port's
goodput model and policy. After each cycle it hands the policy's explain
record and one goodput sample of every active job to the state's watch
store (best effort: a watch failure never fails a cycle).

Builds a :class:`JobInfo` per job from its sched hints — notably
``max_replicas = min(2 x maxProfiledReplicas, spec max)`` so a job can
only scale ~2x past what it has profiled, keeping the speedup model's
extrapolation honest (reference: sched/adaptdl_sched/allocator.py:
181-221) — then runs :class:`PolluxPolicy` over the available slices
and writes ``allocation`` back into the shared state for whatever
worker-lifecycle backend (local runner, k8s operator) is attached.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from collections import deque

import numpy as np

from adaptdl_tpu_torch import env, trace
from adaptdl_tpu_torch.goodput import GoodputFunction, GradParams, PerfParams
from adaptdl_tpu_torch.sched.policy import (
    JobInfo,
    NodeInfo,
    PolluxPolicy,
    SpeedupFunction,
)
from adaptdl_tpu_torch.sched.state import (
    FINISHED,
    ClusterState,
    normalize_topology,
)
from adaptdl_tpu_torch.watch import tenant_of

LOG = logging.getLogger(__name__)


# Amortization horizon for measured restart costs: moving a job is
# priced as restart_seconds / this horizon (clamped), i.e. a rescale
# should pay for itself within ~5 minutes of the new allocation's
# goodput — the same order as the reference's reallocation cadence.
RESTART_AMORTIZATION_S = 300.0


def restart_cost_s_from_stats(
    stats: dict | None,
) -> float | None:
    """Raw measured rescale cost in seconds from a job's posted
    restartStats. Only the phases on the rescale critical path count:
    the final pre-exit save blocks (snapshot + write) and the restore
    blocks the new incarnation; steady-state saves overlap training
    and are free. None when nothing was measured."""
    if not stats:
        return None
    cost = 0.0
    measured = False
    for key in ("snapshotS", "writeS", "restoreS"):
        value = stats.get(key)
        if value is not None:
            cost += max(float(value), 0.0)
            measured = True
    return cost if measured else None


def _penalty_from_cost(cost: float | None) -> float | None:
    """Measured restart seconds -> fractional goodput penalty
    (amortized over the reallocation horizon, clamped)."""
    if cost is None:
        return None
    return float(np.clip(cost / RESTART_AMORTIZATION_S, 0.005, 0.5))


def restart_penalty_from_stats(stats: dict | None) -> float | None:
    """Fractional goodput penalty from a job's measured rescale cost
    (the seconds from :func:`restart_cost_s_from_stats` amortized
    over the reallocation horizon). None when nothing was measured —
    the policy keeps its assumed default."""
    return _penalty_from_cost(restart_cost_s_from_stats(stats))


def slot_kind(node: NodeInfo) -> str:
    """The hazard-accounting kind of a slice: an explicit
    ``extra["kind"]`` wins, else preemptible slices are "spot" and the
    rest "ondemand" — the keys the cluster state's per-kind hazard
    EWMA and the expander's mix policy share."""
    kind = (node.extra or {}).get("kind")
    if kind:
        return str(kind)
    return "spot" if node.preemptible else "ondemand"


def job_info_from_hints(
    hints: dict | None, spec: dict, creation_timestamp: float
) -> JobInfo:
    """JobInfo for the policy; falls back to single-replica until the
    job has posted a usable performance model."""
    resources = dict(spec.get("resources") or {"tpu": 1})
    spec_max = int(spec.get("max_replicas", 1))
    min_replicas = int(spec.get("min_replicas", 0))
    preemptible = bool(spec.get("preemptible", True))
    speedup_fn = None
    max_replicas = max(min_replicas, 1)
    mesh_grid = None
    if hints and hints.get("perfParams") and hints.get("gradParams"):
        perf = PerfParams(**hints["perfParams"])
        grad = GradParams(**hints["gradParams"])
        goodput_fn = GoodputFunction(
            perf, grad, hints["initBatchSize"]
        )
        bounds = hints.get("localBszBounds")
        raw_grid = hints.get("meshShapeGrid")
        if raw_grid:
            mesh_grid = tuple(
                (int(sp), int(tp), int(ss), int(ep))
                for sp, tp, ss, ep in raw_grid
            )
        speedup_fn = SpeedupFunction(
            goodput_fn,
            max_batch_size=hints.get("maxBatchSize"),
            atomic_bsz_range=tuple(bounds) if bounds else None,
            accumulation=bool(hints.get("gradientAccumulation")),
            max_seq_shards=int(hints.get("maxSeqShards") or 1),
            max_model_shards=int(hints.get("maxModelShards") or 1),
            max_stage_shards=int(hints.get("maxStageShards") or 1),
            max_expert_shards=int(hints.get("maxExpertShards") or 1),
            # Older jobs only post their running M; treat it as the cap.
            max_pipeline_micro=int(
                hints.get("maxPipelineMicro")
                or hints.get("pipelineMicrobatches")
                or 8
            ),
            pipeline_chunks=int(hints.get("pipelineChunks") or 0),
            mesh_shape_grid=mesh_grid,
        )
        profiled = int(hints.get("maxProfiledReplicas") or 1)
        # Profiling gates scale-up: at most double what was measured.
        max_replicas = min(max(2 * profiled, 1), spec_max)
    if speedup_fn is None:
        # Linear-optimism placeholder for brand-new jobs: enough to get
        # one replica scheduled so profiling can begin.
        speedup_fn = lambda n, r: r  # noqa: E731
        max_replicas = max(min_replicas, 1)
    restart_cost_s = restart_cost_s_from_stats(
        (hints or {}).get("restartStats")
    )
    return JobInfo(
        resources=resources,
        speedup_fn=speedup_fn,
        creation_timestamp=creation_timestamp,
        min_replicas=min_replicas,
        max_replicas=max(max_replicas, max(min_replicas, 1)),
        preemptible=preemptible,
        restart_penalty=_penalty_from_cost(restart_cost_s),
        restart_cost_s=restart_cost_s,
        mesh_shape_grid=mesh_grid,
    )


class Allocator:
    """Periodic Pollux optimization over the shared cluster state."""

    def __init__(
        self,
        state: ClusterState,
        nodes,
        node_template: NodeInfo | None = None,
        policy: PolluxPolicy | None = None,
        interval: float = 60.0,
        expander=None,
        dirty_threshold: float | None = None,
        full_every: int | None = None,
    ):
        """``nodes`` is the slice inventory: either a static dict or a
        zero-arg callable returning one — a callable makes provisioned
        capacity visible on the next cycle (the autoscaling feedback
        loop; the reference re-lists k8s nodes every cycle,
        allocator.py:149-179).

        Incremental allocation: cycles re-optimize only the jobs the
        cluster state marked dirty (hints, arrivals, departures,
        preemptions) against a pinned background, falling back to a
        FULL Pollux cycle when the dirty fraction crosses
        ``dirty_threshold`` (ADAPTDL_ALLOC_DIRTY_THRESHOLD), every
        ``full_every``-th cycle (ADAPTDL_ALLOC_FULL_EVERY), or
        whenever the slice inventory / exclusion set changed."""
        self._state = state
        self._nodes = nodes
        if node_template is None:
            inventory = self._current_nodes()
            if not inventory:
                raise ValueError(
                    "node_template is required when the initial slice "
                    "inventory is empty (scale-from-zero needs a "
                    "template to describe a provisionable slice)"
                )
            node_template = next(iter(inventory.values()))
        self._template = node_template
        self._policy = policy or PolluxPolicy()
        self._interval = interval
        self._expander = expander
        self._dirty_threshold = (
            env.alloc_dirty_threshold()
            if dirty_threshold is None
            else min(max(float(dirty_threshold), 0.0), 1.0)
        )
        self._full_every = (
            env.alloc_full_every()
            if full_every is None
            else max(int(full_every), 1)
        )
        self._cycle = 0
        # Decision log, newest last (bounded): every cycle's mode,
        # seconds, dirty count, allocations and the policy's explain
        # record; and every published reallocation as (wall time, job,
        # allocation). Read by callers that report what the policy
        # decided; the state is what the runners act on.
        self.cycles: deque = deque(maxlen=1024)
        self.published: deque = deque(maxlen=1024)
        self._last_slots: frozenset | None = None
        self._last_excluded: frozenset = frozenset()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _current_nodes(self) -> dict[str, NodeInfo]:
        return self._nodes() if callable(self._nodes) else self._nodes

    def optimize_once(self) -> dict[str, list[str]]:
        # The decision latency of one Pollux cycle — the number the
        # thousand-job control plane's SLO is written against (served
        # as adaptdl_alloc_decide_seconds{mode} on /metrics).
        start = time.monotonic()
        dirty = self._state.consume_dirty_jobs()
        try:
            with trace.span("alloc.decide") as decide_attrs:
                allocations, mode = self._optimize_once_traced(
                    decide_attrs, dirty
                )
        except Exception:
            # The consumed dirty set must survive a failed cycle, or
            # the next incremental cycle would silently skip the jobs
            # whose changes this one dropped on the floor. The
            # inventory/exclusion baseline is reset too: the failed
            # cycle may have consumed a slot-set change that should
            # force the next cycle onto the full path.
            for key in dirty:
                self._state.mark_job_dirty(key)
            self._last_slots = None
            raise
        elapsed = time.monotonic() - start
        self._state.note_alloc_cycle(elapsed, len(dirty), mode)
        self.cycles.append(
            {
                "cycle": self._cycle,
                "time": time.time(),
                "mode": mode,
                "seconds": elapsed,
                "dirty": len(dirty),
                "allocations": {k: list(v) for k, v in allocations.items()},
                "explain": self._policy.last_explain,
            }
        )
        # The cycle's provenance and its goodput sample. Observability
        # only: a watch failure must not fail a cycle whose publishes
        # already committed.
        try:
            self._note_explain(mode)
            self._watch_sample(elapsed)
        except Exception:  # noqa: BLE001 - observability is best-effort
            LOG.exception("watch sampling failed")
        return allocations

    def _watch_sample(self, cycle_s: float) -> None:
        """One goodput sample per cycle: every active job's published
        allocation and posted hints, the inventory's capacity, and the
        cycle's wall time (the denominator of the sampling-overhead
        share)."""
        watch = getattr(self._state, "watch", None)
        if watch is None:
            return
        nodes = self._current_nodes()
        # "tpu" is the wire name of a slot's chips, shared with the JAX
        # package's state files.
        sizes = [n.resources.get("tpu", 0) for n in nodes.values()]
        chips_per_slice = max(
            sizes + [self._template.resources.get("tpu", 1), 1]
        )
        jobs_view = []
        for key, record in sorted(self._state.jobs().items()):
            if record.status in FINISHED:
                continue
            spec = record.spec or {}
            jobs_view.append(
                {
                    "key": key,
                    "tenant": tenant_of(key, spec),
                    "alloc": list(record.allocation),
                    "topology": record.topology,
                    "batchConfig": record.batch_config,
                    "hints": record.hints,
                    # The fairness denominator: the job's asked-for
                    # fixed allocation (spec "requested", else its max).
                    "requested": int(
                        spec.get("requested")
                        or spec.get("max_replicas")
                        or 1
                    ),
                }
            )
        watch.sample_cycle(
            jobs_view,
            total_chips=sum(sizes),
            chips_per_slice=chips_per_slice,
            cycle_s=cycle_s,
        )

    def _optimize_once_traced(
        self, decide_attrs: dict, dirty: set[str]
    ) -> tuple[dict[str, list[str]], str]:
        self._cycle += 1
        # Stale-provenance guard: a cycle that exits early (no jobs,
        # empty inventory) must not re-publish the PREVIOUS cycle's
        # explain record as its own.
        self._policy.last_explain = None
        records = {}
        base = {}
        for key, record in self._state.jobs().items():
            if record.status in FINISHED:
                continue
            records[key] = record
            base[key] = list(record.allocation)
        if not records:
            # No incomplete jobs: let the expander retire capacity
            # (clamped to its min; shrink waits out the hysteresis).
            # The consumed dirty set is deliberately dropped — it can
            # only name departed jobs, and any future arrival marks
            # itself dirty.
            if self._expander is not None:
                self._expander.request(0)
            return {}, "full"
        # Slots struck out by failed allocation epochs are off the
        # table until their un-quarantine probe: re-placing a job on
        # a slot that just crash-looped it would burn the retry
        # budget re-proving the same failure. Slots DRAINING under an
        # active reclaim notice are excluded the same way — placing
        # on a slot the cloud promised to take back within seconds
        # guarantees an immediate second rescale.
        quarantined = set(self._state.quarantined_slots())
        draining = set(self._state.draining_slots())
        nodes = self._current_nodes()
        if quarantined:
            LOG.info(
                "excluding quarantined slots from placement: %s",
                sorted(quarantined),
            )
        if draining:
            LOG.info(
                "excluding draining (reclaim-notice) slots from "
                "placement: %s",
                sorted(draining),
            )
        if not nodes:
            # Scaled to zero with pending work: the policy cannot run
            # on an empty inventory (it would report desired=0 and
            # deadlock the cluster at zero forever) — bootstrap one
            # slice and allocate on the next cycle. The consumed
            # dirty set must survive this skipped cycle (same
            # invariant as the exception path), and the slot baseline
            # resets so capacity reappearing forces a full cycle.
            for key in dirty:
                self._state.mark_job_dirty(key)
            self._last_slots = None
            if self._expander is not None:
                self._expander.request(1)
            return {}, "full"
        # Hazard pricing: register the inventory's slot->kind map (so
        # a preemption notice is attributed to the right hazard kind)
        # and stamp each slice with its kind's decayed EWMA hazard —
        # the policy's expected-loss term reads it off the NodeInfo.
        kinds = {key: slot_kind(node) for key, node in nodes.items()}
        self._state.set_slot_kinds(
            kinds,
            preemptible={
                key
                for key, node in nodes.items()
                if node.preemptible
            },
        )
        hazards = self._state.hazard_rates()
        nodes = {
            key: dataclasses.replace(
                node, hazard=hazards.get(kinds[key], 0.0)
            )
            for key, node in nodes.items()
        }
        template = dataclasses.replace(
            self._template,
            hazard=hazards.get(slot_kind(self._template), 0.0),
        )
        excluded = quarantined | draining
        dirty_active = dirty & set(records)
        # Incremental vs full: re-searching only dirty jobs is cheap,
        # but cannot rebalance the background — so heavy churn, an
        # inventory/exclusion change, the periodic forced cycle, and
        # the first cycle all take the full path.
        slots_now = frozenset(nodes)
        full = (
            self._cycle == 1
            or self._full_every <= 1
            or self._cycle % self._full_every == 0
            or self._last_slots != slots_now
            or self._last_excluded != frozenset(excluded)
            or len(dirty) > self._dirty_threshold * len(records)
        )
        self._last_slots = slots_now
        self._last_excluded = frozenset(excluded)
        if full:
            mode = "full"
            job_infos = {
                key: job_info_from_hints(
                    record.hints,
                    record.spec,
                    record.creation_timestamp,
                )
                for key, record in records.items()
            }
            allocations, desired = self._policy.optimize(
                job_infos,
                nodes,
                base,
                template,
                quarantined=excluded,
            )
            changed_keys = set(allocations)
        else:
            mode = "incremental"
            # Speedup models (the expensive JobInfo half) are built
            # for the DIRTY jobs only; the pinned background needs
            # just its per-replica resources.
            job_infos = {
                key: job_info_from_hints(
                    records[key].hints,
                    records[key].spec,
                    records[key].creation_timestamp,
                )
                for key in sorted(dirty_active)
            }
            allocations, desired = self._policy.optimize_incremental(
                job_infos,
                nodes,
                base,
                template,
                dirty=dirty_active,
                quarantined=excluded,
                resources={
                    key: dict(
                        record.spec.get("resources") or {"tpu": 1}
                    )
                    for key, record in records.items()
                    if key not in dirty_active
                },
            )
            changed_keys = set(dirty_active)
        decide_attrs["jobs"] = len(records)
        decide_attrs["slots"] = sum(
            info.resources.get("tpu", 0) for info in nodes.values()
        )
        decide_attrs["mode"] = mode
        decide_attrs["dirty"] = len(dirty)
        if self._expander is not None:
            note = getattr(self._expander, "note_restart_costs", None)
            if note is not None and mode == "full":
                # The mix-policy expander weighs the spot discount
                # against the jobs' measured restart costs. Only full
                # cycles see every job's JobInfo — an incremental
                # cycle's dirty-only view would REPLACE the whole map
                # with an unrepresentative sliver (often empty),
                # so pool-mix pricing rides full cycles like the
                # desired-node target does.
                note(
                    {
                        key: info.restart_cost_s
                        for key, info in job_infos.items()
                    }
                )
            self._expander.request(desired)
        for key, alloc in allocations.items():
            if key not in changed_keys:
                # Incremental cycles never touch the pinned
                # background: its allocation is unchanged by
                # construction, and recomputing its batch/topology
                # would rebuild 1k speedup models per cycle.
                continue
            record = self._state.get_job(key)
            if record is None:
                continue
            # Publish the factorization behind this allocation's
            # speedup so the launcher can build the matching mesh.
            # The incumbent factorization is kept unless the challenger
            # clearly beats it (restart hysteresis): near-tie
            # factorizations would otherwise flap across perf refits
            # and restart the job every cycle.
            topology = None
            batch_config = None
            best_config = getattr(
                job_infos[key].speedup_fn,
                "best_config_with_hysteresis",
                None,
            )
            if best_config is not None and alloc:
                bsz, accum, sp, tp, ss, ep, micro = best_config(
                    len(set(alloc)), len(alloc), record.topology
                )
                topology = {
                    "seqShards": sp,
                    "modelShards": tp,
                    "stageShards": ss,
                    "expertShards": ep,
                    "pipelineMicro": micro,
                }
                if bsz > 0:
                    batch_config = {
                        "atomicBsz": int(bsz),
                        "accumSteps": int(accum),
                    }
            # Classify the decision. A change to the device set or the
            # mesh factorization needs checkpoint-restart; a change to
            # only the per-replica batch configuration is a LIVE
            # RE-TUNE — published without touching allocation/topology
            # so the worker backend never restarts the job, and the
            # job adopts it in-process (data.AdaptiveDataLoader).
            reallocate = record.allocation != alloc or normalize_topology(
                record.topology
            ) != normalize_topology(topology)
            if reallocate:
                LOG.info("allocation %s: %s -> %s (topology %s)", key,
                         record.allocation, alloc, topology)
                # Mint a fresh trace for this rescale decision: the
                # launcher exports it (ADAPTDL_TRACEPARENT) to the new
                # incarnation and /config serves it to the doomed one,
                # so every span of this rescale — decide, epoch
                # prepare/commit, final save, restore, first step —
                # shares one trace id. EXCEPT a preemption-driven
                # re-placement: the worker minted the survival trace
                # at notice time (preempt.notice → drain.save), and
                # the successor's restore/first-step must land on THAT
                # id, so the draining job's trace parent is reused.
                if record.draining and record.trace_parent:
                    traceparent = record.trace_parent
                else:
                    traceparent = trace.new_traceparent()
                trace.event(
                    "alloc.publish",
                    traceparent=traceparent,
                    job=key,
                    replicas=len(alloc),
                )
                # Speculative warm-up: publish the decision as a
                # CANDIDATE first, so when the runner sees the launch
                # config drift it finds a matching warm-up target and
                # can bring the successor up before signalling the
                # incumbent. The candidate commits nothing — the
                # update below opens the real prepare epoch, and a
                # later decision or rollback discards it.
                self._state.publish_candidate(
                    key,
                    alloc,
                    topology=topology,
                    batch_config=batch_config,
                    trace_parent=traceparent,
                )
                self._state.update(
                    key,
                    allocation=alloc,
                    topology=topology,
                    batch_config=batch_config,
                    trace_parent=traceparent,
                )
                self.published.append((time.time(), key, list(alloc)))
            elif (
                batch_config is not None
                and batch_config != record.batch_config
            ):
                LOG.info(
                    "re-tune %s: batch config %s -> %s (no restart)",
                    key, record.batch_config, batch_config,
                )
                self._state.publish_retune(key, batch_config)
        return allocations, mode

    def _note_explain(self, mode: str) -> None:
        """Hand the policy's explain record to the watch store, each job
        enriched with its PUBLISHED mesh shape (what actually ships)."""
        watch = getattr(self._state, "watch", None)
        explain = getattr(self._policy, "last_explain", None)
        if watch is None or explain is None:
            return
        # One locked snapshot of the job table, not a get_job per key.
        records = self._state.jobs()
        jobs = {}
        for key, rec in (explain.get("jobs") or {}).items():
            record = records.get(key)
            enriched = dict(rec)
            if record is not None and record.allocation:
                enriched["meshShape"] = normalize_topology(record.topology)
            jobs[key] = enriched
        watch.note_explain(self._cycle, mode, explain, jobs)

    def start(self) -> None:
        # The kick baseline is snapshotted BEFORE each cycle —
        # including this initial synchronous one: a preemption notice
        # that lands WHILE optimize_once runs must wake the next wait
        # immediately, not be silently consumed and wait out the full
        # interval (the notice window is 30s; the interval can be
        # minutes).
        initial_seen = self._state.alloc_kick_count()
        # First cycle runs synchronously so a newly created job has an
        # allocation the moment start() returns.
        try:
            self.optimize_once()
        except Exception:  # noqa: BLE001
            LOG.exception("initial allocator cycle failed")

        def loop():
            seen = initial_seen
            while not self._stop.is_set():
                # Interruptible cadence: a preemption notice kicks the
                # state so the next cycle runs NOW — re-placement must
                # overlap the notice window, not wait out the
                # interval.
                self._state.wait_alloc_kick(self._interval, seen=seen)
                if self._stop.is_set():
                    return
                seen = self._state.alloc_kick_count()
                try:
                    self.optimize_once()
                except Exception:  # noqa: BLE001
                    LOG.exception("allocator cycle failed")

        self._thread = threading.Thread(
            target=loop, name="adaptdl-allocator", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        # Unblock a loop parked in wait_alloc_kick.
        self._state.kick_allocator()
        if self._thread is not None:
            self._thread.join(timeout=10)
