"""Goodput accounting, decision provenance, drift and SLOs.

The port's copy of ``adaptdl_tpu.watch``: a bounded, supervisor-side
store that answers "is the fitted goodput model still right?", "why did
the allocator give job X this allocation and mesh shape?" and "which
tenant is starved?". Its record streams live in bounded ring buffers
(``ADAPTDL_WATCH_*``), all under one lock:

- **Goodput samples**: once per allocator cycle, per active job, the
  measured goodput (the trainer's ``measuredGoodput`` hint), the fitted
  model's goodput at the published allocation and at the job's
  requested-ideal one; ``rho = ideal / actual`` is the instantaneous
  finish-time-fairness slowdown.
- **Per-tenant aggregates**: goodput share, mean rho, chips, and an SLO
  burn counter (each sample whose rho exceeds ``ADAPTDL_WATCH_SLO_RHO``).
- **Decision provenance**: each Pollux cycle's explain record (the
  candidates scored, the winner, the top-k losers with the objective
  term that killed each), in memory, served by ``GET /explain/{job}``.
- **Stragglers**: per-rank step-time EWMAs from the heartbeats; a rank
  above ``ADAPTDL_WATCH_STRAGGLER_FACTOR`` times its job's median marks
  its slot suspect.

The drift monitor keeps a rolling measured/predicted ratio per job; a
ratio outside ``[1/(1+t), 1+t]`` (``ADAPTDL_WATCH_DRIFT_THRESHOLD`` t)
flags the job for re-profiling, a signal and never a policy input.
The clock is injectable, and :meth:`WatchStore.watch_summary` reads only
clock-stamped, rounded sample values, so a virtual clock and a fixed
seed reproduce it bit for bit. The lock is never taken under the cluster
state's condition.
"""

from __future__ import annotations

import logging
import math
import threading
import time
from collections import deque

from adaptdl_tpu_torch import env
from adaptdl_tpu_torch.goodput import GoodputFunction, GradParams, PerfParams

LOG = logging.getLogger(__name__)

# Tail served by one /watch snapshot per series (the rings may hold
# more; the HTTP payload stays bounded regardless of the buffer knob).
_SNAPSHOT_TAIL = 240
# Explain records retained per job: provenance is about the LAST few
# decisions; deep history lives in metrics, not here.
_EXPLAIN_RING = 8
# Fairness slowdown assigned to a modeled job holding NO allocation:
# its instantaneous slowdown is unbounded, but the aggregates need a
# finite, deliberately-alarming value — a starved tenant must show a
# high rho and burn its SLO, not vanish from the mean.
_RHO_STALLED = 100.0

_DP_TOPO = (1, 1, 1, 1, 1)


def tenant_of(
    key: str, spec: dict | None = None
) -> str:
    """A job's accounting tenant: an explicit ``spec["tenant"]`` wins
    (the simulator uses the workload category), else the namespace
    half of the ``namespace/name`` job key."""
    if spec and spec.get("tenant"):
        return str(spec["tenant"])
    return key.split("/", 1)[0] if "/" in key else "default"


def _topo_tuple(
    topology: dict | None,
) -> tuple[int, int, int, int, int]:
    """A published topology dict as the (sp, tp, ss, ep, micro) tuple
    the goodput model prices. Mirrors ``sched.state.
    normalize_topology`` (micro defaults to 4 when a pipeline is
    staged — pricing a different M than the launcher builds would
    register as phantom model drift); not imported from there because
    state.py imports this module."""
    topology = topology or {}
    ss = max(int(topology.get("stageShards", 1)), 1)
    return (
        max(int(topology.get("seqShards", 1)), 1),
        max(int(topology.get("modelShards", 1)), 1),
        ss,
        max(int(topology.get("expertShards", 1)), 1),
        max(int(topology.get("pipelineMicro", 4)), 1) if ss > 1 else 1,
    )


def _r6(value) -> float:
    return round(float(value), 6)


def _pct(values: list, q: float) -> float:
    """Nearest-rank percentile (the sim/bench definition) — local copy
    so watch never imports the sim package it feeds."""
    if not values:
        return 0.0
    ordered = sorted(values)
    rank = min(
        max(int(round(q * (len(ordered) - 1))), 0), len(ordered) - 1
    )
    return float(ordered[rank])


class WatchStore:
    """Bounded supervisor-side time-series store for goodput
    accounting, decision provenance, drift, and straggler signals.
    Thread-safe: every mutable field is guarded by one lock (the
    allocator thread samples, the supervisor's executor threads
    observe/serve, the sweeper never touches it)."""

    def __init__(
        self,
        clock=None,
        buffer: int | None = None,
        drift_window: int | None = None,
        drift_threshold: float | None = None,
        straggler_factor: float | None = None,
        slo_rho: float | None = None,
    ):
        # Injectable clock like ClusterState's: the simulator passes
        # its VirtualClock so every sample timestamp derives from
        # event time (fixed seed => bit-identical series). Assigned
        # once before any other thread holds a reference.
        self._clock = time if clock is None else clock
        self._buffer = (
            env.watch_buffer_size() if buffer is None
            else max(int(buffer), 8)
        )
        self._drift_window = (
            env.watch_drift_window() if drift_window is None
            else max(int(drift_window), 3)
        )
        self._drift_threshold = (
            env.watch_drift_threshold() if drift_threshold is None
            else max(float(drift_threshold), 0.01)
        )
        self._straggler_factor = (
            env.watch_straggler_factor() if straggler_factor is None
            else max(float(straggler_factor), 1.0)
        )
        self._slo_rho = (
            env.watch_slo_rho() if slo_rho is None
            else max(float(slo_rho), 0.1)
        )
        self._lock = threading.Lock()
        # Latest trainer-reported measured goodput per job as
        # (value, intake seq) — the seq lets the drift monitor pair
        # each observation with a prediction exactly ONCE, however
        # many allocator cycles run between hint posts (re-pairing a
        # sticky value every cycle would let one noisy hint fill the
        # whole drift window). The supervisor's hints intake and the
        # sim's engine feed it.
        self._measured: dict[str, tuple] = {}  # guarded-by: _lock
        # Last intake seq the drift ring consumed, per job.
        self._drift_seq: dict[str, int] = {}  # guarded-by: _lock
        self._tenant: dict[str, str] = {}  # guarded-by: _lock
        # Ring buffers: per-job samples, per-tenant aggregates, the
        # cluster series, and the per-job drift window.
        self._job_series: dict[str, deque] = {}  # guarded-by: _lock
        self._tenant_series: dict[str, deque] = {}  # guarded-by: _lock
        self._cluster: deque = deque(maxlen=self._buffer)  # guarded-by: _lock
        self._drift: dict[str, deque] = {}  # guarded-by: _lock
        # Decision provenance: per-job explain rings + the cluster's
        # last few cycle summaries.
        self._explain: dict[str, deque] = {}  # guarded-by: _lock
        self._cycles: deque = deque(maxlen=_EXPLAIN_RING)  # guarded-by: _lock
        # Per-tenant SLO burn counters (monotonic).
        self._slo_burn: dict[str, int] = {}  # guarded-by: _lock
        # Straggler intake: job -> rank -> (slot, step-time EWMA).
        self._step_times: dict[str, dict[int, tuple]] = {}  # guarded-by: _lock
        # Numeric-health incidents (the guard's): per-job bounded
        # incident records (fed by ClusterState.report_incident) and a
        # monotonic per-job counter that survives ring eviction.
        self._incident_series: dict[str, deque] = {}  # guarded-by: _lock
        self._incident_counts: dict[str, int] = {}  # guarded-by: _lock
        # Per-job goodput-model cache: (params signature,
        # GoodputFunction, {eval key: goodput}) — repeat cycles at an
        # unchanged allocation cost a dict lookup, not a model solve.
        self._models: dict[str, tuple] = {}  # guarded-by: _lock
        self._samples = 0  # guarded-by: _lock
        # Sampling-overhead accounting for the watchgate (<1% of
        # allocator cycle time): cumulative sampling vs cycle seconds.
        self._sample_s = 0.0  # guarded-by: _lock
        self._cycle_s = 0.0  # guarded-by: _lock

    # -- intake --------------------------------------------------------

    def observe_measured(
        self, key: str, goodput: float, tenant: str | None = None
    ) -> None:
        """Latest measured goodput for a job (trainer hint intake or
        the sim engine's integrated rate). Pure store: safe on the
        simulator's replay-pure emit path."""
        with self._lock:
            prev = self._measured.get(key)
            self._measured[key] = (
                float(goodput),
                (prev[1] + 1) if prev else 1,
            )
            if tenant:
                self._tenant[key] = str(tenant)

    def note_step_time(
        self, key: str, rank: int, slot: str | None, seconds: float
    ) -> None:
        """One rank's heartbeat-piggybacked step-time EWMA, attributed
        to the slot the rank runs on."""
        if not seconds or seconds <= 0:
            return
        with self._lock:
            ranks = self._step_times.setdefault(key, {})
            ranks[int(rank)] = (slot, float(seconds))

    def note_incident(
        self,
        key: str,
        kind: str,
        blame: str | None = None,
        slot: str | None = None,
    ) -> None:
        """One confirmed numeric-health incident for a job (the
        supervisor's /incident intake feeds this after the journaled
        apply): ring-buffered record + monotonic counter."""
        now = self._clock.time()
        with self._lock:
            ring = self._incident_series.get(key)
            if ring is None:
                ring = deque(maxlen=self._buffer)
                self._incident_series[key] = ring
            ring.append(
                {
                    "t": _r6(now),
                    "kind": str(kind),
                    "blame": str(blame) if blame else "unknown",
                    "slot": str(slot) if slot else None,
                }
            )
            self._incident_counts[key] = (
                self._incident_counts.get(key, 0) + 1
            )

    def forget_job(self, key: str) -> None:
        """Drop a removed job's series (tenant aggregates keep their
        history — a tenant outlives its jobs)."""
        with self._lock:
            for table in (
                self._measured,
                self._drift_seq,
                self._tenant,
                self._job_series,
                self._drift,
                self._explain,
                self._step_times,
                self._models,
                self._incident_series,
                self._incident_counts,
            ):
                table.pop(key, None)

    # -- the per-cycle sample ------------------------------------------

    def sample_cycle(
        self,
        jobs: list[dict],
        total_chips: int,
        chips_per_slice: int,
        cycle_s: float | None = None,
    ) -> None:
        """Fold one allocator cycle into the store. ``jobs`` is the
        caller's locked snapshot of every active job: ``{key, tenant,
        alloc, topology, batchConfig, hints, requested}``. Predicted
        goodput is evaluated from the job's own fitted model at the
        published allocation; the requested-ideal is the same model at
        the job's asked-for fixed allocation. The model evaluations
        (the expensive part) run OUTSIDE the store lock — a burst of
        fresh-params solves must not stall /metrics, heartbeat
        intake, or the straggler reads behind it."""
        overhead_start = time.perf_counter()
        now = self._clock.time()
        chips_per_slice = max(int(chips_per_slice), 1)
        ordered = sorted(jobs, key=lambda j: j["key"])
        rates = [
            (
                self._predicted(job["key"], job),
                self._ideal(job["key"], job, chips_per_slice),
            )
            for job in ordered
        ]
        with self._lock:
            self._samples += 1
            per_tenant: dict[str, dict] = {}
            total_rate = 0.0
            chips_allocated = 0
            replicas_by_key: dict[str, int] = {}
            for job, (predicted, ideal) in zip(ordered, rates):
                key = job["key"]
                tenant = job.get("tenant") or self._tenant.get(key)
                if not tenant:
                    tenant = tenant_of(key)
                self._tenant[key] = tenant
                alloc = job.get("alloc") or []
                replicas = len(alloc)
                replicas_by_key[key] = replicas
                chips_allocated += replicas
                observed = self._measured.get(key)
                # A job holding NO allocation is running nowhere: its
                # pre-withdrawal measured goodput is history, not a
                # rate — using it would report a starved tenant as
                # healthy (rho ~1, no SLO burn).
                measured = (
                    observed[0]
                    if observed and replicas > 0
                    else None
                )
                rate = (
                    measured
                    if measured is not None and measured > 0
                    else predicted
                )
                rho = None
                if ideal and rate and rate > 0:
                    rho = ideal / rate
                elif ideal and replicas == 0:
                    # Modeled but unallocated: starved, not unknown.
                    rho = _RHO_STALLED
                series = self._job_series.get(key)
                if series is None:
                    series = deque(maxlen=self._buffer)
                    self._job_series[key] = series
                # The guard's health series piggyback on the cycle
                # sample: the worker's posted guardStats hint carries
                # rollbacks / last-good checkpoint age / RAW (unguarded)
                # goodput, and the supervisor-confirmed incident count
                # comes from our own intake — together the
                # guarded-vs-raw goodput and rollback panels.
                gstats = (job.get("hints") or {}).get("guardStats") or {}
                raw = gstats.get("rawGoodput")
                age = gstats.get("lastGoodAge")
                series.append(
                    {
                        "t": _r6(now),
                        "replicas": replicas,
                        "measured": (
                            _r6(measured) if measured is not None
                            else None
                        ),
                        "predicted": (
                            _r6(predicted) if predicted is not None
                            else None
                        ),
                        "ideal": _r6(ideal) if ideal is not None else None,
                        "rho": _r6(rho) if rho is not None else None,
                        "incidents": self._incident_counts.get(key, 0),
                        "rollbacks": int(gstats.get("rollbacks") or 0),
                        "lastGoodAge": (
                            _r6(age) if age is not None else None
                        ),
                        "rawGoodput": (
                            _r6(raw) if raw is not None else None
                        ),
                    }
                )
                if (
                    measured is not None
                    and measured > 0
                    and predicted is not None
                    and predicted > 0
                    # Pair each observation ONCE: a sticky hint
                    # re-sampled across allocator cycles must not
                    # fill the drift window by itself.
                    and self._drift_seq.get(key) != observed[1]
                ):
                    self._drift_seq[key] = observed[1]
                    ring = self._drift.get(key)
                    if ring is None:
                        ring = deque(maxlen=self._drift_window)
                        self._drift[key] = ring
                    ring.append(measured / predicted)
                agg = per_tenant.setdefault(
                    tenant,
                    {"jobs": 0, "running": 0, "chips": 0,
                     "rate": 0.0, "rhos": []},
                )
                agg["jobs"] += 1
                if replicas:
                    agg["running"] += 1
                agg["chips"] += replicas
                if rate and rate > 0:
                    agg["rate"] += rate
                    total_rate += rate
                if rho is not None:
                    agg["rhos"].append(rho)
            for tenant in sorted(per_tenant):
                agg = per_tenant[tenant]
                share = (
                    agg["rate"] / total_rate if total_rate > 0 else 0.0
                )
                rho_mean = (
                    sum(agg["rhos"]) / len(agg["rhos"])
                    if agg["rhos"]
                    else None
                )
                if rho_mean is not None and rho_mean > self._slo_rho:
                    self._slo_burn[tenant] = (
                        self._slo_burn.get(tenant, 0) + 1
                    )
                series = self._tenant_series.get(tenant)
                if series is None:
                    series = deque(maxlen=self._buffer)
                    self._tenant_series[tenant] = series
                series.append(
                    {
                        "t": _r6(now),
                        "jobs": agg["jobs"],
                        "running": agg["running"],
                        "chips": agg["chips"],
                        "share": _r6(share),
                        "rho": (
                            _r6(rho_mean) if rho_mean is not None
                            else None
                        ),
                        "burn": self._slo_burn.get(tenant, 0),
                    }
                )
            self._cluster.append(
                {
                    "t": _r6(now),
                    "jobs": len(jobs),
                    "chipsAllocated": chips_allocated,
                    "chipsTotal": int(total_chips),
                    "utilization": _r6(
                        chips_allocated / total_chips
                        if total_chips > 0
                        else 0.0
                    ),
                }
            )
            # Straggler-table hygiene: ranks a rescale retired (and
            # jobs this cycle no longer covers) must not skew the
            # outlier median or flag slots the job left behind.
            for key in list(self._step_times):
                replicas = replicas_by_key.get(key)
                if not replicas:
                    del self._step_times[key]
                    continue
                ranks = self._step_times[key]
                for rank in [r for r in ranks if r >= replicas]:
                    del ranks[rank]
                if not ranks:
                    del self._step_times[key]
            self._sample_s += time.perf_counter() - overhead_start
            if cycle_s is not None:
                self._cycle_s += max(float(cycle_s), 0.0)

    def _model_locked(self, key: str, hints: dict):  # holds-lock: _lock
        """Cached GoodputFunction + evaluation memo for a job's fitted
        params; rebuilt when the posted params change."""
        perf = hints.get("perfParams")
        grad = hints.get("gradParams")
        init = hints.get("initBatchSize")
        if not perf or not grad or not init:
            return None, None
        sig = (
            tuple(sorted(perf.items())),
            tuple(sorted(grad.items())),
            int(init),
        )
        cached = self._models.get(key)
        if cached is not None and cached[0] == sig:
            return cached[1], cached[2]
        try:
            fn = GoodputFunction(
                PerfParams(**perf), GradParams(**grad), int(init)
            )
        except (TypeError, ValueError):
            return None, None
        memo: dict = {}
        self._models[key] = (sig, fn, memo)
        return fn, memo

    def _memoized(self, memo: dict, eval_key, compute):
        """Read-through memo with only BRIEF lock holds: the model
        solve itself runs unlocked (a concurrent params change can at
        worst orphan-write into a replaced memo dict — harmless)."""
        with self._lock:
            if eval_key in memo:
                return memo[eval_key]
        value = compute()
        if value is not None and not math.isfinite(value):
            value = None
        with self._lock:
            memo[eval_key] = value
            if len(memo) > 64:
                # The memo is per-job and keyed by allocation shape; a
                # rapidly rescaled job could accrete entries — reset
                # rather than grow (the next cycle re-fills the hot
                # key).
                for k in [k for k in memo if k != eval_key]:
                    del memo[k]
        return value

    def _predicted(
        self, key: str, job: dict
    ):
        """Model-predicted goodput at the PUBLISHED allocation (and
        published batch config when one exists), memoized per (alloc
        shape, batch config)."""
        hints = job.get("hints") or {}
        with self._lock:
            fn, memo = self._model_locked(key, hints)
        alloc = job.get("alloc") or []
        replicas = len(alloc)
        if fn is None or replicas <= 0:
            return None
        topo = _topo_tuple(job.get("topology"))
        sp, tp, ss, ep, micro = topo
        group = sp * tp * ss * ep
        dp = replicas // group if group > 1 else replicas
        if dp <= 0 or dp * group != replicas:
            dp, (sp, tp, ss, ep, micro) = replicas, _DP_TOPO
        nodes = min(len(set(alloc)), dp)
        bc = job.get("batchConfig") or {}
        eval_key = (
            "pub", nodes, dp, sp, tp, ss, ep, micro,
            bc.get("atomicBsz"), bc.get("accumSteps"),
        )

        def compute():
            try:
                if bc.get("atomicBsz"):
                    return float(
                        fn.evaluate(
                            nodes,
                            dp,
                            int(bc["atomicBsz"]),
                            int(bc.get("accumSteps") or 0),
                            seq_shards=sp,
                            model_shards=tp,
                            stage_shards=ss,
                            pipeline_micro=micro,
                            expert_shards=ep,
                        )
                    )
                bounds = hints.get("localBszBounds")
                goodput, _, _ = fn.optimize(
                    nodes,
                    dp,
                    max_batch_size=hints.get("maxBatchSize"),
                    atomic_bsz_range=(
                        tuple(bounds) if bounds else None
                    ),
                    accumulation=True,
                    seq_shards=sp,
                    model_shards=tp,
                    stage_shards=ss,
                    pipeline_micro=micro,
                    expert_shards=ep,
                )
                return float(goodput)
            except (AssertionError, ValueError, FloatingPointError):
                # A published batch config the model deems infeasible
                # (stale config vs fresh params): price the allocation
                # shape alone rather than poison the sample.
                try:
                    goodput, _, _ = fn.optimize(
                        nodes, dp, accumulation=True
                    )
                    return float(goodput)
                except (
                    AssertionError, ValueError, FloatingPointError
                ):
                    return None

        return self._memoized(memo, eval_key, compute)

    def _ideal(
        self, key: str, job: dict, chips_per_slice: int
    ):
        """Model-predicted goodput at the job's requested-ideal fixed
        allocation — the denominator of the fairness slowdown rho."""
        hints = job.get("hints") or {}
        with self._lock:
            fn, memo = self._model_locked(key, hints)
        if fn is None:
            return None
        requested = max(int(job.get("requested") or 1), 1)
        req_nodes = max(-(-requested // chips_per_slice), 1)

        def compute():
            try:
                bounds = hints.get("localBszBounds")
                goodput, _, _ = fn.optimize(
                    min(req_nodes, requested),
                    requested,
                    max_batch_size=hints.get("maxBatchSize"),
                    atomic_bsz_range=(
                        tuple(bounds) if bounds else None
                    ),
                    accumulation=True,
                )
                return float(goodput)
            except (AssertionError, ValueError, FloatingPointError):
                return None

        return self._memoized(
            memo, ("ideal", requested, req_nodes), compute
        )

    # -- decision provenance -------------------------------------------

    def note_explain(
        self, cycle: int, mode: str, explain: dict, jobs: dict
    ) -> None:
        """One allocator cycle's provenance: the policy's cycle
        summary (candidates/winner/losers) plus the enriched per-job
        records (allocation, mesh shape, objective terms)."""
        now = self._clock.time()
        with self._lock:
            summary = {
                "cycle": int(cycle),
                "mode": str(mode),
                "t": _r6(now),
                "kind": explain.get("kind"),
                "candidates": explain.get("candidates", 0),
                "winner": explain.get("winner"),
                "losers": explain.get("losers") or [],
                "desiredNodes": explain.get("desiredNodes"),
            }
            if summary["candidates"] or summary["winner"] or not self._cycles:
                # Pass-through cycles that scored nothing would only
                # evict the real decisions' winner/losers from the
                # ring — the per-job pinned records already tell the
                # "kept unchanged" story.
                self._cycles.append(summary)
            for key in sorted(jobs):
                ring = self._explain.get(key)
                if ring is None:
                    ring = deque(maxlen=_EXPLAIN_RING)
                    self._explain[key] = ring
                record = dict(jobs[key])
                record["cycle"] = int(cycle)
                record["mode"] = str(mode)
                record["t"] = _r6(now)
                if (
                    record.get("pinned")
                    and ring
                    and ring[-1].get("pinned")
                    and ring[-1].get("alloc") == record.get("alloc")
                ):
                    # Collapse runs of identical pinned keeps: a long
                    # streak of incremental pass-through cycles must
                    # not evict the job's last REAL decision from the
                    # ring — the record's cycle/t advance in place.
                    ring[-1] = record
                else:
                    ring.append(record)

    def explain_for(
        self, key: str
    ) -> dict | None:
        """A job's provenance view: its latest explain record, the
        last record where the job was actually RE-DECIDED (incremental
        pass-through cycles record it pinned, and an operator asking
        "why this allocation" wants the decision, not the keep), its
        retained history, and the matching cycle summary (the losers
        that cycle scored). None when no cycle has covered the job."""
        with self._lock:
            ring = self._explain.get(key)
            if not ring:
                return None
            latest = dict(ring[-1])
            decision = next(
                (
                    dict(rec)
                    for rec in reversed(ring)
                    if not rec.get("pinned")
                ),
                None,
            )
            # Match the cycle summary (winner/losers) to the record
            # the caller will RENDER — the last real decision, not the
            # pinned pass-through that merely kept it.
            target = (decision or latest)["cycle"]
            cycle = None
            for summary in reversed(self._cycles):
                if summary["cycle"] == target:
                    cycle = dict(summary)
                    break
            return {
                "job": key,
                "latest": latest,
                "lastDecision": decision,
                "history": [dict(rec) for rec in ring],
                "cycle": cycle,
            }

    # -- straggler detection -------------------------------------------

    def _suspects_locked(self) -> dict[str, dict]:  # holds-lock: _lock
        """Slots whose rank step-time EWMA is an outlier vs the job's
        median: {slot: {"job", "rank", "ratio"}}. Requires >= 3
        reporting ranks per job — no majority, no verdict."""
        suspects: dict[str, dict] = {}
        for key in sorted(self._step_times):
            ranks = self._step_times[key]
            if len(ranks) < 3:
                continue
            ewmas = sorted(v[1] for v in ranks.values())
            median = ewmas[len(ewmas) // 2]
            if median <= 0:
                continue
            for rank in sorted(ranks):
                slot, ewma = ranks[rank]
                if slot and ewma > self._straggler_factor * median:
                    suspects[slot] = {
                        "job": key,
                        "rank": rank,
                        "ratio": _r6(ewma / median),
                    }
        return suspects

    def suspect_slots(self) -> dict[str, dict]:
        with self._lock:
            return self._suspects_locked()

    # -- drift ----------------------------------------------------------

    def _drift_locked(self, key: str):  # holds-lock: _lock
        """(rolling ratio, reprofile flag) for one job; (None, False)
        until >= 3 paired samples exist."""
        ring = self._drift.get(key)
        if not ring or len(ring) < 3:
            return None, False
        ratio = sum(ring) / len(ring)
        limit = 1.0 + self._drift_threshold
        return ratio, bool(ratio > limit or ratio < 1.0 / limit)

    # -- views -----------------------------------------------------------

    def metrics_view(self) -> dict:
        """One locked snapshot shaped for /metrics: latest per-job
        goodput triple + drift/flag, per-tenant share/rho/burn, the
        cluster utilization, and suspect slots."""
        with self._lock:
            jobs = {}
            for key in sorted(self._job_series):
                series = self._job_series[key]
                if not series:
                    continue
                latest = series[-1]
                drift, flagged = self._drift_locked(key)
                jobs[key] = {
                    "tenant": self._tenant.get(key, tenant_of(key)),
                    "measured": latest["measured"],
                    "predicted": latest["predicted"],
                    "ideal": latest["ideal"],
                    "rho": latest["rho"],
                    "drift": _r6(drift) if drift is not None else None,
                    "reprofile": flagged,
                    "incidents": latest.get("incidents", 0),
                    "rollbacks": latest.get("rollbacks", 0),
                    "lastGoodAge": latest.get("lastGoodAge"),
                    "rawGoodput": latest.get("rawGoodput"),
                }
            tenants = {}
            for tenant in sorted(self._tenant_series):
                series = self._tenant_series[tenant]
                if not series:
                    continue
                # The latest sample already embeds the tenant's burn
                # counter (sample_cycle bumps and appends atomically).
                tenants[tenant] = dict(series[-1])
            return {
                "jobs": jobs,
                "tenants": tenants,
                "cluster": dict(self._cluster[-1]) if self._cluster else None,
                "suspects": self._suspects_locked(),
            }

    def snapshot(self) -> dict:
        """The GET /watch payload: bounded series tails + the latest
        aggregates + provenance cycle summaries + overhead counters
        (what the watchgate's <1% sampling gate reads)."""
        with self._lock:
            return {
                "samples": self._samples,
                "cluster": list(self._cluster)[-_SNAPSHOT_TAIL:],
                "tenants": {
                    tenant: {
                        "series": list(series)[-_SNAPSHOT_TAIL:],
                        "burn": self._slo_burn.get(tenant, 0),
                    }
                    for tenant, series in sorted(
                        self._tenant_series.items()
                    )
                },
                "jobs": {
                    key: {
                        "latest": dict(series[-1]),
                        "drift": (
                            _r6(drift) if drift is not None else None
                        ),
                        "reprofile": flagged,
                        "tenant": self._tenant.get(
                            key, tenant_of(key)
                        ),
                        "incidents": [
                            dict(rec)
                            for rec in list(
                                self._incident_series.get(key, ())
                            )[-_SNAPSHOT_TAIL:]
                        ],
                    }
                    for key, series in sorted(
                        self._job_series.items()
                    )
                    if series
                    for drift, flagged in (self._drift_locked(key),)
                },
                "suspectSlots": self._suspects_locked(),
                "cycles": [dict(c) for c in self._cycles],
                "overhead": {
                    "sampleS": round(self._sample_s, 6),
                    "cycleS": round(self._cycle_s, 6),
                },
            }

    def status_fields(self) -> dict[str, dict]:
        """Per-job fields /status merges in, so ``adaptdl-tpu
        status`` answers "is this job healthy" without a Prometheus
        scrape: tenant, measured vs predicted goodput, drift, flag."""
        view = self.metrics_view()
        return {
            key: {
                "tenant": job["tenant"],
                "goodputMeasured": job["measured"],
                "goodputPredicted": job["predicted"],
                "goodputDrift": job["drift"],
                "reprofile": job["reprofile"],
                "incidents": job["incidents"],
                "rollbacks": job["rollbacks"],
                "lastGoodAge": job["lastGoodAge"],
            }
            for key, job in view["jobs"].items()
        }

    def watch_summary(self) -> dict:
        """Deterministic fairness/drift summary over the retained
        window — built ONLY from clock-stamped, rounded sample values
        (never the wall-clock overhead counters), so a fixed-seed sim
        run reproduces it bit-for-bit."""
        with self._lock:
            tenants = {}
            for tenant in sorted(self._tenant_series):
                series = list(self._tenant_series[tenant])
                if not series:
                    continue
                shares = [s["share"] for s in series]
                rhos = [
                    s["rho"] for s in series if s["rho"] is not None
                ]
                tenants[tenant] = {
                    "samples": len(series),
                    "shareMean": _r6(sum(shares) / len(shares)),
                    "rhoP50": _r6(_pct(rhos, 0.5)),
                    "rhoP90": _r6(_pct(rhos, 0.9)),
                    "chipsMax": max(s["chips"] for s in series),
                    "burn": self._slo_burn.get(tenant, 0),
                }
            utils = [s["utilization"] for s in self._cluster]
            drifts = []
            flagged = 0
            for key in sorted(self._drift):
                drift, flag = self._drift_locked(key)
                if drift is not None:
                    drifts.append(_r6(drift))
                    flagged += int(flag)
            return {
                "samples": self._samples,
                "tenants": tenants,
                "cluster": {
                    "utilMean": (
                        _r6(sum(utils) / len(utils)) if utils else 0.0
                    ),
                    "utilMax": _r6(max(utils, default=0.0)),
                },
                "drift": {
                    "jobsTracked": len(drifts),
                    "flagged": flagged,
                    "p50": _r6(_pct(drifts, 0.5)),
                },
            }
