"""Shared cluster state: the contract between the control plane's parts.

The port's copy of ``adaptdl_tpu.sched.state``: a small threadsafe job
table with waiters that the allocator, the supervisor and the runners
read and write. It keeps the JAX package's in-memory op model unchanged:
every mutator builds an op record (``{"op": "update", "key": ...,
...}``) and applies it through ``_apply_locked``, and the job snapshot
(``_job_to_dict`` / ``_job_from_dict``) is the JAX package's, so either
state can be carried into the other.

**Transactional rescale** (``ADAPTDL_ALLOC_COMMIT_TIMEOUT``): an
allocation change opens a prepare -> commit *epoch*. The new allocation
commits only once the new worker group proves liveness (every expected
process registers or beats); if the commit deadline lapses the job rolls
back to its last committed allocation, the failing slots earn a strike,
and ``ADAPTDL_SLOT_STRIKE_LIMIT`` consecutive strikes quarantine a slot
until a timed probe (``ADAPTDL_SLOT_QUARANTINE_S``).

**Durability** (``state_dir`` or ``ADAPTDL_SCHED_STATE_DIR``): every op
record is appended to a write-ahead journal (``sched/journal.py``) and
fsynced before it applies, with a periodic snapshot. A fresh state on the
same directory recovers the job table by replaying them, then opens a
reconciliation window (``ADAPTDL_SCHED_RECONCILE_WINDOW``): recovered
leases get grace deadlines and pending epochs fresh commit deadlines, so
live workers reattach before anything expires. The files are the JAX
package's, byte for byte, so either package recovers what the other wrote.

**Watch** (``self.watch``, ``watch.WatchStore``): measured goodput from
the hints, step-time EWMAs from the beats, incidents, and the allocator's
per-cycle samples and explain records. In memory only, never journaled:
a recovered state starts with empty series. The store's lock is never
taken under ``_cond``.

Not ported yet (ROADMAP Queue 1): the tenant migration half (the reshard
``pending`` and ``moved`` tables and the op-log stream: the snapshot
carries them empty).
"""

from __future__ import annotations

import logging
import math
import threading
import time
from bisect import bisect_left
from dataclasses import dataclass, field
from typing import Any

from adaptdl_tpu_torch import env, faults, trace
from adaptdl_tpu_torch.sched.journal import StateJournal
from adaptdl_tpu_torch.watch import WatchStore, tenant_of

LOG = logging.getLogger(__name__)

# Terminal job statuses. Shared here (not in allocator) so every
# consumer — allocator skip-list, operator cleanup, runner threads —
# agrees on one definition.
FINISHED = ("Succeeded", "Failed", "Stopped")


# Allocator decision-latency buckets (adaptdl_alloc_decide_seconds):
# incremental cycles live in the millisecond band, full NSGA-II cycles
# in the 0.1-60s band.
_ALLOC_DECIDE_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


def normalize_topology(
    topology: dict | None,
) -> dict:
    """Canonical form for launch-config comparisons: ``None`` and the
    explicit pure-DP dict are the SAME configuration — treating them
    as different would restart every job the first time it posts
    hints."""
    topology = topology or {}
    stage_shards = int(topology.get("stageShards", 1))
    return {
        "seqShards": int(topology.get("seqShards", 1)),
        "modelShards": int(topology.get("modelShards", 1)),
        "stageShards": stage_shards,
        "expertShards": int(topology.get("expertShards", 1)),
        # M is only meaningful with a pipeline; canonicalize to 1
        # otherwise so adding the key never restarts a pure-DP job.
        "pipelineMicro": (
            int(topology.get("pipelineMicro", 4)) if stage_shards > 1
            else 1
        ),
    }


@dataclass
class JobRecord:
    key: str  # "namespace/name"
    spec: dict = field(default_factory=dict)  # min/max replicas, etc.
    hints: dict | None = None  # posted SCHED_HINTS
    allocation: list[str] = field(default_factory=list)
    # Scheduler-chosen mesh factorization for the current allocation:
    # {"seqShards": s, "modelShards": t} (exported to the job as
    # ADAPTDL_SEQ_SHARDS / ADAPTDL_MODEL_SHARDS by the launcher).
    topology: dict | None = None
    # Scheduler-chosen per-replica batch configuration
    # ({"atomicBsz": b, "accumSteps": a}) for the current allocation.
    # Unlike allocation/topology, a change here is a LIVE RE-TUNE: the
    # job adopts it in-process (jit cache keyed by shape, dataloader
    # position kept) and is never restarted for it.
    batch_config: dict | None = None
    # Count of batch-config-only decisions published (re-tunes that
    # cost zero restarts) — the observability counterpart of `group`.
    retunes: int = 0
    status: str = "Pending"  # Pending|Starting|Running|Stopping|Succeeded|Failed
    # rank -> address ("host:port"), registered by running workers.
    workers: dict[int, str] = field(default_factory=dict)
    group: int = 0  # restart group; workers of older groups are stale
    # rank -> monotonic lease deadline, renewed by worker heartbeats
    # (and piggybacked on register/hints/config traffic). A rank with
    # no lease entry has never heartbeat and is never expired — lease
    # enforcement only binds workers that opted into liveness.
    leases: dict[int, float] = field(default_factory=dict)
    # True once a lease expired for this incarnation: the job is
    # running short-handed (or hung) and a reallocation was triggered.
    # Cleared when the degradation is SERVED — the allocator re-grants
    # an allocation, or the next restart group registers — so the
    # degraded window on /metrics measures time-to-replacement (a
    # surviving rank's heartbeats must not mask a missing peer).
    degraded: bool = False
    # Non-graceful worker failures so far (exit-143 rescales and
    # evictions never count); the controller gives up past its budget.
    failures: int = 0
    # Pod names already counted against the failure budget: a failed
    # pod stays visible for several reconcile passes (delete latency,
    # delete errors), and re-counting it each pass would burn the
    # whole budget on one crash. Names embed the restart group, so no
    # reset on group bump is needed.
    counted_failures: list[str] = field(default_factory=list)
    creation_timestamp: float = field(default_factory=time.time)
    # Controller-side restart counter (ADAPTDL_NUM_RESTARTS of the
    # next launch), persisted so a crash-restarted controller never
    # reuses a checkpoint version index.
    restarts: int = 0
    # Worker processes the current incarnation is expected to run
    # (reported on register); the commit quorum for a pending epoch.
    expected_processes: int = 1
    # ---- transactional rescale (prepare -> commit epochs) ----------
    # The last allocation whose worker group fully proved liveness —
    # the rollback target when a newer allocation never comes up.
    committed_allocation: list[str] = field(default_factory=list)
    committed_topology: dict | None = None
    committed_batch_config: dict | None = None
    alloc_epoch: int = 0  # bumped at every prepared allocation change
    alloc_state: str = "committed"  # "committed" | "pending"
    # Monotonic deadline by which a pending epoch must commit (None
    # when committed or when transactional rescale is disabled).
    alloc_deadline: float | None = None
    # Restart group at prepare time; when alloc_require_bump is set
    # (something was alive at prepare), only liveness from a LATER
    # group counts toward the commit quorum — the doomed incarnation's
    # dying heartbeats must not commit the allocation replacing it.
    alloc_prepare_group: int = 0
    alloc_require_bump: bool = False
    # Ranks that proved liveness for the pending epoch (transient —
    # reset at prepare/recovery; workers re-prove after a restart).
    alloc_fresh: set[int] = field(default_factory=set)
    # Ranks that have shown ANY liveness this incarnation (register
    # or heartbeat, leased or not) — what `alloc_require_bump` keys
    # on: with lease enforcement disabled there are no lease entries
    # to betray a live incarnation, but its beats land here, so its
    # replacement still needs successor-group proof. Transient.
    alive_ranks: set[int] = field(default_factory=set)
    # W3C traceparent of the rescale decision behind the current
    # launch config (graftscope): the allocator mints it, the
    # launcher exports it as ADAPTDL_TRACEPARENT, and /config serves
    # it — so worker spans on both sides of the restart stitch into
    # the supervisor's epoch timeline.
    trace_parent: str | None = None
    # Monotonic stamp of the last epoch prepare (transient): the
    # commit/rollback span's start, so the epoch's prepare->verdict
    # window is measured, not inferred.
    alloc_prepared_at: float | None = None
    # Peer-to-peer handoff advertisement (PUT /handoff): where the
    # doomed incarnation's shard server lives and which restart group
    # it served — published during the prepare→commit epoch so the
    # successor discovers its predecessor's in-memory state through
    # the control plane and skips the checkpoint-storage read. A
    # successor only trusts an advertisement from EXACTLY its
    # immediate predecessor group; each new drain overwrites the
    # previous one.
    handoff_url: str | None = None
    handoff_group: int = -1
    # True while the incumbent incarnation drains after a preemption
    # notice (POST /preempt): the affected slots are already withdrawn
    # from inventory and the successor's allocation epoch may open
    # DURING the notice window. Cleared when the successor group shows
    # up (register/heartbeat bump) or the incumbent's leases expire.
    draining: bool = False
    # Monotonic end of the notice window (transient — re-armed with a
    # fresh clock on recovery).
    drain_deadline: float | None = None
    # Speculative warm-up: the allocator's PREDICTED next launch
    # config, published just before the decision so runners can
    # pre-warm a successor (process up, AOT compiled, shards
    # pre-pulled) while the incumbent still trains. Nothing commits
    # through a candidate — the real allocation update (and its
    # prepare epoch) follows, and a candidate is discarded when a
    # different decision supersedes it, when the epoch rolls back, or
    # when the successor group arrives.
    candidate_allocation: list[str] = field(default_factory=list)
    candidate_topology: dict | None = None
    candidate_batch_config: dict | None = None
    # alloc_epoch at publish time (-1 = no candidate outstanding):
    # stamps which epoch the candidate predicted the successor of, so
    # a runner can reject one that predates a rollback.
    candidate_epoch: int = -1


def _job_to_dict(record: JobRecord) -> dict:
    """JSON-serializable snapshot form of one job record. Lease
    deadlines are monotonic-clock values, meaningless across a
    process restart — only the set of lease-holding ranks persists
    (recovery re-grants them reconciliation-grace deadlines)."""
    return {
        "key": record.key,
        "spec": record.spec,
        "hints": record.hints,
        "allocation": list(record.allocation),
        "topology": record.topology,
        "batch_config": record.batch_config,
        "retunes": record.retunes,
        "status": record.status,
        "workers": {str(r): a for r, a in record.workers.items()},
        "group": record.group,
        "lease_ranks": sorted(record.leases),
        "degraded": record.degraded,
        "failures": record.failures,
        "counted_failures": list(record.counted_failures),
        "creation_timestamp": record.creation_timestamp,
        "restarts": record.restarts,
        "expected_processes": record.expected_processes,
        "committed_allocation": list(record.committed_allocation),
        "committed_topology": record.committed_topology,
        "committed_batch_config": record.committed_batch_config,
        "alloc_epoch": record.alloc_epoch,
        "alloc_state": record.alloc_state,
        "alloc_prepare_group": record.alloc_prepare_group,
        "alloc_require_bump": record.alloc_require_bump,
        "trace_parent": record.trace_parent,
        "handoff_url": record.handoff_url,
        "handoff_group": record.handoff_group,
        "draining": record.draining,
        "candidate_allocation": list(record.candidate_allocation),
        "candidate_topology": record.candidate_topology,
        "candidate_batch_config": record.candidate_batch_config,
        "candidate_epoch": record.candidate_epoch,
    }


def _job_from_dict(payload: dict) -> JobRecord: 
    record = JobRecord(key=payload["key"])
    record.spec = dict(payload.get("spec") or {})
    record.hints = payload.get("hints")
    record.allocation = list(payload.get("allocation") or [])
    record.topology = payload.get("topology")
    record.batch_config = payload.get("batch_config")
    record.retunes = int(payload.get("retunes", 0))
    record.status = payload.get("status", "Pending")
    record.workers = {
        int(r): a for r, a in (payload.get("workers") or {}).items()
    }
    record.group = int(payload.get("group", 0))
    # Placeholder deadlines; recovery re-grants grace deadlines.
    record.leases = {
        int(r): 0.0 for r in payload.get("lease_ranks") or []
    }
    record.degraded = bool(payload.get("degraded", False))
    record.failures = int(payload.get("failures", 0))
    record.counted_failures = list(
        payload.get("counted_failures") or []
    )
    # Snapshots always carry the stamp; 0.0 (not "now") keeps the
    # load deterministic for older snapshot versions.
    record.creation_timestamp = float(
        payload.get("creation_timestamp", 0.0)
    )
    record.restarts = int(payload.get("restarts", 0))
    record.expected_processes = int(
        payload.get("expected_processes", 1)
    )
    record.committed_allocation = list(
        payload.get("committed_allocation") or []
    )
    record.committed_topology = payload.get("committed_topology")
    record.committed_batch_config = payload.get(
        "committed_batch_config"
    )
    record.alloc_epoch = int(payload.get("alloc_epoch", 0))
    record.alloc_state = payload.get("alloc_state", "committed")
    record.alloc_prepare_group = int(
        payload.get("alloc_prepare_group", 0)
    )
    record.alloc_require_bump = bool(
        payload.get("alloc_require_bump", False)
    )
    record.trace_parent = payload.get("trace_parent")
    record.handoff_url = payload.get("handoff_url")
    record.handoff_group = int(payload.get("handoff_group", -1))
    record.draining = bool(payload.get("draining", False))
    record.candidate_allocation = list(
        payload.get("candidate_allocation") or []
    )
    record.candidate_topology = payload.get("candidate_topology")
    record.candidate_batch_config = payload.get(
        "candidate_batch_config"
    )
    record.candidate_epoch = int(payload.get("candidate_epoch", -1))
    return record


class ClusterState:
    """Threadsafe job table with change notification, optional
    write-ahead durability, and transactional allocation epochs."""

    def __init__(
        self,
        state_dir: str | None = None,
        alloc_commit_timeout: float | None = None,
        slot_strike_limit: int | None = None,
        slot_quarantine_s: float | None = None,
        reconcile_window: float | None = None,
        snapshot_every: int = 256,
        hazard_tau_s: float | None = None,
        clock=None,
    ):
        self._cond = threading.Condition()  # lock-order: 10
        # Injectable clock (``monotonic()`` + ``time()``): defaults to
        # the real ``time`` module; the discrete-event simulator
        # (adaptdl_tpu/sim) passes a virtual clock so this exact state
        # machine runs under simulated time — every internal deadline,
        # lease stamp, and completion time then derives from event
        # time, which is what makes a fixed-seed sim bit-reproducible.
        # Assigned once before any other thread holds a reference.
        self._clock = time if clock is None else clock
        # The job table is THE cross-component contract: allocator,
        # supervisor, runner, and operator threads all touch it, so
        # every access goes through the condition's lock .
        self._jobs: dict[str, JobRecord] = {}  # guarded-by: _cond
        # Lifecycle metrics (reference: the controller's Prometheus
        # submission Counter and completion-time Summary,
        # sched/adaptdl_sched/controller.py:35-41): monotonic across
        # job deletion, served by the supervisor's /metrics.
        self._submitted_total = 0  # guarded-by: _cond
        # final status -> (count, sum_of_completion_seconds)
        self._completions: dict[str, tuple[int, float]] = {}  # guarded-by: _cond
        # Transactional-rescale knobs (0 commit timeout disables the
        # epoch machinery entirely — allocations commit immediately).
        self._commit_timeout = (
            env.alloc_commit_timeout()
            if alloc_commit_timeout is None
            else float(alloc_commit_timeout)
        )
        self._strike_limit = max(
            env.slot_strike_limit()
            if slot_strike_limit is None
            else int(slot_strike_limit),
            1,
        )
        self._quarantine_s = (
            env.slot_quarantine_s()
            if slot_quarantine_s is None
            else float(slot_quarantine_s)
        )
        self._reconcile_window = (
            env.sched_reconcile_window()
            if reconcile_window is None
            else float(reconcile_window)
        )
        # Slot health: consecutive failed-allocation strikes and the
        # quarantine table (slot -> monotonic un-quarantine time).
        self._slot_strikes: dict[str, int] = {}  # guarded-by: _cond
        self._quarantined: dict[str, float] = {}  # guarded-by: _cond
        self._rollbacks: dict[str, int] = {}  # guarded-by: _cond
        # Preemption survival: slots draining under an active reclaim
        # notice (slot -> monotonic end of the notice window; the
        # allocator must not place jobs on them), the per-slot-kind
        # reclaim-hazard EWMA (kind -> (rate, last wall ts) — wall
        # clock so the estimate survives restarts via the journal),
        # notice counters, and the allocator-registered slot->kind map
        # (in-memory: derivable from the inventory every cycle).
        self._hazard_tau = (
            env.hazard_tau_s()
            if hazard_tau_s is None
            else max(float(hazard_tau_s), 1.0)
        )
        self._draining_slots: dict[str, float] = {}  # guarded-by: _cond
        self._hazard: dict[str, tuple[float, float]] = {}  # guarded-by: _cond
        self._preempt_notices: dict[str, int] = {}  # guarded-by: _cond
        self._slot_kinds: dict[str, str] = {}  # guarded-by: _cond
        self._preemptible_slots: set[str] = set()  # guarded-by: _cond
        # Numeric-health incidents (graftguard): per-kind counts, a
        # bounded per-job record tail, the slot<->data recurrence
        # tables behind blame classification — recurring incidents on
        # the same SLOT across different data strike the slot toward
        # quarantine; recurring incidents on the same DATA across
        # slots blame the data (no hardware quarantine) — and the
        # idempotency ledger (ordered-set of (key, group, step, kind)
        # identities, deterministically bounded). All rebuilt by
        # replaying journaled `incident` ops; counts and blame tables
        # also ride snapshots.
        self._incident_counts: dict[str, int] = {}  # guarded-by: _cond
        self._incidents: dict[str, list] = {}  # guarded-by: _cond
        self._incident_slot_data: dict[str, list] = {}  # guarded-by: _cond
        self._incident_data_slots: dict[str, list] = {}  # guarded-by: _cond
        self._incident_seen: dict = {}  # guarded-by: _cond
        # Incremental allocation: jobs whose scheduling inputs changed
        # since the allocator last consumed the set — arrivals,
        # departures, hint/spec updates, preemption notices, lease
        # expiries. The allocator re-optimizes only these against a
        # pinned background until dirtiness crosses its full-cycle
        # threshold. In-memory transient (the post-recovery first
        # cycle is always full).
        self._dirty: set[str] = set()  # guarded-by: _cond
        # Allocator decision telemetry, served by the supervisor's
        # /metrics as adaptdl_alloc_decide_seconds{mode} (histogram)
        # and adaptdl_alloc_dirty_jobs (gauge).
        self._alloc_decide: dict[str, dict] = {}  # guarded-by: _cond
        self._alloc_last_dirty = 0  # guarded-by: _cond
        # Allocator kick counter: bumped by a preemption notice so the
        # allocator re-places the job DURING the notice window instead
        # of waiting out its cycle interval.
        self._alloc_kick = 0  # guarded-by: _cond
        # Durability / recovery bookkeeping. ``_replaying`` is true only
        # inside recovery's replay loop: replayed ops are history and
        # must not record trace events or spans again.
        self._last_seq = 0  # guarded-by: _cond
        self._replaying = False  # guarded-by: _cond
        self._reconcile_until = 0.0  # guarded-by: _cond
        self._recoveries = 0  # guarded-by: _cond
        self._last_recovery_s: float | None = None  # guarded-by: _cond
        self._torn_records = 0  # guarded-by: _cond
        # The goodput-accounting, provenance and drift store: in memory,
        # never journaled (a recovered state starts with empty series).
        # Assigned once before any other thread holds a reference; the
        # store carries its own lock.
        self.watch = WatchStore(clock=self._clock)
        # Assigned once, before any other thread can hold a reference
        # to this state: mutators then only read it (under _cond).
        self._journal: StateJournal | None = None
        if state_dir is None:
            state_dir = env.sched_state_dir()
        if state_dir:
            self._journal = StateJournal(
                state_dir, snapshot_every=snapshot_every
            )
            self._recover()

    @property
    def alloc_commit_timeout(self) -> float:
        return self._commit_timeout

    # -- write-ahead journal -------------------------------------------

    def _journal_append(self, op: dict) -> None:  # holds-lock: _cond
        """Durably journal one mutation BEFORE it is applied. Rotates
        snapshot and journal first when due: every earlier mutation is
        applied by then, so the snapshot is consistent and this op lands
        in the fresh journal. A no-op without ``state_dir``."""
        if self._journal is None:
            return
        if self._journal.snapshot_due():
            self._journal.write_snapshot(self._snapshot_payload_locked())
        self._last_seq = self._journal.append(op)

    def _snapshot_payload_locked(self) -> dict:  # holds-lock: _cond
        """The JAX package's snapshot, key for key (its reshard tables,
        which the port does not carry, empty)."""
        return {
            "version": 1,
            "jobs": {
                key: _job_to_dict(record)
                for key, record in self._jobs.items()
            },
            "submitted_total": self._submitted_total,
            "completions": {
                status: [count, total]
                for status, (count, total) in self._completions.items()
            },
            "slot_strikes": dict(self._slot_strikes),
            "quarantined": sorted(self._quarantined),
            "rollbacks": dict(self._rollbacks),
            "recoveries": self._recoveries,
            "draining_slots": sorted(self._draining_slots),
            "hazard": {
                kind: [rate, last_ts]
                for kind, (rate, last_ts) in self._hazard.items()
            },
            "preempt_notices": dict(self._preempt_notices),
            "incidents": {
                "counts": dict(self._incident_counts),
                "slot_data": {
                    slot: list(datas)
                    for slot, datas in self._incident_slot_data.items()
                },
                "data_slots": {
                    data: list(slots)
                    for data, slots in self._incident_data_slots.items()
                },
            },
            "reshard": {"pending": {}, "moved": {}},
        }

    def _load_snapshot_locked(self, snapshot: dict) -> None:  # holds-lock: _cond
        self._submitted_total = int(snapshot.get("submitted_total", 0))
        self._completions = {
            status: (int(count), float(total))
            for status, (count, total) in (
                snapshot.get("completions") or {}
            ).items()
        }
        self._slot_strikes = {
            slot: int(n)
            for slot, n in (snapshot.get("slot_strikes") or {}).items()
        }
        self._rollbacks = {
            key: int(n)
            for key, n in (snapshot.get("rollbacks") or {}).items()
        }
        # Placeholder deadlines, re-armed by _recover (monotonic stamps
        # died with the old process).
        self._quarantined = {
            slot: 0.0 for slot in snapshot.get("quarantined") or []
        }
        self._draining_slots = {
            slot: 0.0 for slot in snapshot.get("draining_slots") or []
        }
        self._recoveries = int(snapshot.get("recoveries", 0))
        # The hazard EWMA is wall-clock anchored: it survives as-is.
        self._hazard = {
            kind: (float(rate), float(last_ts))
            for kind, (rate, last_ts) in (
                snapshot.get("hazard") or {}
            ).items()
        }
        self._preempt_notices = {
            kind: int(n)
            for kind, n in (snapshot.get("preempt_notices") or {}).items()
        }
        incidents = snapshot.get("incidents") or {}
        self._incident_counts = {
            str(kind): int(n)
            for kind, n in (incidents.get("counts") or {}).items()
        }
        self._incident_slot_data = {
            str(slot): [str(d) for d in datas]
            for slot, datas in (incidents.get("slot_data") or {}).items()
        }
        self._incident_data_slots = {
            str(data): [str(s) for s in slots]
            for data, slots in (incidents.get("data_slots") or {}).items()
        }
        reshard = snapshot.get("reshard") or {}
        if reshard.get("pending") or reshard.get("moved"):
            LOG.warning(
                "the snapshot holds tenant-migration tables, which the "
                "port does not carry; dropping them"
            )
        for key, payload in (snapshot.get("jobs") or {}).items():
            self._jobs[key] = _job_from_dict(payload)

    def _recover(self) -> None:
        """Rebuild state from snapshot and journal, then open the
        reconciliation window: recovered leases get grace deadlines and
        pending epochs fresh commit deadlines, so live workers can
        reattach before any expiry or rollback verdict is reached."""
        start = self._clock.monotonic()
        snapshot, records, torn = self._journal.load()
        with self._cond:
            if snapshot is not None:
                self._load_snapshot_locked(snapshot)
            self._replaying = True
            try:
                for op in records:
                    try:
                        self._apply_locked(op, start)
                    except Exception:  # noqa: BLE001 - prefix recovery
                        LOG.exception(
                            "skipping unreplayable journal record %r", op
                        )
            finally:
                self._replaying = False
            self._torn_records = torn
            self._last_seq = self._journal.last_seq
            now = self._clock.monotonic()
            if self._jobs:
                self._reconcile_until = now + self._reconcile_window
            grace = max(self._reconcile_window, 1.0)
            for record in self._jobs.values():
                for rank in list(record.leases):
                    record.leases[rank] = now + grace
                if record.alloc_state == "pending":
                    record.alloc_deadline = (
                        now
                        + max(self._commit_timeout, 0.0)
                        + self._reconcile_window
                    )
                    record.alloc_fresh = set()
                if record.draining:
                    record.drain_deadline = now + env.preempt_notice_s()
            # Quarantine and drain clocks did not survive the restart:
            # re-arm full fresh windows (a struck-out slot stays benched,
            # a slot mid-drain is still about to vanish).
            self._quarantined = {
                slot: now + self._quarantine_s for slot in self._quarantined
            }
            self._draining_slots = {
                slot: now + env.preempt_notice_s()
                for slot in self._draining_slots
            }
            if snapshot is not None or records:
                op = {"op": "recovered"}
                self._journal_append(op)
                self._apply_locked(op, now)
            self._last_recovery_s = self._clock.monotonic() - start
            self._cond.notify_all()

    def last_journal_seq(self) -> int:
        """The newest stamped journal seq (0 without a journal)."""
        with self._cond:
            return self._last_seq

    def close(self) -> None:
        """Sync and close the journal (a pending group commit included).
        The state stays readable; a later mutation reopens the file."""
        if self._journal is not None:
            self._journal.close()

    # -- replay/apply layer (shared by live mutators and recovery) -----

    def _apply_locked(self, op: dict, now: float) -> Any:  # holds-lock: _cond
        """Dispatch one journal op to its apply function. ``now`` is
        the caller's monotonic stamp: live mutators read the clock
        BEFORE applying, recovery passes one replay-wide stamp — the
        apply layer itself never reads a clock, so
        replaying a journal reproduces durable state bit-for-bit."""
        kind = op["op"]
        if kind == "create_job":
            return self._apply_create_locked(op, now)
        if kind == "remove_job":
            return self._apply_remove_locked(op, now)
        if kind == "update":
            return self._apply_update_locked(op, now)
        if kind == "retune":
            return self._apply_retune_locked(op, now)
        if kind == "register":
            return self._apply_register_locked(op, now)
        if kind == "lease":
            return self._apply_lease_locked(op, now)
        if kind == "lease_expired":
            return self._apply_lease_expiry_locked(op, now)
        if kind == "alloc_commit":
            return self._apply_commit_locked(op, now)
        if kind == "alloc_rollback":
            return self._apply_rollback_locked(op, now)
        if kind == "preempt":
            return self._apply_preempt_locked(op, now)
        if kind == "incident":
            return self._apply_incident_locked(op, now)
        if kind == "handoff":
            return self._apply_handoff_locked(op, now)
        if kind == "candidate":
            return self._apply_candidate_locked(op, now)
        if kind == "recovered":
            self._recoveries += 1
            return None
        raise ValueError(f"unknown journal op {kind!r}")

    def _apply_create_locked(  # holds-lock: _cond
        self, op: dict, now: float
    ) -> JobRecord:
        key = op["key"]
        if key in self._jobs:
            return self._jobs[key]
        record = JobRecord(
            key=key,
            spec=dict(op.get("spec") or {}),
            # Live mutators always stamp ts; a record from an older
            # journal version replays as 0.0 — deterministic, never
            # "whenever the replay happened to run".
            creation_timestamp=float(op.get("ts") or 0.0),
        )
        self._jobs[key] = record
        self._submitted_total += 1
        # An arrival is scheduling-relevant: the incremental allocator
        # must consider this job on its next cycle.
        self._dirty.add(key)
        return record

    def _apply_remove_locked(self, op: dict, now: float) -> None:  # holds-lock: _cond
        self._jobs.pop(op["key"], None)
        # Per-job incident tail goes with the job; the slot/data blame
        # tables deliberately survive — a flaky chip stays suspect
        # across the jobs it burns.
        self._incidents.pop(op["key"], None)
        # A departure frees capacity — counted toward the allocator's
        # dirtiness (redistribution to survivors rides full cycles).
        self._dirty.add(op["key"])

    def _apply_update_locked(  # holds-lock: _cond
        self, op: dict, now: float
    ) -> None:
        record = self._jobs[op["key"]]
        ts = float(op.get("ts") or 0.0)
        fields = op["fields"]
        # Scheduling-input changes mark the job dirty for the
        # incremental allocator: new hints/spec, or a transition into
        # a terminal status (its capacity frees up). Allocator-written
        # fields (allocation/topology/batch_config) deliberately do
        # NOT — the allocator's own publishes must not feed back into
        # its dirtiness signal.
        if (
            "hints" in fields
            or "spec" in fields
            or (
                fields.get("status") in FINISHED
                and record.status not in FINISHED
            )
        ):
            self._dirty.add(op["key"])
        # A launch-config change is an allocation change OR a
        # topology change on the same slot list — the runners restart
        # workers for either, so either must open a commit epoch (a
        # topology-only rescale whose mesh never comes up needs the
        # same rollback protection).
        launch_config_changed = "allocation" in fields and (
            list(fields["allocation"] or [])
            != list(record.allocation)
            or (
                "topology" in fields
                and normalize_topology(fields["topology"])
                != normalize_topology(record.topology)
            )
        )
        for name, value in fields.items():
            if (
                name == "status"
                and record.status in FINISHED
                and value not in FINISHED
            ):
                # Terminal statuses are sticky: a supervising
                # thread racing a stop_job()/completion must not
                # resurrect the job (the allocator would re-grant
                # it chips).
                continue
            if (
                name == "status"
                and value in FINISHED
                and record.status not in FINISHED
            ):
                # First transition into a terminal status: record
                # the completion time for the lifecycle summary.
                count, total = self._completions.get(value, (0, 0.0))
                self._completions[value] = (
                    count + 1,
                    total + max(ts - record.creation_timestamp, 0.0),
                )
            if name == "allocation":
                value = list(value or [])
                if launch_config_changed:
                    if value and self._commit_timeout > 0:
                        # PREPARE: the new allocation must prove
                        # itself before it becomes the rollback
                        # target.
                        record.alloc_epoch += 1
                        record.alloc_state = "pending"
                        record.alloc_prepare_group = record.group
                        record.alloc_require_bump = bool(
                            record.workers
                            or record.leases
                            or record.alive_ranks
                        )
                        record.alloc_fresh = set()
                        record.alloc_deadline = (
                            now + self._commit_timeout
                        )
                        record.alloc_prepared_at = now
                        if not self._replaying:
                            trace.event(
                                "epoch.prepare",
                                traceparent=fields.get(
                                    "trace_parent",
                                    record.trace_parent,
                                ),
                                job=record.key,
                                epoch=record.alloc_epoch,
                            )
                    elif value:
                        # Transactional rescale disabled: trust it.
                        record.alloc_epoch += 1
                        record.alloc_state = "committed"
                        record.alloc_deadline = None
                    else:
                        # Withdrawal cancels any pending epoch (the
                        # allocator will re-place; the committed
                        # rollback target is kept).
                        record.alloc_state = "committed"
                        record.alloc_deadline = None
                        record.alloc_fresh = set()
                if value and record.degraded:
                    # The allocator re-placed the job: the lease
                    # expiry that withdrew the allocation is served.
                    record.degraded = False
            setattr(record, name, value)
        if launch_config_changed and record.candidate_epoch >= 0:
            # The decision landed. A candidate that matches it stays
            # visible — the runner mid-warm-up revalidates against it
            # at cutover — while a superseding decision discards it:
            # the warm successor was built for a config that will
            # never launch.
            if list(record.allocation) != list(
                record.candidate_allocation
            ) or normalize_topology(
                record.topology
            ) != normalize_topology(record.candidate_topology):
                self._clear_candidate_locked(record)
        if self._commit_timeout <= 0 and "allocation" in fields:
            # Transactional rescale disabled: every published config
            # is immediately the rollback target.
            self._promote_committed_locked(record)

    def _apply_retune_locked(self, op: dict, now: float) -> None:  # holds-lock: _cond
        record = self._jobs[op["key"]]
        record.batch_config = dict(op["batch_config"])
        record.retunes += 1

    def _note_liveness_locked(  # holds-lock: _cond
        self, record: JobRecord, rank: int
    ) -> None:
        if record.alloc_state != "pending":
            return
        if (
            record.alloc_require_bump
            and record.group <= record.alloc_prepare_group
        ):
            # The prepare replaced a live incarnation; only its
            # SUCCESSOR's liveness may commit the new allocation.
            return
        record.alloc_fresh.add(rank)

    def _apply_register_locked(  # holds-lock: _cond
        self, op: dict, now: float
    ) -> bool:
        record = self._jobs[op["key"]]
        group, rank = int(op["group"]), int(op["rank"])
        if group > record.group:
            record.group = group
            record.workers = {}
            # A fresh incarnation starts with a clean liveness
            # slate: old-group leases (and the degraded verdict
            # they produced) describe processes that are gone.
            record.leases = {}
            record.degraded = False
            record.alloc_fresh = set()
            record.alive_ranks = set()
            # The new incarnation re-declares its commit quorum (its
            # registers carry the count); a single-process successor
            # never registers, so a stale multi-process quorum would
            # make its epochs forever uncommittable.
            record.expected_processes = 1
            # The successor arrived: the preemption drain is served,
            # and any outstanding warm-up candidate did its job.
            record.draining = False
            record.drain_deadline = None
            self._clear_candidate_locked(record)
        accepted = group == record.group
        if accepted:
            record.workers[rank] = op["address"]
            record.alive_ranks.add(rank)
            if op.get("processes"):
                record.expected_processes = max(
                    int(op["processes"]), 1
                )
            self._note_liveness_locked(record, rank)
        return accepted

    def _apply_lease_locked(self, op: dict, now: float) -> None:  # holds-lock: _cond
        record = self._jobs[op["key"]]
        group = op.get("group")
        rank = int(op["rank"])
        if group is not None and group < record.group:
            return
        if group is not None and group > record.group:
            # A heartbeat from a newer incarnation is as good a
            # group-bump signal as a registration (single-process
            # jobs never register — their liveness rides heartbeats).
            record.group = int(group)
            record.workers = {}
            record.leases = {}
            record.degraded = False
            record.alloc_fresh = set()
            record.alive_ranks = set()
            # Same quorum reset as a register-driven bump: heartbeats
            # are how single-process incarnations announce themselves.
            record.expected_processes = 1
            record.draining = False
            record.drain_deadline = None
            self._clear_candidate_locked(record)
        record.alive_ranks.add(rank)
        if float(op["ttl"]) > 0:
            # ttl 0 = lease enforcement disabled: the beat proves
            # liveness below but must not plant an instantly-stale
            # lease for the sweeper to expire.
            record.leases[rank] = now + float(op["ttl"])
        self._note_liveness_locked(record, rank)

    def _apply_lease_expiry_locked(  # holds-lock: _cond
        self, op: dict, now: float
    ) -> None:
        record = self._jobs[op["key"]]
        for rank in op["ranks"]:
            rank = int(rank)
            record.leases.pop(rank, None)
            record.workers.pop(rank, None)
            record.alive_ranks.discard(rank)
        if op.get("withdraw"):
            record.degraded = True
            record.allocation = []
            record.alloc_state = "committed"
            record.alloc_deadline = None
            record.alloc_fresh = set()
            # The incumbent died without a successor: the drain (if
            # one was open) resolved into a plain lease expiry.
            record.draining = False
            record.drain_deadline = None
            # The withdrawn job needs re-placement on the next cycle.
            self._dirty.add(op["key"])

    def _promote_committed_locked(  # holds-lock: _cond
        self, record: JobRecord
    ) -> None:
        """The job's CURRENT allocation/topology/batch-config triple
        becomes its rollback target — always all three together, so a
        rollback can never pair configs from different decisions."""
        record.committed_allocation = list(record.allocation)
        record.committed_topology = (
            dict(record.topology) if record.topology else None
        )
        record.committed_batch_config = (
            dict(record.batch_config) if record.batch_config else None
        )

    def _apply_commit_locked(self, op: dict, now: float) -> None:  # holds-lock: _cond
        record = self._jobs[op["key"]]
        self._promote_committed_locked(record)
        record.alloc_state = "committed"
        record.alloc_deadline = None
        record.alloc_fresh = set()
        # The epoch's prepare->commit window, as a span in the job's
        # rescale trace (skipped during recovery replay, where the
        # prepare stamp died with the old process anyway).
        if not self._replaying and record.alloc_prepared_at is not None:
            trace.record_span(
                "epoch.commit",
                self._clock.monotonic() - record.alloc_prepared_at,
                traceparent=record.trace_parent,
                job=record.key,
                epoch=record.alloc_epoch,
            )
        record.alloc_prepared_at = None
        # Consecutive-failure semantics: a slot that just hosted a
        # successful commit earns a clean slate.
        for slot in set(record.allocation):
            self._slot_strikes.pop(slot, None)

    def _apply_rollback_locked(  # holds-lock: _cond
        self, op: dict, now: float
    ) -> None:
        record = self._jobs[op["key"]]
        record.allocation = list(record.committed_allocation)
        record.topology = (
            dict(record.committed_topology)
            if record.committed_topology
            else None
        )
        record.batch_config = (
            dict(record.committed_batch_config)
            if record.committed_batch_config
            else None
        )
        record.alloc_state = "committed"
        record.alloc_deadline = None
        record.alloc_fresh = set()
        if not self._replaying and record.alloc_prepared_at is not None:
            trace.record_span(
                "epoch.rollback",
                self._clock.monotonic() - record.alloc_prepared_at,
                traceparent=record.trace_parent,
                job=record.key,
                epoch=record.alloc_epoch,
            )
        record.alloc_prepared_at = None
        # A candidate published against the rolled-back epoch is
        # stale: a runner must never warm (or cut over to) a
        # successor for a config the epoch machinery just revoked.
        self._clear_candidate_locked(record)
        self._rollbacks[op["key"]] = (
            self._rollbacks.get(op["key"], 0) + 1
        )
        for slot in op.get("strikes", []):
            strikes = self._slot_strikes.get(slot, 0) + 1
            self._slot_strikes[slot] = strikes
            if strikes >= self._strike_limit:
                self._quarantined[slot] = now + self._quarantine_s

    def _update_hazard_locked(  # holds-lock: _cond
        self, kind: str, ts: float
    ) -> None:
        """Fold one observed reclaim into the kind's hazard EWMA:
        exponential decay since the last event plus a 1/tau impulse —
        at a steady reclaim rate R the estimate converges to R
        events/second, and with no events it decays back toward zero
        over ~tau. Anchored to the journaled wall timestamp so replay
        reproduces the estimate exactly."""
        rate, last = self._hazard.get(kind, (0.0, float(ts)))
        dt = max(float(ts) - last, 0.0)
        decayed = rate * math.exp(-dt / self._hazard_tau)
        self._hazard[kind] = (
            decayed + 1.0 / self._hazard_tau,
            float(ts),
        )

    def _apply_preempt_locked(  # holds-lock: _cond
        self, op: dict, now: float
    ) -> None:
        """A reclaim notice: the job starts draining, its slots leave
        the placement inventory for the notice window, and each slot's
        kind pays a hazard observation. The notice's trace parent (the
        worker minted it at notice time) becomes the job's — the
        allocator's re-placement REUSES it, so the notice, the drain
        save, and the successor's first step share one trace id."""
        record = self._jobs[op["key"]]
        notice_s = float(op.get("notice_s") or 30.0)
        # The kicked allocator cycle must re-place this job.
        self._dirty.add(op["key"])
        record.draining = True
        record.drain_deadline = now + notice_s
        if op.get("trace_parent"):
            record.trace_parent = op["trace_parent"]
        ts = float(op.get("ts") or 0.0)
        kinds = op.get("kinds") or {}
        for slot in op.get("slots", []):
            self._draining_slots[slot] = now + notice_s
        # ONE notice = one observed reclaim: one hazard impulse (and
        # one notice count) per affected KIND, however many of the
        # job's slots share it — per-slot impulses would teach the
        # EWMA that a 4-slice job's single notice was 4 reclaims.
        for kind in sorted(
            {kinds.get(slot, "spot") for slot in op.get("slots", [])}
        ):
            self._update_hazard_locked(kind, ts)
            self._preempt_notices[kind] = (
                self._preempt_notices.get(kind, 0) + 1
            )
        if not self._replaying:
            trace.event(
                "preempt.slot_withdrawn",
                traceparent=record.trace_parent,
                job=record.key,
                slots=len(op.get("slots", [])),
            )

    def _apply_incident_locked(  # holds-lock: _cond
        self, op: dict, now: float
    ) -> str:
        """A worker's numeric-health incident (NaN loss/grad or a loss
        spike): count it, append it to the job's bounded record tail,
        and classify blame from recurrence — the same DATA going bad
        on two different slots indicts the data (no hardware action);
        the same SLOT going bad on two different data ids indicts the
        slot, which pays a strike toward quarantine exactly like a
        failed rescale epoch. Returns the blame verdict."""
        key = op["key"]
        record = self._jobs.get(key)
        kind = str(op.get("kind") or "unknown")
        data = op.get("data")
        slot = op.get("slot")
        # Idempotency ledger entry is derived from the op itself so a
        # journal replay re-arms dedupe for post-recovery retries.
        ledger = (
            key,
            int(op.get("group") or 0),
            int(op.get("step") or 0),
            kind,
        )
        self._incident_seen[ledger] = None
        while len(self._incident_seen) > 1024:
            self._incident_seen.pop(next(iter(self._incident_seen)))
        self._incident_counts[kind] = (
            self._incident_counts.get(kind, 0) + 1
        )
        blame = "unknown"
        if slot and data:
            slots = self._incident_data_slots.setdefault(
                str(data), []
            )
            if str(slot) not in slots:
                slots.append(str(slot))
                del slots[:-16]
            datas = self._incident_slot_data.setdefault(
                str(slot), []
            )
            if str(data) not in datas:
                datas.append(str(data))
                del datas[:-16]
            if len(slots) >= 2:
                blame = "data"
            elif len(datas) >= 2:
                blame = "slot"
                strikes = self._slot_strikes.get(slot, 0) + 1
                self._slot_strikes[slot] = strikes
                if strikes >= self._strike_limit:
                    self._quarantined[slot] = (
                        now + self._quarantine_s
                    )
        tail = self._incidents.setdefault(key, [])
        tail.append(
            {
                "kind": kind,
                "step": int(op.get("step") or 0),
                "data": str(data) if data is not None else None,
                "slot": str(slot) if slot else None,
                "action": str(op.get("action") or ""),
                "blame": blame,
                "ts": float(op.get("ts") or 0.0),
            }
        )
        del tail[:-64]
        if record is not None:
            # A quarantine verdict (or even a suspect slot) should
            # feed the next allocator cycle.
            self._dirty.add(key)
        if not self._replaying:
            trace.event(
                "guard.incident",
                traceparent=(
                    record.trace_parent if record is not None else None
                ),
                job=key,
                kind=kind,
                blame=blame,
            )
        return blame

    def _maybe_commit_locked(  # holds-lock: _cond 
        self, record: JobRecord
    ) -> None:
        """Commit the pending epoch once the new group's liveness
        quorum is reached: every expected worker process has proven
        itself since the prepare, and no registered rank is missing a
        lease (when leases are in play at all)."""
        if record.alloc_state != "pending" or not record.allocation:
            return
        if len(record.alloc_fresh) < max(record.expected_processes, 1):
            return
        if (
            record.leases
            and record.workers
            and not set(record.workers) <= set(record.leases)
        ):
            return
        try:
            # Chaos hook: an injected fault SUPPRESSES the commit
            # signal, forcing the epoch to its timeout/rollback path
            # even though workers are healthy.
            faults.maybe_fail("alloc.commit_timeout")
        except faults.InjectedFault:
            return
        op = {"op": "alloc_commit", "key": record.key}
        self._journal_append(op)
        self._apply_commit_locked(op, self._clock.monotonic())

    # -- mutators (each builds an op record) ----------------------------

    def create_job(
        self, key: str, spec: dict | None = None
    ) -> JobRecord:
        with self._cond:
            if key in self._jobs:
                raise ValueError(f"job exists: {key}")
            op = {
                "op": "create_job",
                "key": key,
                "spec": dict(spec or {}),
                "ts": self._clock.time(),
            }
            self._journal_append(op)
            record = self._apply_create_locked(op, self._clock.monotonic())
            self._cond.notify_all()
            return record

    def remove_job(self, key: str) -> None:
        with self._cond:
            if key not in self._jobs:
                return
            op = {"op": "remove_job", "key": key}
            self._journal_append(op)
            self._apply_remove_locked(op, self._clock.monotonic())
            self._cond.notify_all()
        # The job's watch series go with it.
        self.watch.forget_job(key)

    def update(self, key: str, **fields: Any) -> None:
        with self._cond:
            self._jobs[key]  # KeyError on unknown jobs, like before
            op = {
                "op": "update",
                "key": key,
                "fields": fields,
                "ts": self._clock.time(),
            }
            self._journal_append(op)
            self._apply_update_locked(op, self._clock.monotonic())
            self._cond.notify_all()

    def advertise_handoff(
        self, key: str, url: str, group: int
    ) -> bool:
        """Record where a draining incarnation's handoff shard server
        lives (``PUT /handoff``). Journaled: a supervisor restart
        inside the rescale window must not lose the successor's
        fastest restore path. Rejects stale advertisements — a retry
        from an incarnation older than one already advertised must
        not roll the pointer backwards."""
        with self._cond:
            record = self._jobs.get(key)
            if record is None:
                return False
            if int(group) < record.handoff_group:
                return False
            op = {
                "op": "handoff",
                "key": key,
                "url": str(url),
                "group": int(group),
            }
            self._journal_append(op)
            self._apply_handoff_locked(op, self._clock.monotonic())
            self._cond.notify_all()
            return True

    def _apply_handoff_locked(self, op: dict, now: float) -> None:  # holds-lock: _cond
        record = self._jobs.get(op["key"])
        if record is None:
            return
        record.handoff_url = op["url"]
        record.handoff_group = int(op["group"])

    def get_handoff(
        self, key: str
    ) -> dict | None:
        """The job's current handoff advertisement (None when absent):
        ``{"url", "group"}`` — the successor validates the group
        against its own restart count before trusting the peer."""
        with self._cond:
            record = self._jobs.get(key)
            if record is None or not record.handoff_url:
                return None
            return {
                "url": record.handoff_url,
                "group": record.handoff_group,
            }

    def publish_candidate(
        self,
        key: str,
        allocation,
        topology: dict | None = None,
        batch_config: dict | None = None,
        trace_parent: str | None = None,
    ) -> bool:
        """Publish the allocator's PREDICTED next launch config ahead
        of the decision (speculative warm-up): a runner may pre-warm a
        successor for it, but nothing commits through a candidate —
        the real allocation update (and its prepare epoch) follows,
        and a candidate the decision supersedes is simply discarded.
        Journaled so a supervisor recovered mid-warm-up still knows
        what the runner may be warming against."""
        with self._cond:
            if key not in self._jobs:
                return False
            op = {
                "op": "candidate",
                "key": key,
                "allocation": list(allocation or []),
                "topology": topology,
                "batch_config": batch_config,
            }
            if trace_parent:
                op["trace_parent"] = trace_parent
            self._journal_append(op)
            self._apply_candidate_locked(op, self._clock.monotonic())
            self._cond.notify_all()
            return True

    def _apply_candidate_locked(  # holds-lock: _cond
        self, op: dict, now: float
    ) -> None:
        record = self._jobs.get(op["key"])
        if record is None:
            return
        record.candidate_allocation = list(op.get("allocation") or [])
        record.candidate_topology = op.get("topology")
        record.candidate_batch_config = op.get("batch_config")
        # Stamped with the CURRENT epoch: the candidate predicts that
        # epoch's successor, and a rollback of it clears the stamp.
        record.candidate_epoch = record.alloc_epoch
        if not self._replaying:
            trace.event(
                "candidate.publish",
                traceparent=op.get("trace_parent")
                or record.trace_parent,
                job=record.key,
                replicas=len(record.candidate_allocation),
                epoch=record.candidate_epoch,
            )

    def _clear_candidate_locked(  # holds-lock: _cond
        self, record: JobRecord
    ) -> None:
        record.candidate_allocation = []
        record.candidate_topology = None
        record.candidate_batch_config = None
        record.candidate_epoch = -1

    def get_candidate(
        self, key: str
    ) -> dict | None:
        """The job's outstanding candidate launch config (None when
        no warm-up target is published): ``{"allocation", "topology",
        "batchConfig", "epoch"}``. The epoch stamps which alloc_epoch
        the candidate was published against — a consumer must treat a
        vanished or re-stamped candidate as a misprediction and fall
        back to the cold path."""
        with self._cond:
            record = self._jobs.get(key)
            if record is None or record.candidate_epoch < 0:
                return None
            return {
                "allocation": list(record.candidate_allocation),
                "topology": (
                    dict(record.candidate_topology)
                    if record.candidate_topology
                    else None
                ),
                "batchConfig": (
                    dict(record.candidate_batch_config)
                    if record.candidate_batch_config
                    else None
                ),
                "epoch": record.candidate_epoch,
            }

    def publish_retune(
        self, key: str, batch_config: dict
    ) -> bool:
        """Record a batch-config-only decision: updates the published
        config and bumps the re-tune counter atomically. Returns False
        without publishing when the job's allocation has been
        withdrawn or the job is degraded — a re-tune decided against
        an allocation a lease expiry has since rolled back must not
        pair its stale batch config with whatever replaces it."""
        with self._cond:
            record = self._jobs[key]
            if not record.allocation or record.degraded:
                return False
            op = {
                "op": "retune",
                "key": key,
                "batch_config": dict(batch_config),
            }
            self._journal_append(op)
            self._apply_retune_locked(op, self._clock.monotonic())
            self._cond.notify_all()
            return True

    def register_worker(
        self,
        key: str,
        group: int,
        rank: int,
        address: str,
        processes: int | None = None,
    ) -> bool:
        """Record a worker's address; returns whether the
        registration was ACCEPTED into the current restart group (a
        stale-group retry arriving after a rescale is ignored, and
        must not e.g. earn a liveness lease for a rank the new
        incarnation doesn't have). ``processes`` (when reported)
        becomes the commit quorum for a pending allocation epoch."""
        with self._cond:
            record = self._jobs[key]
            op = {
                "op": "register",
                "key": key,
                "group": group,
                "rank": rank,
                "address": address,
            }
            if processes:
                op["processes"] = int(processes)
            self._journal_append(op)
            accepted = self._apply_register_locked(
                op, self._clock.monotonic()
            )
            if accepted:
                self._maybe_commit_locked(record)
            self._cond.notify_all()
            return accepted

    def renew_lease(
        self,
        key: str,
        rank: int,
        ttl: float,
        group: int | None = None,
    ) -> bool:
        """Extend ``rank``'s liveness lease by ``ttl`` seconds from
        now; False if the job is unknown. Called by the supervisor on
        heartbeats and piggybacked on register/hints/config traffic.
        ``group`` (when the worker reports it) guards incarnations: a
        stale group's dying heartbeat is ignored, a newer group's
        first heartbeat bumps the restart group exactly like a
        registration — single-process jobs never register, so their
        commit-quorum liveness rides here. With ``ttl <= 0`` (lease
        enforcement disabled) no lease is planted, but the beat STILL
        counts as commit-quorum liveness and a newer group still
        bumps the incarnation — otherwise disabling leases would
        leave every allocation epoch uncommittable."""
        with self._cond:
            record = self._jobs.get(key)
            if record is None:
                return False
            if group is not None and group < record.group:
                return True
            durable = (
                group is not None and group > record.group
            ) or (ttl > 0 and rank not in record.leases)
            op = {
                "op": "lease",
                "key": key,
                "rank": rank,
                "ttl": max(ttl, 0.0),
            }
            if group is not None:
                op["group"] = group
            if durable:
                self._journal_append(op)
            self._apply_lease_locked(op, self._clock.monotonic())
            self._maybe_commit_locked(record)
            return True

    def expire_stale_leases(
        self, now: float | None = None
    ) -> list[tuple[str, int]]:
        """Expire every lease whose deadline has passed on a Running
        job: the dead rank is dropped from the worker table, the job
        is marked ``degraded``, and its allocation is withdrawn — the
        signal every worker backend already reacts to — so the
        allocator re-places the job on its next cycle instead of the
        cluster waiting forever on a vanished worker. Returns the
        (job, rank) pairs expired. During a post-recovery
        reconciliation window this is a no-op: recovered workers get
        the window to re-prove liveness before anyone is declared
        dead."""
        now = self._clock.monotonic() if now is None else now
        expired: list[tuple[str, int]] = []
        with self._cond:
            if now < self._reconcile_until:
                return []
            for key, record in self._jobs.items():
                if record.status in FINISHED:
                    continue
                stale = [
                    rank
                    for rank, deadline in record.leases.items()
                    if deadline < now
                ]
                if not stale:
                    continue
                op = {
                    "op": "lease_expired",
                    "key": key,
                    "ranks": stale,
                    "withdraw": not record.degraded,
                }
                self._journal_append(op)
                self._apply_lease_expiry_locked(op, now)
                expired.extend((key, rank) for rank in stale)
                # Countable sweep signal (the Grafana per-shard lease
                # panel rates this; per-expiry, not per-sweep-pass).
                trace.event("lease.expired", job=key)
            if expired:
                self._cond.notify_all()
        return expired

    def expire_overdue_allocations(
        self, now: float | None = None
    ) -> list[str]:
        """Roll back every pending allocation epoch whose commit
        deadline has lapsed: the job returns to its last-committed
        allocation/topology/batch-config, and each slot that only the
        failed allocation used earns a strike (``strike_limit``
        consecutive strikes quarantine the slot). Returns the keys of
        rolled-back jobs. Held off during the post-recovery
        reconciliation window, like lease expiry."""
        now = self._clock.monotonic() if now is None else now
        rolled: list[str] = []
        with self._cond:
            if now < self._reconcile_until:
                return []
            for key, record in self._jobs.items():
                if record.status in FINISHED:
                    continue
                if record.alloc_state != "pending":
                    continue
                if (
                    record.alloc_deadline is None
                    or now <= record.alloc_deadline
                ):
                    continue
                strikes = sorted(
                    set(record.allocation)
                    - set(record.committed_allocation)
                )
                op = {
                    "op": "alloc_rollback",
                    "key": key,
                    "strikes": strikes,
                }
                self._journal_append(op)
                self._apply_rollback_locked(op, now)
                rolled.append(key)
            if rolled:
                self._cond.notify_all()
        return rolled

    # -- preemption survival -------------------------------------------

    def report_preemption(
        self,
        key: str,
        group: int | None = None,
        rank: int | None = None,
        slot: str | None = None,
        notice_s: float | None = None,
        trace_parent: str | None = None,
    ) -> bool:
        """Intake of a worker's reclaim notice (``POST /preempt``):
        marks the job draining, withdraws the affected slots from the
        placement inventory for the notice window, updates the
        per-slot-kind hazard EWMA, and kicks the allocator so the
        successor's allocation epoch opens DURING the notice window.
        Idempotent per drain: repeat reports from other ranks of the
        same doomed incarnation (or rpc retries) return False without
        a second hazard observation. A stale incarnation's late notice
        (``group`` below the current one) is ignored too."""
        with self._cond:
            record = self._jobs[key]
            if record.status in FINISHED:
                return False
            if group is not None and group < record.group:
                return False
            now = self._clock.monotonic()
            if record.draining and (
                record.drain_deadline is None
                or now < record.drain_deadline
            ):
                return False
            notice = float(
                notice_s if notice_s else env.preempt_notice_s()
            )
            if slot:
                slots = [slot]
            else:
                # The worker does not know which VM the notice was
                # for, only that one of its hosts is going away:
                # withdraw the job's PREEMPTIBLE slots (a reclaim
                # cannot hit on-demand capacity, and draining a
                # healthy on-demand slot would block re-placing the
                # successor on it). Fall back to the whole allocation
                # when the allocator has not registered preemptibility
                # yet (e.g. right after a supervisor recovery).
                slots = sorted(set(record.allocation))
                known = [
                    s for s in slots if s in self._preemptible_slots
                ]
                if known:
                    slots = known
            op = {
                "op": "preempt",
                "key": key,
                "slots": slots,
                # Kinds resolved at intake time (the allocator
                # registers the slot->kind map each cycle) and
                # journaled, so replay reproduces the hazard estimate
                # without the map.
                "kinds": {
                    s: self._slot_kinds.get(s, "spot") for s in slots
                },
                "notice_s": notice,
                "ts": self._clock.time(),
            }
            if rank is not None:
                op["rank"] = int(rank)
            if trace_parent:
                op["trace_parent"] = trace_parent
            self._journal_append(op)
            self._apply_preempt_locked(op, now)
            # Wake the allocator NOW: re-placement must overlap the
            # drain, not wait out the optimization interval.
            self._alloc_kick += 1
            self._cond.notify_all()
            return True

    # -- numeric-health incidents (graftguard) -------------------------

    def report_incident(
        self,
        key: str,
        kind: str,
        group: int | None = None,
        rank: int | None = None,
        step: int | None = None,
        data: str | None = None,
        action: str | None = None,
    ) -> tuple | None:
        """Intake of a worker's numeric-health incident (``POST
        /incident``): journals it, classifies blame from the slot/data
        recurrence tables (possibly striking the reporting slot toward
        quarantine), and kicks the allocator so a quarantined slot's
        job is re-placed off it immediately. Idempotent per
        (group, step, kind): rpc retries and repeat reports of the
        same incident return None without a second count or strike,
        as do late reports from a superseded incarnation. Returns the
        (blame, slot) verdict otherwise."""
        with self._cond:
            record = self._jobs[key]
            if record.status in FINISHED:
                return None
            if group is not None and group < record.group:
                return None
            kind = str(kind)
            ledger = (key, int(group or 0), int(step or 0), kind)
            if ledger in self._incident_seen:
                return None
            now = self._clock.monotonic()
            # Slot resolved at intake time from the reporting rank's
            # position in the CURRENT allocation and journaled, so
            # replay reproduces blame without allocation history.
            slot = None
            if rank is not None and 0 <= int(rank) < len(
                record.allocation
            ):
                slot = record.allocation[int(rank)]
            op = {
                "op": "incident",
                "key": key,
                "kind": kind,
                "group": int(group or 0),
                "ts": self._clock.time(),
            }
            if rank is not None:
                op["rank"] = int(rank)
            if step is not None:
                op["step"] = int(step)
            if data is not None:
                op["data"] = str(data)
            if slot is not None:
                op["slot"] = slot
            if action:
                op["action"] = str(action)
            self._journal_append(op)
            blame = self._apply_incident_locked(op, now)
            # Wake the allocator NOW: a freshly quarantined slot's
            # occupant must be re-placed off it, not wait out the
            # optimization interval.
            self._alloc_kick += 1
            self._cond.notify_all()
        # The watch store's lock never nests under _cond.
        self.watch.note_incident(key, kind, blame, slot)
        return blame, slot

    def incident_info(self) -> dict:
        """Numeric-health observability in one locked snapshot:
        per-kind incident counts, the bounded per-job record tails,
        and the blame tables (which data ids went bad on which slots
        and vice versa)."""
        with self._cond:
            return {
                "incidentsByKind": dict(self._incident_counts),
                "incidents": {
                    key: [dict(r) for r in tail]
                    for key, tail in self._incidents.items()
                },
                "slotBlame": {
                    slot: list(datas)
                    for slot, datas in self._incident_slot_data.items()
                },
                "dataBlame": {
                    data: list(slots)
                    for data, slots in self._incident_data_slots.items()
                },
            }

    def set_slot_kinds(
        self,
        kinds: dict[str, str],
        preemptible: set[str] | frozenset[str] | None = None,
    ) -> None:
        """Allocator-registered inventory view: the slot->kind map
        ("spot"/"ondemand"/...) that attributes preemption notices to
        a hazard kind, and which slots are preemptible (a notice only
        drains those). REPLACES the previous registration — the
        allocator re-registers the full inventory every cycle, and
        accumulating slots that left the inventory would grow without
        bound under slice churn. In-memory only: derivable from the
        inventory, and journaled preempt ops carry resolved kinds."""
        with self._cond:
            self._slot_kinds = {
                str(k): str(v) for k, v in kinds.items()
            }
            if preemptible is not None:
                self._preemptible_slots = {
                    str(s) for s in preemptible
                }

    def _hazard_rates_locked(  # holds-lock: _cond
        self, now: float
    ) -> dict[str, float]:
        # The EWMA tracks the kind's AGGREGATE notice rate (every
        # reclaim of any slot of the kind lands in one estimator);
        # per-SLOT hazard — what the policy charges per occupied
        # slice and the mix policy prices per provisioned slice —
        # divides by the kind's current fleet size. Unknown fleet
        # (nothing registered yet) conservatively reads as size 1.
        sizes: dict[str, int] = {}
        for kind in self._slot_kinds.values():
            sizes[kind] = sizes.get(kind, 0) + 1
        return {
            kind: (
                rate
                * math.exp(-max(now - last, 0.0) / self._hazard_tau)
                / max(sizes.get(kind, 1), 1)
            )
            for kind, (rate, last) in self._hazard.items()
        }

    def hazard_rates(self, now: float | None = None) -> dict[str, float]:
        """Per-slot reclaim hazard by slot kind (expected notices per
        slot-second: the kind's aggregate EWMA over
        ``ADAPTDL_HAZARD_TAU_S``, normalized by the kind's registered
        fleet size), decayed to ``now`` (wall clock — the estimate is
        journal-anchored so it survives supervisor restarts)."""
        if now is None:
            now = self._clock.time()
        with self._cond:
            return self._hazard_rates_locked(float(now))

    def _prune_draining_locked(  # holds-lock: _cond
        self, now: float
    ) -> None:
        """A drain window that lapsed means the slot was reclaimed
        (the provisioner stops listing it) or the notice was canceled
        (the slot is healthy again) — either way it stops being
        special to the allocator."""
        for slot in [
            slot
            for slot, until in self._draining_slots.items()
            if until <= now
        ]:
            del self._draining_slots[slot]

    def draining_slots(self, now: float | None = None) -> list[str]:
        """Slots under an active reclaim notice: withdrawn from the
        placement inventory for the notice window."""
        now = self._clock.monotonic() if now is None else now
        with self._cond:
            self._prune_draining_locked(now)
            return sorted(self._draining_slots)

    def preemption_info(self, now: float | None = None) -> dict:
        """Preemption observability in one locked snapshot: notice
        counts and decayed hazard rate per slot kind, plus the slots
        currently draining with their remaining notice window."""
        wall = self._clock.time()
        now = self._clock.monotonic() if now is None else now
        with self._cond:
            self._prune_draining_locked(now)
            return {
                "noticesByKind": dict(self._preempt_notices),
                "hazardRates": self._hazard_rates_locked(wall),
                "drainingSlots": {
                    slot: max(until - now, 0.0)
                    for slot, until in self._draining_slots.items()
                },
            }

    def kick_allocator(self) -> None:
        """Wake any allocator blocked in :meth:`wait_alloc_kick`."""
        with self._cond:
            self._alloc_kick += 1
            self._cond.notify_all()

    def alloc_kick_count(self) -> int:
        """The kick counter, snapshotted BEFORE an optimization cycle
        and passed back as :meth:`wait_alloc_kick`'s baseline — a kick
        landing while the cycle runs then wakes the next wait
        immediately instead of being silently consumed."""
        with self._cond:
            return self._alloc_kick

    def wait_alloc_kick(
        self, timeout: float, seen: int | None = None
    ) -> bool:
        """Block until something demands an immediate re-optimization
        (a preemption notice, an explicit kick) or ``timeout`` lapses;
        True when kicked. ``seen`` is the caller's counter baseline
        (:meth:`alloc_kick_count`, taken before its last cycle);
        None means "from now". The allocator's cycle loop waits here
        instead of a plain sleep, so notice-driven re-placement
        overlaps the drain window."""
        deadline = time.monotonic() + max(timeout, 0.0)
        with self._cond:
            if seen is None:
                seen = self._alloc_kick
            while self._alloc_kick == seen:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(remaining)
            return True

    # -- incremental allocation (dirty tracking + decide telemetry) ----

    def mark_job_dirty(self, key: str) -> None:
        """Force the incremental allocator to reconsider ``key`` on
        its next cycle (tests, operators, external policy nudges)."""
        with self._cond:
            self._dirty.add(key)

    def dirty_job_count(self) -> int:
        with self._cond:
            return len(self._dirty)

    def dirty_jobs(self) -> list[str]:
        """Non-consuming peek at the dirty set (the shard inventory
        publisher reads it without stealing the allocator's cycle)."""
        with self._cond:
            return sorted(self._dirty)

    def consume_dirty_jobs(self) -> set[str]:
        """Snapshot-and-clear the dirty set (the allocator calls this
        at the top of each cycle; a mutation landing mid-cycle marks
        dirty again and is picked up by the next one)."""
        with self._cond:
            dirty, self._dirty = self._dirty, set()
            return dirty

    def note_alloc_cycle(
        self, seconds: float, dirty: int, mode: str
    ) -> None:
        """Record one allocator decision: its latency (histogram per
        mode — "full" vs "incremental") and the dirty-job count it
        consumed, for /metrics (adaptdl_alloc_decide_seconds,
        adaptdl_alloc_dirty_jobs)."""
        with self._cond:
            hist = self._alloc_decide.get(mode)
            if hist is None:
                hist = {
                    "counts": [0] * (len(_ALLOC_DECIDE_BUCKETS) + 1),
                    "sum": 0.0,
                    "count": 0,
                }
                self._alloc_decide[mode] = hist
            value = max(float(seconds), 0.0)
            hist["counts"][
                bisect_left(_ALLOC_DECIDE_BUCKETS, value)
            ] += 1
            hist["sum"] += value
            hist["count"] += 1
            self._alloc_last_dirty = int(dirty)

    def alloc_cycle_metrics(self) -> dict:
        """One locked snapshot of the allocator decision telemetry:
        {"buckets": (...), "modes": {mode: {counts, sum, count}},
        "last_dirty": N}."""
        with self._cond:
            return {
                "buckets": _ALLOC_DECIDE_BUCKETS,
                "modes": {
                    mode: {
                        "counts": list(hist["counts"]),
                        "sum": hist["sum"],
                        "count": hist["count"],
                    }
                    for mode, hist in self._alloc_decide.items()
                },
                "last_dirty": self._alloc_last_dirty,
            }

    # -- watch intake (in memory, not journaled) ------------------------

    def observe_measured(self, key: str, goodput: float) -> bool:
        """A job's trainer-reported measured goodput, into the watch
        store under its tenant."""
        with self._cond:
            record = self._jobs.get(key)
            if record is None:
                return False
            tenant = tenant_of(key, record.spec)
        self.watch.observe_measured(key, goodput, tenant=tenant)
        return True

    def note_step_time(self, key: str, rank: int, seconds: float) -> bool:
        """One rank's heartbeat step-time EWMA, attributed to the slot its
        replica runs on (the straggler rule's intake)."""
        with self._cond:
            record = self._jobs.get(key)
            if record is None:
                return False
            rank = int(rank)
            slot = (
                record.allocation[rank]
                if 0 <= rank < len(record.allocation)
                else None
            )
        self.watch.note_step_time(key, rank, slot, seconds)
        return True

    # -- readers -------------------------------------------------------

    def lifecycle_metrics(self) -> dict:
        """Snapshot: submissions counter + completion-time summary."""
        with self._cond:
            return {
                "submitted_total": self._submitted_total,
                "completions": dict(self._completions),
            }

    def get_job(self, key: str) -> JobRecord | None:
        with self._cond:
            return self._jobs.get(key)

    def get_workers(self, key: str) -> dict[int, str] | None:
        """Snapshot of a job's registered workers (readers must not
        iterate the live dict — registration mutates it concurrently)."""
        with self._cond:
            record = self._jobs.get(key)
            return None if record is None else dict(record.workers)

    def get_allocation(self, key: str) -> list[str] | None:
        with self._cond:
            record = self._jobs.get(key)
            return None if record is None else list(record.allocation)

    def get_launch_config(
        self, key: str
    ) -> tuple[list[str], dict | None]:
        """Allocation + topology as ONE locked snapshot — the allocator
        writes them together, and a launcher pairing a new topology
        with a stale chip count would build a mesh the scheduler never
        scored."""
        with self._cond:
            record = self._jobs.get(key)
            if record is None:
                return [], None
            return (
                list(record.allocation),
                dict(record.topology) if record.topology else None,
            )

    def get_batch_config(self, key: str) -> dict | None:
        with self._cond:
            record = self._jobs.get(key)
            if record is None or record.batch_config is None:
                return None
            return dict(record.batch_config)

    def get_config_snapshot(
        self, key: str
    ) -> dict | None:
        """The job's full current decision — allocation, topology,
        batch config, re-tune counter, restart group — as ONE locked
        snapshot. The supervisor's /config endpoint serves exactly
        this: reading the fields off a live JobRecord after the lock
        dropped could pair a new batchConfig with a same-length stale
        allocation, which the loader's size guard cannot detect."""
        with self._cond:
            record = self._jobs.get(key)
            if record is None:
                return None
            return {
                "allocation": list(record.allocation),
                "topology": (
                    dict(record.topology) if record.topology else None
                ),
                "batchConfig": (
                    dict(record.batch_config)
                    if record.batch_config
                    else None
                ),
                "retunes": record.retunes,
                "group": record.group,
                # The decision's trace context: a live worker that
                # polls /config can adopt it, so its final save (the
                # rescale "prepare" on the worker side) lands in the
                # same trace as the restart that follows.
                "traceParent": record.trace_parent,
            }

    def jobs(self) -> dict[str, JobRecord]:
        with self._cond:
            return dict(self._jobs)

    def _prune_quarantine_locked(  # holds-lock: _cond
        self, now: float
    ) -> None:
        """Timed un-quarantine probe: a slot whose quarantine lapsed
        becomes placeable again, but its strike count is primed one
        below the limit — a single new failed allocation re-benches it
        immediately instead of re-earning the whole strike budget."""
        for slot in [
            slot
            for slot, until in self._quarantined.items()
            if until <= now
        ]:
            del self._quarantined[slot]
            self._slot_strikes[slot] = self._strike_limit - 1

    def quarantined_slots(self, now: float | None = None) -> list[str]:
        """Slots the allocator must not place jobs on right now."""
        now = self._clock.monotonic() if now is None else now
        with self._cond:
            self._prune_quarantine_locked(now)
            return sorted(self._quarantined)

    def slot_health(self, now: float | None = None) -> dict:
        """Strike counts, quarantine remaining-seconds, and per-job
        rollback totals — one locked snapshot for /metrics//status."""
        now = self._clock.monotonic() if now is None else now
        with self._cond:
            self._prune_quarantine_locked(now)
            return {
                "strikes": dict(self._slot_strikes),
                "quarantined": {
                    slot: max(until - now, 0.0)
                    for slot, until in self._quarantined.items()
                },
                "rollbacks": dict(self._rollbacks),
            }

    def recovery_info(self) -> dict:
        """Durable-state observability: how many times this cluster's
        state has been recovered, how long the last replay took, torn
        journal records dropped, and the reconciliation window left."""
        with self._cond:
            return {
                "recoveries": self._recoveries,
                "lastRecoveryS": self._last_recovery_s,
                "tornRecords": self._torn_records,
                "reconcileRemainingS": max(
                    self._reconcile_until - self._clock.monotonic(), 0.0
                ),
            }

    def status_snapshot(self) -> dict:
        """Operator-facing per-job view (the /status endpoint): phase,
        degraded flag, allocation epoch/state, lease remaining-seconds
        per rank — one locked snapshot."""
        with self._cond:
            now = self._clock.monotonic()
            jobs = {}
            for key, record in self._jobs.items():
                jobs[key] = {
                    "status": record.status,
                    "tenant": tenant_of(key, record.spec),
                    "degraded": record.degraded,
                    "replicas": len(record.allocation),
                    "allocation": list(record.allocation),
                    "group": record.group,
                    "restarts": record.restarts,
                    "retunes": record.retunes,
                    "workers": len(record.workers),
                    "allocEpoch": record.alloc_epoch,
                    "allocState": record.alloc_state,
                    "draining": record.draining,
                    "drainRemainingS": (
                        max(record.drain_deadline - now, 0.0)
                        if record.draining
                        and record.drain_deadline is not None
                        else None
                    ),
                    "leaseRemainingS": {
                        str(rank): max(deadline - now, 0.0)
                        for rank, deadline in record.leases.items()
                    },
                }
            return {"jobs": jobs}

    def wait_for(self, predicate, timeout: float | None = None) -> bool:
        """Block until ``predicate(jobs_dict)`` is true (or timeout).
        The deadline is monotonic — a wall-clock step (NTP slew,
        suspend/resume) must not stretch or cut the wait."""
        deadline = (
            None if timeout is None else time.monotonic() + timeout
        )
        with self._cond:
            while not predicate(self._jobs):
                remaining = (
                    None
                    if deadline is None
                    else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    return False
                self._cond.wait(remaining)
            return True

    def notify_all(self) -> None:
        """Wake every waiter so it re-reads its predicate (a server
        shutting down releases its long polls this way)."""
        with self._cond:
            self._cond.notify_all()
