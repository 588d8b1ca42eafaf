"""Environment configuration for elastic jobs.

The scheduler talks to a job only through ``ADAPTDL_*`` environment
variables set at (re)start time; this module is the one place that
reads them. The readers here are the ones the port's training path
uses, with the same names, defaults and meanings as the JAX package's
``adaptdl_tpu.env``.

Terminology: a *replica* is one data-parallel model replica; a *chip*
is one GPU; a *node* is one host, the unit whose internal links are
fast; a *process* is one Python process driving its chip. Where the JAX
package drives every chip of a host from one process, the port runs one
process per chip. With data parallelism alone a replica is one chip, so
``ADAPTDL_NUM_PROCESSES`` equals ``ADAPTDL_NUM_REPLICAS`` and the process
rank is the replica rank. Under a sequence axis a replica is a group of
``ADAPTDL_SEQ_SHARDS`` chips: the scheduler exports the job's chips as
``ADAPTDL_NUM_REPLICAS``, and an example rewrites it to
:func:`data_parallel_replicas` before it builds the trainer.
"""

from __future__ import annotations

import os

# Env keys also written by other modules (the tuner writes them into its
# trials' environments): one spelling each.
TRIAL_CONFIG_KEY = "ADAPTDL_TRIAL_CONFIG"
TRIAL_RESULT_KEY = "ADAPTDL_TRIAL_RESULT_FILE"


def _get_int(name: str, default: int) -> int:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else default


def _get_float(name: str, default: float) -> float:
    value = os.environ.get(name)
    return float(value) if value not in (None, "") else default


def _get_str(name: str, default: str | None = None) -> str | None:
    value = os.environ.get(name)
    return value if value not in (None, "") else default


def _get_opt_int(name: str) -> int | None:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else None


def _get_opt_float(name: str) -> float | None:
    value = os.environ.get(name)
    return float(value) if value not in (None, "") else None


def checkpoint_path() -> str | None:
    """Directory for elastic checkpoints, shared across restarts."""
    return _get_str("ADAPTDL_CHECKPOINT_PATH")


def share_path() -> str | None:
    """Shared scratch directory across restarts (tensorboard output, the
    kernel cache)."""
    return _get_str("ADAPTDL_SHARE_PATH")


def tensorboard_logdir() -> str | None:
    """Where the examples write TensorBoard event files."""
    return _get_str("ADAPTDL_TENSORBOARD_LOGDIR")


def replica_rank() -> int:
    """This replica's rank in [0, num_replicas)."""
    return _get_int("ADAPTDL_REPLICA_RANK", 0)


def num_replicas() -> int:
    """Chips granted to this job at launch; the data-parallel replicas
    once an example has rewritten it (:func:`data_parallel_replicas`)."""
    return _get_int("ADAPTDL_NUM_REPLICAS", 1)


def data_parallel_replicas() -> int:
    """Data-parallel replica groups: the job's chips divided by the
    sharded axes' group size (the raw chip count where it does not
    divide: the mesh builder reports a misconfigured topology). The
    chips are the processes where the launcher set them (one process per
    chip), so the value holds after ``ADAPTDL_NUM_REPLICAS`` was
    rewritten to it; else ``ADAPTDL_NUM_REPLICAS`` as launched."""
    group = seq_shards() * model_shards() * stage_shards() * expert_shards()
    chips = _get_int("ADAPTDL_NUM_PROCESSES", num_replicas())
    if group > 1 and chips % group == 0:
        return max(chips // group, 1)
    return chips


def seq_shards() -> int:
    """Sequence-parallel shards per replica group."""
    return _get_int("ADAPTDL_SEQ_SHARDS", 1)


def model_shards() -> int:
    """Tensor-parallel shards per replica group."""
    return _get_int("ADAPTDL_MODEL_SHARDS", 1)


def stage_shards() -> int:
    """Pipeline stages per replica group."""
    return _get_int("ADAPTDL_STAGE_SHARDS", 1)


def expert_shards() -> int:
    """Expert-parallel shards per replica group."""
    return _get_int("ADAPTDL_EXPERT_SHARDS", 1)


def pipeline_micro() -> int:
    """The scheduler's pipeline microbatch count M for the stage axis
    (``ADAPTDL_PIPELINE_MICRO``): 4 by default under a stage axis, else
    1. The topology search picks M with the factorization, so the
    pipelined loss runs the schedule the job was priced at."""
    return _get_int("ADAPTDL_PIPELINE_MICRO", 4 if stage_shards() > 1 else 1)


def num_nodes() -> int:
    """Number of hosts; defaults to one per process."""
    return _get_int("ADAPTDL_NUM_NODES", num_processes())


def num_processes() -> int:
    """Processes participating in the job (default 1). The port runs one
    process per replica, so a multi-replica job has as many processes
    as replicas."""
    return _get_int("ADAPTDL_NUM_PROCESSES", 1)


def process_rank() -> int:
    """This process's rank in [0, num_processes); the replica rank by
    default."""
    return _get_int("ADAPTDL_PROCESS_RANK", replica_rank())


def local_rank() -> int:
    """This process's rank among the processes of its node, which picks
    its device: the job's processes fill its nodes in rank order."""
    per_node = max(num_processes() // max(num_nodes(), 1), 1)
    return process_rank() % per_node


def coordinator_addr() -> str | None:
    """``host:port`` of the process group's rendezvous (rank 0's
    store); required when ``num_processes() > 1``."""
    return _get_str("ADAPTDL_COORDINATOR_ADDR")


def master_addr() -> str:
    """Host that serves the rendezvous (rank 0's)."""
    return _get_str("ADAPTDL_MASTER_ADDR") or "127.0.0.1"


def pod_ip() -> str | None:
    """The address this rank registers with the supervisor, where the
    deployment gives each worker its own (a pod's IP); unset, the rank
    registers its host name's address."""
    return _get_str("ADAPTDL_POD_IP")


def master_port() -> int:
    """Port of the rendezvous; 0 lets the launcher pick a free one."""
    return _get_int("ADAPTDL_MASTER_PORT", 0)


def num_restarts() -> int:
    """How many times the scheduler has restarted this job; indexes the
    checkpoint directories so a dying incarnation's partial save never
    clobbers the previous complete one."""
    return _get_int("ADAPTDL_NUM_RESTARTS", 0)


def checkpoint_every_steps() -> int:
    """Periodic checkpoint cadence in dataloader steps (0 = only the
    final pre-exit save)."""
    return _get_int("ADAPTDL_CKPT_EVERY_STEPS", 0)


def checkpoint_verify() -> bool:
    """Whether ``load_state`` verifies each payload's sha256 and size
    against the checkpoint's manifest before restoring."""
    knob = os.environ.get("ADAPTDL_CKPT_VERIFY", "")
    return knob.lower() not in ("off", "0", "false", "none")


def supervisor_url() -> str | None:
    """Base URL of the cluster supervisor (rendezvous, heartbeats,
    scheduling hints, batch decisions, incidents)."""
    return _get_str("ADAPTDL_SUPERVISOR_URL")


def num_replicas_is_set() -> bool:
    """Whether the scheduler (or launcher) exported a replica count."""
    return "ADAPTDL_NUM_REPLICAS" in os.environ


def set_num_replicas(count: int) -> None:
    """Export the replica count for a standalone run (no scheduler)."""
    os.environ["ADAPTDL_NUM_REPLICAS"] = str(int(count))


def fit_interval() -> float:
    """Seconds between perf refits and hint posts (reference cadence
    30 s)."""
    return _get_float("ADAPTDL_FIT_INTERVAL", 30.0)


def job_id() -> str | None:
    """Unique job identifier, ``namespace/name`` under the k8s operator."""
    return _get_str("ADAPTDL_JOB_ID")


def heartbeat_interval() -> float:
    """Seconds between worker liveness heartbeats to the supervisor (0
    disables the heartbeat thread; liveness then rides only on the hint
    and config traffic)."""
    return _get_float("ADAPTDL_HEARTBEAT_INTERVAL", 20.0)


def fault_spec_raw() -> str | None:
    """Fault-injection schedule, as the raw spec string (``faults``
    parses it). Unset, every injection point is a no-op."""
    return _get_str("ADAPTDL_FAULT_SPEC")


def fault_seed() -> int:
    """Seed of the fault schedule's probabilistic clauses."""
    return _get_int("ADAPTDL_FAULT_SEED", 0)


def guard_policy() -> str:
    """What the numeric-health guard does on an unhealthy step: ``off``,
    ``warn`` (log and report), ``skip`` (also never re-feed the poisoned
    batch) or ``rollback`` (the default: restore the last-known-good
    checkpoint, then skip the poisoned batch)."""
    policy = (_get_str("ADAPTDL_GUARD_POLICY") or "rollback").lower()
    if policy not in ("off", "warn", "skip", "rollback"):
        return "rollback"
    return policy


def guard_window() -> int:
    """Healthy losses the spike detector's rolling median+MAD covers."""
    return max(_get_int("ADAPTDL_GUARD_WINDOW", 32), 4)


def guard_min_samples() -> int:
    """Healthy losses needed before the spike detector arms."""
    return max(_get_int("ADAPTDL_GUARD_MIN_SAMPLES", 8), 2)


def guard_mad_k() -> float:
    """Spike threshold in robust sigmas (1.4826 x MAD) above the median."""
    return max(_get_float("ADAPTDL_GUARD_MAD_K", 8.0), 1.0)


def guard_confirm_steps() -> int:
    """Healthy guard observations after a save before that checkpoint
    earns its last-known-good marker."""
    return max(_get_int("ADAPTDL_GUARD_CONFIRM_STEPS", 8), 1)


def handoff_enabled() -> bool:
    """Whether a planned rescale hands state to the successor peer to
    peer: the stopping incarnation leaves a shard server holding its
    final save's bytes, and the successor pulls them instead of reading
    storage (``ADAPTDL_HANDOFF``; off by default). Any handoff failure
    falls back to the durable checkpoint."""
    knob = os.environ.get("ADAPTDL_HANDOFF", "")
    return knob.lower() in ("on", "1", "true", "yes")


def handoff_url() -> str | None:
    """Explicit base URL of the predecessor's shard server; overrides
    the supervisor's advertisement and the descriptor file."""
    return _get_str("ADAPTDL_HANDOFF_URL")


def handoff_ttl_s() -> float:
    """Seconds the shard server waits for its successor before it
    exits (the durable checkpoint then serves the restore)."""
    return max(_get_float("ADAPTDL_HANDOFF_TTL_S", 60.0), 1.0)


def handoff_timeout_s() -> float:
    """Overall deadline of the successor's handoff fetch (manifest and
    chunks); past it the restore reads the durable checkpoint."""
    return max(_get_float("ADAPTDL_HANDOFF_TIMEOUT_S", 10.0), 0.1)


def handoff_diff_enabled() -> bool:
    """Whether handoff pulls are differential: chunks whose sha256
    already sits in the warm-up prefetch cache are reused instead of
    fetched again (``ADAPTDL_HANDOFF_DIFF``; on by default). A sha
    mismatch fetches the chunk, so the restored bytes are the same
    either way; off pins the full pull."""
    knob = os.environ.get("ADAPTDL_HANDOFF_DIFF", "on")
    return knob.lower() in ("on", "1", "true", "yes")


def warmup_enabled() -> bool:
    """Whether the runners warm a successor speculatively for a planned
    rescale: when the allocator's published candidate matches the new
    launch config, the successor is started (imports, model build,
    chunk prefetch) before the incumbent is signalled
    (``ADAPTDL_WARMUP_ENABLED``; off by default). Any failure falls
    back to the cold planned path."""
    knob = os.environ.get("ADAPTDL_WARMUP_ENABLED", "")
    return knob.lower() in ("on", "1", "true", "yes")


def warmup_flag() -> bool:
    """Set by the runner in a warm successor's environment
    (``ADAPTDL_WARMUP=1``): the process prepares, marks the ready file
    and holds before its restore until the runner writes the cutover
    file."""
    knob = os.environ.get("ADAPTDL_WARMUP", "")
    return knob.lower() in ("on", "1", "true", "yes")


def warmup_ready_file() -> str | None:
    """Path the warm successor writes once warm (runner-provided)."""
    return _get_str("ADAPTDL_WARMUP_READY_FILE")


def warmup_cutover_file() -> str | None:
    """Path the runner writes at cutover (``go``) or discard
    (``abort``); the held successor polls it."""
    return _get_str("ADAPTDL_WARMUP_CUTOVER_FILE")


def warmup_deadline_s() -> float:
    """Longest the runner waits for a warm successor to be ready before
    it discards it and rescales cold; also bounds (six times over, at
    least 60 s) how long a held successor waits for the verdict."""
    return max(_get_float("ADAPTDL_WARMUP_DEADLINE_S", 20.0), 0.1)


def compile_cache_knob() -> str:
    """Raw kernel-cache knob (``ADAPTDL_COMPILE_CACHE``): a path places
    the cache, ``off``/``0``/``false``/``none`` disables it, empty means
    the share path or else the checkpoint path (``ops/_build.py``
    resolves it)."""
    return os.environ.get("ADAPTDL_COMPILE_CACHE", "")


def trace_dir() -> str | None:
    """Directory of the per-job JSONL span journal; unset, spans stay
    in the in-memory ring buffer."""
    return _get_str("ADAPTDL_TRACE_DIR")


def traceparent() -> str | None:
    """W3C ``traceparent`` inherited across the restart: the successor's
    spans join the trace of the decision that restarted it."""
    return _get_str("ADAPTDL_TRACEPARENT")


def preempt_notice_s() -> float:
    """Seconds of warning a preemption notice gives before the machine
    is reclaimed; the urgent drain budgets its final save inside it."""
    return _get_float("ADAPTDL_PREEMPT_NOTICE_S", 30.0)


def preempt_margin_s() -> float:
    """Margin taken off the notice window for the exit after the drain's
    save."""
    return _get_float("ADAPTDL_PREEMPT_MARGIN_S", 5.0)


def preempt_poll_s() -> float:
    """Base cadence of the preemption-notice listener; 0 (the default)
    starts no listener."""
    return _get_float("ADAPTDL_PREEMPT_POLL_S", 0.0)


def preempt_slow_poll_s() -> float:
    """The listener's cadence after ``preempt_backoff_after``
    consecutive polls found no metadata server."""
    return _get_float("ADAPTDL_PREEMPT_SLOW_POLL_S", 60.0)


def preempt_backoff_after() -> int:
    """Consecutive unreachable polls before the listener backs off to
    the slow cadence; one reachable poll restores the base one."""
    return max(_get_int("ADAPTDL_PREEMPT_BACKOFF_AFTER", 12), 1)


# ---- the control plane (``sched/``) -----------------------------------


def watch_buffer_size() -> int:
    """Samples kept per watch time series (per job, per tenant and for
    the cluster): the oldest are evicted first."""
    return max(_get_int("ADAPTDL_WATCH_BUFFER", 512), 8)


def watch_drift_window() -> int:
    """Samples in the rolling measured/predicted goodput window behind
    ``adaptdl_goodput_drift``: the ratio is the mean of the last N."""
    return max(_get_int("ADAPTDL_WATCH_DRIFT_WINDOW", 16), 3)


def watch_drift_threshold() -> float:
    """Relative deviation of the drift ratio from 1.0 past which a job
    is flagged for re-profiling (ratio outside ``[1/(1+t), 1+t]``); a
    metric and a /watch field, never a policy input."""
    return max(_get_float("ADAPTDL_WATCH_DRIFT_THRESHOLD", 0.25), 0.01)


def watch_explain_topk() -> int:
    """Losing candidates kept per allocator cycle's explain record."""
    return max(_get_int("ADAPTDL_WATCH_EXPLAIN_TOPK", 3), 0)


def watch_straggler_factor() -> float:
    """A rank's step-time EWMA above this multiple of its job's median
    marks its slot suspect (``adaptdl_slot_suspect``); needs three or
    more reporting ranks."""
    return max(_get_float("ADAPTDL_WATCH_STRAGGLER_FACTOR", 1.5), 1.0)


def watch_slo_rho() -> float:
    """Per-tenant fairness SLO: each watch sample whose mean slowdown
    rho exceeds it bumps ``adaptdl_tenant_slo_burn_total``."""
    return max(_get_float("ADAPTDL_WATCH_SLO_RHO", 3.0), 0.1)


def trial_config_raw() -> str | None:
    """This tuner trial's hyperparameters as JSON (``tune.py`` sets it
    in the trial's environment)."""
    return _get_str(TRIAL_CONFIG_KEY)


def trial_result_file() -> str | None:
    """JSON-lines file a trial appends its result rows to."""
    return _get_str(TRIAL_RESULT_KEY)


def lease_ttl() -> float:
    """Seconds a worker's liveness lease stays valid without renewal
    before the supervisor declares it dead, marks the job degraded and
    withdraws its allocation (0 disables lease expiry)."""
    return _get_float("ADAPTDL_LEASE_TTL", 120.0)


def sched_state_dir() -> str | None:
    """Directory of a durable cluster state (journal and snapshots)."""
    return _get_str("ADAPTDL_SCHED_STATE_DIR")


def alloc_commit_timeout() -> float:
    """Seconds a newly published allocation has to prove itself (every
    expected worker process of the new group registering or beating)
    before the job rolls back to its last committed allocation and the
    failing slots are struck (0 commits allocations at once)."""
    return _get_float("ADAPTDL_ALLOC_COMMIT_TIMEOUT", 300.0)


def slot_strike_limit() -> int:
    """Consecutive failed-allocation strikes that quarantine a slot."""
    return _get_int("ADAPTDL_SLOT_STRIKE_LIMIT", 3)


def slot_quarantine_s() -> float:
    """Seconds a struck-out slot stays quarantined before a probe."""
    return _get_float("ADAPTDL_SLOT_QUARANTINE_S", 300.0)


def sched_reconcile_window() -> float:
    """Seconds after a recovery during which no lease expires."""
    return _get_float("ADAPTDL_SCHED_RECONCILE_WINDOW", 30.0)


def journal_group_commit_s() -> float:
    """Group-commit window of the cluster state's journal: appends
    within it share one deferred fsync (each is still written and
    flushed before its mutation applies, so a killed supervisor loses
    nothing; a power loss may cost one window). 0, the default, fsyncs
    every record."""
    return max(_get_float("ADAPTDL_JOURNAL_GROUP_COMMIT_S", 0.0), 0.0)


def alloc_dirty_threshold() -> float:
    """Fraction of dirty jobs past which the allocator runs a full
    Pollux cycle instead of re-searching only the dirty jobs."""
    return min(
        max(_get_float("ADAPTDL_ALLOC_DIRTY_THRESHOLD", 0.25), 0.0), 1.0
    )


def alloc_full_every() -> int:
    """A full Pollux cycle every Nth allocator cycle (1: always)."""
    return max(_get_int("ADAPTDL_ALLOC_FULL_EVERY", 10), 1)


def hazard_tau_s() -> float:
    """Time constant of the per-slot-kind reclaim-hazard EWMA."""
    return max(_get_float("ADAPTDL_HAZARD_TAU_S", 3600.0), 1.0)


# Raw runner settings: None when unset; ``sched/config.py`` holds their
# defaults.


def allocator_interval() -> float | None:
    """Seconds between Pollux cycles."""
    return _get_opt_float("ADAPTDL_ALLOCATOR_INTERVAL")


def max_worker_failures() -> int | None:
    """Non-graceful worker failures tolerated before a job is Failed."""
    return _get_opt_int("ADAPTDL_MAX_FAILURES")
