"""Environment configuration for elastic jobs.

The scheduler talks to a job only through ``ADAPTDL_*`` environment
variables set at (re)start time; this module is the one place that
reads them. The readers here are the ones the port's training path
uses, with the same names, defaults and meanings as the JAX package's
``adaptdl_tpu.env``.

Terminology: a *replica* is one data-parallel model replica (one GPU);
a *node* is one host, the unit whose internal links are fast; a
*process* is one Python process driving its replica. Where the JAX
package drives every chip of a host from one process, the port runs
one process per replica, so ``ADAPTDL_NUM_PROCESSES`` equals
``ADAPTDL_NUM_REPLICAS`` and the process rank is the replica rank.
"""

from __future__ import annotations

import os


def _get_int(name: str, default: int) -> int:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else default


def _get_float(name: str, default: float) -> float:
    value = os.environ.get(name)
    return float(value) if value not in (None, "") else default


def _get_str(name: str, default: str | None = None) -> str | None:
    value = os.environ.get(name)
    return value if value not in (None, "") else default


def checkpoint_path() -> str | None:
    """Directory for elastic checkpoints, shared across restarts."""
    return _get_str("ADAPTDL_CHECKPOINT_PATH")


def share_path() -> str | None:
    """Shared scratch directory (tensorboard output and the like)."""
    return _get_str("ADAPTDL_SHARE_PATH")


def tensorboard_logdir() -> str | None:
    """Where the examples write TensorBoard event files."""
    return _get_str("ADAPTDL_TENSORBOARD_LOGDIR")


def replica_rank() -> int:
    """This replica's rank in [0, num_replicas)."""
    return _get_int("ADAPTDL_REPLICA_RANK", 0)


def num_replicas() -> int:
    """Devices granted to this job at launch (one replica each)."""
    return _get_int("ADAPTDL_NUM_REPLICAS", 1)


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
