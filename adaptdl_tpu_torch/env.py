"""Environment configuration for elastic jobs.

The scheduler talks to a job only through ``ADAPTDL_*`` environment
variables set at (re)start time; this module is the one place that
reads them. The readers here are the ones the port's training path
uses, with the same names, defaults and meanings as the JAX package's
``adaptdl_tpu.env``.

Terminology: a *replica* is one data-parallel model replica (one GPU);
a *node* is one host, the unit whose internal links are fast; a
*process* is one Python process driving its replicas.
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
    """Processes participating in the job (default 1)."""
    return _get_int("ADAPTDL_NUM_PROCESSES", 1)


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
    """Base URL of the cluster supervisor (rendezvous + sched hints)."""
    return _get_str("ADAPTDL_SUPERVISOR_URL")


def num_replicas_is_set() -> bool:
    """Whether the scheduler (or launcher) exported a replica count."""
    return "ADAPTDL_NUM_REPLICAS" in os.environ


def set_num_replicas(count: int) -> None:
    """Export the replica count for a standalone run (no scheduler)."""
    os.environ["ADAPTDL_NUM_REPLICAS"] = str(int(count))


def fit_interval() -> float:
    """Seconds between perf refits (reference cadence 30 s)."""
    return _get_float("ADAPTDL_FIT_INTERVAL", 30.0)
