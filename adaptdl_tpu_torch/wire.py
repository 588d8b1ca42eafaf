"""The job-facing wire contracts, the port's copy of ``adaptdl_tpu.wire``.

Every payload a training process exchanges with the supervisor is a
dict with camelCase keys. This module names them in one place, trimmed
to the families the port produces or consumes: its hints and their two
sub-payloads, incidents, the ``/config`` decision with its batch
configuration, heartbeats and registration. The key tuples equal the
JAX package's (a test holds them to it).

Per-family fields: ``keys`` are every key legal on the wire;
``required`` are present in every record since the family's first
version; ``persisted`` marks records that outlive their writer (the
supervisor journals them), whose optional keys a consumer must read
with ``.get``.
"""

from __future__ import annotations

WIRE_CONTRACTS = {
    # job -> cluster: fitted goodput model and limits (PUT /hints).
    "sched_hints": {
        "doc": "PUT /hints body (sched_hints.post_sched_hints)",
        "persisted": True,
        "keys": (
            "initBatchSize",
            "localBszBounds",
            "maxBatchSize",
            "maxProfiledReplicas",
            "gradientAccumulation",
            "gradParams",
            "perfParams",
            "maxSeqShards",
            "maxModelShards",
            "maxStageShards",
            "maxExpertShards",
            "maxPipelineMicro",
            "pipelineMicrobatches",
            "pipelineChunks",
            "meshShapeGrid",
            "restartStats",
            "measuredGoodput",
            "guardStats",
        ),
        "required": ("initBatchSize",),
    },
    # Measured rescale-cost components riding the restartStats hint.
    "restart_stats": {
        "doc": "restartStats sub-payload of sched hints",
        "persisted": True,
        "keys": (
            "snapshotS",
            "writeS",
            "restoreS",
            "overlapFrac",
            "numRetunes",
            "saveBytes",
            "saveKind",
            "deltaRatio",
            "handoffS",
            "handoffBytes",
        ),
        "required": (),
    },
    # Numeric-health summary riding the guardStats hint.
    "guard_stats": {
        "doc": "guardStats sub-payload of sched hints",
        "persisted": True,
        "keys": (
            "policy",
            "incidents",
            "incidentsByKind",
            "rollbacks",
            "skippedBatches",
            "unhealthySteps",
            "healthyStreak",
            "lastGoodAge",
            "rawGoodput",
        ),
        "required": (),
    },
    # One detected corruption event (POST /incident body). The worker
    # reports its rank; the supervisor resolves the slot.
    "incident": {
        "doc": "POST /incident body (guard.post_incident)",
        "persisted": False,
        "keys": ("kind", "step", "rank", "data", "action"),
        "required": ("kind",),
    },
    # cluster -> job: the current decision (GET /config).
    "config": {
        "doc": "GET /config body",
        "persisted": False,
        "keys": (
            "allocation",
            "topology",
            "batchConfig",
            "retunes",
            "group",
            "traceParent",
        ),
        "required": (),
    },
    # The allocator-published batch configuration (live re-tune).
    "batch_config": {
        "doc": "batchConfig sub-payload of /config",
        "persisted": True,
        "keys": ("atomicBsz", "accumSteps"),
        "required": (),
    },
    # Worker liveness beat (PUT /heartbeat body).
    "heartbeat": {
        "doc": "PUT /heartbeat body (sched_hints.send_heartbeat)",
        "persisted": False,
        "keys": ("stepTimeEwma",),
        "required": (),
    },
    # Worker registration (PUT /register body).
    "register": {
        "doc": "PUT /register body (bootstrap)",
        "persisted": False,
        "keys": ("address", "processes"),
        "required": ("address",),
    },
}

SCHED_HINTS_KEYS = WIRE_CONTRACTS["sched_hints"]["keys"]
CONFIG_KEYS = WIRE_CONTRACTS["config"]["keys"]
BATCH_CONFIG_KEYS = WIRE_CONTRACTS["batch_config"]["keys"]
HEARTBEAT_KEYS = WIRE_CONTRACTS["heartbeat"]["keys"]
REGISTER_KEYS = WIRE_CONTRACTS["register"]["keys"]
INCIDENT_KEYS = WIRE_CONTRACTS["incident"]["keys"]
GUARD_STATS_KEYS = WIRE_CONTRACTS["guard_stats"]["keys"]
