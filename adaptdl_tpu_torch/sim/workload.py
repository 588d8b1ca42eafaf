"""Workload model + replayable job-arrival traces for the simulator.

The category mix is modeled on the Pollux OSDI'21 evaluation workload
(itself drawn from the Microsoft Philly trace): mostly small
short-lived jobs, a fat tail of large long ones. A trace is a JSONL
file of small arrival records —

    {"t": 12.34, "job": "sim/j00001", "category": "medium",
     "seed": 913274, "duration": 512.7, "requested": 4}

— everything else (fitted perf/grad parameters, restart-cost stats,
batch geometry, total work) is *derived deterministically* from the
category template plus the record's ``seed``, so a committed trace
stays a few dozen bytes per job while replaying bit-identically.

``duration`` is the job's target runtime at its *requested* fixed
allocation with zero queueing — the fixed-allocation baseline's ideal
JCT. Its total useful work is ``duration x goodput(requested)`` under
the job's own fitted model, so the adaptive policy is scored on
exactly the same work the baseline runs.
"""

from __future__ import annotations

import json
import random
from dataclasses import dataclass

from adaptdl_tpu_torch.goodput import GradParams, PerfParams, mesh_shape_grid


@dataclass(frozen=True)
class SimCategory:
    name: str
    weight: float  # share of arrivals
    max_replicas: int
    requested: int  # the fixed baseline's replica ask
    init_bsz: int
    max_bsz: int
    bounds: tuple[int, int]  # local atomic-batch bounds
    duration_mean_s: float  # mean ideal runtime at `requested`
    restart_mean_s: float  # mean checkpoint-restart cost
    compute_scale: float  # scales the per-step compute constants
    # Mesh-shape limits a job of this category advertises (the
    # max*Shards hints); > 1 makes the category a LARGE-MODEL
    # workload the replica-only scheduler cannot shape correctly —
    # its jobs post a meshShapeGrid and the policy may factorize
    # their chips as (dp, tp, pp) meshes.
    max_model_shards: int = 1
    max_stage_shards: int = 1


# Pollux evaluation mix 72/20/6/2 (% of arrivals), plus a "mega"
# large-model tail: jobs whose statistical batch budget is nearly
# exhausted at their initial batch size (dp scaling hits the
# efficiency cliff immediately) but whose per-step compute is heavy —
# exactly the surface where a (dp, tp, pp) factorization wins. Their
# share is small (2%) but each asks for real capacity.
CATEGORIES: dict[str, SimCategory] = {
    "small": SimCategory(
        "small", 0.72, 4, 1, 64, 512, (16, 128), 300.0, 10.0, 0.5
    ),
    "medium": SimCategory(
        "medium", 0.20, 16, 4, 128, 2048, (32, 256), 600.0, 20.0, 1.0
    ),
    "large": SimCategory(
        "large", 0.06, 32, 8, 256, 4096, (64, 512), 1200.0, 45.0, 2.0
    ),
    "xlarge": SimCategory(
        "xlarge", 0.02, 64, 16, 512, 8192, (64, 1024), 2400.0, 90.0, 4.0
    ),
    "mega": SimCategory(
        "mega", 0.02, 32, 8, 128, 256, (8, 64), 1800.0, 120.0, 8.0,
        max_model_shards=8, max_stage_shards=2,
    ),
}

# Base fitted constants (the ballpark the repo's policy tests anchor
# to); per-category compute scaling + per-job jitter are applied on
# top in resolve_job().
_BASE_PERF = (0.12, 0.006, 0.03, 0.008, 0.012, 0.003, 1.2)


@dataclass
class SimJobSpec:
    """A trace record resolved into everything the engine needs."""

    key: str
    category: str
    arrival: float
    max_replicas: int
    requested: int
    init_bsz: int
    max_bsz: int
    bounds: tuple[int, int]
    duration_s: float
    restart_cost_s: float
    perf: PerfParams
    grad: GradParams
    # Mesh-shape advertisement (large-model categories): the
    # max*Shards limits and the explicit candidate grid the job's
    # hints carry. Empty grid = dp-only job (the pre-mesh hint shape,
    # byte-identical on the wire).
    max_model_shards: int = 1
    max_stage_shards: int = 1
    mesh_shape_grid: tuple = ()


def percentile(values: list, q: float) -> float:
    """Deterministic nearest-rank percentile on the sorted list (the
    sim report and the control-plane bench share one definition)."""
    if not values:
        return 0.0
    ordered = sorted(values)
    rank = min(
        max(int(round(q * (len(ordered) - 1))), 0), len(ordered) - 1
    )
    return float(ordered[rank])


def hints_payload(
    spec: "SimJobSpec", profiled: int = 1, dp_only: bool = False
) -> dict:
    """The sched-hints dict a simulated job posts: its fitted model,
    batch geometry, profiling gate, and restart-stat sample (the
    0.2/0.4/0.4 snapshot/write/restore split). One home — the engine's
    hint events and the control-plane bench's synthetic jobs must post the same
    payload shape. Large-model specs additionally post their mesh
    limits + meshShapeGrid; ``dp_only=True`` strips them (the
    replica-only policy arm of the retention comparison), leaving the
    payload byte-identical to a pre-mesh job's."""
    cost = spec.restart_cost_s
    payload = {
        "perfParams": dict(spec.perf._asdict()),
        "gradParams": dict(spec.grad._asdict()),
        "initBatchSize": spec.init_bsz,
        "maxBatchSize": spec.max_bsz,
        "localBszBounds": list(spec.bounds),
        "gradientAccumulation": True,
        "maxProfiledReplicas": int(profiled),
        "restartStats": {
            "snapshotS": round(0.2 * cost, 4),
            "writeS": round(0.4 * cost, 4),
            "restoreS": round(0.4 * cost, 4),
        },
    }
    if not dp_only and spec.mesh_shape_grid:
        payload["maxModelShards"] = spec.max_model_shards
        payload["maxStageShards"] = spec.max_stage_shards
        payload["meshShapeGrid"] = [
            list(shape) for shape in spec.mesh_shape_grid
        ]
    return payload


def resolve_job(record: dict) -> SimJobSpec:
    """Deterministically expand one trace record: the per-job RNG is
    seeded from the record, so two loads of the same trace produce
    bit-identical job populations."""
    cat = CATEGORIES[record["category"]]
    rng = random.Random(int(record["seed"]))
    jitter = lambda lo, hi: rng.uniform(lo, hi)  # noqa: E731
    scale = cat.compute_scale * jitter(0.7, 1.4)
    alpha_c, beta_c, alpha_n, beta_n, alpha_r, beta_r, gamma = _BASE_PERF
    perf = PerfParams(
        alpha_c * scale,
        beta_c * scale,
        alpha_n * jitter(0.7, 1.4),
        beta_n * jitter(0.7, 1.4),
        alpha_r * jitter(0.7, 1.4),
        beta_r * jitter(0.7, 1.4),
        gamma,
    )
    # Gradient noise scale spread: noise-dominated jobs (high var/sqr)
    # scale batch efficiently; signal-dominated ones hit the
    # statistical-efficiency cliff early — the heterogeneity Pollux's
    # goodput packing exploits.
    sqr = 0.001 * jitter(0.5, 2.0)
    var = sqr * jitter(4.0, 40.0)
    grid: tuple = ()
    if cat.max_model_shards > 1 or cat.max_stage_shards > 1:
        # Large-model category: the extra draws happen only for mesh
        # categories, AFTER the shared sequence — committed traces of
        # the pre-mesh categories replay bit-identically. The fitted
        # surface is tp-favorable by construction: compute is
        # BATCH-dominated (big beta_c, small alpha_c — the per-chip
        # share divides by tp), the gradient sync is expensive, the
        # per-layer TP collectives are cheap, and the batch budget is
        # nearly exhausted at init (signal-dominated noise), so extra
        # chips only help by DIVIDING the model, not the data.
        perf = PerfParams(
            0.05 * jitter(0.8, 1.2),
            0.10 * jitter(0.8, 1.2),
            0.40 * jitter(0.8, 1.2),
            0.06 * jitter(0.8, 1.2),
            0.20 * jitter(0.8, 1.2),
            0.03 * jitter(0.8, 1.2),
            1.2,
            alpha_tp=0.002 * jitter(0.7, 1.3),
            beta_tp=0.0002 * jitter(0.7, 1.3),
            alpha_pp=0.002 * jitter(0.7, 1.3),
            beta_pp=0.0002 * jitter(0.7, 1.3),
        )
        var = sqr * jitter(1.0, 3.0)
        grid = mesh_shape_grid(
            max_model_shards=cat.max_model_shards,
            max_stage_shards=cat.max_stage_shards,
        )
    return SimJobSpec(
        key=record["job"],
        category=cat.name,
        arrival=float(record["t"]),
        max_replicas=cat.max_replicas,
        requested=int(record.get("requested") or cat.requested),
        init_bsz=cat.init_bsz,
        max_bsz=cat.max_bsz,
        bounds=cat.bounds,
        duration_s=float(record["duration"]),
        restart_cost_s=cat.restart_mean_s * jitter(0.5, 2.0),
        perf=perf,
        grad=GradParams(sqr=sqr, var=var),
        max_model_shards=cat.max_model_shards,
        max_stage_shards=cat.max_stage_shards,
        mesh_shape_grid=grid,
    )


def generate_trace(
    num_jobs: int,
    duration_s: float,
    seed: int = 0,
    mix: dict[str, float] | None = None,
) -> list[dict]:
    """Poisson arrivals over ``duration_s`` with the category mix.
    Deterministic for a fixed seed; records are sorted by arrival."""
    rng = random.Random(int(seed))
    weights = {
        name: (mix or {}).get(name, cat.weight)
        for name, cat in CATEGORIES.items()
    }
    names = sorted(weights)
    total = sum(weights[name] for name in names) or 1.0
    rate = num_jobs / max(float(duration_s), 1e-9)
    records: list[dict] = []
    t = 0.0
    for i in range(num_jobs):
        t += rng.expovariate(rate)
        pick = rng.random() * total
        category = names[-1]
        for name in names:
            pick -= weights[name]
            if pick <= 0:
                category = name
                break
        cat = CATEGORIES[category]
        duration = min(
            max(rng.expovariate(1.0 / cat.duration_mean_s), 30.0),
            6.0 * cat.duration_mean_s,
        )
        records.append(
            {
                "t": round(t, 3),
                "job": f"sim/j{i:05d}",
                "category": category,
                "seed": rng.randrange(1 << 31),
                "duration": round(duration, 3),
                "requested": cat.requested,
            }
        )
    return records


def write_trace(path: str, records: list[dict]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for record in records:
            f.write(json.dumps(record, sort_keys=True) + "\n")


def load_trace(path: str) -> list[dict]:
    records: list[dict] = []
    with open(path, encoding="utf-8") as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            record = json.loads(line)
            for field in ("t", "job", "category", "seed", "duration"):
                if field not in record:
                    raise ValueError(
                        f"trace line {lineno}: missing {field!r}"
                    )
            if record["category"] not in CATEGORIES:
                raise ValueError(
                    f"trace line {lineno}: unknown category "
                    f"{record['category']!r}"
                )
            records.append(record)
    records.sort(key=lambda r: (float(r["t"]), r["job"]))
    return records
