"""Command-line interface: the operator's verbs for the port.

The port's copy of ``adaptdl_tpu.cli``, with the verbs whose modules are
ported. Jobs run on this machine under
:class:`~adaptdl_tpu_torch.sched.local_runner.LocalElasticRunner`; the
read-only verbs query a live supervisor of either package (the routes
and their JSON are the same).

Usage (``python -m adaptdl_tpu_torch.cli``, or ``adaptdl-tpu-torch``
once installed)::

    adaptdl-tpu-torch submit train.py --checkpoint-dir DIR [--chips N]
    adaptdl-tpu-torch ls --supervisor http://HOST:PORT
    adaptdl-tpu-torch status --supervisor http://HOST:PORT
    adaptdl-tpu-torch top --supervisor http://HOST:PORT [--watch 2]
    adaptdl-tpu-torch explain ns/job --supervisor http://HOST:PORT
    adaptdl-tpu-torch trace ns/job --supervisor http://HOST:PORT \\
        --perfetto out.json
    adaptdl-tpu-torch hints ns/job --supervisor http://HOST:PORT
    adaptdl-tpu-torch logs --log-file DIR/job.log
    adaptdl-tpu-torch cp DIR/checkpoint-3.0 ./out
    adaptdl-tpu-torch tensorboard --logdir DIR
    adaptdl-tpu-torch check
    adaptdl-tpu-torch sim TRACE --slices 8 --seed 3 --compare-fixed
    adaptdl-tpu-torch sim --generate 64 --duration 500 -o trace.jsonl
    adaptdl-tpu-torch shardmap --supervisor http://ROUTER [--key ns/job]
    adaptdl-tpu-torch reshard plan --supervisor http://ROUTER --retire 1 \\
        --out plan.json
    adaptdl-tpu-torch reshard apply --plan plan.json --map shardmap.json
    adaptdl-tpu-torch reshard status --supervisor http://ROUTER

``submit`` takes one slot per visible card unless ``--chips`` says
otherwise; with no card and no ``--chips`` it refuses rather than run on
the CPU (a script runs on the CPU only when given its own ``--cpu``,
after ``--``).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

# Verbs of the JAX CLI that wait for a module not yet ported, and the
# ROADMAP item (Queue 1) that brings each.
NOT_PORTED = (
    ("submit --backend k8s / --build", "item 5, sched/k8s"),
    ("ls --backend k8s", "item 5, sched/k8s"),
    ("logs JOB (cluster pods)", "item 5, sched/k8s"),
    ("cp namespace/job:path (cluster PVC)", "item 5, sched/k8s"),
    ("tensorboard create|attach|delete --backend k8s", "item 5, sched/k8s"),
    ("deploy", "item 5, sched/k8s"),
)


def _get(args, route: str, endpoint: str):
    from adaptdl_tpu_torch import rpc

    return rpc.default_client().get(
        f"{args.supervisor}{route}",
        endpoint=endpoint,
        timeout=10,
        attempts=3,
        deadline=30.0,
    )


def _cmd_submit(args) -> int:
    from adaptdl_tpu_torch.sched.local_runner import LocalElasticRunner
    from adaptdl_tpu_torch.sched.multi_runner import _device_count
    from adaptdl_tpu_torch.sched.validator import validate_job_spec

    validate_job_spec(
        {"min_replicas": args.min_replicas, "max_replicas": args.max_replicas or 8}
    )
    chips = args.chips if args.chips is not None else _device_count()
    if chips < 1:
        print(
            "submit: no CUDA card visible; pass --chips N to run on slots "
            "of this machine (and --cpu to a script that takes it)",
            file=sys.stderr,
        )
        return 2
    if args.log_file:
        # The runner inherits stdio: redirect ours.
        log = open(args.log_file, "ab", buffering=0)
        os.dup2(log.fileno(), 1)
        os.dup2(log.fileno(), 2)
    runner = LocalElasticRunner(
        args.script,
        num_chips=chips,
        checkpoint_dir=args.checkpoint_dir,
        job_name=args.name or "default/cli-job",
        min_replicas=args.min_replicas,
        max_replicas=args.max_replicas,
        script_args=args.script_args,
    )
    return runner.run()


def _cmd_ls(args) -> int:
    print(_get(args, "/metrics", "cli/metrics").text, end="")
    return 0


def _print_table(rows: list[tuple]) -> None:
    widths = [max(len(row[col]) for row in rows) for col in range(len(rows[0]))]
    for row in rows:
        print(
            "  ".join(
                cell.ljust(width) for cell, width in zip(row, widths)
            ).rstrip()
        )


def _render_status(payload: dict) -> None:
    """The ``status`` view: per-job phase, degraded and draining flags,
    allocation epoch and state, restarts and lease ages; then drains,
    hazards, incidents and their blame, slot strikes and quarantine,
    recoveries and shards."""
    rows = [
        (
            "JOB", "PHASE", "REPLICAS", "DEGRADED", "DRAIN", "ALLOC",
            "RESTARTS", "LEASES",
        )
    ]
    for key, job in sorted(payload.get("jobs", {}).items()):
        ages = job.get("leaseAgeS", {})
        leases = ",".join(
            f"{rank}:{int(age)}s"
            for rank, age in sorted(ages.items(), key=lambda kv: int(kv[0]))
        )
        drain = job.get("drainRemainingS")
        rows.append(
            (
                key,
                str(job.get("status", "?")),
                str(job.get("replicas", 0)),
                "yes" if job.get("degraded") else "no",
                f"{int(drain)}s left"
                if job.get("draining") and drain is not None
                else "-",
                f"{job.get('allocEpoch', 0)}/{job.get('allocState', '?')}",
                str(job.get("restarts", 0)),
                leases or "-",
            )
        )
    _print_table(rows)
    draining_slots = payload.get("drainingSlots") or {}
    if draining_slots:
        print(
            "\ndraining slots (reclaim notice): "
            + ", ".join(
                f"{slot} ({int(remaining)}s left)"
                for slot, remaining in sorted(draining_slots.items())
            )
        )
    hazards = payload.get("hazardRates") or {}
    if any(rate > 0 for rate in hazards.values()):
        print(
            "reclaim hazard: "
            + ", ".join(
                f"{kind}={rate * 3600:.3f}/slot-hour"
                for kind, rate in sorted(hazards.items())
            )
        )
    incidents = payload.get("incidentsByKind") or {}
    if incidents:
        print(
            "numeric incidents: "
            + ", ".join(
                f"{kind}={count}" for kind, count in sorted(incidents.items())
            )
        )
    slot_blame = payload.get("incidentSlotBlame") or {}
    data_blame = payload.get("incidentDataBlame") or {}
    repeat_slots = {s: d for s, d in slot_blame.items() if len(d) >= 2}
    repeat_data = {d: s for d, s in data_blame.items() if len(s) >= 2}
    if repeat_slots:
        print(
            "incident blame (slot — same slot, different data): "
            + ", ".join(
                f"{slot} ({len(datas)} data ids)"
                for slot, datas in sorted(repeat_slots.items())
            )
        )
    if repeat_data:
        print(
            "incident blame (data — same data, different slots): "
            + ", ".join(
                f"{data} ({len(slots)} slots)"
                for data, slots in sorted(repeat_data.items())
            )
        )
    quarantined = payload.get("quarantinedSlots", {})
    strikes = payload.get("slotStrikes", {})
    if quarantined or strikes:
        print()
        rows = [("SLOT", "STRIKES", "QUARANTINED")]
        for slot in sorted(set(quarantined) | set(strikes)):
            remaining = quarantined.get(slot)
            rows.append(
                (
                    slot,
                    str(strikes.get(slot, 0)),
                    f"{int(remaining)}s left" if remaining is not None else "no",
                )
            )
        _print_table(rows)
    recovery = payload.get("recovery") or {}
    if recovery.get("recoveries"):
        print(
            f"\nsupervisor recoveries: {recovery['recoveries']} "
            f"(last replay {recovery.get('lastRecoveryS') or 0:.3f}s, "
            f"{recovery.get('tornRecords', 0)} torn records dropped)"
        )
    shards = payload.get("shards") or {}
    if shards:
        # A router's merged view: one row per supervisor shard.
        print()
        rows = [("SHARD", "JOBS", "RECOVERIES", "TORN", "STATE")]
        for sid in sorted(shards, key=int):
            info = shards[sid]
            shard_recovery = info.get("recovery") or {}
            rows.append(
                (
                    str(sid),
                    str(info.get("jobs", 0)),
                    str(shard_recovery.get("recoveries", 0)),
                    str(shard_recovery.get("tornRecords", 0)),
                    "DOWN: " + str(info["error"])[:40]
                    if info.get("error")
                    else "up",
                )
            )
        _print_table(rows)


def _cmd_status(args) -> int:
    _render_status(_get(args, "/status", "cli/status").json())
    return 0


def _fmt_rate(value) -> str:
    return f"{value:.1f}" if isinstance(value, (int, float)) else "-"


def _render_top(payload: dict) -> None:
    """One frame of the cluster view: utilization, the per-tenant
    fairness table, the per-job goodput table and suspect slots."""
    cluster = payload.get("cluster") or []
    latest = cluster[-1] if cluster else {}
    print(
        f"cluster: {latest.get('jobs', 0)} active job(s), "
        f"{latest.get('chipsAllocated', 0)}/"
        f"{latest.get('chipsTotal', 0)} chips allocated "
        f"(utilization {latest.get('utilization', 0.0):.2f}), "
        f"{payload.get('samples', 0)} watch sample(s)"
        + (
            f", {len(payload['shards'])} shard(s)"
            if payload.get("shards")
            else ""
        )
    )
    tenants = payload.get("tenants") or {}
    if tenants:
        rows = [("TENANT", "JOBS", "CHIPS", "SHARE", "RHO", "SLO-BURN")]
        for tenant, info in sorted(tenants.items()):
            series = info.get("series") or []
            last = series[-1] if series else {}
            rho = last.get("rho")
            rows.append(
                (
                    tenant,
                    f"{last.get('running', 0)}/{last.get('jobs', 0)}",
                    str(last.get("chips", 0)),
                    f"{last.get('share', 0.0):.3f}",
                    f"{rho:.2f}" if rho is not None else "-",
                    str(info.get("burn", 0)),
                )
            )
        print()
        _print_table(rows)
    jobs = payload.get("jobs") or {}
    if jobs:
        rows = [
            (
                "JOB", "TENANT", "REPLICAS", "MEASURED", "PREDICTED",
                "DRIFT", "REPROFILE", "RHO", "INCID", "ROLLBK",
            )
        ]
        for key, info in sorted(jobs.items()):
            last = info.get("latest") or {}
            drift = info.get("drift")
            rho = last.get("rho")
            rows.append(
                (
                    key,
                    info.get("tenant", "-"),
                    str(last.get("replicas", 0)),
                    _fmt_rate(last.get("measured")),
                    _fmt_rate(last.get("predicted")),
                    f"{drift:.3f}" if drift is not None else "-",
                    "YES" if info.get("reprofile") else "no",
                    f"{rho:.2f}" if rho is not None else "-",
                    str(last.get("incidents", 0)),
                    str(last.get("rollbacks", 0)),
                )
            )
        print()
        _print_table(rows)
    suspects = payload.get("suspectSlots") or {}
    if suspects:
        print(
            "\nsuspect slots (straggling step times): "
            + ", ".join(
                f"{slot} ({info['job']} rank {info['rank']}, "
                f"{info['ratio']:.2f}x median)"
                for slot, info in sorted(suspects.items())
            )
        )


def _cmd_top(args) -> int:
    """The cluster view from one ``GET /watch``; ``--watch N``
    re-renders every N seconds until interrupted."""
    import time

    try:
        while True:
            _render_top(_get(args, "/watch", "cli/watch").json())
            if not args.watch:
                return 0
            time.sleep(args.watch)
            print()
    except KeyboardInterrupt:
        return 0


def _render_explain(job: str, payload: dict) -> None:
    """Why the last cycle that re-decided the job gave it its allocation
    and mesh shape: the winner's objective terms and the losers, each
    with the term that killed it."""
    # Incremental pass-through cycles only pin: render the last real
    # decision.
    latest = payload.get("lastDecision") or payload["latest"]
    newest = payload["latest"]
    alloc = latest.get("alloc") or []
    slots = sorted(set(alloc))
    print(f"job {job}  cycle {latest.get('cycle')} ({latest.get('mode')})")
    if latest.get("pinned"):
        print(
            f"  pinned: kept its allocation untouched this cycle "
            f"({len(alloc)} replica(s) on {', '.join(slots) or '-'})"
        )
    else:
        print(
            f"  winning allocation: {len(alloc)} replica(s) on "
            f"{', '.join(slots) or '(none)'}"
        )
        if newest.get("pinned") and newest.get("cycle") != latest.get("cycle"):
            print(f"  (pinned unchanged through cycle {newest.get('cycle')})")
    mesh = latest.get("meshShape")
    if mesh:
        print(
            "  mesh shape: "
            f"sp={mesh.get('seqShards', 1)} "
            f"tp={mesh.get('modelShards', 1)} "
            f"pp={mesh.get('stageShards', 1)} "
            f"ep={mesh.get('expertShards', 1)} "
            f"micro={mesh.get('pipelineMicro', 1)}"
        )
    if latest.get("speedup") is not None:
        print(
            "  objective terms: "
            f"speedup={latest['speedup']:.4f} "
            f"(scaled {latest.get('scaledSpeedup', 0.0):.4f}), "
            f"restartPenalty={latest.get('restartPenalty', 0.0):.3f}"
            f"{' (moved)' if latest.get('moved') else ''}, "
            f"hazardLoss={latest.get('hazardLoss', 0.0):.4f}"
        )
    cycle = payload.get("cycle") or {}
    winner = cycle.get("winner")
    if winner:
        print(
            f"  cycle winner: objective {winner['objective']:.4f} "
            f"over {cycle.get('candidates', 0)} candidate(s), "
            f"{winner['nodes']} slice(s) active"
        )
    losers = cycle.get("losers") or []
    if losers:
        print("  losing candidates:")
        for loser in losers:
            print(
                f"    objective {loser['objective']:.4f} "
                f"({loser['nodes']} slice(s)) — killed by "
                f"{loser['killedBy']}"
            )
    history = payload.get("history") or []
    if len(history) > 1:
        print(
            f"  history: {len(history)} retained decision(s), "
            f"cycles {history[0].get('cycle')}..{history[-1].get('cycle')}"
        )


def _cmd_shardmap(args) -> int:
    """The sharded control plane's routing table: shard id → url from
    the router's rendezvous map, and (with ``--key``) where
    one ``namespace/name`` lands — the first question an operator
    asks when a tenant's traffic misbehaves."""
    payload = _get(args, "/shardmap", "cli/shardmap").json()
    print(f"shard map version {payload['version']}")
    rows = [("SHARD", "URL")]
    for sid, url in sorted(
        payload["shards"].items(), key=lambda kv: int(kv[0])
    ):
        rows.append((str(sid), url))
    _print_table(rows)
    if getattr(args, "key", None):
        from adaptdl_tpu_torch.sched.shard import ShardMap

        shard_map = ShardMap.from_payload(payload)
        print(f"\n{args.key} -> shard {shard_map.assign(args.key)}")
    return 0


def _cmd_reshard(args) -> int:
    """Live resharding from the command line. ``plan`` cuts a :class:`ReshardPlan`
    (the tenant moves a shard-set change implies) from the router's
    current map plus the merged inventory; ``apply`` executes a saved
    plan move by move — each tenant migration streams, fences,
    verifies, and flips its own map version with zero job restarts;
    ``status`` shows every shard's migration state: per-tenant
    watermark lag against the source journal head, fence remaining,
    and post-flip moved markers."""
    from adaptdl_tpu_torch import rpc
    from adaptdl_tpu_torch.sched import shard as shard_mod

    client = rpc.default_client()

    if args.action == "apply":
        if not args.plan or not args.map:
            print(
                "reshard apply requires --plan and --map",
                file=sys.stderr,
            )
            return 2
        shard_map = shard_mod.ShardMap.load(args.map)
        plan = shard_mod.ReshardPlan.load(args.plan)
        # A grow plan names shards the journaled map has never seen.
        # Mirror ShardedCluster.grow: publish a widened map FIRST,
        # with every moving tenant pinned to its current owner (and
        # any drain targets marked retiring), so the publish itself
        # changes no routing — the per-tenant flips do.
        needed = {m["from"] for m in plan.moves} | {
            m["to"] for m in plan.moves
        }
        urls = dict(shard_map.shards)
        for sid, url in plan.shards.items():
            urls.setdefault(sid, url)
        missing = sorted(needed - set(urls))
        if missing:
            print(
                f"reshard apply: plan names shard(s) {missing} absent "
                "from both the map and the plan's shard set",
                file=sys.stderr,
            )
            return 2
        retiring = tuple(set(shard_map.retiring) | set(plan.retiring))
        if urls != shard_map.shards or retiring != shard_map.retiring:
            overrides = dict(shard_map.overrides)
            for move in plan.moves:
                overrides[move["tenant"]] = move["from"]
            shard_map = shard_mod.ShardMap(
                urls,
                version=shard_map.version + 1,
                overrides=overrides,
                retiring=retiring,
            )
            shard_map.save(args.map)
            print(
                f"published widened map v{shard_map.version} "
                f"({len(urls)} shard(s), routing unchanged)"
            )
        print(
            f"applying {len(plan.moves)} move(s) "
            f"from map v{shard_map.version}"
        )
        for move in plan.moves:
            shard_map = shard_mod.migrate_tenant(
                shard_map,
                move["tenant"],
                move["from"],
                move["to"],
                map_path=args.map,
                client=client,
                fence_s=args.fence_s,
            )
            print(
                f"  {move['tenant']}: shard {move['from']} -> "
                f"{move['to']} (map v{shard_map.version})"
            )
        print(f"done: map v{shard_map.version}")
        return 0

    if not args.supervisor:
        print(
            f"reshard {args.action} requires --supervisor",
            file=sys.stderr,
        )
        return 2
    payload = _get(args, "/shardmap", "cli/reshard").json()
    shard_map = shard_mod.ShardMap.from_payload(payload)

    if args.action == "plan":
        new_shards = dict(shard_map.shards)
        for spec in args.add or ():
            sid, _, url = spec.partition("=")
            new_shards[int(sid)] = url
        plan = shard_mod.plan_reshard(
            shard_map,
            new_shards=new_shards,
            retiring=tuple(args.retire or ()),
            client=client,
        )
        print(
            f"reshard plan: map v{plan.from_version} -> "
            f"v{plan.version}, {len(plan.moves)} move(s)"
        )
        rows = [("TENANT", "FROM", "TO")]
        for move in plan.moves:
            rows.append(
                (move["tenant"], str(move["from"]), str(move["to"]))
            )
        _print_table(rows)
        if args.out:
            plan.save(args.out)
            print(f"\nwrote {args.out}")
        return 0

    # status: one fan-out over the map, then cross-shard watermark
    # lag (the epoch names the source shard, whose journal head is
    # the target the destination watermark chases).
    infos: dict[int, dict] = {}
    for sid in shard_map.shard_ids():
        infos[sid] = client.get(
            f"{shard_map.shards[sid]}/shard/reshard/status",
            endpoint="cli/reshard",
            timeout=10,
            attempts=3,
            deadline=30.0,
        ).json()
    print(f"shard map v{shard_map.version}")
    rows = [("SHARD", "SEQ", "TENANT", "STATE", "WATERMARK", "LAG", "DETAIL")]
    for sid in sorted(infos):
        info = infos[sid]
        seq = int(info.get("seq") or 0)
        busy = False
        for tenant, entry in sorted((info.get("pending") or {}).items()):
            busy = True
            epoch = str(entry.get("epoch") or "")
            lag = "-"
            # epoch format: "{tenant}:{from}->{to}@v{version}"
            try:
                src_sid = int(epoch.rsplit("@", 1)[0].rsplit(":", 1)[1].split("->")[0])
                lag = str(
                    max(int(infos[src_sid].get("seq") or 0)
                        - int(entry.get("watermark") or 0), 0)
                )
            except (KeyError, IndexError, ValueError):
                pass
            rows.append(
                (str(sid), str(seq), tenant, "pending",
                 str(entry.get("watermark")), lag,
                 f"jobs={entry.get('jobs')} "
                 f"skipped={entry.get('skipped')} epoch={epoch}")
            )
        for tenant, remaining in sorted((info.get("fenced") or {}).items()):
            busy = True
            rows.append(
                (str(sid), str(seq), tenant, "fenced", "-", "-",
                 f"remaining={float(remaining):.3f}s")
            )
        for tenant, marker in sorted((info.get("moved") or {}).items()):
            busy = True
            rows.append(
                (str(sid), str(seq), tenant, "moved", "-", "-",
                 f"-> shard {marker.get('shard')} "
                 f"@ map v{marker.get('version')}")
            )
        if not busy:
            rows.append((str(sid), str(seq), "-", "idle", "-", "-", "-"))
    _print_table(rows)
    return 0


def _cmd_explain(args) -> int:
    response = _get(args, f"/explain/{args.job}", "cli/explain")
    payload = response.json()
    if response.status_code == 404 or "latest" not in payload:
        print(
            payload.get("error", f"no explain record for {args.job}"),
            file=sys.stderr,
        )
        return 1
    _render_explain(args.job, payload)
    return 0


def _cmd_trace(args) -> int:
    """A job's stitched rescale trace: one trace (``--trace-id``, else
    the current decision's, else the newest; ``--all`` for every span)
    as a phase waterfall with per-phase medians, and optionally the
    Chrome/Perfetto ``trace_event`` file."""
    from adaptdl_tpu_torch import trace

    payload = _get(args, f"/trace/{args.job}", "cli/trace").json()
    spans = payload.get("spans") or []
    if not spans:
        print(f"no spans recorded for {args.job}", file=sys.stderr)
        return 1
    by_trace: dict[str, list] = {}
    for rec in spans:
        by_trace.setdefault(rec.get("trace", "?"), []).append(rec)
    if args.all:
        selected = spans
        trace_id = f"(all {len(by_trace)} traces)"
    else:
        if args.trace_id:
            trace_id = args.trace_id
            if trace_id not in by_trace:
                print(
                    f"trace {trace_id} not found; known: {sorted(by_trace)}",
                    file=sys.stderr,
                )
                return 1
        else:
            parsed = trace.parse_traceparent(payload.get("traceParent"))
            if parsed is not None and parsed[0] in by_trace:
                trace_id = parsed[0]
            else:
                trace_id = max(
                    by_trace,
                    key=lambda t: max(float(r.get("ts", 0.0)) for r in by_trace[t]),
                )
        selected = by_trace[trace_id]
    print(f"job {args.job}  trace {trace_id}  {len(selected)} span(s)")
    print(trace.render_waterfall(selected))
    summary = trace.phase_summary(selected)
    if summary:
        print("\nper-phase medians:")
        for name in sorted(summary):
            print(f"  {name:<28} {summary[name] * 1e3:>10.2f} ms")
    if args.perfetto:
        with open(args.perfetto, "w", encoding="utf-8") as f:
            json.dump(trace.to_perfetto(selected), f)
        print(
            f"\nwrote Perfetto trace_event JSON to {args.perfetto} "
            "(load in ui.perfetto.dev or chrome://tracing)"
        )
    return 0


def _cmd_hints(args) -> int:
    print(json.dumps(_get(args, f"/hints/{args.job}", "cli/hints").json(), indent=2))
    return 0


def _cmd_sim(args) -> int:
    """Replay a JSONL job-arrival trace through the REAL
    scheduler (PolluxPolicy + Allocator + ClusterState) under a
    virtual clock and render the summary table — or generate a trace
    (``--generate N``). A fixed ``--seed`` reproduces the summary
    bit-for-bit; ``--compare-fixed`` also runs the fixed-allocation
    baseline and prints the goodput-retention ratio."""
    from adaptdl_tpu_torch.sim import (
        generate_trace,
        load_trace,
        run_trace,
        write_trace,
    )

    if args.generate is not None:
        records = generate_trace(
            args.generate, args.duration, seed=args.seed
        )
        if args.out:
            write_trace(args.out, records)
            print(
                f"wrote {len(records)} arrivals to {args.out}",
                file=sys.stderr,
            )
        else:
            for record in records:
                print(json.dumps(record, sort_keys=True))
        return 0
    if not args.trace:
        print(
            "sim: a TRACE file is required (or --generate N)",
            file=sys.stderr,
        )
        return 2
    records = load_trace(args.trace)
    kwargs = dict(
        slices=args.slices,
        chips_per_slice=args.chips_per_slice,
        seed=args.seed,
        interval=args.interval,
        spot_fraction=args.spot_fraction,
        reclaims_per_slot_hour=args.reclaims_per_slot_hour,
    )
    report = run_trace(
        records, fixed=args.fixed, dp_only=args.dp_only, **kwargs
    )
    print(report.render())
    payload = {
        "summary": report.summary(),
        "latency": report.latency(),
        # The watch store's deterministic per-tenant fairness and drift
        # summary (tenant = workload category).
        "watch": report.watch_summary(),
    }
    if args.compare_fixed and not args.fixed:
        baseline = run_trace(records, fixed=True, **kwargs)
        retention = report.summary()["avg_goodput_x_ideal"] / max(
            baseline.summary()["avg_goodput_x_ideal"], 1e-9
        )
        payload["fixed_baseline"] = baseline.summary()
        payload["goodput_retention_vs_fixed"] = round(retention, 4)
        print(
            f"\ngoodput retention vs fixed allocation: "
            f"{retention:.4f} (>= 1.0 means the adaptive policy "
            "wins)"
        )
    if args.compare_dp_only and not args.fixed and not args.dp_only:
        baseline = run_trace(records, dp_only=True, **kwargs)
        retention = report.summary()["avg_goodput_x_ideal"] / max(
            baseline.summary()["avg_goodput_x_ideal"], 1e-9
        )
        payload["dp_only_baseline"] = baseline.summary()
        payload["goodput_retention_vs_dp_only"] = round(retention, 4)
        print(
            f"\ngoodput retention vs the dp-only policy: "
            f"{retention:.4f} (>= 1.0 means mesh-shape search wins "
            "on this trace)"
        )
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump(payload, f, sort_keys=True, indent=2)
        print(f"\nwrote report JSON to {args.json}", file=sys.stderr)
    return 0


def _cmd_check(args) -> int:
    """The repo's graftcheck analyzer (``tools/graftcheck``); its exit
    codes: 0 clean beyond the committed baseline, 1 new findings, 2
    usage."""
    try:
        from tools.graftcheck.__main__ import main as graftcheck_main
    except ImportError:
        print(
            "check needs the graftcheck analyzer (tools/graftcheck) on "
            "PYTHONPATH: run from a source checkout of the repo",
            file=sys.stderr,
        )
        return 2
    # graftcheck resolves its contracts, baseline and cache from the
    # working directory: anchor it at the checkout this package is in.
    import adaptdl_tpu_torch

    repo_root = os.path.dirname(
        os.path.dirname(os.path.abspath(adaptdl_tpu_torch.__file__))
    )
    if os.getcwd() != repo_root and os.path.isdir(
        os.path.join(repo_root, "tools", "graftcheck")
    ):
        args.paths = [
            os.path.abspath(p) if os.path.exists(p) else p for p in args.paths
        ]
        for attr in ("baseline", "docs_dir"):
            value = getattr(args, attr)
            if value:
                setattr(args, attr, os.path.abspath(value))
        os.chdir(repo_root)
    argv = list(args.paths)
    if args.fast:
        argv.append("--fast")
    if args.format != "text":
        argv.extend(["--format", args.format])
    if args.rules:
        argv.extend(["--rules", args.rules])
    if args.docs_dir:
        argv.extend(["--docs-dir", args.docs_dir])
    if args.baseline:
        argv.extend(["--baseline", args.baseline])
    if args.write_baseline:
        argv.append("--write-baseline")
    if args.list_rules:
        argv.append("--list-rules")
    if args.quiet:
        argv.append("--quiet")
    return graftcheck_main(argv)


def _cmd_logs(args) -> int:
    cmd = ["tail"]
    if args.follow:
        cmd.append("-f")
    cmd.extend(["-n", str(args.lines), args.log_file])
    return subprocess.call(cmd)


def _cmd_cp(args) -> int:
    if os.path.isdir(args.src):
        shutil.copytree(args.src, args.dst, dirs_exist_ok=True)
    else:
        shutil.copy2(args.src, args.dst)
    return 0


def _cmd_tensorboard(args) -> int:
    if shutil.which("tensorboard") is None:
        print("tensorboard is not installed in this environment", file=sys.stderr)
        return 1
    return subprocess.call(
        ["tensorboard", "--logdir", args.logdir, "--port", str(args.port)]
    )


def _parser() -> argparse.ArgumentParser:
    epilog = "not ported yet (ROADMAP Queue 1):\n" + "\n".join(
        f"  {verb:<48} {item}" for verb, item in NOT_PORTED
    )
    parser = argparse.ArgumentParser(
        prog="adaptdl-tpu-torch",
        epilog=epilog,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser(
        "submit",
        help="run a training script elastically on this machine's cards",
    )
    p.add_argument("script", help="the script; its own arguments follow --")
    p.add_argument("--name")
    p.add_argument(
        "--chips", type=int, default=None,
        help="slots of this machine (default: the visible cards)",
    )
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--min-replicas", type=int, default=0)
    p.add_argument("--max-replicas", type=int, default=None)
    p.add_argument("--log-file")
    p.set_defaults(fn=_cmd_submit)

    p = sub.add_parser("ls", help="list jobs: a live supervisor's /metrics")
    p.add_argument("--supervisor", required=True)
    p.set_defaults(fn=_cmd_ls)

    p = sub.add_parser(
        "status",
        help="a live supervisor's jobs: phase, degraded flag, allocation "
        "epoch and state, lease ages, slot strikes and quarantine, "
        "recoveries",
    )
    p.add_argument("--supervisor", required=True)
    p.set_defaults(fn=_cmd_status)

    p = sub.add_parser(
        "top",
        help="the cluster view: per-tenant goodput share and fairness, "
        "per-job measured against predicted goodput with drift flags, "
        "straggler-suspect slots",
    )
    p.add_argument("--supervisor", required=True)
    p.add_argument(
        "--watch", type=float, default=0.0, metavar="SECONDS",
        help="re-render every SECONDS until interrupted (default: once)",
    )
    p.set_defaults(fn=_cmd_top)

    p = sub.add_parser(
        "explain",
        help="one job's decision provenance: the winning allocation and "
        "mesh shape with its objective terms, and the losing candidates",
    )
    p.add_argument("job", help="namespace/name")
    p.add_argument("--supervisor", required=True)
    p.set_defaults(fn=_cmd_explain)

    p = sub.add_parser(
        "trace",
        help="a job's stitched rescale trace (phase waterfall and "
        "per-phase medians; --perfetto writes the trace_event file)",
    )
    p.add_argument("job", help="namespace/name")
    p.add_argument("--supervisor", required=True)
    p.add_argument(
        "--trace-id", default=None,
        help="this trace id (default: the current decision's, else the newest)",
    )
    p.add_argument(
        "--perfetto", default=None, metavar="FILE",
        help="also write the selected spans as Chrome/Perfetto JSON",
    )
    p.add_argument(
        "--all", action="store_true",
        help="every stored span, not one trace",
    )
    p.set_defaults(fn=_cmd_trace)

    p = sub.add_parser("hints", help="a job's posted sched hints")
    p.add_argument("job", help="namespace/name")
    p.add_argument("--supervisor", required=True)
    p.set_defaults(fn=_cmd_hints)

    p = sub.add_parser("logs", help="tail a local job's log file")
    p.add_argument("--log-file", required=True)
    p.add_argument("-f", "--follow", action="store_true")
    p.add_argument("-n", "--lines", type=int, default=50)
    p.set_defaults(fn=_cmd_logs)

    p = sub.add_parser(
        "cp", help="copy a local checkpoint file or directory out"
    )
    p.add_argument("src")
    p.add_argument("dst")
    p.set_defaults(fn=_cmd_cp)

    p = sub.add_parser("tensorboard", help="run tensorboard on a local logdir")
    p.add_argument("--logdir", required=True)
    p.add_argument("--port", type=int, default=6006)
    p.set_defaults(fn=_cmd_tensorboard)

    p = sub.add_parser(
        "shardmap",
        help="the sharded control plane's routing table: shard id -> url "
        "from the router's rendezvous map",
    )
    p.add_argument(
        "--supervisor", required=True,
        help="router (or shard-map-serving supervisor) base URL",
    )
    p.add_argument(
        "--key", help="a namespace/name job key to resolve to its shard",
    )
    p.set_defaults(fn=_cmd_shardmap)

    p = sub.add_parser(
        "reshard",
        help="live resharding: plan tenant moves for a shard-set change, "
        "apply them with zero job restarts, or show per-tenant migration "
        "status (watermark lag, fences, moved markers)",
    )
    p.add_argument(
        "action", choices=("plan", "apply", "status"),
        help="plan: cut a ReshardPlan from the current map and the merged "
        "inventory; apply: execute a saved plan (stream, fence, verify, "
        "flip: one map bump per tenant); status: each shard's migration "
        "state",
    )
    p.add_argument("--supervisor", help="router base URL (plan/status)")
    p.add_argument(
        "--retire", action="append", type=int, metavar="SHARD",
        help="shard id to drain out of the rendezvous (plan; repeatable)",
    )
    p.add_argument(
        "--add", action="append", metavar="SID=URL",
        help="shard to add to the target set (plan; repeatable)",
    )
    p.add_argument("--out", help="write the computed plan here (plan)")
    p.add_argument("--plan", help="plan file to execute (apply)")
    p.add_argument(
        "--map", help="shard-map path the flips are published to (apply)",
    )
    p.add_argument(
        "--fence-s", type=float, default=None, dest="fence_s",
        help="per-tenant write-fence budget in seconds (apply; default "
        "ADAPTDL_RESHARD_FENCE_S)",
    )
    p.set_defaults(fn=_cmd_reshard)

    p = sub.add_parser(
        "sim",
        help="replay a job-arrival trace through the real scheduler under "
        "a virtual clock (or --generate a trace); a fixed seed gives a "
        "bit-identical summary",
    )
    p.add_argument("trace", nargs="?", default=None, help="JSONL arrival trace")
    p.add_argument("--slices", type=int, default=16)
    p.add_argument("--chips-per-slice", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--interval", type=float, default=60.0,
        help="virtual seconds between allocator cycles",
    )
    p.add_argument(
        "--fixed", action="store_true",
        help="score the fixed-allocation baseline instead of Pollux",
    )
    p.add_argument(
        "--compare-fixed", action="store_true",
        help="also run the fixed baseline and print the goodput-retention "
        "ratio",
    )
    p.add_argument(
        "--dp-only", action="store_true",
        help="strip mesh-shape hints so the policy runs its replica-only "
        "search",
    )
    p.add_argument(
        "--compare-dp-only", action="store_true",
        help="also run the dp-only policy and print the goodput-retention "
        "ratio mesh-shape search buys on this trace",
    )
    p.add_argument(
        "--spot-fraction", type=float, default=0.0,
        help="fraction of slices that are preemptible",
    )
    p.add_argument(
        "--reclaims-per-slot-hour", type=float, default=0.0,
        help="Poisson reclaim-notice rate per spot slice (0 = off)",
    )
    p.add_argument(
        "--generate", type=int, default=None, metavar="N",
        help="generate an N-job trace instead of simulating",
    )
    p.add_argument(
        "--duration", type=float, default=3600.0,
        help="arrival span (virtual seconds) for --generate",
    )
    p.add_argument("-o", "--out", default=None, help="trace output file")
    p.add_argument("--json", default=None, help="write summary+latency JSON here")
    p.set_defaults(fn=_cmd_sim)

    p = sub.add_parser(
        "check",
        help="run the graftcheck static analyzer; exit 0 clean, 1 new "
        "findings, 2 usage error",
    )
    p.add_argument(
        "paths", nargs="*", default=["adaptdl_tpu_torch"],
        help="files or directories to analyze (default: adaptdl_tpu_torch)",
    )
    p.add_argument(
        "--fast", action="store_true",
        help="reuse cached results for unchanged files",
    )
    p.add_argument("--format", choices=("text", "json", "sarif"), default="text")
    p.add_argument(
        "--rules", default=None,
        help="comma-separated rule-id prefixes (e.g. GC10,GC1101)",
    )
    p.add_argument("--baseline", default=None)
    p.add_argument("--docs-dir", default=None)
    p.add_argument("--write-baseline", action="store_true")
    p.add_argument("--list-rules", action="store_true")
    p.add_argument("-q", "--quiet", action="store_true")
    p.set_defaults(fn=_cmd_check)
    return parser


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    script_args: list[str] = []
    if "--" in argv:
        cut = argv.index("--")
        argv, script_args = argv[:cut], argv[cut + 1:]
    args = _parser().parse_args(argv)
    args.script_args = script_args
    from adaptdl_tpu_torch.sched.validator import ValidationError

    try:
        return args.fn(args)
    except ValidationError as exc:
        print(f"invalid job spec: {exc}", file=sys.stderr)
        return 2
    except BrokenPipeError:
        # stdout went away (piped into `head`): not an error.
        return 0


if __name__ == "__main__":
    sys.exit(main())
