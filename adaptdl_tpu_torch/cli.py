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
    ("shardmap", "item 5, sched/shard"),
    ("reshard", "item 5, sched/shard"),
    ("sim", "item 4, sim"),
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
