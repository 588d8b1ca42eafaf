"""The port's CLI (``python -m adaptdl_tpu_torch.cli``) against the JAX
package's.

- The ``status``, ``top``, ``explain`` and ``trace`` renderers print the
  same stdout in both packages for the same payloads (each verb's HTTP
  fetch answered by a stub client): a status payload that reaches every
  section, the watch snapshot and explain records of a port cluster after
  three allocator cycles, and span records of two incarnations.
- The verbs against a live port supervisor, each as its own
  ``python -m adaptdl_tpu_torch.cli`` process: ``ls`` (the Prometheus
  exposition), ``hints``, ``status``, ``top``, ``explain`` and ``trace
  --perfetto`` (one trace id across both incarnations in the file).
- ``logs --log-file``, the local ``cp`` of a file and of a checkpoint
  directory, ``submit`` of the CPU linear regression to completion at
  ``--chips 1``, and ``submit`` refusing with no card and no ``--chips``.
- ``--help`` lists the ported verbs and names each waiting verb with its
  ROADMAP item.
"""

import argparse
import json
import os
import subprocess
import sys
import urllib.request
from pathlib import Path

import pytest

from adaptdl_tpu import cli as jax_cli
from adaptdl_tpu import rpc as jax_rpc
from adaptdl_tpu_torch import cli
from adaptdl_tpu_torch import rpc as port_rpc
from adaptdl_tpu_torch import trace
from adaptdl_tpu_torch.sched.allocator import Allocator
from adaptdl_tpu_torch.sched.policy import NodeInfo, PolluxPolicy
from adaptdl_tpu_torch.sched.state import ClusterState
from adaptdl_tpu_torch.sched.supervisor import Supervisor
from tests.test_torch_watch import HINTS
from tests.torch_support import one_torch_thread, private_tempdir  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
JOB = "team/lm"

STATUS_PAYLOAD = {
    "jobs": {
        "team/lm": {
            "status": "Running", "replicas": 2, "degraded": False,
            "draining": True, "drainRemainingS": 12.7, "allocEpoch": 3,
            "allocState": "committed", "restarts": 2,
            "leaseAgeS": {"0": 0.4, "1": 1.9, "10": 3.2},
        },
        "team/b": {"status": "Pending", "replicas": 0, "degraded": True},
    },
    "drainingSlots": {"spot-0": 12.7},
    "hazardRates": {"spot": 0.0002, "od": 0.0},
    "incidentsByKind": {"nan_loss": 3, "loss_spike": 1},
    "incidentSlotBlame": {"s0": ["d1", "d2"], "s1": ["d3"]},
    "incidentDataBlame": {"d9": ["s0", "s1"]},
    "quarantinedSlots": {"s0": 40.5},
    "slotStrikes": {"s0": 3, "s2": 1},
    "recovery": {"recoveries": 2, "lastRecoveryS": 0.0123, "tornRecords": 1},
    "shards": {"1": {"jobs": 3, "recovery": {"recoveries": 1}},
               "0": {"jobs": 2, "error": "connection refused"}},
}


class _Reply:
    def __init__(self, payload, status=200):
        self._payload = payload
        self.status_code = status
        self.text = json.dumps(payload)

    def json(self):
        return self._payload


class _StubClient:
    def __init__(self, routes):
        self.routes = routes

    def get(self, url, **kwargs):
        for suffix, reply in self.routes.items():
            if url.endswith(suffix):
                return reply
        raise AssertionError(url)


def _spans(trace_id, job=JOB):
    """Two incarnations' spans under one trace id, and one span of an
    older trace."""
    records = []
    for i, (name, inc, dur) in enumerate((
        ("ckpt.snapshot", 0, 0.12), ("ckpt.write", 0, 1.5),
        ("ckpt.restore", 1, 0.8), ("restart.first_step", 1, 2.25),
    )):
        records.append({
            "name": name, "trace": trace_id, "span": "%016x" % (i + 1),
            "parent": "0" * 15 + "1", "ts": 1700000000.0 + i, "dur": dur,
            "attrs": {"job": job}, "pid": 300 + inc, "tid": "MainThread",
            "inc": inc,
        })
    records.append({
        "name": "epoch.prepare", "kind": "event", "trace": "f" * 32,
        "span": "e" * 16, "parent": "0" * 15 + "1", "ts": 1690000000.0,
        "dur": 0.0, "attrs": {}, "pid": 1, "tid": "sup", "inc": 0,
    })
    return records


@pytest.fixture(scope="module")
def cluster():
    """A port cluster after three allocator cycles, with hints, beats and
    two incarnations' spans posted over HTTP; yields (url, the job's
    trace id, the /watch, /explain and /trace payloads)."""
    state = ClusterState()
    state.create_job(JOB, spec={"max_replicas": 4, "requested": 4})
    state.create_job("team/b", spec={"max_replicas": 2})
    for key in (JOB, "team/b"):
        state.update(key, status="Running", hints=dict(HINTS))
    supervisor = Supervisor(state, lease_ttl=0.0)
    url = supervisor.start()
    allocator = Allocator(
        state, {f"slice-{i}": NodeInfo(resources={"tpu": 4}) for i in range(2)},
        policy=PolluxPolicy(pop_size=8, generations=4), interval=1000.0,
    )
    client = port_rpc.RpcClient()
    try:
        allocator.optimize_once()
        for step in range(2):
            client.put(f"{url}/hints/{JOB}", json=dict(HINTS, measuredGoodput=90.0 + step))
            for rank, ewma in enumerate((0.1, 0.1, 0.35)):
                client.put(f"{url}/heartbeat/{JOB}/{rank}", json={"stepTimeEwma": ewma})
            allocator.optimize_once()
        trace_id = trace.parse_traceparent(state.get_job(JOB).trace_parent)[0]
        client.put(f"{url}/trace/{JOB}", json={"spans": _spans(trace_id)}).raise_for_status()
        payloads = {
            route: json.load(urllib.request.urlopen(url + route))
            for route in ("/watch", f"/explain/{JOB}", f"/trace/{JOB}")
        }
        yield url, trace_id, payloads
    finally:
        allocator.stop()
        supervisor.stop()


def _both(monkeypatch, capsys, tmp_path, verb, args, routes):
    """Run ``verb`` of each package's CLI on the stubbed fetch; returns
    (rc, stdout, stderr, the Perfetto file's JSON or None) for the JAX
    package, then for the port."""
    outs = []
    for name, module, rpc in (("jax", jax_cli, jax_rpc), ("port", cli, port_rpc)):
        monkeypatch.setattr(rpc, "default_client", lambda: _StubClient(routes))
        ns = argparse.Namespace(supervisor="http://stub", **args)
        if getattr(ns, "perfetto", None):
            ns.perfetto = str(tmp_path / f"{name}.json")
        rc = getattr(module, f"_cmd_{verb}")(ns)
        out, err = capsys.readouterr()
        written = None
        if getattr(ns, "perfetto", None):
            out = out.replace(ns.perfetto, "FILE")
            if Path(ns.perfetto).exists():
                written = json.loads(Path(ns.perfetto).read_text())
        outs.append((rc, out, err, written))
    return outs


def test_status_renders_like_jax(monkeypatch, capsys, tmp_path):
    (jrc, jout, jerr, _), (prc, pout, perr, _) = _both(
        monkeypatch, capsys, tmp_path, "status", {}, {"/status": _Reply(STATUS_PAYLOAD)}
    )
    assert prc == jrc == 0
    assert pout == jout
    for text in ("DRAIN", "12s left", "reclaim hazard", "numeric incidents",
                 "incident blame (slot", "incident blame (data", "QUARANTINED",
                 "supervisor recoveries: 2", "DOWN: connection refused"):
        assert text in pout, text


def test_top_renders_like_jax(monkeypatch, capsys, tmp_path, cluster):
    _, _, payloads = cluster
    (jrc, jout, _, _), (prc, pout, _, _) = _both(
        monkeypatch, capsys, tmp_path, "top", {"watch": 0.0},
        {"/watch": _Reply(payloads["/watch"])},
    )
    assert prc == jrc == 0
    assert pout == jout
    assert "TENANT" in pout and JOB in pout and "suspect slots" in pout


@pytest.mark.parametrize("which", ["live", "pinned", "missing"])
def test_explain_renders_like_jax(monkeypatch, capsys, tmp_path, cluster, which):
    _, _, payloads = cluster
    payload = dict(payloads[f"/explain/{JOB}"])
    reply = _Reply(payload)
    if which == "pinned":
        # The newest record a pinned keep after the last real decision.
        payload["latest"] = dict(payload["lastDecision"], pinned=True, cycle=9)
    elif which == "missing":
        reply = _Reply({"error": "no such job"}, status=404)
    (jrc, jout, jerr, _), (prc, pout, perr, _) = _both(
        monkeypatch, capsys, tmp_path, "explain", {"job": JOB},
        {f"/explain/{JOB}": reply},
    )
    assert (prc, pout, perr) == (jrc, jout, jerr)
    if which == "missing":
        assert prc == 1 and "no such job" in perr
    else:
        assert "winning allocation" in pout and "objective terms" in pout


@pytest.mark.parametrize(
    "options",
    [{}, {"all": True}, {"trace_id": "f" * 32}, {"trace_id": "0" * 32}],
    ids=["current", "all", "older", "unknown"],
)
def test_trace_renders_like_jax(monkeypatch, capsys, tmp_path, cluster, options):
    _, _, payloads = cluster
    args = {"job": JOB, "all": False, "trace_id": None, "perfetto": "set"}
    args.update(options)
    (jrc, jout, jerr, jfile), (prc, pout, perr, pfile) = _both(
        monkeypatch, capsys, tmp_path, "trace", args,
        {f"/trace/{JOB}": _Reply(payloads[f"/trace/{JOB}"])},
    )
    if options.get("trace_id") == "0" * 32:
        assert prc == jrc == 1 and perr == jerr
        assert pfile is None and jfile is None
        return
    assert prc == jrc == 0
    assert pout == jout
    assert pfile == jfile


def _cli(*argv, timeout=60, **kwargs):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run(
        [sys.executable, "-m", "adaptdl_tpu_torch.cli", *argv], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=timeout, **kwargs,
    )


def test_read_verbs_against_a_live_supervisor(cluster, tmp_path):
    from tests import promcheck

    url, trace_id, _ = cluster
    ls = _cli("ls", "--supervisor", url)
    assert ls.returncode == 0, ls.stderr
    families = promcheck.validate_exposition(ls.stdout)["families"]
    assert families["adaptdl_goodput_drift"]["samples"] or families[
        "adaptdl_goodput_measured"]["samples"]
    hints = _cli("hints", JOB, "--supervisor", url)
    assert hints.returncode == 0 and json.loads(hints.stdout)["measuredGoodput"] == 91.0
    status = _cli("status", "--supervisor", url)
    assert status.returncode == 0 and JOB in status.stdout
    top = _cli("top", "--supervisor", url)
    assert top.returncode == 0 and "suspect slots" in top.stdout
    explain = _cli("explain", JOB, "--supervisor", url)
    assert explain.returncode == 0 and "winning allocation" in explain.stdout
    assert _cli("explain", "team/none", "--supervisor", url).returncode == 1
    out = tmp_path / "trace.json"
    traced = _cli("trace", JOB, "--supervisor", url, "--perfetto", str(out))
    assert traced.returncode == 0, traced.stderr
    assert f"trace {trace_id}" in traced.stdout
    events = json.loads(out.read_text())["traceEvents"]
    ids = {e["args"]["trace_id"] for e in events if e["ph"] in ("X", "i")}
    assert ids == {trace_id}
    # Both incarnations, beside the supervisor process's own decision spans.
    assert {300, 301} <= {e["pid"] for e in events if e["ph"] == "X"}


def test_logs_and_cp(tmp_path, capfd):
    log = tmp_path / "job.log"
    log.write_text("".join(f"line {i}\n" for i in range(60)))
    assert cli.main(["logs", "--log-file", str(log), "-n", "3"]) == 0
    assert capfd.readouterr().out == "line 57\nline 58\nline 59\n"
    ckpt = tmp_path / "ckpt" / "checkpoint-3.0"
    ckpt.mkdir(parents=True)
    (ckpt / "model").write_bytes(b"\x00\x01weights")
    (ckpt / "manifest.json").write_text("{}")
    assert cli.main(["cp", str(ckpt), str(tmp_path / "out")]) == 0
    assert (tmp_path / "out" / "model").read_bytes() == b"\x00\x01weights"
    assert cli.main(["cp", str(ckpt / "model"), str(tmp_path / "one.bin")]) == 0
    assert (tmp_path / "one.bin").read_bytes() == b"\x00\x01weights"


def test_submit_runs_linear_regression_to_completion(tmp_path):
    log = tmp_path / "submit.log"
    proc = _cli(
        "submit", "adaptdl_tpu_torch/examples/linear_regression.py", "--chips", "1",
        "--checkpoint-dir", str(tmp_path / "ckpt"), "--name", "cli/lr",
        "--log-file", str(log), "--", "--cpu", "--epochs", "2", timeout=240,
    )
    text = log.read_text()
    assert proc.returncode == 0, proc.stderr + text
    assert "epoch 1: loss=" in text and "w:" in text


def test_submit_refuses_without_a_card(tmp_path, capsys):
    rc = cli.main([
        "submit", "adaptdl_tpu_torch/examples/linear_regression.py",
        "--checkpoint-dir", str(tmp_path / "ckpt"), "--", "--cpu",
    ])
    assert rc == 2
    assert "no CUDA card visible" in capsys.readouterr().err
    assert not (tmp_path / "ckpt").exists()


def test_help_lists_ported_and_waiting_verbs():
    proc = _cli("--help")
    assert proc.returncode == 0
    for verb in ("submit", "ls", "status", "top", "explain", "trace", "hints",
                 "logs", "cp", "tensorboard", "check"):
        assert verb in proc.stdout
    epilog = proc.stdout.split("not ported yet")[1]
    for verb, item in cli.NOT_PORTED:
        assert verb in epilog and item in epilog
    for verb in ("deploy", "shardmap", "reshard", "sim"):
        assert _cli(verb).returncode == 2
