"""The port's rescale tracing, against the JAX package's ``trace``.

- Traceparent format and parse agree with ``adaptdl_tpu.trace`` on ids
  drawn from a seed, and on malformed headers.
- Spans nest per thread, pin to an explicit context, flag errors; the
  journal the port writes reads back through the JAX reader, and
  ``phase_summary`` equals the JAX package's on the same records.
- The rpc client sends the current ``traceparent`` header; ``/config``'s
  ``traceParent`` becomes the process's context.
- Two incarnations of the 2-layer LM (tests/torch_rescale_worker.py)
  under the JAX supervisor: the first adopts the decision's trace from
  ``/config``, trains with a save every 2 steps and stops (exit 143);
  the successor inherits ``ADAPTDL_TRACEPARENT``, restores and trains.
  Their spans (``ckpt.snapshot``, ``ckpt.write``, ``ckpt.restore``,
  ``restart.first_step``, ``rpc.request``) reach ``/trace/{job}`` under
  one trace id, and ``python -m adaptdl_tpu.cli trace`` renders it.
"""

import json
import os
import random
import subprocess
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import pytest

from adaptdl_tpu import trace as jax_trace
from adaptdl_tpu.sched.state import ClusterState
from adaptdl_tpu.sched.supervisor import Supervisor
from adaptdl_tpu_torch import rpc, sched_hints, trace
from tests.torch_support import private_tempdir  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
WORKER = str(REPO / "tests" / "torch_rescale_worker.py")
RUN_TIMEOUT_S = 180
JOB = "test/traced"


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    for name in ("ADAPTDL_TRACEPARENT", "ADAPTDL_TRACE_DIR", "ADAPTDL_JOB_ID",
                 "ADAPTDL_SUPERVISOR_URL"):
        monkeypatch.delenv(name, raising=False)
    trace._reset_state()
    jax_trace._reset_state()
    rpc.reset_default_client()
    yield
    trace._reset_state()
    jax_trace._reset_state()
    rpc.reset_default_client()


MALFORMED = [
    None, "", "garbage", "00-abc-def-01", "00-" + "0" * 32 + "-" + "1" * 16 + "-01",
    "00-" + "1" * 32 + "-" + "0" * 16 + "-01", "00-" + "g" * 32 + "-" + "1" * 16 + "-01",
    "000-" + "1" * 32 + "-" + "1" * 16 + "-01",
    "00-" + "1" * 32 + "-" + "1" * 16, " 00-" + "a" * 32 + "-" + "b" * 16 + "-01 ",
]


def test_traceparent_format_and_parse_agree_with_jax():
    rng = random.Random(0)
    for _ in range(200):
        trace_id = "%032x" % rng.getrandbits(128)
        span_id = "%016x" % rng.getrandbits(64)
        header = trace.format_traceparent(trace_id, span_id)
        assert header == jax_trace.format_traceparent(trace_id, span_id)
        assert trace.parse_traceparent(header) == jax_trace.parse_traceparent(header)
    for header in MALFORMED:
        assert trace.parse_traceparent(header) == jax_trace.parse_traceparent(header)
    fresh = trace.new_traceparent()
    assert jax_trace.parse_traceparent(fresh) is not None


def test_spans_nest_pin_and_journal_like_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("ADAPTDL_TRACE_DIR", str(tmp_path))
    monkeypatch.setenv("ADAPTDL_JOB_ID", "ns/job")
    root = trace.new_traceparent()
    monkeypatch.setenv("ADAPTDL_TRACEPARENT", root)
    with trace.span("outer", k=1) as attrs:
        attrs["hit"] = True
        with trace.span("inner"):
            pass
        trace.event("point")
    pinned = trace.new_traceparent()
    with trace.span("pinned", traceparent=pinned):
        pass
    with pytest.raises(ValueError):
        with trace.span("failing"):
            raise ValueError
    trace.begin_pending("restart.first_step")
    assert trace.end_pending("restart.first_step", atomic_bsz=4)
    assert not trace.end_pending("restart.first_step")
    records = jax_trace.read_journal(str(tmp_path / "trace-ns-job.jsonl"))
    assert records == trace.read_journal(trace.journal_path())
    by_name = {r["name"]: r for r in records}
    root_id, root_span = trace.parse_traceparent(root)
    assert by_name["outer"]["parent"] == root_span
    assert by_name["inner"]["parent"] == by_name["outer"]["span"]
    assert by_name["point"]["kind"] == "event"
    assert by_name["outer"]["attrs"] == {"k": 1, "hit": True}
    assert by_name["pinned"]["trace"] == trace.parse_traceparent(pinned)[0]
    assert by_name["failing"]["attrs"]["error"] is True
    assert by_name["restart.first_step"]["attrs"] == {"atomic_bsz": 4}
    assert {r["trace"] for r in records if r["name"] != "pinned"} == {root_id}
    assert trace.phase_summary(records) == jax_trace.phase_summary(records)
    rng = random.Random(1)
    synthetic = [
        {"name": f"p{rng.randrange(3)}", "dur": rng.random()} for _ in range(50)
    ]
    assert trace.phase_summary(synthetic) == jax_trace.phase_summary(synthetic)


class _Echo(BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802
        body = json.dumps({
            "traceparent": self.headers.get("traceparent"),
            "traceParent": self.server.config_tp,
        }).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


def test_rpc_sends_the_context_and_config_adopts_the_decisions(monkeypatch):
    server = ThreadingHTTPServer(("127.0.0.1", 0), _Echo)
    server.config_tp = trace.new_traceparent()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with trace.span("caller"):
            sent = rpc.default_client().get(f"{url}/x").json()["traceparent"]
        (caller,) = [r for r in trace.snapshot_spans() if r["name"] == "caller"]
        (request,) = [r for r in trace.snapshot_spans() if r["name"] == "rpc.request"]
        assert trace.parse_traceparent(sent) == (caller["trace"], request["span"])
        monkeypatch.setenv("ADAPTDL_SUPERVISOR_URL", url)
        monkeypatch.setenv("ADAPTDL_JOB_ID", "ns/job")
        assert sched_hints.fetch_job_config() is not None
        assert trace.current_traceparent() == server.config_tp
    finally:
        server.shutdown()
        server.server_close()
        thread.join(10)


def _run(out, restarts, url, extra, **env):
    run_env = {k: v for k, v in os.environ.items() if not k.startswith("ADAPTDL_")}
    run_env.update(
        PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
        ADAPTDL_CHECKPOINT_PATH=str(out / "ckpt"),
        ADAPTDL_TRACE_DIR=str(out / "trace"), ADAPTDL_SUPERVISOR_URL=url,
        ADAPTDL_JOB_ID=JOB, ADAPTDL_HEARTBEAT_INTERVAL="0.2",
        ADAPTDL_FIT_INTERVAL="0.2", ADAPTDL_NUM_RESTARTS=str(restarts), **env,
    )
    return subprocess.run(
        [sys.executable, WORKER, str(out), *extra], cwd=REPO, env=run_env,
        capture_output=True, text=True, timeout=RUN_TIMEOUT_S,
    )


def test_two_incarnations_render_one_trace_id(tmp_path):
    state = ClusterState()
    state.create_job(JOB, spec={"max_replicas": 8})
    decision = jax_trace.new_traceparent()
    state.update(JOB, allocation=["slot-0"], trace_parent=decision)
    trace_id = jax_trace.parse_traceparent(decision)[0]
    sup = Supervisor(state, lease_ttl=30.0)
    url = sup.start()
    try:
        first = _run(tmp_path, 0, url, ["--steps", "20", "--stop-after", "4"],
                     ADAPTDL_CKPT_EVERY_STEPS="2")
        assert first.returncode == 143, first.stderr
        second = _run(tmp_path, 1, url, ["--steps", "3"],
                      ADAPTDL_TRACEPARENT=decision)
        assert second.returncode == 0, second.stderr
        cli = subprocess.run(
            [sys.executable, "-m", "adaptdl_tpu.cli", "trace", JOB,
             "--supervisor", url],
            cwd=REPO, env={**os.environ, "JAX_PLATFORMS": "cpu"},
            capture_output=True, text=True, timeout=RUN_TIMEOUT_S,
        )
        spans = jax_trace_spans(url)
    finally:
        sup.stop()
    assert cli.returncode == 0, cli.stderr
    assert f"trace {trace_id}" in cli.stdout
    worker = [r for r in spans if "inc" in r and r.get("pid") is not None]
    by_inc = {}
    for rec in worker:
        by_inc.setdefault(rec["inc"], set()).add(rec["name"])
    assert {"ckpt.snapshot", "ckpt.write", "rpc.request"} <= by_inc[0]
    assert {"ckpt.restore", "restart.first_step"} <= by_inc[1]
    # Everything after the first /config adoption is in the one trace.
    phases = {"ckpt.snapshot", "ckpt.write", "ckpt.restore", "restart.first_step"}
    assert {r["trace"] for r in worker if r["name"] in phases} == {trace_id}
    journal = trace.read_journal(str(tmp_path / "trace" / "trace-test-traced.jsonl"))
    assert {r["inc"] for r in journal} == {0, 1}
    assert {r["trace"] for r in journal if r["name"] in phases} == {trace_id}
    assert {"ckpt.restore", "ckpt.write"} <= set(trace.phase_summary(journal))


def jax_trace_spans(url):
    from adaptdl_tpu import rpc as jax_rpc

    return jax_rpc.default_client().get(f"{url}/trace/{JOB}").json()["spans"]
