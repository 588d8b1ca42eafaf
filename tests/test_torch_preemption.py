"""Preemption survival in the port, against the JAX package's
``sched.preemption``.

- Notice, urgent drain, exit 143: the 2-layer LM of
  tests/torch_rescale_worker.py trains in a fresh interpreter under the
  JAX supervisor with the listener on (``ADAPTDL_PREEMPT_POLL_S``) and
  ``preempt.notice=fail@1`` (the first poll is a notice, so no poll
  reaches a metadata server). It drains and
  exits 143 with a complete checkpoint inside its deadline; the
  supervisor marks the job draining under the notice's trace context;
  the journal holds the ``drain.save`` span and no
  ``drain.deadline_exceeded``.
- The drain joins a periodic write in flight, in both packages.
- ``/preempt`` reaches the JAX supervisor from the port's client.
- The listener backs off after unreachable polls and comes back after a
  reachable one, on an injected clock (no sleeps), at the intervals the
  JAX package's ``_next_interval`` gives.
- A poll reads a metadata server (here a local one) as the JAX package's
  does: TRUE is a notice, anything else is not, nothing listening is
  unreachable.

Every thread and process a test starts is joined with a timeout.
"""

import json
import os
import subprocess
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import pytest

from adaptdl_tpu import _signal as jax_signal
from adaptdl_tpu import checkpoint as jax_checkpoint
from adaptdl_tpu import metrics as jax_metrics
from adaptdl_tpu import rpc as jax_rpc
from adaptdl_tpu import trace as jax_trace
from adaptdl_tpu.sched import preemption as jax_preemption
from adaptdl_tpu.sched.state import ClusterState
from adaptdl_tpu.sched.supervisor import Supervisor
from adaptdl_tpu_torch import (
    _signal,
    checkpoint,
    faults,
    metrics,
    rpc,
    trace,
)
from adaptdl_tpu_torch.sched import preemption
from tests.torch_support import private_tempdir  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
WORKER = str(REPO / "tests" / "torch_rescale_worker.py")
RUN_TIMEOUT_S = 180
JOB = "test/preempt"
GATE_TIMEOUT_S = 30


def _reset():
    for reset in (
        checkpoint._reset_registry, jax_checkpoint._reset_registry,
        metrics._reset_state, jax_metrics._reset_state, faults.reset,
        rpc.reset_default_client, jax_rpc.reset_default_client,
        preemption.reset_notice, jax_preemption.reset_notice,
        trace._reset_state, jax_trace._reset_state,
    ):
        reset()
    preemption.stop_listener()
    jax_preemption.stop_listener()
    _signal.set_exit_flag(False)
    jax_signal.set_exit_flag(False)  # the JAX notice raises its own flag


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    for name in ("ADAPTDL_CHECKPOINT_PATH", "ADAPTDL_SUPERVISOR_URL",
                 "ADAPTDL_JOB_ID", "ADAPTDL_PREEMPT_POLL_S",
                 "ADAPTDL_FAULT_SPEC", "ADAPTDL_TRACE_DIR"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(metrics, "_maybe_fit", lambda: None)
    monkeypatch.setattr(jax_metrics, "_maybe_fit_and_report", lambda *a, **k: None)
    _reset()
    yield
    _reset()


@pytest.fixture
def supervisor():
    state = ClusterState()
    state.create_job(JOB, spec={"max_replicas": 8})
    sup = Supervisor(state, lease_ttl=30.0)
    url = sup.start()
    yield state, url
    sup.stop()


def test_notice_drains_and_exits_143(tmp_path, supervisor):
    state, url = supervisor
    run_env = {k: v for k, v in os.environ.items() if not k.startswith("ADAPTDL_")}
    run_env.update(
        PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
        ADAPTDL_CHECKPOINT_PATH=str(tmp_path / "ckpt"),
        ADAPTDL_SUPERVISOR_URL=url, ADAPTDL_JOB_ID=JOB,
        ADAPTDL_HEARTBEAT_INTERVAL="0", ADAPTDL_CKPT_EVERY_STEPS="2",
        ADAPTDL_PREEMPT_POLL_S="0.2", ADAPTDL_PREEMPT_BACKOFF_AFTER="10000",
        ADAPTDL_PREEMPT_NOTICE_S="30", ADAPTDL_PREEMPT_MARGIN_S="5",
        ADAPTDL_FAULT_SPEC="preempt.notice=fail@1",
        ADAPTDL_TRACE_DIR=str(tmp_path / "trace"),
    )
    proc = subprocess.run(
        [sys.executable, WORKER, str(tmp_path), "--steps", "100000"],
        cwd=REPO, env=run_env, capture_output=True, text=True,
        timeout=RUN_TIMEOUT_S,
    )
    assert proc.returncode == 143, proc.stderr
    report = json.loads((tmp_path / "report-0.json").read_text())
    notice = report["notice"]
    assert notice["source"] == "metadata" and notice["budgetS"] == 25.0
    newest = checkpoint.latest_checkpoint_dir(str(tmp_path / "ckpt"))
    assert os.path.isfile(os.path.join(newest, "manifest.json"))
    record = state.get_job(JOB)
    assert record.draining
    assert record.trace_parent == notice["traceParent"]
    records = trace.read_journal(str(tmp_path / "trace" / "trace-test-preempt.jsonl"))
    names = [r["name"] for r in records]
    assert "preempt.notice" in names and "drain.save" in names
    assert "drain.deadline_exceeded" not in names
    (drain,) = [r for r in records if r["name"] == "drain.save"]
    assert drain["dur"] <= notice["budgetS"]
    assert drain["trace"] == trace.parse_traceparent(notice["traceParent"])[0]


def _gated_blob(module, gate):
    class Blob(module.State):
        def save(self, fileobj):
            fileobj.write(b"v")

        def load(self, fileobj):
            fileobj.read()

        def write_snapshot(self, snapshot, fileobj):
            assert gate.wait(GATE_TIMEOUT_S), "gate never opened"
            fileobj.write(snapshot)

    return Blob("blob")


@pytest.mark.parametrize(
    "ckpt_mod, module", [(checkpoint, preemption), (jax_checkpoint, jax_preemption)],
    ids=["port", "jax"],
)
def test_the_drain_joins_an_inflight_write(tmp_path, monkeypatch, ckpt_mod, module):
    monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(tmp_path))
    gate = threading.Event()
    _gated_blob(ckpt_mod, gate)
    ckpt_mod.save_all_states(wait=False)
    assert module.deliver_notice(source="test", notice_s=20.0, notify=False)
    assert not module.deliver_notice(source="again", notify=False)
    opener = threading.Timer(0.2, gate.set)
    opener.start()
    try:
        summary = module.urgent_drain()
    finally:
        gate.set()
        opener.join(GATE_TIMEOUT_S)
    assert summary["joinedInflight"] is True
    assert summary["deadlineMet"] is True
    assert summary["durationS"] >= 0.1  # it waited for the gated write
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("checkpoint-"))
    assert dirs == ["checkpoint-0.1"]  # the drain's save, newest
    assert module.notice_state()["drained"]


def test_the_notice_reaches_the_jax_supervisor(supervisor, monkeypatch):
    state, url = supervisor
    monkeypatch.setenv("ADAPTDL_SUPERVISOR_URL", url)
    monkeypatch.setenv("ADAPTDL_JOB_ID", JOB)
    assert preemption.deliver_notice(source="test", notice_s=30.0, notify=False)
    assert preemption.notify_supervisor()
    assert preemption.notice_state()["reported"]
    record = state.get_job(JOB)
    assert record.draining
    assert record.trace_parent == preemption.notice_state()["traceParent"]


def test_listener_backs_off_on_an_injected_clock(monkeypatch):
    """Unreachable polls past the threshold move to the slow cadence, a
    reachable poll restores the base one, and a notice ends the loop."""
    base, slow, after = 5.0, 60.0, 3
    polls = iter(
        [preemption.POLL_UNREACHABLE] * 5
        + [preemption.POLL_OK]
        + [preemption.POLL_UNREACHABLE] * 4
        + [preemption.POLL_PREEMPTED]
    )
    waits, delivered = [], []
    monkeypatch.setattr(
        preemption, "deliver_notice", lambda **kw: delivered.append(kw)
    )

    def wait(seconds):
        waits.append(seconds)
        return False  # never stopped: the clock only records

    jitter = iter([0.0, 0.25, 0.5, 0.75, 0.99] * 3)
    assert preemption.listen(
        lambda: next(polls), wait, base, slow, after, lambda: next(jitter)
    )
    assert delivered == [{"source": "metadata"}]
    streaks = [1, 2, 3, 4, 5, 0, 1, 2, 3, 4]
    jitters = [0.0, 0.25, 0.5, 0.75, 0.99] * 2
    want = [
        jax_preemption._next_interval(s, base, slow, after, j)
        for s, j in zip(streaks, jitters)
    ]
    assert waits == pytest.approx(want, rel=0, abs=0)
    assert waits[2] >= 0.8 * slow and waits[5] <= 1.2 * base

    # A stop ends the loop without a notice.
    stopped = preemption.listen(
        lambda: preemption.POLL_OK, lambda s: True, base, slow, after
    )
    assert stopped is False


def test_the_listener_thread_stops_and_joins(monkeypatch):
    monkeypatch.setenv("ADAPTDL_PREEMPT_POLL_S", "0.01")
    monkeypatch.setattr(preemption, "poll_status", lambda *a, **k: preemption.POLL_OK)
    stop = preemption.ensure_listener()
    assert stop is not None and preemption.ensure_listener() is stop
    preemption.stop_listener()
    assert stop.is_set() and not preemption._listener_thread.is_alive()
    assert not preemption.notice_active()


class _Metadata(BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802
        body = self.server.answer.encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


@pytest.mark.parametrize("module", [preemption, jax_preemption], ids=["port", "jax"])
def test_poll_status_reads_a_local_metadata_server(module):
    server = ThreadingHTTPServer(("127.0.0.1", 0), _Metadata)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/preempted"
    try:
        server.answer = "TRUE"
        assert module.poll_status(url) == module.POLL_PREEMPTED
        assert module.poll_once(url)
        server.answer = "FALSE"
        assert module.poll_status(url) == module.POLL_OK
        assert not module.poll_once(url)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(10)
    # Nothing listens there any more.
    assert module.poll_status(url, timeout=1.0) == module.POLL_UNREACHABLE
