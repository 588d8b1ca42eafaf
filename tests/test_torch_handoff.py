"""Peer-to-peer handoff in the port: the stopping incarnation's shard
server serves its successor, against the JAX package's handoff.

- The 2-layer LM of tests/torch_rescale_worker.py trains 6 steps in a
  fresh interpreter with ``ADAPTDL_HANDOFF=on`` and a save every 2 steps,
  raises its exit flag, saves, spawns the shard-server child and exits
  143. The successor (another interpreter, restarts 1) restores every
  state from the peer; its trainer digest equals what the stopping
  incarnation held and what a storage restore of the same checkpoint
  gives here; the child exits on the successor's ``/done``.
- A successor of two ranks (``adaptdl_tpu_torch.launch``) restores
  every state on both ranks from the one peer, and the child exits once
  both ranks have posted ``/done``.
- A ``handoff.fetch`` fault and a corrupted chunk each fall back to
  storage, bit-equal. So does a ``meta`` chunk that is not the JSON the
  trainer writes (a pickle that would run code, an unknown dtype), even
  where the server's own sha256 table vouches for it: nothing from the
  peer is executed.
- The child exits on its TTL, and withdraws its descriptor, never a
  later server's.
- Advertisement and discovery go through the JAX supervisor: the child
  PUTs ``/handoff/{job}``, the successor finds it there, and a server
  of an older incarnation is not trusted.
- The wire format is the JAX package's: the port's client restores a
  byte state from the JAX shard server, and the JAX client from the
  port's, bit for bit.

Every process a test starts is waited for with a timeout.
"""

import json
import os
import pickle
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from adaptdl_tpu import checkpoint as jax_checkpoint
from adaptdl_tpu import handoff as jax_handoff
from adaptdl_tpu import rpc as jax_rpc
from adaptdl_tpu.sched.state import ClusterState
from adaptdl_tpu.sched.supervisor import Supervisor
from adaptdl_tpu_torch import (
    _signal,
    checkpoint,
    epoch,
    faults,
    handoff,
    metrics,
    rpc,
)
from tests import torch_rescale_worker as worker
from tests.torch_support import private_tempdir  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
WORKER = str(REPO / "tests" / "torch_rescale_worker.py")
RUN_TIMEOUT_S = 180
JOB = "test/handoff"
JOB_ENV = (
    "ADAPTDL_CHECKPOINT_PATH", "ADAPTDL_HANDOFF", "ADAPTDL_NUM_RESTARTS",
    "ADAPTDL_SUPERVISOR_URL", "ADAPTDL_JOB_ID", "ADAPTDL_HANDOFF_TTL_S",
    "ADAPTDL_HANDOFF_URL", "ADAPTDL_FAULT_SPEC", "ADAPTDL_POD_IP",
)


def _reset():
    for reset in (
        checkpoint._reset_registry, jax_checkpoint._reset_registry,
        metrics._reset_state, epoch._reset_state, faults.reset,
        rpc.reset_default_client, jax_rpc.reset_default_client,
    ):
        reset()
    _signal.set_exit_flag(False)


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    for name in JOB_ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(metrics, "_maybe_fit", lambda: None)
    _reset()
    yield
    _reset()


def _run(out, restarts, extra=(), launcher=(), **env):
    run_env = {k: v for k, v in os.environ.items() if not k.startswith("ADAPTDL_")}
    run_env.update(
        PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", ADAPTDL_HANDOFF="on",
        ADAPTDL_CHECKPOINT_PATH=str(out / "ckpt"),
        ADAPTDL_NUM_RESTARTS=str(restarts), **env,
    )
    # Its own session, so a run past its timeout goes down with its ranks.
    proc = subprocess.Popen(
        [sys.executable, *launcher, WORKER, str(out), *extra], cwd=REPO,
        env=run_env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True,
    )
    try:
        stdout, stderr = proc.communicate(timeout=RUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"{proc.args} timed out")
    report = json.loads((out / f"report-{restarts}.json").read_text())
    return subprocess.CompletedProcess(proc.args, proc.returncode, stdout, stderr), report


def _wait_gone(pid, timeout=RUN_TIMEOUT_S):
    """Wait for a process that is not this one's child to exit."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return True
        with open(f"/proc/{pid}/stat") as f:
            if f.read().split(")")[-1].split()[0] == "Z":
                return True
        time.sleep(0.05)
    return False


def _storage_digest(ckpt_root, monkeypatch):
    """The trainer digest a storage restore of the newest checkpoint
    gives, in this process, with the handoff off."""
    monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(ckpt_root))
    monkeypatch.delenv("ADAPTDL_HANDOFF", raising=False)
    checkpoint._reset_registry()
    _trainer, holder, ckpt = worker.build(seed=9)
    assert checkpoint.load_state(ckpt)
    assert checkpoint._loaded_from[ckpt.name] != checkpoint.HANDOFF_SOURCE
    return worker.digest(holder["state"])


@pytest.fixture(scope="module")
def planned_rescale(tmp_path_factory):
    """Incarnation 0 stops after 5 steps with the handoff on; the
    successor restores from its shard server."""
    out = tmp_path_factory.mktemp("rescale")
    first, before = _run(
        out, 0, ["--steps", "20", "--stop-after", "5"],
        ADAPTDL_CKPT_EVERY_STEPS="2",
    )
    descriptor = json.loads((out / "ckpt" / handoff.DESCRIPTOR_NAME).read_text())
    second, after = _run(out, 1, ["--steps", "2"])
    gone = _wait_gone(descriptor["pid"])
    return {
        "out": out, "codes": (first.returncode, second.returncode),
        "logs": first.stderr + second.stderr, "before": before,
        "after": after, "descriptor": descriptor, "gone": gone,
    }


def test_successor_restores_every_state_from_the_peer(planned_rescale, monkeypatch):
    run = planned_rescale
    assert run["codes"] == (143, 0), run["logs"]
    assert run["descriptor"]["group"] == 0
    after = run["after"]
    assert set(after["loaded_from"].values()) == {checkpoint.HANDOFF_SOURCE}
    assert {"elastic_trainer", "adaptdl_metrics", "adaptdl_dataloader"} < set(
        after["loaded_from"]
    )
    assert after["handoff"]["bytes"] > 0
    assert after["restart_stats"]["handoffBytes"] == after["handoff"]["bytes"]
    # Bit-equal to what the stopping incarnation held and to storage.
    assert after["digest"] == run["before"]["digest_now"]
    assert after["digest"] == _storage_digest(run["out"] / "ckpt", monkeypatch)
    assert len(after["losses"]) == 2


def test_the_child_exits_on_done_and_withdraws_its_descriptor(planned_rescale):
    assert planned_rescale["gone"]
    assert not (planned_rescale["out"] / "ckpt" / handoff.DESCRIPTOR_NAME).exists()


def test_a_two_rank_successor_restores_every_rank_from_the_peer(tmp_path):
    """Incarnation 0 (one replica) stops with the handoff on; the
    successor runs two ranks under the launcher. Every state of both
    ranks comes from the peer, bit-equal, and the child waits for both
    ranks' ``/done`` before it exits."""
    first, before = _run(
        tmp_path, 0, ["--steps", "20", "--stop-after", "3"],
        ADAPTDL_CKPT_EVERY_STEPS="2",
    )
    assert first.returncode == 143, first.stderr
    descriptor = json.loads(
        (tmp_path / "ckpt" / handoff.DESCRIPTOR_NAME).read_text()
    )
    second, rank0 = _run(
        tmp_path, 1, ["--steps", "1"],
        launcher=("-m", "adaptdl_tpu_torch.launch"), ADAPTDL_NUM_REPLICAS="2",
    )
    assert second.returncode == 0, second.stderr
    rank1 = json.loads((tmp_path / "report-1-rank1.json").read_text())
    for report in (rank0, rank1):
        assert set(report["loaded_from"].values()) == {checkpoint.HANDOFF_SOURCE}
        assert {"elastic_trainer", "adaptdl_dataloader"} < set(report["loaded_from"])
        assert report["digest"] == before["digest_now"]
        assert report["handoff"]["bytes"] > 0
    assert _wait_gone(descriptor["pid"])


def test_the_server_is_done_once_every_successor_rank_is():
    server = handoff.HandoffServer({}, group=0)
    try:
        for rank in (1, 1):
            server.handle("POST", "/done", json.dumps({"rank": rank, "replicas": 3}).encode())
        assert not server.done.is_set()
        server.handle("POST", "/done", b'{"rank": 0, "replicas": 3}')
        assert not server.done.is_set()
        server.handle("POST", "/done", b'{"rank": 2, "replicas": 3}')
        assert server.done.is_set()
        # A post that names no rank (the JAX client's) ends it at once.
        bare = handoff.HandoffServer({}, group=0)
        try:
            bare.handle("POST", "/done")
            assert bare.done.is_set()
        finally:
            bare._httpd.server_close()
    finally:
        server._httpd.server_close()


class _Blob(checkpoint.State):
    def __init__(self, name, value):
        super().__init__(name)
        self.value = value

    def save(self, fileobj):
        fileobj.write(self.value)

    def load(self, fileobj):
        self.value = fileobj.read()


def _serve_trainer(tmp_path, monkeypatch):
    """A saved trainer state and an in-process shard server holding it;
    returns the server and the saved digest."""
    monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(tmp_path))
    trainer, holder, ckpt = worker.build(seed=4)
    _Blob("blob", b"payload")
    checkpoint.save_all_states()
    server = handoff.serve_states(group=0)
    return server, worker.digest(holder["state"])


@pytest.mark.parametrize("fault", ["fetch_fault", "corrupt_chunk"])
def test_a_failed_fetch_falls_back_to_storage(tmp_path, monkeypatch, fault):
    server, want = _serve_trainer(tmp_path, monkeypatch)
    try:
        if fault == "fetch_fault":
            faults.configure("handoff.fetch=fail@2")
        else:
            entry = server._payload["elastic_trainer"]
            cid = entry["order"][3]
            data = entry["chunks"][cid]
            entry["chunks"][cid] = bytes([data[0] ^ 0xFF]) + data[1:]
        checkpoint._reset_registry()
        handoff.set_source(server.url)
        _trainer, holder, ckpt = worker.build(seed=8)
        assert checkpoint.load_state(ckpt)
        assert checkpoint._loaded_from[ckpt.name] != checkpoint.HANDOFF_SOURCE
        assert worker.digest(holder["state"]) == want
        # The failure made the peer unavailable for every later state.
        blob = _Blob("blob", b"")
        assert checkpoint.load_state(blob) and blob.value == b"payload"
        assert checkpoint._loaded_from["blob"] != checkpoint.HANDOFF_SOURCE
    finally:
        server.stop()


class _Planted:
    """What a pickle made by a hostile peer would do on loading."""

    def __init__(self, path):
        self.path = path

    def __reduce__(self):
        return (open, (self.path, "w"))


@pytest.mark.parametrize("meta", ["pickle", "unknown_dtype"])
def test_a_hostile_meta_chunk_falls_back_to_storage(tmp_path, monkeypatch, meta):
    server, want = _serve_trainer(tmp_path, monkeypatch)
    planted = tmp_path / "planted"
    try:
        entry = server._payload["elastic_trainer"]
        if meta == "pickle":
            entry["chunks"]["meta"] = pickle.dumps(_Planted(str(planted)))
        else:
            doc = json.loads(entry["chunks"]["meta"])
            doc["dict"][0][1]["dict"][0][1]["tensor"][1] = "load"
            entry["chunks"]["meta"] = json.dumps(doc).encode()
        # The server vouches for its own bytes: the sha256 check passes.
        entry["sha"]["meta"] = handoff.chunk_sha(entry["chunks"]["meta"])
        checkpoint._reset_registry()
        handoff.set_source(server.url)
        _trainer, holder, ckpt = worker.build(seed=8)
        assert checkpoint.load_state(ckpt)
        assert checkpoint._loaded_from[ckpt.name] != checkpoint.HANDOFF_SOURCE
        assert worker.digest(holder["state"]) == want
        assert not planted.exists()
    finally:
        server.stop()


def test_in_process_restore_from_the_peer_is_bit_equal(tmp_path, monkeypatch):
    server, want = _serve_trainer(tmp_path, monkeypatch)
    try:
        checkpoint._reset_registry()
        handoff.set_source(server.url)
        _trainer, holder, ckpt = worker.build(seed=8)
        blob = _Blob("blob", b"")
        assert checkpoint.load_state(ckpt) and checkpoint.load_state(blob)
        assert checkpoint._loaded_from == {
            "elastic_trainer": checkpoint.HANDOFF_SOURCE,
            "blob": checkpoint.HANDOFF_SOURCE,
        }
        assert worker.digest(holder["state"]) == want and blob.value == b"payload"
        assert server.done.is_set()  # every state fetched: /done
    finally:
        server.stop()


def _spawn(tmp_path, monkeypatch, **env):
    monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(tmp_path))
    monkeypatch.setenv("ADAPTDL_HANDOFF", "on")
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    _Blob("blob", b"payload")
    handle = checkpoint.save_all_states(retain_snapshots=True)
    return handoff.spawn_server(snapshots=handle.snapshots)


def _wait_descriptor(root):
    path = Path(root) / handoff.DESCRIPTOR_NAME
    deadline = time.monotonic() + 60
    while not path.exists() and time.monotonic() < deadline:
        time.sleep(0.05)
    return json.loads(path.read_text())


def test_the_child_exits_on_its_ttl(tmp_path, monkeypatch):
    proc = _spawn(tmp_path, monkeypatch, ADAPTDL_HANDOFF_TTL_S="1")
    try:
        assert _wait_descriptor(tmp_path)["pid"] == proc.pid
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert not (tmp_path / handoff.DESCRIPTOR_NAME).exists()


def test_a_server_withdraws_only_its_own_descriptor(tmp_path, monkeypatch):
    """An older server winding down leaves a newer one's descriptor."""
    monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(tmp_path))
    path = tmp_path / handoff.DESCRIPTOR_NAME
    for pid, kept in ((os.getpid() + 1, True), (os.getpid(), False)):
        path.write_text(json.dumps({"url": "http://x", "group": 1, "pid": pid}))
        handoff._withdraw_descriptor()
        assert path.exists() == kept


def test_advertisement_and_discovery_through_the_jax_supervisor(tmp_path, monkeypatch):
    state = ClusterState()
    state.create_job(JOB, spec={"max_replicas": 8})
    sup = Supervisor(state, lease_ttl=30.0)
    url = sup.start()
    proc = None
    try:
        proc = _spawn(
            tmp_path, monkeypatch, ADAPTDL_SUPERVISOR_URL=url,
            ADAPTDL_JOB_ID=JOB, ADAPTDL_POD_IP="127.0.0.1",
        )
        descriptor = _wait_descriptor(tmp_path)
        deadline = time.monotonic() + 30
        while state.get_handoff(JOB) is None and time.monotonic() < deadline:
            time.sleep(0.05)
        assert state.get_handoff(JOB) == {"url": descriptor["url"], "group": 0}
        # The successor finds the peer through the supervisor alone.
        os.remove(tmp_path / handoff.DESCRIPTOR_NAME)
        monkeypatch.setenv("ADAPTDL_NUM_RESTARTS", "1")
        assert handoff.discover_url() == descriptor["url"]
        # Two restarts later the advertised server is stale.
        monkeypatch.setenv("ADAPTDL_NUM_RESTARTS", "2")
        assert handoff.discover_url() is None
        monkeypatch.setenv("ADAPTDL_NUM_RESTARTS", "1")
        checkpoint._reset_registry()
        blob = _Blob("blob", b"")
        assert checkpoint.load_state(blob) and blob.value == b"payload"
        assert checkpoint._loaded_from["blob"] == checkpoint.HANDOFF_SOURCE
        assert proc.wait(timeout=60) == 0  # /done after the last state
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        sup.stop()


class _JaxBlob(jax_checkpoint.State):
    def __init__(self, name, value):
        super().__init__(name)
        self.value = value

    def save(self, fileobj):
        fileobj.write(self.value)

    def load(self, fileobj):
        self.value = fileobj.read()


def test_the_wire_format_is_the_jax_packages(tmp_path, monkeypatch):
    monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(tmp_path))
    value = os.urandom(1 << 16)
    # The port's client from the JAX shard server.
    _JaxBlob("blob", value)
    jax_server = jax_handoff.serve_states(group=0)
    try:
        handoff.set_source(jax_server.url)
        got = _Blob("blob", b"")
        assert handoff.try_restore(got) and got.value == value
    finally:
        jax_server.stop()
        jax_checkpoint._reset_registry()
    # The JAX client from the port's shard server.
    checkpoint._reset_registry()
    _Blob("blob", value)
    server = handoff.serve_states(group=0)
    try:
        jax_handoff.set_source(server.url)
        got = _JaxBlob("blob", b"")
        assert jax_handoff.try_restore(got) and got.value == value
    finally:
        server.stop()
        jax_checkpoint._reset_registry()
