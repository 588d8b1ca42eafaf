"""The port's durable cluster state held to the JAX package's.

The port's ``ClusterState(state_dir=...)`` journals every mutation to the
JAX package's write-ahead journal and snapshot (``sched/journal.py``) and
recovers from them. Covered here, each case on both states:

- the files are the JAX package's byte for byte (one fake clock each), and
  a journal or snapshot either package wrote, the other recovers to equal
  snapshot payloads;
- the JAX package's own recovery cases (``tests/test_chaos_sched.py``):
  rotation bounds the journal, a torn tail recovers the acknowledged
  prefix and later appends survive the next recovery, a crash between
  snapshot and truncation replays nothing twice, a corrupt snapshot
  raises, the journal fault point blocks the mutation, group commit
  batches fsyncs and keeps order (a killed process loses nothing), the
  reconciliation window holds off expiry until reattach, and a candidate
  from a rolled-back epoch stays cleared across recovery;
- the warm successor's liveness sequence: the incumbent's drain traffic
  never commits the epoch replacing it, the successor's does;
- the port's supervisor restarted on the same ``state_dir`` lets live
  workers reattach in the same group, a worker loop whose supervisor is
  killed between rescales ends with the weights of an undisturbed run,
  and a restarted runner drops recovered jobs it does not run.

Histories written for a payload comparison run on a fake clock, so
their wall stamps agree; recovery seconds are not compared. Every
subprocess has its own timeout.
"""

import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from adaptdl_tpu import faults as jax_faults
from adaptdl_tpu.sched import journal as jax_journal
from adaptdl_tpu.sched import state as jax_state
from adaptdl_tpu_torch import checkpoint, faults, rpc, sched_hints
from adaptdl_tpu_torch.launch import pick_unused_port
from adaptdl_tpu_torch.sched import journal as port_journal
from adaptdl_tpu_torch.sched import state as port_state
from adaptdl_tpu_torch.sched.multi_runner import JobSpec, MultiJobRunner
from adaptdl_tpu_torch.sched.supervisor import Supervisor
from tests.torch_support import private_tempdir  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 1234
MODULES = {"jax": jax_state, "port": port_state}
JOURNALS = {"jax": jax_journal, "port": port_journal}
SUBPROCESS_TIMEOUT_S = 120


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    jax_faults.reset()
    rpc.reset_default_client()
    yield
    faults.reset()
    jax_faults.reset()
    rpc.reset_default_client()


class FakeClock:
    def __init__(self):
        self.mono = 1000.0
        self.wall = 1.7e9

    def monotonic(self):
        return self.mono

    def time(self):
        return self.wall


def _state(impl, path, **kwargs):
    kwargs.setdefault("alloc_commit_timeout", 0.3)
    kwargs.setdefault("slot_strike_limit", 2)
    kwargs.setdefault("slot_quarantine_s", 60.0)
    kwargs.setdefault("reconcile_window", 0.5)
    return MODULES[impl].ClusterState(state_dir=str(path), **kwargs)


def _payload(state):
    """The state's snapshot payload, in its JSON form."""
    with state._cond:
        return json.loads(json.dumps(state._snapshot_payload_locked()))


def _both(tmp_path, scenario):
    """Run ``scenario(impl, dir)`` for both states; assert equal results
    and return the port's."""
    out = {
        impl: scenario(impl, tmp_path / impl) for impl in ("jax", "port")
    }
    assert out["port"] == out["jax"]
    return out["port"]


def _busy_history(st, fake_clock=None):
    """A call sequence touching every journaled op kind."""
    st.create_job("ns/a", spec={"max_replicas": 8})
    st.update(
        "ns/a", allocation=["s0"] * 2, topology={"seqShards": 2},
        status="Running", hints={"initBatchSize": 64},
        batch_config={"atomicBsz": 16, "accumSteps": 0},
    )
    st.register_worker("ns/a", 0, 0, "10.0.0.1", processes=2)
    st.register_worker("ns/a", 0, 1, "10.0.0.2", processes=2)
    st.renew_lease("ns/a", 0, 30.0, group=0)
    st.renew_lease("ns/a", 1, 30.0, group=0)
    st.publish_retune("ns/a", {"atomicBsz": 32, "accumSteps": 1})
    st.advertise_handoff("ns/a", "http://h:1", 0)
    st.publish_candidate("ns/a", ["s0", "s1"], topology=None)
    st.update("ns/a", allocation=["s0", "s1"])
    st.report_preemption("ns/a", group=0, slot="s1", notice_s=30.0)
    st.report_incident("ns/a", "nan_loss", group=0, rank=0, step=5, data="d1")
    st.create_job("ns/b", spec={})
    st.update("ns/b", allocation=["bad"], status="Running")
    if fake_clock is not None:
        fake_clock.mono += 1.0
    st.expire_overdue_allocations(
        now=None if fake_clock else time.monotonic() + 1.0
    )
    st.create_job("ns/c")
    st.update("ns/c", status="Succeeded")
    st.remove_job("ns/c")


# ---- the files ------------------------------------------------------------


def test_the_journal_and_snapshot_are_the_jax_packages_byte_for_byte(tmp_path):
    files = {}
    for impl in ("jax", "port"):
        clock = FakeClock()
        st = _state(impl, tmp_path / impl, clock=clock, snapshot_every=9)
        _busy_history(st, fake_clock=clock)
        files[impl] = {
            name: (tmp_path / impl / name).read_bytes()
            for name in ("journal.jsonl", "snapshot.json")
        }
    assert files["port"]["snapshot.json"], "the history rotated once"
    assert files["port"] == files["jax"]


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
@pytest.mark.parametrize("snapshot_every", [1000, 7])
def test_either_package_recovers_what_the_other_wrote(
    tmp_path, writer, reader, snapshot_every
):
    """Recovered across the packages, a history reaches the snapshot
    payload the reader reaches recovering its own writing of it (the
    writers on one fake clock each, so their wall stamps agree)."""
    for impl, where in ((writer, "cross"), (reader, "own")):
        clock = FakeClock()
        _busy_history(
            _state(impl, tmp_path / where, snapshot_every=snapshot_every,
                   clock=clock),
            fake_clock=clock,
        )
    if snapshot_every == 7:
        assert (tmp_path / "cross" / "snapshot.json").is_file()
    cross = _state(reader, tmp_path / "cross", snapshot_every=snapshot_every)
    got = _payload(cross)
    assert got == _payload(
        _state(reader, tmp_path / "own", snapshot_every=snapshot_every)
    )
    assert sorted(got["jobs"]) == ["ns/a", "ns/b"]
    assert got["rollbacks"] == {"ns/a": 1, "ns/b": 1}
    assert got["recoveries"] == 1
    assert cross.recovery_info()["recoveries"] == 1


# ---- the JAX package's recovery cases ----------------------------------------


def test_recovery_restores_jobs_allocations_leases_retunes(tmp_path):
    def scenario(impl, path):
        st = _state(impl, path)
        st.create_job("ns/a", spec={"max_replicas": 8})
        st.update(
            "ns/a", allocation=["slice-0"] * 2, topology={"seqShards": 2},
            status="Running", hints={"initBatchSize": 64},
        )
        st.renew_lease("ns/a", 0, 30.0, group=0)  # commits the epoch
        assert st.publish_retune("ns/a", {"atomicBsz": 32, "accumSteps": 1})
        st.create_job("ns/b")
        st.update("ns/b", status="Succeeded")
        rec = _state(impl, path)
        a = rec.get_job("ns/a")
        metrics = rec.lifecycle_metrics()
        info = rec.recovery_info()
        return {
            "allocation": a.allocation, "topology": a.topology,
            "status": a.status, "hints": a.hints,
            "batch_config": a.batch_config, "retunes": a.retunes,
            "alloc_state": a.alloc_state,
            "committed": a.committed_allocation, "leases": sorted(a.leases),
            "b": rec.get_job("ns/b").status,
            "submitted": metrics["submitted_total"],
            "succeeded": metrics["completions"]["Succeeded"][0],
            "recoveries": info["recoveries"], "torn": info["tornRecords"],
        }

    assert _both(tmp_path, scenario) == {
        "allocation": ["slice-0"] * 2, "topology": {"seqShards": 2},
        "status": "Running", "hints": {"initBatchSize": 64},
        "batch_config": {"atomicBsz": 32, "accumSteps": 1}, "retunes": 1,
        "alloc_state": "committed", "committed": ["slice-0"] * 2,
        "leases": [0], "b": "Succeeded", "submitted": 2, "succeeded": 1,
        "recoveries": 1, "torn": 0,
    }


def test_snapshot_rotation_bounds_the_journal(tmp_path):
    def scenario(impl, path):
        st = _state(impl, path, snapshot_every=10)
        st.create_job("ns/a")
        for i in range(40):
            st.update("ns/a", hints={"initBatchSize": i})
        lines = (path / "journal.jsonl").read_text().splitlines()
        rec = _state(impl, path, snapshot_every=10)
        return {
            "snapshot": (path / "snapshot.json").is_file(),
            "bounded": len(lines) <= 10,
            "hints": rec.get_job("ns/a").hints,
            "submitted": rec.lifecycle_metrics()["submitted_total"],
        }

    assert _both(tmp_path, scenario) == {
        "snapshot": True, "bounded": True, "hints": {"initBatchSize": 39},
        "submitted": 1,
    }


def test_a_torn_tail_recovers_the_acknowledged_prefix(tmp_path):
    def scenario(impl, path):
        st = _state(impl, path)
        st.create_job("ns/a")
        st.update("ns/a", allocation=["s0"], status="Running")
        st.update("ns/a", hints={"initBatchSize": 8})
        with open(path / "journal.jsonl", "a", encoding="utf-8") as f:
            f.write('{"op": "update", "key": "ns/a", "fi')  # torn write
        rec = _state(impl, path)
        record = rec.get_job("ns/a")
        return (record.allocation, record.hints,
                rec.recovery_info()["tornRecords"])

    assert _both(tmp_path, scenario) == (["s0"], {"initBatchSize": 8}, 1)


def test_appends_after_a_torn_recovery_survive_the_next(tmp_path):
    def scenario(impl, path):
        st = _state(impl, path)
        st.create_job("ns/a")
        with open(path / "journal.jsonl", "a", encoding="utf-8") as f:
            f.write('{"op": "update", "key": "ns/a", "fi')  # torn write
        middle = _state(impl, path)  # drops the torn tail...
        middle.create_job("ns/b")  # ...then acknowledges a new mutation
        torn_first = middle.recovery_info()["tornRecords"]
        final = _state(impl, path)
        return (torn_first, final.get_job("ns/b") is not None,
                final.recovery_info()["tornRecords"])

    assert _both(tmp_path, scenario) == (1, True, 0)


def test_a_crash_between_snapshot_and_truncation_replays_nothing_twice(
    tmp_path,
):
    def scenario(impl, path):
        st = _state(impl, path, snapshot_every=1000)
        st.create_job("ns/a")
        st.update("ns/a", allocation=["good"], status="Running")
        st.renew_lease("ns/a", 0, 30.0, group=0)
        st.update("ns/a", allocation=["bad"])
        st.expire_overdue_allocations(now=time.monotonic() + 1.0)
        journal = path / "journal.jsonl"
        pre_rotation = journal.read_bytes()
        # Rotate, then rebuild the crash-between layout: the new snapshot
        # in place, the journal never truncated.
        st._journal._snapshot_every = 1
        st.update("ns/a", hints={"initBatchSize": 1})
        journal.write_bytes(pre_rotation + journal.read_bytes())
        rec = _state(impl, path, snapshot_every=1000)
        health = rec.slot_health()
        return (health["strikes"], health["rollbacks"],
                rec.lifecycle_metrics()["submitted_total"],
                rec.get_job("ns/a").hints)

    assert _both(tmp_path, scenario) == (
        {"bad": 1}, {"ns/a": 1}, 1, {"initBatchSize": 1}
    )


def test_a_corrupt_snapshot_raises_loudly(tmp_path):
    st = _state("port", tmp_path, snapshot_every=2)
    st.create_job("ns/a")
    for i in range(6):
        st.update("ns/a", hints={"initBatchSize": i})
    snap = tmp_path / "snapshot.json"
    assert snap.is_file()
    snap.write_text("{not json")
    with pytest.raises(port_journal.JournalCorruptError):
        _state("port", tmp_path, snapshot_every=2)
    with pytest.raises(jax_journal.JournalCorruptError):
        _state("jax", tmp_path, snapshot_every=2)


def test_the_journal_fault_point_blocks_the_mutation(tmp_path):
    st = _state("port", tmp_path)
    st.create_job("ns/a")
    faults.configure("sched.journal_write=fail@1", seed=SEED)
    with pytest.raises(faults.InjectedFault):
        st.update("ns/a", status="Running")
    faults.configure(None)
    assert st.get_job("ns/a").status == "Pending"
    assert _state("port", tmp_path).get_job("ns/a").status == "Pending"


@pytest.mark.parametrize("point", ["sched.snapshot_write",
                                   "sched.recovery_replay"])
def test_the_snapshot_and_replay_fault_points_fire(tmp_path, point):
    st = _state("port", tmp_path, snapshot_every=1)
    st.create_job("ns/a")
    faults.configure(f"{point}=fail@1", seed=SEED)
    with pytest.raises(faults.InjectedFault):
        if point == "sched.snapshot_write":
            st.update("ns/a", status="Running")
        else:
            _state("port", tmp_path, snapshot_every=1)
    faults.configure(None)
    assert _state("port", tmp_path).get_job("ns/a") is not None


def test_the_journal_file_is_json_lines(tmp_path):
    st = _state("port", tmp_path)
    st.create_job("ns/a", spec={})
    st.update("ns/a", status="Running")
    for impl in ("jax", "port"):
        snapshot, records, torn = JOURNALS[impl].StateJournal(
            str(tmp_path)
        ).load()
        assert snapshot is None and torn == 0
        assert [r["op"] for r in records] == ["create_job", "update"]
        assert [r["seq"] for r in records] == [1, 2]


def test_the_reconciliation_window_holds_expiry_until_reattach(tmp_path):
    def scenario(impl, path):
        st = _state(impl, path, reconcile_window=0.4)
        st.create_job("ns/a")
        st.update("ns/a", allocation=["s0"], status="Running")
        st.renew_lease("ns/a", 0, 0.05)
        time.sleep(0.1)  # the lease is stale on disk
        rec = _state(impl, path, reconcile_window=0.4)
        inside = rec.expire_stale_leases()
        allocation = rec.get_job("ns/a").allocation
        renewed = rec.renew_lease("ns/a", 0, 30.0)  # the worker reattaches
        time.sleep(0.45)
        return (inside, allocation, renewed, rec.expire_stale_leases(),
                rec.get_job("ns/a").degraded)

    assert _both(tmp_path, scenario) == ([], ["s0"], True, [], False)


def test_an_unrenewed_recovered_lease_expires_after_the_grace(tmp_path):
    def scenario(impl, path):
        st = _state(impl, path, reconcile_window=0.2)
        st.create_job("ns/a")
        st.update("ns/a", allocation=["s0"], status="Running")
        st.renew_lease("ns/a", 0, 30.0)
        rec = _state(impl, path, reconcile_window=0.2)
        deadline = time.monotonic() + 5
        expired = []
        while time.monotonic() < deadline and not expired:
            expired = rec.expire_stale_leases()
            time.sleep(0.05)
        return expired, rec.get_job("ns/a").degraded

    assert _both(tmp_path, scenario) == ([("ns/a", 0)], True)


def test_a_rolled_back_candidate_stays_cleared_across_recovery(tmp_path):
    def scenario(impl, path):
        st = _state(impl, path)
        st.create_job("ns/a")
        st.update("ns/a", allocation=["good"], status="Running")
        st.renew_lease("ns/a", 0, 30.0, group=0)  # commit baseline
        st.update("ns/a", allocation=["bad", "bad"])  # pending epoch
        st.publish_candidate("ns/a", ["bad", "bad"])
        published = st.get_candidate("ns/a")["allocation"]
        st.expire_overdue_allocations(now=time.monotonic() + 1.0)
        rec = _state(impl, path)
        return (published, st.get_candidate("ns/a"),
                rec.get_candidate("ns/a"), rec.get_allocation("ns/a"))

    assert _both(tmp_path, scenario) == (
        ["bad", "bad"], None, None, ["good"]
    )


def test_a_published_candidate_survives_recovery(tmp_path):
    def scenario(impl, path):
        st = _state(impl, path)
        st.create_job("ns/a")
        st.update("ns/a", allocation=["s0"], status="Running")
        st.renew_lease("ns/a", 0, 30.0, group=0)
        st.publish_candidate("ns/a", ["s0", "s1"], topology={"modelShards": 2},
                             batch_config={"atomicBsz": 16, "accumSteps": 1})
        return st.get_candidate("ns/a"), _state(impl, path).get_candidate("ns/a")

    before, after = _both(tmp_path, scenario)
    assert after == before and before["allocation"] == ["s0", "s1"]


def test_a_pending_epoch_gets_a_fresh_deadline_on_recovery(tmp_path):
    def scenario(impl, path):
        st = _state(impl, path, alloc_commit_timeout=0.2, reconcile_window=0.3)
        st.create_job("ns/a")
        st.update("ns/a", allocation=["s0"], status="Running")
        time.sleep(0.25)  # the epoch's deadline passed on disk
        rec = _state(impl, path, alloc_commit_timeout=0.2,
                     reconcile_window=0.3)
        inside = rec.expire_overdue_allocations()
        rec.renew_lease("ns/a", 0, 30.0, group=0)  # the worker reattaches
        return inside, rec.get_job("ns/a").alloc_state

    assert _both(tmp_path, scenario) == ([], "committed")


# ---- group commit ------------------------------------------------------------


def _count_fsyncs(monkeypatch, module):
    calls = {"n": 0}
    real_fsync = os.fsync

    def counting_fsync(fd):
        calls["n"] += 1
        return real_fsync(fd)

    monkeypatch.setattr(module.os, "fsync", counting_fsync)
    return calls


def test_group_commit_batches_fsyncs(tmp_path, monkeypatch):
    calls = _count_fsyncs(monkeypatch, port_journal)
    strict = port_journal.StateJournal(str(tmp_path / "s"), group_commit_s=0.0)
    for i in range(40):
        strict.append({"op": "update", "i": i})
    strict.close()
    assert calls["n"] >= 40
    calls["n"] = 0
    batched = port_journal.StateJournal(
        str(tmp_path / "b"), group_commit_s=5.0
    )
    for i in range(40):
        batched.append({"op": "update", "i": i})
    batched.close()  # syncs the pending batch
    assert calls["n"] <= 3, calls


def test_group_commit_fsync_latency_is_bounded(tmp_path, monkeypatch):
    calls = _count_fsyncs(monkeypatch, port_journal)
    journal = port_journal.StateJournal(str(tmp_path), group_commit_s=0.1)
    journal.append({"op": "update"})
    assert calls["n"] == 0, "the append itself must not fsync"
    deadline = time.monotonic() + 5.0
    while calls["n"] == 0 and time.monotonic() < deadline:
        time.sleep(0.02)
    journal.close()
    assert calls["n"] >= 1, "the flusher never fired within the window"


def test_group_commit_keeps_order_and_recovers(tmp_path):
    journal = port_journal.StateJournal(str(tmp_path), group_commit_s=5.0)
    for i in range(17):
        journal.append({"op": "update", "i": i})
    journal.close()
    for impl in ("port", "jax"):
        _, records, torn = JOURNALS[impl].StateJournal(
            str(tmp_path), group_commit_s=5.0
        ).load()
        assert torn == 0
        assert [r["i"] for r in records] == list(range(17))
        assert [r["seq"] for r in records] == list(range(1, 18))


KILL_SCRIPT = textwrap.dedent(
    """
    import os, sys
    from adaptdl_tpu_torch.sched.state import ClusterState

    state = ClusterState(state_dir=sys.argv[1], alloc_commit_timeout=0.0)
    state.create_job("c/gc", spec={"max_replicas": 4})
    for i in range(1, 25):
        state.update(
            "c/gc", allocation=["slot"] * (i % 4 + 1), status="Running",
            hints={"initBatchSize": i},
        )
    os._exit(9)  # the group-commit fsync still pending
    """
)


def test_a_killed_process_loses_nothing_acknowledged_under_group_commit(
    tmp_path,
):
    script = tmp_path / "kill.py"
    script.write_text(KILL_SCRIPT)
    env = dict(
        os.environ, ADAPTDL_JOURNAL_GROUP_COMMIT_S="30",
        PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
    )
    proc = subprocess.run(
        [sys.executable, str(script), str(tmp_path / "sched")], env=env,
        capture_output=True, text=True, timeout=SUBPROCESS_TIMEOUT_S,
    )
    assert proc.returncode == 9, proc.stderr
    for impl in ("port", "jax"):
        record = _state(impl, tmp_path / "sched",
                        alloc_commit_timeout=0.0).get_job("c/gc")
        assert record.hints == {"initBatchSize": 24}
        assert record.allocation == ["slot"] * (24 % 4 + 1)


# ---- epochs: the warm successor's liveness ------------------------------------


def test_only_the_successor_group_commits_a_rescale(tmp_path):
    """A warm successor sends nothing before its go; until then the
    incumbent's drain heartbeats must leave the epoch pending, and the
    successor's first beat commits it."""

    def scenario(impl, path):
        st = _state(impl, path)
        st.create_job("ns/a")
        st.update("ns/a", allocation=["s0"], status="Running")
        st.renew_lease("ns/a", 0, 30.0, group=0)  # commit epoch 1
        st.publish_candidate("ns/a", ["s0", "s0"])
        st.update("ns/a", allocation=["s0", "s0"])
        states = [st.get_job("ns/a").alloc_state]
        st.renew_lease("ns/a", 0, 30.0, group=0)  # the incumbent drains
        states.append(st.get_job("ns/a").alloc_state)
        candidate = st.get_candidate("ns/a")["allocation"]
        st.register_worker("ns/a", 1, 0, "h:0", processes=2)  # after go
        st.renew_lease("ns/a", 0, 30.0, group=1)
        states.append(st.get_job("ns/a").alloc_state)
        st.register_worker("ns/a", 1, 1, "h:1", processes=2)
        st.renew_lease("ns/a", 1, 30.0, group=1)
        record = st.get_job("ns/a")
        states.append(record.alloc_state)
        return (states, candidate, record.group, record.committed_allocation,
                st.get_candidate("ns/a"))

    assert _both(tmp_path, scenario) == (
        ["pending", "pending", "pending", "committed"], ["s0", "s0"], 1,
        ["s0", "s0"], None,
    )


def test_a_group_bump_resets_the_commit_quorum(tmp_path):
    def scenario(impl, path):
        st = _state(impl, path)
        st.create_job("ns/a")
        st.update("ns/a", allocation=["s0"] * 4, status="Running")
        st.register_worker("ns/a", 0, 0, "10.0.0.1", processes=2)
        st.register_worker("ns/a", 0, 1, "10.0.0.2", processes=2)
        st.renew_lease("ns/a", 0, 30.0)
        st.renew_lease("ns/a", 1, 30.0)
        first = st.get_job("ns/a").alloc_state
        st.update("ns/a", allocation=["s1"])
        st.renew_lease("ns/a", 0, 30.0, group=1)
        record = _state(impl, path).get_job("ns/a")
        return first, record.expected_processes, record.alloc_state

    assert _both(tmp_path, scenario) == ("committed", 1, "committed")


# ---- the supervisor and the runner on a state_dir -------------------------------


def _boot(state_dir, port, job="c/sup"):
    st = port_state.ClusterState(
        state_dir=state_dir, alloc_commit_timeout=30.0, reconcile_window=1.0
    )
    if st.get_job(job) is None:
        st.create_job(job, spec={})
        st.update(job, allocation=["local"] * 2, status="Running")
    sup = Supervisor(st, port=port, lease_ttl=10.0, sweep_interval=0.2)
    sup.start()
    return st, sup


def test_a_restarted_supervisor_lets_workers_reattach_without_a_group_bump(
    tmp_path,
):
    port = pick_unused_port()
    state_dir = str(tmp_path / "sched")
    state, supervisor = _boot(state_dir, port)
    url = f"http://127.0.0.1:{port}"
    client = rpc.default_client()
    for rank in (0, 1):
        client.put(
            f"{url}/register/c/sup/0/{rank}",
            json={"address": f"10.0.0.{rank + 1}", "processes": 2},
        ).raise_for_status()
    assert state.get_job("c/sup").alloc_state == "committed"
    supervisor.stop()  # the in-memory table goes; the journal stays
    state.close()
    state, supervisor = _boot(state_dir, port)
    try:
        record = state.get_job("c/sup")
        assert record.allocation == ["local"] * 2
        assert record.workers == {0: "10.0.0.1", 1: "10.0.0.2"}
        assert record.alloc_state == "committed"
        client.put(
            f"{url}/register/c/sup/0/0",
            json={"address": "10.0.0.1", "processes": 2},
        ).raise_for_status()
        got = client.get(
            f"{url}/discover/c/sup/0", params={"replicas": 2}
        ).json()
        assert got == {"0": "10.0.0.1", "1": "10.0.0.2"}
        assert state.get_job("c/sup").group == 0, "no restart group bump"
        time.sleep(0.5)  # the sweeper ran and expired nobody
        assert not state.get_job("c/sup").degraded
        status = client.get(f"{url}/status").json()
        assert status["recovery"]["recoveries"] == 1
    finally:
        supervisor.stop()


class _Sim:
    """A stand-in trainer whose update depends only on (weights, step)."""

    def __init__(self):
        self.w = np.zeros(8)
        self.step = 0

    def train_step(self):
        grad = np.random.default_rng(self.step).normal(size=self.w.shape)
        self.w = self.w - 0.01 * grad + 0.001 * np.sin(self.w)
        self.step += 1


class _SimState(checkpoint.State):
    def __init__(self, sim):
        super().__init__("journal_sim")
        self.sim = sim

    def save(self, fileobj):
        np.save(fileobj, self.sim.w, allow_pickle=False)
        fileobj.write(self.sim.step.to_bytes(8, "big"))

    def load(self, fileobj):
        import io

        blob = fileobj.read()
        self.sim.w = np.load(io.BytesIO(blob[:-8]), allow_pickle=False)
        self.sim.step = int.from_bytes(blob[-8:], "big")


def _run_supervised_sim(tmp_path, monkeypatch, tag, kill_at=None):
    """A worker loop against the port's supervisor over HTTP: a heartbeat
    and a config poll every step; an allocation change forces a
    checkpoint-restart. Rescales at steps 8 and 20; ``kill_at`` kills the
    supervisor between them and restarts it from the journal."""
    job = "c/equal"
    state_dir = str(tmp_path / f"sched-{tag}")
    ckpt_dir = tmp_path / f"ckpt-{tag}"
    ckpt_dir.mkdir()
    port = pick_unused_port()
    monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(ckpt_dir))
    monkeypatch.setenv("ADAPTDL_SUPERVISOR_URL", f"http://127.0.0.1:{port}")
    monkeypatch.setenv("ADAPTDL_JOB_ID", job)
    state, supervisor = _boot(state_dir, port, job)
    checkpoint._reset_registry()
    sim = _Sim()
    checkpoint.load_state(_SimState(sim))
    group = restarts = 0
    seen = None
    try:
        while sim.step < 30:
            step = sim.step
            # The beat reports the restart group, ADAPTDL_NUM_RESTARTS.
            monkeypatch.setenv("ADAPTDL_NUM_RESTARTS", str(group))
            assert sched_hints.send_heartbeat(rank=0)
            config = sched_hints.fetch_job_config()
            if config is not None and config["allocation"]:
                alloc = config["allocation"]
                if seen is None:
                    seen = alloc
                elif alloc != seen:
                    checkpoint.save_all_states()
                    checkpoint._reset_registry()
                    sim = _Sim()
                    checkpoint.load_state(_SimState(sim))
                    restarts += 1
                    group += 1
                    seen = alloc
            sim.train_step()
            if step == 8:
                state.update(job, allocation=["local"] * 3)
            if step == 20:
                state.update(job, allocation=["local"] * 2)
            if kill_at is not None and step == kill_at:
                supervisor.stop()
                state.close()
                state, supervisor = _boot(state_dir, port, job)
        return sim.w.copy(), restarts, list(state.get_job(job).allocation)
    finally:
        supervisor.stop()
        checkpoint._reset_registry()


def test_a_supervisor_killed_between_rescales_keeps_the_weights(
    tmp_path, monkeypatch
):
    w_base, restarts_base, alloc_base = _run_supervised_sim(
        tmp_path, monkeypatch, "base"
    )
    rpc.reset_default_client()
    w_chaos, restarts_chaos, alloc_chaos = _run_supervised_sim(
        tmp_path, monkeypatch, "chaos", kill_at=14
    )
    assert restarts_base == restarts_chaos == 2
    assert alloc_chaos == alloc_base == ["local"] * 2
    np.testing.assert_array_equal(w_chaos, w_base)


def test_a_restarted_runner_drops_recovered_jobs_it_does_not_run(tmp_path):
    state_dir = str(tmp_path / "sched")
    spec_a = JobSpec(name="m/a", script="a.py", checkpoint_dir=str(tmp_path))
    spec_b = JobSpec(name="m/b", script="b.py", checkpoint_dir=str(tmp_path))
    first = MultiJobRunner([spec_a, spec_b], num_chips=2, state_dir=state_dir)
    first.state.update("m/a", status="Running", restarts=3)
    first.state.update("m/b", status="Running", restarts=5)
    first.state.close()
    second = MultiJobRunner([spec_b], num_chips=2, state_dir=state_dir)
    try:
        assert second.state.get_job("m/a") is None
        assert second.state.get_job("m/b") is not None
        assert second.restart_counts["m/b"] == 6, (
            "a recovered job never reuses a restart index"
        )
    finally:
        second.state.close()
