"""The port's cluster state held to the JAX package's.

The same call sequence runs on ``adaptdl_tpu.sched.state.ClusterState``
and on the port's, each under its own copy of one fake clock (monotonic
and wall time advanced by hand). After every call the two return the
same value, and every job's ``_job_to_dict`` snapshot is equal, the
wall-clock ``creation_timestamp`` masked. Leases expire at the same
instants, allocation epochs commit and roll back alike (with the same
strikes and quarantines), and the readers (``status_snapshot``,
``slot_health``, ``preemption_info``, ``incident_info``,
``get_config_snapshot``, ``get_candidate``) answer alike. A job carries
across the two states through the JAX package's snapshot form.
"""

import pytest

from adaptdl_tpu.sched import state as jax_state
from adaptdl_tpu_torch.sched import state as port_state
from tests.torch_support import private_tempdir  # noqa: F401


class FakeClock:
    def __init__(self):
        self.mono = 1000.0
        self.wall = 1.7e9

    def monotonic(self):
        return self.mono

    def time(self):
        return self.wall

    def advance(self, seconds):
        self.mono += seconds
        self.wall += seconds


def _snapshots(state, module):
    out = {}
    for key, record in state.jobs().items():
        snap = module._job_to_dict(record)
        snap.pop("creation_timestamp")
        out[key] = snap
    return out


class Pair:
    """One clock each, advanced together; ``call`` runs a method on both
    and asserts equal results and equal job snapshots."""

    def __init__(self, **kw):
        self.clocks = (FakeClock(), FakeClock())
        self.jax = jax_state.ClusterState(clock=self.clocks[0], **kw)
        self.port = port_state.ClusterState(clock=self.clocks[1], **kw)

    def advance(self, seconds):
        for clock in self.clocks:
            clock.advance(seconds)

    def call(self, name, *args, **kwargs):
        outs = []
        for state in (self.jax, self.port):
            try:
                outs.append(("ok", getattr(state, name)(*args, **kwargs)))
            except Exception as exc:  # noqa: BLE001 - compared below
                outs.append(("raised", type(exc).__name__))
        a, b = outs
        if a[0] == "ok" and isinstance(a[1], jax_state.JobRecord):
            a = ("ok", jax_state._job_to_dict(a[1]))
            b = ("ok", port_state._job_to_dict(b[1]))
        assert b == a, name
        assert _snapshots(self.port, port_state) == _snapshots(
            self.jax, jax_state
        ), name
        return b[1]


@pytest.fixture
def pair():
    return Pair(alloc_commit_timeout=30.0, slot_strike_limit=2,
                slot_quarantine_s=60.0, reconcile_window=0.0)


def test_job_lifecycle_and_readers_match(pair):
    pair.call("create_job", "ns/a", {"min_replicas": 0, "max_replicas": 4})
    pair.call("create_job", "ns/a", {})  # exists: both raise
    pair.call("create_job", "other/b", {"max_replicas": 2, "tenant": "t"})
    pair.call("update", "ns/a", hints={"initBatchSize": 32})
    pair.call("update", "ns/missing", status="Running")  # KeyError alike
    pair.call(
        "update", "ns/a", allocation=["s0", "s0"],
        topology={"seqShards": 1}, batch_config={"atomicBsz": 16,
                                                 "accumSteps": 0},
        trace_parent="00-" + "a" * 32 + "-" + "b" * 16 + "-01",
    )
    pair.call("publish_retune", "ns/a", {"atomicBsz": 8, "accumSteps": 1})
    pair.call("publish_candidate", "ns/a", ["s0"], topology=None,
              batch_config={"atomicBsz": 32, "accumSteps": 0})
    pair.call("get_candidate", "ns/a")
    pair.call("get_config_snapshot", "ns/a")
    pair.call("get_launch_config", "ns/a")
    pair.call("get_batch_config", "ns/a")
    pair.call("advertise_handoff", "ns/a", "http://h:1", 1)
    pair.call("advertise_handoff", "ns/a", "http://h:0", 0)  # stale
    pair.call("get_handoff", "ns/a")
    pair.call("update", "ns/a", status="Succeeded")
    pair.call("update", "ns/a", status="Running")  # terminal is sticky
    pair.call("lifecycle_metrics")
    pair.call("status_snapshot")
    pair.call("dirty_jobs")
    pair.call("consume_dirty_jobs")
    pair.call("remove_job", "ns/a")
    pair.call("remove_job", "ns/a")
    pair.call("get_job", "ns/a")


def test_epochs_commit_by_quorum_and_roll_back_alike(pair):
    pair.call("create_job", "ns/j", {"max_replicas": 2})
    pair.call("update", "ns/j", allocation=["s0"])
    # First epoch: nothing was alive at prepare, one beat commits it.
    pair.call("renew_lease", "ns/j", 0, 10.0, group=0)
    assert pair.port.get_job("ns/j").alloc_state == "committed"
    pair.call("register_worker", "ns/j", 0, 0, "h:1", processes=1)
    # A rescale with the incumbent alive needs the successor group.
    pair.call("update", "ns/j", allocation=["s0", "s1"])
    pair.call("renew_lease", "ns/j", 0, 10.0, group=0)  # incumbent: no
    assert pair.port.get_job("ns/j").alloc_state == "pending"
    pair.call("register_worker", "ns/j", 1, 0, "h:2", processes=2)
    pair.call("register_worker", "ns/j", 0, 1, "h:9")  # stale group
    pair.call("register_worker", "ns/j", 1, 1, "h:3", processes=2)
    pair.call("renew_lease", "ns/j", 0, 10.0, group=1)
    pair.call("renew_lease", "ns/j", 1, 10.0, group=1)
    assert pair.port.get_job("ns/j").alloc_state == "committed"
    # A rescale that never comes up rolls back, striking the new slot.
    for _ in range(2):
        pair.call("update", "ns/j", allocation=["s0", "s2"])
        pair.advance(31.0)
        pair.call("renew_lease", "ns/j", 0, 100.0, group=1)
        pair.call("renew_lease", "ns/j", 1, 100.0, group=1)
        pair.call("expire_overdue_allocations")
    pair.call("slot_health")
    pair.call("quarantined_slots")
    pair.advance(61.0)
    pair.call("quarantined_slots")  # the probe re-admits it
    pair.call("slot_health")


def test_leases_expire_alike_under_one_clock(pair):
    pair.call("create_job", "ns/l", {})
    pair.call("update", "ns/l", allocation=["s0", "s0"], status="Running")
    pair.call("register_worker", "ns/l", 0, 0, "h:1", processes=2)
    pair.call("register_worker", "ns/l", 0, 1, "h:2", processes=2)
    pair.call("renew_lease", "ns/l", 0, 20.0, group=0)
    pair.call("renew_lease", "ns/l", 1, 20.0, group=0)
    pair.advance(15.0)
    pair.call("renew_lease", "ns/l", 0, 20.0, group=0)
    pair.call("expire_stale_leases")  # nothing due yet
    pair.advance(10.0)
    pair.call("expire_stale_leases")  # rank 1 lapsed: withdrawn
    record = pair.port.get_job("ns/l")
    assert record.degraded and record.allocation == []
    pair.advance(30.0)
    pair.call("expire_stale_leases")  # rank 0 now; already degraded
    pair.call("status_snapshot")
    pair.call("update", "ns/l", allocation=["s1"])  # re-placed
    assert not pair.port.get_job("ns/l").degraded


def test_preemption_and_incidents_alike(pair, monkeypatch):
    monkeypatch.setenv("ADAPTDL_PREEMPT_NOTICE_S", "30")
    for state in (pair.jax, pair.port):
        state.set_slot_kinds({"s0": "spot", "s1": "ondemand"},
                             preemptible={"s0"})
    pair.call("create_job", "ns/p", {})
    pair.call("update", "ns/p", allocation=["s0", "s1"], status="Running")
    kicks = pair.call("alloc_kick_count")
    pair.call("report_preemption", "ns/p", group=0, rank=0)
    pair.call("report_preemption", "ns/p", group=0, rank=1)  # folded
    assert pair.call("alloc_kick_count") == kicks + 1
    pair.call("draining_slots")
    pair.call("preemption_info")
    pair.call("hazard_rates")
    pair.advance(31.0)
    pair.call("draining_slots")
    pair.call("report_incident", "ns/p", "nan_grad", group=0, rank=0,
              step=7, data="batch-3", action="rollback")
    pair.call("report_incident", "ns/p", "nan_grad", group=0, rank=0,
              step=7, data="batch-3", action="rollback")  # duplicate
    pair.call("report_incident", "ns/p", "nan_grad", group=0, rank=0,
              step=9, data="batch-5")  # same slot, new data: a strike
    pair.call("report_incident", "ns/p", "loss_spike", group=0, rank=1,
              step=9, data="batch-5")  # same data, other slot
    pair.call("incident_info")
    pair.call("slot_health")
    pair.call("note_alloc_cycle", 0.05, 2, "full")
    pair.call("alloc_cycle_metrics")


def test_snapshot_carries_a_job_across_the_two_states():
    clock = FakeClock()
    source = jax_state.ClusterState(clock=clock, alloc_commit_timeout=30.0)
    source.create_job("ns/x", {"min_replicas": 1, "max_replicas": 2})
    source.update("ns/x", hints={"initBatchSize": 32},
                  allocation=["s0", "s0"], status="Running",
                  batch_config={"atomicBsz": 16, "accumSteps": 0})
    source.register_worker("ns/x", 0, 0, "h:1", processes=2)
    source.renew_lease("ns/x", 0, 10.0, group=0)
    snap = jax_state._job_to_dict(source.get_job("ns/x"))
    port_record = port_state._job_from_dict(snap)
    assert port_state._job_to_dict(port_record) == snap
    assert jax_state._job_to_dict(
        jax_state._job_from_dict(port_state._job_to_dict(port_record))
    ) == snap
    assert port_state.normalize_topology(None) == jax_state.normalize_topology(
        None
    )
    assert port_state.normalize_topology(
        {"stageShards": 2}
    ) == jax_state.normalize_topology({"stageShards": 2})


def test_state_dir_is_not_ported_yet(tmp_path):
    with pytest.raises(NotImplementedError, match="journal"):
        port_state.ClusterState(state_dir=str(tmp_path))
