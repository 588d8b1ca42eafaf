"""The port's allocator held to the JAX package's.

Equal cluster states (the same jobs, specs and posted hints, the JAX
wire form) go to ``adaptdl_tpu.sched.allocator.Allocator`` and to the
port's, each with its own Pollux policy of the same size. Cycle after
cycle, full and incremental, ``optimize_once`` returns equal allocations
and publishes equal allocations, topologies, batch configurations,
candidates and re-tunes into the two states (the minted trace ids are
random and differ). ``restart_cost_s_from_stats``,
``restart_penalty_from_stats``, ``slot_kind`` and ``job_info_from_hints``
agree on the same inputs.
"""

import time

import pytest

from adaptdl_tpu.sched import allocator as jax_allocator
from adaptdl_tpu.sched.policy import NodeInfo as JaxNodeInfo
from adaptdl_tpu.sched.policy import PolluxPolicy as JaxPolicy
from adaptdl_tpu.sched.state import ClusterState as JaxClusterState
from adaptdl_tpu_torch.sched import allocator as port_allocator
from adaptdl_tpu_torch.sched.policy import NodeInfo as PortNodeInfo
from adaptdl_tpu_torch.sched.policy import PolluxPolicy as PortPolicy
from adaptdl_tpu_torch.sched.state import ClusterState as PortClusterState
from tests.torch_support import private_tempdir  # noqa: F401


def _hints(alpha_c=0.02, sqr=0.001, var=0.004, profiled=1, restart=None):
    hints = {
        "initBatchSize": 32,
        "localBszBounds": [8, 128],
        "maxBatchSize": 512,
        "maxProfiledReplicas": profiled,
        "gradientAccumulation": True,
        "gradParams": {"sqr": sqr, "var": var},
        "perfParams": {
            "alpha_c": alpha_c, "beta_c": 0.0012, "alpha_n": 0.03,
            "beta_n": 0.002, "alpha_r": 0.015, "beta_r": 0.0011,
            "gamma": 1.3,
        },
    }
    if restart is not None:
        hints["restartStats"] = restart
    return hints


SIDES = {
    "jax": (JaxClusterState, JaxNodeInfo, JaxPolicy, jax_allocator),
    "port": (PortClusterState, PortNodeInfo, PortPolicy, port_allocator),
}


def _side(name, slots=(("s0", 4), ("s1", 4))):
    state_cls, node_cls, policy_cls, module = SIDES[name]
    state = state_cls(alloc_commit_timeout=0.0)
    nodes = {key: node_cls(resources={"tpu": chips}) for key, chips in slots}
    alloc = module.Allocator(
        state, nodes, policy=policy_cls(pop_size=24, generations=20),
        interval=3600.0,
    )
    return state, alloc


def _published(state):
    return {
        key: (
            list(r.allocation), r.topology, r.batch_config, r.retunes,
            state.get_candidate(key),
        )
        for key, r in sorted(state.jobs().items())
    }


def _apply(states, fn):
    for state in states:
        fn(state)


def test_cycles_publish_alike():
    (jax_state, jax_alloc), (port_state, port_alloc) = (
        _side("jax"), _side("port")
    )
    states = (jax_state, port_state)

    def cycle():
        got = [jax_alloc.optimize_once(), port_alloc.optimize_once()]
        assert got[1] == got[0]
        assert _published(port_state) == _published(jax_state)
        return got[1]

    _apply(states, lambda s: s.create_job("ns/a", {"max_replicas": 8}))
    _apply(states, lambda s: s.create_job(
        "ns/b", {"min_replicas": 1, "max_replicas": 4}
    ))
    first = cycle()  # no hints yet: one replica each
    assert [len(first[k]) for k in ("ns/a", "ns/b")] == [1, 1]
    _apply(states, lambda s: s.update("ns/a", hints=_hints(profiled=2)))
    cycle()
    _apply(states, lambda s: s.update(
        "ns/b", hints=_hints(alpha_c=0.05, sqr=0.01, var=0.001,
                             restart={"snapshotS": 1.0, "writeS": 4.0,
                                      "restoreS": 3.5})
    ))
    cycle()
    # A quiet cycle, an incremental one (one dirty job of three), and a
    # spec edit (the bounds a user edits).
    cycle()
    _apply(states, lambda s: s.create_job("ns/c", {"max_replicas": 2}))
    _apply(states, lambda s: s.update("ns/c", hints=_hints(profiled=1)))
    cycle()
    _apply(states, lambda s: s.update(
        "ns/a", spec={"min_replicas": 3, "max_replicas": 3}
    ))
    assert len(cycle()["ns/a"]) == 3
    _apply(states, lambda s: s.update("ns/b", status="Succeeded"))
    cycle()
    assert port_state.alloc_cycle_metrics()["modes"].keys() == (
        jax_state.alloc_cycle_metrics()["modes"].keys()
    )
    assert [c["mode"] for c in port_alloc.cycles][:2] == ["full", "full"]
    # The decision log's last publish per job is what the state holds.
    last = {key: alloc for _, key, alloc in port_alloc.published}
    assert last == {k: list(r.allocation)
                    for k, r in port_state.jobs().items()}


def test_runner_spec_edits_move_one_job_1_2_1():
    """The single-job runners' slot and spec shape: one node of two
    slots, the job capped at 1, then held at 2, then capped at 1."""
    sides = [_side(name, slots=(("local", 2),)) for name in ("jax", "port")]
    for state, _ in sides:
        state.create_job("ns/r", {"min_replicas": 0, "max_replicas": 1})
        state.update("ns/r", hints=_hints(profiled=1))
    counts = []
    for spec in (None, {"min_replicas": 2, "max_replicas": 2},
                 {"min_replicas": 1, "max_replicas": 1}):
        got = []
        for state, alloc in sides:
            if spec:
                state.update("ns/r", spec=dict(state.get_job("ns/r").spec,
                                               **spec))
            got.append(alloc.optimize_once())
        assert got[1] == got[0]
        counts.append(len(got[1]["ns/r"]))
    assert counts == [1, 2, 1]


@pytest.mark.parametrize("stats", [
    None, {}, {"snapshotS": 0.04}, {"snapshotS": 0.04, "writeS": 5.1,
                                    "restoreS": 3.3, "overlapFrac": 0.9},
    {"restoreS": 400.0}, {"writeS": -1.0},
])
def test_restart_pricing_agrees(stats):
    for name in ("restart_cost_s_from_stats", "restart_penalty_from_stats"):
        assert getattr(port_allocator, name)(stats) == getattr(
            jax_allocator, name
        )(stats)


def test_slot_kind_and_job_info_agree():
    for kw in ({}, {"preemptible": True}, {"extra": {"kind": "reserved"}}):
        assert port_allocator.slot_kind(
            PortNodeInfo(resources={"tpu": 1}, **kw)
        ) == jax_allocator.slot_kind(JaxNodeInfo(resources={"tpu": 1}, **kw))
    spec = {"min_replicas": 1, "max_replicas": 6, "preemptible": False}
    for hints in (None, {"initBatchSize": 32}, _hints(profiled=2),
                  _hints(restart={"writeS": 30.0})):
        infos = [
            module.job_info_from_hints(hints, spec, 5.0)
            for module in (jax_allocator, port_allocator)
        ]
        for field in ("resources", "min_replicas", "max_replicas",
                      "preemptible", "restart_penalty", "restart_cost_s",
                      "creation_timestamp"):
            assert getattr(infos[1], field) == getattr(infos[0], field), field
        for nodes, replicas in ((1, 1), (1, 2), (1, 4)):
            assert infos[1].speedup_fn(nodes, replicas) == pytest.approx(
                infos[0].speedup_fn(nodes, replicas), rel=1e-12
            )


def test_start_and_stop_run_cycles_on_a_thread():
    state, alloc = _side("port")
    state.create_job("ns/t", {"max_replicas": 2})
    alloc._interval = 0.05
    alloc.start()
    try:
        assert state.get_allocation("ns/t")  # the first cycle is synchronous
        seen = len(alloc.cycles)
        state.kick_allocator()
        deadline = time.monotonic() + 10
        while len(alloc.cycles) <= seen and time.monotonic() < deadline:
            time.sleep(0.02)
        assert len(alloc.cycles) > seen
    finally:
        alloc.stop()
    assert not alloc._thread.is_alive()
