"""The port's sharded control plane (``adaptdl_tpu_torch.sched.shard`` and
``sched.router``): the JAX package's contracts, held by the port, then
the two packages held to each other on the same inputs.

What must hold for the sharded control plane to be deployable:

- the rendezvous shard map is deterministic across processes and
  minimal-remap under shard add/remove;
- the map file is atomic: an injected ``shard.map.write`` fault leaves
  the previous complete version served;
- the router's forward is idempotent and retries through a stale shard
  map by reloading the file;
- aggregation endpoints fan out and merge: a dead shard degrades to an
  error marker, and the merged ``/metrics`` stays a strictly valid
  Prometheus exposition with a ``shard`` label;
- the 1-shard sharded deployment is byte-identical to the unsharded
  supervisor;
- assignments, map and plan payloads, rebalance and reshard plans, and
  the merged routes equal the JAX package's.
"""

from __future__ import annotations

import json
import random

import pytest

from adaptdl_tpu.sched import router as jax_router
from adaptdl_tpu.sched import shard as jax_shard
from adaptdl_tpu_torch import faults, rpc
from adaptdl_tpu_torch.sched import shard as port_shard
from adaptdl_tpu_torch.sched.router import (
    Router,
    merge_metrics,
    merge_status,
    merge_watch,
)
from adaptdl_tpu_torch.sched.shard import (
    ReshardPlan,
    ShardMap,
    ShardedCluster,
    _flip_map,
    merged_inventory,
    migrate_tenant,
    partition_slices,
    plan_inventory_rebalance,
    plan_reshard,
    rendezvous_shard,
    shard_key,
)
from adaptdl_tpu_torch.sched.state import ClusterState
from adaptdl_tpu_torch.sched.supervisor import Supervisor

from promcheck import validate_exposition
from tests.torch_support import private_tempdir  # noqa: F401

HINTS = {"initBatchSize": 128, "maxBatchSize": 1280}


@pytest.fixture(autouse=True)
def _clean_fault_state():
    faults.reset()
    rpc.reset_default_client()
    yield
    faults.reset()
    rpc.reset_default_client()


class _FrozenClock:
    """Constant clock: every monotonic()/time() read returns the same
    instant, so two runs making different NUMBERS of clock calls still
    produce byte-identical payloads (the bit-equivalence harness)."""

    @staticmethod
    def monotonic() -> float:
        return 1000.0

    @staticmethod
    def time() -> float:
        return 1_700_000_000.0


# ---- rendezvous hashing ----------------------------------------------


def test_rendezvous_deterministic():
    ids = [0, 1, 2, 3]
    for key in ("tenant-a", "tenant-b", "x/y", ""):
        first = rendezvous_shard(key, ids)
        assert rendezvous_shard(key, list(reversed(ids))) == first
        assert rendezvous_shard(key, ids) == first


def test_rendezvous_minimal_remap_on_add():
    keys = [f"tenant-{i}" for i in range(300)]
    before = {k: rendezvous_shard(k, [0, 1, 2]) for k in keys}
    after = {k: rendezvous_shard(k, [0, 1, 2, 3]) for k in keys}
    moved = [k for k in keys if before[k] != after[k]]
    # Every moved key lands on the NEW shard — no churn between
    # surviving shards (the HRW property).
    assert moved and all(after[k] == 3 for k in moved)
    # The expected move fraction is 1/4; allow generous slack.
    assert len(moved) / len(keys) < 0.45


def test_rendezvous_minimal_remap_on_remove():
    keys = [f"tenant-{i}" for i in range(300)]
    before = {k: rendezvous_shard(k, [0, 1, 2]) for k in keys}
    after = {k: rendezvous_shard(k, [0, 2]) for k in keys}
    for k in keys:
        if before[k] != 1:
            # Keys not on the removed shard NEVER move.
            assert after[k] == before[k]
        else:
            assert after[k] in (0, 2)


def test_shard_key_is_tenant():
    assert shard_key("ns-a/job-1") == "ns-a"
    assert shard_key("bare") == "bare"


def test_partition_slices_minimal_remap():
    names = [f"slice-{i}" for i in range(64)]
    before = partition_slices(names, [0, 1])
    after = partition_slices(names, [0, 1, 2])
    assert sorted(sum(after.values(), [])) == sorted(names)
    for sid in (0, 1):
        # Surviving shards only SHED slices (to the new shard).
        assert set(after[sid]) <= set(before[sid])


# ---- shard map (journaled, atomic) -----------------------------------


def test_shard_map_roundtrip(tmp_path):
    m = ShardMap({0: "http://h:1", 1: "http://h:2"}, version=7)
    path = str(tmp_path / "map.json")
    m.save(path)
    loaded = ShardMap.load(path)
    assert loaded.version == 7
    assert loaded.shards == {0: "http://h:1", 1: "http://h:2"}
    key = "tenant-x/job"
    assert loaded.assign(key) == m.assign(key)
    assert loaded.url_for(key) == m.shards[m.assign(key)]


def test_shard_map_write_fault_preserves_previous(tmp_path):
    path = str(tmp_path / "map.json")
    ShardMap({0: "http://old:1"}, version=1).save(path)
    faults.configure("shard.map.write=fail", seed=1234)
    with pytest.raises(faults.InjectedFault):
        ShardMap({0: "http://new:1"}, version=2).save(path)
    faults.configure(None)
    # The previous complete version is still what readers see.
    loaded = ShardMap.load(path)
    assert loaded.version == 1
    assert loaded.shards == {0: "http://old:1"}


# ---- router forwarding -----------------------------------------------


@pytest.fixture()
def two_shards():
    cluster = ShardedCluster(
        2, lease_ttl=30.0, sweep_interval=3600.0
    )
    shard_map = cluster.start()
    router = Router(shard_map, circuit_cooldown=0.2)
    router.start()
    try:
        yield cluster, router
    finally:
        router.stop()
        cluster.stop()


def _tenant_for(cluster, sid):
    """A tenant name the cluster's map routes to shard ``sid``."""
    for i in range(1000):
        tenant = f"tenant-{i}"
        if cluster.map.assign(f"{tenant}/j") == sid:
            return tenant
    raise AssertionError("no tenant found")


def test_router_forwards_to_owning_shard(two_shards):
    cluster, router = two_shards
    client = rpc.default_client()
    for sid in (0, 1):
        key = f"{_tenant_for(cluster, sid)}/job-{sid}"
        cluster.create_job(key, {})
        resp = client.put(
            f"{router.url}/register/{key}/0/0",
            json={"address": "10.0.0.1:1234"},
            endpoint="test/register",
        )
        assert resp.status_code == 200
        resp = client.put(
            f"{router.url}/hints/{key}",
            json=HINTS,
            endpoint="test/hints",
        )
        assert resp.status_code == 200
        # The mutation landed on the owning shard and ONLY there.
        owner = cluster.shards[sid].state
        other = cluster.shards[1 - sid].state
        assert owner.get_job(key) is not None
        assert other.get_job(key) is None


def test_router_forward_is_idempotent(two_shards):
    cluster, router = two_shards
    client = rpc.default_client()
    key = f"{_tenant_for(cluster, 0)}/job"
    cluster.create_job(key, {})
    for _ in range(3):
        resp = client.put(
            f"{router.url}/register/{key}/0/0",
            json={"address": "10.0.0.1:1234"},
            endpoint="test/register",
        )
        assert resp.status_code == 200
    workers = cluster.shards[0].state.get_workers(key)
    assert workers == {0: "10.0.0.1:1234"}
    for _ in range(2):
        resp = client.put(
            f"{router.url}/heartbeat/{key}/0",
            json={"stepTimeEwma": 0.25},
            endpoint="test/heartbeat",
        )
        assert resp.status_code == 200


def test_router_passes_through_downstream_status(two_shards):
    cluster, router = two_shards
    client = rpc.default_client()
    resp = client.get(
        f"{router.url}/hints/{_tenant_for(cluster, 0)}/missing",
        endpoint="test/hints",
    )
    assert resp.status_code == 404


def test_router_fault_point_yields_500(two_shards):
    cluster, router = two_shards
    key = f"{_tenant_for(cluster, 0)}/job"
    cluster.create_job(key, {})
    faults.configure("router.forward.pre=fail@1", seed=1234)
    # The worker-side client retries straight through the injected
    # router blip — the same contract supervisor blips already have.
    resp = rpc.default_client().put(
        f"{router.url}/heartbeat/{key}/0",
        json={},
        endpoint="test/heartbeat",
        attempts=3,
    )
    assert resp.status_code in (200, 404)
    assert faults.hit_count("router.forward.pre") >= 1


def test_router_stale_map_retry(tmp_path):
    cluster = ShardedCluster(1, lease_ttl=30.0, sweep_interval=3600.0)
    fresh_map = cluster.start()
    key = "tenant-x/job"
    cluster.create_job(key, {})
    map_path = str(tmp_path / "map.json")
    # Disk has the CURRENT map at a newer version; the router boots
    # from a stale one naming a dead shard replica.
    ShardMap(dict(fresh_map.shards), version=2).save(map_path)
    stale = ShardMap({0: "http://127.0.0.1:9"}, version=1)
    router = Router(stale, map_path=map_path, circuit_cooldown=0.2)
    router.start()
    try:
        resp = rpc.default_client().put(
            f"{router.url}/heartbeat/{key}/0",
            json={},
            endpoint="test/heartbeat",
            attempts=4,
            deadline=20.0,
        )
        assert resp.status_code in (200, 404)
        assert router.current_map().version == 2
    finally:
        router.stop()
        cluster.stop()


def test_router_without_newer_map_returns_503(tmp_path):
    stale = ShardMap({0: "http://127.0.0.1:9"}, version=1)
    router = Router(stale, circuit_cooldown=0.2, forward_deadline=1.0)
    router.start()
    try:
        resp = rpc.default_client().put(
            f"{router.url}/heartbeat/tenant-x/job/0",
            json={},
            endpoint="test/heartbeat",
            attempts=1,
            retry_statuses=(),
        )
        assert resp.status_code == 503
    finally:
        router.stop()


# ---- aggregation -----------------------------------------------------


def test_router_aggregates_status_and_watch(two_shards):
    cluster, router = two_shards
    client = rpc.default_client()
    keys = [
        f"{_tenant_for(cluster, sid)}/job-{sid}" for sid in (0, 1)
    ]
    for key in keys:
        cluster.create_job(key, {})
    status = client.get(
        f"{router.url}/status", endpoint="cli/status"
    ).json()
    assert sorted(status["jobs"]) == sorted(keys)
    assert set(status["shards"]) == {"0", "1"}
    assert all(
        not info["error"] for info in status["shards"].values()
    )
    watch = client.get(
        f"{router.url}/watch", endpoint="cli/watch"
    ).json()
    assert watch["shards"] == [0, 1]


def test_router_merged_metrics_are_valid_prometheus(two_shards):
    cluster, router = two_shards
    client = rpc.default_client()
    cluster.create_job(f"{_tenant_for(cluster, 0)}/job", {})
    text = client.get(
        f"{router.url}/metrics", endpoint="cli/metrics"
    ).text
    validate_exposition(text)
    sample_lines = [
        line
        for line in text.splitlines()
        if line and not line.startswith("#")
    ]
    assert sample_lines
    assert all('shard="' in line for line in sample_lines)


def test_dead_shard_degrades_to_error_marker(two_shards):
    cluster, router = two_shards
    client = rpc.default_client()
    live_key = f"{_tenant_for(cluster, 0)}/job"
    cluster.create_job(live_key, {})
    cluster.kill_shard(1)
    status = client.get(
        f"{router.url}/status", endpoint="cli/status"
    ).json()
    assert live_key in status["jobs"]
    assert status["shards"]["1"]["error"]
    assert not status["shards"]["0"]["error"]
    # The merged exposition simply omits the dead shard.
    text = client.get(
        f"{router.url}/metrics", endpoint="cli/metrics"
    ).text
    validate_exposition(text)
    assert 'shard="0"' in text and 'shard="1"' not in text


# ---- merge units -----------------------------------------------------


def test_merge_metrics_single_help_type_per_family():
    shard0 = (
        "# HELP adaptdl_jobs jobs\n"
        "# TYPE adaptdl_jobs gauge\n"
        "adaptdl_jobs 3\n"
        '# HELP adaptdl_lat seconds\n'
        "# TYPE adaptdl_lat histogram\n"
        'adaptdl_lat_bucket{le="1"} 2\n'
        'adaptdl_lat_bucket{le="+Inf"} 2\n'
        "adaptdl_lat_sum 0.5\n"
        "adaptdl_lat_count 2\n"
    )
    shard1 = shard0.replace(" 3\n", " 5\n")
    merged = merge_metrics([(0, shard0), (1, shard1)])
    validate_exposition(merged)
    assert merged.count("# HELP adaptdl_jobs") == 1
    assert merged.count("# TYPE adaptdl_jobs") == 1
    assert 'adaptdl_jobs{shard="0"} 3' in merged
    assert 'adaptdl_jobs{shard="1"} 5' in merged
    assert 'adaptdl_lat_bucket{shard="0",le="1"} 2' in merged


def test_merge_status_counters_and_tables():
    merged = merge_status(
        {
            0: {
                "jobs": {"a/j": {"status": "Running"}},
                "slotStrikes": {"s0": 1},
                "recovery": {"recoveries": 1, "tornRecords": 2},
                "hazardRates": {"spot": 0.5},
                "preemptionNotices": {"spot": 2},
            },
            1: {
                "jobs": {"b/j": {"status": "Running"}},
                "slotStrikes": {"s1": 2},
                "recovery": {"recoveries": 3, "tornRecords": 0},
                "hazardRates": {"spot": 0.25},
                "preemptionNotices": {"spot": 1},
            },
            2: {"error": "down"},
        }
    )
    assert sorted(merged["jobs"]) == ["a/j", "b/j"]
    assert merged["slotStrikes"] == {"s0": 1, "s1": 2}
    assert merged["recovery"]["recoveries"] == 4
    assert merged["recovery"]["tornRecords"] == 2
    assert merged["hazardRates"] == {"spot": 0.5}
    assert merged["preemptionNotices"] == {"spot": 3}
    assert merged["shards"]["2"]["error"] == "down"


def test_merge_watch_synthesizes_cluster_line():
    merged = merge_watch(
        {
            0: {
                "samples": 2,
                "cluster": [
                    {"jobs": 1, "chipsAllocated": 4, "chipsTotal": 8}
                ],
                "tenants": {"a": {"series": [], "burn": 0}},
                "jobs": {},
                "suspectSlots": {},
                "cycles": [],
                "overhead": {"sampleS": 0.1, "cycleS": 0.2},
            },
            1: {
                "samples": 3,
                "cluster": [
                    {"jobs": 2, "chipsAllocated": 8, "chipsTotal": 8}
                ],
                "tenants": {"b": {"series": [], "burn": 1}},
                "jobs": {},
                "suspectSlots": {},
                "cycles": [],
                "overhead": {"sampleS": 0.3, "cycleS": 0.1},
            },
        }
    )
    assert merged["samples"] == 5
    latest = merged["cluster"][-1]
    assert latest["jobs"] == 3
    assert latest["chipsAllocated"] == 12
    assert latest["chipsTotal"] == 16
    assert latest["utilization"] == 0.75
    assert sorted(merged["tenants"]) == ["a", "b"]


# ---- merged inventory + rebalance planning ---------------------------


def test_merged_inventory_view(two_shards):
    cluster, router = two_shards
    keys = [
        f"{_tenant_for(cluster, sid)}/job-{sid}" for sid in (0, 1)
    ]
    for key in keys:
        cluster.create_job(key, {})
    view = merged_inventory(cluster.map)
    assert sorted(view["shards"]) == [0, 1]
    assert sorted(view["jobs"]) == sorted(keys)
    for key in keys:
        assert view["jobs"][key] == cluster.map.assign(key)
    # A fresh create marks the job dirty on its own shard; the merged
    # dirty set is the union.
    assert sorted(view["dirtyJobs"]) == sorted(keys)


def test_merged_inventory_slices_follow_partition(tmp_path):
    slices = [f"slice-{i}" for i in range(8)]
    cluster = ShardedCluster(
        2, slices=slices, lease_ttl=30.0, sweep_interval=3600.0
    )
    shard_map = cluster.start()
    try:
        view = merged_inventory(shard_map)
        assert sorted(view["slices"]) == slices
        expected = partition_slices(slices, [0, 1])
        for sid, names in expected.items():
            for name in names:
                assert view["slices"][name] == sid
    finally:
        cluster.stop()


def test_plan_inventory_rebalance_deterministic_and_balanced():
    merged = {
        "shards": [0, 1],
        "jobs": {"a/1": 0, "a/2": 0, "b/1": 1, "b/2": 1},
        "dirtyJobs": [],
        "slices": {f"s{i}": 0 for i in range(6)},
    }
    plan = plan_inventory_rebalance(merged)
    assert plan == plan_inventory_rebalance(merged)
    # Equal job shares -> half the slices move to the empty shard.
    assert len(plan) == 3
    assert all(m["from"] == 0 and m["to"] == 1 for m in plan)
    # Balanced input -> empty plan.
    balanced = dict(merged)
    balanced["slices"] = {
        f"s{i}": (0 if i < 3 else 1) for i in range(6)
    }
    assert plan_inventory_rebalance(balanced) == []
    # No jobs -> nothing to optimize for.
    idle = dict(merged)
    idle["jobs"] = {}
    assert plan_inventory_rebalance(idle) == []


# ---- 1-shard bit-equivalence -----------------------------------------


def _drive(base_url: str) -> list[str]:
    """One deterministic op sequence against a control plane at
    ``base_url``; returns the raw response bodies, in order."""
    client = rpc.default_client()
    out = []

    def record(resp):
        assert resp.status_code == 200, resp.text
        out.append(resp.text)

    for key in ("tenant-a/j0", "tenant-b/j1"):
        record(
            client.put(
                f"{base_url}/register/{key}/0/0",
                json={"address": "10.0.0.1:1", "processes": 1},
                endpoint="test/register",
            )
        )
        record(
            client.put(
                f"{base_url}/hints/{key}",
                json=HINTS,
                endpoint="test/hints",
            )
        )
        record(
            client.put(
                f"{base_url}/heartbeat/{key}/0",
                json={"stepTimeEwma": 0.5},
                endpoint="test/heartbeat",
            )
        )
        record(
            client.get(
                f"{base_url}/hints/{key}", endpoint="test/hints"
            )
        )
        record(
            client.get(
                f"{base_url}/config/{key}", endpoint="test/config"
            )
        )
    return out


def test_one_shard_bit_identical_to_unsharded(tmp_path):
    """The provably-unchanged special case: every worker-visible
    response from a 1-shard sharded deployment (through the router)
    is BYTE-identical to the classic unsharded supervisor's, given a
    frozen clock and the same op sequence."""
    keys = ("tenant-a/j0", "tenant-b/j1")

    # Classic unsharded supervisor.
    plain_state = ClusterState(clock=_FrozenClock())
    for key in keys:
        plain_state.create_job(key, {})
    plain_sup = Supervisor(
        plain_state, lease_ttl=30.0, sweep_interval=3600.0
    )
    plain_url = plain_sup.start()

    # 1-shard sharded deployment behind the router.
    cluster = ShardedCluster(
        1,
        lease_ttl=30.0,
        sweep_interval=3600.0,
        state_kwargs={"clock": _FrozenClock()},
    )
    shard_map = cluster.start()
    for key in keys:
        cluster.create_job(key, {})
    router = Router(shard_map)
    router_url = router.start()

    try:
        plain = _drive(plain_url)
        sharded = _drive(router_url)
        assert plain == sharded
        # The shard's own /status (what failover preserves) matches
        # the unsharded one byte-for-byte too.
        client = rpc.default_client()
        plain_status = client.get(
            f"{plain_url}/status", endpoint="cli/status"
        ).text
        shard_status = client.get(
            f"{cluster.shards[0].url}/status", endpoint="cli/status"
        ).text
        assert plain_status == shard_status
        # And the router's merged views carry the same tables — the
        # only delta is the ``shards`` section the merge adds.
        merged = client.get(
            f"{router_url}/status", endpoint="cli/status"
        ).json()
        assert json.dumps(merged["jobs"], sort_keys=True) == json.dumps(
            json.loads(plain_status)["jobs"], sort_keys=True
        )
        plain_watch = client.get(
            f"{plain_url}/watch", endpoint="cli/watch"
        ).json()
        merged_watch = client.get(
            f"{router_url}/watch", endpoint="cli/watch"
        ).json()
        assert merged_watch.pop("shards") == [0]
        assert json.dumps(merged_watch, sort_keys=True) == json.dumps(
            plain_watch, sort_keys=True
        )
    finally:
        router.stop()
        plain_sup.stop()
        cluster.stop()


# ---- live resharding: map extensions + planning ----------------------


def test_shard_map_overrides_and_retiring():
    m = ShardMap(
        {0: "u0", 1: "u1", 2: "u2"},
        version=3,
        overrides={"tenant-x": 2},
        retiring=(1,),
    )
    # A retiring shard still serves but wins no tenants.
    assert m.active_ids() == [0, 2]
    # The pin wins over rendezvous.
    assert m.assign("tenant-x/j") == 2
    # A pin to a shard no longer in the map is ignored.
    m2 = ShardMap({0: "u0"}, overrides={"tenant-x": 9})
    assert m2.assign("tenant-x/j") == 0
    # Every shard retiring degenerates to the full set, never empty.
    m3 = ShardMap({0: "u0", 1: "u1"}, retiring=(0, 1))
    assert m3.active_ids() == [0, 1]


def test_shard_map_payload_roundtrip_with_overrides(tmp_path):
    path = str(tmp_path / "map.json")
    m = ShardMap(
        {0: "u0", 1: "u1"},
        version=5,
        overrides={"t": 1},
        retiring=(0,),
    )
    m.save(path)
    loaded = ShardMap.load(path)
    assert loaded.version == 5
    assert loaded.overrides == {"t": 1}
    assert loaded.retiring == (0,)
    assert loaded.assign("t/j") == 1
    # Legacy payloads (pre-resharding) still load.
    legacy = ShardMap.from_payload(
        {"version": 1, "shards": {"0": "u0"}}
    )
    assert legacy.overrides == {} and legacy.retiring == ()
    # Empty overrides/retiring are OMITTED: the payload a map without
    # live migrations writes is byte-identical to the legacy format.
    plain = ShardMap({0: "u0"}, version=1).to_payload()
    assert "overrides" not in plain and "retiring" not in plain


def test_reshard_plan_roundtrip(tmp_path):
    plan = ReshardPlan(
        [
            {"tenant": "a", "from": 0, "to": 2},
            {"tenant": "b", "from": 1, "to": 2},
        ],
        from_version=4,
        retiring=(1,),
        shards={0: "u0", 1: "u1", 2: "u2"},
    )
    # One map-version bump per tenant move.
    assert plan.version == 6
    path = str(tmp_path / "plan.json")
    plan.save(path)
    loaded = ReshardPlan.load(path)
    assert loaded.moves == plan.moves
    assert loaded.from_version == 4
    assert loaded.version == 6
    assert loaded.retiring == (1,)
    # The target shard URL set rides along: what a standalone apply
    # widens the journaled map with before the first migration.
    assert loaded.shards == {0: "u0", 1: "u1", 2: "u2"}


def test_plan_reshard_moves_follow_rendezvous():
    shard_map = ShardMap({0: "u0", 1: "u1"}, version=3)
    tenants = [f"tenant-{i}" for i in range(20)]
    merged = {
        "jobs": {
            f"{t}/job": rendezvous_shard(t, [0, 1]) for t in tenants
        }
    }
    # Grow: only tenants whose rendezvous over the widened set lands
    # on the new shard move — and they move exactly there.
    plan = plan_reshard(
        shard_map,
        new_shards={0: "u0", 1: "u1", 2: "u2"},
        merged=merged,
    )
    assert plan.from_version == 3
    expect = {
        t: rendezvous_shard(t, [0, 1, 2])
        for t in tenants
        if rendezvous_shard(t, [0, 1, 2]) != rendezvous_shard(t, [0, 1])
    }
    assert {m["tenant"]: m["to"] for m in plan.moves} == expect
    assert all(m["to"] == 2 for m in plan.moves)
    # Drain: exactly the retiring shard's tenants move, to survivors.
    plan = plan_reshard(shard_map, retiring=(1,), merged=merged)
    assert {m["tenant"] for m in plan.moves} == {
        t for t in tenants if rendezvous_shard(t, [0, 1]) == 1
    }
    assert all(m["from"] == 1 and m["to"] == 0 for m in plan.moves)
    assert plan.retiring == (1,)
    # Empty tenants have nothing to stream: no inventory, no moves.
    assert plan_reshard(shard_map, retiring=(1,), merged={"jobs": {}}).moves == []


def test_flip_map_retargets_or_prunes_pin():
    natural0 = next(
        t
        for i in range(100)
        for t in (f"tenant-{i}",)
        if rendezvous_shard(t, [0, 1]) == 0
    )
    natural1 = next(
        t
        for i in range(100)
        for t in (f"tenant-{i}",)
        if rendezvous_shard(t, [0, 1]) == 1
    )
    base = ShardMap(
        {0: "u0", 1: "u1"},
        version=1,
        overrides={natural0: 0, natural1: 0},
    )
    # Flip against rendezvous: the pin is retargeted.
    flipped = _flip_map(base, natural0, 1)
    assert flipped.version == 2
    assert flipped.overrides[natural0] == 1
    assert flipped.assign(f"{natural0}/j") == 1
    # Flip TO the rendezvous winner: the pin is dropped entirely.
    flipped = _flip_map(base, natural1, 1)
    assert natural1 not in flipped.overrides
    assert flipped.assign(f"{natural1}/j") == 1


# ---- live resharding: migration end-to-end ---------------------------


def test_migrate_tenant_end_to_end(two_shards):
    cluster, router = two_shards
    client = rpc.default_client()
    tenant = _tenant_for(cluster, 0)
    key = f"{tenant}/job"
    cluster.create_job(key, {})
    resp = client.put(
        f"{router.url}/register/{key}/0/0",
        json={"address": "10.0.0.1:1", "processes": 1},
        endpoint="test/register",
    )
    assert resp.status_code == 200
    resp = client.put(
        f"{router.url}/hints/{key}", json=HINTS, endpoint="test/hints"
    )
    assert resp.status_code == 200

    flipped = migrate_tenant(cluster.map, tenant, 0, 1, fence_s=5.0)
    assert flipped.version == cluster.map.version + 1
    assert flipped.assign(key) == 1
    # Destination owns the full durable record now.
    dst_state = cluster.shards[1].state
    assert dst_state.get_job(key) is not None
    assert dst_state.get_workers(key) == {0: "10.0.0.1:1"}
    # Source dropped the tenant and planted the 409 marker.
    src_state = cluster.shards[0].state
    assert src_state.get_job(key) is None
    moved = src_state.moved_owner(tenant)
    assert moved["shard"] == 1
    assert moved["version"] == flipped.version
    # The fence never outlives the migration.
    assert src_state.fence_remaining(tenant) == 0.0
    # Re-running the same move (a crashed coordinator) is a pure
    # idempotent commit tail: same map version out, no new state.
    again = migrate_tenant(flipped, tenant, 0, 1)
    assert again.version == flipped.version
    # The router serves the migrated tenant on the flipped map.
    router.set_map(flipped)
    cluster.map = flipped
    resp = client.get(
        f"{router.url}/hints/{key}", endpoint="test/hints"
    )
    assert resp.status_code == 200
    for field, value in HINTS.items():
        assert resp.json()[field] == value


def test_cluster_grow_then_drain_preserves_jobs(tmp_path):
    map_path = str(tmp_path / "map.json")
    cluster = ShardedCluster(
        2,
        lease_ttl=30.0,
        sweep_interval=3600.0,
        map_path=map_path,
    )
    cluster.start()
    keys = [f"tenant-{i}/job-{i}" for i in range(12)]
    for key in keys:
        cluster.create_job(key, {})
    try:
        plan = cluster.grow(fence_s=5.0)
        assert sorted(cluster.shards) == [0, 1, 2]
        # Deterministic rendezvous over tenant-0..11 moves a nonempty
        # strict subset to the new shard.
        assert plan.moves
        assert all(m["to"] == 2 for m in plan.moves)
        for key in keys:
            sid = cluster.map.assign(key)
            assert cluster.shards[sid].state.get_job(key) is not None
        # Drain the new shard back out: every tenant returns to a
        # survivor, nothing lost, the retired shard leaves the map.
        cluster.drain(2, fence_s=5.0)
        assert sorted(cluster.shards) == [0, 1]
        assert sorted(cluster.map.shards) == [0, 1]
        assert cluster.map.retiring == ()
        for key in keys:
            sid = cluster.map.assign(key)
            assert sid in (0, 1)
            assert cluster.shards[sid].state.get_job(key) is not None
        # The journaled map matches the in-memory one.
        assert ShardMap.load(map_path).version == cluster.map.version
    finally:
        cluster.stop()


def test_write_fence_503s_mutations_reads_flow(two_shards):
    cluster, router = two_shards
    client = rpc.default_client()
    tenant = _tenant_for(cluster, 0)
    key = f"{tenant}/job"
    cluster.create_job(key, {})
    state = cluster.shards[0].state
    state.fence_tenant(tenant, 30.0)
    try:
        # Direct to the shard: the fence 503 carries Retry-After.
        resp = client.put(
            f"{cluster.shards[0].url}/hints/{key}",
            json=HINTS,
            endpoint="test/hints",
            attempts=1,
            retry_statuses=(),
        )
        assert resp.status_code == 503
        assert float(resp.headers["Retry-After"]) > 0
        # Reads keep flowing off the still-authoritative source.
        resp = client.get(
            f"{router.url}/config/{key}", endpoint="test/config"
        )
        assert resp.status_code == 200
    finally:
        state.unfence_tenant(tenant)
    # Released fence: writes resume immediately.
    resp = client.put(
        f"{router.url}/hints/{key}", json=HINTS, endpoint="test/hints"
    )
    assert resp.status_code == 200


# ---- live resharding: the 409-moved re-forward bound -----------------


class _CountingClient:
    """Delegating rpc client that records the endpoint label of every
    request — the per-hop audit trail for the re-forward bound."""

    def __init__(self, inner):
        self._inner = inner
        self.endpoints = []

    def request(self, method, url, **kwargs):
        self.endpoints.append(kwargs.get("endpoint"))
        return self._inner.request(method, url, **kwargs)

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def hops(self):
        return [
            e
            for e in self.endpoints
            if e and e.startswith("router/shard")
        ]


def test_moved_owner_hint_parses_only_moved_bodies():
    hint = Router._moved_owner_hint(
        '{"error": "moved", "shard": 2, "version": 3}'
    )
    assert hint["shard"] == 2
    # Application 409s and junk are NOT redirect hints.
    assert Router._moved_owner_hint('{"error": "conflict"}') is None
    assert Router._moved_owner_hint("not json") is None
    assert Router._moved_owner_hint('["moved"]') is None


def test_router_double_flip_single_reforward(tmp_path):
    """The satellite regression: a request in flight across TWO map
    bumps (the tenant migrated 0→1, then 1→2) resolves with EXACTLY
    one re-forward — the old owner 409s ``moved``, the reload jumps
    straight to the newest journaled map, and the second hop lands on
    the final owner. No hop ever visits the intermediate shard and
    the budget is never consumed twice."""
    cluster = ShardedCluster(3, lease_ttl=30.0, sweep_interval=3600.0)
    cluster.start()
    map_path = str(tmp_path / "map.json")
    stale = cluster.map  # v1, pre-migration
    stale.save(map_path)
    tenant = _tenant_for(cluster, 0)
    key = f"{tenant}/job"
    cluster.create_job(key, {})
    router = None
    try:
        v2 = migrate_tenant(
            cluster.map, tenant, 0, 1, map_path=map_path
        )
        cluster.map = v2
        v3 = migrate_tenant(v2, tenant, 1, 2, map_path=map_path)
        cluster.map = v3
        assert v3.version == stale.version + 2
        counting = _CountingClient(rpc.default_client())
        router = Router(stale, map_path=map_path, client=counting)
        url = router.start()
        resp = rpc.default_client().put(
            f"{url}/hints/{key}",
            json=HINTS,
            endpoint="test/hints",
            attempts=1,
            retry_statuses=(),
        )
        assert resp.status_code == 200
        # Exactly one re-forward: first hop to the stale owner, second
        # straight to the final owner — shard 1 is never touched.
        assert counting.hops() == ["router/shard0", "router/shard2"]
        assert router.current_map().version == v3.version
    finally:
        if router is not None:
            router.stop()
        cluster.stop()


def test_router_moved_409_without_newer_map_is_verbatim():
    """The other half of the at-most-once bound: a ``moved`` 409 with
    NO newer journaled map to reload earns zero re-forwards — the
    worker sees the 409 verbatim instead of the router looping."""
    cluster = ShardedCluster(2, lease_ttl=30.0, sweep_interval=3600.0)
    cluster.start()
    tenant = _tenant_for(cluster, 0)
    key = f"{tenant}/job"
    cluster.create_job(key, {})
    router = None
    try:
        flipped = migrate_tenant(cluster.map, tenant, 0, 1)
        assert flipped.version == cluster.map.version + 1
        counting = _CountingClient(rpc.default_client())
        # Router keeps the stale map and has NO map_path to reload.
        router = Router(cluster.map, client=counting)
        url = router.start()
        resp = rpc.default_client().put(
            f"{url}/hints/{key}",
            json=HINTS,
            endpoint="test/hints",
            attempts=1,
            retry_statuses=(),
        )
        assert resp.status_code == 409
        assert resp.json()["error"] == "moved"
        assert resp.json()["shard"] == 1
        assert counting.hops() == ["router/shard0"]
    finally:
        if router is not None:
            router.stop()
        cluster.stop()


# ---- the port against the JAX package --------------------------------



@pytest.mark.parametrize("seed", [0, 1, 1234])
def test_assignments_equal_the_jax_rendezvous(seed):
    rng = random.Random(seed)
    keys = [f"tenant-{rng.randrange(1 << 30)}" for _ in range(200)]
    slices = [f"slice-{rng.randrange(1 << 20):05d}" for _ in range(64)]
    for ids in ([0], [0, 1], [0, 1, 2], [3, 1, 7, 2], list(range(9))):
        for key in keys:
            assert rendezvous_shard(key, ids) == jax_shard.rendezvous_shard(
                key, ids
            )
        assert partition_slices(slices, ids) == jax_shard.partition_slices(
            slices, ids
        )
    # Minimal remap on add and on remove, identical in both packages.
    before = {k: rendezvous_shard(k, [0, 1, 2]) for k in keys}
    grown = {k: rendezvous_shard(k, [0, 1, 2, 3]) for k in keys}
    shrunk = {k: rendezvous_shard(k, [0, 2]) for k in keys}
    assert all(grown[k] in (before[k], 3) for k in keys)
    assert all(shrunk[k] == before[k] for k in keys if before[k] != 1)


def _maps(pkg):
    return [
        pkg.ShardMap({0: "http://h:1", 1: "http://h:2"}, version=7),
        pkg.ShardMap(
            {2: "u2", 0: "u0", 1: "u1"}, version=3,
            overrides={"t-b": 2, "t-a": 0}, retiring=(1,),
        ),
    ]


def test_map_and_plan_payloads_are_the_jax_bytes(tmp_path):
    for port_map, jax_map in zip(_maps(port_shard), _maps(jax_shard)):
        assert json.dumps(port_map.to_payload()) == json.dumps(
            jax_map.to_payload()
        )
        port_path, jax_path = str(tmp_path / "p.json"), str(tmp_path / "j.json")
        port_map.save(port_path)
        jax_map.save(jax_path)
        with open(port_path, "rb") as a, open(jax_path, "rb") as b:
            assert a.read() == b.read()
        # Each package loads the other's file.
        loaded = ShardMap.load(jax_path)
        assert loaded.to_payload() == jax_shard.ShardMap.load(
            port_path
        ).to_payload()
        for key in ("t-a/j", "t-b/j", "tenant-9/x"):
            assert loaded.assign(key) == jax_map.assign(key)
    moves = [{"tenant": "a", "from": 0, "to": 2},
             {"tenant": "b", "from": 1, "to": 2}]
    shards = {0: "u0", 1: "u1", 2: "u2"}
    port_plan = ReshardPlan(moves, 4, retiring=(1,), shards=shards)
    jax_plan = jax_shard.ReshardPlan(moves, 4, retiring=(1,), shards=shards)
    port_plan.save(str(tmp_path / "p-plan.json"))
    jax_plan.save(str(tmp_path / "j-plan.json"))
    with open(tmp_path / "p-plan.json", "rb") as a, open(
        tmp_path / "j-plan.json", "rb"
    ) as b:
        assert a.read() == b.read()
    assert ReshardPlan.load(str(tmp_path / "j-plan.json")).to_payload() == (
        port_plan.to_payload()
    )


def _merged(seed):
    rng = random.Random(seed)
    shards = list(range(rng.randint(1, 5)))
    return {
        "shards": shards,
        "jobs": {
            f"t{rng.randrange(40)}/j{i}": rng.choice(shards)
            for i in range(rng.randrange(0, 60))
        },
        "dirtyJobs": [],
        "slices": {
            f"s{i:03d}": rng.choice(shards) for i in range(rng.randrange(0, 40))
        },
    }


@pytest.mark.parametrize("seed", range(6))
def test_rebalance_and_reshard_plans_equal_the_jax_plans(seed):
    merged = _merged(seed)
    assert plan_inventory_rebalance(merged) == (
        jax_shard.plan_inventory_rebalance(merged)
    )
    ids = merged["shards"]
    urls = {sid: f"u{sid}" for sid in ids}
    for new_shards, retiring in (
        ({**urls, max(ids) + 1: "new"}, ()),
        (urls, (ids[-1],)),
        (urls, ()),
    ):
        port_plan = plan_reshard(
            ShardMap(urls, version=seed + 1), new_shards=new_shards,
            retiring=retiring, merged=merged,
        )
        jax_plan = jax_shard.plan_reshard(
            jax_shard.ShardMap(urls, version=seed + 1), new_shards=new_shards,
            retiring=retiring, merged=merged,
        )
        assert port_plan.to_payload() == jax_plan.to_payload()
    pin = next(iter(sorted(merged["jobs"])), "t0/j").split("/")[0]
    base = ShardMap(urls, overrides={pin: ids[0]})
    jax_base = jax_shard.ShardMap(urls, overrides={pin: ids[0]})
    for to in ids:
        assert _flip_map(base, pin, to).to_payload() == (
            jax_shard._flip_map(jax_base, pin, to).to_payload()
        )


def _exposition(shard_id):
    return (
        "# HELP adaptdl_jobs Known jobs by lifecycle status.\n"
        "# TYPE adaptdl_jobs gauge\n"
        f'adaptdl_jobs{{status="Running"}} {shard_id + 2}\n'
        "# HELP adaptdl_alloc_decide_seconds Allocator decision latency.\n"
        "# TYPE adaptdl_alloc_decide_seconds histogram\n"
        'adaptdl_alloc_decide_seconds_bucket{mode="full",le="0.1"} 1\n'
        'adaptdl_alloc_decide_seconds_bucket{mode="full",le="+Inf"} 2\n'
        'adaptdl_alloc_decide_seconds_sum{mode="full"} 0.3\n'
        'adaptdl_alloc_decide_seconds_count{mode="full"} 2\n'
        "# HELP adaptdl_supervisor_recoveries_total Recoveries.\n"
        "# TYPE adaptdl_supervisor_recoveries_total counter\n"
        f"adaptdl_supervisor_recoveries_total {shard_id}\n"
    )


def test_merged_routes_equal_the_jax_merges():
    per_shard_text = [(sid, _exposition(sid)) for sid in (0, 2, 1)]
    merged = merge_metrics(per_shard_text)
    assert merged == jax_router.merge_metrics(per_shard_text)
    validate_exposition(merged)
    status = {
        0: {"jobs": {"a/j": {"status": "Running"}}, "slotStrikes": {"s0": 1},
            "quarantinedSlots": {"s9": 3.0}, "rollbacks": {"a/j": 1},
            "drainingSlots": {}, "hazardRates": {"spot": 0.5},
            "preemptionNotices": {"spot": 2},
            "recovery": {"recoveries": 1, "tornRecords": 2,
                         "lastRecoveryS": 0.25, "reconcileRemainingS": 1.0}},
        1: {"error": "down"},
        2: {"jobs": {"b/j": {"status": "Running"}},
            "hazardRates": {"spot": 0.75, "ondemand": 0.1},
            "preemptionNotices": {"spot": 1},
            "recovery": {"recoveries": 3, "tornRecords": 0,
                         "lastRecoveryS": 0.5}},
    }
    assert json.dumps(merge_status(status), sort_keys=True) == json.dumps(
        jax_router.merge_status(status), sort_keys=True
    )
    watch = {
        0: {"samples": 2, "cluster": [{"jobs": 1, "chipsAllocated": 4,
                                       "chipsTotal": 8}],
            "tenants": {"a": {"burn": 0}}, "jobs": {"a/j": {}},
            "suspectSlots": {"s1": 1.7}, "cycles": [{"cycle": 1}],
            "overhead": {"sampleS": 0.1, "cycleS": 0.2}},
        1: {"error": "down"},
        2: {"samples": 3, "cluster": [], "tenants": {"b": {"burn": 1}},
            "jobs": {}, "suspectSlots": {}, "cycles": [],
            "overhead": {"sampleS": 0.3}},
        3: {"samples": 1, "cluster": [{"jobs": 2, "chipsAllocated": 8,
                                       "chipsTotal": 8}]},
    }
    assert json.dumps(merge_watch(watch), sort_keys=True) == json.dumps(
        jax_router.merge_watch(watch), sort_keys=True
    )
