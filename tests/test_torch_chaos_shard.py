"""Chaos contracts of the port's sharded control plane, at seed 1234:
the JAX package's ``tests/test_chaos_shard.py`` held by the port's shards,
router and live migration.

One supervisor shard hard-killed mid-traffic:

- the victim's workers ride out the outage on the retrying rpc client
  (503s from the router's per-shard circuit, never an error a worker
  promotes to a restart) and reattach after journal recovery: zero job
  restarts anywhere;
- sibling shards never degrade: every sibling request succeeds;
- the recovered shard replays its exact acknowledged journal prefix: the
  records on disk at kill time are a byte-prefix of the journal after
  recovery, and every acknowledged mutation is back;
- the router's circuit isolates the dead shard and probes it back.

Live migration under traffic (grow, drain), through transient faults,
coordinator faults that roll back, a source killed mid-stream, a
destination killed mid-replay, and a fence overrun.
"""

from __future__ import annotations

import json
import threading
import time

import pytest

from adaptdl_tpu_torch import faults, rpc
from adaptdl_tpu_torch.sched.router import Router
from adaptdl_tpu_torch.sched.shard import ShardedCluster
from tests.torch_support import private_tempdir  # noqa: F401

pytestmark = pytest.mark.chaos

SEED = 1234
HINTS_BASE = {"initBatchSize": 128, "maxBatchSize": 1280}


@pytest.fixture(autouse=True)
def _clean_fault_state():
    faults.reset()
    rpc.reset_default_client()
    yield
    faults.reset()
    rpc.reset_default_client()


def _tenant_for(cluster, sid):
    for i in range(1000):
        tenant = f"tenant-{i}"
        if cluster.map.assign(f"{tenant}/j") == sid:
            return tenant
    raise AssertionError("no tenant found")


def _journal_records(tmp_path, sid):
    path = tmp_path / f"shard-{sid}" / "journal.jsonl"
    with open(path) as f:
        return [
            json.loads(line) for line in f if line.strip()
        ]


def test_shard_kill_zero_restarts_siblings_unaffected(tmp_path):
    cluster = ShardedCluster(
        3,
        state_root=str(tmp_path),
        lease_ttl=30.0,
        sweep_interval=3600.0,
    )
    shard_map = cluster.start()
    router = Router(
        shard_map,
        circuit_cooldown=0.3,
        forward_attempts=1,
        forward_deadline=2.0,
    )
    url = router.start()
    client = rpc.default_client()

    keys = {
        sid: f"{_tenant_for(cluster, sid)}/job-{sid}"
        for sid in range(3)
    }
    acked_hints = {}
    for sid, key in keys.items():
        cluster.create_job(key, {})
        resp = client.put(
            f"{url}/register/{key}/0/0",
            json={"address": f"10.0.0.{sid}:1", "processes": 1},
            endpoint="worker/register",
        )
        assert resp.status_code == 200
        hints = dict(HINTS_BASE, initBatchSize=128 + sid)
        resp = client.put(
            f"{url}/hints/{key}", json=hints, endpoint="worker/hints"
        )
        # A 200 IS the acknowledgement: the shard journaled (and
        # fsynced) the update before answering — exactly what
        # recovery must replay.
        assert resp.status_code == 200
        acked_hints[key] = hints

    victim = 1
    siblings = [0, 2]

    # Sibling workers hammer the hot path through the router for the
    # whole scenario; ANY non-200 is a degradation and fails the test.
    stop = threading.Event()
    sibling_failures: list = []

    def beat(key: str) -> None:
        while not stop.is_set():
            try:
                resp = client.put(
                    f"{url}/heartbeat/{key}/0",
                    json={"stepTimeEwma": 0.5},
                    endpoint=f"worker/{key}",
                    attempts=2,
                    deadline=2.0,
                )
                if resp.status_code != 200:
                    sibling_failures.append((key, resp.status_code))
            except rpc.RpcError as exc:
                sibling_failures.append((key, repr(exc)))
            time.sleep(0.02)

    threads = [
        threading.Thread(target=beat, args=(keys[sid],), daemon=True)
        for sid in siblings
    ]
    for t in threads:
        t.start()

    try:
        time.sleep(0.3)  # traffic flowing before the kill

        # ---- hard-kill the victim shard mid-traffic --------------
        cluster.kill_shard(victim)
        acked_journal = _journal_records(tmp_path, victim)
        assert any(
            r.get("op") == "create_job" for r in acked_journal
        )

        # The victim's workers see cheap, retryable errors (the
        # router 503s once the per-shard circuit opens) — never a
        # success, never a hang.
        outage_statuses = set()
        for _ in range(8):
            try:
                resp = client.put(
                    f"{url}/heartbeat/{keys[victim]}/0",
                    json={},
                    endpoint="worker/victim",
                    attempts=1,
                    deadline=2.0,
                    retry_statuses=(),
                )
                outage_statuses.add(resp.status_code)
            except rpc.RpcError:
                outage_statuses.add("rpc-error")
            time.sleep(0.1)
        assert 200 not in outage_statuses
        assert 503 in outage_statuses

        # Sibling visibility survives the outage: the merged /status
        # still lists sibling jobs and marks the victim down.
        status = client.get(
            f"{url}/status", endpoint="cli/status"
        ).json()
        for sid in siblings:
            assert keys[sid] in status["jobs"]
        assert status["shards"][str(victim)]["error"]

        # ---- recover: journal replay on the same port ------------
        cluster.restart_shard(victim)

        # The victim's worker reattaches through the router (the
        # circuit's next probe closes it); nothing about the worker
        # restarted — same group, same rank, same lease key.
        deadline = time.monotonic() + 15.0
        reattached = False
        while time.monotonic() < deadline:
            try:
                resp = client.put(
                    f"{url}/heartbeat/{keys[victim]}/0",
                    json={"stepTimeEwma": 0.5},
                    endpoint="worker/victim-reattach",
                    attempts=1,
                    deadline=2.0,
                    # The probing worker re-tries on a short cadence;
                    # the 60s default circuit cooldown models a
                    # steady-state fleet, not a reattach loop.
                    circuit_cooldown=0.5,
                )
                if resp.status_code == 200:
                    reattached = True
                    break
            except rpc.RpcError:
                pass
            time.sleep(0.1)
        assert reattached, "victim worker failed to reattach"
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=5)

    # Siblings NEVER degraded — not one failed request across the
    # kill, the outage, and the recovery.
    assert sibling_failures == []

    # Zero job restarts anywhere.
    status = client.get(f"{url}/status", endpoint="cli/status").json()
    assert sorted(status["jobs"]) == sorted(keys.values())
    for key, job in status["jobs"].items():
        assert job["restarts"] == 0, (key, job)

    # Exact acknowledged prefix: the records on disk at kill time are
    # a prefix of the journal after recovery, replayed without loss.
    victim_state = cluster.shards[victim].state
    recovery = victim_state.recovery_info()
    assert recovery["recoveries"] == 1
    assert recovery["tornRecords"] == 0
    post_journal = _journal_records(tmp_path, victim)
    assert post_journal[: len(acked_journal)] == acked_journal

    # Every acknowledged mutation is back: job, worker, hints.
    record = victim_state.get_job(keys[victim])
    assert record is not None
    assert victim_state.get_workers(keys[victim]) == {
        0: f"10.0.0.{victim}:1"
    }
    resp = client.get(
        f"{url}/hints/{keys[victim]}", endpoint="worker/hints"
    )
    assert resp.status_code == 200
    got = resp.json()
    for field, value in acked_hints[keys[victim]].items():
        assert got[field] == value

    router.stop()
    cluster.stop()


def test_router_circuit_isolates_dead_shard(tmp_path):
    """The per-shard circuit: once open, the dead shard costs one
    cheap CircuitOpenError-backed 503 per request instead of a
    connect timeout — and sibling endpoints stay on their own
    (closed) circuits."""
    cluster = ShardedCluster(
        2, lease_ttl=30.0, sweep_interval=3600.0
    )
    shard_map = cluster.start()
    router = Router(
        shard_map,
        circuit_cooldown=60.0,
        forward_attempts=1,
        forward_deadline=2.0,
    )
    url = router.start()
    client = rpc.default_client()
    keys = {
        sid: f"{_tenant_for(cluster, sid)}/job-{sid}"
        for sid in range(2)
    }
    for key in keys.values():
        cluster.create_job(key, {})
    try:
        cluster.kill_shard(1)
        # Drive the victim circuit open (threshold 3), then prove
        # failures are instant (no network touch).
        for _ in range(4):
            resp = client.put(
                f"{url}/heartbeat/{keys[1]}/0",
                json={},
                endpoint="worker/victim",
                attempts=1,
                retry_statuses=(),
            )
            assert resp.status_code == 503
        start = time.monotonic()
        resp = client.put(
            f"{url}/heartbeat/{keys[1]}/0",
            json={},
            endpoint="worker/victim",
            attempts=1,
            retry_statuses=(),
        )
        assert resp.status_code == 503
        assert time.monotonic() - start < 0.5
        # The sibling's circuit is untouched.
        resp = client.put(
            f"{url}/heartbeat/{keys[0]}/0",
            json={},
            endpoint="worker/sibling",
            attempts=1,
        )
        assert resp.status_code in (200, 404)
    finally:
        router.stop()
        cluster.stop()


# ---------------------------------------------------------------------------
# Live-resharding chaos (docs/scheduler.md "Live resharding"): grow and
# drain under live worker traffic with ZERO job restarts, plus kills at
# every registered reshard.* fault point — each either resumes from the
# destination's acked watermark or rolls back with the old shard (and
# the old map version) still authoritative.
# ---------------------------------------------------------------------------

from adaptdl_tpu_torch.sched.shard import (  # noqa: E402
    ReshardError,
    ShardMap,
    migrate_tenant,
)


class _ImportAudit:
    """Delegating rpc client that counts snapshot-mode imports — the
    signal that a migration RESTARTED from scratch instead of resuming
    from the destination's acked watermark."""

    def __init__(self, inner):
        self._inner = inner
        self.snapshot_imports = 0

    def request(self, method, url, **kwargs):
        body = kwargs.get("json")
        if (
            "/shard/reshard/import/" in url
            and isinstance(body, dict)
            and body.get("mode") == "snapshot"
        ):
            self.snapshot_imports += 1
        return self._inner.request(method, url, **kwargs)

    def get(self, url, **kwargs):
        return self.request("GET", url, **kwargs)

    def post(self, url, **kwargs):
        return self.request("POST", url, **kwargs)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def _hammer(client, url, keys, stop, failures):
    """A worker fleet on the retrying rpc client: every logical
    request must eventually succeed — fence 503s and moved 409s are
    the router's and client's problem, never the worker's."""
    while not stop.is_set():
        for key in keys:
            try:
                resp = client.put(
                    f"{url}/heartbeat/{key}/0",
                    json={"stepTimeEwma": 0.5},
                    endpoint=f"worker/{key}",
                    attempts=6,
                    deadline=10.0,
                    circuit_cooldown=0.5,
                )
                if resp.status_code != 200:
                    failures.append(
                        (key, resp.status_code, resp.text[:120])
                    )
            except rpc.RpcError as exc:
                failures.append((key, repr(exc)))
        time.sleep(0.01)


def _seed_jobs(cluster, client, url, count):
    """Create + register ``count`` single-worker jobs through the
    router; returns {key: acked hints} — the fence-quiesced oracle
    every post-flip read is compared against."""
    acked = {}
    for i in range(count):
        key = f"tenant-{i}/job-{i}"
        cluster.create_job(key, {})
        resp = client.put(
            f"{url}/register/{key}/0/0",
            json={"address": f"10.0.0.{i}:1", "processes": 1},
            endpoint="worker/register",
        )
        assert resp.status_code == 200
        hints = dict(HINTS_BASE, initBatchSize=128 + i)
        resp = client.put(
            f"{url}/hints/{key}", json=hints, endpoint="worker/hints"
        )
        assert resp.status_code == 200
        acked[key] = hints
    return acked


def _assert_fleet_settled(cluster, router, client, acked_hints):
    """Post-migration bar: every job is where the map says, serves
    byte-equal acked state through the router, and restarted zero
    times."""
    url = router.url
    for key, hints in acked_hints.items():
        sid = cluster.map.assign(key)
        assert cluster.shards[sid].state.get_job(key) is not None
        # The router resolves any staleness itself (reload + one
        # re-forward) — the worker never sees a 409.
        resp = client.get(
            f"{url}/hints/{key}", endpoint="worker/hints"
        )
        assert resp.status_code == 200, (key, resp.text)
        got = resp.json()
        for field, value in hints.items():
            assert got[field] == value, key
    router.set_map(cluster.map)
    status = client.get(f"{url}/status", endpoint="cli/status").json()
    assert sorted(status["jobs"]) == sorted(acked_hints)
    for key, job in status["jobs"].items():
        assert job["restarts"] == 0, (key, job)


def test_reshard_grow_under_traffic_zero_restarts(tmp_path):
    """2→3 live grow under a hammering worker fleet: zero failed
    worker requests, zero job restarts, every migrated tenant's
    post-flip state byte-equal to the acked writes."""
    map_path = str(tmp_path / "map.json")
    cluster = ShardedCluster(
        2,
        state_root=str(tmp_path),
        lease_ttl=30.0,
        sweep_interval=3600.0,
        map_path=map_path,
    )
    cluster.start()
    router = Router(cluster.map, map_path=map_path, circuit_cooldown=0.3)
    url = router.start()
    client = rpc.default_client()
    acked_hints = _seed_jobs(cluster, client, url, 10)
    stop = threading.Event()
    failures: list = []
    keys = sorted(acked_hints)
    threads = [
        threading.Thread(
            target=_hammer,
            args=(client, url, keys[i::2], stop, failures),
            daemon=True,
        )
        for i in range(2)
    ]
    for t in threads:
        t.start()
    try:
        time.sleep(0.3)  # traffic flowing before the grow
        plan = cluster.grow(fence_s=2.0)
        time.sleep(0.3)  # traffic flowing on the grown map
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
    try:
        assert failures == []
        assert sorted(cluster.shards) == [0, 1, 2]
        # Deterministic rendezvous over tenant-0..9 moves a nonempty
        # subset onto the new shard.
        assert plan.moves
        assert all(m["to"] == 2 for m in plan.moves)
        assert ShardMap.load(map_path).version == cluster.map.version
        _assert_fleet_settled(cluster, router, client, acked_hints)
        # The old owners answer nothing for migrated tenants but the
        # durable moved marker.
        for move in plan.moves:
            src_state = cluster.shards[move["from"]].state
            marker = src_state.moved_owner(move["tenant"])
            assert marker is not None and marker["shard"] == 2
    finally:
        router.stop()
        cluster.stop()


def test_reshard_drain_under_traffic_zero_restarts(tmp_path):
    """3→2 live drain-and-retire under a hammering worker fleet:
    the retired shard's tenants all land on survivors, zero failed
    worker requests, zero restarts, the shard leaves the map."""
    map_path = str(tmp_path / "map.json")
    cluster = ShardedCluster(
        3,
        state_root=str(tmp_path),
        lease_ttl=30.0,
        sweep_interval=3600.0,
        map_path=map_path,
    )
    cluster.start()
    router = Router(cluster.map, map_path=map_path, circuit_cooldown=0.3)
    url = router.start()
    client = rpc.default_client()
    acked_hints = _seed_jobs(cluster, client, url, 12)
    stop = threading.Event()
    failures: list = []
    keys = sorted(acked_hints)
    threads = [
        threading.Thread(
            target=_hammer,
            args=(client, url, keys[i::2], stop, failures),
            daemon=True,
        )
        for i in range(2)
    ]
    for t in threads:
        t.start()
    try:
        time.sleep(0.3)
        plan = cluster.drain(2, fence_s=2.0)
        time.sleep(0.3)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
    try:
        assert failures == []
        assert sorted(cluster.shards) == [0, 1]
        assert sorted(cluster.map.shards) == [0, 1]
        assert cluster.map.retiring == ()
        # Deterministic: tenant-0..11 put at least one tenant on the
        # drained shard, and every move targets a survivor.
        assert plan.moves
        assert all(
            m["from"] == 2 and m["to"] in (0, 1) for m in plan.moves
        )
        assert ShardMap.load(map_path).version == cluster.map.version
        _assert_fleet_settled(cluster, router, client, acked_hints)
    finally:
        router.stop()
        cluster.stop()


def test_reshard_rides_out_transient_faults(tmp_path):
    """Retryable blips at ``sup.reshard.pre``, ``reshard.stream.batch``
    and ``reshard.replay`` become 500s the coordinator's rpc client
    retries straight through — the migration still lands."""
    cluster = ShardedCluster(2, lease_ttl=30.0, sweep_interval=3600.0)
    cluster.start()
    # Three distinct tenants owned by shard 0, picked up front.
    tenants = []
    for i in range(1000):
        t = f"tenant-{i}"
        if cluster.map.assign(f"{t}/j") == 0:
            tenants.append(t)
        if len(tenants) == 3:
            break
    specs = (
        "sup.reshard.pre=fail@1",
        "reshard.stream.batch=fail@1",
        "reshard.replay=fail@1",
    )
    try:
        current = cluster.map
        for tenant, spec in zip(tenants, specs):
            key = f"{tenant}/job"
            cluster.create_job(key, {})
            faults.configure(spec, seed=SEED)
            current = migrate_tenant(current, tenant, 0, 1, fence_s=5.0)
            point = spec.split("=", 1)[0]
            assert faults.hit_count(point) >= 1, point
            faults.configure(None)
            cluster.map = current
            assert cluster.shards[1].state.get_job(key) is not None
            assert cluster.shards[0].state.get_job(key) is None
    finally:
        cluster.stop()


@pytest.mark.parametrize("point", ["reshard.fence", "reshard.flip"])
def test_reshard_coordinator_fault_rolls_back(tmp_path, point):
    """A coordinator killed at the fence or flip fault point rolls
    back: the journaled map version is NOT bumped, the destination's
    partial epoch is discarded, the source keeps serving unfenced —
    and a clean re-run completes the migration."""
    map_path = str(tmp_path / "map.json")
    cluster = ShardedCluster(
        2,
        lease_ttl=30.0,
        sweep_interval=3600.0,
        map_path=map_path,
    )
    cluster.start()
    tenant = _tenant_for(cluster, 0)
    key = f"{tenant}/job"
    cluster.create_job(key, {})
    try:
        faults.configure(f"{point}=fail", seed=SEED)
        with pytest.raises(ReshardError):
            migrate_tenant(
                cluster.map, tenant, 0, 1, map_path=map_path
            )
        faults.configure(None)
        # Rolled back: old map version on disk, source authoritative
        # and unfenced, destination pending discarded.
        assert ShardMap.load(map_path).version == cluster.map.version
        src_state = cluster.shards[0].state
        assert src_state.get_job(key) is not None
        assert src_state.moved_owner(tenant) is None
        assert src_state.fence_remaining(tenant) == 0.0
        dst_state = cluster.shards[1].state
        assert dst_state.reshard_info()["pending"] == {}
        assert dst_state.get_job(key) is None
        # The re-run (same epoch derivation) completes cleanly.
        flipped = migrate_tenant(
            cluster.map, tenant, 0, 1, map_path=map_path
        )
        assert flipped.version == cluster.map.version + 1
        assert ShardMap.load(map_path).version == flipped.version
        assert cluster.shards[1].state.get_job(key) is not None
    finally:
        cluster.stop()


def test_reshard_source_killed_mid_stream(tmp_path):
    """The source shard hard-killed mid-stream: the migration rolls
    back (map version unchanged, destination epoch discarded); after
    the source recovers from its journal, the re-run lands the move
    with nothing lost."""
    map_path = str(tmp_path / "map.json")
    cluster = ShardedCluster(
        2,
        state_root=str(tmp_path),
        lease_ttl=30.0,
        sweep_interval=3600.0,
        map_path=map_path,
    )
    cluster.start()
    tenant = _tenant_for(cluster, 0)
    keys = [f"{tenant}/job-{i}" for i in range(3)]
    for key in keys:
        cluster.create_job(key, {})
    try:
        cluster.kill_shard(0)
        with pytest.raises(ReshardError):
            migrate_tenant(
                cluster.map, tenant, 0, 1, map_path=map_path
            )
        # Rolled back, old shard (once recovered) still authoritative.
        assert ShardMap.load(map_path).version == cluster.map.version
        assert (
            cluster.shards[1].state.reshard_info()["pending"] == {}
        )
        cluster.restart_shard(0)
        src_state = cluster.shards[0].state
        for key in keys:
            assert src_state.get_job(key) is not None
        flipped = migrate_tenant(
            cluster.map, tenant, 0, 1, map_path=map_path
        )
        assert flipped.version == cluster.map.version + 1
        dst_state = cluster.shards[1].state
        for key in keys:
            assert dst_state.get_job(key) is not None
        assert src_state.moved_owner(tenant)["shard"] == 1
    finally:
        cluster.stop()


def test_reshard_dest_killed_mid_replay_resumes_from_watermark(tmp_path):
    """The destination hard-killed mid-replay: its journal replays the
    imported epoch back to the exact durable watermark, and the
    coordinator's re-run RESUMES the stream from there — zero
    snapshot re-imports — instead of restarting from scratch."""
    map_path = str(tmp_path / "map.json")
    cluster = ShardedCluster(
        2,
        state_root=str(tmp_path),
        lease_ttl=30.0,
        sweep_interval=3600.0,
        map_path=map_path,
    )
    cluster.start()
    tenant = _tenant_for(cluster, 0)
    key = f"{tenant}/job"
    cluster.create_job(key, {})
    try:
        src_state = cluster.shards[0].state
        dst_state = cluster.shards[1].state
        # The epoch migrate_tenant will derive for this map version.
        epoch = f"{tenant}:0->1@v{cluster.map.version}"
        # Bootstrap + one delta, exactly as the coordinator would.
        snapshot = src_state.stream_tenant(tenant, None)
        watermark = dst_state.reshard_import_batch(
            tenant, epoch, snapshot
        )
        cluster.create_job(f"{tenant}/job-late", {})
        delta = src_state.stream_tenant(tenant, watermark)
        assert delta["records"]
        watermark = dst_state.reshard_import_batch(tenant, epoch, delta)

        # ---- hard-kill the destination mid-replay ----------------
        cluster.kill_shard(1)
        cluster.restart_shard(1)
        dst_state = cluster.shards[1].state
        # Journal replay restored the pending epoch to the exact
        # durable watermark.
        assert dst_state.reshard_watermark(tenant, epoch) == watermark

        audit = _ImportAudit(rpc.default_client())
        flipped = migrate_tenant(
            cluster.map, tenant, 0, 1, map_path=map_path, client=audit
        )
        # Resumed from the watermark: the snapshot bootstrap never
        # re-ran.
        assert audit.snapshot_imports == 0
        assert flipped.version == cluster.map.version + 1
        for k in (key, f"{tenant}/job-late"):
            assert cluster.shards[1].state.get_job(k) is not None
        assert src_state.moved_owner(tenant)["shard"] == 1
    finally:
        cluster.stop()


def test_reshard_fence_overrun_rolls_back(tmp_path):
    """A writer that never quiesces overruns a zero fence budget: the
    migration rolls back (map version unchanged, source authoritative,
    fence released) — and once the writes stop, the re-run lands."""
    map_path = str(tmp_path / "map.json")
    cluster = ShardedCluster(2, lease_ttl=30.0, sweep_interval=3600.0)
    cluster.start()
    cluster.map.save(map_path)
    tenant = _tenant_for(cluster, 0)
    key = f"{tenant}/job"
    cluster.create_job(key, {})
    src_state = cluster.shards[0].state
    stop = threading.Event()

    def write_forever():
        i = 0
        while not stop.is_set():
            # Straight into state: sustained tenant journal traffic
            # the fence cannot pause (the overrun adversary). The
            # pacing keeps well ahead of one HTTP round trip while
            # bounding how much state the re-run must stream.
            src_state.create_job(f"{tenant}/gen-{i}", {})
            i += 1
            time.sleep(0.001)

    writer = threading.Thread(target=write_forever, daemon=True)
    writer.start()
    try:
        with pytest.raises(ReshardError):
            migrate_tenant(
                cluster.map,
                tenant,
                0,
                1,
                map_path=map_path,
                fence_s=0.0,
                max_catchup_batches=3,
            )
        # Rolled back: version unchanged, source unfenced and
        # authoritative, destination epoch discarded.
        assert ShardMap.load(map_path).version == cluster.map.version
        assert src_state.get_job(key) is not None
        assert src_state.moved_owner(tenant) is None
        assert src_state.fence_remaining(tenant) == 0.0
        assert (
            cluster.shards[1].state.reshard_info()["pending"] == {}
        )
    finally:
        stop.set()
        writer.join(timeout=10)
    try:
        # Writes quiesced: the re-run drains inside a real budget.
        flipped = migrate_tenant(
            cluster.map, tenant, 0, 1, map_path=map_path, fence_s=5.0
        )
        assert flipped.version == cluster.map.version + 1
        dst_state = cluster.shards[1].state
        assert dst_state.get_job(key) is not None
        # EVERY write the source ever acknowledged — including the
        # adversary's — crossed over.
        src_export_keys = {
            k
            for k in dst_state.status_snapshot()["jobs"]
            if k.startswith(f"{tenant}/")
        }
        assert key in src_export_keys
        assert len(src_export_keys) >= 2
    finally:
        cluster.stop()
